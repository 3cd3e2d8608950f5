"""Workload self-telemetry: the channel that carries what only the workload
can measure up to the node exporter.

Two of the schema's gauges have no device-counter source on every node:

- ``tpu_tensorcore_utilization`` — a genuine achieved/peak tensor-core FLOPs
  estimate exists only where the FLOPs are counted: inside the workload
  (loadgen/matmul.py ``mxu_utilization``).  A device counter's busy fraction
  is a *different quantity* (schema.py's table).
- ``tpu_hbm_memory_bandwidth_utilization`` — a workload that knows its
  achieved bytes/s self-reports it where no device counter serves it.

Mechanism (dcgm-exporter's hostPath plumbing, dcgm-exporter.yaml:50-62, with
the direction reversed): each workload pod atomically writes
``$TPU_TELEMETRY_DIR/<namespace>_<pod>.json`` on a hostPath volume shared
with the exporter DaemonSet.  The JSON fields are the JAX package's, field
for field, so its exporter-side reader (``exporter/selfreport.py``) merges
the port's reports unchanged.

Writes are tmp+rename (atomic on one filesystem) so the reader never sees a
torn JSON; files older than the reader's staleness window are ignored, so a
dead workload's last report ages out.
"""

from __future__ import annotations

import errno
import json
import os
import time
from dataclasses import asdict, dataclass

#: where workload pods drop their reports; the shipped manifests mount a
#: hostPath here in both the workload and exporter containers
TELEMETRY_DIR_ENV = "TPU_TELEMETRY_DIR"
DEFAULT_TELEMETRY_DIR = "/var/run/tpu-telemetry"


@dataclass
class WorkloadReport:
    """One workload's self-measured gauges; None = not measured this period.

    ``queue_depth`` is the serving-demand signal (requests waiting) consumed
    by the External-metric rung.
    """

    namespace: str
    pod: str
    ts: float
    tensorcore_util_pct: float | None = None  # achieved/peak tensor-core FLOPs
    duty_cycle_pct: float | None = None  # busy fraction
    hbm_bw_util_pct: float | None = None  # achieved/peak HBM bandwidth
    achieved_tflops: float | None = None  # raw rate, for operators/debugging
    queue_depth: float | None = None  # pending requests (serving rungs)
    queue: str | None = None  # queue name label (the app, e.g. "tpu-test")


class TelemetryWriter:
    """Atomically publishes a WorkloadReport for this pod.

    Identity comes from the Downward API (POD_NAME / POD_NAMESPACE env, as the
    shipped manifests inject); ``enabled`` is False when no telemetry dir is
    configured and the directory can't be created — loadgens then run exactly
    as before (the channel is additive, never load-bearing for the workload).
    """

    def __init__(
        self,
        directory: str | None = None,
        pod: str | None = None,
        namespace: str | None = None,
        queue: str | None = None,
        min_interval: float = 1.0,
    ):
        self.directory = directory or os.environ.get(
            TELEMETRY_DIR_ENV, DEFAULT_TELEMETRY_DIR
        )
        self.pod = pod or os.environ.get("POD_NAME", "") or os.uname().nodename
        self.namespace = namespace or os.environ.get("POD_NAMESPACE", "default")
        # queue-name label for queue_depth (the External rung's selector
        # matches queue=<app>, deploy/tpu-test-external-hpa.yaml)
        self.queue = queue or os.environ.get("QUEUE_NAME", "tpu-test")
        self.min_interval = min_interval
        self._last_write = -float("inf")
        self.enabled = True
        try:
            os.makedirs(self.directory, exist_ok=True)
        except OSError:
            self.enabled = False

    @property
    def path(self) -> str:
        # namespace-qualified: two same-named pods in different namespaces on
        # one node must not clobber each other's reports (the reader keys by
        # (namespace, pod)).  "_" cannot appear in either (DNS labels), so
        # the name is unambiguous.
        return os.path.join(self.directory, f"{self.namespace}_{self.pod}.json")

    def write(
        self,
        tensorcore_util_pct: float | None = None,
        duty_cycle_pct: float | None = None,
        hbm_bw_util_pct: float | None = None,
        achieved_tflops: float | None = None,
        queue_depth: float | None = None,
        force: bool = False,
    ) -> bool:
        """Publish a report; rate-limited to ``min_interval`` (loadgen loops
        call this every step).  Returns True when a file was written."""
        if not self.enabled:
            return False
        now = time.time()
        if not force and now - self._last_write < self.min_interval:
            return False
        report = WorkloadReport(
            namespace=self.namespace,
            pod=self.pod,
            ts=now,
            tensorcore_util_pct=tensorcore_util_pct,
            duty_cycle_pct=duty_cycle_pct,
            hbm_bw_util_pct=hbm_bw_util_pct,
            achieved_tflops=achieved_tflops,
            queue_depth=queue_depth,
            queue=self.queue if queue_depth is not None else None,
        )
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(asdict(report), f)
            os.replace(tmp, self.path)  # atomic: readers see old or new, whole
        except OSError as e:
            # Transient conditions (ENOSPC, brief EIO) must not kill the
            # channel for the pod's lifetime — writes are already rate-limited
            # and the reader tolerates gaps.  Only a read-only filesystem is
            # permanent (volume remounted ro: no write will ever succeed).
            if e.errno == errno.EROFS:
                self.enabled = False
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._last_write = now
        return True

    def clear(self) -> None:
        """Remove this pod's report (called on clean shutdown so the exporter
        doesn't wait out the staleness window)."""
        try:
            os.unlink(self.path)
        except OSError:
            pass
