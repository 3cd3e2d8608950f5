"""The metrics-exporter daemon loop: source → native core → /metrics.

Counterpart of ``k8s_gpu_hpa_tpu/exporter/daemon.py``.  Pulls device
readings from a MetricsSource every ``collect_interval`` (dcgm-exporter's
``-c`` flag, dcgm-exporter.yaml:37 — 1 s here, not the reference's 10 s,
because metric freshness bounds the whole control loop's latency), refreshes
device→pod attribution at a lower rate (allocations change only on pod
churn), merges the workload self-reports the attribution vouches for, and
pushes all of it into the C++ core, which serves /metrics.

``main()`` is the DaemonSet container's command
(``python -m k8s_gpu_hpa_tpu_torch.exporter``).
"""

from __future__ import annotations

import os

from k8s_gpu_hpa_tpu_torch.exporter.native import NativeExporter
from k8s_gpu_hpa_tpu_torch.exporter.podresources import Attributor
from k8s_gpu_hpa_tpu_torch.exporter.selfreport import (
    SelfReportReader,
    filter_to_attribution,
    merge_reports,
)
from k8s_gpu_hpa_tpu_torch.exporter.sources import MetricsSource
from k8s_gpu_hpa_tpu_torch.metrics import schema
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock


class ExporterDaemon:
    def __init__(
        self,
        source: MetricsSource,
        attributor: Attributor | None = None,
        node_name: str = "unknown-node",
        listen_addr: str = "0.0.0.0",
        port: int = 9400,
        collect_interval: float = 1.0,
        attribution_interval: float = 10.0,
        clock: Clock | None = None,
        selfreport: SelfReportReader | None = None,
        metric_fields: list[str] | None = None,
    ):
        self.source = source
        self.attributor = attributor
        self.selfreport = selfreport
        self.collect_interval = collect_interval
        self.attribution_interval = attribution_interval
        self.clock = clock or SystemClock()
        if metric_fields:
            # the dcgm `-f metrics.csv` analog: export only these families.
            # Unknown names fail fast: ignoring a typo would blank every
            # family while the exporter still reports up=1.
            unknown = [f for f in metric_fields if f not in schema.CHIP_METRICS]
            if unknown:
                raise ValueError(
                    f"unknown metric fields {unknown}; valid families: "
                    f"{sorted(schema.CHIP_METRICS)}"
                )
        self.native = NativeExporter(
            node_name=node_name,
            listen_addr=listen_addr,
            port=port,
            # up goes 0 after 3 missed collections, like dcgm watchdogs
            staleness_ms=int(collect_interval * 3000),
        )
        if metric_fields:
            self.native.set_enabled_metrics(metric_fields)
        self._last_attribution = -float("inf")
        self._attribution: dict[int, tuple[str, str]] = {}
        self.sweeps = 0
        self._unmapped_logged = False
        #: optional producer of (queue, namespace, pod, depth) rows, polled
        #: every sweep.  Production queue gauges come from workload
        #: self-reports; this hook is the stub's: the kind-e2e harness drives
        #: the External rung with a file knob, as STUB_UTIL_FILE drives
        #: utilization.
        self.queue_fn = None

    @property
    def port(self) -> int:
        return self.native.port

    def step(self) -> None:
        """One collection sweep (tests call this directly)."""
        now = self.clock.now()
        if (
            self.attributor is not None
            and now - self._last_attribution >= self.attribution_interval
        ):
            try:
                allocations = self.attributor.list_allocations()
                self.native.set_attribution(allocations)
                self._attribution = allocations
                self._last_attribution = now
            except Exception:  # noqa: BLE001
                pass  # kubelet briefly unavailable: keep last mapping
        try:
            chips = self.source.sample()
            queue_rows = list(self.queue_fn()) if self.queue_fn is not None else []
            if self.selfreport is not None:
                # fill gauges only the workload can measure (the tensor-core
                # rate; bandwidth where GPM is absent), gated by the
                # attribution: a report claiming an identity the kubelet does
                # not place on this node paints nothing, queue gauges included
                reports = filter_to_attribution(self.selfreport.read(), self._attribution)
                chips = merge_reports(chips, self._attribution, reports)
                queue_rows.extend(
                    (r.queue, r.namespace, r.pod, r.queue_depth)
                    for r in reports.values()
                    if r.queue_depth is not None and r.queue
                )
            if self.selfreport is not None or self.queue_fn is not None:
                # one replace a sweep: set_queue_gauges is atomic, so the
                # self-reported and the hook's rows land together
                self.native.set_queue_gauges(queue_rows)
            self.native.push(chips)
            self.sweeps += 1
            if not self._unmapped_logged:
                # once, after the first good sweep: what the source advertises
                # and this exporter does not consume (NVML's source has no
                # such list; the hook stays for one that does)
                self._unmapped_logged = True
                unmapped_fn = getattr(self.source, "unmapped_advertised", None)
                unmapped = unmapped_fn() if unmapped_fn is not None else None
                if unmapped:
                    print(
                        "the device source advertises metrics this exporter does "
                        "not consume: " + ", ".join(unmapped),
                        flush=True,
                    )
        except Exception:  # noqa: BLE001
            pass  # source hiccup: the freshness watchdog flips `up` to 0

    def run_forever(self) -> None:
        while True:
            self.step()
            self.clock.sleep(self.collect_interval)

    def close(self) -> None:
        self.native.close()

    def __enter__(self) -> "ExporterDaemon":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _metric_fields() -> list[str]:
    # TPU_METRIC_FIELDS: comma-separated family names to export (the analog
    # of dcgm-exporter's `-f <metrics.csv>`, dcgm-exporter.yaml:37); empty =
    # every family the source can measure
    return [f.strip() for f in os.environ.get("TPU_METRIC_FIELDS", "").split(",") if f.strip()]


def _stub_queue_fn():
    """STUB_QUEUE_NAME (comma separated) makes the stub serve
    tpu_test_queue_depth{queue=...} from a file a queue, always
    ``<STUB_QUEUE_FILE>-<name>``, as STUB_UTIL_FILE drives utilization."""
    names = [n.strip() for n in os.environ.get("STUB_QUEUE_NAME", "").split(",") if n.strip()]
    if not names:
        return None
    base = os.environ.get("STUB_QUEUE_FILE", "/tmp/stub-queue")
    default = float(os.environ.get("STUB_QUEUE_DEPTH", "0"))
    namespace = os.environ.get("STUB_QUEUE_NAMESPACE", "default")

    def queue_fn():
        rows = []
        for name in names:
            try:
                with open(f"{base}-{name}") as f:
                    depth = float(f.read().strip())
            except (OSError, ValueError):
                depth = default
            rows.append((name, namespace, f"{name}-stub", depth))
        return rows

    return queue_fn


def main() -> None:
    """CLI entry point: ``python -m k8s_gpu_hpa_tpu_torch.exporter``.

    Driven by the environment, as the reference's container is
    (dcgm-exporter.yaml:30-37), with the JAX daemon's variable names:

    - ``SOURCE``: ``nvml`` (default) reads every GPU of the node through
      NVML and attributes them to pods through the kubelet's PodResources
      socket (``nvidia.com/gpu``, UUIDs resolved by NVML); ``torch`` reads
      this process's devices through PyTorch, with no attributor; ``stub``
      serves ``STUB_CHIPS`` synthetic devices whose utilization is read from
      ``STUB_UTIL_FILE`` (default ``STUB_UTIL``), attributed through the
      Kubernetes API to the running pods labelled ``app=$ATTRIBUTE_APP`` in
      ``ATTRIBUTE_NAMESPACE`` when ATTRIBUTE_APP is set, and ``STUB_QUEUE_*``
      queue gauges.
    - ``NODE_NAME`` (the Downward API's), ``LISTEN_PORT`` (9400),
      ``COLLECT_MS`` (1000): the node label, the port, the sweep period.
    - ``TPU_METRIC_FIELDS``: the families to export (default all); under
      ``nvml`` a disabled family costs no NVML call.
    - ``TPU_TELEMETRY_DIR``: the workloads' self-report directory, merged
      each sweep (the tensor-core gauge comes only from there).

    There is no fallback: under ``SOURCE=nvml`` on a host without NVML this
    exits non-zero with NVML's error before it serves anything.
    """
    source_kind = os.environ.get("SOURCE", "nvml")
    fields = _metric_fields()
    if source_kind == "nvml":
        from k8s_gpu_hpa_tpu_torch.exporter.nvml import NvmlError
        from k8s_gpu_hpa_tpu_torch.exporter.podresources import PodResourcesClient
        from k8s_gpu_hpa_tpu_torch.exporter.sources import NvmlSource

        try:
            source: MetricsSource = NvmlSource(
                fetch_bw=not fields or schema.TPU_HBM_BW_UTIL in fields,
                fetch_temp_power=not fields
                or bool({schema.TPU_CHIP_TEMP, schema.TPU_CHIP_POWER} & set(fields)),
            )
            source.sample()  # NVML must answer before anything is served
        except (OSError, NvmlError) as e:
            raise SystemExit(f"SOURCE=nvml: NVML is not usable on this host: {e}") from e
        attributor: Attributor | None = PodResourcesClient(resolve_uuid=source.uuid_to_index)
    elif source_kind == "torch":
        from k8s_gpu_hpa_tpu_torch.exporter.sources import TorchDeviceSource

        source = TorchDeviceSource()
        attributor = None
    elif source_kind == "stub":
        from k8s_gpu_hpa_tpu_torch.exporter.sources import StubSource, file_util_fn

        num_chips = int(os.environ.get("STUB_CHIPS", "4"))
        source = StubSource(
            num_chips=num_chips,
            util_fn=file_util_fn(
                os.environ.get("STUB_UTIL_FILE", "/tmp/stub-util"),
                default=float(os.environ.get("STUB_UTIL", "20")),
            ),
        )
        attributor = None
        attribute_app = os.environ.get("ATTRIBUTE_APP", "")
        if attribute_app:
            from k8s_gpu_hpa_tpu_torch.exporter.kubeapi import KubeApiAttributor

            attributor = KubeApiAttributor(
                attribute_app,
                namespace=os.environ.get("ATTRIBUTE_NAMESPACE", "default"),
                num_chips=num_chips,
            )
    else:
        raise SystemExit(f"SOURCE={source_kind!r}: expected nvml, torch or stub")

    telemetry_dir = os.environ.get("TPU_TELEMETRY_DIR", "")
    daemon = ExporterDaemon(
        source,
        attributor=attributor,
        node_name=os.environ.get("NODE_NAME", "unknown-node"),
        port=int(os.environ.get("LISTEN_PORT", "9400")),
        collect_interval=float(os.environ.get("COLLECT_MS", "1000")) / 1000.0,
        selfreport=SelfReportReader(telemetry_dir) if telemetry_dir else None,
        metric_fields=fields or None,
    )
    if source_kind == "stub":
        daemon.queue_fn = _stub_queue_fn()
    daemon.run_forever()


if __name__ == "__main__":
    main()
