"""The metrics-exporter daemon loop: source → native core → /metrics.

Counterpart of ``k8s_gpu_hpa_tpu/exporter/daemon.py``.  Pulls device
readings from a MetricsSource every ``collect_interval`` (dcgm-exporter's
``-c`` flag, dcgm-exporter.yaml:37 — 1 s here, not the reference's 10 s,
because metric freshness bounds the whole control loop's latency), refreshes
device→pod attribution at a lower rate (allocations change only on pod
churn), and pushes both into the C++ core, which serves /metrics.

The caller runs ``step()`` on its schedule (the headline trial feeds it from
a thread).  The JAX daemon's workload self-report merge, metric-field
filter, queue gauges, ``run_forever`` and environment-driven ``main()`` are
not ported.
"""

from __future__ import annotations

from k8s_gpu_hpa_tpu_torch.exporter.native import NativeExporter
from k8s_gpu_hpa_tpu_torch.exporter.podresources import Attributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import MetricsSource
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
    ):
        self.source = source
        self.attributor = attributor
        self.collect_interval = collect_interval
        self.attribution_interval = attribution_interval
        self.clock = clock or SystemClock()
        self.native = NativeExporter(
            node_name=node_name,
            listen_addr=listen_addr,
            port=port,
            # up goes 0 after 3 missed collections, like dcgm watchdogs
            staleness_ms=int(collect_interval * 3000),
        )
        self._last_attribution = -float("inf")
        self.sweeps = 0

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
                self.native.set_attribution(self.attributor.list_allocations())
                self._last_attribution = now
            except Exception:  # noqa: BLE001
                pass  # kubelet briefly unavailable: keep last mapping
        try:
            chips = self.source.sample()
        except Exception:  # noqa: BLE001
            return  # source hiccup: the freshness watchdog flips `up` to 0
        self.native.push(chips)
        self.sweeps += 1

    def close(self) -> None:
        self.native.close()

    def __enter__(self) -> "ExporterDaemon":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
