"""Metric schema for the metrics exporter (the subset the headline loop
reads), and the histogram the pipeline's self-metrics render.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/schema.py``.  The family names stay
the JAX package's ``tpu_*`` names: they are the string contracts the rules,
adapter, dashboards and shipped manifests pivot on, whatever accelerator
serves them.

One series name, ONE meaning — and a source that cannot measure a quantity
exports NOTHING under that name (``None`` → the family omits the sample):

=================================  =======================================
metric                             definition (the only one)
=================================  =======================================
tpu_tensorcore_utilization         achieved/peak tensor-core FLOPs, percent
                                   (workload self-report, ``mxu_fn``)
tpu_duty_cycle                     fraction of time the device was busy,
                                   percent — says "loaded", not "efficient"
tpu_hbm_memory_usage_bytes         bytes of device memory in use
tpu_hbm_memory_total_bytes         device memory capacity, bytes
tpu_hbm_memory_bandwidth_          achieved/peak memory bandwidth, percent
utilization
tpu_chip_temperature_celsius       device temperature
tpu_chip_power_watts               device power draw
=================================  =======================================
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

TPU_TENSORCORE_UTIL = "tpu_tensorcore_utilization"  # percent, 0-100
TPU_DUTY_CYCLE = "tpu_duty_cycle"  # percent, 0-100
TPU_HBM_USAGE = "tpu_hbm_memory_usage_bytes"  # bytes
TPU_HBM_TOTAL = "tpu_hbm_memory_total_bytes"  # bytes
TPU_HBM_BW_UTIL = "tpu_hbm_memory_bandwidth_utilization"  # percent, 0-100
TPU_CHIP_TEMP = "tpu_chip_temperature_celsius"  # degrees C
TPU_CHIP_POWER = "tpu_chip_power_watts"  # watts

#: name -> (type, help text); all gauges.  The help strings are the JAX
#: package's, so both packages' /metrics texts agree byte for byte.
CHIP_METRICS: dict[str, tuple[str, str]] = {
    TPU_TENSORCORE_UTIL: (
        "gauge",
        "Achieved/peak MXU FLOPs percent per TPU chip (workload-reported)",
    ),
    TPU_DUTY_CYCLE: ("gauge", "Accelerator duty cycle percent per TPU chip"),
    TPU_HBM_USAGE: ("gauge", "HBM memory used in bytes per TPU chip"),
    TPU_HBM_TOTAL: ("gauge", "Total HBM memory in bytes per TPU chip"),
    TPU_HBM_BW_UTIL: ("gauge", "HBM bandwidth utilization percent per TPU chip"),
    TPU_CHIP_TEMP: ("gauge", "Chip temperature in Celsius per TPU chip"),
    TPU_CHIP_POWER: ("gauge", "Chip power draw in watts per TPU chip"),
}

#: the families every healthy source serves (the rest are absent where
#: nothing measures them): what the doctor's exporter probe requires
CORE_CHIP_METRICS = (TPU_HBM_USAGE, TPU_HBM_TOTAL)


@dataclass(frozen=True)
class Exemplar:
    """An OpenMetrics exemplar: the traced observation behind a bucket count
    (``Histogram`` keeps the latest a bucket; exposition.py renders and
    parses it).  ``trace_id`` equals ``span_id``: the tracer is one process's."""

    value: float
    trace_id: int
    span_id: int
    ts: float | None = None


@dataclass(frozen=True)
class Sample:
    """One exposition sample: value plus its label set.

    ``suffix`` supports compound families (histograms): the series name on
    the wire is ``family.name + sample.suffix``."""

    value: float
    labels: tuple[tuple[str, str], ...] = ()
    suffix: str = ""
    exemplar: Exemplar | None = None

    @staticmethod
    def make(value: float, **labels: str) -> "Sample":
        return Sample(value, tuple(sorted(labels.items())))

    def label(self, key: str) -> str | None:
        for k, v in self.labels:
            if k == key:
                return v
        return None


@dataclass
class MetricFamily:
    """A named metric with TYPE/HELP metadata and its samples."""

    name: str
    type: str = "gauge"
    help: str = ""
    samples: list[Sample] = field(default_factory=list)

    def add(self, value: float, **labels: str) -> None:
        self.samples.append(Sample.make(value, **labels))


#: duration buckets of the pipeline's own wall-clock latencies (a scrape,
#: rule evaluation, adapter query or sync takes well under a millisecond to
#: tens of them in-process; the 1.0 and 2.5 tail catches a wedged joint)
DEFAULT_DURATION_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


def format_le(bound: float) -> str:
    """The ``le`` label value of a bucket bound: an integral bound without
    its fraction (``30``, not ``30.0``), the overflow bucket ``+Inf``, as
    exposition.py formats values, so text round trips are stable."""
    if bound == float("inf"):
        return "+Inf"
    if bound == int(bound):
        return str(int(bound))
    return repr(bound)


class Histogram:
    """A cumulative-bucket histogram in the OpenMetrics layout.

    Per label set it keeps the bucket counts (one a finite bound plus the
    implicit +Inf bucket), a ``_sum``, a ``_count`` and the latest
    :class:`Exemplar` of each bucket.  :meth:`family` renders it as one
    :class:`MetricFamily` of type ``histogram`` whose samples carry the
    ``_bucket``/``_sum``/``_count`` suffixes, so it goes through
    ``encode_text`` and the structured scrape like any other family."""

    def __init__(
        self,
        name: str,
        help: str = "",
        bounds: tuple[float, ...] = DEFAULT_DURATION_BUCKETS,
    ):
        if not bounds:
            raise ValueError(f"histogram {name}: needs at least one bound")
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(bounds))
        if self.bounds[-1] == float("inf"):
            self.bounds = self.bounds[:-1]  # +Inf is implicit
        # labels -> [per-bucket counts (+Inf last), sum, count,
        #            per-bucket latest exemplar]
        self._series: dict[tuple[tuple[str, str], ...], list] = {}

    def observe(self, value: float, exemplar: Exemplar | None = None, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        state = self._series.get(key)
        if state is None:
            n = len(self.bounds) + 1
            state = [[0] * n, 0.0, 0, [None] * n]
            self._series[key] = state
        idx = bisect.bisect_left(self.bounds, value)  # first bound >= value
        state[0][idx] += 1
        state[1] += value
        state[2] += 1
        if exemplar is not None:
            state[3][idx] = exemplar

    def cumulative_buckets(
        self, labels: tuple[tuple[str, str], ...] = ()
    ) -> list[tuple[float, float]]:
        """``[(le, cumulative_count), ...]`` with +Inf, for one label set:
        what ``rules.bucket_quantile`` reads."""
        state = self._series.get(labels)
        if state is None:
            return []
        out: list[tuple[float, float]] = []
        cumulative = 0
        for i, bound in enumerate(self.bounds + (float("inf"),)):
            cumulative += state[0][i]
            out.append((bound, float(cumulative)))
        return out

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, type="histogram", help=self.help)
        bounds = self.bounds + (float("inf"),)
        for key in sorted(self._series):
            counts, total, count, exemplars = self._series[key]
            cumulative = 0
            for i, bound in enumerate(bounds):
                cumulative += counts[i]
                fam.samples.append(
                    Sample(
                        float(cumulative),
                        tuple(sorted(key + (("le", format_le(bound)),))),
                        suffix="_bucket",
                        exemplar=exemplars[i],
                    )
                )
            fam.samples.append(Sample(total, key, suffix="_sum"))
            fam.samples.append(Sample(float(count), key, suffix="_count"))
        return fam


@dataclass(frozen=True)
class ChipSample:
    """One reading of all per-device gauges, before exposition.

    ``accel_index`` is the device index the pod attribution joins on."""

    accel_index: int
    #: None = this source cannot measure the quantity; the sample is OMITTED
    #: from exposition (absent series), never exported as a fake 0.
    tensorcore_util: float | None  # 0-100, achieved/peak tensor-core FLOPs
    duty_cycle: float | None  # 0-100
    hbm_usage_bytes: float
    hbm_total_bytes: float
    hbm_bw_util: float | None  # 0-100
    temperature_c: float | None = None
    power_w: float | None = None

    def as_metric_values(self) -> dict[str, float]:
        """Measured values only — None (unmeasurable) fields are skipped."""
        values = {
            TPU_TENSORCORE_UTIL: self.tensorcore_util,
            TPU_DUTY_CYCLE: self.duty_cycle,
            TPU_HBM_USAGE: self.hbm_usage_bytes,
            TPU_HBM_TOTAL: self.hbm_total_bytes,
            TPU_HBM_BW_UTIL: self.hbm_bw_util,
            TPU_CHIP_TEMP: self.temperature_c,
            TPU_CHIP_POWER: self.power_w,
        }
        return {name: v for name, v in values.items() if v is not None}


def families_from_chips(
    chips: list[ChipSample],
    node: str,
    attribution: dict[int, tuple[str, str]] | None = None,
) -> list[MetricFamily]:
    """Build exposition families from device readings plus pod attribution.

    ``attribution`` maps accel_index -> (namespace, pod); devices not in the
    map are exported with empty pod labels — exactly how dcgm-exporter
    behaves for GPUs not allocated to any pod (dcgm-exporter.yaml:33-34).
    """
    attribution = attribution or {}
    fams = {
        name: MetricFamily(name, type_, help_)
        for name, (type_, help_) in CHIP_METRICS.items()
    }
    for chip in chips:
        namespace, pod = attribution.get(chip.accel_index, ("", ""))
        for name, value in chip.as_metric_values().items():
            fams[name].add(
                value,
                node=node,
                namespace=namespace,
                pod=pod,
                chip=str(chip.accel_index),
            )
    # Families with zero samples (no device could measure them) are dropped
    # entirely: an absent series is the honest exposition of "can't measure".
    return [f for f in fams.values() if f.samples]
