"""The closed autoscaling loop around one real device: the headline trial.

The port's counterpart of the headline trial in the repository's bench.py
(``MirrorDeployment``, ``_wire_pipeline`` and the scale-up half of
``run_trial``).  One real pod, ``tpu-test-real``, runs the matmul load
generator on the device; its exporter serves the generator's self-reported
gauges over HTTP.  The deployment's other replicas are mirror pods on a
synthetic node whose gauges copy the real device's current utilization once
they have started.  A scraper feeds a TSDB, the shipped ``tpu-test`` rule
group records the per-deployment averages, and an HPA with target 40 and
1..4 replicas scales the deployment through the custom-metrics adapter.

The trial offers 0.2 devices of load, then spikes to 8 devices' worth: the
generator's intensity is the per-running-pod share, so it runs flat out
until four pods share the load.  The trial ends when all four replicas
run, and fails if that takes longer than the budget after the metric
crossed the target.

The serve trial (``run_serve_trial``, the counterpart of bench.py's
``run_rung_serve``) runs the same loop around the decode load generator:
pod ``tpu-serve-real``, the ``tpu-serve`` rule on the bandwidth gauge, and
the shipped serve HPA (target ``SERVE_BW_TARGET``).  A ``LoopSpec`` names
what differs between the two; ``wire_pipeline`` and ``run_trial`` take it.

The node headline trial (``run_node_headline_trial``) runs the headline
loop as a GPU node's exporter sees it: the device read through NVML
(``NvmlSource``), the pod attributed as the kubelet would, and the
tensor-core gauge supplied by the generator's self-report, which the daemon
merges.

Every control-plane period (pod start latency, HPA sync, scrape interval,
behavior windows and periods, the budget) multiplies by ``time_scale``, as
bench.py's ``BENCH_TIME_SCALE`` does, so that a short run exercises the same
code path.  The loop takes its clock as an argument: a ``SystemClock`` for a
real run, a ``VirtualClock`` for a scripted one.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Protocol

from k8s_gpu_hpa_tpu_torch.control.adapter import (
    AdapterRule,
    CustomMetricsAdapter,
    ObjectReference,
)
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HPABehavior,
    HPAController,
    ObjectMetricSpec,
    shipped_behavior,
    signal_ceiling_clears_band,
)
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import Attributor, StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.selfreport import SelfReportReader
from k8s_gpu_hpa_tpu_torch.exporter.sources import MetricsSource, NvmlSource, TorchDeviceSource
from k8s_gpu_hpa_tpu_torch.loadgen.telemetry import TelemetryWriter
from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    SERVE_BW_TARGET,
    RecordingRule,
    RuleEvaluator,
    tpu_test_avg_rule,
)
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_DUTY_CYCLE,
    TPU_HBM_BW_UTIL,
    ChipSample,
    MetricFamily,
    families_from_chips,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import Scraper, TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock

if TYPE_CHECKING:
    from k8s_gpu_hpa_tpu_torch.loadgen.decode import DecodeLoadGen
    from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen

TARGET = 40.0
MAX_REPLICAS = 4
REAL_POD = "tpu-test-real"
TENSORCORE_SERIES = "tpu_test_tensorcore_avg"
DUTY_SERIES = "tpu_test_duty_cycle_avg"
SERVE_POD = "tpu-serve-real"
SERVE_SERIES = "tpu_serve_hbm_bw_avg"
BASE_POD_START_LATENCY = 12.0
BASE_HPA_SYNC = 15.0
BASE_BUDGET_S = 60.0


def tpu_test_rules() -> list[RecordingRule]:
    """The shipped ``tpu-test`` rule group's tensor-core and duty-cycle rules."""
    return [
        tpu_test_avg_rule(),
        tpu_test_avg_rule(metric=TPU_DUTY_CYCLE, record=DUTY_SERIES),
    ]


@dataclass(frozen=True)
class LoopSpec:
    """What one closed loop scales and on which signal."""

    app: str  # the Deployment's name and its pods' ``app`` label
    real_pod: str
    rules: tuple[RecordingRule, ...]
    metric: str  # the recorded series the HPA targets
    target: float
    #: recorded series read at each scrape into ``TrialResult.series``
    series: tuple[str, ...]
    #: offered load before the spike, in devices' worth
    base_offered: float
    #: the trial starts once ``Load.utilization()`` is at most this
    settle_below: float
    #: a started mirror pod's device, given the value ``mirror_util`` reads
    mirror_chip: Callable[[int, float], ChipSample]


def _mirror_busy(i: int, util: float) -> ChipSample:
    return ChipSample(i, util, util, 8e9, 16e9, util * 0.6)


def _mirror_bandwidth(i: int, bw: float) -> ChipSample:
    return ChipSample(i, None, None, 8e9, 16e9, bw)


def headline_spec(metric: str = DUTY_SERIES) -> LoopSpec:
    """The headline loop: the shipped ``tpu-test`` rule group, target 40."""
    return LoopSpec(
        app="tpu-test",
        real_pod=REAL_POD,
        rules=tuple(tpu_test_rules()),
        metric=metric,
        target=TARGET,
        series=(TENSORCORE_SERIES, DUTY_SERIES),
        base_offered=0.2,
        settle_below=30.0,
        mirror_chip=_mirror_busy,
    )


def serve_spec() -> LoopSpec:
    """The serve loop: bench.py's serve rung against the shipped serve pair
    (deploy/tpu-serve-hpa.yaml: target 5, 1..4 replicas, the shipped
    behavior).  Mirror pods report the real pod's bandwidth."""
    return LoopSpec(
        app="tpu-serve",
        real_pod=SERVE_POD,
        rules=(
            tpu_test_avg_rule(
                app="tpu-serve", deployment="tpu-serve", metric=TPU_HBM_BW_UTIL,
                record=SERVE_SERIES,
            ),
        ),
        metric=SERVE_SERIES,
        target=SERVE_BW_TARGET,
        series=(SERVE_SERIES,),
        base_offered=0.1,
        settle_below=SERVE_BW_TARGET / 2,
        mirror_chip=_mirror_bandwidth,
    )


def scaled_behavior(time_scale: float) -> HPABehavior:
    """``shipped_behavior()`` with every window and period times ``time_scale``."""
    behavior = shipped_behavior()
    for rules in (behavior.scale_up, behavior.scale_down):
        rules.stabilization_window_seconds *= time_scale
        for policy in rules.policies:
            policy.period_seconds *= time_scale
    return behavior


class MirrorDeployment:
    """Scalable target whose pods mirror the real device's utilization."""

    def __init__(
        self, clock: Clock, pod_start_latency: float, real_pod: str = REAL_POD,
        app: str = "tpu-test",
    ):
        self.clock = clock
        self.pod_start_latency = pod_start_latency
        self.replicas = 1
        self.real_pod = real_pod
        self.app = app
        #: pod name -> ready_at timestamp (the real pod is always ready)
        self.pods: dict[str, float] = {real_pod: -float("inf")}
        self._counter = 0

    def scale_to(self, n: int) -> None:
        while len(self.pods) < n:
            self._counter += 1
            self.pods[f"{self.app}-sim{self._counter}"] = (
                self.clock.now() + self.pod_start_latency
            )
        while len(self.pods) > n:
            self.pods.pop(next(reversed(self.pods)))
        self.replicas = n

    def running(self) -> list[str]:
        now = self.clock.now()
        return [p for p, ready in self.pods.items() if ready <= now]


@dataclass
class Pipeline:
    """The wired loop: what ``run_trial`` drives."""

    deployment: MirrorDeployment
    db: TimeSeriesDB
    scraper: Scraper
    evaluator: RuleEvaluator
    hpa: HPAController
    metric: str
    spec: LoopSpec | None = None  # None: the headline loop on ``metric``

    def loop_spec(self) -> LoopSpec:
        return self.spec if self.spec is not None else headline_spec(self.metric)


def http_fetch(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return r.read().decode()


def mirror_exposition(
    deployment: MirrorDeployment,
    util: float,
    mirror_chip: Callable[[int, float], ChipSample] = _mirror_busy,
) -> str:
    """The synthetic node's /metrics: one device per started mirror pod, each
    reading the real device's current value (``mirror_chip`` says which
    gauges carry it)."""
    chips, attribution = [], {}
    running = (p for p in deployment.running() if p != deployment.real_pod)
    for i, pod in enumerate(running):
        chips.append(mirror_chip(i, util))
        attribution[i] = ("default", pod)
    return encode_text(families_from_chips(chips, "sim-0", attribution))


def pod_labels_exposition(deployment: MirrorDeployment) -> str:
    """kube-state-metrics' ``kube_pod_labels`` for the deployment's pods."""
    fam = MetricFamily("kube_pod_labels", "gauge")
    for pod in deployment.pods:
        fam.add(1.0, namespace="default", pod=pod, label_app=deployment.app)
    return encode_text([fam])


def wire_pipeline(
    fetch_real: Callable[[], str],
    mirror_util: Callable[[], float],
    clock: Clock,
    time_scale: float = 1.0,
    metric: str = DUTY_SERIES,
    spec: LoopSpec | None = None,
) -> Pipeline:
    """Build the metric pipeline and HPA around a fresh MirrorDeployment.

    ``fetch_real`` serves the real pod's exposition (its node is ``real-0``),
    ``mirror_util`` the value the mirror pods report.  ``spec`` is the loop
    (default: the headline loop with ``metric`` the recorded series the HPA
    targets)."""
    loop = spec if spec is not None else headline_spec(metric)
    deployment = MirrorDeployment(
        clock, BASE_POD_START_LATENCY * time_scale, loop.real_pod, loop.app
    )
    db = TimeSeriesDB(clock)
    scraper = Scraper(db)
    scraper.add_target(fetch_real, name="exporter/real", node="real-0")
    scraper.add_target(
        lambda: mirror_exposition(deployment, mirror_util(), loop.mirror_chip),
        name="exporter/sim",
        node="sim-0",
    )
    scraper.add_target(lambda: pod_labels_exposition(deployment), name="ksm")
    evaluator = RuleEvaluator(db, list(loop.rules))
    adapter = CustomMetricsAdapter(db, [AdapterRule(series=loop.metric)])
    hpa = HPAController(
        target=deployment,
        metrics=[
            ObjectMetricSpec(
                loop.metric, loop.target, ObjectReference("Deployment", loop.app, "default")
            )
        ],
        adapter=adapter,
        clock=clock,
        min_replicas=1,
        max_replicas=MAX_REPLICAS,
        behavior=scaled_behavior(time_scale),
    )
    return Pipeline(deployment, db, scraper, evaluator, hpa, loop.metric, spec)


class Load(Protocol):
    """What the trial commands and reads: the load generator's knob and the
    windowed gauge it settles on (the duty cycle; for the serve loop the
    bandwidth percent)."""

    def set_intensity(self, value: float) -> None: ...

    def utilization(self, _chip_index: int = 0) -> float: ...


@dataclass
class TrialResult:
    scale_up_s: float  # metric crossed the target -> all replicas running
    spike_to_cross_s: float
    #: (t after spike, *the spec's series) at each scrape: for the headline
    #: loop (t, tensorcore avg, duty-cycle avg)
    series: list[tuple[float | None, ...]] = field(default_factory=list)
    #: (t after spike, replicas, running) at each HPA sync and at the end
    replicas: list[tuple[float, int, int]] = field(default_factory=list)
    #: serve loop: the saturated signal measured before the loop, percent,
    #: and its headroom over the target
    saturated_pct: float | None = None
    headroom: float | None = None


def run_trial(
    load: Load,
    pipe: Pipeline,
    clock: Clock,
    time_scale: float = 1.0,
    tick: float = 0.05,
) -> TrialResult:
    """Settle at the spec's base load (0.2 devices for the headline loop),
    spike to 8, and time the scale-up.

    Raises RuntimeError when the metric never crosses the target or the
    deployment does not reach MAX_REPLICAS running pods within the budget
    after the crossing."""
    loop = pipe.loop_spec()
    scrape_interval = max(0.05, 1.0 * time_scale)
    hpa_sync = BASE_HPA_SYNC * time_scale
    budget = BASE_BUDGET_S * time_scale
    deployment = pipe.deployment
    # drop to the pre-spike load and let the generator's window flush any
    # earlier load, so the crossing starts from a true baseline
    load.set_intensity(loop.base_offered)
    settle_deadline = clock.now() + max(30.0 * time_scale, 5.0)
    while load.utilization() > loop.settle_below and clock.now() < settle_deadline:
        clock.sleep(0.1)

    offered = loop.base_offered  # in devices' worth; below the target
    start = clock.now()
    spike_at = start + 6.0 * time_scale
    t_cross = None
    t_done = None
    result = TrialResult(0.0, 0.0)
    next_scrape = start
    next_sync = start + hpa_sync
    deadline = spike_at + 6.0 * hpa_sync + budget
    while clock.now() < deadline:
        now = clock.now()
        if now >= spike_at:
            offered = 8.0  # drives per-pod utilization to 100 until 4 pods
        load.set_intensity(min(1.0, offered / max(1, len(deployment.running()))))
        if now >= next_scrape:
            pipe.scraper.scrape_once()
            pipe.evaluator.evaluate_once()
            next_scrape = now + scrape_interval
            selector = {"deployment": loop.app}
            value = pipe.db.latest(loop.metric, selector)
            result.series.append(
                (now - spike_at, *(pipe.db.latest(s, selector) for s in loop.series))
            )
            if (
                t_cross is None
                and now >= spike_at
                and value is not None
                and value > loop.target
            ):
                t_cross = now
        if now >= next_sync:
            pipe.hpa.sync_once()
            next_sync = now + hpa_sync
            result.replicas.append(
                (now - spike_at, deployment.replicas, len(deployment.running()))
            )
        if (
            t_cross is not None
            and deployment.replicas == MAX_REPLICAS
            and len(deployment.running()) == MAX_REPLICAS
        ):
            t_done = now
            result.replicas.append((now - spike_at, MAX_REPLICAS, MAX_REPLICAS))
            break
        clock.sleep(tick)
    if t_cross is None:
        raise RuntimeError(f"{loop.metric} never crossed {loop.target} after the spike")
    if t_done is None or t_done - t_cross > budget:
        raise RuntimeError(
            f"no scale-up to {MAX_REPLICAS} running replicas within {budget:.1f}s "
            f"of the crossing; replicas: {result.replicas}"
        )
    result.scale_up_s = t_done - t_cross
    result.spike_to_cross_s = t_cross - spike_at
    return result


class LoadThread:
    """Runs ``step()`` of a load generator in its own thread, as the workload
    runs in its own pod.  An exception in the thread stops it and is raised
    again by ``stop()``."""

    def __init__(self, step: Callable[[], object]):
        self._step = step
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="loadgen", daemon=True)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._step()
        except BaseException as e:  # noqa: BLE001 — handed to stop()
            self._error = e

    def start(self) -> "LoadThread":
        self._thread.start()
        return self

    def check(self) -> None:
        """Raise the thread's exception, if it has died of one."""
        if self._error is not None:
            raise RuntimeError("load generator thread failed") from self._error

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"load generator thread did not stop within {timeout}s")
        self.check()


def _live_trial(
    spec: LoopSpec,
    source: MetricsSource,
    step: Callable[[], object],
    load: Load,
    mirror_util: Callable[[], float],
    time_scale: float,
    attributor: Attributor | None = None,
    selfreport: SelfReportReader | None = None,
) -> TrialResult:
    """Run ``step`` in its own thread, as the workload runs in its own pod,
    serve ``source`` over HTTP as the spec's real pod, and drive the loop.

    An ``ExporterDaemon`` serves the source on an ephemeral port of
    127.0.0.1 on node ``real-0``, attributing devices through ``attributor``
    (default: device 0 to the real pod) and merging ``selfreport``'s
    reports, fed by a thread every half second (times ``time_scale``); the
    scraper reads that endpoint over HTTP (``http_fetch``).  Every thread and
    the HTTP server are stopped before this returns or raises, and an
    exception in the feed thread is raised here."""
    daemon = ExporterDaemon(
        source,
        attributor or StaticAttributor({0: ("default", spec.real_pod)}),
        node_name="real-0",
        listen_addr="127.0.0.1",
        port=0,
        selfreport=selfreport,
    )
    clock = SystemClock()
    stop = threading.Event()
    feed_interval = max(0.05, 0.5 * time_scale)

    feed_errors: list[Exception] = []

    def feed() -> None:
        try:
            while not stop.is_set():
                daemon.step()
                stop.wait(feed_interval)
        except Exception as e:  # noqa: BLE001 — raised again below
            feed_errors.append(e)

    feeder = threading.Thread(target=feed, name="exporter-feed", daemon=True)
    worker = LoadThread(step)
    try:
        feeder.start()
        worker.start()
        pipe = wire_pipeline(
            lambda: http_fetch(daemon.port), mirror_util, clock, time_scale, spec=spec
        )
        return run_trial(load, pipe, clock, time_scale)
    finally:
        stop.set()
        feeder.join(10)
        worker.stop()
        daemon.close()
        if feed_errors:
            raise RuntimeError("the exporter's feed thread failed") from feed_errors[0]


def run_headline_trial(
    gen: MatmulLoadGen, time_scale: float = 1.0, metric: str = TENSORCORE_SERIES
) -> TrialResult:
    """The headline trial around one matmul load generator, in real time.

    ``TorchDeviceSource`` reads the generator's self-reported gauges; the
    HPA targets ``metric``: by default the tensor-core average, the
    generator's MFU, as bench.py's headline trial does.  The mirror pods copy
    the real device's duty cycle into both gauges, as bench.py's do.  The
    tensor-core series exists only where the generator knows its device's
    peak (``gen.peak_tflops``)."""
    source = TorchDeviceSource(
        util_fn=gen.utilization, mxu_fn=gen.mxu_utilization, device=gen.device
    )
    return _live_trial(
        headline_spec(metric), source, gen.step, gen, gen.utilization, time_scale
    )


def run_node_headline_trial(
    gen: MatmulLoadGen,
    telemetry_dir: str,
    attributor: Attributor,
    source: NvmlSource | None = None,
    time_scale: float = 1.0,
) -> TrialResult:
    """The headline trial through the node exporter, as a GPU node runs it.

    The exporter reads the device through ``source`` (default
    ``NvmlSource()``, the card's driver) and attributes it through
    ``attributor``, which must map the generator's NVML index to
    (``default``, ``tpu-test-real``), as the kubelet would.  The workload
    thread runs ``gen.step`` and publishes its self-report into
    ``telemetry_dir`` as pod ``tpu-test-real``: the tensor-core rate
    (``gen.mxu_utilization()``), the duty cycle and the TFLOP/s, as the
    matmul container does.  The daemon merges the report, and the HPA reads
    ``tpu_test_tensorcore_avg``, which under NVML only the merge supplies.
    The source is closed before this returns."""
    source = source if source is not None else NvmlSource()
    writer = TelemetryWriter(
        telemetry_dir, pod=REAL_POD, namespace="default",
        min_interval=max(0.05, time_scale),
    )

    def step() -> None:
        gen.step()
        writer.write(
            tensorcore_util_pct=gen.mxu_utilization(),
            duty_cycle_pct=gen.utilization(),
            achieved_tflops=gen.stats().achieved_tflops,
        )

    try:
        return _live_trial(
            headline_spec(TENSORCORE_SERIES), source, step, gen, gen.utilization,
            time_scale, attributor=attributor, selfreport=SelfReportReader(telemetry_dir),
        )
    finally:
        writer.clear()
        source.close()


class ServeLoad:
    """The serve pod's workload around a decode generator: bursts at a
    commanded intensity, shaped as bench.py's serve rung shapes them (after
    each burst, sleep ``busy * (1 - i) / i``, at most 2 s, with ``i`` at
    least 0.02).  Its ``utilization`` is the bandwidth signal the HPA reads,
    0 where the generator reports none."""

    def __init__(self, gen: DecodeLoadGen):
        self.gen = gen
        self._intensity = 0.1

    def set_intensity(self, value: float) -> None:
        self._intensity = value

    def utilization(self, _chip_index: int = 0) -> float:
        return self.gen.hbm_bw_utilization() or 0.0

    def step(self) -> None:
        i = max(self._intensity, 0.02)
        busy = self.gen.step()
        time.sleep(min(busy * (1.0 - i) / i, 2.0))


def measure_saturated_signal(gen: DecodeLoadGen) -> tuple[float | None, float]:
    """Step the generator flat out for 1.5 windows; returns its bandwidth
    signal then (percent, None without a peak) and the headroom over the
    serve target (0 without a signal)."""
    deadline = time.perf_counter() + 1.5 * gen.window
    while time.perf_counter() < deadline:
        gen.step()
    saturated = gen.stats().hbm_bw_util_pct
    return saturated, (saturated / SERVE_BW_TARGET if saturated else 0.0)


def run_serve_trial(gen: DecodeLoadGen, time_scale: float = 1.0) -> TrialResult:
    """The serve trial around one decode load generator, in real time.

    First the saturated signal: where it cannot clear the HPA's band above
    the shipped target (``signal_ceiling_clears_band``), the pairing is inert
    and this raises RuntimeError without driving the loop.  Otherwise the
    generator runs as pod ``tpu-serve-real`` under ``ServeLoad``,
    ``TorchDeviceSource`` serves its duty cycle and bandwidth, mirror pods
    report its bandwidth, and the shipped serve HPA scales on
    ``tpu_serve_hbm_bw_avg``: 0.1 devices of demand, then 8."""
    spec = serve_spec()
    saturated, headroom = measure_saturated_signal(gen)
    if not signal_ceiling_clears_band(headroom, 1.0):
        raise RuntimeError(
            f"inert pairing: the saturated signal {saturated}% of the "
            f"{gen.peak_hbm_gbps} GB/s peak cannot clear the band above target "
            f"{spec.target} (headroom {headroom:.3f}x)"
        )
    source = TorchDeviceSource(
        util_fn=gen.utilization, bw_fn=gen.hbm_bw_utilization, device=gen.device
    )
    load = ServeLoad(gen)
    result = _live_trial(spec, source, load.step, load, load.utilization, time_scale)
    result.saturated_pct = saturated
    result.headroom = headroom
    return result
