"""The closed autoscaling loop around one real device: the headline trial.

The port's counterpart of the headline trial in the repository's bench.py
(``MirrorDeployment``, ``_wire_pipeline``, ``run_trial`` and
``run_overshoot_probe``).  One real pod, ``tpu-test-real``, runs the matmul load
generator on the device; its exporter serves the generator's self-reported
gauges over HTTP.  The deployment's other replicas are mirror pods on a
synthetic node whose gauges copy the real device's current utilization once
they have started.  A scraper feeds a TSDB, the shipped ``tpu-test`` rule
group records the per-deployment averages, and an HPA with target 40 and
1..4 replicas scales the deployment through the custom-metrics adapter.

The trial offers 0.2 devices of load, then spikes to 8 devices' worth: the
generator's intensity is the per-running-pod share, so it runs flat out
until four pods share the load.  The scale-up fails if all four replicas do
not run within the budget after the metric crossed the target.  Then the
headline trial drains, as bench.py's does: the load drops to 0.08 devices,
and the trial times the way back to one replica under the shipped
behavior (a 120 s window, then 50% every 60 s) and counts the flaps, the
syncs at which the replicas rise again after a fall.  The other loops end
at the scale-up.  The overshoot probe (``run_overshoot_probe``) offers one
device of load, whose steady need is 3 of 4 replicas, and counts the
replicas the HPA asks for beyond 3 while its metric still reads the load
from before the new pods started.

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

The training trial (``run_train_trial``, the counterpart of bench.py's
``run_rung_train_multimetric``) runs the loop around the ResNet training
generator: pod ``tpu-train-real``, both rules of the ``tpu-train`` group and
the shipped two-metric HPA (duty cycle target 50, bandwidth target 30).  The
duty cycle is a 3 s sliding busy fraction (``WindowedDuty``).  No source on
the card serves the bandwidth gauge, so it is absent, and the HPA decides by
the metrics it has: the duty cycle alone.

Every control-plane period (pod start latency, HPA sync, scrape interval,
behavior windows and periods, the budget) multiplies by ``time_scale``, as
bench.py's ``BENCH_TIME_SCALE`` does, so that a short run exercises the same
code path.  The loop takes its clock as an argument: a ``SystemClock`` for a
real run, a ``VirtualClock`` for a scripted one.
"""

from __future__ import annotations

import dataclasses
import math
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
    TRAIN_BW_SERIES,
    TRAIN_DUTY_SERIES,
    HPABehavior,
    HPAController,
    ObjectMetricSpec,
    shipped_behavior,
    signal_ceiling_clears_band,
    train_metrics,
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
    from k8s_gpu_hpa_tpu_torch.loadgen.train import TrainLoadGen

TARGET = 40.0
MAX_REPLICAS = 4
REAL_POD = "tpu-test-real"
TENSORCORE_SERIES = "tpu_test_tensorcore_avg"
DUTY_SERIES = "tpu_test_duty_cycle_avg"
SERVE_POD = "tpu-serve-real"
SERVE_SERIES = "tpu_serve_hbm_bw_avg"
TRAIN_POD = "tpu-train-real"
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
    #: the HPA's Object metrics: recorded series and their targets
    metrics: tuple[ObjectMetricSpec, ...]
    #: recorded series read at each scrape into ``TrialResult.series``
    series: tuple[str, ...]
    #: offered load before the spike, in devices' worth
    base_offered: float
    #: the trial starts once ``Load.utilization()`` is at most this
    settle_below: float
    #: a started mirror pod's device, given the value ``mirror_util`` reads
    mirror_chip: Callable[[int, float], ChipSample]
    #: offered load once all replicas run, in devices' worth, whose drain
    #: back to one replica the trial times; None: the trial ends there
    drain_offered: float | None = None


def _mirror_busy(i: int, util: float) -> ChipSample:
    return ChipSample(i, util, util, 8e9, 16e9, util * 0.6)


def _mirror_bandwidth(i: int, bw: float) -> ChipSample:
    return ChipSample(i, None, None, 8e9, 16e9, bw)


def _mirror_duty(i: int, duty: float) -> ChipSample:
    # the duty cycle only, as bench.py's training rung: a bandwidth gauge
    # here would invent a tpu_train_hbm_bw_avg series the card never serves
    return ChipSample(i, None, duty, 0.0, 0.0, None)


def _on_deployment(app: str, metric: str, target: float) -> ObjectMetricSpec:
    return ObjectMetricSpec(metric, target, ObjectReference("Deployment", app, "default"))


def headline_spec(metric: str = DUTY_SERIES) -> LoopSpec:
    """The headline loop: the shipped ``tpu-test`` rule group, target 40."""
    return LoopSpec(
        app="tpu-test",
        real_pod=REAL_POD,
        rules=tuple(tpu_test_rules()),
        metrics=(_on_deployment("tpu-test", metric, TARGET),),
        series=(TENSORCORE_SERIES, DUTY_SERIES),
        base_offered=0.2,
        settle_below=30.0,
        mirror_chip=_mirror_busy,
        # well below one pod's target even once the load concentrates on
        # fewer pods (4 → 2 → 1), so every recommendation after the drop is
        # 1 and the drain is the behavior's own pace (bench.py's value)
        drain_offered=0.08,
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
        metrics=(_on_deployment("tpu-serve", SERVE_SERIES, SERVE_BW_TARGET),),
        series=(SERVE_SERIES,),
        base_offered=0.1,
        settle_below=SERVE_BW_TARGET / 2,
        mirror_chip=_mirror_bandwidth,
    )


def train_spec() -> LoopSpec:
    """The training loop: bench.py's training rung against the shipped
    tpu-train pair (deploy/tpu-train-hpa.yaml: ``train_metrics()``, 1..4
    replicas, the shipped behavior) with both rules of the ``tpu-train``
    group.  Each pod runs its own steps: 0.15 of the device before the
    spike, all of it after.  Mirror pods report the real pod's duty cycle
    and no bandwidth."""
    return LoopSpec(
        app="tpu-train",
        real_pod=TRAIN_POD,
        rules=tuple(
            tpu_test_avg_rule(app="tpu-train", deployment="tpu-train", metric=gauge, record=series)
            for gauge, series in ((TPU_DUTY_CYCLE, TRAIN_DUTY_SERIES),
                                  (TPU_HBM_BW_UTIL, TRAIN_BW_SERIES))
        ),
        metrics=tuple(train_metrics()),
        series=(TRAIN_DUTY_SERIES, TRAIN_BW_SERIES),
        base_offered=0.15,
        settle_below=30.0,
        mirror_chip=_mirror_duty,
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
    adapter = CustomMetricsAdapter(db, [AdapterRule(series=m.metric_name) for m in loop.metrics])
    hpa = HPAController(
        target=deployment,
        metrics=list(loop.metrics),
        adapter=adapter,
        clock=clock,
        min_replicas=1,
        max_replicas=MAX_REPLICAS,
        behavior=scaled_behavior(time_scale),
    )
    return Pipeline(deployment, db, scraper, evaluator, hpa, loop.metrics[0].metric_name, spec)


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
    #: (t after spike, {metric: the adapter's value, None where absent}) at
    #: each HPA sync: the metrics the HPA had
    metrics: list[tuple[float, dict[str, float | None]]] = field(default_factory=list)
    #: serve loop: the saturated signal measured before the loop, percent,
    #: and its headroom over the target
    saturated_pct: float | None = None
    headroom: float | None = None
    #: the load's drop once all replicas ran → one replica (None: no drain,
    #: or a drain that did not end within its bound), and the syncs of the
    #: drain at which the replicas rose after a fall
    scale_down_s: float | None = None
    scale_down_flaps: int = 0


class _Grid:
    """The scrapes' times: every ``period`` from ``first`` on a fixed grid,
    as Prometheus keeps them.  A due time is taken at the tick nearest it,
    and a late tick moves none of the times after it.  (bench.py's loop
    sets each next scrape from the tick that ran the last, so its scrapes
    drift against the syncs, and a sync can read a scrape up to a period
    old.)  The HPA's syncs stay off any grid: each comes a full period
    after the last one ran, as the controller requeues its target, so the
    policy periods the HPA looks back over have passed by the next sync."""

    def __init__(self, first: float, period: float, tick: float):
        self.first, self.period, self.slack = first, period, tick / 2
        self._k = 0

    def due(self, now: float) -> bool:
        if now < self.first + self._k * self.period - self.slack:
            return False
        self._k = math.floor((now + self.slack - self.first) / self.period) + 1
        return True


def _settle(load: Load, loop: LoopSpec, clock: Clock, time_scale: float) -> None:
    """Drop to the spec's base load and let the generator's window flush any
    earlier load, so the trial starts from a true baseline."""
    load.set_intensity(loop.base_offered)
    settle_deadline = clock.now() + max(30.0 * time_scale, 5.0)
    while load.utilization() > loop.settle_below and clock.now() < settle_deadline:
        clock.sleep(0.1)


def run_trial(
    load: Load,
    pipe: Pipeline,
    clock: Clock,
    time_scale: float = 1.0,
    tick: float = 0.05,
) -> TrialResult:
    """Settle at the spec's base load (0.2 devices for the headline loop),
    spike to 8, and time the scale-up.  The crossing is the first scrape
    after the spike at which any of the HPA's metrics exceeds its target.
    Where the spec drains (``drain_offered``), the load then drops and the
    trial times the drain to one replica, bounded at ``max(600 ×
    time_scale, 60)`` s, and counts its flaps.

    Raises RuntimeError when no metric crosses its target or the
    deployment does not reach MAX_REPLICAS running pods within the budget
    after the crossing."""
    loop = pipe.loop_spec()
    scrape_interval = max(0.05, 1.0 * time_scale)
    hpa_sync = BASE_HPA_SYNC * time_scale
    budget = BASE_BUDGET_S * time_scale
    deployment = pipe.deployment
    _settle(load, loop, clock, time_scale)

    offered = loop.base_offered  # in devices' worth; below the target
    start = clock.now()
    spike_at = start + 6.0 * time_scale
    t_cross = None
    t_done = None
    t_drop = None
    fell = False  # the replicas fell at a sync of the drain
    prev_replicas = deployment.replicas
    result = TrialResult(0.0, 0.0)
    scrapes = _Grid(start, scrape_interval, tick)
    next_sync = start + hpa_sync
    deadline = spike_at + 6.0 * hpa_sync + budget
    while clock.now() < deadline:
        now = clock.now()
        if t_drop is None and now >= spike_at:
            offered = 8.0  # drives per-pod utilization to 100 until 4 pods
        load.set_intensity(min(1.0, offered / max(1, len(deployment.running()))))
        if scrapes.due(now):
            pipe.scraper.scrape_once()
            pipe.evaluator.evaluate_once()
            selector = {"deployment": loop.app}
            result.series.append(
                (now - spike_at, *(pipe.db.latest(s, selector) for s in loop.series))
            )
            if t_cross is None and now >= spike_at and any(
                (value := pipe.db.latest(m.metric_name, selector)) is not None
                and value > m.target_value
                for m in loop.metrics
            ):
                t_cross = now
        if now >= next_sync:
            pipe.hpa.sync_once()
            next_sync = now + hpa_sync
            result.replicas.append(
                (now - spike_at, deployment.replicas, len(deployment.running()))
            )
            result.metrics.append((now - spike_at, {
                m.metric_name: pipe.hpa.adapter.get_object_metric(m.described_object, m.metric_name)
                for m in loop.metrics
            }))
            if t_drop is not None:
                if deployment.replicas > prev_replicas and fell:
                    result.scale_down_flaps += 1
                fell = fell or deployment.replicas < prev_replicas
            prev_replicas = deployment.replicas
        if (
            t_done is None
            and t_cross is not None
            and deployment.replicas == MAX_REPLICAS
            and len(deployment.running()) == MAX_REPLICAS
        ):
            t_done = now
            result.replicas.append((now - spike_at, MAX_REPLICAS, MAX_REPLICAS))
            if loop.drain_offered is None:
                break
            t_drop, offered = now, loop.drain_offered
            deadline = now + max(600.0 * time_scale, 60.0)
        if t_drop is not None and deployment.replicas == 1:
            result.scale_down_s = now - t_drop
            result.replicas.append((now - spike_at, 1, len(deployment.running())))
            break
        clock.sleep(tick)
    if t_cross is None:
        targets = ", ".join(f"{m.metric_name} {m.target_value}" for m in loop.metrics)
        raise RuntimeError(f"no metric crossed its target after the spike ({targets})")
    if t_done is None or t_done - t_cross > budget:
        raise RuntimeError(
            f"no scale-up to {MAX_REPLICAS} running replicas within {budget:.1f}s "
            f"of the crossing; replicas: {result.replicas}"
        )
    result.scale_up_s = t_done - t_cross
    result.spike_to_cross_s = t_cross - spike_at
    return result


#: the overshoot probe's offered load, in devices' worth, and the replicas
#: it needs: at n running pods each is 100/n % busy, and ceil(n × (100/n) /
#: 40) is 3 at n = 1 and at n = 3
PROBE_OFFERED = 1.0
PROBE_NEED = 3


def run_overshoot_probe(
    load: Load,
    pipe: Pipeline,
    clock: Clock,
    time_scale: float = 1.0,
    tick: float = 0.05,
    log: Callable[[str], None] | None = None,
) -> int:
    """bench.py's overshoot probe: settle at the spec's base load, offer
    ``PROBE_OFFERED`` device, and watch two further syncs and 2 s (times
    ``time_scale``) after ``PROBE_NEED`` pods run, where a sync that reads
    the metric from before the new pods started would overshoot.  Returns
    the most replicas seen less ``PROBE_NEED``, at least 0; ``log`` gets a
    line at each sync.  Raises RuntimeError when ``PROBE_NEED`` pods never
    run within ``max(240 × time_scale, 60)`` s."""
    loop = pipe.loop_spec()
    scrape_interval = max(0.05, 1.0 * time_scale)
    hpa_sync = BASE_HPA_SYNC * time_scale
    deployment = pipe.deployment
    _settle(load, loop, clock, time_scale)

    offered = loop.base_offered
    start = clock.now()
    spike_at = start + 6.0 * time_scale
    max_seen = deployment.replicas
    t_steady = None
    scrapes = _Grid(start, scrape_interval, tick)
    next_sync = start + hpa_sync
    deadline = start + max(240.0 * time_scale, 60.0)
    while clock.now() < deadline:
        now = clock.now()
        if now >= spike_at:
            offered = PROBE_OFFERED
        load.set_intensity(min(1.0, offered / max(1, len(deployment.running()))))
        if scrapes.due(now):
            pipe.scraper.scrape_once()
            pipe.evaluator.evaluate_once()
        if now >= next_sync:
            pipe.hpa.sync_once()
            next_sync = now + hpa_sync
            max_seen = max(max_seen, deployment.replicas)
            if log is not None:
                values = (pipe.hpa.adapter.get_object_metric(m.described_object, m.metric_name)
                          for m in loop.metrics)
                read = " ".join(f"read={v:.2f}" if v is not None else "read=none" for v in values)
                log(f"probe sync: t={now - spike_at:+.2f}s {read} replicas={deployment.replicas} "
                    f"running={len(deployment.running())} max_seen={max_seen}")
        if t_steady is None and len(deployment.running()) >= PROBE_NEED:
            t_steady = now
        # a metric-lag overshoot fires at the first sync after the new pods
        # start: two further syncs cover it
        if t_steady is not None and now >= t_steady + 2 * hpa_sync + 2.0 * time_scale:
            break
        clock.sleep(tick)
    if t_steady is None:
        raise RuntimeError(f"the overshoot probe never had {PROBE_NEED} pods running")
    return max(0, max_seen - PROBE_NEED)


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
    drive: Callable[..., object] = run_trial,
):
    """Run ``step`` in its own thread, as the workload runs in its own pod,
    serve ``source`` over HTTP as the spec's real pod, and drive the loop
    (``run_trial``, or ``run_overshoot_probe``): what ``drive`` returns.

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
        return drive(load, pipe, clock, time_scale)
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
    return _live_trial(
        headline_spec(metric), _matmul_source(gen), gen.step, gen, gen.utilization, time_scale
    )


def _matmul_source(gen: MatmulLoadGen) -> TorchDeviceSource:
    return TorchDeviceSource(
        util_fn=gen.utilization, mxu_fn=gen.mxu_utilization, device=gen.device
    )


def run_headline_overshoot_probe(
    gen: MatmulLoadGen, log: Callable[[str], None] | None = None
) -> int:
    """``run_overshoot_probe`` on the headline loop around one matmul load
    generator, in real time at time scale 1, wired as ``run_headline_trial``
    wires it.  Its HPA reads the duty-cycle average, where each of n running
    pods reads 100/n under one device of load, as the probe's need of 3
    assumes: on the tensor-core average the real pod reads its MFU, about
    half its duty cycle, and the need would be 2."""
    return _live_trial(
        headline_spec(DUTY_SERIES), _matmul_source(gen), gen.step, gen, gen.utilization, 1.0,
        drive=lambda *args: run_overshoot_probe(*args, log=log),
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
    It ends at the scale-up.  The source is closed before this returns."""
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
            # the scale-up alone: the headline trial times the drain
            dataclasses.replace(headline_spec(TENSORCORE_SERIES), drain_offered=None),
            source, step, gen, gen.utilization,
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
            f"{SERVE_BW_TARGET} (headroom {headroom:.3f}x)"
        )
    source = TorchDeviceSource(
        util_fn=gen.utilization, bw_fn=gen.hbm_bw_utilization, device=gen.device
    )
    load = ServeLoad(gen)
    result = _live_trial(spec, source, load.step, load, load.utilization, time_scale)
    result.saturated_pct = saturated
    result.headroom = headroom
    return result


class WindowedDuty:
    """Busy fraction over a sliding window, percent: the training pod's
    duty-cycle gauge (``TrainStats.utilization`` is cumulative since the
    start and cannot show a spike).  Locked: the training thread records
    while the exporter's feed thread reads."""

    def __init__(self, window: float = 3.0):
        self.window = window
        self._events: list[tuple[float, float]] = []
        self._lock = threading.Lock()

    def record(self, busy: float) -> None:
        now = time.perf_counter()
        with self._lock:
            self._events.append((now, busy))

    def value(self, _chip_index: int = 0) -> float:
        now = time.perf_counter()
        cutoff = now - self.window
        with self._lock:
            self._events = [(t, b) for t, b in self._events if t >= cutoff]
            if not self._events:
                return 0.0
            busy = sum(b for _, b in self._events)
            first = min(t for t, _ in self._events)
        wall = max(now - first, busy, 1e-9)
        return min(100.0, 100.0 * busy / wall)


class TrainLoad:
    """The training pod's workload around a training generator, shaped as
    bench.py's training rung shapes it: after each step, sleep ``busy * (1 -
    i) / i``, at most 2 s, with ``i`` at least 0.01; the whole iteration
    counts as busy.  Its ``utilization`` is the windowed duty cycle."""

    def __init__(self, gen: TrainLoadGen, window: float = 3.0):
        self.gen = gen
        self.duty = WindowedDuty(window)
        self._intensity = 0.15

    def set_intensity(self, value: float) -> None:
        self._intensity = value

    def utilization(self, _chip_index: int = 0) -> float:
        return self.duty.value()

    def step(self) -> None:
        i = max(self._intensity, 0.01)
        t0 = time.perf_counter()
        self.gen.step()
        busy = time.perf_counter() - t0
        self.duty.record(busy)
        time.sleep(min(busy * (1.0 - i) / i, 2.0))


def run_train_trial(gen: TrainLoadGen, time_scale: float = 1.0) -> TrialResult:
    """The training trial around one training generator, in real time.

    The generator runs as pod ``tpu-train-real`` under ``TrainLoad``:
    intensity 0.15, then 1.0 on every pod after the spike.
    ``TorchDeviceSource`` serves its windowed duty cycle and no bandwidth
    gauge (none is measured on the card), mirror pods report the same duty
    cycle, and the shipped two-metric HPA scales on the metrics it has.
    The duty cycle's 3 s window multiplies by ``time_scale`` too."""
    load = TrainLoad(gen, window=3.0 * time_scale)
    source = TorchDeviceSource(util_fn=load.utilization, device=gen.device)
    return _live_trial(train_spec(), source, load.step, load, load.utilization, time_scale)
