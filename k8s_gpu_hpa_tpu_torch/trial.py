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

Every control-plane period (pod start latency, HPA sync, scrape interval,
behavior windows and periods, the budget) multiplies by ``time_scale``, as
bench.py's ``BENCH_TIME_SCALE`` does, so that a short run exercises the same
code path.  The loop takes its clock as an argument: a ``SystemClock`` for a
real run, a ``VirtualClock`` for a scripted one.
"""

from __future__ import annotations

import threading
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
)
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import TorchDeviceSource
from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.rules import RecordingRule, RuleEvaluator, tpu_test_avg_rule
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_DUTY_CYCLE,
    ChipSample,
    MetricFamily,
    families_from_chips,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import Scraper, TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock

if TYPE_CHECKING:
    from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen

TARGET = 40.0
MAX_REPLICAS = 4
REAL_POD = "tpu-test-real"
TENSORCORE_SERIES = "tpu_test_tensorcore_avg"
DUTY_SERIES = "tpu_test_duty_cycle_avg"
BASE_POD_START_LATENCY = 12.0
BASE_HPA_SYNC = 15.0
BASE_BUDGET_S = 60.0


def tpu_test_rules() -> list[RecordingRule]:
    """The shipped ``tpu-test`` rule group's tensor-core and duty-cycle rules."""
    return [
        tpu_test_avg_rule(),
        tpu_test_avg_rule(metric=TPU_DUTY_CYCLE, record=DUTY_SERIES),
    ]


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

    def __init__(self, clock: Clock, pod_start_latency: float):
        self.clock = clock
        self.pod_start_latency = pod_start_latency
        self.replicas = 1
        #: pod name -> ready_at timestamp (the real pod is always ready)
        self.pods: dict[str, float] = {REAL_POD: -float("inf")}
        self._counter = 0

    def scale_to(self, n: int) -> None:
        while len(self.pods) < n:
            self._counter += 1
            self.pods[f"tpu-test-sim{self._counter}"] = (
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


def http_fetch(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return r.read().decode()


def mirror_exposition(deployment: MirrorDeployment, util: float) -> str:
    """The synthetic node's /metrics: one device per started mirror pod, each
    reading the real device's current utilization."""
    chips, attribution = [], {}
    for i, pod in enumerate(p for p in deployment.running() if p != REAL_POD):
        chips.append(ChipSample(i, util, util, 8e9, 16e9, util * 0.6))
        attribution[i] = ("default", pod)
    return encode_text(families_from_chips(chips, "sim-0", attribution))


def pod_labels_exposition(deployment: MirrorDeployment) -> str:
    """kube-state-metrics' ``kube_pod_labels`` for the deployment's pods."""
    fam = MetricFamily("kube_pod_labels", "gauge")
    for pod in deployment.pods:
        fam.add(1.0, namespace="default", pod=pod, label_app="tpu-test")
    return encode_text([fam])


def wire_pipeline(
    fetch_real: Callable[[], str],
    mirror_util: Callable[[], float],
    clock: Clock,
    time_scale: float = 1.0,
    metric: str = DUTY_SERIES,
) -> Pipeline:
    """Build the metric pipeline and HPA around a fresh MirrorDeployment.

    ``fetch_real`` serves the real pod's exposition (its node is ``real-0``),
    ``mirror_util`` the percent the mirror pods report, and ``metric`` is the
    recorded series the HPA targets."""
    deployment = MirrorDeployment(clock, BASE_POD_START_LATENCY * time_scale)
    db = TimeSeriesDB(clock)
    scraper = Scraper(db)
    scraper.add_target(fetch_real, name="exporter/real", node="real-0")
    scraper.add_target(
        lambda: mirror_exposition(deployment, mirror_util()),
        name="exporter/sim",
        node="sim-0",
    )
    scraper.add_target(lambda: pod_labels_exposition(deployment), name="ksm")
    evaluator = RuleEvaluator(db, tpu_test_rules())
    adapter = CustomMetricsAdapter(db, [AdapterRule(series=metric)])
    hpa = HPAController(
        target=deployment,
        metrics=[
            ObjectMetricSpec(
                metric, TARGET, ObjectReference("Deployment", "tpu-test", "default")
            )
        ],
        adapter=adapter,
        clock=clock,
        min_replicas=1,
        max_replicas=MAX_REPLICAS,
        behavior=scaled_behavior(time_scale),
    )
    return Pipeline(deployment, db, scraper, evaluator, hpa, metric)


class Load(Protocol):
    """What the trial commands and reads: the load generator's knob and its
    windowed duty cycle."""

    def set_intensity(self, value: float) -> None: ...

    def utilization(self, _chip_index: int = 0) -> float: ...


@dataclass
class TrialResult:
    scale_up_s: float  # metric crossed the target -> all replicas running
    spike_to_cross_s: float
    #: (t after spike, tensorcore avg, duty-cycle avg) at each scrape
    series: list[tuple[float, float | None, float | None]] = field(default_factory=list)
    #: (t after spike, replicas, running) at each HPA sync and at the end
    replicas: list[tuple[float, int, int]] = field(default_factory=list)


def run_trial(
    load: Load,
    pipe: Pipeline,
    clock: Clock,
    time_scale: float = 1.0,
    tick: float = 0.05,
) -> TrialResult:
    """Settle at 0.2 devices of load, spike to 8, and time the scale-up.

    Raises RuntimeError when the metric never crosses the target or the
    deployment does not reach MAX_REPLICAS running pods within the budget
    after the crossing."""
    scrape_interval = max(0.05, 1.0 * time_scale)
    hpa_sync = BASE_HPA_SYNC * time_scale
    budget = BASE_BUDGET_S * time_scale
    deployment = pipe.deployment
    # drop to the pre-spike duty cycle and let the generator's window flush
    # any earlier load, so the crossing starts from a true baseline
    load.set_intensity(0.2)
    settle_deadline = clock.now() + max(30.0 * time_scale, 5.0)
    while load.utilization() > 30.0 and clock.now() < settle_deadline:
        clock.sleep(0.1)

    offered = 0.2  # in devices' worth; below the 40% target
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
            selector = {"deployment": "tpu-test"}
            value = pipe.db.latest(pipe.metric, selector)
            result.series.append(
                (
                    now - spike_at,
                    pipe.db.latest(TENSORCORE_SERIES, selector),
                    pipe.db.latest(DUTY_SERIES, selector),
                )
            )
            if t_cross is None and now >= spike_at and value is not None and value > TARGET:
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
        raise RuntimeError(f"{pipe.metric} never crossed {TARGET} after the spike")
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


def run_headline_trial(gen: MatmulLoadGen, time_scale: float = 1.0) -> TrialResult:
    """The headline trial around one load generator, in real time.

    The generator runs in its own thread, as the workload runs in its own
    pod.  ``TorchDeviceSource`` reads its self-reported gauges, and an
    ``ExporterDaemon`` serves them over HTTP on an ephemeral port of
    127.0.0.1 as pod ``tpu-test-real`` on node ``real-0``, fed by a thread
    every half second (times ``time_scale``).  The scraper reads that
    endpoint over HTTP; the HPA targets the duty-cycle average.  Every
    thread and the HTTP server are stopped before this returns or raises."""
    source = TorchDeviceSource(
        util_fn=gen.utilization, mxu_fn=gen.mxu_utilization, device=gen.device
    )
    daemon = ExporterDaemon(
        source,
        StaticAttributor({0: ("default", REAL_POD)}),
        node_name="real-0",
        listen_addr="127.0.0.1",
        port=0,
    )
    clock = SystemClock()
    stop = threading.Event()
    feed_interval = max(0.05, 0.5 * time_scale)

    def feed() -> None:
        while not stop.is_set():
            daemon.step()
            stop.wait(feed_interval)

    feeder = threading.Thread(target=feed, name="exporter-feed", daemon=True)
    load = LoadThread(gen.step)
    try:
        feeder.start()
        load.start()
        pipe = wire_pipeline(
            lambda: http_fetch(daemon.port), gen.utilization, clock, time_scale
        )
        return run_trial(gen, pipe, clock, time_scale)
    finally:
        stop.set()
        feeder.join(10)
        load.stop()
        daemon.close()
