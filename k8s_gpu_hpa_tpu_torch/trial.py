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

The slice trial (``run_slice_trial``, the counterpart of bench.py's
``run_rung_multihost_quantum``) scales a StatefulSet of multi-host slices
(``MirrorStatefulSet``: pods ``tpu-test-multihost-<ordinal>``, two hosts a
slice) in whole-slice quanta under the shipped slice HPA
(deploy/tpu-test-multihost-hpa.yaml: target 40, pods 2..8, quantum 2).  The
real pod, ordinal 0, runs the slice container's collective generator; its
slice peer and the other slices are mirror pods.  It offers 0.2 devices of
load, then 3.2 ("320 shared"): 53.3 a pod at 6 pods, which needs all 8, and
40 at 8.  It counts the scale events that land off a slice boundary.

The HBM trial (``run_hbm_pods_trial``, the counterpart of bench.py's
``run_rung_hbm_pods``) scales the ``tpu-test-v5e8`` Deployment under the
shipped HBM HPA (deploy/tpu-test-hbm-hpa.yaml: a Pods metric, the per-pod
hottest device's bytes in use, AverageValue 13Gi, pods 1..4) through the
pod-max rule and the adapter's Pods API.  The real pod holds real device
memory (``HbmHold``), and each running pod's one device reports the bytes
the real pod holds.  It offers 0.5 GiB, then from 3 s after the start
44 GiB shared by the running pods, each holding at most 14.5 GiB (bench.py's
traffic), and ends at the scale-up.  The External rung
(``run_external_queue_trial``, the counterpart of bench.py's
``run_rung_external_queue``) runs the shipped queue-depth HPA on a virtual
clock over ``control/external_sim.py``; ``QueueJoint`` is that HPA's path
on a node, around a serving container that runs as its own process.  The
cpu rung (``run_cpu_resource_trial``, bench.py's ``run_rung_cpu_resource``)
scales the CPU busy-loop under the shipped Resource HPA on a virtual clock,
over the simulated cluster of ``control/cluster.py``.  The signal-latency
rung (``run_signal_latency_trial``, bench.py's ``run_rung_signal_latency``)
traces the assembled pipeline of ``control/loop.py`` under a staircase of
load steps and reports how long each step takes to reach a sync and a scale
event.  The live loops run untraced, as bench.py's.  The chaos rungs,
``chaos_storm_rung`` and ``slo_burn_rung`` (bench.py's ``run_rung_chaos``
and ``run_rung_slo_burn``), run the canned fault storm and the SLO
burn-rate check on virtual clocks, and ``recovery_drill_rung`` (bench.py's
``run_rung_recovery_drill``, ``drill_rung`` of a finished drill) the
recovery drill, each durable component crashed and rebuilt mid-run.  The
metrics plane's rungs, ``sim_scale_rung``, ``sim_scale_10k_rung``,
``query_bench_rung`` and ``downsample_bench_rung`` (bench.py's
``run_rung_sim_scale``, ``run_rung_sim_scale_10k``, ``run_rung_query_bench``
and ``run_rung_downsample_bench``), drive the fleet harnesses of ``control/scale_harness.py`` at the smoke sizes of
``perfgates.py`` or, with ``full``, its full sizes.  ``region_evacuation_rung``
(bench.py's ``run_rung_region_evacuation``, ``evacuation_rung`` of a
finished run and its canary) runs the region evacuation and its planted
canary on virtual clocks.  ``profile_bench_rung`` (bench.py's
``run_rung_profile_bench``) profiles the fleet scale and the storm: the
scale run's attribution, same-seed bit-identity and the planted canary.
``chaos_fuzz_rung`` (bench.py's ``run_rung_chaos_fuzz``) runs the fuzz
campaign twice and its break-grace canary (minutes of wall time on a CPU),
and ``paging_bench_rung`` (bench.py's ``run_rung_paging_bench``) the three
paging drills, the mis-inhibition canary and a second smoke evacuation.
``coverage_floor_rung`` (bench.py's ``run_rung_coverage_floor``) gates the
union coverage of every canned run against the coverage floors (some 70 s
on a CPU, or a finished ``run_coverage("all")`` export).

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
import json
import math
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Protocol

import torch

from k8s_gpu_hpa_tpu_torch.chaos import run_fault_storm, run_region_evacuation
from k8s_gpu_hpa_tpu_torch.control.adapter import (
    AdapterRule,
    CustomMetricsAdapter,
    ExternalRule,
    ObjectReference,
)
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment, SimResourceMetrics
from k8s_gpu_hpa_tpu_torch.control.external_sim import ScaleTarget, external_sim_from_manifest
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HBM_APP,
    HBM_SERIES,
    TRAIN_BW_SERIES,
    TRAIN_DUTY_SERIES,
    MULTIHOST_MAX_REPLICAS,
    MULTIHOST_MIN_REPLICAS,
    MULTIHOST_QUANTUM,
    MULTIHOST_SERIES,
    MULTIHOST_TARGET,
    HPABehavior,
    HPAController,
    ObjectMetricSpec,
    PodsMetricSpec,
    ResourceMetricSpec,
    behavior_from_manifest,
    hbm_metrics,
    metrics_from_manifest,
    shipped_behavior,
    shipped_multihost_behavior,
    signal_ceiling_clears_band,
    train_metrics,
)
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.control.scale_harness import (
    run_downsample_bench,
    run_fleet_scale,
    run_query_bench,
    run_recovery_drill,
)
from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import Attributor, StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.selfreport import SelfReportReader
from k8s_gpu_hpa_tpu_torch.exporter.sources import MetricsSource, NvmlSource, TorchDeviceSource
from k8s_gpu_hpa_tpu_torch.loadgen.telemetry import TelemetryWriter
from k8s_gpu_hpa_tpu_torch.manifests import external_hpa_doc, load_yaml
from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    SERVE_BW_TARGET,
    RecordingRule,
    RuleEvaluator,
    tpu_test_avg_rule,
    tpu_test_multihost_avg_rule,
    tpu_test_pod_max_rule,
)
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_DUTY_CYCLE,
    TPU_HBM_BW_UTIL,
    TPU_TENSORCORE_UTIL,
    ChipSample,
    MetricFamily,
    families_from_chips,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import Scraper, TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.obs import TracedLoad, Tracer, propagation_report
from k8s_gpu_hpa_tpu_torch.simulate import run_slo_check
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock, VirtualClock

if TYPE_CHECKING:
    from k8s_gpu_hpa_tpu_torch.loadgen.allreduce import AllReduceLoadGen
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
MULTIHOST_APP = "tpu-test-multihost"
#: the slice trial on the card: the duty-cycle series of the slice rule,
#: named with the JAX manifests' stem for the duty cycle
MULTIHOST_DUTY_SERIES = "tpu_test_multihost_duty_cycle_avg"
BASE_POD_START_LATENCY = 12.0
BASE_HPA_SYNC = 15.0
BASE_BUDGET_S = 60.0
GIB = 1 << 30
#: the HBM trial (bench.py's run_rung_hbm_pods): the real pod, the base
#: demand, the demand from 3 s after the start, shared by the running pods,
#: and the most one pod holds
HBM_POD = f"{HBM_APP}-real"
HBM_BASE = GIB // 2
HBM_DEMAND = 44 * GIB
HBM_CAP = 14.5 * GIB


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
    #: the HPA's metrics: Object metrics (recorded series on the object and
    #: their targets) or Pods metrics (per-pod series averaged over the
    #: running pods)
    metrics: tuple[ObjectMetricSpec | PodsMetricSpec, ...]
    #: recorded series read at each scrape into ``TrialResult.series``
    series: tuple[str, ...]
    #: offered load before the spike, in devices' worth
    base_offered: float
    #: the trial starts once ``Load.utilization()`` is at most this
    settle_below: float
    #: a started mirror pod's device, given the value ``mirror_util`` reads
    mirror_chip: Callable[[int, float], ChipSample]
    #: offered load once all replicas run, in devices' worth, whose drain
    #: back to ``min_replicas`` the trial times; None: the trial ends there
    drain_offered: float | None = None
    #: offered load after the spike, in devices' worth
    spike_offered: float = 8.0
    min_replicas: int = 1
    max_replicas: int = MAX_REPLICAS
    #: pods a slice: replicas move in multiples of it
    replica_quantum: int = 1
    #: the HPA's behavior stanza at time scale 1
    behavior: Callable[[], HPABehavior] = shipped_behavior
    #: seconds from the start to the spike, at time scale 1
    spike_after: float = 6.0

    @property
    def kind(self) -> str:
        """The scaled object's kind, the HPA's metrics' described object's:
        ``Deployment`` or ``StatefulSet``; a Deployment for Pods metrics."""
        metric = self.metrics[0]
        return "Deployment" if isinstance(metric, PodsMetricSpec) else metric.described_object.kind

    @property
    def object_label(self) -> str:
        """The recorded series' label that names the scaled object."""
        return self.kind.lower()


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


def slice_spec(metric: str = TPU_TENSORCORE_UTIL, record: str = MULTIHOST_SERIES) -> LoopSpec:
    """The slice loop: bench.py's multihost rung against the shipped slice
    HPA (deploy/tpu-test-multihost-hpa.yaml: target 40 on the StatefulSet,
    pods 2..8, quantum 2, its behavior) with the slice rule on ``metric``,
    recorded as ``record``.  The trial offers 0.2 devices of load, then 3.2;
    it drains back to 0.2.  Mirror pods report the real pod's value in
    both activity gauges."""
    return LoopSpec(
        app=MULTIHOST_APP,
        real_pod=f"{MULTIHOST_APP}-0",
        rules=(tpu_test_multihost_avg_rule(metric=metric, record=record),),
        metrics=(ObjectMetricSpec(
            record, MULTIHOST_TARGET, ObjectReference("StatefulSet", MULTIHOST_APP, "default")
        ),),
        series=(record,),
        base_offered=0.2,
        settle_below=30.0,
        mirror_chip=_mirror_busy,
        drain_offered=0.2,
        spike_offered=3.2,
        min_replicas=MULTIHOST_MIN_REPLICAS,
        max_replicas=MULTIHOST_MAX_REPLICAS,
        replica_quantum=MULTIHOST_QUANTUM,
        behavior=shipped_multihost_behavior,
    )


def hbm_pods_spec(hbm_total: float = 80 * GIB) -> LoopSpec:
    """The HBM loop: bench.py's HBM rung against the shipped HBM HPA
    (``hbm_metrics()``: Pods, AverageValue 13Gi, pods 1..4, the shipped
    behavior) through the pod-max rule on the per-device bytes in use.  The
    offered load is in units of ``HBM_CAP``, so that each running pod holds
    ``min(1, offered / running) × HBM_CAP``: 0.5 GiB, then
    ``min(44 GiB / running, 14.5 GiB)``.  Mirror pods report the real pod's
    held bytes of ``hbm_total``."""
    return LoopSpec(
        app=HBM_APP,
        real_pod=HBM_POD,
        rules=(tpu_test_pod_max_rule(app=HBM_APP, record=HBM_SERIES),),
        metrics=tuple(hbm_metrics()),
        series=(HBM_SERIES,),
        base_offered=HBM_BASE / HBM_CAP,
        settle_below=HBM_BASE,
        mirror_chip=lambda i, held: ChipSample(i, None, None, held, hbm_total, None),
        spike_offered=HBM_DEMAND / HBM_CAP,
        spike_after=3.0,
    )


def scaled_behavior(time_scale: float, behavior: HPABehavior) -> HPABehavior:
    """``behavior`` with every window and period times ``time_scale``."""
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

    def ready_pod_names(self) -> list[str]:
        """The pods a Pods-type metric is read for (``PodLister``)."""
        return self.running()


class MirrorStatefulSet(MirrorDeployment):
    """Scalable StatefulSet whose pods are ``<app>-<ordinal>``: ordinal 0 is
    the real pod, the others mirror its device.  It starts with
    ``replicas`` pods running; scaling adds the next ordinals, each running
    ``pod_start_latency`` after, and removes the highest, as a StatefulSet
    does."""

    def __init__(self, clock: Clock, pod_start_latency: float, app: str, replicas: int):
        super().__init__(clock, pod_start_latency, f"{app}-0", app)
        self.pods = {f"{app}-{i}": -float("inf") for i in range(replicas)}
        self.replicas = replicas

    def scale_to(self, n: int) -> None:
        while len(self.pods) < n:
            self.pods[f"{self.app}-{len(self.pods)}"] = self.clock.now() + self.pod_start_latency
        while len(self.pods) > n:
            self.pods.pop(f"{self.app}-{len(self.pods) - 1}")
        self.replicas = n


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
    """Build the metric pipeline and HPA around a fresh MirrorDeployment
    (a MirrorStatefulSet at its minimum for a StatefulSet spec).

    ``fetch_real`` serves the real pod's exposition (its node is ``real-0``),
    ``mirror_util`` the value the mirror pods report.  ``spec`` is the loop
    (default: the headline loop with ``metric`` the recorded series the HPA
    targets)."""
    loop = spec if spec is not None else headline_spec(metric)
    latency = BASE_POD_START_LATENCY * time_scale
    if loop.kind == "StatefulSet":
        deployment = MirrorStatefulSet(clock, latency, loop.app, loop.min_replicas)
    else:
        deployment = MirrorDeployment(clock, latency, loop.real_pod, loop.app)
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
    overrides = {"namespace": "namespace", loop.object_label: loop.kind}
    pod_overrides = {"namespace": "namespace", "pod": "Pod"}
    adapter = CustomMetricsAdapter(db, [
        AdapterRule(m.metric_name, dict(pod_overrides if isinstance(m, PodsMetricSpec) else overrides))
        for m in loop.metrics
    ])
    hpa = HPAController(
        target=deployment,
        metrics=list(loop.metrics),
        adapter=adapter,
        clock=clock,
        min_replicas=loop.min_replicas,
        max_replicas=loop.max_replicas,
        behavior=scaled_behavior(time_scale, loop.behavior()),
        replica_quantum=loop.replica_quantum,
        pod_lister=deployment,
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
    #: each HPA sync: the metrics the HPA had (a Pods metric's value is its
    #: mean over the running pods)
    metrics: list[tuple[float, dict[str, float | None]]] = field(default_factory=list)
    #: (t after spike, the HPA's reason) at each HPA sync
    reasons: list[tuple[float, str]] = field(default_factory=list)
    #: serve loop: the saturated signal measured before the loop, percent,
    #: and its headroom over the target
    saturated_pct: float | None = None
    headroom: float | None = None
    #: the load's drop once all replicas ran → the minimum (None: no drain,
    #: or a drain that did not end within its bound), and the syncs of the
    #: drain at which the replicas rose after a fall
    scale_down_s: float | None = None
    scale_down_flaps: int = 0
    #: scale events whose new replica count is not a multiple of the
    #: spec's quantum (a partial slice)
    slice_boundary_violations: int = 0


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


def pods_mean(pipe: Pipeline, metric: PodsMetricSpec) -> float | None:
    """A Pods metric as the HPA reads it: the adapter's per-pod values of
    the running pods, averaged; None where no pod has one."""
    values = pipe.hpa.adapter.get_pods_metric(
        "default", metric.metric_name, pipe.deployment.running()
    )
    return sum(values.values()) / len(values) if values else None


def _hpa_reading(pipe: Pipeline, metric: ObjectMetricSpec | PodsMetricSpec) -> float | None:
    """The value the adapter serves the HPA for ``metric``."""
    if isinstance(metric, PodsMetricSpec):
        return pods_mean(pipe, metric)
    return pipe.hpa.adapter.get_object_metric(metric.described_object, metric.metric_name)


def _settle(load: Load, loop: LoopSpec, clock: Clock, time_scale: float) -> None:
    """Drop to the spec's base load and let the generator's window flush any
    earlier load, so the trial starts from a true baseline."""
    load.set_intensity(min(1.0, loop.base_offered / loop.min_replicas))
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
    spike to the spec's ``spike_offered`` (8 devices), and time the
    scale-up.  The crossing is the first scrape after the spike at which
    any of the HPA's metrics exceeds its target.  Where the spec drains
    (``drain_offered``), the load then drops and the trial times the drain
    to the spec's minimum, bounded at ``max(600 × time_scale, 60)`` s, and
    counts its flaps.  Every sync's scale event off the spec's quantum
    counts as a slice-boundary violation.

    Raises RuntimeError when no metric crosses its target or the
    deployment does not reach the spec's maximum of running pods within
    the budget after the crossing."""
    loop = pipe.loop_spec()
    scrape_interval = max(0.05, 1.0 * time_scale)
    hpa_sync = BASE_HPA_SYNC * time_scale
    budget = BASE_BUDGET_S * time_scale
    deployment = pipe.deployment
    top = loop.max_replicas
    _settle(load, loop, clock, time_scale)

    offered = loop.base_offered  # in devices' worth; below the target
    start = clock.now()
    spike_at = start + loop.spike_after * time_scale
    t_cross = None
    t_done = None
    t_drop = None
    fell = False  # the replicas fell at a sync of the drain
    prev_replicas = deployment.replicas
    result = TrialResult(0.0, 0.0)
    scrapes = _Grid(start, scrape_interval, tick)
    next_sync = start + hpa_sync
    deadline = spike_at + 6.0 * hpa_sync + budget
    selector = {loop.object_label: loop.app}
    pods = {m.metric_name: m for m in loop.metrics if isinstance(m, PodsMetricSpec)}

    def reading(name: str) -> float | None:
        # a recorded series on the object, or a Pods metric as the HPA reads it
        return pods_mean(pipe, pods[name]) if name in pods else pipe.db.latest(name, selector)

    while clock.now() < deadline:
        now = clock.now()
        if t_drop is None and now >= spike_at:
            offered = loop.spike_offered
        load.set_intensity(min(1.0, offered / max(1, len(deployment.running()))))
        if scrapes.due(now):
            pipe.scraper.scrape_once()
            pipe.evaluator.evaluate_once()
            result.series.append((now - spike_at, *(reading(s) for s in loop.series)))
            if t_cross is None and now >= spike_at and any(
                (value := reading(m.metric_name)) is not None and value > _target(m)
                for m in loop.metrics
            ):
                t_cross = now
        if now >= next_sync:
            status = pipe.hpa.sync_once()
            next_sync = now + hpa_sync
            result.replicas.append(
                (now - spike_at, deployment.replicas, len(deployment.running()))
            )
            result.metrics.append(
                (now - spike_at, {m.metric_name: _hpa_reading(pipe, m) for m in loop.metrics})
            )
            result.reasons.append((now - spike_at, status.last_reason))
            if deployment.replicas != prev_replicas and deployment.replicas % loop.replica_quantum:
                result.slice_boundary_violations += 1
            if t_drop is not None:
                if deployment.replicas > prev_replicas and fell:
                    result.scale_down_flaps += 1
                fell = fell or deployment.replicas < prev_replicas
            prev_replicas = deployment.replicas
        if (
            t_done is None
            and t_cross is not None
            and deployment.replicas == top
            and len(deployment.running()) == top
        ):
            t_done = now
            result.replicas.append((now - spike_at, top, top))
            if loop.drain_offered is None:
                break
            t_drop, offered = now, loop.drain_offered
            deadline = now + max(600.0 * time_scale, 60.0)
        if t_drop is not None and deployment.replicas == loop.min_replicas:
            result.scale_down_s = now - t_drop
            result.replicas.append((now - spike_at, loop.min_replicas, len(deployment.running())))
            break
        clock.sleep(tick)
    if t_cross is None:
        targets = ", ".join(f"{m.metric_name} {_target(m)}" for m in loop.metrics)
        raise RuntimeError(f"no metric crossed its target after the spike ({targets})")
    if t_done is None or t_done - t_cross > budget:
        raise RuntimeError(
            f"no scale-up to {top} running replicas within {budget:.1f}s "
            f"of the crossing; replicas: {result.replicas}"
        )
    result.scale_up_s = t_done - t_cross
    result.spike_to_cross_s = t_cross - spike_at
    return result


def _target(metric: ObjectMetricSpec | PodsMetricSpec) -> float:
    if isinstance(metric, PodsMetricSpec):
        return metric.target_average_value
    return metric.target_value


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
                values = (_hpa_reading(pipe, m) for m in loop.metrics)
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
        #: the thread's exception, appended once (the declared contract in
        #: analysis/concurrency.py: the only write the thread shares)
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._run, name="loadgen", daemon=True)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._step()
        except BaseException as e:  # noqa: BLE001 — handed to stop()
            self._errors.append(e)

    def start(self) -> "LoadThread":
        self._thread.start()
        return self

    def check(self) -> None:
        """Raise the thread's exception, if it has died of one."""
        if self._errors:
            raise RuntimeError("load generator thread failed") from self._errors[0]

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"load generator thread did not stop within {timeout}s")
        self.check()


def _feed_exporter(daemon: ExporterDaemon, stop: threading.Event, interval: float,
                   errors: list[Exception]) -> None:
    """The exporter-feed thread of ``_live_trial``: one daemon sweep every
    ``interval`` s until ``stop`` is set; an exception ends it and is
    appended to ``errors`` for the caller to raise after the join."""
    try:
        while not stop.is_set():
            daemon.step()
            stop.wait(interval)
    except Exception as e:  # noqa: BLE001 — raised again by the caller
        errors.append(e)


def _live_trial(
    spec: LoopSpec,
    source: MetricsSource,
    step: Callable[[], object] | None,
    load: Load,
    mirror_util: Callable[[], float],
    time_scale: float,
    attributor: Attributor | None = None,
    selfreport: SelfReportReader | None = None,
    drive: Callable[..., object] = run_trial,
):
    """Run ``step`` in its own thread, as the workload runs in its own pod
    (None: the load acts when it is set, and no thread runs), serve
    ``source`` over HTTP as the spec's real pod, and drive the loop
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
    feed_errors: list[Exception] = []
    feeder = threading.Thread(
        target=_feed_exporter,
        args=(daemon, stop, max(0.05, 0.5 * time_scale), feed_errors),
        name="exporter-feed",
        daemon=True,
    )
    worker = LoadThread(step) if step is not None else None
    try:
        feeder.start()
        if worker is not None:
            worker.start()
        pipe = wire_pipeline(
            lambda: http_fetch(daemon.port), mirror_util, clock, time_scale, spec=spec
        )
        return drive(load, pipe, clock, time_scale)
    finally:
        stop.set()
        feeder.join(10)
        if worker is not None:
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


class PacedLoad(TrainLoad):
    """``TrainLoad`` paced against a schedule: each step is allotted ``busy
    / i`` of wall time from where the last allotment ended, and sleeps
    until its end, so a sleep that wakes late, or the host's time between
    steps, is taken from the next sleep instead of from the duty cycle.  A
    late start of more than ``CATCH_UP_S`` restarts the schedule (the
    intensity rose, or the host stalled).  The slice pod's collective
    bursts take some 1.7 ms on an H100: under ``TrainLoad``'s sleep after
    each step, amid the trial's threads, the pod read 43.9 for a commanded
    53.3, below the HPA's band edge of 44."""

    CATCH_UP_S = 0.05

    def __init__(self, gen: AllReduceLoadGen, window: float = 3.0):
        super().__init__(gen, window)
        self._due: float | None = None

    def step(self) -> None:
        i = max(self._intensity, 0.01)
        t0 = time.perf_counter()
        self.gen.step()
        busy = time.perf_counter() - t0
        self.duty.record(busy)
        on_schedule = self._due is not None and t0 - self._due <= self.CATCH_UP_S
        self._due = (self._due if on_schedule else t0) + busy / i
        time.sleep(min(max(0.0, self._due - time.perf_counter()), 2.0))


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


def run_slice_trial(gen: AllReduceLoadGen, time_scale: float = 1.0) -> TrialResult:
    """The slice trial around one collective generator, in real time: the
    scale-up alone.

    The generator, the slice container's default workload, runs as pod
    ``tpu-test-multihost-0`` (ordinal 0 of slice 0) under ``PacedLoad``;
    its slice peer and the other slices' hosts are mirror pods.  The loop
    reads the duty cycle, the generator's busy share over a 3 s window
    (times ``time_scale``) served by ``TorchDeviceSource``, recorded by the
    slice rule as ``tpu_test_multihost_duty_cycle_avg``: a GPU serves no
    tensor-core gauge for a collective pod.  Target, bounds, quantum and
    behavior are the shipped slice HPA's."""
    load = PacedLoad(gen, window=3.0 * time_scale)
    source = TorchDeviceSource(util_fn=load.utilization, device=gen.device)
    spec = dataclasses.replace(
        slice_spec(TPU_DUTY_CYCLE, record=MULTIHOST_DUTY_SERIES), drain_offered=None
    )
    return _live_trial(spec, source, load.step, load, load.utilization, time_scale)


class HbmHold:
    """Holds real device memory, so that the HBM gauge reports bytes that
    are resident on the device (bench.py's ``HbmHold``): blocks of 1/4 GiB,
    each zeroed on the device and synchronized before it counts.

    ``clear`` drops the blocks and empties PyTorch's caching allocator:
    without that the allocator keeps the freed blocks reserved, and NVML's
    memory in use never falls.  ``held_bytes`` is read from other threads
    (the exporter's feed) and is one integer."""

    BLOCK = GIB // 4

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve(device)
        self._blocks: list[torch.Tensor] = []
        self._held = 0

    def held_bytes(self) -> int:
        return self._held

    def set_target(self, target_bytes: float) -> None:
        """Hold the most whole blocks that fit in ``target_bytes``."""
        while self._held + self.BLOCK <= target_bytes:
            block = torch.zeros(self.BLOCK, dtype=torch.uint8, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._blocks.append(block)
            self._held += self.BLOCK
        while self._blocks and self._held > target_bytes:
            self._blocks.pop()
            self._held -= self.BLOCK

    def clear(self) -> None:
        self._blocks.clear()
        self._held = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Hold(Protocol):
    """What the HBM trial commands: ``HbmHold``, or a stand-in that counts."""

    def held_bytes(self) -> int: ...

    def set_target(self, target_bytes: float) -> None: ...

    def clear(self) -> None: ...


class HbmLoad:
    """The HBM pod's workload around a hold: an intensity is the fraction
    of ``HBM_CAP`` the pod holds, set at once (bench.py sets its hold in
    the loop's tick).  Its ``utilization`` is the held bytes, which the
    mirror pods report too."""

    def __init__(self, hold: Hold):
        self.hold = hold

    def set_intensity(self, value: float) -> None:
        self.hold.set_target(value * HBM_CAP)

    def utilization(self, _chip_index: int = 0) -> float:
        return float(self.hold.held_bytes())


class HeldBytesSource:
    """The real pod's one device as its exporter reads it for the HBM loop:
    the held bytes in use of ``total`` and no activity gauge."""

    def __init__(self, hold: Hold, total: float):
        self.hold = hold
        self.total = total

    def sample(self) -> list[ChipSample]:
        return [ChipSample(0, None, None, float(self.hold.held_bytes()), self.total, None)]


def run_hbm_pods_trial(
    device: str | torch.device | None = None,
    time_scale: float = 1.0,
    hold: Hold | None = None,
    clock: VirtualClock | None = None,
) -> TrialResult:
    """The HBM trial: bench.py's HBM rung around real device memory.

    ``hold`` (default ``HbmHold(device)``) holds the real pod's bytes, and
    every running pod's one device reports them.  With no ``clock`` it runs
    in real time: an ``ExporterDaemon`` serves the real pod over HTTP and
    the HPA reads ``tpu_test_hbm_used_bytes`` through the pod-max rule and
    the adapter's Pods API.  With a ``VirtualClock`` the real pod's
    exposition is read in process.  The crossing is the first scrape after
    the spike at which the mean over the running pods exceeds 13Gi.  It
    ends at the scale-up; the hold is cleared before it returns."""
    dev = resolve(device)
    hold = hold if hold is not None else HbmHold(dev)
    total = float(torch.cuda.get_device_properties(dev).total_memory) if dev.type == "cuda" else 0.0
    spec = hbm_pods_spec(total)
    load = HbmLoad(hold)
    source = HeldBytesSource(hold, total)
    try:
        if clock is None:
            return _live_trial(spec, source, None, load, load.utilization, time_scale)
        attribution = {0: ("default", spec.real_pod)}

        def fetch_real() -> str:
            return encode_text(families_from_chips(source.sample(), "real-0", attribution))

        pipe = wire_pipeline(fetch_real, load.utilization, clock, time_scale, spec=spec)
        return run_trial(load, pipe, clock, time_scale)
    finally:
        hold.clear()


#: bench.py's External rung: the queued requests before and after the spike
#: at 10 s, published every second; the HPA syncs every 15 s
QUEUE_BASE = 40.0
QUEUE_SPIKE = 240.0
QUEUE_SPIKE_AT = 10.0


@dataclass
class QueueResult:
    spike_to_desired_s: float
    replicas_reached: int
    #: (t, replicas, the HPA's reason) at each sync
    syncs: list[tuple[float, int, str]] = field(default_factory=list)


def run_external_queue_trial() -> QueueResult:
    """bench.py's External rung on a virtual clock: the queue-depth HPA
    (``external_hpa_doc()``, the generator's tpu-test-external-hpa) over
    ``external_sim``, 40 requests queued, then 240 from 10 s, a sample a
    second and a sync every 15 s.  Times the spike to the steady desired
    count, ceil(240 / the AverageValue target).  Raises RuntimeError when
    it is not reached within 300 s."""
    sim = external_sim_from_manifest(external_hpa_doc())
    need = math.ceil(QUEUE_SPIKE / sim.metric.target_average_value)
    result = QueueResult(0.0, need)
    next_sync = 15.0
    while sim.clock.now() < 300.0:
        now = sim.clock.now()
        sim.publish(QUEUE_SPIKE if now >= QUEUE_SPIKE_AT else QUEUE_BASE)
        if now >= next_sync:
            status = sim.hpa.sync_once()
            next_sync += 15.0
            result.syncs.append((now, sim.target.replicas, status.last_reason))
        if now >= QUEUE_SPIKE_AT and sim.target.replicas == need:
            result.spike_to_desired_s = now - QUEUE_SPIKE_AT
            return result
        sim.clock.advance(1.0)
    raise RuntimeError(f"the queue HPA never reached {need} replicas: {result.syncs}")


#: the shipped manifests, read as an operator would apply them
DEPLOY = Path(__file__).resolve().parent.parent / "deploy"
#: bench.py's cpu rung: the busy-loop's load before and after the spike at
#: 30 s, percent of a pod's CPU request
CPU_BASE = 20.0
CPU_SPIKE = 100.0
CPU_SPIKE_AT = 30.0


@dataclass
class ResourceResult:
    scale_up_s: float
    replicas_reached: int


def run_cpu_resource_trial() -> ResourceResult:
    """bench.py's ``0_cpu_resource`` rung on a virtual clock: the shipped
    Resource HPA (deploy/cpu-busyloop-hpa.yaml, read with ``load_yaml``)
    over the simulated cluster's metrics.k8s.io stand-in.  Pods claim no
    device and start in 3 s; each busy-loop replica runs at the offered
    load (20%, then 100% of its request from 30 s); the HPA syncs every
    15 s.  Times the spike to every replica of ``maxReplicas`` running,
    stepping the clock 0.5 s.  Raises RuntimeError when that does not
    happen within 400 s."""
    hpa_doc = load_yaml((DEPLOY / "cpu-busyloop-hpa.yaml").read_text())
    (metric,) = metrics_from_manifest(hpa_doc)
    if not isinstance(metric, ResourceMetricSpec):
        raise ValueError(f"the cpu rung needs a Resource metric, not {metric}")
    clock = VirtualClock()
    cluster = SimCluster(clock, nodes=[("node-0", 0)], pod_start_latency=3.0)
    dep = SimDeployment(
        cluster, "cpu-busyloop", "cpu-busyloop", chips_per_pod=0,
        load_fn=lambda t: CPU_SPIKE if t >= CPU_SPIKE_AT else CPU_BASE, load_mode="per_pod",
    )
    cluster.add_deployment(dep, replicas=1)
    clock.advance(5.0)
    max_replicas = hpa_doc["spec"]["maxReplicas"]
    hpa = HPAController(
        target=dep,
        metrics=[metric],
        adapter=None,
        clock=clock,
        min_replicas=hpa_doc["spec"]["minReplicas"],
        max_replicas=max_replicas,
        behavior=behavior_from_manifest(hpa_doc),
        resource_metrics=SimResourceMetrics(cluster, dep.name),
    )
    next_sync = 15.0
    while clock.now() < 400.0:
        if clock.now() >= next_sync:
            hpa.sync_once()
            next_sync += 15.0
        if (clock.now() >= CPU_SPIKE_AT and dep.replicas == max_replicas
                and len(cluster.running_pods(dep.name)) == max_replicas):
            return ResourceResult(round(clock.now() - CPU_SPIKE_AT, 1), max_replicas)
        clock.advance(0.5)
    raise RuntimeError(f"the cpu rung never reached {max_replicas} replicas")


#: the signal-latency rung's loop: the latency budget a step's scale event
#: must meet at p95, and the run's length, clock seconds
SIGNAL_LATENCY_BUDGET = 60.0
SIGNAL_LATENCY_RUN = 420.0


def _signal_latency_load(t: float) -> float:
    """The rung's offered load, devices' worth x 100: three upward steps far
    enough apart that the loop settles between them (35 holds 1 replica at
    target 40; 90 needs 3, 140 needs 4, 200 needs 5)."""
    if t < 60.0:
        return 35.0
    if t < 180.0:
        return 90.0
    if t < 300.0:
        return 140.0
    return 200.0


@dataclass
class SignalLatencyRun:
    """A finished run of the signal-latency rung's traced pipeline
    (``pipe.tracer`` holds its spans), and every SLO alert that fired at any
    second of it, in the order they first fired."""

    pipe: AutoscalingPipeline
    fired: list[str]


def signal_latency_run() -> SignalLatencyRun:
    """The pipeline of bench.py's ``signal_latency`` rung, run on a virtual
    clock: one simulated node of 8 devices, traced, the shared load of
    ``_signal_latency_load`` (steps at 60, 180 and 300 s), target 40, at
    most 8 replicas and a 12 s pod start, for 420 s, the firing SLO alerts
    read after each second."""
    clock = VirtualClock()
    cluster = SimCluster(clock, nodes=[("n0", 8)], pod_start_latency=BASE_POD_START_LATENCY)
    dep = SimDeployment(
        cluster, "tpu-test", "tpu-test", load_fn=_signal_latency_load, load_mode="shared"
    )
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)
    base = clock.now()
    tracer = Tracer(clock)
    dep.load_fn = TracedLoad(lambda t: _signal_latency_load(t - base), tracer)
    pipe = AutoscalingPipeline(cluster, dep, target_value=TARGET, max_replicas=8, tracer=tracer)
    fired: list[str] = []
    for _ in range(int(SIGNAL_LATENCY_RUN)):
        pipe.run_for(1.0)
        fired.extend(n for n in pipe.evaluator.firing_alerts() if n not in fired)
    return SignalLatencyRun(pipe, fired)


def signal_latency_rung(pipe: AutoscalingPipeline) -> dict:
    """bench.py's rung dict, key for key, from a finished run: each step's
    ``workload_change`` span paired with the first sync and the first scale
    event after it (``obs.propagation_report``)."""
    prop = propagation_report(pipe.tracer.spans)
    return {
        "mode": "virtual",
        "metric": "signal propagation latency (s, workload change -> sync/scale)",
        "changes_total": prop["changes_total"],
        "changes_scaled": prop["changes_scaled"],
        "sync_latency_p50_s": prop["sync_latency_p50"],
        "sync_latency_p95_s": prop["sync_latency_p95"],
        "scale_latency_p50_s": prop["scale_latency_p50"],
        "scale_latency_p95_s": prop["scale_latency_p95"],
        "budget_s": SIGNAL_LATENCY_BUDGET,
        "within_budget": (
            prop["scale_latency_p95"] is not None
            and prop["scale_latency_p95"] <= SIGNAL_LATENCY_BUDGET
        ),
        "trace_spans": len(pipe.tracer.spans),
        "final_replicas": pipe.replicas(),
    }


def run_signal_latency_trial() -> dict:
    """bench.py's ``signal_latency`` rung (``run_rung_signal_latency``):
    ``signal_latency_rung`` of ``signal_latency_run``."""
    return signal_latency_rung(signal_latency_run().pipe)


def chaos_storm_rung() -> dict:
    """bench.py's ``chaos_storm`` rung (``run_rung_chaos``), key for key:
    the canned fault storm (``chaos.run_fault_storm``) at the base pod
    start, each fault's MTTR and detection time."""
    result = run_fault_storm(pod_start_latency=BASE_POD_START_LATENCY)
    return {
        "mode": "virtual",
        "metric": "fault storm MTTR (s, cleared -> reconverged)",
        "settled_replicas": result["settled_replicas"],
        "mttr_s": {f["fault"]: f["mttr"] for f in result["faults"]},
        "detection_s": {f["fault"]: f["detection_time"] for f in result["faults"]},
        "all_recovered": result["all_recovered"],
        "spurious_scale_events_during_blackout": result["spurious_scale_events_during_blackout"],
        "blackout_condition_observed": result["blackout_condition_observed"],
    }


def slo_burn_rung() -> dict:
    """bench.py's ``slo_burn`` rung (``run_rung_slo_burn``), key for key:
    ``simulate.run_slo_check`` at the base pod start, the SLO burn-rate
    alerts on a clean staircase and under a scrape blackout."""
    result = run_slo_check(pod_start_latency=BASE_POD_START_LATENCY)
    return {
        "mode": "virtual",
        "metric": "SLO burn-rate detection (s, blackout -> alert firing)",
        "clean_false_positives": result["clean_false_positives"],
        "fault_first_fired": result["fault_first_fired"],
        "fast_detection_s": result["fast_detection_s"],
        "slow_detection_s": result["slow_detection_s"],
        "ok": result["ok"],
    }


def drill_rung(result: dict) -> dict:
    """bench.py's ``recovery_drill`` rung dict, key for key, from a
    finished drill (``control.scale_harness.run_recovery_drill``): each
    restart's MTTR, the worst replay gap and first good sync, and whether
    any scale event fell in a recovery window."""
    return {
        "mode": "virtual",
        "metric": "recovery drill MTTR (s, restart -> reconverged)",
        "components": result["components"],
        "settled_replicas": result["settled_replicas"],
        "mttr_s": {f["fault"]: f["mttr"] for f in result["faults"]},
        "mttr_max_s": result["mttr_max_s"],
        "replay_gap_max_s": result["replay_gap_max_s"],
        "first_good_sync_max_s": result["first_good_sync_max_s"],
        "all_recovered": result["all_recovered"],
        "spurious_scale_events_during_replay": result["spurious_scale_events_during_replay"],
        "lineage_complete": result["lineage_complete"],
        "final_replicas": result["final_replicas"],
        "ok": result["ok"],
    }


def recovery_drill_rung() -> dict:
    """bench.py's ``recovery_drill`` rung (``run_rung_recovery_drill``):
    ``drill_rung`` of the drill at the base pod start."""
    return drill_rung(run_recovery_drill(pod_start_latency=BASE_POD_START_LATENCY))


def evacuation_rung(result: dict, canary: dict) -> dict:
    """bench.py's ``region_evacuation`` rung dict, key for key, from a
    finished evacuation and its canary (``chaos.run_region_evacuation()``
    and ``run_region_evacuation(spill_enabled=False, smoke=True)``): each
    band's time to reconvergence against its budget, the spills, the sealed
    generations and the global reads.  ``ok`` holds when the run keeps the
    contract and the canary breaks it."""
    evac = result["evacuations"][0] if result["evacuations"] else {}
    return {
        "mode": "virtual",
        "metric": "region evacuation (s, kill -> frozen demand Running on "
        "survivors, per band)",
        "ttc_s": evac.get("tenant_ttc_s", {}),
        "ttc_budgets_s": result["ttc_budgets_s"],
        "bands": {t: result["bands"][t] for t in evac.get("frozen", {})},
        "spills_admitted": result["spills"]["admitted"],
        "spills_denied": result["spills"]["denied"],
        "generations": result["exchange"]["generations"],
        "publish_failures": result["exchange"]["publish_failures"],
        "survivor_pools_conserved": result["audits"]["alive_conserved"],
        "bit_identical": result["global"]["bit_identical"],
        "all_recovered": result["all_recovered"],
        "violations": result["violations"],
        "canary_failed": not canary["ok"],
        "canary_violations": len(canary["violations"]),
        "ok": result["ok"] and not canary["ok"],
    }


def region_evacuation_rung() -> dict:
    """bench.py's ``region_evacuation`` rung (``run_rung_region_evacuation``):
    ``evacuation_rung`` of the full evacuation and the smoke canary."""
    return evacuation_rung(
        run_region_evacuation(), run_region_evacuation(spill_enabled=False, smoke=True)
    )


def _scale_rung(result: dict, metric: str, floor: float) -> dict:
    """A ``run_fleet_scale``/``run_query_bench``/``run_downsample_bench``
    result annotated as
    bench.py's metrics-plane rungs are: its mode, metric and speedup floor."""
    result["mode"] = "virtual"
    result["metric"] = metric
    result["speedup_floor"] = floor
    result["meets_floor"] = result["speedup"] >= floor
    return result


# The four metrics-plane rungs run at bench.py's smoke sizes unless
# ``full`` asks for the sizes of its TIME_SCALE 1 branch.  Wall time is what
# they measure, so the smoke size shrinks the population, not the clock.
# No run of the port takes the full sizes yet (minutes of host time each).


def sim_scale_rung(full: bool = False) -> dict:
    """bench.py's ``sim_scale`` rung (``run_rung_sim_scale``), key for key:
    the pipeline and 200 synthetic structured targets over 600 s of virtual
    time (``full``: 1000 over an hour)."""
    if full:
        targets, horizon_s = perfgates.SIM_SCALE_TARGETS, perfgates.SIM_SCALE_HORIZON_S
        floor = perfgates.SIM_SCALE_MIN_SPEEDUP
    else:
        targets = perfgates.SIM_SCALE_SMOKE_TARGETS
        horizon_s = perfgates.SIM_SCALE_SMOKE_HORIZON_S
        floor = perfgates.SIM_SCALE_SMOKE_MIN_SPEEDUP
    return _scale_rung(run_fleet_scale(targets=targets, horizon_s=horizon_s),
                       "fleet-scale metrics plane (virtual s per wall s)", floor)


def sim_scale_10k_rung(full: bool = False) -> dict:
    """bench.py's ``sim_scale_10k`` rung (``run_rung_sim_scale_10k``), key
    for key: 2000 synthetic targets over 4 hash-ring scraper shards with
    their pre-reductions, federated into the view the HPA reads, over 600 s
    of virtual time (``full``: 10,000 over 8 shards for an hour).  ``ok``
    holds the speedup floor, the compression floor, the fleet query's p95
    budget, the appends floor and the ring's invariants."""
    if full:
        targets, shards = perfgates.SIM_SCALE_10K_TARGETS, perfgates.SIM_SCALE_10K_SHARDS
        horizon_s = perfgates.SIM_SCALE_10K_HORIZON_S
        floor = perfgates.SIM_SCALE_10K_MIN_SPEEDUP
    else:
        targets = perfgates.SIM_SCALE_10K_SMOKE_TARGETS
        shards = perfgates.SIM_SCALE_10K_SMOKE_SHARDS
        horizon_s = perfgates.SIM_SCALE_10K_SMOKE_HORIZON_S
        floor = perfgates.SIM_SCALE_10K_SMOKE_MIN_SPEEDUP
    result = _scale_rung(
        run_fleet_scale(targets=targets, horizon_s=horizon_s, shards=shards),
        "sharded 10k-target federation plane (virtual s per wall s)", floor)
    result["compression_floor"] = perfgates.MIN_COMPRESSION_RATIO
    result["query_p95_budget_ms"] = perfgates.MAX_FLEET_QUERY_P95_MS
    result["appends_per_sec_floor"] = perfgates.MIN_APPENDS_PER_SEC
    result["ok"] = (
        result["meets_floor"]
        and result["compression_ratio"] >= perfgates.MIN_COMPRESSION_RATIO
        and result["query_p95_ms"] <= perfgates.MAX_FLEET_QUERY_P95_MS
        and result["appends_per_sec"] >= perfgates.MIN_APPENDS_PER_SEC
        and result["shards_disjoint"]
        and result["shards_cover_fleet"]
    )
    return result


def query_bench_rung(full: bool = False) -> dict:
    """bench.py's ``query_bench`` rung (``run_rung_query_bench``), key for
    key: the fleet-aggregate basket evaluated naive and planned over one
    populated sharded TSDB, 500 series over 4 shards for 1800 s (``full``:
    10k over 8 for an hour).  ``ok`` holds the vectors bit-identical, the
    planned speedup floor, the p95 budget and a nonzero summary fast
    path."""
    if full:
        targets, shards = perfgates.QUERY_BENCH_TARGETS, perfgates.QUERY_BENCH_SHARDS
        horizon_s = perfgates.QUERY_BENCH_HORIZON_S
        floor = perfgates.MIN_PLANNED_SPEEDUP
    else:
        targets = perfgates.QUERY_BENCH_SMOKE_TARGETS
        shards = perfgates.QUERY_BENCH_SMOKE_SHARDS
        horizon_s = perfgates.QUERY_BENCH_SMOKE_HORIZON_S
        floor = perfgates.QUERY_BENCH_SMOKE_MIN_PLANNED_SPEEDUP
    result = _scale_rung(
        run_query_bench(targets=targets, shards=shards, horizon_s=horizon_s,
                        scrape_interval=perfgates.QUERY_BENCH_INTERVAL_S),
        "planned vs naive rule eval (wall-time speedup)", floor)
    result["query_p95_budget_ms"] = perfgates.MAX_FLEET_QUERY_P95_MS
    result["ok"] = (
        result["identical"]
        and result["meets_floor"]
        and result["query_p95_ms"] <= perfgates.MAX_FLEET_QUERY_P95_MS
        and result["planner_fastpath"] > 0
    )
    return result


def downsample_bench_rung(full: bool = False) -> dict:
    """bench.py's ``downsample_bench`` rung (``run_rung_downsample_bench``),
    key for key: 200 fleet series over 2 downsampling shard DBs scraped
    every 30 s for 6 h, then a 3 h tier-aligned fleet query ending at hour
    4 read from the 1h rollups and from raw (``full``: 10,000 over 8 for a
    day, a 20 h window ending at hour 22).  ``ok`` holds the rollup read
    bit-identical to its raw twin, the randomized differential clean, the
    speedup floor, the bytes budget and the planner selecting the tier."""
    if full:
        targets, shards = perfgates.DOWNSAMPLE_BENCH_TARGETS, perfgates.DOWNSAMPLE_BENCH_SHARDS
        horizon_s = perfgates.DOWNSAMPLE_BENCH_HORIZON_S
        scrape_interval = perfgates.DOWNSAMPLE_BENCH_INTERVAL_S
        window_s, at_s = perfgates.DOWNSAMPLE_BENCH_WINDOW_S, perfgates.DOWNSAMPLE_BENCH_AT_S
        floor = perfgates.MIN_ROLLUP_SPEEDUP
    else:
        targets, shards = perfgates.DOWNSAMPLE_SMOKE_TARGETS, perfgates.DOWNSAMPLE_SMOKE_SHARDS
        horizon_s = perfgates.DOWNSAMPLE_SMOKE_HORIZON_S
        scrape_interval = perfgates.DOWNSAMPLE_SMOKE_INTERVAL_S
        window_s, at_s = perfgates.DOWNSAMPLE_SMOKE_WINDOW_S, perfgates.DOWNSAMPLE_SMOKE_AT_S
        floor = perfgates.DOWNSAMPLE_SMOKE_MIN_ROLLUP_SPEEDUP
    result = _scale_rung(
        run_downsample_bench(targets=targets, shards=shards, horizon_s=horizon_s,
                             scrape_interval=scrape_interval, window_s=window_s, at_s=at_s),
        "rollup tier vs raw rescan (wall-time speedup)", floor)
    result["bytes_ratio_budget"] = perfgates.MAX_ROLLUP_BYTES_RATIO
    result["ok"] = (
        result["identical"]
        and result["differential"]["identical"]
        and result["meets_floor"]
        and result["bytes_ratio"] <= perfgates.MAX_ROLLUP_BYTES_RATIO
        and result["tier_selected"]
    )
    return result


def coverage_floor_rung(export: dict | None = None) -> dict:
    """bench.py's ``coverage_floor`` rung (``run_rung_coverage_floor``), field
    for field: the canned runs (``simulate.COVERAGE_RUN_NAMES``) under one
    CoverageMap, the union gated against perfgates' ``COVERAGE_*`` floors:
    the union hit ratio, each domain's ratio and a least count of never-hit
    probes (a gap list gone dark means coverage stopped carrying
    information).  ``never_hit`` is the published gap list.  ``export`` is
    a finished ``simulate.run_coverage("all")`` export, run here when None.
    Virtual time: deterministic run to run."""
    from k8s_gpu_hpa_tpu_torch.obs import coverage
    from k8s_gpu_hpa_tpu_torch.simulate import run_coverage

    if export is None:
        export = run_coverage(run="all")
    union = coverage.export_union_ratio(export)
    gaps = coverage.export_never_hit(export)
    domain_ratios = {d: round(export["domains"][d]["ratio"], 4) for d in coverage.DOMAINS}
    domains_ok = all(
        domain_ratios[d] >= perfgates.COVERAGE_DOMAIN_FLOORS[d] for d in coverage.DOMAINS
    )
    return {
        "mode": "virtual",
        "metric": "decision-path coverage (canned-scenario union, ratio)",
        "probes_registered": len(export["probes"]),
        "probes_hit": len(export["probes"]) - len(gaps),
        "union_ratio": round(union, 4),
        "union_floor": perfgates.COVERAGE_UNION_FLOOR,
        "domain_ratios": domain_ratios,
        "domain_floors": dict(perfgates.COVERAGE_DOMAIN_FLOORS),
        "never_hit": gaps,
        "never_hit_min": perfgates.COVERAGE_MIN_NEVER_HIT,
        "ok": (
            union >= perfgates.COVERAGE_UNION_FLOOR
            and domains_ok
            and len(gaps) >= perfgates.COVERAGE_MIN_NEVER_HIT
        ),
    }


def profile_bench_rung(full: bool = False) -> dict:
    """bench.py's ``profile_bench`` rung (``run_rung_profile_bench``), key
    for key: the three guarantees the cost-attribution plane rests on, each
    gated by perfgates' ``PROFILE_*``.  **Attribution**: the scale run
    (the smoke shape, 200 targets for 600 s; ``full``: 1000 for an hour)
    attributes at least ``PROFILE_MIN_ATTRIBUTION`` of its own measured
    wall window to named stages.  **Determinism**: two same-seed storm runs
    export bit-identical canonical structure.  **Canary**: a planted
    ``PROFILE_CANARY_PLANT_S`` a call on ``PROFILE_CANARY_STAGE`` trips the
    ``--diff`` share gate against the clean run, and the clean pair does
    not.  The wall-clock fields are measured; the structure is the virtual
    clock's, deterministic."""
    from k8s_gpu_hpa_tpu_torch.control.profile_harness import run_profile
    from k8s_gpu_hpa_tpu_torch.obs import profile

    smoke = not full
    scale = run_profile("scale", smoke=smoke)[0]
    first = run_profile("storm", seed=0)[0]
    second = run_profile("storm", seed=0)[0]
    bit_identical = first["canonical"] == second["canonical"]
    planted = run_profile(
        "storm",
        seed=0,
        plant={perfgates.PROFILE_CANARY_STAGE: perfgates.PROFILE_CANARY_PLANT_S},
    )[0]
    canary_caught = profile.diff_exports(first["timed"], planted["timed"])["regression"]
    clean_diff = profile.diff_exports(first["timed"], second["timed"])
    rollup = profile.stage_rollup(scale["timed"])
    return {
        "mode": "measured",
        "metric": "stage attribution + export determinism + diff canary",
        "scale_targets": (
            perfgates.PROFILE_SCALE_SMOKE_TARGETS if smoke else perfgates.PROFILE_SCALE_TARGETS
        ),
        "scale_wall_s": scale["wall_s"],
        "attribution": scale["attribution"],
        "attribution_floor": perfgates.PROFILE_MIN_ATTRIBUTION,
        "stages": {
            sid: {"calls": agg["calls"], "self_s": agg["self_s"], "cum_s": agg["cum_s"]}
            for sid, agg in sorted(rollup.items())
        },
        "open_spans": scale["open_spans"],
        "bit_identical": bit_identical,
        "canary_stage": perfgates.PROFILE_CANARY_STAGE,
        "canary_plant_s": perfgates.PROFILE_CANARY_PLANT_S,
        "canary_caught": canary_caught,
        "clean_diff_regression": clean_diff["regression"],
        "ok": (
            scale["attribution_ok"]
            and not scale["open_spans"]
            and bit_identical
            and canary_caught
            and not clean_diff["regression"]
        ),
    }


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def chaos_fuzz_rung() -> dict:
    """bench.py's ``chaos_fuzz`` rung (``run_rung_chaos_fuzz``), key for
    key: the three guarantees the corpus and its replays rest on, each
    gated by perfgates' ``FUZZ_*``.  **Determinism**: one seeded campaign
    run twice gives the same canonical JSON.  **Novelty**: the campaign
    accepts at least ``FUZZ_MIN_NOVEL_ACCEPTS`` mutations for coverage not
    seen before.  **Canary**: with --break-grace armed the fuzzer finds a
    failing schedule within ``FUZZ_CANARY_BUDGET`` cases, shows that it
    reproduces and minimizes it to at most ``FUZZ_MAX_SHRINK_RATIO`` of its
    faults (or to a core of at most 2).  Virtual time throughout."""
    from k8s_gpu_hpa_tpu_torch.chaos import fuzz

    first = fuzz.run_fuzz(budget=perfgates.FUZZ_RUNG_BUDGET, seed=perfgates.FUZZ_RUNG_SEED)
    second = fuzz.run_fuzz(budget=perfgates.FUZZ_RUNG_BUDGET, seed=perfgates.FUZZ_RUNG_SEED)
    bit_identical = _canonical(first) == _canonical(second)
    canary = fuzz.run_fuzz(
        budget=perfgates.FUZZ_CANARY_BUDGET, seed=perfgates.FUZZ_CANARY_SEED, break_grace=True
    )
    failure = canary["failure"]
    canary_found = failure is not None and failure["reproducible"]
    minimized = failure["minimized"] if canary_found else None
    shrink = failure["shrink_ratio"] if canary_found else None
    canary_minimized = minimized is not None and (
        shrink <= perfgates.FUZZ_MAX_SHRINK_RATIO or len(minimized["faults"]) <= 2
    )
    return {
        "mode": "virtual",
        "metric": "fuzz campaign determinism + canary find/minimize",
        "budget": perfgates.FUZZ_RUNG_BUDGET,
        "seed": perfgates.FUZZ_RUNG_SEED,
        "bit_identical": bit_identical,
        "novel_accepts": first["novel_accepts"],
        "novel_accepts_min": perfgates.FUZZ_MIN_NOVEL_ACCEPTS,
        "canary_budget": perfgates.FUZZ_CANARY_BUDGET,
        "canary_found": canary_found,
        "canary_minimized": canary_minimized,
        "canary_shrink_ratio": shrink,
        "shrink_ratio_max": perfgates.FUZZ_MAX_SHRINK_RATIO,
        "canary_minimized_faults": len(minimized["faults"]) if minimized is not None else None,
        "ok": (
            bit_identical
            and first["novel_accepts"] >= perfgates.FUZZ_MIN_NOVEL_ACCEPTS
            and canary_found
            and canary_minimized
        ),
    }


def paging_bench_rung() -> dict:
    """bench.py's ``paging_bench`` rung (``run_rung_paging_bench``), key for
    key: the alert router armed over the storm, the crunch and the smoke
    evacuation, each held to the paging contract (perfgates'
    ``PAGING_*``: recall 1.0, precision, p95 time to page within the
    drill's budget); the evacuation with --break-inhibition armed must
    fail on an uninhibited duplicate page; and two smoke evacuations must
    give the same canonical result.  Virtual time throughout."""
    from k8s_gpu_hpa_tpu_torch.chaos import paging

    storm = paging.run_paging_storm()
    crunch = paging.run_paging_crunch()
    evac = paging.run_paging_evacuation(smoke=True)
    canary = paging.run_paging_evacuation(smoke=True, break_inhibition=True)
    second = paging.run_paging_evacuation(smoke=True)
    bit_identical = _canonical(evac) == _canonical(second)
    canary_caught = not canary["ok"] and any(
        v["kind"] == "uninhibited_duplicate_page" for v in canary["score"]["violations"]
    )

    def summarize(r: dict) -> dict:
        s = r["score"]
        return {
            "pages": s["pages_total"],
            "recall": s["recall"],
            "precision": s["precision"],
            "ttp_p95_s": s["time_to_page_s"]["p95"],
            "violations": len(r["violations"]),
            "ok": r["ok"],
        }

    return {
        "mode": "virtual",
        "metric": "paging contract (recall/precision/time-to-page) + "
        "mis-inhibition canary + log determinism",
        "storm": summarize(storm),
        "crunch": summarize(crunch),
        "evacuate": summarize(evac),
        "ttp_budgets_s": dict(perfgates.PAGING_TTP_P95_MAX_S),
        "canary_caught": canary_caught,
        "bit_identical": bit_identical,
        "ok": storm["ok"] and crunch["ok"] and evac["ok"] and canary_caught and bit_identical,
    }


class QueueJoint:
    """The External metric's path on one node, around a serving container
    that runs as its own process: its self-reported queue depth (the
    telemetry file of pod ``pod``) → the node exporter, which merges the
    reports the kubelet's attribution vouches for → HTTP → scraper → TSDB
    → ``external.metrics.k8s.io`` → the queue HPA of
    ``external_hpa_doc()`` on a scale target of one replica.

    ``sweep`` runs one exporter sweep while the pod's report holds still
    and one scrape after it, so that what the adapter serves can be held to
    what the file held.  ``close`` stops the exporter's HTTP server."""

    def __init__(self, source: MetricsSource, attributor: Attributor, telemetry_dir: str,
                 pod: str, namespace: str = "default"):
        self.daemon = ExporterDaemon(
            source, attributor, node_name="real-0", listen_addr="127.0.0.1", port=0,
            selfreport=SelfReportReader(telemetry_dir),
        )
        clock = SystemClock()
        self.db = TimeSeriesDB(clock)
        self.scraper = Scraper(self.db)
        self.scraper.add_target(lambda: http_fetch(self.daemon.port), name="exporter/real",
                                node="real-0")
        doc = external_hpa_doc()
        (self.metric,) = metrics_from_manifest(doc, namespace)
        self.adapter = CustomMetricsAdapter(
            self.db, [], external_rules=[ExternalRule(self.metric.metric_name)])
        self.target = ScaleTarget(doc["spec"]["minReplicas"])
        self.hpa = HPAController(
            self.target, [self.metric], self.adapter, clock,
            min_replicas=doc["spec"]["minReplicas"], max_replicas=doc["spec"]["maxReplicas"],
            behavior=behavior_from_manifest(doc),
        )
        self.namespace = namespace
        self.report = Path(telemetry_dir) / f"{namespace}_{pod}.json"

    def served(self) -> list[float]:
        return self.adapter.get_external_metric(
            self.namespace, self.metric.metric_name, self.metric.selector)

    def sweep(self, attempts: int = 50) -> tuple[float, list[float]]:
        """The report's queue depth at one exporter sweep, and what the
        adapter serves after the scrape that follows.  Raises RuntimeError
        when the report changed across every attempt's sweep."""
        for _ in range(attempts):
            before = self.report.read_text()
            self.daemon.step()
            if self.report.read_text() == before:
                self.scraper.scrape_once()
                return json.loads(before)["queue_depth"], self.served()
        raise RuntimeError(f"{self.report} changed across {attempts} sweeps")

    def close(self) -> None:
        self.daemon.close()
