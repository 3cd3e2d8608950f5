"""The port's metric and control planes against the JAX package's: the text
exposition, the exporter daemon's /metrics, and Scraper → recording rule →
adapter → HPA on a virtual clock with a scripted utilization trace.  Both
packages get the same inputs and must give the same outputs."""

import dataclasses
import math
import urllib.request
from pathlib import Path

import pytest
import yaml

from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.exporter.daemon import ExporterDaemon as JaxExporterDaemon
from k8s_gpu_hpa_tpu.exporter.podresources import StaticAttributor as JaxStaticAttributor
from k8s_gpu_hpa_tpu.exporter.sources import StubSource as JaxStubSource
from k8s_gpu_hpa_tpu.metrics import exposition as jax_exposition
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxVirtualClock
from k8s_gpu_hpa_tpu_torch.control.hpa import shipped_behavior
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import StubSource
from k8s_gpu_hpa_tpu_torch.metrics import exposition, schema
from k8s_gpu_hpa_tpu_torch.trial import (
    DUTY_SERIES,
    MAX_REPLICAS,
    REAL_POD,
    TARGET,
    TENSORCORE_SERIES,
    MirrorDeployment,
    wire_pipeline,
)
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

HPA_YAML = Path(__file__).resolve().parent.parent / "deploy" / "tpu-test-hpa.yaml"

EXPOSITION = """\
# HELP tpu_tensorcore_utilization Achieved/peak MXU FLOPs percent per TPU chip (workload-reported)
# TYPE tpu_tensorcore_utilization gauge
tpu_tensorcore_utilization{chip="0",namespace="default",node="real-0",pod="tpu-test-real"} 19.4
tpu_tensorcore_utilization{chip="1",namespace="",node="real-0",pod="a\\"b\\\\c"} NaN
# TYPE tpu_duty_cycle gauge
tpu_duty_cycle{chip="0",node="real-0"} 100
# comment line
broken{{{ 9
# TYPE rule_eval_seconds histogram
rule_eval_seconds_bucket{le="0.5"} 3 # {trace_id="7",span_id="9"} 0.25 12.5
rule_eval_seconds_bucket{le="+Inf"} 4
rule_eval_seconds_sum 1.75
rule_eval_seconds_count 4
up +Inf
"""


def _structure(families):
    """Families as plain tuples (the two packages' dataclasses differ by
    class); NaN becomes a string so that equal structures compare equal."""

    def num(v):
        return "NaN" if isinstance(v, float) and math.isnan(v) else v

    return [
        (
            f.name,
            f.type,
            f.help,
            [
                (
                    num(s.value),
                    s.labels,
                    s.suffix,
                    None if s.exemplar is None else dataclasses.astuple(s.exemplar),
                )
                for s in f.samples
            ],
        )
        for f in families
    ]


def test_exposition_round_trip_equals_the_jax_package():
    port = exposition.parse_text(EXPOSITION)
    ref = jax_exposition.parse_text(EXPOSITION)
    assert _structure(port) == _structure(ref)
    assert [f.name for f in port] == [
        "tpu_tensorcore_utilization", "tpu_duty_cycle", "rule_eval_seconds", "up",
    ]
    text = exposition.encode_text(port)
    assert text == jax_exposition.encode_text(ref)
    assert _structure(exposition.parse_text(text)) == _structure(port)


class _FixedSource:
    def __init__(self, chips):
        self.chips = chips

    def sample(self):
        return list(self.chips)


def _chips(mod):
    return [
        mod.ChipSample(0, 19.4, 100.0, 2.1e9, 85.0e9, None),
        mod.ChipSample(1, None, 37.5, 0.0, 85.0e9, 12.0, temperature_c=41.0, power_w=390.5),
    ]


def _http_metrics(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return r.read().decode()


def test_daemon_metrics_text_equals_the_jax_daemon(native_built):
    """The same ChipSamples through both daemons and their native cores
    serve the same /metrics text (the reading's age excepted)."""
    attribution = {0: ("default", REAL_POD)}
    daemons = [
        ExporterDaemon(_FixedSource(_chips(schema)), StaticAttributor(attribution),
                       node_name="real-0", listen_addr="127.0.0.1", port=0),
        JaxExporterDaemon(_FixedSource(_chips(jax_schema)), JaxStaticAttributor(attribution),
                          node_name="real-0", listen_addr="127.0.0.1", port=0),
    ]
    try:
        texts = []
        for daemon in daemons:
            daemon.step()
            assert daemon.sweeps == 1
            text = _http_metrics(daemon.port)
            texts.append([ln for ln in text.splitlines() if "sample_age_seconds" not in ln])
    finally:
        for daemon in daemons:
            daemon.close()
    assert texts[0] == texts[1]
    body = "\n".join(texts[0])
    assert 'tpu_duty_cycle{chip="0",namespace="default",node="real-0",pod="tpu-test-real"} 100' in body
    assert 'tpu_tensorcore_utilization{chip="1"' not in body  # None: absent, not 0


def test_stub_source_samples_equal_the_jax_stub():
    def util(t, i):
        return 40.0 * i + 3.0 * t - 10.0  # clamps below 0 and above 100

    samples = []
    for cls, clock in ((StubSource, VirtualClock()), (JaxStubSource, JaxVirtualClock())):
        source = cls(num_chips=4, util_fn=util, clock=clock)
        clock.advance(5.0)
        samples.append([dataclasses.astuple(c) for c in source.sample()])
    assert samples[0] == samples[1]
    assert samples[0][0][1] == 5.0 and samples[0][3][1] == 100.0


def test_shipped_behavior_equals_the_manifest():
    """The port reads no YAML; its constant must equal what the JAX package
    parses out of deploy/tpu-test-hpa.yaml."""
    manifest = jax_hpa.behavior_from_manifest(yaml.safe_load(HPA_YAML.read_text()))
    assert dataclasses.asdict(shipped_behavior()) == dataclasses.asdict(manifest)


# ---- scripted trace through scrape → rule → adapter → HPA ------------------


class _Trace:
    """Scripted offered load, in pods' worth, shared by the running pods:
    idle; a spike that lands at 3 replicas at 46% (inside a 20% tolerance
    band, outside the shipped 10% one); a partial drop that settles at 3
    replicas; then a drop that scales 3 → 1 through the 50% policy.  The
    real pod has two devices, the second half as busy, so the rule's
    per-pod max matters.  Both exporters fail from 200 s to 230 s, so the
    recorded series must go stale and the HPA hold."""

    def __init__(self, clock):
        self.clock = clock
        self.deployment = None  # set once the pipeline exists

    def offered(self) -> float:
        t = self.clock.now()
        if t < 30.0:
            return 0.2
        if t < 150.0:
            return 1.38
        if t < 330.0:
            return 1.0
        return 0.3

    def util(self) -> float:
        if 200.0 <= self.clock.now() < 230.0:
            raise ConnectionError("exporter down")
        running = len(self.deployment.running()) if self.deployment else 1
        return min(100.0, 100.0 * self.offered() / max(1, running))

    def real_exposition(self, mod_schema, mod_exposition):
        def fetch():
            u = self.util()
            chips = [
                mod_schema.ChipSample(0, 0.9 * u, u, 2e9, 85e9, None),
                mod_schema.ChipSample(1, 0.45 * u, 0.5 * u, 1e9, 85e9, None),
            ]
            return mod_exposition.encode_text(mod_schema.families_from_chips(
                chips, "real-0", {0: ("default", REAL_POD), 1: ("default", REAL_POD)},
            ))

        return fetch


def _jax_pipeline(fetch_real, mirror_util, clock, metric):
    """The JAX package's layers wired as bench.py's ``_wire_pipeline`` wires
    them, with the shipped tpu-test rule group's two rules."""
    deployment = MirrorDeployment(clock, 12.0)
    db = jax_tsdb.TimeSeriesDB(clock)
    scraper = jax_tsdb.Scraper(db)
    scraper.add_target(fetch_real, name="exporter/real", node="real-0")

    def sim():
        chips, attribution = [], {}
        for i, pod in enumerate(p for p in deployment.running() if p != REAL_POD):
            u = mirror_util()
            chips.append(jax_schema.ChipSample(i, u, u, 8e9, 16e9, u * 0.6))
            attribution[i] = ("default", pod)
        return jax_exposition.encode_text(
            jax_schema.families_from_chips(chips, "sim-0", attribution)
        )

    def ksm():
        fam = jax_schema.MetricFamily("kube_pod_labels", "gauge")
        for pod in deployment.pods:
            fam.add(1.0, namespace="default", pod=pod, label_app="tpu-test")
        return jax_exposition.encode_text([fam])

    scraper.add_target(sim, name="exporter/sim", node="sim-0")
    scraper.add_target(ksm, name="ksm")
    evaluator = jax_rules.RuleEvaluator(db, [
        jax_rules.tpu_test_avg_rule(),
        jax_rules.tpu_test_avg_rule(metric=jax_schema.TPU_DUTY_CYCLE, record=DUTY_SERIES),
    ])
    adapter = jax_adapter.CustomMetricsAdapter(db, [jax_adapter.AdapterRule(series=metric)])
    hpa = jax_hpa.HPAController(
        target=deployment,
        metrics=[jax_hpa.ObjectMetricSpec(
            metric, TARGET, jax_adapter.ObjectReference("Deployment", "tpu-test", "default"),
        )],
        adapter=adapter,
        clock=clock,
        min_replicas=1,
        max_replicas=MAX_REPLICAS,
        behavior=jax_hpa.behavior_from_manifest(yaml.safe_load(HPA_YAML.read_text())),
    )
    return deployment, db, scraper, evaluator, hpa


def _drive(clock, deployment, db, scraper, evaluator, hpa, until=620.0):
    recorded, timeline = [], []
    selector = {"deployment": "tpu-test"}
    next_sync = 15.0
    while clock.now() < until:
        now = clock.now()
        scraper.scrape_once()
        evaluator.evaluate_once()
        recorded.append((now, db.latest(TENSORCORE_SERIES, selector),
                         db.latest(DUTY_SERIES, selector)))
        if now >= next_sync:
            status = hpa.sync_once()
            next_sync = now + 15.0
            timeline.append((now, deployment.replicas, len(deployment.running()),
                             status.last_reason))
        clock.advance(1.0)
    return recorded, timeline


@pytest.mark.parametrize("metric", [TENSORCORE_SERIES, DUTY_SERIES])
def test_scripted_trace_gives_the_jax_packages_values_and_timeline(metric):
    port_trace = _Trace(VirtualClock())
    pipe = wire_pipeline(
        port_trace.real_exposition(schema, exposition), port_trace.util,
        port_trace.clock, metric=metric,
    )
    port_trace.deployment = pipe.deployment
    port = _drive(port_trace.clock, pipe.deployment, pipe.db, pipe.scraper, pipe.evaluator,
                  pipe.hpa)

    jax_trace = _Trace(JaxVirtualClock())
    layers = _jax_pipeline(
        jax_trace.real_exposition(jax_schema, jax_exposition), jax_trace.util,
        jax_trace.clock, metric,
    )
    jax_trace.deployment = layers[0]
    ref = _drive(jax_trace.clock, *layers)
    assert port[0] == ref[0]  # recorded series, point for point
    assert port[1] == ref[1]  # replica timeline and the HPA's reasons
    replicas = [r for _, r, _, _ in port[1]]
    # the trace reaches every branch it was scripted for: up to 4 through
    # the band edge, down to 3, and 3 → 1 by the 50% policy's ceiling
    assert max(replicas) == MAX_REPLICAS and replicas[-1] == 1
    assert any(reason.startswith("scale down 4->3") for *_, reason in port[1])
    assert any(reason.startswith("scale down 3->1") for *_, reason in port[1])
    assert any(reason == "metrics unavailable; holding" for *_, reason in port[1])
    assert all(tc is None and duty is None for t, tc, duty in port[0] if 201 <= t < 230)
