"""The tracing plane (``obs/``) and the traced pipeline against the JAX
package's.

The same seeded scenario runs through both packages, each on its own
virtual clock, and the traces are held equal span by span: kind, id,
start, end, links and every attribute.  Tolerance: exact, with one stated
exception, the wall-clock ``duration_seconds`` attribute (the
``pipeline-self`` scrape's ``samples`` count the query planner's and the
decode cache's counters in both).  The runs: the shipped HPAs' traced spike and
outage (``simulate.run_scenario(trace=True)``: the headline HPA, the slice
HPA in quanta of 2), seeded random load steps on a cluster whose exporters
sample every 1 s or every 10 s, scraped every 1 s or every 5 s (where
incremental rule evaluation skips), and an External queue HPA.  Every scale event's lineage is complete and
equals JAX's hop for hop.  Then the schema's messages, the span and tracer
mechanics, the JSONL round trip through both readers, and the ``trace``
scenario on the CLI, after ``tests/test_obs.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu import obs as jax_obs
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.__main__ import main as jax_main
from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch import obs, simulate
from k8s_gpu_hpa_tpu_torch.__main__ import main
from k8s_gpu_hpa_tpu_torch.control import adapter, cluster, hpa, loop
from k8s_gpu_hpa_tpu_torch.manifests import load_yaml
from k8s_gpu_hpa_tpu_torch.metrics import schema
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy"
PORT = (cluster, hpa, loop, clock, obs, adapter, schema)
JAX = (jax_cluster, jax_hpa, jax_loop, jax_clock, jax_obs, jax_adapter, jax_schema)


def _normalized(span) -> dict:
    """A span's dict without what may rightly differ: the wall-clock
    ``duration_seconds`` (the ``pipeline-self`` scrape's ``samples`` is
    JAX's, the six query-engine series included)."""
    d = span.as_dict()
    d["attrs"] = {k: v for k, v in d["attrs"].items() if k != "duration_seconds"}
    return d


def assert_traces_equal(port_spans, ref_spans) -> None:
    assert len(port_spans) == len(ref_spans)
    for got, want in zip(port_spans, ref_spans):
        assert _normalized(got) == _normalized(want)


def assert_lineages_complete_and_equal(port_tracer, ref_tracer, hops=obs.LINEAGE_ORDER) -> int:
    port_by_id = obs.index_spans(port_tracer.spans)
    ref_by_id = jax_obs.index_spans(ref_tracer.spans)
    events = port_tracer.spans_of("scale_event")
    assert [e.span_id for e in events] == [e.span_id for e in ref_tracer.spans_of("scale_event")]
    for event in events:
        got = obs.lineage_of(event, port_by_id)
        want = jax_obs.lineage_of(ref_by_id[event.span_id], ref_by_id)
        assert got == want
        assert got["complete"], obs.format_lineage(got)
        assert [h["kind"] for h in got["hops"]] == list(hops)
        assert obs.format_lineage(got) == jax_obs.format_lineage(want)
    return len(events)


def _docs(name: str) -> tuple[dict, dict]:
    text = (DEPLOY / name).read_text()
    return load_yaml(text), yaml.safe_load(text)


# ---- the shipped HPAs, traced -------------------------------------------------


@pytest.mark.parametrize("scenario", ["spike", "outage"])
@pytest.mark.parametrize("name", ["tpu-test-hpa.yaml", "tpu-test-multihost-hpa.yaml"])
def test_the_traced_scenario_gives_jax_s_spans_and_lineages(name, scenario):
    port_doc, ref_doc = _docs(name)
    port = simulate.run_scenario(port_doc, scenario, duration=240.0, trace=True)
    ref = jax_simulate.run_scenario(ref_doc, scenario, duration=240.0, trace=True)
    assert port.trace_base == ref.trace_base
    assert port.scale_events == ref.scale_events and port.timeline == ref.timeline
    assert_traces_equal(port.tracer.spans, ref.tracer.spans)
    assert assert_lineages_complete_and_equal(port.tracer, ref.tracer) >= 1
    assert simulate.render_trace_timeline(port) == jax_simulate.render_trace_timeline(ref)
    if scenario == "outage":
        # the blackout's failed scrapes carry JAX's error and no link
        failed = [s for s in port.tracer.spans_of("scrape") if not s.attrs["ok"]]
        assert failed and all(s.attrs["error"] == "exporter down (scenario)" for s in failed)
        assert all(s.links == () for s in failed)
    if name == "tpu-test-multihost-hpa.yaml":
        assert all(s.attrs["to_replicas"] % 2 == 0 for s in port.tracer.spans_of("scale_event"))


def test_the_traced_spike_on_the_headline_hpa_gives_jax_s_counts():
    """The reference run: 420 s of the spike on deploy/tpu-test-hpa.yaml,
    spans counted by kind as the JAX package counts them."""
    port_doc, _ = _docs("tpu-test-hpa.yaml")
    report = simulate.run_scenario(port_doc, "spike", trace=True)
    kinds: dict[str, int] = {}
    for span in report.tracer.spans:
        kinds[span.kind] = kinds.get(span.kind, 0) + 1
    assert kinds == {"scrape": 1680, "exporter_sample": 840, "rule_eval": 420,
                     "adapter_query": 28, "hpa_sync": 28, "scale_event": 2,
                     "workload_change": 1}
    assert [(s.attrs["from_replicas"], s.attrs["to_replicas"])
            for s in report.tracer.spans_of("scale_event")] == [(1, 3), (3, 4)]
    prop = obs.propagation_report(report.tracer.spans)
    assert (prop["changes_total"], prop["scale_latency_p95"]) == (1, 15.0)


def _random_steps(seed: int, t_end: float, n: int = 4):
    """A seeded staircase of offered load (percent of one device, shared)."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(20.0, t_end - 60.0, n)).tolist()
    levels = rng.uniform(20.0, 320.0, n + 1).round(1).tolist()

    def load(t):
        for at, level in zip(times, levels):
            if t < at:
                return level
        return levels[-1]

    return load


def traced_pipeline(mods, load_fn, exporter_sample_interval=1.0, **kw):
    """``tests/test_obs.py``'s traced pipeline on one package: two nodes of
    4 devices, shared load, target 40, the load's steps traced."""
    cluster_mod, _, loop_mod, clock_mod, obs_mod = mods[:5]
    vclock = clock_mod.VirtualClock()
    tracer = obs_mod.Tracer(vclock)
    sim = cluster_mod.SimCluster(
        vclock, nodes=[("obs-node-0", 4), ("obs-node-1", 4)],
        exporter_sample_interval=exporter_sample_interval,
    )
    dep = cluster_mod.SimDeployment(
        sim, "tpu-test", "tpu-test", load_fn=obs_mod.TracedLoad(load_fn, tracer),
        load_mode="shared",
    )
    sim.add_deployment(dep, replicas=1)
    pipe = loop_mod.AutoscalingPipeline(
        sim, dep, target_value=40.0, max_replicas=kw.pop("max_replicas", 8), tracer=tracer, **kw
    )
    pipe.start()
    return vclock, tracer, pipe


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("exporter,scrape", [(1.0, 1.0), (10.0, 1.0), (10.0, 5.0)])
def test_seeded_load_steps_give_jax_s_spans(seed, exporter, scrape):
    """The exporters collect every 1 s or every 10 s (the reference's
    interval); with a 5 s scrape the rules' inputs stand still for four
    ticks in five, incremental evaluation skips those ticks, and a skipped
    tick emits no rule_eval span, in both packages.  (At a 1 s scrape the
    inputs are rewritten every tick, cache hits included, so no tick
    skips.)"""
    runs = []
    for mods in (PORT, JAX):
        vclock, tracer, pipe = traced_pipeline(
            mods, _random_steps(seed, 300.0), exporter_sample_interval=exporter,
            intervals=mods[2].PipelineIntervals(scrape=scrape))
        vclock.advance(300.0)
        runs.append((tracer, pipe))
    (port_tracer, port_pipe), (ref_tracer, ref_pipe) = runs
    assert_traces_equal(port_tracer.spans, ref_tracer.spans)
    assert_lineages_complete_and_equal(port_tracer, ref_tracer)
    assert port_pipe.scale_history == ref_pipe.scale_history
    rule = port_pipe.evaluator.rules[0]
    ref_rule = ref_pipe.evaluator.rules[0]
    assert (rule.full_evals, rule.skipped_evals) == (ref_rule.full_evals, ref_rule.skipped_evals)
    assert len(port_tracer.spans_of("rule_eval")) == rule.full_evals
    if scrape == 5.0:
        assert rule.skipped_evals > rule.full_evals > 0
    else:
        assert rule.skipped_evals == 0
    assert obs.propagation_report(port_tracer.spans) == jax_obs.propagation_report(
        ref_tracer.spans)


QUEUE_LABELS = (("namespace", "default"), ("queue", "tpu-serve"))


def external_pipeline(mods, demand):
    """A traced pipeline under the shipped queue HPA
    (deploy/tpu-test-external-hpa.yaml): the node exporter also serves the
    queue depth, so its scrape links to the exporter's sweep, and the
    adapter serves it on external.metrics.k8s.io."""
    cluster_mod, hpa_mod, loop_mod, clock_mod, obs_mod, adapter_mod, schema_mod = mods
    text = (DEPLOY / "tpu-test-external-hpa.yaml").read_text()
    doc = load_yaml(text) if mods is PORT else yaml.safe_load(text)
    vclock = clock_mod.VirtualClock()
    tracer = obs_mod.Tracer(vclock)
    sim = cluster_mod.SimCluster(vclock, nodes=[("tpu-node-0", 8)])
    dep = cluster_mod.SimDeployment(sim, "tpu-test", "tpu-test", load_fn=lambda t: 30.0,
                                    load_mode="shared")
    sim.add_deployment(dep, replicas=1)
    pipe = loop_mod.AutoscalingPipeline(
        sim, dep, metric_specs=hpa_mod.metrics_from_manifest(doc),
        behavior=hpa_mod.behavior_from_manifest(doc), max_replicas=doc["spec"]["maxReplicas"],
        tracer=tracer,
    )
    pipe.adapter.external_rules["tpu_test_queue_depth"] = adapter_mod.ExternalRule(
        "tpu_test_queue_depth")

    def queue():
        fam = schema_mod.MetricFamily("tpu_test_queue_depth", "gauge", "queued requests")
        fam.samples.append(schema_mod.Sample(demand(vclock.now()), QUEUE_LABELS))
        return [fam]

    target = pipe.scraper.add_target(queue, name="queue")
    target.trace_origin = lambda: sim.exporter_sample_span("tpu-node-0")
    pipe.start()
    return vclock, tracer, pipe


def test_an_external_queue_hpa_gives_jax_s_spans():
    demand = _random_steps(7, 300.0)
    runs = []
    for mods in (PORT, JAX):
        vclock, tracer, pipe = external_pipeline(mods, lambda t: 2.0 * demand(t))
        vclock.advance(300.0)
        runs.append((tracer, pipe))
    (port_tracer, port_pipe), (ref_tracer, ref_pipe) = runs
    assert_traces_equal(port_tracer.spans, ref_tracer.spans)
    # the adapter reads the scraped series itself: no rule_eval hop
    direct = tuple(k for k in obs.LINEAGE_ORDER if k != "rule_eval")
    assert assert_lineages_complete_and_equal(port_tracer, ref_tracer, direct) >= 1
    assert port_pipe.scale_history == ref_pipe.scale_history
    queries = port_tracer.spans_of("adapter_query")
    assert queries and {q.attrs["api"] for q in queries} == {"external"}
    assert all(q.attrs["found"] for q in queries[2:])


# ---- the schema ----------------------------------------------------------------


def test_the_schema_is_jax_s_table():
    assert obs.SPAN_SCHEMA == jax_obs.SPAN_SCHEMA
    assert obs.LINEAGE_ORDER == jax_obs.LINEAGE_ORDER


SCHEMA_CASES = [
    ("mystery", {}, None),
    ("mystery", {}, 7),
    ("scrape", {"target": "x"}, None),
    ("scrape", {"target": "x"}, 3),
    ("scrape", {"target": "x", "ok": True, "colour": "red"}, 4),
    ("hpa_sync", {"reason": "r"}, None),
    ("rule_eval", {"rule": "r", "samples_out": 1, "staleness_seconds": 0.0, "extra": 1, "z": 2}, 9),
]


@pytest.mark.parametrize("kind,attrs,span_id", SCHEMA_CASES)
def test_validate_span_fields_raises_jax_s_messages(kind, attrs, span_id):
    with pytest.raises(ValueError) as got:
        obs.validate_span_fields(kind, attrs, span_id=span_id)
    with pytest.raises(ValueError) as want:
        jax_obs.validate_span_fields(kind, attrs, span_id=span_id)
    assert str(got.value) == str(want.value)


def test_every_declared_shape_validates():
    for kind, entry in obs.SPAN_SCHEMA.items():
        attrs = {k: 1 for k in entry["required"] | entry["optional"]}
        obs.validate_span_fields(kind, attrs)
        jax_obs.validate_span_fields(kind, attrs)


def test_the_tracer_refuses_an_undeclared_shape_at_close_unless_told_not_to():
    vclock = clock.VirtualClock()
    with pytest.raises(ValueError, match="missing required attrs"):
        obs.Tracer(vclock).emit("scrape", {"target": "x"})
    loose = obs.Tracer(vclock, validate=False)
    assert loose.emit("scrape", {"target": "x"}).span_id == 1


# ---- spans, scopes, lineage (tests/test_obs.py) --------------------------------


def _hand_built_dag(mods):
    vclock = mods[3].VirtualClock()
    tracer = mods[4].Tracer(vclock)
    e1 = tracer.emit("exporter_sample", {"node": "n0", "chips": 4})
    e2 = tracer.emit("exporter_sample", {"node": "n1", "chips": 4})
    vclock.advance(1.0)
    s1 = tracer.emit("scrape", {"target": "exporter/n0", "ok": True}, links=(e1.span_id,))
    tracer.emit("scrape", {"target": "exporter/n1", "ok": True}, links=(e2.span_id,))
    rule = tracer.emit("rule_eval", {"rule": "r", "samples_out": 1}, links=(s1.span_id,))
    vclock.advance(1.0)
    tracer.push_scope()
    query = tracer.emit("adapter_query", {"api": "object", "metric": "m", "found": True},
                        links=(rule.span_id, rule.span_id))
    sync = tracer.open("hpa_sync")
    vclock.advance(0.5)
    tracer.close(sync, tracer.pop_scope(), reason="scale up", current_replicas=1,
                 desired_replicas=2)
    scale = tracer.emit("scale_event", {"from_replicas": 1, "to_replicas": 2},
                        links=(sync.span_id,))
    return tracer, scale


def test_a_hand_built_dag_walks_as_jax_s_does():
    """The walk returns exactly the spans whose data fed the decision: the
    parallel branch the rule never read is left out; a scope collects the
    spans closed inside it; a repeated link counts once."""
    tracer, scale = _hand_built_dag(PORT)
    ref_tracer, ref_scale = _hand_built_dag(JAX)
    assert [s.as_dict() for s in tracer.spans] == [s.as_dict() for s in ref_tracer.spans]
    lineage = obs.lineage_of(scale, obs.index_spans(tracer.spans))
    assert lineage == jax_obs.lineage_of(ref_scale, jax_obs.index_spans(ref_tracer.spans))
    by_kind = {h["kind"]: h["span_ids"] for h in lineage["hops"]}
    assert by_kind == {"scale_event": [8], "hpa_sync": [7], "adapter_query": [6],
                       "rule_eval": [5], "scrape": [3], "exporter_sample": [1]}
    assert tracer.get(6).links == (5,) and tracer.get(7).links == (6,)
    assert tracer.get(7).start == 2.0 and tracer.get(7).end == 2.5
    assert "INCOMPLETE" not in obs.format_lineage(lineage)


def test_a_truncated_trace_walks_to_an_incomplete_lineage():
    tracer, scale = _hand_built_dag(PORT)
    kept = [s for s in tracer.spans if s.kind not in ("scrape", "exporter_sample")]
    lineage = obs.lineage_of(scale, obs.index_spans(kept))
    assert not lineage["complete"]
    assert obs.format_lineage(lineage).endswith("[INCOMPLETE: no exporter samples reached]")
    ref_tracer, ref_scale = _hand_built_dag(JAX)
    ref_kept = [s for s in ref_tracer.spans if s.kind not in ("scrape", "exporter_sample")]
    assert lineage == jax_obs.lineage_of(ref_scale, jax_obs.index_spans(ref_kept))


def test_span_from_dict_defaults():
    span = obs.Span.from_dict({"span_id": 7, "kind": "scrape", "start": 1.0, "end": 2.0})
    assert span.attrs == {} and span.links == ()


def test_spans_of_and_get():
    tracer, _ = _hand_built_dag(PORT)
    assert [s.span_id for s in tracer.spans_of("scrape")] == [3, 4]
    assert tracer.get(99) is None


# ---- JSONL ---------------------------------------------------------------------


def test_a_trace_round_trips_through_jsonl_and_reads_in_both_packages(tmp_path):
    vclock, tracer, _ = traced_pipeline(PORT, _random_steps(3, 200.0))
    vclock.advance(200.0)
    path = tmp_path / "trace.jsonl"
    assert tracer.write_jsonl(path) == len(tracer.spans) > 0
    want = [s.as_dict() for s in tracer.spans]
    assert [s.as_dict() for s in obs.read_jsonl(path)] == want
    assert [s.as_dict() for s in jax_obs.read_jsonl(path)] == want
    # a blank line is skipped, and a reloaded trace walks as the original
    path.write_text(path.read_text().replace("\n", "\n\n", 1))
    loaded = obs.read_jsonl(path)
    by_id = obs.index_spans(loaded)
    for event in (s for s in loaded if s.kind == "scale_event"):
        assert obs.lineage_of(event, by_id) == obs.lineage_of(
            tracer.get(event.span_id), obs.index_spans(tracer.spans))


def test_jax_s_export_reads_in_the_port(tmp_path):
    _, tracer, _ = traced_pipeline(JAX, _random_steps(4, 120.0))
    tracer.clock.advance(120.0)
    path = tmp_path / "jax.jsonl"
    tracer.write_jsonl(path)
    assert [s.as_dict() for s in obs.read_jsonl(path)] == [s.as_dict() for s in tracer.spans]


# ---- the trace scenario on the CLI ---------------------------------------------


def _without_query_engine(text: str) -> str:
    """The trace output as printed, after a check that it holds the query
    engine's line (the port prints JAX's line, counters and all)."""
    assert any(line.startswith("query engine: planner fastpath ")
               for line in text.splitlines())
    return text


@pytest.mark.parametrize("name", ["tpu-test-hpa.yaml", "tpu-test-multihost-hpa.yaml"])
def test_the_trace_scenario_prints_and_writes_what_jax_s_does(name, tmp_path, capsys,
                                                            monkeypatch):
    monkeypatch.chdir(REPO)
    port_out, ref_out = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    args = ["simulate", "--scenario", "trace", "--hpa", f"deploy/{name}", "--duration", "240"]
    assert main([*args, "--trace-out", str(port_out)]) == 0
    out = capsys.readouterr().out
    assert jax_main([*args, "--trace-out", str(ref_out)]) == 0
    ref = capsys.readouterr().out
    assert _without_query_engine(out).replace(str(port_out), "OUT") == _without_query_engine(
        ref).replace(str(ref_out), "OUT")
    assert "lineage: scale_event x1" in out and "INCOMPLETE" not in out
    assert_traces_equal(obs.read_jsonl(port_out), jax_obs.read_jsonl(ref_out))


def test_the_trace_scenario_writes_trace_jsonl_by_default(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    hpa_path = str(DEPLOY / "tpu-test-hpa.yaml")
    assert main(["simulate", "--scenario", "trace", "--hpa", hpa_path, "--duration", "120"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("wrote ")
    assert obs.read_jsonl(tmp_path / "trace.jsonl")


def test_the_trace_scenario_exits_2_when_no_scale_event_is_traced(tmp_path, capsys):
    """40 s of the spike end before its step: no scale event, so no
    lineage to hold, and the contract is reported violated."""
    out = tmp_path / "t.jsonl"
    args = ["simulate", "--scenario", "trace", "--hpa", str(DEPLOY / "tpu-test-hpa.yaml"),
            "--duration", "40", "--trace-out", str(out)]
    assert main(args) == 2
    text = capsys.readouterr().out
    assert text.splitlines()[-1] == "TRACE CONTRACT VIOLATED: no scale events traced"
    assert jax_main(args) == 2
    assert capsys.readouterr().out.splitlines()[-1] == text.splitlines()[-1]


def test_the_trace_scenario_refuses_an_external_hpa_with_a_diagnosis(tmp_path, capsys):
    code = main(["simulate", "--scenario", "trace", "--hpa",
                 str(DEPLOY / "tpu-test-external-hpa.yaml"), "--trace-out",
                 str(tmp_path / "t.jsonl")])
    assert code == 2
    assert capsys.readouterr().out.startswith("simulate: simulate supports single Object-metric")


def test_the_trace_scenario_runs_as_a_program(tmp_path):
    out = tmp_path / "t.jsonl"
    run = subprocess.run(
        [sys.executable, "-m", "k8s_gpu_hpa_tpu_torch", "simulate", "--scenario", "trace",
         "--duration", "120", "--trace-out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.splitlines()[-1] == f"wrote {len(obs.read_jsonl(out))} spans to {out}"
    assert json.loads(out.read_text().splitlines()[0])["kind"] == "exporter_sample"
