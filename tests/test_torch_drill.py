"""The recovery drill (``control/scale_harness.py``), its ``drill`` scenario
(``simulate.py``) and ``trial.recovery_drill_rung`` against the JAX
package's.

- ``run_recovery_drill()`` for all four components and for tsdb, hpa and
  adapter: JAX's result on every decision field (settled replicas, each
  fault's report, spurious scale events, the worst MTTR, replay gap and
  first good sync, the final replicas, the scale events and their
  lineages, the span count, ``ok``), and JAX's numbers: settled at 3, MTTR
  0 for each fault, a replay gap of 1.0 s, no spurious scale event, 2
  scale events with complete lineages, 4/4 at the end, 8724 spans.
- The restart log: JAX's, key for key (each TSDB restart recovers
  137 series, 18300 points, 1916 replayed records, then 127, 45486,
  2560), the port's ``pipeline-self`` target serving JAX's six query-engine
  series (the planner's four counters, the decode cache's two).
- An unknown component; ``simulate --scenario drill`` exits 0 and prints
  JAX's report, and exits 2 as JAX's does on an unknown component and on a
  failing drill; the rung is bench.py's dict.

Tolerance: exact (virtual time throughout).
"""

import functools
import json

import pytest
import torch

import bench
import k8s_gpu_hpa_tpu.__main__ as jax_cli
from k8s_gpu_hpa_tpu.control import scale_harness as jax_harness
from k8s_gpu_hpa_tpu.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu.obs import selfmetrics as jax_selfmetrics
import k8s_gpu_hpa_tpu_torch.__main__ as cli
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.control import scale_harness
from k8s_gpu_hpa_tpu_torch.obs import selfmetrics as port_selfmetrics
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

ALL = ("tsdb", "hpa", "adapter", "wal")
DECISION_FIELDS = (
    "settled_replicas", "faults", "all_recovered", "spurious_scale_events_during_replay",
    "mttr_max_s", "replay_gap_max_s", "first_good_sync_max_s", "final_replicas",
    "final_running", "scale_events", "scale_event_lineages", "lineage_complete",
    "trace_spans", "ok",
)
#: the JAX package's restart log of the whole drill: (recovered_series,
#: recovered_points, replayed_records) at each TSDB restart
JAX_RECOVERIES = [(137, 18300, 1916), (127, 45486, 2560)]


@functools.cache
def _drill(package: str, components: tuple[str, ...], planner_series: bool = True) -> str:
    """One package's drill; without ``planner_series`` its self-metrics
    attach no query engine, so they serve six series fewer."""
    harness, metrics = ((scale_harness, port_selfmetrics) if package == "port"
                        else (jax_harness, jax_selfmetrics))
    if planner_series:
        return json.dumps(harness.run_recovery_drill(components=components))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics.PipelineSelfMetrics, "attach_query_engine",
                   lambda self, stats, db: None)
        return json.dumps(harness.run_recovery_drill(components=components))


def _result(package: str, components=ALL, planner_series: bool = True) -> dict:
    return json.loads(_drill(package, tuple(components), planner_series))


@pytest.mark.parametrize("components", [ALL, ("tsdb", "hpa", "adapter")],
                         ids=["all", "tsdb-hpa-adapter"])
def test_the_drill_decides_as_jax_s(components):
    port, ref = _result("port", components), _result("jax", components)
    assert {k: port[k] for k in DECISION_FIELDS} == {k: ref[k] for k in DECISION_FIELDS}
    assert {k: port[k] for k in port if k != "restarts"} == {k: ref[k] for k in ref
                                                              if k != "restarts"}
    assert scale_harness.render_drill_report(port) == jax_harness.render_drill_report(ref)


def test_the_drill_gives_jax_s_numbers():
    port = _result("port")
    assert port["settled_replicas"] == 3
    assert [(f["fault"], f["mttr"], f["time_to_first_good_sync"], f["recovered"])
            for f in port["faults"]] == [
        ("tsdb_restart@30s", 0.0, 0.0, True), ("hpa_restart@210s", 0.0, 0.0, True),
        ("adapter_restart@390s", 0.0, 0.0, True), ("wal_truncate@570s", 0.0, 0.0, True)]
    assert [f["replay_gap"] for f in port["faults"]] == [1.0, None, None, 1.0]
    assert (port["spurious_scale_events_during_replay"], port["mttr_max_s"],
            port["replay_gap_max_s"], port["first_good_sync_max_s"]) == (0, 0.0, 1.0, 0.0)
    assert (port["scale_events"], port["scale_event_lineages"], port["lineage_complete"]) == (
        2, 2, True)
    assert (port["final_replicas"], port["final_running"], port["trace_spans"], port["ok"]) == (
        4, 4, 8724, True)


def _recoveries(result: dict) -> list[tuple]:
    return [(r["recovered_series"], r["recovered_points"], r["replayed_records"])
            for r in result["restarts"] if r["component"] == "tsdb"]


def test_the_restart_log_is_jax_s_without_the_planner_series():
    """With the six query-engine series withheld from both packages'
    self-metrics, the restart log is still JAX's key for key: every other
    series recovers as JAX's does."""
    port = _result("port", planner_series=False)
    assert port["restarts"] == _result("jax", planner_series=False)["restarts"]
    assert [(r["component"], r["at"]) for r in port["restarts"]] == [
        ("tsdb", 165.0), ("hpa", 345.0), ("adapter", 525.0), ("tsdb", 705.0)]
    for r in port["restarts"]:
        if r["component"] == "tsdb":
            assert (r["snapshot_restored"], r["dropped_records"], r["replay_gap_seconds"],
                    r["newest_ts"]) == (True, 0, 1.0, r["at"] - 1.0)
        elif r["component"] == "hpa":
            assert r["checkpoint_restored"] is True


def test_the_restart_log_differs_from_jax_s_by_the_planner_series_alone():
    """The whole restart log is JAX's, its two TSDB restarts recovering
    JAX's series, points and replayed records; the log with the six
    query-engine series withheld differs from it in the recovered counts
    alone, by six series at each TSDB restart."""
    port, ref = _result("port"), _result("jax")
    assert _recoveries(ref) == JAX_RECOVERIES
    assert port["restarts"] == ref["restarts"]
    withheld = _result("port", planner_series=False)
    assert [p[0] - w[0] for p, w in zip(_recoveries(port), _recoveries(withheld))] == [6, 6]
    strip = ("recovered_series", "recovered_points", "replayed_records")
    assert [{k: v for k, v in r.items() if k not in strip} for r in withheld["restarts"]] == [
        {k: v for k, v in r.items() if k not in strip} for r in port["restarts"]]


def test_the_planner_series_are_the_six_jax_serves_and_the_port_does_not():
    """The six query-engine series are the ones JAX's self-metrics serve
    once a query engine is attached; until then the port's do not serve
    them, as JAX's do not, and once attached its exposition is JAX's."""
    from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    class Stats:
        fastpath = fallback = series_cache_hits = series_resolves = 0

    class Db:
        decode_cache_hits = decode_cache_misses = 0

    def samples(exposition: str) -> set[tuple]:
        return {(f.name + s.suffix, s.labels) for f in parse_text(exposition) for s in f.samples}

    ref = jax_selfmetrics.PipelineSelfMetrics(clock=JaxClock())
    port = port_selfmetrics.PipelineSelfMetrics(clock=VirtualClock())
    assert samples(port.exposition()) == samples(ref.exposition())
    unattached = {name for name, _ in samples(port.exposition())}
    ref.attach_query_engine(Stats(), Db())
    port.attach_query_engine(Stats(), Db())
    assert port.exposition() == ref.exposition()
    six = {name for name, _ in samples(ref.exposition())} - unattached
    assert sorted(six) == sorted(port_selfmetrics.SELF_METRIC_NAMES[4:])
    assert len(six) == 6 and not six & unattached


def test_an_unknown_component_is_refused_as_jax_s():
    with pytest.raises(ValueError) as got:
        scale_harness.run_recovery_drill(components=("tsdb", "flux-capacitor"))
    with pytest.raises(ValueError) as want:
        jax_harness.run_recovery_drill(components=("tsdb", "flux-capacitor"))
    assert str(got.value) == str(want.value)
    assert "flux-capacitor" in str(got.value) and "adapter, hpa, tsdb, wal" in str(got.value)


def test_the_components_are_jax_s():
    assert scale_harness.DRILL_COMPONENTS == jax_harness.DRILL_COMPONENTS


def test_the_rung_gives_bench_s_dict():
    port = trial.recovery_drill_rung()
    assert port == bench.run_rung_recovery_drill()
    assert trial.drill_rung(_result("port")) == port
    assert port["mttr_s"] == {"tsdb_restart@30s": 0.0, "hpa_restart@210s": 0.0,
                              "adapter_restart@390s": 0.0, "wal_truncate@570s": 0.0}


# ---- the CLI ---------------------------------------------------------------------


def _as_drilled(package: str):
    """The drill as ``run_recovery_drill`` is asked for it, from the cache:
    both packages' drills of every component already ran above."""

    def drill(components, pod_start_latency):
        assert pod_start_latency == 12.0
        return _result(package, components)

    return drill


@pytest.mark.parametrize("components", [None, "hpa", "tsdb,wal"])
def test_the_drill_scenario_exits_0_and_prints_jax_s_report(components, monkeypatch, capsys):
    args = ["simulate", "--scenario", "drill"] + (
        ["--components", components] if components else [])
    if components is None:  # all four: the cached drills
        monkeypatch.setattr(scale_harness, "run_recovery_drill", _as_drilled("port"))
        monkeypatch.setattr(jax_harness, "run_recovery_drill", _as_drilled("jax"))
    assert cli.main(args) == 0
    port = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    assert port == capsys.readouterr().out
    assert port.rstrip().endswith("verdict: PASS")


def test_an_unknown_component_exits_2_as_jax_s(capsys):
    args = ["simulate", "--scenario", "drill", "--components", "hpa,flux-capacitor"]
    assert cli.main(args) == 2
    port = capsys.readouterr().out
    assert jax_cli.main(args) == 2
    assert port == capsys.readouterr().out
    assert port.startswith("simulate: unknown drill component(s) ['flux-capacitor']")


@pytest.mark.parametrize("how", ["unrecovered", "spurious"])
def test_a_failing_drill_exits_2_as_jax_s(how, monkeypatch, capsys):
    canned = _result("port", ("hpa",))
    if how == "unrecovered":
        canned["faults"][0].update(recovered=False, recovered_at=None, mttr=None)
        canned["all_recovered"] = False
    else:
        canned["spurious_scale_events_during_replay"] = 1
    canned["ok"] = False
    monkeypatch.setattr(scale_harness, "run_recovery_drill", lambda **kw: canned)
    monkeypatch.setattr(jax_harness, "run_recovery_drill", lambda **kw: canned)
    args = ["simulate", "--scenario", "drill", "--components", "hpa"]
    assert cli.main(args) == 2
    port = capsys.readouterr().out
    assert jax_cli.main(args) == 2
    assert port == capsys.readouterr().out
    assert port.rstrip().endswith("verdict: FAIL")
