"""The profile plane (``obs/profile.py``), its stage brackets in the ported
planes, ``control/profile_harness.py``, the ``profile`` scenario and the
``profile_bench`` rung against the JAX package's.

- test_profile.py's fifteen cases on the port: the registry, the shared
  no-op bracket, nested self and cumulative accounting, unregistered and
  unbalanced brackets, the exception-safe exit, the bounded trace buffer,
  the storm balanced and bit-identical, the diff gate with its planted
  canary and lost paths, the attribution floor and its probe, the metric
  families, the coverage session, and the CLI exit-code matrix.
- The canonical export of ``run_profile`` for the storm, the crunch and the
  smoke scale run equals JAX's, path for path (stage, domain, depth,
  count) and as bytes: each bracket nests as JAX's does, not only the same
  number of times.  Each has no open span and its attribution meets
  ``PROFILE_MIN_ATTRIBUTION``.
- ``chip_smoke.py``'s coverage phase holds the card's exports to JAX's
  digests, recomputed here from the JAX package.
- ``trial.profile_bench_rung()`` carries bench.py's keys, and its
  deterministic fields (``bit_identical``, ``canary_caught``,
  ``clean_diff_regression``, ``open_spans``, the scale shape and every
  stage's calls) equal those of bench.py's ``run_rung_profile_bench`` at
  its smoke time scale, built from JAX's ``run_profile``.

Tolerance: exact on the structure (virtual time); the wall-clock fields
(seconds, attribution, shares) are checked against their floors only.
"""

import argparse
import hashlib
import json

import pytest
import torch

import bench
import chip_smoke
from k8s_gpu_hpa_tpu import perfgates as jax_perfgates
from k8s_gpu_hpa_tpu.control import profile_harness as jax_harness
from k8s_gpu_hpa_tpu.obs import profile as jax_profile
from k8s_gpu_hpa_tpu_torch import perfgates, trial
from k8s_gpu_hpa_tpu_torch.control.profile_harness import (
    PROFILE_RUNS,
    run_profile,
    run_profile_coverage_session,
)
from k8s_gpu_hpa_tpu_torch.obs import coverage, profile
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: SHA-256 of JAX's canonical export per run, recorded on the CPU from the
#: JAX package
JAX_SHA256 = {
    "storm": "3a71ad8d0f5e6f1c899c7818e50b0dffbf187fdb078fd640f2be21dfba74215c",
    "crunch": "179a4e96e5ab6a5e29f3b73f9a0b6ba4e076fab554ba1d2f2a78a9c4c0f9a2b0",
    "scale": "324b379db7ec181d1aabc89782fc5b384342912453081049a0894422e61f618f",
}

#: a time scale below 1, which picks bench.py's smoke shape
BENCH_SMOKE_TIME_SCALE = 0.1

#: the rung's fields that read the wall clock
WALL = {"scale_wall_s", "attribution", "stages", "ok"}


@pytest.fixture(scope="module")
def records():
    """Each canned run of each package once, the scale run at the smoke
    shape: {run: (port record, JAX record)}."""
    return {
        run: (run_profile(run, smoke=True)[0], jax_harness.run_profile(run, smoke=True)[0])
        for run in PROFILE_RUNS
    }


@pytest.fixture(scope="module")
def scale(records):
    return records["scale"][0]


# ---- registry -------------------------------------------------------------------


def test_stage_registry_is_stable():
    assert profile.stage_ids() == [
        "adapter:query",
        "capacity:try_place",
        "downsample:compact",
        "harness:observe",
        "hpa:sync",
        "planner:plan",
        "rules:eval",
        "rules:eval_fallback",
        "rules:eval_planned",
        "scrape:sweep",
        "tsdb:append",
        "wal:flush",
    ]
    for stage_id, stage in profile.STAGES.items():
        assert stage.stage_id == stage_id
        assert stage.domain in profile.DOMAINS
        assert stage.description
    # JAX's twelve, in JAX's order, with JAX's domains and descriptions
    assert profile.DOMAINS == jax_profile.DOMAINS
    assert [(s.domain, s.stage_id, s.description) for s in profile.STAGES.values()] == [
        (s.domain, s.stage_id, s.description) for s in jax_profile.STAGES.values()
    ]


def test_stage_registry_rejects_duplicates_and_unknown_domains():
    with pytest.raises(ValueError, match="duplicate"):
        profile.stage_def("scrape", "sweep", "again")
    with pytest.raises(ValueError, match="unknown stage domain"):
        profile.stage_def("warp_drive", "engage", "no such domain")


# ---- zero cost when off, and the accounting --------------------------------------


def test_inactive_bracket_is_shared_noop():
    assert profile.active() is None
    span_a = profile.stage("scrape:sweep")
    span_b = profile.stage("tsdb:append")
    # one shared null object, no allocation a call, nothing recorded
    assert span_a is span_b
    with span_a:
        pass
    pmap = profile.ProfileMap("t")
    assert pmap.export()["paths"] == {}


def test_nested_accounting_self_cum_counts():
    pmap = profile.ProfileMap("t")
    profile.activate(pmap)
    try:
        for _ in range(3):
            with profile.stage("rules:eval"):
                with profile.stage("planner:plan"):
                    pass
    finally:
        profile.deactivate()
    export = pmap.timed_export(1.0)
    outer = export["paths"]["rules:eval"]
    inner = export["paths"]["rules:eval;planner:plan"]
    assert outer["count"] == 3 and inner["count"] == 3
    assert inner["depth"] == 2 and inner["stage"] == "planner:plan"
    assert inner["domain"] == "planner"
    # a parent's self time leaves its child's out; its cumulative takes it in
    assert outer["cum_s"] >= outer["self_s"] >= 0.0
    assert outer["cum_s"] >= inner["cum_s"]
    rollup = profile.stage_rollup(export)
    assert rollup["rules:eval"]["calls"] == 3


def test_unregistered_stage_and_unbalanced_exit_raise():
    pmap = profile.ProfileMap("t")
    profile.activate(pmap)
    try:
        with pytest.raises(KeyError, match="unregistered stage"):
            with profile.stage("tsdb:quantum_leap"):
                pass
        with pytest.raises(RuntimeError, match="unbalanced"):
            pmap._exit("scrape:sweep")
    finally:
        profile.deactivate()
    with pytest.raises(KeyError, match="unregistered stage"):
        profile.ProfileMap("t", plant={"warp:core": 1.0})


def test_exception_unwinds_open_span():
    # a fault raising mid-stage closes its span on the way out, so the map
    # stays balanced and later spans do not nest under a ghost parent
    with profile.collect("t") as pmap:
        with pytest.raises(RuntimeError, match="adapter blackout"):
            with profile.stage("scrape:sweep"):
                with profile.stage("adapter:query"):
                    raise RuntimeError("adapter blackout")
        assert pmap.open_spans() == []
        with profile.stage("hpa:sync"):
            pass
    assert "hpa:sync" in pmap.export()["paths"]
    assert pmap.export()["paths"]["hpa:sync"]["depth"] == 1
    # collect() deactivated on exit though the block raised earlier
    assert profile.active() is None


def test_trace_event_buffer_is_bounded():
    pmap = profile.ProfileMap("t", trace_cap=5)
    profile.activate(pmap)
    try:
        for _ in range(9):
            with profile.stage("wal:flush"):
                pass
    finally:
        profile.deactivate()
    assert pmap.events_dropped == 4
    trace = json.loads(profile.render_chrome_trace(pmap))
    assert len(trace["traceEvents"]) == 5
    assert trace["otherData"]["events_dropped"] == 4
    # the aggregate keeps counting past the raw-event cap
    assert pmap.export()["paths"]["wal:flush"]["count"] == 9


# ---- determinism and balance under the fault storm ----------------------------------


def test_storm_profile_is_balanced_and_bit_identical():
    """Same-seed storm runs, the whole fault schedule included, leave no
    open span and export bit-identical structure; the trace and flame
    renderings are the same structure but for their timings."""
    first = run_profile("storm", seed=3)[0]
    second = run_profile("storm", seed=3)[0]
    assert first["open_spans"] == [] and second["open_spans"] == []
    assert first["canonical"] == second["canonical"]
    assert json.loads(first["canonical"])["run"] == "storm@3"

    def trace_structure(rec):
        events = json.loads(profile.render_chrome_trace(rec["pmap"]))
        return [
            (e["name"], e["cat"], e["pid"], e["tid"], e["args"]["path"])
            for e in events["traceEvents"]
        ]

    assert trace_structure(first) == trace_structure(second)

    def flame_structure(rec):
        lines = profile.render_collapsed(rec["pmap"]).strip().splitlines()
        return [line.rsplit(" ", 1)[0] for line in lines]

    assert flame_structure(first) == flame_structure(second)


# ---- the canonical exports against JAX's --------------------------------------------


@pytest.mark.parametrize("run", PROFILE_RUNS)
def test_the_canonical_export_is_jax_s_path_by_path(records, run):
    port, ref = records[run]
    assert port["export"]["stages"] == ref["export"]["stages"]
    assert sorted(port["export"]["paths"]) == sorted(ref["export"]["paths"])
    for path, rec in ref["export"]["paths"].items():
        assert port["export"]["paths"][path] == rec, path
    assert port["canonical"] == ref["canonical"]
    assert hashlib.sha256(port["canonical"].encode()).hexdigest() == JAX_SHA256[run]
    assert port["open_spans"] == []
    assert port["run"] == run


def test_the_chip_phase_holds_jax_s_digests(records):
    """``chip_smoke.py``'s coverage phase holds the card's crunch and smoke
    scale canonical exports to these: JAX's, recomputed here."""
    for key, run in (("crunch_profile", "crunch"), ("scale_profile", "scale")):
        digest = hashlib.sha256(records[run][1]["canonical"].encode()).hexdigest()
        assert chip_smoke.COVERAGE_EXPECTED[key] == digest == JAX_SHA256[run]


def test_the_scale_run_meets_the_attribution_floor(scale):
    assert scale["attribution_ok"]
    assert scale["attribution"] >= perfgates.PROFILE_MIN_ATTRIBUTION
    assert scale["open_spans"] == []


#: the profile plane's gates and shapes in perfgates (the JAX module's
#: other ``PROFILE_SMOKE_*`` names size a tool the port does not have)
PROFILE_GATES = (
    "PROFILE_MIN_ATTRIBUTION",
    "PROFILE_DIFF_SHARE_TOLERANCE",
    "PROFILE_DIFF_MIN_SELF_S",
    "PROFILE_CANARY_STAGE",
    "PROFILE_CANARY_PLANT_S",
    "PROFILE_SCALE_TARGETS",
    "PROFILE_SCALE_HORIZON_S",
    "PROFILE_SCALE_SMOKE_TARGETS",
    "PROFILE_SCALE_SMOKE_HORIZON_S",
    "PROFILE_COVERAGE_TARGETS",
    "PROFILE_COVERAGE_HORIZON_S",
)


def test_the_profile_gates_are_jax_s():
    for name in PROFILE_GATES:
        assert getattr(perfgates, name) == getattr(jax_perfgates, name), name


# ---- the diff gate and the planted canary ---------------------------------------------


def test_diff_clean_run_passes_and_planted_canary_trips(scale):
    second = run_profile("scale", smoke=True)[0]
    ok = profile.diff_exports(scale["timed"], second["timed"])
    assert not ok["regression"]
    assert ok["lost"] == [] and ok["share_regressions"] == []

    planted = run_profile(
        "scale",
        smoke=True,
        plant={perfgates.PROFILE_CANARY_STAGE: perfgates.PROFILE_CANARY_PLANT_S},
    )[0]
    # the plant changes the accounting, never the structure
    assert planted["canonical"] == scale["canonical"]
    diff = profile.diff_exports(scale["timed"], planted["timed"])
    assert diff["regression"]
    assert any(
        r["stage"] == perfgates.PROFILE_CANARY_STAGE for r in diff["share_regressions"]
    )
    assert "PROFILE REGRESSION" in profile.render_profile_diff(diff)


def test_diff_detects_lost_paths(scale):
    empty = profile.ProfileMap("empty").timed_export(1.0)
    diff = profile.diff_exports(scale["timed"], empty)
    assert diff["regression"]
    assert diff["lost"] == sorted(scale["timed"]["paths"])


def test_run_profile_rejects_unknown_run():
    assert PROFILE_RUNS == ("storm", "crunch", "scale") == jax_harness.PROFILE_RUNS
    with pytest.raises(ValueError, match="unknown profile run"):
        run_profile("warp")


# ---- attribution and the metric families ----------------------------------------------


def test_attribution_and_floor_probe(scale):
    timed = scale["timed"]
    assert timed["attribution"] == pytest.approx(
        timed["attributed_s"] / timed["wall_s"], abs=1e-3
    )
    assert profile.check_attribution(timed, floor=0.0)
    with coverage.collect("t") as cmap:
        assert not profile.check_attribution(
            profile.ProfileMap("empty").timed_export(1.0),
            perfgates.PROFILE_MIN_ATTRIBUTION,
        )
    assert cmap.export()["probes"]["profile:unattributed_overflow"]["count"] == 1


def test_profile_families_names_and_labels(scale):
    families = profile.profile_families(scale["timed"])
    assert [f.name for f in families] == list(profile.PROFILE_METRIC_NAMES)
    assert profile.PROFILE_METRIC_NAMES == jax_profile.PROFILE_METRIC_NAMES
    seconds, calls, ratio = families
    stages = {dict(s.labels)["stage"] for s in seconds.samples}
    assert "tsdb:append" in stages and "harness:observe" in stages
    assert {dict(s.labels)["stage"] for s in calls.samples} == stages
    (ratio_sample,) = ratio.samples
    assert dict(ratio_sample.labels)["run"] == "scale"
    assert ratio_sample.value == scale["attribution"]
    text = profile.profile_exposition(scale["timed"])
    for name in profile.PROFILE_METRIC_NAMES:
        assert name in text
    # the same timed export renders as JAX's renders it
    assert text == jax_profile.profile_exposition(scale["timed"])


# ---- the coverage session and the CLI's exit codes -------------------------------------


def test_coverage_session_fires_every_profile_probe():
    with coverage.collect("t") as cmap:
        run_profile_coverage_session()
    probes = cmap.export()["probes"]
    for probe_id in coverage.probes_in_domain("profile"):
        assert probes[probe_id]["count"] >= 1, probe_id


def _cli(tmp_path, **overrides):
    ns = argparse.Namespace(
        scenario="profile",
        run="scale",
        seed=None,
        smoke=True,
        plant=None,
        diff=None,
        json_out=None,
        trace_out=None,
        flame_out=None,
    )
    for key, value in overrides.items():
        setattr(ns, key, value)
    from k8s_gpu_hpa_tpu_torch.simulate import main

    return main(ns)


def test_cli_exit_code_matrix(tmp_path, capsys):
    baseline = tmp_path / "baseline.json"
    trace = tmp_path / "run.trace.json"
    flame = tmp_path / "run.flame.txt"
    # a clean run writing every export form: exit 0
    assert _cli(tmp_path, json_out=str(baseline), trace_out=str(trace),
                flame_out=str(flame)) == 0
    assert json.loads(trace.read_text())["traceEvents"]
    assert flame.read_text().strip()
    # run, then diff against its own baseline: exit 0
    assert _cli(tmp_path, diff=[str(baseline)]) == 0
    # the planted slowdown against the clean baseline: exit 2
    plant = f"{perfgates.PROFILE_CANARY_STAGE}={perfgates.PROFILE_CANARY_PLANT_S}"
    assert _cli(tmp_path, plant=plant, diff=[str(baseline)]) == 2
    # an offline self-diff: exit 0
    assert _cli(tmp_path, diff=[str(baseline), str(baseline)]) == 0
    capsys.readouterr()
    # usable errors, all exit 2
    assert _cli(tmp_path, run="warp") == 2
    assert "pick one of" in capsys.readouterr().out
    assert _cli(tmp_path, plant="tsdb:append") == 2  # no =SECONDS
    assert _cli(tmp_path, plant="warp:core=1.0") == 2  # an unknown stage
    assert _cli(tmp_path, diff=[str(baseline)] * 3) == 2
    assert _cli(tmp_path, run="all", diff=[str(baseline)]) == 2
    assert _cli(tmp_path, diff=[str(tmp_path / "missing.json")] * 2) == 2


# ---- the profile_bench rung --------------------------------------------------------------


def test_the_profile_bench_rung_is_bench_py_s(monkeypatch):
    port = trial.profile_bench_rung()
    monkeypatch.setattr(bench, "TIME_SCALE", BENCH_SMOKE_TIME_SCALE)
    ref = bench.run_rung_profile_bench()
    assert list(port) == list(ref)
    assert {k: v for k, v in port.items() if k not in WALL} == {
        k: v for k, v in ref.items() if k not in WALL
    }
    assert port["bit_identical"] and port["canary_caught"]
    assert not port["clean_diff_regression"] and port["open_spans"] == []
    assert port["scale_targets"] == perfgates.PROFILE_SCALE_SMOKE_TARGETS
    assert {sid: agg["calls"] for sid, agg in port["stages"].items()} == {
        sid: agg["calls"] for sid, agg in ref["stages"].items()
    }
    assert port["attribution"] >= port["attribution_floor"]
    assert port["ok"] and ref["ok"]
