"""The coverage-guided chaos fuzzer (``chaos/fuzz.py``), its harness
(``control/fuzz_harness.py``) and the ``fuzz`` scenario against the JAX
package's.

- tests/test_fuzz.py's cases that need no canary campaign, against the
  port: the mutation pool is the registry, the ``fuzz`` coverage run and
  probes are registered, the spec dict round trip, the violation
  signature, the mutation bounds, the minimizer golden and its run budget,
  the clean case, same-seed campaigns, each committed fuzz artifact
  replaying green, and the CLI's replay and campaign exit codes (the
  campaign stubbed, five report shapes).
- Against the JAX package: ``MUTATION_FAULT_KINDS`` is JAX's tuple, in
  JAX's order; ``_random_spec`` and ``mutate_case`` draw JAX's cases from
  the same ``random.Random`` over 60 seeds, the rng left in JAX's state;
  ``minimize_schedule`` gives JAX's list and run count; the clean case's
  fingerprint and ``run_fuzz(budget=4, seed=3)`` (each package's campaign
  run once a module, the port's twice) are JAX's; the replay's result and
  report are JAX's.
- ``run_coverage("fuzz")``'s export as canonical JSON hashes to the JAX
  package's and lights all four ``fuzz:*`` probes above the domain's
  floor.  JAX's side takes 50-60 s on a CPU, so it is held to JAX's
  digest, written here from the JAX package at commit 828a707 (its fuzz
  plane unchanged since 24dba52).

The canary campaign is tests/test_torch_fuzz_canary.py's.

Tolerance: exact (virtual time, one seeded rng).
"""

import copy
import hashlib
import json
import random
from pathlib import Path

import pytest
import torch

from k8s_gpu_hpa_tpu.chaos import fuzz as jax_fuzz
from k8s_gpu_hpa_tpu.control import fuzz_harness as jax_harness
from k8s_gpu_hpa_tpu_torch import perfgates, simulate
from k8s_gpu_hpa_tpu_torch.__main__ import main as umbrella_main
from k8s_gpu_hpa_tpu_torch.chaos import fuzz
from k8s_gpu_hpa_tpu_torch.chaos.faults import FAULT_KINDS
from k8s_gpu_hpa_tpu_torch.control import fuzz_harness
from k8s_gpu_hpa_tpu_torch.control.fuzz_harness import (
    DEFAULT_TRAFFIC,
    FUZZ_MAX_AT_S,
    FUZZ_MAX_DURATION_S,
    FUZZ_MAX_FAULTS,
    FUZZ_TRAFFIC_MAX,
    FUZZ_TRAFFIC_MIN,
    run_fuzz_case,
)
from k8s_gpu_hpa_tpu_torch.obs import coverage
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

SCENARIOS_DIR = Path(__file__).resolve().parent / "scenarios"

#: SHA-256 of the JAX package's run_fuzz_case([]) fingerprint string and of
#: its run_fuzz(budget=4, seed=3) as canonical JSON, on a CPU (recomputed
#: from the JAX side of the fixtures below)
JAX_CLEAN_FINGERPRINT_SHA256 = "fbea142130f9740da4d0ae5078503a9be14aecc15da999bcd695ee64e9d1515d"
JAX_CAMPAIGN_SHA256 = "dcfb604a0db2c5d878dfa140b5d2c21d31b48db9337866bc64b0e942fc985b28"
#: SHA-256 of the canonical JSON of the JAX package's run_coverage("fuzz")
#: export, on a CPU
JAX_FUZZ_COVERAGE_SHA256 = "643b72dbb470b9492db3fde4eafbab7f2662a6f075dad24980d3c4f3240b8f67"


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _fuzz_scenarios() -> list[Path]:
    """The committed fuzz corpus: the evac-*.json artifacts are region
    evacuations, with a replay of their own (tests/test_torch_evacuate.py)
    and another schema."""
    return sorted(p for p in SCENARIOS_DIR.glob("*.json") if not p.name.startswith("evac-"))


# ---- the registry ---------------------------------------------------------------


def test_mutation_pool_covers_the_whole_registry():
    assert set(fuzz.MUTATION_FAULT_KINDS) == set(FAULT_KINDS)


def test_the_mutation_pool_and_its_tables_are_jax_s():
    """The order is part of the rng stream: ``rng.choice`` indexes it."""
    assert fuzz.MUTATION_FAULT_KINDS == jax_fuzz.MUTATION_FAULT_KINDS
    assert len(fuzz.MUTATION_FAULT_KINDS) == 18
    assert fuzz._IMPULSE_KINDS == jax_fuzz._IMPULSE_KINDS
    assert fuzz._TARGET_POOLS == jax_fuzz._TARGET_POOLS
    assert fuzz._VIOLATION_CATEGORIES == jax_fuzz._VIOLATION_CATEGORIES
    assert fuzz.CANARY_CORE == jax_fuzz.CANARY_CORE
    assert fuzz.ARTIFACT_VERSION == jax_fuzz.ARTIFACT_VERSION
    for name in ("FUZZ_TENANTS", "FUZZ_NODES", "FUZZ_MAX_FAULTS", "FUZZ_MAX_AT_S",
                 "FUZZ_MAX_DURATION_S", "FUZZ_SETTLE_S", "FUZZ_TAIL_S", "FUZZ_MIN_TOTAL_S",
                 "FUZZ_MAX_TOTAL_S", "FUZZ_TRAFFIC_MIN", "FUZZ_TRAFFIC_MAX", "DEFAULT_TRAFFIC",
                 "_FINGERPRINT_KEYS"):
        assert getattr(fuzz_harness, name) == getattr(jax_harness, name), name


def test_fuzz_is_a_registered_coverage_run():
    from k8s_gpu_hpa_tpu_torch.simulate import COVERAGE_RUN_NAMES

    assert "fuzz" in COVERAGE_RUN_NAMES
    assert "fuzz" in coverage.DOMAINS
    assert "fuzz" in perfgates.COVERAGE_DOMAIN_FLOORS
    assert {p for p in coverage.probe_ids() if p.startswith("fuzz:")} == {
        "fuzz:mutation_accepted",
        "fuzz:mutation_rejected",
        "fuzz:minimizer_step",
        "fuzz:corpus_replay",
    }


# ---- the pure helpers -------------------------------------------------------------


def test_spec_dict_round_trip():
    d = {
        "kind": "tenant_spike",
        "at": 30.0,
        "duration": 60.0,
        "target": "tpu-batch",
        "params": {"add": 80.0},
    }
    assert fuzz.spec_to_dict(fuzz.spec_from_dict(d)) == d


def test_violation_signature_classifies_known_clauses():
    violations = [
        "tpu-batch: did not converge (0/1 running, 0 pending, 1 terminating)",
        "not every fault recovered",
        "tpu-prod: starved 400s past its 300s budget",
        "something the classifier has never seen",
    ]
    sig = fuzz.violation_signature(violations)
    assert sig == ("convergence", "other", "recovery", "starvation")
    assert sig == jax_fuzz.violation_signature(violations)


def test_mutations_respect_schedule_bounds():
    """200 mutation steps from one rng: every case stays inside the bounds
    of a schedule's shape that the replayer keeps."""
    rng = random.Random(5)
    case = {"faults": [], "traffic": dict(DEFAULT_TRAFFIC)}
    for _ in range(200):
        case = fuzz.mutate_case(case, rng, [])
        assert len(case["faults"]) <= FUZZ_MAX_FAULTS
        for f in case["faults"]:
            assert f["kind"] in FAULT_KINDS
            assert 0.0 <= f["at"] <= FUZZ_MAX_AT_S
            assert 0.0 <= f["duration"] <= FUZZ_MAX_DURATION_S
        assert set(case["traffic"]) == set(DEFAULT_TRAFFIC)
        for load in case["traffic"].values():
            assert FUZZ_TRAFFIC_MIN <= load <= FUZZ_TRAFFIC_MAX


@pytest.mark.parametrize("prefer", ["none", "dark"])
def test_random_specs_and_mutations_are_jax_s_over_60_seeds(prefer):
    """The same rng draws, in the same order: each seed's specs and chain of
    mutations equal JAX's, and both rngs end in the same state."""
    kinds = [] if prefer == "none" else ["node_drain", "wal_truncate", "tenant_spike",
                                          "region_kill", "crashloop"]
    for seed in range(60):
        rng, ref = random.Random(seed), random.Random(seed)
        specs = [fuzz._random_spec(rng, kinds) for _ in range(5)]
        assert specs == [jax_fuzz._random_spec(ref, kinds) for _ in range(5)]
        case = {"faults": specs[:seed % 4], "traffic": dict(DEFAULT_TRAFFIC)}
        jcase = copy.deepcopy(case)
        for _ in range(12):
            case = fuzz.mutate_case(case, rng, kinds)
            jcase = jax_fuzz.mutate_case(jcase, ref, kinds)
            assert case == jcase, seed
        assert rng.getstate() == ref.getstate()


# ---- the minimizer golden (no simulation: a synthetic predicate) ------------------

#: 8 faults, of which exactly two form the failing core: the
#: scrape_blackout (100..160) overlapping the tenant_spike (120..160)
_GOLDEN_SCHEDULE = [
    {"kind": "exporter_outage", "at": 10.0, "duration": 30.0, "target": None, "params": {}},
    {"kind": "node_drain", "at": 40.0, "duration": 50.0, "target": "fuzz-node-1", "params": {}},
    {"kind": "scrape_blackout", "at": 100.0, "duration": 60.0, "target": None, "params": {}},
    {"kind": "pod_crash", "at": 110.0, "duration": 0.0, "target": None, "params": {}},
    {"kind": "tenant_spike", "at": 120.0, "duration": 40.0, "target": "tpu-batch",
     "params": {"add": 80.0}},
    {"kind": "slow_scrape", "at": 200.0, "duration": 45.0, "target": None, "params": {}},
    {"kind": "hpa_restart", "at": 260.0, "duration": 0.0, "target": None, "params": {}},
    {"kind": "wal_truncate", "at": 300.0, "duration": 0.0, "target": None,
     "params": {"records": 4}},
]


def _blackout_overlaps_spike(faults: list[dict]) -> bool:
    def overlap(a: dict, b: dict) -> bool:
        return a["at"] < b["at"] + b["duration"] and b["at"] < a["at"] + a["duration"]

    return any(
        overlap(a, b)
        for a in faults
        if a["kind"] == "scrape_blackout"
        for b in faults
        if b["kind"] == "tenant_spike"
    )


def test_minimizer_golden_8_fault_schedule_to_2_fault_core():
    """ddmin drops the six decoys, the shrink phase halves the core's
    durations to the smallest windows that still overlap, the shift phase
    moves nothing; the same output twice, and JAX's list and run count."""
    first, runs_1 = fuzz.minimize_schedule(copy.deepcopy(_GOLDEN_SCHEDULE),
                                           _blackout_overlaps_spike)
    second, runs_2 = fuzz.minimize_schedule(copy.deepcopy(_GOLDEN_SCHEDULE),
                                            _blackout_overlaps_spike)
    assert first == [
        {"kind": "scrape_blackout", "at": 100.0, "duration": 30.0, "target": None,
         "params": {}},
        {"kind": "tenant_spike", "at": 120.0, "duration": 5.0, "target": "tpu-batch",
         "params": {"add": 80.0}},
    ]
    assert second == first and runs_2 == runs_1
    assert (first, runs_1) == jax_fuzz.minimize_schedule(copy.deepcopy(_GOLDEN_SCHEDULE),
                                                         _blackout_overlaps_spike)


def test_minimizer_respects_the_run_budget():
    calls = []

    def never_shrinks(faults: list[dict]) -> bool:
        calls.append(1)
        return False  # only the whole schedule fails

    minimized, runs = fuzz.minimize_schedule(copy.deepcopy(_GOLDEN_SCHEDULE), never_shrinks,
                                             max_runs=7)
    assert minimized == _GOLDEN_SCHEDULE
    assert runs == len(calls) == 7


def test_the_minimizer_counts_a_probe_a_run():
    with coverage.collect("minimizer") as cmap:
        _, runs = fuzz.minimize_schedule(copy.deepcopy(_GOLDEN_SCHEDULE),
                                         _blackout_overlaps_spike)
    assert cmap.counts["fuzz:minimizer_step"] == runs


# ---- the case runner ----------------------------------------------------------------


@pytest.fixture(scope="module")
def clean():
    """The fault-free case: the port's twice, JAX's once."""
    return run_fuzz_case([]), run_fuzz_case([]), jax_harness.run_fuzz_case([])


def test_clean_case_passes_contract_and_fingerprints_identically(clean):
    """A case without faults passes the contract clean (so every violation
    the fuzzer finds is the schedule's), and two runs fingerprint alike."""
    first, second, _ = clean
    assert first["violations"] == []
    assert first["ok"] is True
    assert first["fingerprint"] == second["fingerprint"]


def test_the_clean_case_is_jax_s(clean):
    port, _, ref = clean
    assert _canon(port) == _canon(ref)
    assert hashlib.sha256(port["fingerprint"].encode()).hexdigest() == (
        JAX_CLEAN_FINGERPRINT_SHA256)


def test_traffic_naming_an_unknown_tenant_is_refused():
    with pytest.raises(ValueError, match=r"traffic names unknown tenants: \['tpu-best'\]"):
        run_fuzz_case([], traffic={"tpu-best": 20.0})


# ---- the campaign ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def campaigns():
    """run_fuzz(budget=4, seed=3): the port's twice, JAX's once."""
    return fuzz.run_fuzz(budget=4, seed=3), fuzz.run_fuzz(budget=4, seed=3), \
        jax_fuzz.run_fuzz(budget=4, seed=3)


def test_same_seed_campaigns_are_bit_identical(campaigns):
    first, second, _ = campaigns
    assert _canon(first) == _canon(second)


def test_the_campaign_is_jax_s(campaigns):
    port, _, ref = campaigns
    assert _canon(port) == _canon(ref)
    assert hashlib.sha256(_canon(port).encode()).hexdigest() == JAX_CAMPAIGN_SHA256
    assert (port["accepted"], port["rejected"], port["coverage_probes_hit"]) == (3, 1, 29)
    assert fuzz.render_fuzz_report(port) == jax_fuzz.render_fuzz_report(ref)


# ---- the committed corpus ---------------------------------------------------------------


@pytest.fixture(scope="module")
def replays():
    return {p.stem: fuzz.replay_artifact(p) for p in _fuzz_scenarios()}


@pytest.mark.parametrize("scenario", _fuzz_scenarios(), ids=lambda p: p.stem)
def test_committed_scenario_replays_green(replays, scenario):
    """Every fuzz artifact reproduces its recorded fingerprint: a minimized
    failure is a regression test only while it still fails the same way."""
    replay = replays[scenario.stem]
    assert replay["fingerprint_match"] is True, replay
    assert replay["violations_match"] is True
    assert replay["ok"] is True


def test_the_canary_artifact_keeps_jax_s_injector_errors():
    """The committed canary's fingerprint holds the injector errors word for
    word, among them the tenant_spike whose workload_change span fails the
    span schema at span 845 in both packages (the fingerprint matching
    shows the port's tracer emitted the same spans before it)."""
    artifact = json.loads((SCENARIOS_DIR / "break-grace-canary.json").read_text())
    errors = json.loads(artifact["expect"]["fingerprint"])["inject_errors"]
    assert ("tenant_spike/tpu-prod@1s: span 845 (workload_change): missing required "
            "attrs ['intensity']") in errors


def test_the_replay_result_is_jax_s(replays):
    """The replay of the shorter artifact, through both packages, gives the
    same result dict."""
    path = SCENARIOS_DIR / "overlap-stress.json"
    assert replays["overlap-stress"] == jax_fuzz.replay_artifact(path)


def test_committed_corpus_is_not_empty():
    assert _fuzz_scenarios(), "the regression corpus is empty"


# ---- the CLI's exit codes ---------------------------------------------------------------


def test_cli_replay_green_scenario_exits_0(capsys):
    scenario = SCENARIOS_DIR / "overlap-stress.json"
    rc = umbrella_main(["simulate", "--scenario", "fuzz", "--replay", str(scenario)])
    assert rc == 0
    assert capsys.readouterr().out == (
        "scenario overlap-stress: reproduced bit-identically (0 recorded violation(s) "
        "fired again)\n")


def test_cli_replay_doctored_fingerprint_exits_2(tmp_path, capsys):
    """An artifact whose recorded fingerprint no longer matches what the
    simulator gives is a dead regression test, and fails loudly."""
    artifact = json.loads((SCENARIOS_DIR / "overlap-stress.json").read_text())
    artifact["expect"]["fingerprint"] = artifact["expect"]["fingerprint"][:-2] + '"'
    doctored = tmp_path / "doctored.json"
    doctored.write_text(json.dumps(artifact))
    rc = umbrella_main(["simulate", "--scenario", "fuzz", "--replay", str(doctored)])
    out = capsys.readouterr().out
    assert rc == 2
    assert "DID NOT REPRODUCE" in out


def test_cli_replay_missing_file_exits_2(tmp_path, capsys):
    rc = umbrella_main(["simulate", "--scenario", "fuzz", "--replay",
                        str(tmp_path / "nope.json")])
    assert rc == 2
    assert "simulate fuzz --replay" in capsys.readouterr().out


def _campaign_report(**overrides) -> dict:
    report = {
        "scenario": "fuzz",
        "mode": "virtual",
        "budget": 8,
        "seed": 7,
        "break_grace": False,
        "cases_run": 8,
        "accepted": 5,
        "rejected": 3,
        "novel_accepts": 4,
        "best_score": 12.0,
        "coverage_probes_hit": 30,
        "failure": None,
        "ok": True,
    }
    report.update(overrides)
    return report


def _failure_record(**overrides) -> dict:
    record = {
        "case_index": 2,
        "case": {"faults": _GOLDEN_SCHEDULE[:4], "traffic": dict(DEFAULT_TRAFFIC)},
        "violations": ["tpu-batch: did not converge (0/1 running, 0 pending, 1 terminating)"],
        "signature": ["convergence"],
        "score": 112.0,
        "reproducible": True,
        "minimized": {"faults": _GOLDEN_SCHEDULE[:1], "traffic": dict(DEFAULT_TRAFFIC)},
        "minimizer_runs": 12,
        "shrink_ratio": 0.25,
        "artifact": None,
        "artifact_path": None,
    }
    record.update(overrides)
    return record


@pytest.mark.parametrize(
    "report,expected_rc",
    [
        # a clean exploration: nothing found
        (_campaign_report(), 0),
        # a genuine minimized failure: new corpus material
        (_campaign_report(failure=_failure_record(), ok=True), 1),
        # the canary armed, found and minimized: the fuzzer working
        (_campaign_report(break_grace=True, failure=_failure_record(), ok=True), 0),
        # a failure that does not reproduce
        (_campaign_report(failure=_failure_record(reproducible=False, minimized=None,
                                                  shrink_ratio=None), ok=False), 2),
        # a failure that cannot be minimized
        (_campaign_report(failure=_failure_record(minimized=None, shrink_ratio=None),
                          ok=False), 2),
    ],
    ids=["clean", "genuine", "canary", "non-reproducing", "unminimizable"],
)
def test_cli_campaign_exit_codes(monkeypatch, capsys, report, expected_rc):
    """The exit codes through the umbrella with the campaign stubbed, and
    the report printed in JAX's words."""
    calls = []
    monkeypatch.setattr(fuzz, "run_fuzz", lambda **kw: calls.append(kw) or dict(report))
    rc = umbrella_main(["simulate", "--scenario", "fuzz", "--budget", "8"])
    out = capsys.readouterr().out
    assert rc == expected_rc
    assert out == jax_fuzz.render_fuzz_report(report) + "\n"
    assert calls == [{"budget": 8, "seed": perfgates.FUZZ_SMOKE_SEED, "break_grace": False,
                      "out_dir": None}]


# ---- the coverage session ---------------------------------------------------------------


@pytest.fixture(scope="module")
def fuzz_coverage():
    return simulate.run_coverage("fuzz")


def test_the_fuzz_coverage_session_is_jax_s(fuzz_coverage):
    assert hashlib.sha256(_canon(fuzz_coverage).encode()).hexdigest() == (
        JAX_FUZZ_COVERAGE_SHA256)


def test_fuzz_coverage_session_drives_all_fuzz_probes(fuzz_coverage):
    """``coverage --run fuzz`` lights all four fuzz:* probes (accept and
    reject from the pinned campaign, minimizer steps and a corpus replay
    from the canary's core) and clears the domain's floor."""
    probes = fuzz_coverage["probes"]
    for probe_id in ("fuzz:mutation_accepted", "fuzz:mutation_rejected",
                     "fuzz:minimizer_step", "fuzz:corpus_replay"):
        assert probes[probe_id]["count"] > 0, f"{probe_id} never fired"
    assert sum(1 for r in probes.values() if r["count"]) == 35
    hit = sum(1 for p, r in probes.items() if p.startswith("fuzz:") and r["count"])
    assert hit / len(coverage.probes_in_domain("fuzz")) >= perfgates.COVERAGE_DOMAIN_FLOORS["fuzz"]
