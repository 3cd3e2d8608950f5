"""The coverage plane (``obs/coverage.py``), its probes in the ported planes
and the ``coverage`` scenario against the JAX package's.

- The registry is JAX's: the same 98 probes with the same ids, domains,
  descriptions and declaration order, and the fault-kind probes mirror the
  port's ``FAULT_KINDS``.
- The map's semantics (test_coverage.py's cases): an unregistered probe is
  refused, the first hit keeps its time and the count accumulates, ``hit``
  without a map does nothing, the scorecard and the families.
- ``run_coverage`` of each ported run (storm, crunch, drill, slo, profile,
  evacuate) and of the storm at seed 11, each run once a module in each
  package: the port's export equals JAX's probe by probe (count, first-hit
  time, first-hit span), and as ``export_json()`` bytes.  Same-seed runs
  are bit-identical; a storm seed changes the hit set.
- The CLI through the port's umbrella: ``--diff`` (0 on a gain, 2 on a
  loss), an unreadable export, an unknown run, ``--json`` and ``--floor``
  (test_coverage.py's four cases); the races run and the default union
  are held in tests/test_torch_races.py and tests/test_torch_coverage_union.py.
- ``chip_smoke.py``'s coverage phase holds the card's exports to JAX's
  digests, recomputed here from the JAX package.
- test_evacuate.py's three registry cases: ``evacuate`` is a coverage run,
  the region domain has a floor, and its probes are the declared nine.

Tolerance: exact (virtual time throughout).
"""

import hashlib
import json

import pytest
import torch

import chip_smoke
from k8s_gpu_hpa_tpu import perfgates as jax_perfgates
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.obs import coverage as jax_coverage
from k8s_gpu_hpa_tpu_torch import perfgates, simulate
from k8s_gpu_hpa_tpu_torch.__main__ import main as umbrella_main
from k8s_gpu_hpa_tpu_torch.chaos.faults import FAULT_KINDS
from k8s_gpu_hpa_tpu_torch.obs import coverage
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: (run, seed) of every export held against JAX's
RUNS = [
    ("storm", None),
    ("crunch", None),
    ("drill", None),
    ("slo", None),
    ("profile", None),
    ("evacuate", None),
    ("storm", 11),
]

#: SHA-256 of JAX's ``export_json()`` for the unseeded runs, recorded on
#: the CPU from the JAX package (deterministic under any PYTHONHASHSEED)
JAX_SHA256 = {
    "storm": "f4bd74ba9f916fee09811716d285266139d75d59e63472379a4e183582fe195f",
    "crunch": "d2204e144e2067d91de1f3e47a036e0019179009f274d917b88643f8f3da9065",
    "drill": "34b01f650c92881d620e0cb00e8a46a4d1e393c12b946b43763fb438c00af6e1",
    "slo": "d553e8d356d25ec957837da8366f3c2a848c5c7841949c547fb154d78c43da54",
    "profile": "92675d984010bbf244e65590aacdcc95505cfcc4708a8786e24b1c4a9a644a6f",
    "evacuate": "99eb77a52512912fd979f7f29541bc3b96cee0d827f5f4abc18df4677c67bc55",
}


def _key(run: str, seed: int | None) -> str:
    return run if seed is None else f"{run}@{seed}"


def _dump(export: dict) -> str:
    return json.dumps(export, sort_keys=True, separators=(",", ":"))


@pytest.fixture(scope="module")
def exports():
    """Each run of each package once: {key: (port export, JAX export)}."""
    return {
        _key(run, seed): (
            simulate.run_coverage(run=run, seed=seed),
            jax_simulate.run_coverage(run=run, seed=seed),
        )
        for run, seed in RUNS
    }


# ---- the registry -------------------------------------------------------------


def test_the_registry_is_jax_s_in_jax_s_order():
    assert coverage.DOMAINS == jax_coverage.DOMAINS
    assert coverage.EXPORT_VERSION == jax_coverage.EXPORT_VERSION
    assert len(coverage.PROBES) == len(jax_coverage.PROBES) == 98
    assert list(coverage.PROBES) == list(jax_coverage.PROBES)
    for pid, probe in coverage.PROBES.items():
        ref = jax_coverage.PROBES[pid]
        assert (probe.domain, probe.probe_id, probe.description) == (
            ref.domain, ref.probe_id, ref.description
        ), pid
    assert coverage.FAULT_PROBE_KINDS == jax_coverage.FAULT_PROBE_KINDS


def test_registry_ids_are_domain_scoped_and_unique():
    assert coverage.probe_ids() == sorted(set(coverage.probe_ids()))
    for pid, probe in coverage.PROBES.items():
        domain, _, name = pid.partition(":")
        assert domain == probe.domain and domain in coverage.DOMAINS
        assert name and probe.description
    for domain in coverage.DOMAINS:
        assert coverage.probes_in_domain(domain), f"empty domain {domain}"
    with pytest.raises(ValueError, match="duplicate"):
        coverage.probe("hpa_condition", "sync_scale_up", "again")
    with pytest.raises(ValueError, match="unknown probe domain"):
        coverage.probe("warp_drive", "engage", "no such domain")


def test_fault_kind_probes_mirror_the_injector_registry():
    assert set(coverage.FAULT_PROBE_KINDS) == set(FAULT_KINDS)
    assert len(FAULT_KINDS) == 18


# ---- map semantics ------------------------------------------------------------


def test_record_rejects_unregistered_probe():
    cmap = coverage.CoverageMap("t")
    with pytest.raises(KeyError):
        cmap.record("hpa_condition:not_a_probe")


def test_first_hit_keeps_timestamp_and_count_accumulates():
    clock = VirtualClock()
    cmap = coverage.CoverageMap("t")
    cmap.bind(clock)
    clock.advance(5.0)
    cmap.record("hpa_condition:sync_scale_up")
    clock.advance(5.0)
    cmap.record("hpa_condition:sync_scale_up")
    rec = cmap.export()["probes"]["hpa_condition:sync_scale_up"]
    assert rec["count"] == 2
    assert rec["first_hit_ts"] == 5.0  # the first hit wins; later hits only count
    assert rec["first_hit_span"] is None  # no tracer bound


def test_hit_is_a_noop_without_an_active_map():
    assert coverage.active() is None
    coverage.hit("hpa_condition:sync_scale_up")
    coverage.hit_dynamic("fault_kind", "exporter_outage")
    assert coverage.active() is None


def test_scorecard_lists_every_domain_and_the_gap_list():
    with coverage.collect("t") as cmap:
        coverage.hit("hpa_condition:sync_scale_up")
    card = coverage.render_scorecard(cmap.export())
    for domain in coverage.DOMAINS:
        assert domain in card
    assert "never-hit probes" in card
    assert "hpa_condition:sync_scale_down" in card  # in the gap list
    with jax_coverage.collect("t") as ref:
        jax_coverage.hit("hpa_condition:sync_scale_up")
    assert card == jax_coverage.render_scorecard(ref.export())


def test_coverage_families_expose_per_domain_samples():
    with coverage.collect("t") as cmap:
        coverage.hit("planner_path:plan_built")
    families = coverage.coverage_families(cmap.export())
    assert [f.name for f in families] == list(coverage.COVERAGE_METRIC_NAMES)
    text = coverage.coverage_exposition(cmap.export())
    for name in coverage.COVERAGE_METRIC_NAMES:
        assert name in text
    assert 'domain="planner_path"' in text
    with jax_coverage.collect("t") as ref:
        jax_coverage.hit("planner_path:plan_built")
    assert text == jax_coverage.coverage_exposition(ref.export())


def test_the_export_readers_and_the_diff_are_jax_s(exports):
    port, ref = exports["storm"]
    _, crunch = exports["crunch"]
    assert coverage.export_union_ratio(port) == jax_coverage.export_union_ratio(ref)
    assert coverage.export_never_hit(port) == jax_coverage.export_never_hit(ref)
    assert coverage.diff_exports(port, crunch) == jax_coverage.diff_exports(ref, crunch)


# ---- the runs against JAX's -----------------------------------------------------


@pytest.mark.parametrize("run,seed", RUNS, ids=[_key(r, s) for r, s in RUNS])
def test_the_run_s_export_is_jax_s_probe_by_probe(exports, run, seed):
    port, ref = exports[_key(run, seed)]
    assert port["run"] == ref["run"] == _key(run, seed)
    assert port["domains"] == ref["domains"]
    assert list(port["probes"]) == list(ref["probes"])
    for pid, rec in ref["probes"].items():
        assert port["probes"][pid] == rec, pid
    assert _dump(port) == _dump(ref)
    if seed is None:
        assert hashlib.sha256(_dump(port).encode()).hexdigest() == JAX_SHA256[run]


def test_the_chip_phase_holds_jax_s_digests(exports):
    """``chip_smoke.py``'s coverage phase holds the card's crunch and
    profile-session exports to these: JAX's, recomputed here."""
    for key, run in (("crunch_coverage", "crunch"), ("profile_coverage", "profile")):
        digest = hashlib.sha256(_dump(exports[run][1]).encode()).hexdigest()
        assert chip_smoke.COVERAGE_EXPECTED[key] == digest == JAX_SHA256[run]


def test_no_ported_run_hits_a_probe_of_a_plane_not_ported(exports):
    for port, _ in exports.values():
        for pid, rec in port["probes"].items():
            if pid.split(":")[0] in ("concurrency", "fuzz", "alerting"):
                assert rec["count"] == 0, pid


def test_same_seed_runs_export_bit_identical_maps(exports):
    again = simulate.run_coverage(run="storm", seed=11)
    assert _dump(again) == _dump(exports["storm@11"][0])


def test_different_storm_seeds_change_the_hit_set(exports):
    """The map carries signal: the seeded schedule arms one fault kind the
    fixed timeline never does, so the seeded storm's hit set differs."""
    hit = lambda e: {p for p, r in e["probes"].items() if r["count"]}  # noqa: E731
    assert hit(exports["storm@11"][0]) != hit(exports["storm"][0])


# ---- the CLI --------------------------------------------------------------------


def _export_with(hits: list[str], run: str = "golden") -> dict:
    cmap = coverage.CoverageMap(run)
    for pid in hits:
        cmap.record(pid)
    return cmap.export()


def test_cli_diff_golden_sections_and_exit_codes(tmp_path, capsys):
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(_export_with(["hpa_condition:sync_scale_up"])))
    b.write_text(json.dumps(
        _export_with(["hpa_condition:sync_scale_up", "planner_path:plan_built"])
    ))
    # the candidate is a strict superset: exit 0, the gain under "gained"
    rc = umbrella_main(["simulate", "--scenario", "coverage", "--diff", str(a), str(b)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "gained (1):" in out and "planner_path:plan_built" in out
    assert "lost (0):" in out
    assert "unchanged" in out
    assert "verdict: OK" in out
    # reversed: the candidate lost a probe, a regression, exit 2
    rc = umbrella_main(["simulate", "--scenario", "coverage", "--diff", str(b), str(a)])
    out = capsys.readouterr().out
    assert rc == 2
    assert "lost (1):" in out and "COVERAGE REGRESSION" in out
    # one path is not a diff
    assert umbrella_main(["simulate", "--scenario", "coverage", "--diff", str(a)]) == 2
    assert "BASELINE CANDIDATE" in capsys.readouterr().out


def test_cli_diff_unreadable_export_is_a_diagnosis(tmp_path, capsys):
    missing = tmp_path / "nope.json"
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(_export_with([])))
    garbled = tmp_path / "garbled.json"
    garbled.write_text("{not json")
    for pair in ((missing, ok), (ok, garbled)):
        rc = umbrella_main(["simulate", "--scenario", "coverage", "--diff", *map(str, pair)])
        assert rc == 2
        assert "simulate coverage --diff" in capsys.readouterr().out


def test_cli_unknown_run_name_exits_nonzero_with_usable_message(capsys):
    rc = umbrella_main(["simulate", "--scenario", "coverage", "--run", "tempest"])
    out = capsys.readouterr().out
    assert rc == 2
    assert "tempest" in out
    for name in ("storm", "crunch", "drill", "slo", "all"):
        assert name in out


def test_cli_single_run_writes_canonical_json_and_scores(exports, tmp_path, capsys):
    out_path = tmp_path / "slo.json"
    rc = umbrella_main(
        ["simulate", "--scenario", "coverage", "--run", "slo", "--json", str(out_path)]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "coverage scorecard" in out
    export = json.loads(out_path.read_text())
    assert export["run"] == "slo"
    assert set(export["domains"]) == set(coverage.DOMAINS)
    # the canonical form: sorted keys, no whitespace, JAX's bytes
    assert out_path.read_text() == _dump(export) + "\n"
    assert _dump(export) == _dump(exports["slo"][1])
    # one run stays under the union floor: an impossible floor fails it
    rc = umbrella_main(
        ["simulate", "--scenario", "coverage", "--run", "profile", "--floor", "0.99"]
    )
    assert rc == 2
    assert "COVERAGE FLOOR VIOLATED" in capsys.readouterr().out
    rc = umbrella_main(
        ["simulate", "--scenario", "coverage", "--run", "profile", "--floor", "0.1"]
    )
    assert rc == 0
    assert "meets declared floor" in capsys.readouterr().out


def test_the_run_names_and_floors_are_jax_s():
    assert simulate.COVERAGE_RUN_NAMES == jax_simulate.COVERAGE_RUN_NAMES
    assert perfgates.COVERAGE_UNION_FLOOR == jax_perfgates.COVERAGE_UNION_FLOOR
    assert perfgates.COVERAGE_DOMAIN_FLOORS == jax_perfgates.COVERAGE_DOMAIN_FLOORS
    assert perfgates.COVERAGE_MIN_NEVER_HIT == jax_perfgates.COVERAGE_MIN_NEVER_HIT


# ---- the region domain (test_evacuate.py's registry cases) ----------------------


def test_evacuate_is_a_registered_coverage_run():
    assert "evacuate" in simulate.COVERAGE_RUN_NAMES


def test_region_domain_is_registered_with_a_floor():
    assert "region" in coverage.DOMAINS
    assert "region" in perfgates.COVERAGE_DOMAIN_FLOORS
    assert perfgates.COVERAGE_DOMAIN_FLOORS["region"] > 0.0


def test_region_probe_set_is_exactly_the_declared_nine():
    assert set(coverage.probes_in_domain("region")) == {
        "region:evacuation_started",
        "region:evacuation_completed",
        "region:spill_admitted",
        "region:spill_denied",
        "region:objstore_hit",
        "region:objstore_miss",
        "region:objstore_outage",
        "region:global_merge_sealed",
        "region:global_merge_fallback",
    }
