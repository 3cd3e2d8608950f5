"""The paging drills (``chaos/paging.py``), the ``incident`` scenario, the
``coverage --run incident`` session and the two rungs of this plane
against the JAX package's.

- Each drill of each package run once a module: the storm, the crunch, the
  smoke evacuation and both mis-inhibition canaries (the evacuation's and
  the storm's), and ``run_coverage("incident")``: the same result as
  canonical JSON, whose SHA-256 is the one the JAX package gives on a CPU,
  and the same report and ``--why`` text.
- The drills' parts: the state-probe rules, the router ``attach_pager``
  hangs on the pipeline (JAX's timing and inhibition), the paging contract
  on doctored results, a clause at a time, in JAX's words.
- ``simulate --scenario incident`` through the port's umbrella: exit 0 for
  ``--run storm``, ``--run crunch`` and ``--smoke``, 2 for
  ``--break-inhibition`` and an unknown run; ``--json`` writes JAX's bytes
  and ``--why INC-001`` prints JAX's timeline.
- ``trial.chaos_fuzz_rung()`` and ``trial.paging_bench_rung()`` with their
  runs stubbed, as tests/test_bench_rungs.py stubs bench.py's: bench.py's
  keys, values and gate logic.

Tolerance: exact (virtual time throughout).
"""

import copy
import hashlib
import json

import pytest
import torch

import bench
import chip_smoke
from k8s_gpu_hpa_tpu import perfgates as jax_perfgates
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.chaos import fuzz as jax_fuzz
from k8s_gpu_hpa_tpu.chaos import paging as jax_paging
from k8s_gpu_hpa_tpu.obs import incident as jax_incident
from k8s_gpu_hpa_tpu_torch import perfgates, simulate, trial
from k8s_gpu_hpa_tpu_torch.__main__ import main as umbrella_main
from k8s_gpu_hpa_tpu_torch.chaos import fuzz, paging
from k8s_gpu_hpa_tpu_torch.obs import incident
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: SHA-256 of each drill's canonical JSON as the JAX package gives it on a
#: CPU (recomputed from the JAX side of the fixture below)
JAX_SHA256 = {
    "storm": "dc2d902f60b189ca6c9a3877f1d5622bb7535dbc2e48bb2d06291a399c1964b9",
    "crunch": "d05049d997ce0f1d837a73b96b9def3294958ca2b2cecea019628d56825fabd5",
    "evacuate": "d91885152bf732cce2a2eb047beef5c7444a7379bbf8563b1e71c3462a8031e7",
    "evacuate_canary": "499c82b9639958a407584727744bc90e04522788c9892340cbecc2f2bb1db324",
    "storm_canary": "23e8e05006fae024314fdabb714f117b3273cb58a8058dbd81c6eab94bfa3745",
    "coverage_incident": "e64655f27fced2bd8eddc8ab928d41927f83bff3d4bb2a26f489ab6a364bc4a8",
}


def _drills(mod, sim):
    return {
        "storm": lambda: mod.run_paging_storm(),
        "crunch": lambda: mod.run_paging_crunch(),
        "evacuate": lambda: mod.run_paging_evacuation(smoke=True),
        "evacuate_canary": lambda: mod.run_paging_evacuation(smoke=True, break_inhibition=True),
        "storm_canary": lambda: mod.run_paging_storm(break_inhibition=True),
        "coverage_incident": lambda: sim.run_coverage("incident"),
    }


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _sha(obj) -> str:
    return hashlib.sha256(_canon(obj).encode()).hexdigest()


@pytest.fixture(scope="module")
def results():
    """Each drill of each package once: {name: (port, jax)}."""
    port, ref = _drills(paging, simulate), _drills(jax_paging, jax_simulate)
    return {name: (port[name](), ref[name]()) for name in port}


@pytest.mark.parametrize("name", list(JAX_SHA256))
def test_the_drill_is_jax_s_as_canonical_json(results, name):
    port, ref = results[name]
    assert _canon(port) == _canon(ref)
    assert _sha(ref) == JAX_SHA256[name]


@pytest.mark.parametrize("name", ["storm", "crunch", "evacuate", "evacuate_canary",
                                  "storm_canary"])
def test_the_report_and_the_why_are_jax_s(results, name):
    port, ref = results[name]
    assert incident.render_incident_report(port) == jax_incident.render_incident_report(ref)
    for inc in port["incidents"] + [{"id": "INC-999"}]:
        assert incident.render_incident_why(port, inc["id"]) == (
            jax_incident.render_incident_why(ref, inc["id"]))


def test_the_drills_keep_the_contract_and_the_canaries_break_it(results):
    for name in ("storm", "crunch", "evacuate"):
        port = results[name][0]
        assert port["ok"] is True and port["violations"] == [], name
        assert port["score"]["recall"] == 1.0
    assert [r["score"]["pages_total"] for r in
            (results[n][0] for n in ("storm", "crunch", "evacuate"))] == [8, 1, 3]
    for name in ("evacuate_canary", "storm_canary"):
        port = results[name][0]
        assert port["ok"] is False
        assert {v["kind"] for v in port["score"]["violations"]} == {"uninhibited_duplicate_page"}


def test_the_incident_session_hits_every_alerting_probe(results):
    export = results["coverage_incident"][0]
    alerting_probes = {p: r for p, r in export["probes"].items() if p.startswith("alerting:")}
    assert len(alerting_probes) == 16
    assert all(r["count"] > 0 for r in alerting_probes.values())
    assert sum(1 for r in export["probes"].values() if r["count"]) == 39


def test_the_chip_phase_holds_jax_s_digests(results):
    """``chip_smoke.py``'s incident phase holds the card's session export
    and evacuation canary to these: JAX's, recomputed here."""
    assert chip_smoke.INCIDENT_EXPECTED["coverage_incident"] == (
        _sha(results["coverage_incident"][1]))
    assert chip_smoke.INCIDENT_EXPECTED["evacuate_canary"] == _sha(results["evacuate_canary"][1])
    assert set(chip_smoke.INCIDENT_REPLAYS) == {"break-grace-canary", "overlap-stress"}


# ---- the drills' parts ----------------------------------------------------------


def test_the_gates_and_the_grouping_are_jax_s():
    assert paging.PAGING_GROUP_BY == jax_paging.PAGING_GROUP_BY
    for name in dir(jax_perfgates):
        if name.startswith(("PAGING_", "FUZZ_")):
            assert getattr(perfgates, name) == getattr(jax_perfgates, name), name


def test_a_state_probe_passes_through_the_planner_and_pages():
    """A StateProbe is an expression the planner does not know: it plans it
    as itself, and the alert pends, fires and pages on the rule tick."""
    from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
    from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    clock = VirtualClock()
    cluster = SimCluster(clock, nodes=[("tpu-node-0", 8)], pod_start_latency=12.0)
    dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=lambda t: 20.0,
                        load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)
    pipe = AutoscalingPipeline(cluster, dep, target_value=40.0, max_replicas=4)
    assert pipe.page_router is None
    pipe.start()
    state = {"bad": False}
    probe = paging.StateProbe(lambda: state["bad"])
    assert pipe.planner.plan(probe) is probe
    assert probe.promql() == "state_probe()" and probe.input_names() == frozenset()
    rule = paging.health_alert_rules(pipe)[0]
    rule.expr = probe
    router = paging.attach_pager(pipe, [rule])
    assert pipe.page_router is router and pipe.evaluator.alerts[-1] is rule
    assert (router.group_wait, router.group_interval, router.repeat_interval) == (
        perfgates.PAGING_GROUP_WAIT_S, perfgates.PAGING_GROUP_INTERVAL_S,
        perfgates.PAGING_REPEAT_INTERVAL_S)
    clock.run_until(60.0)
    state["bad"] = True
    clock.run_until(120.0)
    (page,) = router.pages()
    # pending at the first tick, firing for_seconds later, paged group_wait on
    assert page["t"] == page["alerts"][0]["active_since"] + perfgates.PAGING_GROUP_WAIT_S
    assert page["group"] == {"alertname": "PipelineUnhealthy", "severity": "critical",
                             "region": ""}


def _doctored(base: dict, **score) -> dict:
    result = copy.deepcopy(base)
    result["score"].update(score)
    return result


@pytest.mark.parametrize("change", [
    {"recall": 0.5, "uncovered_faults": ["f"]},
    {"precision": 0.5},
    {"time_to_page_s": {"p50": 10.0, "p95": 500.0, "max": 600.0}},
    {"unattributed_incidents": ["INC-002"]},
    {"violations": [{"kind": "duplicate_page", "t": 40.0, "group": {"alertname": "A"}}]},
], ids=["recall", "precision", "time_to_page", "unattributed", "log"])
def test_the_paging_contract_clause_by_clause_is_jax_s(results, change):
    port = _doctored(results["storm"][0], **change)
    got = paging.evaluate_paging_contract(port, "storm")
    assert got == jax_paging.evaluate_paging_contract(port, "storm")
    assert got[0] is False and len(got[1]) == 1


# ---- the umbrella -----------------------------------------------------------------


@pytest.mark.parametrize("argv,name,rc", [
    (["--run", "storm"], "storm", 0),
    (["--run", "crunch"], "crunch", 0),
    (["--break-inhibition"], "storm_canary", 2),
], ids=["storm", "crunch", "break-inhibition"])
def test_cli_incident_prints_jax_s_report_and_exit_code(results, capsys, argv, name, rc):
    assert umbrella_main(["simulate", "--scenario", "incident", *argv]) == rc
    out = capsys.readouterr().out
    ref = results[name][1]
    assert out.startswith(jax_incident.render_incident_report(ref) + "\n")
    for v in ref["violations"]:
        assert f"paging contract: {v}" in out


def test_cli_incident_smoke_json_and_why_are_jax_s(results, tmp_path, capsys):
    path = tmp_path / "incident.json"
    rc = umbrella_main(["simulate", "--scenario", "incident", "--smoke", "--json", str(path),
                        "--why", "INC-001"])
    assert rc == 0
    ref = results["evacuate"][1]
    assert path.read_bytes() == (_canon(ref) + "\n").encode()
    out = capsys.readouterr().out
    assert out == (jax_incident.render_incident_report(ref) + "\n\n"
                   + jax_incident.render_incident_why(ref, "INC-001") + "\n")


def test_cli_incident_unknown_run_exits_2(capsys):
    assert umbrella_main(["simulate", "--scenario", "incident", "--run", "races"]) == 2
    assert capsys.readouterr().out == (
        "simulate incident: unknown --run 'races' (storm, crunch, evacuate)\n")


# ---- the rungs, stubbed -------------------------------------------------------------


def _fake_run_fuzz(canary_found: bool):
    def run_fuzz(budget, seed, break_grace=False):
        if break_grace:
            if not canary_found:
                return {"novel_accepts": 0, "failure": None}
            return {
                "novel_accepts": 3,
                "failure": {
                    "reproducible": True,
                    "minimized": {"faults": [{}, {}], "traffic": {}},
                    "shrink_ratio": 0.4,
                },
            }
        return {"novel_accepts": perfgates.FUZZ_MIN_NOVEL_ACCEPTS}

    return run_fuzz


@pytest.mark.parametrize("canary_found", [True, False])
def test_chaos_fuzz_rung_pins_keys_and_gate_logic(monkeypatch, canary_found):
    """bench.py's keys and gate logic with the campaigns stubbed: the rung
    equals bench.py's on the same stubs, and a canary the fuzzer cannot
    find fails it with determinism and novelty intact."""
    monkeypatch.setattr(fuzz, "run_fuzz", _fake_run_fuzz(canary_found))
    monkeypatch.setattr(jax_fuzz, "run_fuzz", _fake_run_fuzz(canary_found))
    result = trial.chaos_fuzz_rung()
    assert result == bench.run_rung_chaos_fuzz()
    assert set(result) == {
        "mode", "metric", "budget", "seed", "bit_identical", "novel_accepts",
        "novel_accepts_min", "canary_budget", "canary_found", "canary_minimized",
        "canary_shrink_ratio", "shrink_ratio_max", "canary_minimized_faults", "ok",
    }
    assert result["mode"] == "virtual"
    assert result["budget"] == perfgates.FUZZ_RUNG_BUDGET
    assert result["canary_budget"] == perfgates.FUZZ_CANARY_BUDGET
    assert result["shrink_ratio_max"] == perfgates.FUZZ_MAX_SHRINK_RATIO
    assert result["bit_identical"] is True
    assert result["canary_found"] is canary_found
    assert result["canary_minimized"] is canary_found
    assert result["ok"] is canary_found


def _drill(ok=True, violations=()):
    return {
        "score": {
            "pages_total": 3,
            "recall": 1.0,
            "precision": 1.0,
            "time_to_page_s": {"p50": 20.0, "p95": 20.0, "max": 20.0},
            "violations": list(violations),
        },
        "violations": [v["kind"] for v in violations],
        "ok": ok,
    }


def _stub_paging(monkeypatch, mod, canary_caught: bool) -> None:
    canary_violation = {"kind": "uninhibited_duplicate_page"}
    monkeypatch.setattr(mod, "run_paging_storm", lambda: _drill())
    monkeypatch.setattr(mod, "run_paging_crunch", lambda: _drill())
    monkeypatch.setattr(
        mod,
        "run_paging_evacuation",
        lambda smoke=True, break_inhibition=False: (
            _drill(ok=False, violations=[canary_violation])
            if break_inhibition and canary_caught
            else _drill()
        ),
    )


@pytest.mark.parametrize("canary_caught", [True, False])
def test_paging_bench_rung_pins_keys_and_gate_logic(monkeypatch, canary_caught):
    """bench.py's keys and gate logic with the drills stubbed: the rung
    equals bench.py's on the same stubs, and a canary that pages clean (the
    mis-inhibition regression uncaught) fails it with all three drills
    green and the log the same bytes."""
    _stub_paging(monkeypatch, paging, canary_caught)
    _stub_paging(monkeypatch, jax_paging, canary_caught)
    result = trial.paging_bench_rung()
    assert result == bench.run_rung_paging_bench()
    assert set(result) == {
        "mode", "metric", "storm", "crunch", "evacuate", "ttp_budgets_s", "canary_caught",
        "bit_identical", "ok",
    }
    assert result["mode"] == "virtual"
    assert result["ttp_budgets_s"] == perfgates.PAGING_TTP_P95_MAX_S
    assert result["bit_identical"] is True
    for scenario in ("storm", "crunch", "evacuate"):
        assert set(result[scenario]) == {"pages", "recall", "precision", "ttp_p95_s",
                                         "violations", "ok"}
    assert result["canary_caught"] is canary_caught
    assert result["ok"] is canary_caught
