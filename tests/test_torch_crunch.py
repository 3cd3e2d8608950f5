"""The capacity crunch (``chaos/crunch.py``) and its ``simulate`` scenario
against the JAX package's.

- ``run_capacity_crunch()`` of each package, run once a module: the same
  result as sorted JSON (the tenants' times to capacity, worst waits and
  evictions, the pool's 224 audits, the autoscaler, the fault reports and
  the scheduler's 51 events), and the same ``render_crunch_report`` text.
- ``evaluate_crunch_contract`` on doctored results, a clause at a time:
  the same violations, in the same words.
- The crunch's sizing and gates in ``perfgates`` and its faults are JAX's.
- ``simulate --scenario crunch --starvation-budget 0`` exits 2 and prints
  JAX's report with JAX's violations (the budgets only score the run, so
  JAX's result with every budget at 0 is the reference); the scenario's
  exit 0 is tests/test_torch_isolation.py's.

Tolerance: exact (virtual time throughout).
"""

import copy
import json

import pytest
import torch

from k8s_gpu_hpa_tpu import perfgates as jax_perfgates
from k8s_gpu_hpa_tpu.chaos import crunch as jax_crunch
import k8s_gpu_hpa_tpu_torch.__main__ as cli
from k8s_gpu_hpa_tpu_torch import chaos, perfgates
from k8s_gpu_hpa_tpu_torch.chaos import crunch
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def results():
    return crunch.run_capacity_crunch(), jax_crunch.run_capacity_crunch()


def test_the_crunch_is_jax_s_as_sorted_json(results):
    port, ref = results
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["ok"] and port["violations"] == [] and len(port["events"]) == 51
    assert {n: t["ttc_p95_s"] for n, t in port["tenants"].items()} == {
        "tpu-prod": 10.0, "tpu-batch": 310.0, "tpu-best": 235.0}
    assert [t["preemptions_suffered"] for t in port["tenants"].values()] == [0, 1, 2]
    assert port["autoscaler"] == {"provisions": 2, "provision_failures": 1, "nodes_final": 0,
                                  "reaped": ["tpu-auto-0", "tpu-auto-1"]}
    assert port["pool"]["audit_ticks"] == 224 and port["pool"]["conserved_all"]


def test_the_crunch_s_report_is_jax_s(results):
    port, ref = results
    text = chaos.render_crunch_report(port)
    assert text == jax_crunch.render_crunch_report(ref)
    assert text.splitlines()[0] == ("capacity crunch: 3 tenants over a 16-chip pool, "
                                    "3 preemptions, 2 nodes provisioned (1 failed attempts)")
    assert text.endswith("contract: all clauses hold")


def _doctor(result: dict, how: str) -> dict:
    out = copy.deepcopy(result)
    t = out["tenants"]
    if how == "conservation":
        out["pool"].update(conserved_all=False, audit_violations=["node n: used 9 + free 0 != 8"])
    elif how == "conservation_silent":
        out["pool"]["conserved_all"] = False
    elif how == "ttc":
        t["tpu-prod"]["ttc_p95_s"] = 61.0
    elif how == "starvation":
        t["tpu-best"]["max_pending_stint_s"] = 901.5
    elif how == "budget":
        t["tpu-batch"]["preemptions_suffered"] = 7
    elif how == "converged":
        t["tpu-best"].update(final_running=0, final_pending=1)
    elif how == "recovered":
        out["all_recovered"] = False
    elif how == "surplus":
        out["autoscaler"]["nodes_final"] = 1
    elif how == "vacuous":
        out["preemptions_total"] = 0
        out["autoscaler"].update(provisions=0, provision_failures=0)
    elif how != "whole":
        raise KeyError(how)
    return out


@pytest.mark.parametrize("how", ["whole", "conservation", "conservation_silent", "ttc",
                                 "starvation", "budget", "converged", "recovered", "surplus",
                                 "vacuous"])
def test_each_clause_of_the_contract_fires_as_jax_s(results, how):
    port, ref = results
    got = crunch.evaluate_crunch_contract(_doctor(port, how))
    assert got == jax_crunch.evaluate_crunch_contract(_doctor(ref, how))
    assert bool(got) == (how != "whole")
    if how == "vacuous":
        assert len(got) == 3


def test_the_crunch_s_sizing_gates_and_faults_are_jax_s():
    names = [n for n in dir(jax_perfgates) if n.startswith("CRUNCH_")]
    assert len(names) == 11
    assert {n: getattr(perfgates, n) for n in names} == {
        n: getattr(jax_perfgates, n) for n in names}
    assert crunch.CRUNCH_TENANTS == jax_crunch.CRUNCH_TENANTS
    assert ([(f.name, f.duration, f.target, f.params) for f in chaos.CRUNCH_FAULTS]
            == [(f.name, f.duration, f.target, f.params) for f in jax_crunch.CRUNCH_FAULTS])


def test_the_crunch_scenario_passes_and_a_zero_budget_fails_it_as_jax_s(results, capsys):
    _, ref = results
    assert cli.main(["simulate", "--scenario", "crunch", "--starvation-budget", "0"]) == 2
    starved = copy.deepcopy(ref)
    for t in starved["tenants"].values():
        t["starvation_budget_s"] = 0.0
    starved["violations"] = jax_crunch.evaluate_crunch_contract(starved)
    starved["ok"] = not starved["violations"]
    out = capsys.readouterr().out
    assert out == jax_crunch.render_crunch_report(starved) + "\n"
    assert starved["violations"] == ["tpu-prod: starved 10.0s, over its 0s budget",
                                     "tpu-batch: starved 310.0s, over its 0s budget",
                                     "tpu-best: starved 235.0s, over its 0s budget"]
