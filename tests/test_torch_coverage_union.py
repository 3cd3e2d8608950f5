"""The coverage union, ``simulate.run_coverage("all")``, and bench.py's
``coverage_floor`` rung against the JAX package's.

Each package's union (every canned run of ``COVERAGE_RUN_NAMES`` under one
map, some 70-90 s on a CPU) runs once, in the module fixture:

- the port's export is JAX's bytes, probe by probe;
- ``trial.coverage_floor_rung`` fed the port's export equals bench.py's
  ``run_rung_coverage_floor`` fed JAX's (``k8s_gpu_hpa_tpu.simulate.
  run_coverage`` replaced for the call, as the rung calls it), field for
  field, and passes its floors;
- ``simulate --scenario coverage`` with no ``--run`` runs the union (fed
  the finished export) and gates it on the union floor.

Tolerance: exact (virtual time throughout).
"""

import hashlib
import json

import pytest
import torch

import bench
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu_torch import simulate, trial
from k8s_gpu_hpa_tpu_torch.__main__ import main as umbrella_main
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: SHA-256 of JAX's union export (``export_json`` form), on the CPU
JAX_ALL_SHA256 = "b2baee3ef592e6ebb3725d543c4773f75edcc3fe9fe01b8b612a7d263ad3cbff"


def _dump(export: dict) -> str:
    return json.dumps(export, sort_keys=True, separators=(",", ":"))


@pytest.fixture(scope="module")
def unions():
    """(the port's union, JAX's union), each run once."""
    return simulate.run_coverage(), jax_simulate.run_coverage()


def test_the_union_is_jax_s_bytes(unions):
    port, ref = unions
    assert port["run"] == ref["run"] == "all"
    assert list(port["probes"]) == list(ref["probes"])
    for pid, rec in ref["probes"].items():
        assert port["probes"][pid] == rec, pid
    assert port["domains"] == ref["domains"]
    assert _dump(port) == _dump(ref)
    assert hashlib.sha256(_dump(ref).encode()).hexdigest() == JAX_ALL_SHA256


def test_the_union_hits_every_domain_s_floor(unions):
    port, _ = unions
    assert port["domains"]["concurrency"]["ratio"] == 1.0
    assert all(port["domains"][d]["hit"] for d in port["domains"])


def test_the_rung_is_bench_s_field_for_field(unions, monkeypatch):
    port, ref = unions
    monkeypatch.setattr(jax_simulate, "run_coverage", lambda run="all", seed=None: ref)
    want = bench.run_rung_coverage_floor()
    got = trial.coverage_floor_rung(port)
    assert list(got) == list(want)
    assert got == want
    assert got["ok"] and got["never_hit"]


def test_the_default_coverage_command_runs_the_union(unions, monkeypatch, capsys, tmp_path):
    port, _ = unions
    calls = []

    def finished(run="all", seed=None):
        calls.append((run, seed))
        return port

    monkeypatch.setattr(simulate, "run_coverage", finished)
    out_path = tmp_path / "all.json"
    assert umbrella_main(["simulate", "--scenario", "coverage", "--json", str(out_path)]) == 0
    assert calls == [("all", None)]
    text = capsys.readouterr().out
    assert "meets declared floor" in text
    assert out_path.read_text() == _dump(port) + "\n"
    # an impossible floor fails the union
    assert umbrella_main(["simulate", "--scenario", "coverage", "--floor", "0.999"]) == 2
    assert "COVERAGE FLOOR VIOLATED" in capsys.readouterr().out
