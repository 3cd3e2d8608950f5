"""The scenario simulator (``simulate.py``) and the CLI umbrella
(``python -m k8s_gpu_hpa_tpu_torch``) against the JAX package's.

- Every Object scenario (spike, ramp, flap, outage, crash) on the
  headline, serve and slice HPAs: the port's timeline and scale events
  equal JAX's row for row, the recorded values within 1e-9, and
  ``render_report`` gives JAX's text.
- A measured signal ceiling on both sides of the band gives JAX's notes.
- The External scenarios, and the rejections with JAX's messages.
- ``python -m k8s_gpu_hpa_tpu_torch simulate ...`` prints what JAX's
  ``main`` prints and exits with its codes.
- The reference table: 45.0 s on the headline spike, 60.0 s and 40.0 s at
  the measured ceilings, 45.0 s on the slice HPA, 85.0 s on the ramps, the
  External spike's events at 60 and 75 s.
"""

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.__main__ import main as jax_main
from k8s_gpu_hpa_tpu_torch import simulate
from k8s_gpu_hpa_tpu_torch.__main__ import main
from k8s_gpu_hpa_tpu_torch.manifests import load_yaml
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy"
OBJECT_HPAS = ["tpu-test-hpa.yaml", "tpu-serve-hpa.yaml", "tpu-test-multihost-hpa.yaml"]


def _docs(name: str) -> tuple[dict, dict]:
    """The manifest as the port reads it and as JAX's tests read it."""
    text = (DEPLOY / name).read_text()
    port, ref = load_yaml(text), yaml.safe_load(text)
    assert port == ref
    return port, ref


def assert_reports_alike(port, ref) -> None:
    assert port.scenario == ref.scenario and port.offered_units == ref.offered_units
    assert len(port.timeline) == len(ref.timeline)
    for got, want in zip(port.timeline, ref.timeline):
        assert got[:2] == want[:2] and got[3:] == want[3:], (got, want)
        if want[2] is None:
            assert got[2] is None, got
        else:
            assert math.isclose(got[2], want[2], rel_tol=0, abs_tol=1e-9), (got, want)
    assert port.scale_events == ref.scale_events
    assert port.scale_up_latency == ref.scale_up_latency
    assert port.target_note == ref.target_note
    assert simulate.render_report(port) == jax_simulate.render_report(ref)


@pytest.mark.parametrize("scenario", list(simulate.SCENARIOS))
@pytest.mark.parametrize("name", OBJECT_HPAS)
def test_each_object_scenario_plays_as_jax_s(name, scenario):
    port_doc, ref_doc = _docs(name)
    port = simulate.run_scenario(port_doc, scenario)
    ref = jax_simulate.run_scenario(ref_doc, scenario)
    assert_reports_alike(port, ref)
    assert port.query_engine == ref.query_engine


#: (HPA, measured ceiling, the band edge in the note, reachable)
CEILINGS = [
    ("tpu-test-hpa.yaml", 51.4, 44, True),
    # at the edge the verdict says inert, yet 44 / 40 is 1.1000000000000000888
    # in floats, past the tolerance, so both controllers scale: JAX's quirk
    ("tpu-test-hpa.yaml", 44.0, 44, False),
    ("tpu-test-hpa.yaml", 6.3, 44, False),
    ("tpu-serve-hpa.yaml", 10.75, 5.5, True),
    ("tpu-serve-hpa.yaml", 5.0, 5.5, False),
]


@pytest.mark.parametrize("name,ceiling,edge,reachable", CEILINGS)
def test_a_measured_ceiling_gives_jax_s_verdict(name, ceiling, edge, reachable):
    port_doc, ref_doc = _docs(name)
    port = simulate.run_scenario(port_doc, "spike", saturated_pct=ceiling)
    assert_reports_alike(port, jax_simulate.run_scenario(ref_doc, "spike", saturated_pct=ceiling))
    assert f"(> {edge:g}" in port.target_note
    assert port.target_note.endswith("target reachable") == reachable
    if not reachable:
        assert port.target_note.startswith("INERT PAIRING")
        assert (port.scale_up_latency is None) == (ceiling < edge)


@pytest.mark.parametrize("scenario", list(simulate.EXTERNAL_SCENARIOS))
def test_each_external_scenario_plays_as_jax_s(scenario):
    port_doc, ref_doc = _docs("tpu-test-external-hpa.yaml")
    port = simulate.run_external_scenario(port_doc, scenario)
    assert_reports_alike(port, jax_simulate.run_external_scenario(ref_doc, scenario))


def test_the_reference_values():
    def run(name, scenario="spike", **kw):
        return simulate.run_scenario(_docs(name)[0], scenario, **kw)

    head = run("tpu-test-hpa.yaml")
    assert head.scale_up_latency == 45.0 and head.scale_events == [(75.0, 1, 3), (90.0, 3, 4)]
    capped = run("tpu-test-hpa.yaml", saturated_pct=51.4)
    assert capped.scale_up_latency == 60.0
    assert capped.scale_events == [(75.0, 1, 2), (90.0, 2, 3), (105.0, 3, 4)]
    assert run("tpu-serve-hpa.yaml", saturated_pct=10.75).scale_up_latency == 40.0
    sliced = run("tpu-test-multihost-hpa.yaml")
    assert sliced.scale_up_latency == 45.0 and [e[2] for e in sliced.scale_events] == [6, 8]
    for name, steps in (("tpu-test-hpa.yaml", [(1, 2), (2, 3), (3, 4)]),
                        ("tpu-test-multihost-hpa.yaml", [(2, 4), (4, 6), (6, 8)])):
        ramp = run(name, "ramp")
        assert ramp.scale_up_latency == 85.0
        assert ramp.scale_events == [(t, a, b) for t, (a, b) in zip((90.0, 120.0, 150.0), steps)]
    for scenario in ("flap", "crash", "outage"):
        assert run("tpu-test-hpa.yaml", scenario).scale_events == [(15.0, 1, 3)]
    external = simulate.run_external_scenario(_docs("tpu-test-external-hpa.yaml")[0], "spike")
    assert external.scale_events == [(60.0, 1, 3), (75.0, 3, 4)]


@pytest.mark.parametrize("call", [
    lambda mod, doc: mod.run_scenario(doc("tpu-train-hpa.yaml")),
    lambda mod, doc: mod.run_scenario(doc("tpu-test-hbm-hpa.yaml")),
    lambda mod, doc: mod.run_scenario(doc("tpu-test-external-hpa.yaml")),
    lambda mod, doc: mod.run_external_scenario(doc("tpu-test-external-hpa.yaml"), "crash"),
    lambda mod, doc: mod.run_external_scenario(doc("tpu-test-hpa.yaml")),
], ids=["two_metrics", "pods_metric", "external_as_object", "unknown_external",
        "object_as_external"])
def test_each_rejection_gives_jax_s_message(call):
    errors = []
    for mod, index in ((simulate, 0), (jax_simulate, 1)):
        with pytest.raises(ValueError) as err:
            call(mod, lambda name: _docs(name)[index])
        errors.append(str(err.value))
    assert errors[0] == errors[1]


#: simulate's arguments, each run by both CLIs
CLI_CASES = [
    [],
    ["--scenario", "ramp", "--duration", "300"],
    ["--saturated-pct", "51.4"],
    ["--saturated-pct", "6.3", "--pod-start", "20"],
    ["--hpa", "deploy/tpu-serve-hpa.yaml", "--saturated-pct", "10.75"],
    ["--hpa", "deploy/tpu-test-multihost-hpa.yaml", "--scenario", "outage"],
    ["--hpa", "deploy/tpu-test-external-hpa.yaml", "--scenario", "flap"],
    ["--hpa", "deploy/tpu-test-external-hpa.yaml", "--scenario", "crash"],
    ["--hpa", "deploy/tpu-test-external-hpa.yaml", "--saturated-pct", "50"],
    ["--hpa", "deploy/tpu-train-hpa.yaml"],
    ["--hpa", "deploy/cpu-busyloop-hpa.yaml"],
]


@pytest.mark.parametrize("args", CLI_CASES, ids=lambda a: " ".join(a) or "default")
def test_the_cli_prints_and_exits_as_jax_s(args, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    code = main(["simulate", *args])
    out = capsys.readouterr().out
    ref_code = jax_main(["simulate", *args])
    assert (code, out) == (ref_code, capsys.readouterr().out)
    assert code == (2 if args[-1:] in (["crash"], ["50"], ["deploy/tpu-train-hpa.yaml"],
                                       ["deploy/cpu-busyloop-hpa.yaml"]) else 0)


def test_the_module_runs_as_a_program_and_exits_with_jax_s_codes():
    """``python -m k8s_gpu_hpa_tpu_torch simulate`` as a program: JAX's
    report and exit 0, and exit 2 with JAX's diagnosis on a manifest it
    cannot play."""
    for args, code in ((["--scenario", "spike"], 0),
                       (["--hpa", "deploy/tpu-test-hbm-hpa.yaml"], 2)):
        runs = [subprocess.run([sys.executable, "-m", package, "simulate", *args], cwd=REPO,
                               capture_output=True, text=True, timeout=120)
                for package in ("k8s_gpu_hpa_tpu_torch", "k8s_gpu_hpa_tpu")]
        assert [r.returncode for r in runs] == [code, code]
        assert runs[0].stdout == runs[1].stdout


def test_the_umbrella_offers_the_ported_commands_only(capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    for command in ("doctor", "exporter", "loadgen", "train", "multihost", "simulate",
                    "gen-pipeline", "gen-manifests"):
        assert command in text
    assert "stub-libtpu" not in text
    # the crunch, the region evacuation, the fuzzer, the incident drill and
    # the race harness are ported
    # (tests/test_torch_{crunch,evacuate,fuzz,paging,races}.py)
    with pytest.raises(SystemExit):
        main(["simulate", "--help"])
    text = capsys.readouterr().out
    for scenario in ("crunch", "evacuate", "fuzz", "incident", "races"):
        assert scenario in text
    # a scenario the simulator does not have is refused
    with pytest.raises(SystemExit):
        main(["simulate", "--scenario", "no-such-scenario"])


def test_gen_manifests_writes_the_bundle(tmp_path, capsys):
    from k8s_gpu_hpa_tpu_torch import manifests

    assert main(["gen-manifests", "--out", str(tmp_path)]) == 0
    bundle = manifests.default_bundle()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(bundle)
    for name, docs in bundle.items():
        assert manifests.load_yaml_all((tmp_path / name).read_text()) == docs
    assert len(capsys.readouterr().out.splitlines()) == len(bundle)


def test_gen_manifests_check_reports_as_jax_s(tmp_path, capsys, monkeypatch):
    """``gen-manifests --check``: JAX's report and exit codes, the port's
    bundle held against the directory ``--out`` names (JAX's against its
    deploy/): every file agrees, then one is missing and one disagrees.
    The check writes nothing."""
    import re

    from k8s_gpu_hpa_tpu import manifests as jax_manifests
    from k8s_gpu_hpa_tpu_torch import manifests

    assert main(["gen-manifests", "--out", str(tmp_path)]) == 0
    capsys.readouterr()
    written = {p.name: p.read_text() for p in tmp_path.iterdir()}
    assert main(["gen-manifests", "--check", "--out", str(tmp_path)]) == 0
    port_ok = capsys.readouterr().out
    assert jax_main(["gen-manifests", "--check"]) == 0
    jax_ok = capsys.readouterr().out
    assert port_ok == f"all {len(manifests.default_bundle())} manifests agree with the generator\n"
    assert re.sub(r"\d+", "N", port_ok) == re.sub(r"\d+", "N", jax_ok)
    for module in (manifests, jax_manifests):
        real = module.default_bundle

        def bundle(real=real):
            docs = dict(real())
            docs["extra.yaml"] = [{"kind": "Extra"}]
            docs["tpu-test-hpa.yaml"] = [{"kind": "Other"}]
            return docs

        monkeypatch.setattr(module, "default_bundle", bundle)
    assert main(["gen-manifests", "--check", "-o", str(tmp_path)]) == 1
    port_stale = capsys.readouterr().out
    assert jax_main(["gen-manifests", "--check"]) == 1
    assert port_stale == capsys.readouterr().out == (
        "stale (disagree with manifests.py): extra.yaml (missing), tpu-test-hpa.yaml\n")
    assert {p.name: p.read_text() for p in tmp_path.iterdir()} == written
    with pytest.raises(SystemExit):
        main(["gen-manifests", "--check"])  # --out stays required
