"""The fuzzer's planted canary, held to the JAX package's digest.

- tests/test_fuzz.py's three canary cases over one port campaign a module
  (``run_fuzz(budget=6, seed=7, break_grace=True)`` with an artifact
  directory): the failure is found within the pinned budget, reproduces,
  minimizes to a small core with a tenant_spike in it, and its written
  artifact replays green.
- The campaign's report (artifact path aside) as canonical JSON hashes to
  the JAX package's: the failure at case 0, minimized from 4 faults to 2
  in 23 runs, the signature ``convergence, recovery``.

JAX's side of it takes 130-200 s on a CPU, so it is held to JAX's digest,
written here from the JAX package at commit 828a707 (its fuzz plane
unchanged since 24dba52), as is the fuzz coverage session's
(tests/test_torch_fuzz.py); every cheaper comparison of the plane runs JAX
live.  The fuzz coverage session runs in tests/test_torch_fuzz.py, so that
neither file holds a worker much past 200 s.

Tolerance: exact (virtual time, one seeded rng).
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.chaos import fuzz
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: SHA-256 of the canonical JSON (sorted keys, no whitespace) of the JAX
#: package's run_fuzz(budget=6, seed=7, break_grace=True) (no out_dir), on
#: a CPU
JAX_CANARY_SHA256 = "9a078360827a95106f5f9c580da7dae7328fcb1c194c5f88154ff3949f3d4037"


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@pytest.fixture(scope="module")
def canary_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("fuzz-corpus")
    return fuzz.run_fuzz(
        budget=perfgates.FUZZ_CANARY_BUDGET,
        seed=perfgates.FUZZ_CANARY_SEED,
        break_grace=True,
        out_dir=out,
    )


def test_canary_found_within_pinned_budget(canary_report):
    failure = canary_report["failure"]
    assert failure is not None, (
        f"--break-grace canary not found within {perfgates.FUZZ_CANARY_BUDGET} cases"
    )
    assert failure["case_index"] < perfgates.FUZZ_CANARY_BUDGET
    assert failure["reproducible"] is True
    assert "convergence" in failure["signature"]
    assert canary_report["ok"] is True


def test_canary_minimizes_to_a_small_core(canary_report):
    failure = canary_report["failure"]
    minimized = failure["minimized"]
    assert minimized is not None, "the canary's failure did not minimize"
    assert (
        failure["shrink_ratio"] <= perfgates.FUZZ_MAX_SHRINK_RATIO
        or len(minimized["faults"]) <= 2
    )
    # the known core: a prod spike while provisioning is down forces the
    # preemption whose victim --break-grace strands in Terminating
    assert "tenant_spike" in sorted(f["kind"] for f in minimized["faults"])


def test_canary_artifact_written_and_replays_green(canary_report):
    path = canary_report["failure"]["artifact_path"]
    assert path is not None and Path(path).exists()
    replay = fuzz.replay_artifact(path)
    assert replay["ok"] is True, replay


def test_the_canary_campaign_is_jax_s(canary_report):
    failure = canary_report["failure"]
    assert (failure["case_index"], len(failure["case"]["faults"]),
            len(failure["minimized"]["faults"]), failure["minimizer_runs"],
            failure["signature"]) == (0, 4, 2, 23, ["convergence", "recovery"])
    # the digest is of the report JAX gives without an artifact directory
    report = {**canary_report, "failure": {**failure, "artifact_path": None}}
    assert hashlib.sha256(_canon(report).encode()).hexdigest() == JAX_CANARY_SHA256
