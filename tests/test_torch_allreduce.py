"""The slice container's collective rung and the tensor-parallel MLP on the
CPU, the port over gloo ranks against the JAX package on the 8 virtual CPU
devices of tests/conftest.py.

- ``tp_mlp_forward`` at a (2, 4) mesh on JAX's weights and batch
  (tests/test_jax_workloads.py's sizes) in f32 at 2e-4; the exact erf gelu
  planted in its place must fail that bar (``jax.nn.gelu`` is the tanh form).
- ``AllReduceLoadGen`` at (4, 2) and (2, 2) from one seeded numpy buffer
  after the same bursts: f32 at 2e-5, bf16 at 3e-2; its bytes a round equal
  JAX's at (4, 2), (2, 2) and (1, 1); its ring shift alone, at (4, 2),
  delivers each data rank its predecessor's shard.
- ``python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with no WORKLOAD
  runs the rung until SIGTERM.

Rank bodies live at the top level and JAX is imported inside the tests."""

import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from k8s_gpu_hpa_tpu_torch.loadgen import allreduce
from k8s_gpu_hpa_tpu_torch.loadgen.allreduce import AllReduceLoadGen
from k8s_gpu_hpa_tpu_torch.models import tp_mlp
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import JOIN_S, QUIET, REPO, _save, run_ranks

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

MLP_TOL = 2e-4
BUFFER_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
D_MODEL, D_HIDDEN, MLP_BATCH = 128, 512, 16
#: a buffer of 16 rows a rank (the floor) at 8 ranks in f32
BUFFER_MB, ROUNDS, BURSTS = 0.1, 2, 2


def _seeded(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _collectives(buffers: dict, model_parallelism: int) -> dict:
    """One rank's buffer shard after ``BURSTS`` bursts from ``buffers[dtype]``."""
    mesh = make_mesh(model_parallelism=model_parallelism)
    out = {}
    for name, full in buffers.items():
        gen = AllReduceLoadGen(mesh=mesh, buffer_mb=BUFFER_MB, rounds_per_burst=ROUNDS,
                               dtype=getattr(torch, name), device="cpu")
        gen.set_buffer(full)
        gen.warmup()
        for _ in range(BURSTS):
            gen.step()
        out[name] = {"shard": gen._x.float().numpy(), "stats": gen.stats(), "shape": gen.shape}
    out["index"] = (mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS))
    return out


def _ring_shift(mesh) -> dict:
    """One round on a shard stamped with this rank's data index plus one,
    the all_reduce and the gather made the identity: what the ring shift
    alone delivered.  (After a real all_reduce every data shard is equal,
    so a ring that sent to the wrong rank, or not at all, would not show.)"""
    gen = AllReduceLoadGen(mesh=mesh, buffer_mb=BUFFER_MB, rounds_per_burst=1,
                           dtype=torch.float32, device="cpu")
    index = mesh.get_local_rank(DATA_AXIS)
    gen._x.fill_((index + 1) * gen.n_data)  # the round divides by n_data
    allreduce.dist = types.SimpleNamespace(
        all_reduce=lambda x, group: None,
        all_gather_into_tensor=lambda out, x, group: out.view(-1, *x.shape).copy_(x),
        batch_isend_irecv=dist.batch_isend_irecv, P2POp=dist.P2POp, isend=dist.isend,
        irecv=dist.irecv)
    try:
        x = gen._burst(gen._x)
    finally:
        allreduce.dist = dist
    return {"index": index, "n_data": gen.n_data, "values": torch.unique(x).tolist()}


def eight_rank(out_dir, buffers, w1, w2, x) -> None:
    """The buffer at (4, 2), and its ring shift alone; the MLP at (2, 4),
    tanh and erf gelu."""
    torch.set_num_threads(1)
    out = {"collectives": _collectives(buffers, 2),
           "ring": _ring_shift(make_mesh(model_parallelism=2))}
    mesh = make_mesh(model_parallelism=4)
    params = tp_mlp.tp_params_from_numpy(w1.numpy(), w2.numpy(), mesh, device="cpu")
    rows = x.shape[0] // 2
    shard = x[mesh.get_local_rank(DATA_AXIS) * rows:][:rows]
    out["mlp"] = tp_mlp.tp_mlp_forward(params, shard, mesh).numpy()
    # the fault: the exact erf gelu, whatever ``approximate`` asks
    tp_mlp.F = types.SimpleNamespace(gelu=lambda t, approximate: F.gelu(t))
    out["mlp_erf"] = tp_mlp.tp_mlp_forward(params, shard, mesh).numpy()
    tp_mlp.F = F
    out["mlp_index"] = (mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS))
    _save(out_dir, out)


def four_rank(out_dir, buffers) -> None:
    torch.set_num_threads(1)
    _save(out_dir, {"collectives": _collectives(buffers, 2)})


def one_rank(out_dir, buffers) -> None:
    _save(out_dir, {"collectives": _collectives(buffers, 1)})


def _buffers(n_devices: int, model_parallelism: int) -> tuple[dict, dict]:
    """One seeded buffer a dtype at JAX's shape for this mesh, and JAX's
    buffer and bytes a round after the same warmup and bursts."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax
    from k8s_gpu_hpa_tpu.loadgen.allreduce import AllReduceLoadGen as JaxAllReduceLoadGen
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(n_devices, model_parallelism=model_parallelism)
    buffers, want = {}, {}
    for seed, name in enumerate(BUFFER_TOL):
        gen = JaxAllReduceLoadGen(mesh=mesh, buffer_mb=BUFFER_MB, rounds_per_burst=ROUNDS,
                                  dtype=getattr(jnp, name))
        buffers[name] = _seeded(gen.shape, seed)
        gen._x = jax.device_put(jnp.asarray(buffers[name], getattr(jnp, name)),
                                NamedSharding(mesh, P("data")))
        gen.warmup()
        for _ in range(BURSTS):
            gen.step()
        want[name] = {"buffer": np.asarray(gen._x, np.float32),
                      "bytes": gen.stats().bytes_moved_per_round, "shape": gen.shape}
    return {name: torch.from_numpy(b) for name, b in buffers.items()}, want


def _assembled(ranks: list, name: str) -> np.ndarray:
    """The global buffer from the data shards; every model replica equal."""
    shards = {}
    for r in ranks:
        c = r["collectives"]
        data = c["index"][0]
        if data in shards:
            np.testing.assert_array_equal(c[name]["shard"], shards[data])
        shards[data] = c[name]["shard"]
    return np.concatenate([shards[i] for i in sorted(shards)])


@pytest.fixture(scope="module")
def jax_mlp():
    import jax
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.tp_mlp import init_tp_mlp, tp_mlp_forward
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(model_parallelism=4)
    params = init_tp_mlp(jax.random.PRNGKey(0), D_MODEL, D_HIDDEN, mesh, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (MLP_BATCH, D_MODEL), jnp.float32)
    return {"w1": np.asarray(params["w1"]), "w2": np.asarray(params["w2"]),
            "x": np.asarray(x), "y": np.asarray(tp_mlp_forward(params, x, mesh))}


@pytest.fixture(scope="module")
def layouts(jax_mlp, tmp_path_factory):
    """Each mesh's port ranks and JAX's buffers: (4, 2), (2, 2), (1, 1)."""
    out = {}
    buffers, want = _buffers(8, 2)
    mlp = [torch.from_numpy(jax_mlp[k]) for k in ("w1", "w2", "x")]
    out[(4, 2)] = (run_ranks(eight_rank, 8, tmp_path_factory.mktemp("ar8"), buffers, *mlp), want)
    buffers, want = _buffers(4, 2)
    out[(2, 2)] = (run_ranks(four_rank, 4, tmp_path_factory.mktemp("ar4"), buffers), want)
    buffers, want = _buffers(1, 1)
    out[(1, 1)] = (run_ranks(one_rank, 1, tmp_path_factory.mktemp("ar1"), buffers), want)
    return out


def _mlp(ranks: list, key: str) -> np.ndarray:
    rows = {}
    for r in ranks:
        data, model = r["mlp_index"]
        if model == 0:
            rows[data] = r[key]
        else:  # every model rank holds the summed output
            np.testing.assert_array_equal(r[key], ranks[data * 4][key])
    return np.concatenate([rows[i] for i in sorted(rows)])


def test_tp_mlp_matches_jax_at_model_parallelism_4(layouts, jax_mlp):
    ranks, _ = layouts[(4, 2)]
    np.testing.assert_allclose(_mlp(ranks, "mlp"), jax_mlp["y"], rtol=MLP_TOL, atol=MLP_TOL)
    # JAX's own check: the unsharded block on the same weights
    import jax

    want = jax.nn.gelu(jax_mlp["x"] @ jax_mlp["w1"]) @ jax_mlp["w2"]
    np.testing.assert_allclose(_mlp(ranks, "mlp"), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)


def test_a_planted_erf_gelu_fails_the_mlp_bar(layouts, jax_mlp):
    ranks, _ = layouts[(4, 2)]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_mlp(ranks, "mlp_erf"), jax_mlp["y"], rtol=MLP_TOL,
                                   atol=MLP_TOL)


@pytest.mark.parametrize("layout", [(4, 2), (2, 2), (1, 1)], ids=lambda lay: f"{lay[0]}x{lay[1]}")
@pytest.mark.parametrize("dtype", list(BUFFER_TOL))
def test_allreduce_buffer_matches_jax_after_the_same_bursts(layout, dtype, layouts):
    ranks, want = layouts[layout]
    tol = BUFFER_TOL[dtype]
    got = _assembled(ranks, dtype)
    assert ranks[0]["collectives"][dtype]["shape"] == want[dtype]["shape"] == got.shape
    np.testing.assert_allclose(got, want[dtype]["buffer"], rtol=tol, atol=tol)
    if layout[0] > 1:  # the rounds moved it to the data shards' mean
        assert not np.allclose(got, _seeded(got.shape, list(BUFFER_TOL).index(dtype)), atol=tol)


def test_the_ring_shift_sends_each_data_shard_to_the_next_data_rank(layouts):
    ranks, _ = layouts[(4, 2)]
    for r in ranks:
        ring = r["ring"]
        # data rank i holds what data rank i - 1 was stamped with
        assert ring["n_data"] == 4 and ring["values"] == [(ring["index"] - 1) % 4 + 1], ring


@pytest.mark.parametrize("layout", [(4, 2), (2, 2), (1, 1)], ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_bytes_moved_per_round_equal_jax_s(layout, layouts):
    ranks, want = layouts[layout]
    for name in BUFFER_TOL:
        for r in ranks:
            stats = r["collectives"][name]["stats"]
            assert stats.bytes_moved_per_round == want[name]["bytes"]
            assert stats.rounds == BURSTS * ROUNDS and stats.achieved_gbps > 0


def test_multihost_main_runs_the_allreduce_rung_on_the_cpu_until_sigterm(tmp_path):
    """No WORKLOAD: the rung, at one rank on the CPU, its banner and report
    lines, and exit 0 on SIGTERM."""
    env = {
        **{k: v for k, v in os.environ.items()
           if k not in ("WORKLOAD", "COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
                        "HOSTS_PER_SLICE")},
        "REPORT_S": "0.2", "BUFFER_MB": "1", "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob"),
        **QUIET,
    }
    code = "from k8s_gpu_hpa_tpu_torch.loadgen.multihost import main; main(device='cpu')"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines = []
    try:
        deadline = time.monotonic() + JOIN_S
        while sum(ln.startswith("rounds=") for ln in lines) < 2 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=JOIN_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    assert lines[0].startswith("tpu-test multihost loadgen (allreduce): process 0/1 slice=0 "
                               "mesh={'data': 1, 'model': 1}")
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in lines[1:]]
    assert len(reports) >= 2 and all(r["ici"].endswith("GB/s") for r in reports)
    assert int(reports[1]["rounds"]) > int(reports[0]["rounds"]) > 0


def test_stats_before_any_burst_are_zero(tmp_path):
    (got,) = run_ranks(fresh_stats_rank, 1, tmp_path)
    assert got == (0, 0.0, 0.0)


def fresh_stats_rank(out_dir) -> None:
    s = AllReduceLoadGen(buffer_mb=BUFFER_MB, device="cpu").stats()
    _save(out_dir, (s.rounds, s.achieved_gbps, s.seconds))
    assert dist.get_world_size() == 1
