"""Ring attention across ranks on the CPU: the port's ring over 2, 4 and 8
gloo ranks against the JAX package's ``ring_attention`` on the 8 virtual
CPU devices of tests/conftest.py, from the same seeded numpy inputs.

- the output at f32 2e-5 and bf16 3e-2, causal and not
  (tests/test_ring_attention.py's bars), chunked and not, and on a (4, 2)
  mesh whose model axis replicates;
- the first block ignores the future (tests/test_ring_attention.py:53);
- the gradients of q, k and v against ``jax.vjp`` of JAX's ring at 2e-4;
- ``ppermute``'s forward and its transpose against ``lax.ppermute``'s on 2
  and 4 ranks, a mismatched ring raising at the group's timeout, and the
  host staging chosen by the group's backend;
- the ringattn rung: ``RingAttentionLoadGen`` self-reports
  (tests/test_ring_attention.py:69) and ``python -m
  k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with WORKLOAD=ringattn runs it
  over two processes until SIGTERM.

Rank bodies live at the top level and JAX is imported inside the tests."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from k8s_gpu_hpa_tpu_torch.loadgen.multihost import free_port, launch
from k8s_gpu_hpa_tpu_torch.loadgen.ringattn import RingAttentionLoadGen
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import ring_attention
from k8s_gpu_hpa_tpu_torch.parallel import mesh as pm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import JOIN_S, QUIET, REPO, _save, run_ranks

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 2e-4
#: tests/test_ring_attention.py's operands: batch 2, seq 64, 2 heads of 16
SHAPE = (2, 64, 2, 16)
#: the K/V chunk of each ring: unchunked on 4 and 8 ranks, 4 chunks a block on 2
CHUNK = {2: 8, 4: 512, 8: 512}
#: the permutations held against lax.ppermute: on 4 ranks rank 3 receives nothing
PERMS = {2: [(0, 1), (1, 0)], 4: [(0, 2), (2, 1), (1, 0)]}


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    names = ("q", "k", "v", "do", "k2", "v2")
    return {name: rng.standard_normal(SHAPE).astype(np.float32) for name in names}


def _shard(x: torch.Tensor, index: int, n: int) -> torch.Tensor:
    lq = x.shape[1] // n
    return x[:, index * lq:(index + 1) * lq].contiguous()


def _ring_outputs(x: dict, mesh, n: int, chunk: int) -> dict:
    index = mesh.get_local_rank(pm.DATA_AXIS)
    q, k, v = (_shard(x[name], index, n) for name in "qkv")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            got = ring_attention(q.to(dtype), k.to(dtype), v.to(dtype), mesh, causal=causal,
                                 kv_chunk=chunk)
            out[(str(dtype).removeprefix("torch."), causal)] = got.float()
    return out


def ring_rank(out_dir, x, n) -> None:
    """One of ``n`` ranks: the ring's outputs and gradients; on 4 ranks the
    scrambled-future run, on 8 a (4, 2) mesh; ppermute on 2 and 4."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh()
    index = mesh.get_local_rank(pm.DATA_AXIS)
    res = {"index": index, "outputs": _ring_outputs(x, mesh, n, CHUNK[n])}
    for causal in (False, True):
        q, k, v = (_shard(x[name], index, n).requires_grad_() for name in "qkv")
        ring_attention(q, k, v, mesh, causal=causal, kv_chunk=CHUNK[n]).backward(
            _shard(x["do"], index, n))
        res[("grads", causal)] = [t.grad for t in (q, k, v)]
    if n == 4:
        q, k2, v2 = (_shard(x[name], index, n) for name in ("q", "k2", "v2"))
        k, v = (_shard(x[name], index, n) for name in "kv")
        first = index == 0  # rank 0's K/V stay; every later block is scrambled
        res["scrambled"] = ring_attention(q, k if first else k2, v if first else v2, mesh,
                                          causal=True)
    if n == 8:
        mesh2d = pm.make_mesh(model_parallelism=2)
        res["mesh2d_index"] = mesh2d.get_local_rank(pm.DATA_AXIS)
        res["mesh2d"] = ring_attention(*(_shard(x[name], res["mesh2d_index"], 4) for name in "qkv"),
                                       mesh2d, causal=True)
    if n in PERMS:
        group = mesh.get_group(pm.DATA_AXIS)
        value = x["q"][0, 0, 0, :3] + 10.0 * index
        weight = x["do"][0, 0, 0, :3] + 10.0 * index
        xs = value.clone().requires_grad_()
        ys = pm.ppermute(xs, group, PERMS[n])
        (ys * weight).sum().backward()
        res["ppermute"] = (ys.detach(), xs.grad)
        res["staged"] = {"cpu_tensor": pm.host_staged(xs, group),
                         "off_cpu_tensor": pm.host_staged(torch.empty(3, device="meta"), group),
                         "backend": dist.get_backend(group)}
    _save(out_dir, res)


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    x = {name: torch.from_numpy(a) for name, a in _inputs().items()}
    return {n: run_ranks(ring_rank, n, tmp_path_factory.mktemp(f"ring{n}"), x, n)
            for n in (2, 4, 8)}


def _jax_ring(n: int, dtype: str, causal: bool, model_parallelism: int = 1, k="k", v="v"):
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.ops.ring_attention import ring_attention as jax_ring_attention
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    x = _inputs()
    mesh = make_mesh(n_devices=n * model_parallelism, model_parallelism=model_parallelism)
    q, kk, vv = (jnp.asarray(x[name], getattr(jnp, dtype)) for name in ("q", k, v))
    out = jax_ring_attention(q, kk, vv, mesh, causal=causal, kv_chunk=CHUNK.get(n, 512))
    return np.asarray(out.astype(jnp.float32))


def _assembled(ranks: list, key, index_key="index") -> np.ndarray:
    """The global array from the ranks' sequence shards, in axis order."""
    shards = {}
    for r in ranks:
        shard = r[key] if not isinstance(key, tuple) else r["outputs"][key]
        i = r[index_key]
        if i in shards:  # a replica of the model axis: the same shard
            np.testing.assert_array_equal(np.asarray(shard), shards[i])
        shards[i] = np.asarray(shard)
    return np.concatenate([shards[i] for i in sorted(shards)], axis=1)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_ring_matches_jax_s_ring(rings, n, dtype, causal):
    got = _assembled(rings[n], (dtype, causal))
    want = _jax_ring(n, dtype, causal)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_the_ring_over_the_data_axis_of_a_2d_mesh_matches_jax_s(rings):
    """tests/test_ring_attention.py's 2-D case: the ring runs over the data
    axis, the model axis replicates (each replica's shard is checked equal)."""
    got = _assembled(rings[8], "mesh2d", "mesh2d_index")
    want = _jax_ring(4, "float32", True, model_parallelism=2)
    np.testing.assert_allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"])


def test_the_first_block_ignores_the_future(rings):
    """Rank 0's rows attend only to their own block: scrambling every later
    block's K/V moves nothing there and something everywhere else."""
    ranks = sorted(rings[4], key=lambda r: r["index"])
    base = [r["outputs"][("float32", True)].numpy() for r in ranks]
    poked = [r["scrambled"].numpy() for r in ranks]
    np.testing.assert_allclose(poked[0], base[0], rtol=1e-5, atol=1e-5)
    assert all(not np.allclose(p, b) for p, b in zip(poked[1:], base[1:]))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_ring_s_gradients_match_jax_s(rings, n, causal):
    import jax
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.ops.ring_attention import ring_attention as jax_ring_attention
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    x = _inputs()
    mesh = make_mesh(n_devices=n)

    @jax.jit
    def grads(q, k, v, do):
        ring = lambda q, k, v: jax_ring_attention(q, k, v, mesh, causal=causal,  # noqa: E731
                                                   kv_chunk=CHUNK[n])
        return jax.vjp(ring, q, k, v)[1](do)

    want = grads(*(jnp.asarray(x[name]) for name in ("q", "k", "v", "do")))
    ranks = sorted(rings[n], key=lambda r: r["index"])
    for i, name in enumerate(("dq", "dk", "dv")):
        got = np.concatenate([r[("grads", causal)][i].numpy() for r in ranks], axis=1)
        np.testing.assert_allclose(got, np.asarray(want[i]), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_ppermute_and_its_transpose_match_jax_s(rings, n):
    """``lax.ppermute`` inside ``shard_map`` and its vjp on n devices, each
    device's row its rank's: the forward and the cotangent sent back along
    the inverse permutation (an idle rank receives zeros)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh
    from k8s_gpu_hpa_tpu.utils.jax_compat import shard_map

    x = _inputs()
    rows = np.stack([x["q"][0, 0, 0, :3] + 10.0 * i for i in range(n)])
    weights = np.stack([x["do"][0, 0, 0, :3] + 10.0 * i for i in range(n)])
    mesh = make_mesh(n_devices=n)
    permute = shard_map(lambda a: lax.ppermute(a, "data", PERMS[n]), mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"))
    y, vjp = jax.vjp(permute, jnp.asarray(rows))
    (dx,) = vjp(jnp.asarray(weights))
    ranks = sorted(rings[n], key=lambda r: r["index"])
    np.testing.assert_array_equal(np.stack([r["ppermute"][0].numpy() for r in ranks]),
                                  np.asarray(y))
    np.testing.assert_array_equal(np.stack([r["ppermute"][1].numpy() for r in ranks]),
                                  np.asarray(dx))


def test_the_host_staging_is_chosen_by_the_group_s_backend(rings, monkeypatch):
    """On gloo a tensor off the CPU travels as a host copy, a CPU tensor as
    it is; the choice reads the group's backend, so on NCCL nothing is
    staged (the staging itself runs on the card: chip_smoke.py's
    ring_parity)."""
    for r in rings[2] + rings[4]:
        assert r["staged"] == {"cpu_tensor": False, "off_cpu_tensor": True, "backend": "gloo"}
    monkeypatch.setattr(pm.dist, "get_backend", lambda group=None: "nccl")
    assert not pm.host_staged(torch.empty(3, device="meta"), group=None)


def mismatched_rank(out_dir) -> None:
    """Both ranks wait to receive and neither sends: each raises at the
    group's timeout."""
    torch.set_num_threads(1)
    group = pm.make_mesh().get_group(pm.DATA_AXIS)
    perm = [(1, 0)] if dist.get_rank() == 0 else [(0, 1)]
    t0 = time.monotonic()
    try:
        pm.ppermute(torch.ones(3), group, perm)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    _save(out_dir, {"raised": raised, "after_s": time.monotonic() - t0})
    os._exit(0)  # a timed-out pair leaves the group unusable: no closing barrier


def test_a_ring_whose_ranks_disagree_raises_at_the_group_s_timeout(tmp_path):
    """Both ranks raise, neither before the group's 5 s timeout.  The first
    rank to time out closes gloo's pair, so its peer, whose own timeout may
    be a few milliseconds behind, may raise on the closed pair instead."""
    code = launch(mismatched_rank, (tmp_path,), devices=["cpu", "cpu"], timeout_s=5,
                  join_timeout_s=JOIN_S)
    assert code == 0
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert any("Timed out" in (g["raised"] or "") for g in got), got
    for g in got:
        assert g["raised"] is not None and (
            "Timed out" in g["raised"] or "Connection closed by peer" in g["raised"]), g
        assert 4.5 <= g["after_s"] < 30


def test_a_permutation_that_repeats_a_rank_is_refused():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="is not a permutation"):
            pm.ppermute(torch.ones(1), dist.group.WORLD, [(0, 0), (0, 0)])
        np.testing.assert_array_equal(pm.ppermute(torch.ones(2), dist.group.WORLD, [(0, 0)]),
                                      np.ones(2))
    finally:
        dist.destroy_process_group()


def loadgen_rank(out_dir) -> None:
    torch.set_num_threads(1)
    gen = RingAttentionLoadGen(mesh=pm.make_mesh(), seq_per_device=16, heads=2, head_dim=16,
                               device="cpu")
    gen.warmup()
    gen.step()
    _save(out_dir, {"stats": gen.stats(), "passes": gen.passes_per_burst})


def test_the_rung_self_reports(tmp_path):
    """tests/test_ring_attention.py's ``test_loadgen_self_reports`` on 8
    ranks, and the FLOPs of JAX's formula."""
    from k8s_gpu_hpa_tpu.loadgen.ringattn import RingAttentionLoadGen as JaxRingAttentionLoadGen
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    jax_gen = JaxRingAttentionLoadGen(mesh=make_mesh(n_devices=8), seq_per_device=16, heads=2,
                                      head_dim=16)
    jax_gen.warmup()
    jax_gen.step()
    want = jax_gen.stats()
    for r in run_ranks(loadgen_rank, 8, tmp_path):
        s = r["stats"]
        assert r["passes"] == jax_gen.passes_per_burst == 1
        assert s.bursts == 1 and s.context_length == want.context_length == 128
        assert s.achieved_tflops > 0 and s.seconds > 0
        # the same FLOPs a burst: TFLOP/s times the busy seconds
        assert s.achieved_tflops * s.seconds == pytest.approx(
            want.achieved_tflops * want.seconds, rel=1e-9)


def test_the_rung_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RingAttentionLoadGen(mesh=object())


def _slice_process(pid: int, port: int, env: dict) -> subprocess.Popen:
    code = "from k8s_gpu_hpa_tpu_torch.loadgen.multihost import main; main(device='cpu')"
    return subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, text=True,
        env={**env, **QUIET, "COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "2",
             "PROCESS_ID": str(pid)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)


def run_slice(env: dict, prefix: str, count: int = 2) -> tuple[list[str], list[int]]:
    """The slice container's command as two processes of one slice, until
    process 0 has printed ``count`` lines starting with ``prefix``; then
    SIGTERM to both.  Returns process 0's lines and both exit codes."""
    env = {k: v for k, v in {**os.environ, **env}.items()
           if k not in ("TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE")}
    port = free_port()
    procs = [_slice_process(pid, port, env) for pid in (0, 1)]
    lines = []
    try:
        deadline = time.monotonic() + JOIN_S
        while sum(ln.startswith(prefix) for ln in lines) < count and time.monotonic() < deadline:
            line = procs[0].stdout.readline()
            if not line:
                break
            lines.append(line.strip())
        for p in procs:
            p.send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    return lines + outs[0].splitlines(), [p.returncode for p in procs]


def test_the_slice_container_runs_ringattn_over_two_processes_until_sigterm(tmp_path):
    lines, codes = run_slice({"WORKLOAD": "ringattn", "SEQ_PER_DEVICE": "16", "HEADS": "2",
                              "HEAD_DIM": "16", "REPORT_S": "0.2",
                              "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob")}, "bursts=")
    assert codes == [0, 0], lines
    banner = next(ln for ln in lines if ln.startswith("tpu-test multihost loadgen"))
    assert banner.startswith("tpu-test multihost loadgen (ringattn): process 0/2 slice=0")
    assert "mesh={'data': 2, 'model': 1}" in banner
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in lines
               if ln.startswith("bursts=")]
    assert len(reports) >= 2 and all(r["ctx"] == "32" for r in reports)
    assert int(reports[-1]["bursts"]) > 0
