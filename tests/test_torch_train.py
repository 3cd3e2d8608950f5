"""The port's single-device training slice against the JAX package's: ring
attention on a ring of one device, the training forward and SGD step
(models/transformer.py), the LLM load generator (loadgen/llm.py) and the
multi-host entry point cut to one process (loadgen/multihost.py).

Parameters and tokens come from the JAX package (or numpy seeds) and are
carried across.  f32 holds the algorithm at the JAX transformer tests' bar,
2e-4, and ring attention at the JAX ring tests' f32 bar, 2e-5; bf16 holds the
flash branch at the loss bar of tests/test_flash_attention.py, 0.05.  On the
CPU the flash branch runs the kernels' plain versions, forward and backward;
chip_smoke.py drives the same step through the CUDA kernels on the card."""

import inspect
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.loadgen import multihost as jax_multihost
from k8s_gpu_hpa_tpu.loadgen.llm import LlmLoadGen as JaxLlmLoadGen
from k8s_gpu_hpa_tpu.models import transformer as jt
from k8s_gpu_hpa_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh
from k8s_gpu_hpa_tpu_torch.loadgen import multihost
from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
from k8s_gpu_hpa_tpu_torch.models import transformer as pt
from k8s_gpu_hpa_tpu_torch.ops import flash_attention as fa
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import ring_attention_local
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 2e-4
RING_TOL = 2e-5
LOSS_TOL = 0.05

#: the JAX transformer tests' CFG (tests/test_transformer.py:18)
SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=64)
#: head_dim 128, seq 128: inside both packages' flash envelopes
FLASH = dict(d_model=128, n_heads=1, n_layers=2, d_ff=512, max_seq=128)


def _models(sizes, jdtype, tdtype, seed=1):
    jcfg = jt.TransformerConfig(**sizes, dtype=jdtype)
    pcfg = pt.TransformerConfig(**sizes, dtype=tdtype)
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, pcfg, params, pt.params_from_jax(params_np, pcfg)


def _tokens(cfg, batch=2, seed=7):
    return np.array(
        jax.random.randint(jax.random.PRNGKey(seed), (batch, cfg.max_seq), 0, cfg.vocab, jnp.int32)
    )


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=name
    )


# ---- ring attention on a ring of one ---------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_local_matches_jax_ring_with_gradients(causal):
    """kv_chunk 64 over seq 256: four checkpointed chunk steps and their
    merges, against JAX ``ring_attention`` on a one-device mesh, output and
    gradients."""
    rng = np.random.default_rng(11 + causal)
    q, k, v, do = (rng.standard_normal((2, 256, 2, 32), dtype=np.float32) for _ in range(4))
    mesh = make_mesh(n_devices=1)
    out, vjp = jax.vjp(
        lambda q, k, v: jax_ring_attention(q, k, v, mesh, causal=causal, kv_chunk=64),
        *(jnp.asarray(x) for x in (q, k, v)),
    )
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ring_attention_local(tq, tk, tv, "data", 1, causal=causal, kv_chunk=64)
    _close(got.detach(), out, RING_TOL, "out")
    got.backward(torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want, strict=True):
        _close(g, w, RING_TOL, name)


def test_ring_attention_refuses_a_ring_of_more_than_one_device():
    """Given an axis name, not the ring's group (the ring itself runs in
    tests/test_torch_ring_attention.py)."""
    q = torch.zeros(1, 64, 1, 32)
    with pytest.raises(TypeError, match="through its process group"):
        ring_attention_local(q, q, q, "data", 2, causal=True)


# ---- the training attention op ----------------------------------------------


def _branch(attn_fn, cfg, lq=128):
    """Which op ``attn_fn`` takes: the flash Function leaves its backward
    node on the output."""
    q = torch.randn(1, lq, cfg.n_heads, cfg.head_dim, dtype=cfg.dtype, requires_grad=True)
    name = type(attn_fn(q, q, q).grad_fn).__name__
    return "flash" if name == "FlashAttentionBackward" else "ring"


def test_train_attn_fn_branches_and_refuses_unknown_impls():
    cfg = pt.TransformerConfig(d_model=128, n_heads=1, max_seq=128)
    assert _branch(pt._train_attn_fn(cfg, "data", 1, 128, "auto"), cfg) == "flash"
    assert _branch(pt._train_attn_fn(cfg, "data", 1, 128, "ring"), cfg) == "ring"
    # head_dim 32 lies off the envelope: a ring of one takes the ring too
    cfg32 = pt.TransformerConfig(d_model=128, n_heads=4, max_seq=128)
    assert _branch(pt._train_attn_fn(cfg32, "data", 1, 128, "auto"), cfg32) == "ring"
    # f32 lies off the port's envelope (bf16 only)
    cfg_f32 = pt.TransformerConfig(d_model=128, n_heads=1, max_seq=128, dtype=torch.float32)
    assert _branch(pt._train_attn_fn(cfg_f32, "data", 1, 128, "auto"), cfg_f32) == "ring"
    # a ring of two takes the ring path, which needs the ring's group
    with pytest.raises(TypeError, match="through its process group"):
        _branch(pt._train_attn_fn(cfg, "data", 2, 128, "auto"), cfg)
    # the pod-env knob rejects unknown values, as in JAX
    for impl in ("flash", "", "AUTO"):
        with pytest.raises(ValueError, match="attn_impl"):
            pt._train_attn_fn(cfg, "data", 1, 128, impl)


# ---- forward and train step -------------------------------------------------


def test_f32_forward_matches_jax_single_device_forward():
    jcfg, pcfg, params, ported = _models(SMALL, jnp.float32, torch.float32, seed=0)
    tokens = _tokens(jcfg, seed=3)
    want = jt.make_forward(make_mesh(n_devices=1), jcfg)(params, jnp.asarray(tokens))
    got = pt.make_forward(pcfg)(ported, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, 64, 256)
    _close(got, want, F32_TOL)
    with pytest.raises(TypeError, match="through its process group"):
        pt.forward_local(ported, torch.from_numpy(tokens).long(), pcfg, "data", 2)


def test_f32_train_step_matches_jax_and_the_loss_falls():
    """One SGD step at lr 0.5: the loss and every updated leaf agree with
    the JAX step on a one-device mesh; over 15 steps the loss falls below
    0.7 of its first value (tests/test_transformer.py:57-67)."""
    jcfg, pcfg, params, ported = _models(SMALL, jnp.float32, torch.float32)
    tokens = _tokens(jcfg)
    jstep = jt.make_train_step(make_mesh(n_devices=1), jcfg, lr=0.5)
    pstep = pt.make_train_step(pcfg, lr=0.5)
    want_params, want_loss = jstep(params, jnp.asarray(tokens))
    ttokens = torch.from_numpy(tokens).long()
    got_params, got_loss = pstep(ported, ttokens)
    _close(float(got_loss), float(want_loss), F32_TOL, "loss")
    want_np = jax.tree.map(lambda x: np.asarray(x, np.float32), want_params)
    got_np = pt.params_to_numpy(got_params)
    assert jax.tree.structure(got_np) == jax.tree.structure(want_np)
    for path, got in jax.tree_util.tree_leaves_with_path(got_np):
        want = want_np
        for key in path:
            want = want[key.key if hasattr(key, "key") else key.idx]
        _close(got, want, F32_TOL, jax.tree_util.keystr(path))
    # the step left its input untouched
    for before, after in zip(pt.param_leaves(ported), pt.param_leaves(pt.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params), pcfg)), strict=True):
        assert torch.equal(before, after)
    losses = [float(got_loss)]
    for _ in range(15):
        got_params, loss = pstep(got_params, ttokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def test_loss_is_finite_and_near_uniform_at_init():
    _, pcfg, _, ported = _models(SMALL, jnp.float32, torch.float32, seed=0)
    _, loss = pt.make_train_step(pcfg, lr=0.0)(ported, torch.from_numpy(_tokens(pcfg)).long())
    assert abs(float(loss) - math.log(pcfg.vocab)) < 0.1


def test_bf16_flash_step_matches_jax_and_the_ring_step(monkeypatch):
    """The flash branch in bf16 (d_model 128, one head of 128, seq 128, two
    layers): the port's auto loss lies within 0.05 of JAX's auto loss and of
    the port's own ring loss.  Under remat each layer runs the flash forward
    twice with the logsumexp and the backward once."""
    jcfg, pcfg, params, ported = _models(FLASH, jnp.bfloat16, torch.bfloat16)
    tokens = _tokens(jcfg, batch=1)
    _, want = jt.make_train_step(make_mesh(n_devices=1), jcfg)(params, jnp.asarray(tokens))
    calls = {"fwd_lse": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_kernel, fa.flash_attention_bwd_kernel

    def fwd_spy(q, k, v, causal, with_lse=False):
        calls["fwd_lse"] += with_lse
        return fwd(q, k, v, causal, with_lse)

    def bwd_spy(*args):
        calls["bwd"] += 1
        return bwd(*args)

    monkeypatch.setattr(fa, "flash_attention_kernel", fwd_spy)
    monkeypatch.setattr(fa, "flash_attention_bwd_kernel", bwd_spy)
    ttokens = torch.from_numpy(tokens).long()
    _, auto = pt.make_train_step(pcfg, attn_impl="auto")(ported, ttokens)
    assert calls == {"fwd_lse": 2 * pcfg.n_layers, "bwd": pcfg.n_layers}
    _, ring = pt.make_train_step(pcfg, attn_impl="ring")(ported, ttokens)
    assert calls == {"fwd_lse": 2 * pcfg.n_layers, "bwd": pcfg.n_layers}
    assert math.isfinite(float(auto))
    assert abs(float(auto) - float(want)) < LOSS_TOL
    assert abs(float(auto) - float(ring)) < LOSS_TOL


@pytest.mark.parametrize("sizes", [FLASH, dict(FLASH, d_model=256, n_heads=2, max_seq=256)],
                         ids=["h1s128", "h2s256"])
def test_bf16_flash_gradients_match_the_ring_gradients(sizes):
    """The loss's gradient through the flash branch (the plain backward on
    the CPU, inside the model: fused-QKV views, non-reentrant remat) against
    the ring's, leaf by leaf, wqkv's Q, K and V columns apart: the norm of
    the difference within 3% of the ring gradient's norm.  bf16 roundings
    downstream of attention make some 1% (0.6-1.3% read here); a leaf whose
    attention gradient went missing differs by 100%."""
    _, pcfg, _, ported = _models(sizes, jnp.bfloat16, torch.bfloat16)
    ttokens = torch.from_numpy(_tokens(pcfg, batch=1)).long()
    grads = {impl: pt.make_loss_and_grad(pcfg, impl)(ported, ttokens)
             for impl in ("auto", "ring")}
    assert abs(float(grads["auto"][0]) - float(grads["ring"][0])) < LOSS_TOL
    for p, a, r in zip(pt.param_leaves(ported), grads["auto"][1], grads["ring"][1], strict=True):
        assert a.shape == p.shape and a.dtype == p.dtype
        parts = (a.split(pcfg.d_model, -1), r.split(pcfg.d_model, -1)) \
            if a.shape[-1] == 3 * pcfg.d_model else ((a,), (r,))
        for x, y in zip(*parts, strict=True):
            x, y = x.float(), y.float()
            assert float((x - y).norm() / y.norm()) < 0.03


def test_params_to_numpy_inverts_params_from_jax():
    _, pcfg, params, ported = _models(SMALL, jnp.bfloat16, torch.bfloat16)
    back = pt.params_to_numpy(ported)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params), strict=True):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


# ---- the LLM load generator -------------------------------------------------

TINY = dict(seq_per_device=64, batch=2, d_model=64, n_heads=2, n_layers=2)


def test_llm_loadgen_matches_the_jax_generator():
    """The same parameters and tokens: warmup and one step land the JAX
    generator's loss; stats count tokens and the context as JAX does."""
    ref = JaxLlmLoadGen(mesh=make_mesh(n_devices=1), **TINY, dtype=jnp.float32, lr=0.5)
    gen = LlmLoadGen(**TINY, dtype=torch.float32, lr=0.5, device="cpu")
    gen.set_params(jax.tree.map(lambda x: np.asarray(x, np.float32), ref._params))
    gen.set_tokens(np.asarray(ref._tokens))
    for g in (ref, gen):
        g.warmup()
        g.step()
    got, want = gen.stats(), ref.stats()
    assert (got.steps, got.context_length) == (want.steps, want.context_length) == (1, 64)
    _close(got.last_loss, want.last_loss, F32_TOL, "loss")
    assert got.seconds > 0 and got.tokens_per_sec == pytest.approx(2 * 64 / got.seconds)


def test_llm_loadgen_defaults_are_the_jax_rung_and_seeded():
    a = LlmLoadGen(**TINY, device="cpu")
    b = LlmLoadGen(**TINY, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(pt.param_leaves(a._params), pt.param_leaves(b._params)))
    assert torch.equal(a._tokens, b._tokens) and a._tokens.shape == (2, 64)
    assert a.stats().steps == 0 and math.isnan(a.stats().last_loss)
    want = inspect.signature(JaxLlmLoadGen).parameters
    got = inspect.signature(LlmLoadGen).parameters
    for name in ("seq_per_device", "batch", "d_model", "n_heads", "n_layers", "lr", "attn_impl"):
        assert got[name].default == want[name].default, name
    assert got["dtype"].default == torch.bfloat16 and got["device"].default is None


def test_llm_loadgen_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlmLoadGen(**TINY)


# ---- the multi-host entry point ---------------------------------------------

ENV_CASES = [
    ({"COORDINATOR_ADDRESS": "coord:1234", "NUM_PROCESSES": "4", "PROCESS_ID": "2"}, "whatever"),
    ({"COORDINATOR_ADDRESS": "c:1", "TPU_WORKER_ID": "3", "SLICE_INDEX": "5"}, "h"),
    ({"TPU_WORKER_HOSTNAMES": "host-a,host-b", "TPU_WORKER_ID": "1"}, "host-b"),
    ({"TPU_WORKER_HOSTNAMES": "a,b,c", "COORDINATOR_PORT": "99"}, "a"),
    ({"TPU_WORKER_HOSTNAMES": ""}, "h"),
    ({"TPU_WORKER_HOSTNAMES": ",,"}, "h"),
    *[({"HOSTS_PER_SLICE": "2", "HEADLESS_SERVICE": "tpu-test-multihost"}, f"tpu-test-multihost-{i}")
      for i in (0, 1, 4, 5)],
    ({"HOSTS_PER_SLICE": "4", "POD_NAMESPACE": "ml"}, "set-9"),
    ({}, "h"),
    ({"HOSTS_PER_SLICE": "1"}, "x-3"),
    ({"HOSTS_PER_SLICE": "1"}, "tpu-test-7d9f4b-x2kqz"),
]


@pytest.mark.parametrize("env, hostname", ENV_CASES)
def test_topology_from_env_matches_jax(env, hostname):
    want = jax_multihost.topology_from_env(env, hostname=hostname)
    got = multihost.topology_from_env(env, hostname=hostname)
    if want is None:
        assert got is None
    else:
        assert got.__dict__ == want.__dict__ and got.worker_index == want.worker_index


def test_topology_needs_an_ordinal_and_pod_ordinal_matches_jax():
    with pytest.raises(ValueError):
        multihost.topology_from_env({"HOSTS_PER_SLICE": "2"}, hostname="no-ordinal-here")
    for name in ("a-b-12", "a", "a-", "-3", "x-07", "pod-1-x"):
        assert multihost.pod_ordinal(name) == jax_multihost.pod_ordinal(name)


def test_initialize_takes_one_process_and_refuses_more():
    # a slice of one process: a group of one, its rendezvous on this host
    topology = multihost.HostTopology(0, 1, f"127.0.0.1:{multihost.free_port()}")
    assert multihost.initialize(topology, device="cpu").num_processes == 1
    try:
        assert torch.distributed.get_world_size() == 1
    finally:
        torch.distributed.destroy_process_group()
    # a process beyond its slice is refused before any rendezvous
    with pytest.raises(ValueError, match="process 2 of a slice of 2"):
        multihost.initialize(multihost.HostTopology(2, 2, "127.0.0.1:1"), device="cpu")


_MAIN = "from k8s_gpu_hpa_tpu_torch.loadgen.multihost import main; main(device='cpu')"


def test_main_trains_and_reports_until_sigterm(tmp_path):
    """WORKLOAD=llm at a tiny size on the CPU: the banner, report lines with
    the context and a finite loss, and exit 0 on SIGTERM."""
    env = {
        **{k: v for k, v in os.environ.items() if k not in ("CHECKPOINT_DIR", "HOSTS_PER_SLICE")},
        "WORKLOAD": "llm", "SEQ_PER_DEVICE": "64", "D_MODEL": "64", "N_HEADS": "2",
        "N_LAYERS": "1", "REPORT_S": "0.2", "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob"),
    }
    proc = subprocess.Popen(
        [sys.executable, "-c", _MAIN], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    lines = []
    try:
        deadline = time.monotonic() + 120
        while sum(ln.startswith("steps=") for ln in lines) < 2 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    lines += out.splitlines()
    assert proc.returncode == 0, err
    assert lines[0].startswith("tpu-test multihost loadgen (llm): process 0/1 slice=0 device=cpu")
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in lines if ln.startswith("steps=")]
    assert len(reports) >= 2
    assert all(r["ctx"] == "64" for r in reports)
    assert int(reports[-1]["steps"]) > 0 and math.isfinite(float(reports[-1]["loss"]))
