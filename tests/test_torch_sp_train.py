"""Sequence-parallel training on the CPU: the port's forward and SGD step
with the context sharded over 2, 4 and 8 gloo ranks against the JAX
package's ``make_forward`` and ``make_train_step`` on the 8 virtual CPU
devices of tests/conftest.py, from the same parameters and tokens
(tests/test_transformer.py's sizes, f32).

- the sharded forward at 2e-4, and causality across shard boundaries;
- one step at 2e-4, the loss and every parameter, on 2, 4 and 8 ranks
  (two layers, so the backward recomputes each layer's ring, sends and
  all), every rank's parameters identical after it;
- a mesh of one runs the one-device step bit for bit;
- ``LlmLoadGen`` on a mesh of 4: the context, its first loss against JAX's
  step, its statistics;
- ``python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with WORKLOAD=llm
  as two processes of one slice: reports, saves on SIGTERM, exits 0, and
  started again resumes from that save.

Rank bodies live at the top level and JAX is imported inside the tests."""

import math

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
from k8s_gpu_hpa_tpu_torch.models import transformer as pt
from k8s_gpu_hpa_tpu_torch.parallel import mesh as pm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import _save, run_ranks
from tests.test_torch_ring_attention import run_slice

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 2e-4
LR = 0.5
#: tests/test_transformer.py's CFG
SIZES = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=64)
RANKS = (2, 4, 8)


def _jax_setup():
    import jax
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(**SIZES, dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(1), cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, cfg.max_seq)).astype(np.int32)
    return cfg, params, tokens


def _poked(tokens: np.ndarray) -> np.ndarray:
    """The tokens with one late position changed."""
    poked = tokens.copy()
    cut = SIZES["max_seq"] - 3
    poked[:, cut] = (poked[:, cut] + 1) % 256
    return poked


def sp_rank(out_dir, params, tokens, poked, n) -> None:
    """One of ``n`` ranks: the forward of its shard (and of the poked
    tokens' shard), then one SGD step."""
    torch.set_num_threads(1)
    cfg = pt.TransformerConfig(**SIZES, dtype=torch.float32)
    mesh = pm.make_mesh()
    index = mesh.get_local_rank(pm.DATA_AXIS)
    lq = cfg.max_seq // n
    shard = slice(index * lq, (index + 1) * lq)
    ported = pt.params_from_jax(params, cfg)
    forward = pt.make_forward(cfg, mesh)
    out = {"index": index, "logits": forward(ported, tokens[:, shard].long()),
           "poked": forward(ported, poked[:, shard].long())}
    new, loss = pt.make_train_step(cfg, lr=LR, mesh=mesh)(ported, tokens[:, shard].long())
    out["loss"], out["leaves"] = float(loss), pt.param_leaves(new)
    _save(out_dir, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    _, params, tokens = _jax_setup()
    params_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    args = (params_t, torch.from_numpy(tokens), torch.from_numpy(_poked(tokens)))
    return {n: sorted(run_ranks(sp_rank, n, tmp_path_factory.mktemp(f"sp{n}"), *args, n),
                      key=lambda r: r["index"])
            for n in RANKS}


def _logits(ranks: list, key: str) -> np.ndarray:
    return np.concatenate([r[key].numpy() for r in ranks], axis=1)


@pytest.mark.parametrize("n", RANKS)
def test_the_sharded_forward_matches_jax_s(runs, n):
    """tests/test_transformer.py's ``test_sharded_forward_matches_single_device``:
    the port's shards against JAX's sequence-sharded forward on as many
    devices."""
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import make_forward
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    cfg, params, tokens = _jax_setup()
    want = make_forward(make_mesh(n_devices=n), cfg)(params, jnp.asarray(tokens))
    np.testing.assert_allclose(_logits(runs[n], "logits"), np.asarray(want), rtol=TOL, atol=TOL)


def test_causality_across_shard_boundaries(runs):
    """Changing a late token moves no earlier position's logits, on earlier
    shards included (tests/test_transformer.py:48)."""
    base, poked = _logits(runs[8], "logits"), _logits(runs[8], "poked")
    cut = SIZES["max_seq"] - 3
    np.testing.assert_allclose(poked[:, :cut], base[:, :cut], rtol=1e-5, atol=1e-5)
    assert not np.allclose(poked[:, cut:], base[:, cut:])


@pytest.mark.parametrize("n", RANKS)
def test_one_step_matches_jax_s_step(runs, n):
    """The loss and every updated leaf against JAX's ``make_train_step`` on
    as many devices (lr 0.5, so the gradients show in the parameters)."""
    import jax
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import make_train_step
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    cfg, params, tokens = _jax_setup()
    new, loss = make_train_step(make_mesh(n_devices=n), cfg, lr=LR)(params, jnp.asarray(tokens))
    want = pt.param_leaves(pt.params_from_jax(jax.tree.map(np.asarray, new), pt.TransformerConfig(
        **SIZES, dtype=torch.float32)))
    for r in runs[n]:
        assert r["loss"] == pytest.approx(float(loss), rel=TOL, abs=TOL)
    for i, (got, w) in enumerate(zip(runs[n][0]["leaves"], want, strict=True)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=f"leaf {i}")


@pytest.mark.parametrize("n", RANKS)
def test_every_replica_holds_the_same_parameters_after_the_step(runs, n):
    first = runs[n][0]["leaves"]
    for r in runs[n][1:]:
        for a, b in zip(first, r["leaves"], strict=True):
            assert torch.equal(a, b)


def ring_of_one_rank(out_dir, params, tokens) -> None:
    """The step and the loss-and-grad on a mesh of one, and without a mesh."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = pt.TransformerConfig(**SIZES, dtype=dtype)
        ported = pt.params_from_jax(params, cfg)
        for name, m in (("mesh", mesh), ("none", None)):
            new, loss = pt.make_train_step(cfg, lr=LR, mesh=m)(ported, tokens.long())
            _, grads = pt.make_loss_and_grad(cfg, mesh=m)(ported, tokens.long())
            out[str(dtype), name] = {"loss": loss, "leaves": pt.param_leaves(new),
                                     "grad_dtypes": {g.dtype for g in grads}}
    _save(out_dir, out)


def test_a_ring_of_one_runs_the_single_device_step(tmp_path):
    """On a mesh whose data axis has one rank (the single-GPU pod in a group
    of one) the step is the one-device step bit for bit, its gradients in
    the leaves' dtype: no hop and no all_reduce run."""
    import jax

    _, params, tokens = _jax_setup()
    params_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    (out,) = run_ranks(ring_of_one_rank, 1, tmp_path, params_t, torch.from_numpy(tokens))
    for dtype in (torch.float32, torch.bfloat16):
        got, want = out[str(dtype), "mesh"], out[str(dtype), "none"]
        assert torch.equal(got["loss"], want["loss"])
        for a, b in zip(got["leaves"], want["leaves"], strict=True):
            assert torch.equal(a, b)
        assert got["grad_dtypes"] == want["grad_dtypes"] == {dtype}


def llm_rank(out_dir, params, tokens) -> None:
    torch.set_num_threads(1)
    gen = LlmLoadGen(mesh=pm.make_mesh(), seq_per_device=16, d_model=64, n_heads=2, n_layers=2,
                     dtype=torch.float32, lr=LR, device="cpu")
    gen.set_params(params)
    gen.set_tokens(tokens.numpy())
    shard = gen.tokens.clone()
    gen.warmup()
    first = gen.stats().last_loss
    gen.step()
    _save(out_dir, {"first_loss": first, "stats": gen.stats(), "shard": shard,
                    "index": gen.data_index, "max_seq": gen.cfg.max_seq})


def test_the_llm_rung_trains_over_a_mesh_of_four(tmp_path):
    """The context is four ranks' 16 tokens; each rank trains on its shard;
    the first step's loss is JAX's step's on the same weights and batch."""
    import jax
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import make_train_step
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    cfg, params, tokens = _jax_setup()
    tokens = tokens[:1]
    _, want = make_train_step(make_mesh(n_devices=4), cfg, lr=LR)(params, jnp.asarray(tokens))
    params_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    ranks = sorted(run_ranks(llm_rank, 4, tmp_path, params_t, torch.from_numpy(tokens)),
                   key=lambda r: r["index"])
    np.testing.assert_array_equal(np.concatenate([r["shard"].numpy() for r in ranks], axis=1),
                                  tokens)
    for r in ranks:
        assert r["max_seq"] == 64
        assert r["first_loss"] == pytest.approx(float(want), rel=TOL, abs=TOL)
        s = r["stats"]
        assert s.steps == 1 and s.context_length == 64 and s.seconds > 0
        assert s.tokens_per_sec == pytest.approx(64 / s.seconds)
        assert math.isfinite(s.last_loss) and s.last_loss < r["first_loss"]


def test_the_llm_rung_refuses_a_batch_of_another_shape():
    gen = LlmLoadGen(seq_per_device=8, d_model=64, n_heads=2, n_layers=1, dtype=torch.float32,
                     device="cpu")
    with pytest.raises(ValueError, match="a batch of shape"):
        gen.set_tokens(np.zeros((1, 16), np.int64))


def test_the_slice_container_trains_llm_over_two_processes_and_resumes(tmp_path):
    """WORKLOAD=llm as two processes of one slice: process 0 reports the
    whole context and a finite loss, both exit 0 on SIGTERM after rank 0's
    final save; started again, process 0 resumes from that save's step."""
    env = {"WORKLOAD": "llm", "SEQ_PER_DEVICE": "32", "D_MODEL": "64", "N_HEADS": "2",
           "N_LAYERS": "1", "REPORT_S": "0.2", "CHECKPOINT_DIR": str(tmp_path / "ckpt"),
           "CHECKPOINT_EVERY": "1000", "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob")}
    lines, codes = run_slice(env, "steps=")
    assert codes == [0, 0], lines
    banner = next(ln for ln in lines if ln.startswith("tpu-test multihost loadgen"))
    assert banner.startswith("tpu-test multihost loadgen (llm): process 0/2 slice=0 device=cpu")
    assert "mesh={'data': 2, 'model': 1}" in banner
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in lines if ln.startswith("steps=")]
    assert len(reports) >= 2 and all(r["ctx"] == "64" for r in reports)
    assert math.isfinite(float(reports[-1]["loss"]))
    (final,) = [ln for ln in lines if ln.startswith("final checkpoint at step ")]
    saved = int(final.rsplit(" ", 1)[1])
    assert saved >= int(reports[-1]["steps"])
    again, codes = run_slice(env, "steps=", count=1)
    assert codes == [0, 0], again
    assert f"resumed from step {saved} in {tmp_path / 'ckpt'}" in again
    steps = [int(ln.split()[0].split("=")[1]) for ln in again if ln.startswith("steps=")]
    assert steps and steps[-1] > saved
