"""The port's single-device transformer (k8s_gpu_hpa_tpu_torch/models/
transformer.py) against the JAX package's, on the JAX parameters carried
over with ``params_from_jax``.

f32 holds the algorithm: prefill and decode logits and the KV cache agree to
2e-4, the bar of the JAX package's own transformer tests.  bf16 holds the
serving dtype, where the port's products round to bf16 where JAX's keep an
fp32 result (the module's note), at 0.06 absolute, the JAX bf16 attention
bar.  The port's cache is head-major; the tests permute it into JAX's
layout to compare."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.models import transformer as jt
from k8s_gpu_hpa_tpu_torch.models import transformer as pt
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import flash_shape_supported
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

F32_TOL = 2e-4
BF16_TOL = 0.06

SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=64)
#: head_dim 128 and a 64-token prompt: inside the flash kernel's envelope
FLASH = dict(d_model=256, n_heads=2, n_layers=2, d_ff=512, max_seq=128)
#: head_dim 256, the width of D_MODEL=2048 N_HEADS=8 cut to two heads
FLASH_D256 = dict(d_model=512, n_heads=2, n_layers=2, d_ff=1024, max_seq=128)
#: head_dim 512, the width of D_MODEL=2048 N_HEADS=4 cut to two heads (the
#: chunked kernels on the card)
FLASH_D512 = dict(d_model=1024, n_heads=2, n_layers=2, d_ff=2048, max_seq=128)
#: head_dim 1024, the width of D_MODEL=2048 N_HEADS=2 cut to one head (the
#: streamed kernels' width on the card in bf16 and f16)
FLASH_D1024 = dict(d_model=1024, n_heads=1, n_layers=2, d_ff=2048, max_seq=128)


def _models(sizes, jdtype, tdtype, seed=0):
    jcfg = jt.TransformerConfig(**sizes, dtype=jdtype)
    pcfg = pt.TransformerConfig(**sizes, dtype=tdtype)
    params = jax.jit(jt.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, pcfg, params, pt.params_from_jax(params_np, pcfg)


def _jax_prefill(params, jcfg, prompt):
    fn = jax.jit(lambda p, t, c: jt.prefill(p, jcfg, t, c))
    return fn(params, jnp.asarray(prompt), jt.init_kv_cache(jcfg, prompt.shape[0]))


def _jax_decode(jcfg):
    return jax.jit(lambda p, t, c, pos: jt.decode_step(p, jcfg, t, c, pos))


def _prompt(batch, plen, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, plen)).astype(np.int32)


def _jax_layout(cache_side: torch.Tensor) -> np.ndarray:
    """[layers, b, heads, seq, hd] -> JAX's [layers, b, seq, heads, hd]."""
    return cache_side.permute(0, 1, 3, 2, 4).float().numpy()


def test_params_from_jax_maps_every_leaf_one_to_one():
    jcfg, pcfg, params, ported = _models(SMALL, jnp.float32, torch.float32)
    assert set(ported) == set(params)
    assert [set(b) for b in ported["blocks"]] == [set(b) for b in params["blocks"]]
    for name in ("embed", "pos", "out_norm"):
        np.testing.assert_array_equal(ported[name].numpy(), np.asarray(params[name]))
    for got, want in zip(ported["blocks"], params["blocks"], strict=True):
        for name, leaf in want.items():
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(leaf))
    # the port's own init has the same structure, shapes and dtype
    own = pt.init_params(pcfg, torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in pt.param_leaves(own)] == [
        tuple(t.shape) for t in pt.param_leaves(ported)
    ]
    assert {t.dtype for t in pt.param_leaves(own)} == {torch.float32}


def test_f32_prefill_and_decode_match_jax():
    jcfg, pcfg, params, ported = _models(SMALL, jnp.float32, torch.float32)
    prompt = _prompt(2, 16)
    want_logits, want_cache = _jax_prefill(params, jcfg, prompt)
    got_logits, cache = pt.prefill(
        ported, pcfg, torch.from_numpy(prompt).long(), pt.init_kv_cache(pcfg, 2)
    )
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=F32_TOL, atol=F32_TOL)
    for side in ("k", "v"):
        np.testing.assert_allclose(
            _jax_layout(cache[side]), np.asarray(want_cache[side]), rtol=F32_TOL, atol=F32_TOL
        )
    tokens = np.random.default_rng(2).integers(0, 256, (2,)).astype(np.int32)
    step = _jax_decode(jcfg)
    for pos in (16, 17, 40, 63):
        want_logits, want_cache = step(params, jnp.asarray(tokens), want_cache, jnp.int32(pos))
        got_logits, cache = pt.decode_step(
            ported, pcfg, torch.from_numpy(tokens).long(), cache, torch.tensor(pos)
        )
        np.testing.assert_allclose(
            got_logits.numpy(), np.asarray(want_logits), rtol=F32_TOL, atol=F32_TOL,
            err_msg=f"position {pos}",
        )
        tokens = np.asarray(jnp.argmax(want_logits, axis=-1)).astype(np.int32)
    for side in ("k", "v"):
        np.testing.assert_allclose(
            _jax_layout(cache[side]), np.asarray(want_cache[side]), rtol=F32_TOL, atol=F32_TOL
        )


def _stepwise(ported, pcfg, prompt):
    cache = pt.init_kv_cache(pcfg, prompt.shape[0])
    for pos in range(prompt.shape[1]):
        logits, cache = pt.decode_step(ported, pcfg, torch.from_numpy(prompt[:, pos]).long(), cache, pos)
    return logits, cache


def test_prefill_equals_stepwise_decode():
    """The identity the JAX package pins (tests/test_transformer.py): one
    prefill pass equals feeding the prompt through decode_step, logits and
    cache; the cache beyond the prompt stays untouched."""
    _, pcfg, _, ported = _models(SMALL, jnp.float32, torch.float32)
    prompt = _prompt(2, 16)
    got_logits, got_cache = pt.prefill(
        ported, pcfg, torch.from_numpy(prompt).long(), pt.init_kv_cache(pcfg, 2)
    )
    want_logits, want_cache = _stepwise(ported, pcfg, prompt)
    torch.testing.assert_close(got_logits, want_logits, rtol=F32_TOL, atol=F32_TOL)
    for side in ("k", "v"):
        torch.testing.assert_close(
            got_cache[side][:, :, :, :16], want_cache[side][:, :, :, :16],
            rtol=F32_TOL, atol=F32_TOL,
        )
        assert not got_cache[side][:, :, :, 16:].any()


@pytest.mark.parametrize("sizes", [FLASH, FLASH_D256, FLASH_D512, FLASH_D1024],
                         ids=["d128", "d256", "d512", "d1024"])
def test_bf16_prefill_inside_the_flash_envelope_matches_jax_and_stepwise_decode(sizes):
    """2 heads of 128 (d_model 256), of 256 (d_model 512) or of 512 (d_model
    1024), or one of 1024 (d_model 1024), bf16, a 64-token prompt: the
    prefill takes the flash kernel's
    wrapper (its plain version on the CPU), and JAX's prefill takes its
    Pallas kernel in interpret mode; logits and cache within JAX's bf16
    bar, 0.06."""
    jcfg, pcfg, params, ported = _models(sizes, jnp.bfloat16, torch.bfloat16)
    assert flash_shape_supported(64, pcfg.head_dim, pcfg.dtype)
    prompt = _prompt(2, 64)
    want_logits, want_cache = _jax_prefill(params, jcfg, prompt)
    got_logits, cache = pt.prefill(
        ported, pcfg, torch.from_numpy(prompt).long(), pt.init_kv_cache(pcfg, 2)
    )
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=BF16_TOL)
    np.testing.assert_allclose(
        _jax_layout(cache["k"]), np.asarray(want_cache["k"], np.float32), rtol=0, atol=BF16_TOL
    )
    step_logits, step_cache = _stepwise(ported, pcfg, prompt)
    torch.testing.assert_close(got_logits, step_logits, rtol=0, atol=BF16_TOL)
    torch.testing.assert_close(
        cache["v"][:, :, :, :64].float(), step_cache["v"][:, :, :, :64].float(),
        rtol=0, atol=BF16_TOL,
    )


@pytest.mark.parametrize("sizes", [FLASH, FLASH_D256, FLASH_D512], ids=["d128", "d256", "d512"])
def test_f32_prefill_inside_the_flash_envelope_matches_jax(monkeypatch, sizes):
    """The serving slice in f32 inside the flash envelope (2 heads of 128,
    of 256 or of 512, the last the streamed FFMA kernels' width on the
    card; a 64-token prompt), from the JAX weights carried over: the
    prefill takes the kernel's wrapper once a layer (its plain version on
    the CPU), where it took ``reference_attention`` while the kernels were
    bf16 only, and JAX's prefill its Pallas kernel in interpret mode.  The
    logits and the cache agree at the f32 bar, 2e-4."""
    from k8s_gpu_hpa_tpu_torch.ops import flash_attention as fa

    jcfg, pcfg, params, ported = _models(sizes, jnp.float32, torch.float32)
    assert flash_shape_supported(64, pcfg.head_dim, pcfg.dtype)
    calls = []
    kernel = fa.flash_attention_kernel
    monkeypatch.setattr(fa, "flash_attention_kernel",
                        lambda *args, **kw: calls.append(1) or kernel(*args, **kw))
    prompt = _prompt(2, 64)
    want_logits, want_cache = _jax_prefill(params, jcfg, prompt)
    got_logits, cache = pt.prefill(
        ported, pcfg, torch.from_numpy(prompt).long(), pt.init_kv_cache(pcfg, 2)
    )
    assert len(calls) == pcfg.n_layers
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=F32_TOL, atol=F32_TOL)
    for side in ("k", "v"):
        np.testing.assert_allclose(
            _jax_layout(cache[side]), np.asarray(want_cache[side]), rtol=F32_TOL, atol=F32_TOL
        )


@pytest.mark.parametrize("pos", [0, 7])
def test_bf16_decode_step_matches_jax(pos):
    jcfg, pcfg, params, ported = _models(SMALL, jnp.bfloat16, torch.bfloat16)
    tokens = _prompt(2, 1)[:, 0]
    want, _ = _jax_decode(jcfg)(
        params, jnp.asarray(tokens), jt.init_kv_cache(jcfg, 2), jnp.int32(pos)
    )
    got, _ = pt.decode_step(ported, pcfg, torch.from_numpy(tokens).long(), pt.init_kv_cache(pcfg, 2), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BF16_TOL)


def test_decode_position_may_be_a_tensor_and_writes_in_place():
    _, pcfg, _, ported = _models(SMALL, jnp.float32, torch.float32)
    tokens = torch.tensor([3, 9])
    a, cache_a = pt.decode_step(ported, pcfg, tokens, pt.init_kv_cache(pcfg, 2), 5)
    cache = pt.init_kv_cache(pcfg, 2)
    b, cache_b = pt.decode_step(ported, pcfg, tokens, cache, torch.tensor(5))
    assert cache_b is cache  # in place
    assert torch.equal(a, b) and torch.equal(cache_a["k"], cache_b["k"])
    written = cache_b["k"].abs().sum(dim=(0, 1, 2, 4))
    assert written.nonzero().flatten().tolist() == [5]


def test_mlp_block_matches_jax_with_the_tanh_gelu():
    """jax.nn.gelu defaults to the tanh approximation: the port's MLP equals
    JAX's to 1e-5 in f32, while the erf GELU would miss by far more."""
    jcfg, pcfg, params, ported = _models(SMALL, jnp.float32, torch.float32)
    x = np.random.default_rng(4).standard_normal((2, 8, 64), dtype=np.float32) * 3
    blk = params["blocks"][0]
    h = jt._rmsnorm(jnp.asarray(x), blk["mlp_norm"])
    want = np.asarray(jnp.asarray(x) + jax.nn.gelu(h @ blk["w1"]) @ blk["w2"])
    got = pt._mlp(torch.from_numpy(x), ported["blocks"][0], pcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = np.asarray(jnp.asarray(x) + jax.nn.gelu(h @ blk["w1"], approximate=False) @ blk["w2"])
    assert np.abs(erf - want).max() > 1e-4
