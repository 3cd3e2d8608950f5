"""The port's flash attention (k8s_gpu_hpa_tpu_torch/ops/flash_attention.py)
against the JAX package's, whose Pallas kernel runs in interpret mode on the
CPU as its own tests run it (tests/test_flash_attention.py).

On the CPU the kernel's wrapper computes its plain version; the CUDA kernel
is held against that plain version on the card by chip_smoke.py.  Inputs are
made with numpy from a seed and handed to both.  The bars are the JAX
tests': 2e-3 in f32 (the two sides sum in other orders and the Pallas
kernel blocks its softmax), 0.06 in bf16 (each side rounds P to bf16 before
P V at other points of its blocking)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.ops.flash_attention import _flash_bhsd
from k8s_gpu_hpa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from k8s_gpu_hpa_tpu.ops.ring_attention import reference_attention as jax_reference_attention
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_kernel,
    flash_attention_reference,
    flash_attention_supported,
    flash_shape_supported,
)
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import reference_attention
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

F32_TOL = 2e-3
BF16_TOL = 0.06


def _qkv(batch=1, seq=256, heads=2, head_dim=128, seed=11):
    rng = np.random.default_rng(seed)
    shape = (batch, seq, heads, head_dim)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(3))


def _torch(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _jax(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


@pytest.mark.parametrize("causal", [False, True])
def test_f32_matches_jax_flash(causal):
    """f32 lies outside the Hopper kernel's envelope, so the dispatcher takes
    the exact reference; the kernel's plain version is held to the same bar."""
    q, k, v = _qkv()
    want = np.asarray(jax_flash_attention(*_jax(q, k, v), causal=causal, block_q=64, block_k=64))
    got = flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    plain = flash_attention_kernel(*_torch(q, k, v), causal)
    np.testing.assert_allclose(plain.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_causal_with_uneven_jax_blocks():
    """block_q != block_k drives the JAX kernel's skip bound
    ceil((iq+1)*bq / bk); the port's result does not depend on the blocks."""
    q, k, v = _qkv(seq=256)
    want = np.asarray(jax_flash_attention(*_jax(q, k, v), causal=True, block_q=64, block_k=128))
    got = flash_attention_kernel(*_torch(q, k, v), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_flash(causal):
    """bf16, inside the envelope: the dispatcher takes the kernel's wrapper,
    which on the CPU computes the plain version."""
    q, k, v = _qkv(seq=128)
    assert flash_attention_supported(_torch(q, dtype=torch.bfloat16)[0])
    want = jax_flash_attention(
        *_jax(q, k, v, dtype=jnp.bfloat16), causal=causal, block_q=64, block_k=64
    )
    got = flash_attention(*_torch(q, k, v, dtype=torch.bfloat16), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL, atol=BF16_TOL
    )


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_matches_jax_flash_bhsd(causal):
    """The training forward's residual: [b*h, s, d] in, (o, lse [b*h, s, 1]
    f32) out.  The logsumexp is a sum of exponentials, an f32 reduction in
    two orders: 1e-4 absolute."""
    q, k, v = (x.reshape(4, 128, 64) for x in _qkv(batch=2, seq=128, heads=2, head_dim=64))
    want_o, want_lse = _flash_bhsd(*_jax(q, k, v), causal, 64, 64, with_lse=True)
    got_o, got_lse = flash_attention_kernel(*_torch(q, k, v), causal, with_lse=True)
    assert got_lse.shape == (4, 128, 1) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-4)


def test_strided_four_d_operands_equal_the_three_d_layout():
    """The transformer hands the kernel views of one fused QKV product; the
    plain version on [b, s, h, d] views equals it on [b*h, s, d] copies."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3 * 128), dtype=np.float32))
    q, k, v = (t.view(2, 64, 2, 64) for t in qkv.split(128, dim=-1))
    assert not q.is_contiguous()
    got, lse = flash_attention_kernel(q, k, v, True, with_lse=True)
    flat = [t.permute(0, 2, 1, 3).reshape(4, 64, 64) for t in (q, k, v)]
    want, want_lse = flash_attention_reference(*flat, True, with_lse=True)
    torch.testing.assert_close(got.permute(0, 2, 1, 3).reshape(4, 64, 64), want)
    torch.testing.assert_close(lse, want_lse)


def test_envelope():
    bf16 = torch.bfloat16
    assert flash_shape_supported(512, 128, bf16)  # the serve prefill's shape
    assert flash_shape_supported(192, 64, bf16)
    assert flash_shape_supported(64, 128, bf16, block_q=24, block_k=24)  # blocks change nothing
    assert not flash_shape_supported(512, 128, torch.float32)  # the kernel is bf16
    assert not flash_shape_supported(512, 256, bf16)
    assert not flash_shape_supported(512, 16, bf16)
    assert not flash_shape_supported(96, 128, bf16)  # not a multiple of the KV tile
    assert not flash_shape_supported(0, 128, bf16)
    # no stripe cap: the kernel streams K/V
    assert flash_shape_supported(65536, 128, bf16)
    assert not flash_attention_supported(torch.zeros(2, 64, 128, dtype=bf16))  # 3-D


def test_off_envelope_takes_the_reference_and_equals_jax():
    q, k, v = _qkv(seq=64, head_dim=16)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    assert not flash_attention_supported(tq)
    got = flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(got, reference_attention(tq, tk, tv, causal=True))
    want = jax_reference_attention(*_jax(q, k, v), causal=True)
    np.testing.assert_allclose(
        flash_attention(*_torch(q, k, v), causal=True).numpy(), np.asarray(want),
        rtol=1e-5, atol=1e-5,
    )
    # cross-attention (lk != lq) is off the envelope too
    kv = torch.from_numpy(_qkv(seq=128, head_dim=16, seed=3)[0])
    out = flash_attention(torch.from_numpy(q), kv, kv)
    assert torch.equal(out, reference_attention(torch.from_numpy(q), kv, kv))


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    q, k, v = _torch(*_qkv(seq=64), dtype=torch.bfloat16)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, True)
    assert flash_attention_kernel.launches == before
    assert torch.equal(got, flash_attention_reference(q, k, v, True))


@pytest.mark.parametrize(
    "shape, dtype",
    [((1, 128, 2, 128), torch.bfloat16), ((1, 100, 2, 128), torch.bfloat16),
     ((1, 128, 2, 128), torch.float32)],
)
def test_kernel_refuses_tensors_off_the_cpu_that_are_not_cuda(shape, dtype):
    """Only CPU tensors take the plain version; anything else is checked for
    the kernel and raises, never falls back."""
    q = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q, True)
