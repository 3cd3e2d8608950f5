"""The port's flash-attention backward (k8s_gpu_hpa_tpu_torch/ops/
flash_attention.py: ``flash_attention_bwd_reference``,
``flash_attention_bwd_kernel`` and the autograd Function ``FlashAttention``)
against the JAX package's Pallas backward, which runs in interpret mode on
the CPU as its own tests run it (tests/test_flash_attention.py).

On the CPU the wrappers compute their plain versions; the two CUDA kernels
are held against those plain versions on the card by chip_smoke.py.  Inputs
are made with numpy from a seed and handed to both packages.  The bar is the
JAX tests' gradient bar, 2e-4 in f32: both sides recompute P from the same
logsumexp and sum in fp32, in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.ops.flash_attention import _flash_bhsd, _flash_bhsd_bwd
from k8s_gpu_hpa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from k8s_gpu_hpa_tpu_torch.ops import flash_attention as fa
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd_kernel,
    flash_attention_bwd_reference,
    flash_attention_kernel,
    flash_attention_reference,
)

GRAD_TOL = 2e-4
BF16_TOL = 0.06

#: (seq, JAX block_q, JAX block_k): the JAX tests' even blocks, and uneven
#: ones that put the dQ upper and the dK/dV lower causal bounds on chunk
#: boundaries that do not coincide
BLOCKS = [(256, 128, 128), (384, 128, 64)]


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(n))


def _close(got, want, name, tol=GRAD_TOL):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=name
    )


@pytest.mark.parametrize("seq, block_q, block_k", BLOCKS)
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_the_pallas_kernels(seq, block_q, block_k, causal):
    """The same q, k, v, o, lse and dO through JAX ``_flash_bhsd_bwd`` (the
    dQ and dK/dV Pallas kernels) and the port's plain backward, on
    [b*h, s, d] operands."""
    q, k, v, do = _arrays((2, seq, 128), 4, seed=seq + causal)
    o, lse = _flash_bhsd(*(jnp.asarray(x) for x in (q, k, v)), causal, block_q, block_k, with_lse=True)
    want = _flash_bhsd_bwd(
        *(jnp.asarray(x) for x in (q, k, v)), o, lse, jnp.asarray(do), causal, block_q, block_k
    )
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = flash_attention_bwd_kernel(
        tq, tk, tv, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)), tdo, causal
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert g.shape == tq.shape and g.dtype == torch.float32
        _close(g, w, f"{name} seq={seq} causal={causal}")


@pytest.mark.parametrize("seq, block_q, block_k", BLOCKS)
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_vjp(seq, block_q, block_k, causal):
    """``FlashAttention.apply`` on [b, s, h, d] in f32 (its plain versions on
    the CPU) against ``jax.vjp`` through JAX ``flash_attention`` (the Pallas
    forward and backward under its custom VJP)."""
    q, k, v, do = _arrays((1, seq, 2, 128), 4, seed=7 * seq + causal)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    out, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, causal=causal, block_q=block_q, block_k=block_k),
        jq, jk, jv,
    )
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = FlashAttention.apply(tq, tk, tv, causal)
    _close(got_out.detach(), out, "out")
    got_out.backward(torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want, strict=True):
        _close(g, w, f"{name} seq={seq} causal={causal}")


def test_function_gradients_equal_autograd_through_the_plain_forward():
    """In f32 the plain backward is the exact gradient of the plain forward:
    the Function's gradients equal autograd's through
    ``flash_attention_reference``, on strided views of one fused QKV
    product as the transformer hands them over."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 128, 3 * 128), dtype=np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 128, 2, 64), dtype=np.float32))
    grads = []
    for fn in (
        lambda q, k, v: FlashAttention.apply(q, k, v, True),
        lambda q, k, v: flash_attention_reference(q, k, v, True),
    ):
        leaf = qkv.clone().requires_grad_()
        q, k, v = (t.view(2, 128, 2, 64) for t in leaf.split(128, dim=-1))
        fn(q, k, v).backward(do)
        grads.append(leaf.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_dispatcher_gradients_match_jax_vjp(causal):
    """bf16 inside the envelope: ``flash_attention`` takes the Function, and
    its gradients lie within the JAX bf16 attention bar of JAX's."""
    q, k, v, do = _arrays((1, 128, 2, 128), 4, seed=21 + causal)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, causal=causal, block_q=64, block_k=64),
        jq, jk, jv,
    )
    want = vjp(jnp.asarray(do).astype(jnp.bfloat16))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want, strict=True):
        assert g.dtype == torch.bfloat16
        _close(g, w, name, tol=BF16_TOL)


def test_forward_asks_for_the_logsumexp_only_when_a_gradient_is_needed(monkeypatch):
    calls = []
    real = fa.flash_attention_kernel

    def spy(q, k, v, causal, with_lse=False):
        calls.append(with_lse)
        return real(q, k, v, causal, with_lse)

    monkeypatch.setattr(fa, "flash_attention_kernel", spy)
    q = torch.randn(1, 64, 1, 64, dtype=torch.bfloat16)
    out = FlashAttention.apply(q, q, q, True)
    assert out.grad_fn is None and calls == [False]
    q.requires_grad_()
    with torch.no_grad():  # the dispatcher skips the Function
        assert flash_attention(q, q, q, causal=True).grad_fn is None
    assert calls == [False, False]
    out = flash_attention(q, q, q, causal=True)
    assert calls == [False, False, True]
    assert torch.equal(out, flash_attention_reference(q, q, q, True))


def test_backward_cpu_path_is_the_plain_version_and_launches_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _arrays((2, 64, 1, 64), 4, seed=5))
    o, lse = flash_attention_kernel(q, k, v, True, with_lse=True)
    before = (flash_attention_bwd_kernel.dq_launches, flash_attention_bwd_kernel.dkv_launches)
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do, True)
    assert (flash_attention_bwd_kernel.dq_launches, flash_attention_bwd_kernel.dkv_launches) == before
    for g, w in zip(got, flash_attention_bwd_reference(q, k, v, o, lse, do, True), strict=True):
        assert torch.equal(g, w) and g.is_contiguous()


def test_plain_backward_rounds_ds_and_p_to_the_operand_dtype():
    """bf16 operands: the plain backward's dQ is dS K with dS rounded to bf16
    before the product, as the Pallas kernel rounds it."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _arrays((1, 64, 64), 4, seed=9))
    o, lse = flash_attention_reference(q, k, v, False, with_lse=True)
    dq, _, dv = flash_attention_bwd_reference(q, k, v, o, lse, do, False)
    s = q.float() @ k.float().transpose(1, 2) / 8.0
    p = torch.exp(s - lse)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (do.float() @ v.float().transpose(1, 2) - delta) / 8.0
    assert torch.equal(dq, (ds.bfloat16().float() @ k.float()).bfloat16())
    assert torch.equal(dv, (p.bfloat16().float().transpose(1, 2) @ do.float()).bfloat16())


@pytest.mark.parametrize(
    "shape, dtype",
    [((1, 128, 2, 128), torch.bfloat16), ((1, 100, 2, 128), torch.bfloat16),
     ((1, 128, 2, 128), torch.float32)],
)
def test_backward_refuses_tensors_off_the_cpu_that_are_not_cuda(shape, dtype):
    """Only CPU tensors take the plain version; anything else is checked for
    the kernels and raises, never falls back."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    lse = torch.empty((shape[0] * shape[2], shape[1], 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_kernel(t, t, t, t, lse, t, True)
