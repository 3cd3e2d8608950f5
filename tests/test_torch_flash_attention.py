"""The port's flash attention (k8s_gpu_hpa_tpu_torch/ops/flash_attention.py)
against the JAX package's, whose Pallas kernel runs in interpret mode on the
CPU as its own tests run it (tests/test_flash_attention.py).

On the CPU the kernel's wrapper computes its plain version; the CUDA kernel
is held against that plain version on the card by chip_smoke.py.  Inputs are
made with numpy from a seed and handed to both.  The bars are the JAX
tests': 2e-3 in f32 (the two sides sum in other orders and the Pallas
kernel blocks its softmax), 0.06 in bf16 and f16 (each side rounds P to the
operand dtype before P V at other points of its blocking)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.ops.flash_attention import _flash_bhsd
from k8s_gpu_hpa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from k8s_gpu_hpa_tpu.ops.ring_attention import reference_attention as jax_reference_attention
from k8s_gpu_hpa_tpu_torch.ops import flash_attention as fa
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
    """f32 lies inside the Hopper kernels' envelope (the FFMA kernel), so the
    dispatcher takes the kernel's wrapper, whose plain version runs on the
    CPU; called directly, the wrapper is held to the same bar."""
    q, k, v = _qkv()
    assert flash_attention_supported(_torch(q)[0])
    want = np.asarray(jax_flash_attention(*_jax(q, k, v), causal=causal, block_q=64, block_k=64))
    got = flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    plain = flash_attention_kernel(*_torch(q, k, v), causal)
    np.testing.assert_allclose(plain.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("head_dim", [384, 512, 640], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("causal", [False, True])
def test_f32_streamed_widths_match_jax_flash(causal, head_dim):
    """f32 at the streamed kernels' widths, where the dispatcher took
    ``reference_attention`` before they existed: it takes the kernel's
    wrapper (its plain version on the CPU), within JAX's f32 bar of JAX's
    Pallas kernel."""
    q, k, v = _qkv(seq=128, head_dim=head_dim, seed=23)
    assert flash_attention_supported(_torch(q)[0])
    want = np.asarray(jax_flash_attention(*_jax(q, k, v), causal=causal, block_q=64, block_k=64))
    got = flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


#: the sweep's grid: JAX's envelope is head_dim % 128 == 0, a sequence a
#: 64-aligned block divides, and a K/V stripe of at most 12 MiB
SWEEP_SEQS = (64, 192, 512, 2048, 6144, 8192)
SWEEP_HEAD_DIMS = tuple(range(64, 2049, 64))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_the_envelope_contains_jaxs(dtype):
    """Every shape of the grid that JAX's ``flash_shape_supported`` takes,
    the port's takes too, in each dtype: so no shape on which JAX's
    training step or dispatcher runs its Pallas kernel sends the port to
    ``reference_attention`` or its training step to ring attention.  Past
    it the port adds head_dim 64 and sequences past the stripe cap."""
    from k8s_gpu_hpa_tpu.ops.flash_attention import flash_shape_supported as jax_supported

    accepted = [(s, d) for s in SWEEP_SEQS for d in SWEEP_HEAD_DIMS
                if jax_supported(s, d, getattr(jnp, dtype))]
    assert len(accepted) > 20  # the grid reaches into JAX's envelope
    assert max(d for _, d in accepted) == 2048
    missing = [(s, d) for s, d in accepted
               if not flash_shape_supported(s, d, getattr(torch, dtype))]
    assert not missing, missing


def test_causal_with_uneven_jax_blocks():
    """block_q != block_k drives the JAX kernel's skip bound
    ceil((iq+1)*bq / bk); the port's result does not depend on the blocks."""
    q, k, v = _qkv(seq=256)
    want = np.asarray(jax_flash_attention(*_jax(q, k, v), causal=True, block_q=64, block_k=128))
    got = flash_attention_kernel(*_torch(q, k, v), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("head_dim", [128, 256, 384, 512, 640, 1024], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_flash(causal, head_dim):
    """bf16, inside the envelope: the dispatcher takes the kernel's wrapper,
    which on the CPU computes the plain version; JAX's Pallas kernel takes
    head_dim 128 to 1024 alike (384 and 512 the chunked kernels' widths on
    the card, 640 and 1024 the streamed ones'), at JAX's bf16 bar, 0.06."""
    q, k, v = _qkv(seq=128, head_dim=head_dim)
    assert flash_attention_supported(_torch(q, dtype=torch.bfloat16)[0])
    want = jax_flash_attention(
        *_jax(q, k, v, dtype=jnp.bfloat16), causal=causal, block_q=64, block_k=64
    )
    got = flash_attention(*_torch(q, k, v, dtype=torch.bfloat16), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL, atol=BF16_TOL
    )


@pytest.mark.parametrize("head_dim", [128, 256, 384, 512, 640, 1024], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("causal", [False, True])
def test_f16_matches_jax_flash(causal, head_dim):
    """f16, inside the envelope (the wgmma kernel built as f16): the
    dispatcher takes the kernel's wrapper, its plain version on the CPU,
    against JAX's Pallas kernel in interpret mode at f16, at the bf16 bar:
    each side rounds P to f16 at other points of its blocking."""
    q, k, v = _qkv(seq=128, head_dim=head_dim, seed=13)
    tq, tk, tv = _torch(q, k, v, dtype=torch.float16)
    assert flash_attention_supported(tq)
    want = jax_flash_attention(
        *_jax(q, k, v, dtype=jnp.float16), causal=causal, block_q=64, block_k=64
    )
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL, atol=BF16_TOL
    )


@pytest.mark.parametrize("head_dim", [128, 256, 384, 512, 640, 1024], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("causal", [False, True])
def test_f16_with_lse_matches_jax_flash_bhsd(causal, head_dim):
    """The training forward's residual in f16: the output at the bf16 bar;
    the logsumexp is fp32 on both sides, from the same f16 scores: 1e-4."""
    q, k, v = (x.reshape(4, 128, head_dim)
               for x in _qkv(batch=2, seq=128, heads=2, head_dim=head_dim, seed=17))
    want_o, want_lse = _flash_bhsd(*_jax(q, k, v, dtype=jnp.float16), causal, 64, 64,
                                   with_lse=True)
    got_o, got_lse = flash_attention_kernel(*_torch(q, k, v, dtype=torch.float16), causal,
                                            with_lse=True)
    assert got_o.dtype == torch.float16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-4)


@pytest.mark.parametrize("head_dim", [384, 512, 640, 1024], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_with_lse_matches_jax_flash_bhsd(causal, head_dim):
    """The training forward's residual in bf16 at the chunked and the
    streamed kernels' widths: the output at JAX's bf16 bar, 0.06; the
    logsumexp is fp32 on both sides, from the same bf16 scores: 1e-4."""
    q, k, v = (x.reshape(4, 128, head_dim)
               for x in _qkv(batch=2, seq=128, heads=2, head_dim=head_dim, seed=19))
    want_o, want_lse = _flash_bhsd(*_jax(q, k, v, dtype=jnp.bfloat16), causal, 64, 64,
                                   with_lse=True)
    got_o, got_lse = flash_attention_kernel(*_torch(q, k, v, dtype=torch.bfloat16), causal,
                                            with_lse=True)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-4)


@pytest.mark.parametrize("head_dim", [64, 128, 256, 384, 512, 640], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_matches_jax_flash_bhsd(causal, head_dim):
    """The training forward's residual in f32: [b*h, s, d] in, (o, lse
    [b*h, s, 1] f32) out, at the fixed kernels' head_dims and the streamed
    ones' 384, 512 and 640.  The logsumexp is a sum of exponentials, an f32
    reduction in two orders: 1e-4 absolute."""
    q, k, v = (x.reshape(4, 128, head_dim)
               for x in _qkv(batch=2, seq=128, heads=2, head_dim=head_dim))
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
    # the kernels take bf16, f16 (wgmma) and f32 (FFMA) at head_dim 64-256
    for dtype in (bf16, torch.float16, torch.float32):
        assert all(flash_shape_supported(512, d, dtype) for d in (64, 128, 256))
    assert not flash_shape_supported(512, 128, torch.float64)  # no kernel of that dtype
    # head_dim 256 (D_MODEL=2048 N_HEADS=8) at every positive multiple of the tile
    assert all(flash_shape_supported(64 * n, 256, bf16) for n in range(1, 385))
    # 384 and 512 (D_MODEL=1536 and 2048 in N_HEADS=4) in every dtype: the
    # chunked wgmma kernels in bf16 and f16, f32's streamed FFMA kernels
    for d in (384, 512):
        assert flash_shape_supported(512, d, bf16) and flash_shape_supported(512, d, torch.float16)
        assert all(flash_shape_supported(64 * n, d, bf16) for n in range(1, 65))
        assert flash_shape_supported(512, d, torch.float32)
        assert fa.streamed(d, torch.float32) and not fa.streamed(d, bf16)
    # from 640 on every multiple of 128 in every dtype, with no upper width:
    # the streamed kernels (D_MODEL=2048 N_HEADS=2 is head_dim 1024)
    for dtype in (bf16, torch.float16, torch.float32):
        assert all(flash_shape_supported(512, d, dtype) for d in range(640, 4097, 128))
        assert not any(flash_shape_supported(512, d, dtype) for d in range(576, 4097, 128))
    assert not flash_shape_supported(512, 320, torch.float32)  # f32: 64, 128, 256, then 384 on
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


def test_cpu_path_ignores_the_tiling(monkeypatch):
    """The consumer warpgroups a CTA are the CUDA kernel's choice; the
    plain version has none, so a CPU call never asks for it."""

    def refuse(*args):
        raise AssertionError("the CPU path chose a kernel tiling")

    monkeypatch.setattr(fa, "fwd_split", refuse)
    q, k, v = _torch(*_qkv(seq=128), dtype=torch.bfloat16)
    want = flash_attention_reference(q, k, v, True)
    assert torch.equal(flash_attention_kernel(q, k, v, True), want)


@pytest.mark.parametrize(
    "batch_heads, seq, sms, head_dim, want",
    [
        (4, 2048, 132, 128, 2),  # the llm training shape: 128 CTAs, two warpgroups each
        (32, 512, 132, 128, 1),  # the serve prefill: 256 CTAs, two an SM
        (16, 4096, 132, 128, 1),  # the long timed shape: 1,024 CTAs
        (66, 128, 132, 128, 2),  # exactly one CTA an SM
        (67, 128, 132, 128, 1),
        (33, 256, 132, 128, 2),
        (34, 256, 132, 128, 1),
        (2, 192, 2, 128, 1),  # the simulator's two SMs
        (1, 256, 4, 128, 2),
        (1, 128, 4, 128, 2),
        (2, 4096, 132, 64, 2),  # head_dim 64 as 128
        # head_dim 256 has one warpgroup a CTA, whatever the grid: the llm
        # shape at D_MODEL=2048 (256 CTAs), its prefill (512), a grid that
        # would take two at 128 (4 CTAs), the simulator's
        (8, 2048, 132, 256, 1),
        (64, 512, 132, 256, 1),
        (1, 256, 132, 256, 1),
        (2, 192, 2, 256, 1),
        # so have 384 and 512: the llm shape and the prefill at D_MODEL=1536
        # and 2048 in N_HEADS=4, and a grid of 4 CTAs
        (4, 2048, 132, 384, 1),
        (32, 512, 132, 384, 1),
        (4, 2048, 132, 512, 1),
        (32, 512, 132, 512, 1),
        (1, 256, 132, 512, 1),
    ],
)
def test_forward_tiling_keeps_the_card_busy(batch_heads, seq, sms, head_dim, want):
    assert fa.fwd_split(batch_heads, seq, sms, head_dim) == want
    assert want in fa.fwd_splits(head_dim)


def test_forward_instantiations_by_head_dim():
    """Two tilings at head_dim 64 and 128, one at 256, 384 and 512 (a 64-row
    tile is 32 KB or more: two warpgroups' ring and hand-over pass an SM's
    shared memory), in bf16 and f16 alike (one source, two builds); the f32
    kernel has one tiling at each of its head_dims, 64 to 256, so its split
    is 1 whatever the grid.  Past those, the streamed tiling (from 640 in
    bf16 and f16, from 384 in f32) is one instantiation of one split at
    every multiple of 128."""
    for dtype in (torch.bfloat16, torch.float16):
        assert fa.HEAD_DIMS[dtype] == (64, 128, 256, 384, 512)
        assert [fa.fwd_splits(d, dtype) for d in fa.HEAD_DIMS[dtype]] == [
            (1, 2), (1, 2), (1,), (1,), (1,)]
        assert fa.STREAMED_FROM[dtype] == 640
    assert fa.HEAD_DIMS[torch.float32] == (64, 128, 256)
    assert [fa.fwd_splits(d, torch.float32) for d in fa.HEAD_DIMS[torch.float32]] == [
        (1,), (1,), (1,)]
    assert fa.STREAMED_FROM[torch.float32] == 384 and fa.STREAMED_COLS == 128
    for dtype, first in fa.STREAMED_FROM.items():
        for d in range(first, 2049, 128):
            assert fa.streamed(d, dtype) and fa.head_dim_supported(d, dtype)
            assert fa.fwd_splits(d, dtype) == (1,)
        assert not fa.streamed(first - 128, dtype)
    assert fa.fwd_split(4, 2048, 132, 128, torch.float32) == 1
    assert fa.fwd_split(4, 2048, 132, 128, torch.float16) == 2


def test_each_dtype_builds_a_library_of_its_own(monkeypatch):
    """bf16 and f16 build the wgmma source, f16 with ELEM_F16; f32 builds
    the FFMA source; each into a library named for its dtype, with the
    headers its source includes."""
    calls = []
    monkeypatch.setattr(fa, "build_shared", lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "nvcc", lambda: "nvcc")
    for lib in (fa._FWD, fa._BWD):
        for dtype in fa.DTYPES:
            lib.build(dtype)
    names = [name for name, *_ in calls]
    assert names == ["libflash_attention_bf16.so", "libflash_attention_f16.so",
                     "libflash_attention_f32.so", "libflash_attention_bwd_bf16.so",
                     "libflash_attention_bwd_f16.so", "libflash_attention_bwd_f32.so"]
    sources = [srcs[0] for _, srcs, *_ in calls]
    assert sources == [fa.SOURCE, fa.SOURCE, fa.F32_SOURCE,
                       fa.BWD_SOURCE, fa.BWD_SOURCE, fa.BWD_F32_SOURCE]
    assert ["-DELEM_F16" in cmd for _, _, cmd, _ in calls] == [False, True, False] * 2
    assert [hdrs for *_, hdrs in calls] == [fa.HEADERS, fa.HEADERS, fa.F32_HEADERS] * 2


def test_f32_sources_are_ffma_with_every_head_dim():
    """The f32 forward and backward multiply on the CUDA cores (no wgmma, TMA
    or mbarrier); the forward includes only the FFMA tile header, the
    backward that and the PTX layer, for its clusters' barrier and loads
    from a peer's shared memory, and ``F32_HEADERS`` names what they
    include (the PTX layer's element type with it).  Each opts in and
    launches every fixed head_dim of each kernel and the streamed
    instantiations, the backward its cluster instantiations too, whose
    head_dim is an argument."""
    for source, headers, launched, streamed in (
            (fa.F32_SOURCE, {"ffma_tiles.cuh"}, ("launch<{d}>(",),
             ("flash_fwd_f32_streamed_kernel<<<",)),
            (fa.BWD_F32_SOURCE, {"ffma_tiles.cuh", "hopper_ptx.cuh"},
             ("launch<{d}, true>(", "launch<{d}, false>("),
             ("flash_bwd_dq_f32_streamed_kernel<<<", "flash_bwd_dkv_f32_streamed_kernel<<<"))):
        code = "\n".join(line.split("//")[0] for line in source.read_text().splitlines())
        for gone in ("wgmma", "tma_load", "mbar_"):
            assert gone not in code, (source.name, gone)
        assert "fmaf(" in (fa.CSRC / "ffma_tiles.cuh").read_text()
        included = set(re.findall(r'#include "([^"]+)"', code))
        assert included == headers, source.name
        assert {fa.CSRC / name for name in included} <= set(fa.F32_HEADERS)
        for d in fa.HEAD_DIMS[torch.float32]:
            assert all(form.format(d=d) in code for form in launched), (source.name, d)
            assert f"opt_in<{d}>()" in code or f"opt_in_both<{d}>()" in code
        for launch in streamed:
            kernel = launch.removesuffix("<<<")
            assert launch in code and f"cudaFuncSetAttribute({kernel}" in code.replace(
                "reinterpret_cast<const void*>(", "cudaFuncSetAttribute("), (source.name, kernel)
        assert "p.head_dim / kF32ChunkCols" in code
    for kernel in ("flash_bwd_dq_f32_cluster_kernel", "flash_bwd_dkv_f32_cluster_kernel"):
        assert f"cudaLaunchKernelEx(&cl.cfg, {kernel}, p)" in code, kernel
        assert f"cudaFuncSetAttribute({kernel}" in code, kernel
    assert '#include "elem.cuh"' in (fa.CSRC / "hopper_ptx.cuh").read_text()
    assert set(fa.F32_HEADERS) == {
        fa.CSRC / name for name in ("ffma_tiles.cuh", "hopper_ptx.cuh", "elem.cuh")}


class _FakeCuda:
    """Stands in for a CUDA tensor in a check that reads only its
    attributes: a CUDA tensor cannot be made on this host."""

    def __init__(self, dtype, shape=(1, 128, 2, 128)):
        self.dtype, self.shape, self.ndim, self.is_cuda = dtype, shape, len(shape), True
        self.device = torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32], ids=str)
def test_a_cuda_operand_of_another_dtype_raises(dtype):
    """On a CUDA tensor of a dtype no kernel takes, the wrappers' check
    raises; nothing falls back to the plain version."""
    with pytest.raises(TypeError, match="operands of one of"):
        fa._check("flash_attention_kernel", (_FakeCuda(dtype),) * 3)
    mixed = (_FakeCuda(torch.float16), _FakeCuda(torch.float32), _FakeCuda(torch.float16))
    with pytest.raises(TypeError, match="operands of one of"):
        fa._check("flash_attention_kernel", mixed)


def test_a_cuda_f32_operand_past_head_dim_256_raises():
    """A CUDA operand of a head_dim no kernel of its dtype takes raises in
    the wrappers' check, and nothing falls back to the plain version: f32 at
    320 (its kernels take 64, 128, 256, then every multiple of 128 from 384
    on, where 384 and 512 pass that test as in bf16 and f16), and past 512 a
    head_dim that is not a multiple of the streamed tilings' 128 columns in
    every dtype.  The check reads the tensor's attributes alone, so it runs
    on this host."""
    for d in (384, 512):
        for dtype in fa.DTYPES:
            try:
                fa._check("flash_attention_kernel", (_FakeCuda(dtype, (1, 128, 2, d)),) * 3)
            except ValueError as e:
                assert "head_dim" not in str(e), (dtype, d, e)
            except AttributeError:
                pass  # past the head_dim check: the fake has no strides
    with pytest.raises(ValueError, match="head_dim"):
        fa._check("flash_attention_kernel", (_FakeCuda(torch.float32, (1, 128, 2, 320)),) * 3)
    for dtype in fa.DTYPES:
        with pytest.raises(ValueError, match="head_dim"):
            fa._check("flash_attention_kernel", (_FakeCuda(dtype, (1, 128, 2, 704)),) * 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.float32], ids=str)
def test_cpu_path_takes_the_plain_version_in_every_dtype(dtype):
    q, k, v = _torch(*_qkv(seq=64, head_dim=64), dtype=dtype)
    before = dict(flash_attention_kernel.launches_by_dtype)
    got = flash_attention_kernel(q, k, v, True)
    assert got.dtype == dtype and flash_attention_kernel.launches_by_dtype == before
    assert torch.equal(got, flash_attention_reference(q, k, v, True))


def _assert_wgmma_fed_by_tma(source, used: tuple[str, ...]) -> None:
    """``source`` issues the ``used`` wgmma and loads by TMA on mbarriers;
    the mma.sync, ldmatrix and cp.async path is gone, and the headers it
    includes rebuild it."""
    code = "\n".join(line.split("//")[0] for line in source.read_text().splitlines())
    for gone in ("mma_bf16", "mma_ptx", "ldmatrix", "cp_async"):
        assert gone not in code, gone
    for name in (*used, "mbar_wait", "mbar_arrive_expect_tx"):
        assert name in code, name
    included = set(re.findall(r'#include "([^"]+)"', code))
    assert {fa.CSRC / name for name in included} <= set(fa.HEADERS)


def test_forward_source_is_wgmma_fed_by_tma():
    """The forward's source issues wgmma for both products and loads by TMA
    on mbarriers; the mma.sync, ldmatrix and cp.async path is gone, and the
    headers it includes rebuild it.  Every instantiation, d256's among them,
    is opted in and launched, on the same wgmma products (P V at 256 as two
    of 128 columns; at 384 and 512 the scores as m64n32k16 products over
    32-row K tiles)."""
    _assert_wgmma_fed_by_tma(fa.SOURCE, ("wgmma_m64n64k16_ss", "wgmma_m64n32k16_ss",
                                         "wgmma_m64n128k16_rs", "wgmma_m64n64k16_rs",
                                         "tma_load_4d"))
    code = fa.SOURCE.read_text()
    for d in fa.HEAD_DIMS[torch.bfloat16]:
        for split in fa.fwd_splits(d):
            assert f"opt_in<{d}, {split}>()" in code and f"launch<{d}, {split}>(" in code
    for d in (256, 384, 512):
        assert f"opt_in<{d}, 2>" not in code and f"launch<{d}, 2>" not in code
    # the streamed tiling: one instantiation, head_dim an argument
    assert "cudaFuncSetAttribute(flash_fwd_streamed_kernel," in code
    assert "flash_fwd_streamed_kernel<<<" in code and "p.head_dim / C::kDc" in code


def test_backward_source_is_wgmma_fed_by_tma():
    """The backward's source issues every product as wgmma (S, dP and their
    transposes from shared memory, dQ, dK and dV with A from registers) and
    loads Q, K, V and dO by 4-D TMA and lse and delta by 2-D TMA on
    mbarriers; no source or header of the kernels has an mma.sync, ldmatrix
    or cp.async left."""
    _assert_wgmma_fed_by_tma(fa.BWD_SOURCE, ("wgmma_m64n64k16_ss", "wgmma_m64n32k16_ss",
                                             "wgmma_m64n128k16_rs", "wgmma_m64n64k16_rs",
                                             "tma_load_4d", "tma_load_2d", "setmaxnreg_inc"))
    code = fa.BWD_SOURCE.read_text()
    for d in fa.HEAD_DIMS[torch.bfloat16]:  # both kernels at every head_dim, 256's to 512's
        assert f"opt_in_both<{d}>()" in code
        assert f"launch<{d}, true>(" in code and f"launch<{d}, false>(" in code
    # d256's dK/dV splits dV and dK between its warpgroups, on the same wgmma
    assert "flash_bwd_dkv_kernel<256>(const __grid_constant__ Params p)" in code
    # the streamed tilings: one instantiation of each kernel, head_dim an argument
    for kernel in ("flash_bwd_dq_streamed_kernel", "flash_bwd_dkv_streamed_kernel"):
        assert f"opt_in({kernel}," in code and f"{kernel}<<<" in code
    for path in fa.CSRC.iterdir():
        text = path.read_text()
        for gone in ("mma.sync", "ldmatrix", "cp.async.ca", "cp.async.cg"):
            assert gone not in text, (path.name, gone)


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
