"""The streamed instantiations of the flash kernels (forward, dQ and dK/dV;
head_dim 640 and up in the wgmma sources, built as bf16 and as f16, and 384
and up in the f32 FFMA sources) run on the CPU in the lockstep simulator of
tests/test_torch_kernel_sim.py, whose helpers build and drive them, and held
against their plain versions at that file's bars.

The streamed tilings hold no whole row of a tile: each CTA owns 128 of its
output's columns and sums the score products over the head_dim in a runtime
loop of 128-column chunks, which the wgmma kernels stream in pairs through a
ring of four stages beside a two-stage ring of the owned columns.  The
shapes: head_dim 640 (five chunks) and 1024 (eight) in bf16 and f16, 384
and 640 in f32; causal and not; one head, and two batches of two heads
(the 4-D tensor maps and strides of fused QKV views); and seq 320 causal,
five 64-row tiles a side, which wraps the two-stage rings twice.  Planted
faults: a score product that drops its last head_dim chunk fails the
simulation, in the wgmma forward, the wgmma backward and the f32 backward.  Run it alone
with ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernel_sim_streamed.py
-n 3``."""

import pytest

from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_kernel_sim import _assert_within, _build, _planted, _run

# (batch, seq, heads, head_dim, causal, the forward's consumer warpgroups a
# CTA: one, the streamed tiling's only)
WGMMA_SHAPES = [(1, 128, 1, 640, 1, 1), (1, 192, 1, 640, 0, 1), (2, 128, 2, 640, 0, 1),
                (1, 320, 1, 640, 1, 1), (1, 128, 1, 1024, 1, 1), (1, 192, 1, 1024, 0, 1)]
F16_SHAPES = [(1, 192, 1, 640, 1, 1), (1, 128, 1, 1024, 0, 1), (1, 192, 1, 1024, 1, 1)]
F32_SHAPES = [(1, 128, 1, 384, 1, 1), (1, 192, 1, 384, 0, 1), (2, 128, 2, 384, 1, 1),
              (1, 128, 1, 640, 0, 1), (1, 192, 1, 640, 1, 1), (1, 320, 1, 384, 1, 1)]


def _ids(shape) -> str:
    return "b{}s{}h{}d{}c{}".format(*shape[:5])


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each dtype's library, built at its first use."""
    built = {}

    def lib(dtype: str):
        if dtype not in built:
            built[dtype] = _build(tmp_path_factory.mktemp(f"streamed_{dtype}"), dtype=dtype)
        return built[dtype]

    return lib


@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=_ids)
def test_bf16_streamed_kernels_match_the_plain_versions(libs, shape):
    _assert_within(_run(libs("bf16"), shape), "bf16")


@pytest.mark.parametrize("shape", F16_SHAPES, ids=_ids)
def test_f16_streamed_kernels_match_the_plain_versions(libs, shape):
    """The wgmma sources built as f16, at the bf16 bars."""
    _assert_within(_run(libs("f16"), shape, dtype="f16"), "f16")


@pytest.mark.parametrize("shape", F32_SHAPES, ids=_ids)
def test_f32_streamed_kernels_match_the_plain_versions(libs, shape):
    """The FFMA sources' streamed tiling, at the JAX package's f32 bars."""
    _assert_within(_run(libs("f32"), shape, dtype="f32"), "f32")


def test_the_simulation_catches_a_forward_dropping_its_last_chunk(tmp_path):
    """A planted fault: the streamed forward's producer loading Q's last
    128-column chunk from past the head_dim, where the tensor map reads
    zeros, so the score product drops that chunk (its pair still loaded and
    consumed, so the rings stay in step).  The output and the logsumexp
    leave their bars."""
    right = "tma_load_4d(pair + x * kBoxBytes, &p.q, &full[st], c * C::kDc + x * kBox, h, q0, b);"
    plant = _planted("flash_attention.cu", right, right.replace(
        "c * C::kDc + x * kBox", "(c == chunks - 1 ? p.head_dim : c * C::kDc) + x * kBox"))
    err = _run(_build(tmp_path, plant), (1, 128, 1, 640, 1, 1))
    assert err["o_bar"] > 1.0 and err["lse"] > 1e-4, err


def test_the_simulation_catches_a_backward_dropping_its_last_chunk(tmp_path):
    """The same fault in the streamed backward's producer: the A operand of
    each score product (dQ: Q and dO; dK/dV: K and V) read from past the
    head_dim in its last chunk.  dQ, dK and dV leave their bars; the
    forward stays right."""
    right = "load_chunk(pair, a[g], &sm.full[st], c * C::kDc, h, own_row, b);"
    plant = _planted("flash_attention_bwd.cu", right, right.replace(
        "c * C::kDc", "c == chunks - 1 ? p.head_dim : c * C::kDc"))
    err = _run(_build(tmp_path, plant), (1, 128, 1, 640, 1, 1))
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] > 1.0, (name, err)


def test_the_simulation_catches_an_f32_backward_dropping_its_last_chunk(tmp_path):
    """A planted fault: the f32 streamed backward's score products summing
    every chunk but the head_dim's last.  dQ, dK and dV leave their bars; the
    forward stays right."""
    right = "for (int k = 0; k < cta.chunks; ++k) {"
    plant = _planted("flash_attention_bwd_f32.cu", right,
                     right.replace("k < cta.chunks", "k < cta.chunks - 1"))
    err = _run(_build(tmp_path, plant, "f32"), (1, 128, 1, 384, 1, 1), dtype="f32")
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] > 1.0, (name, err)
