"""The port's GEMM wrapper (k8s_gpu_hpa_tpu_torch/ops/matmul.py) against the
JAX package's Pallas matmul, run in interpret mode on the CPU as the JAX
package's own tests run it.

On the CPU the wrapper computes its plain version (fp32 accumulation, cast
to the input dtype); the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py.  Inputs are made with numpy from a
seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.ops.pallas_matmul import matmul as jax_matmul
from k8s_gpu_hpa_tpu.ops.pallas_matmul import matmul_pallas
from k8s_gpu_hpa_tpu_torch.ops import matmul as mm
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul, matmul_kernel, matmul_reference
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    return a, b


def test_f32_full_k_branch_matches_pallas():
    """256x384x128 with the default blocks: fullk stripes (the branch the
    load generator's 4096^2 shape takes).  The bar is the JAX package's own
    (tests/test_jax_workloads.py): rtol/atol 1e-3."""
    a, b = _operands(256, 384, 128)
    want = np.asarray(matmul_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_f32_k_grid_branch_matches_pallas():
    """The same product through the k-grid kernel (block_k=128): one
    Hopper kernel covers both Pallas branches, so both agree with it."""
    a, b = _operands(256, 384, 128, seed=1)
    want = np.asarray(
        matmul_pallas(jnp.asarray(a), jnp.asarray(b), block_m=128, block_n=128, block_k=128)
    )
    got = matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bf16_matches_pallas():
    """bf16 in, bf16 out.  Both sides sum in fp32 and round once to bf16;
    their fp32 sums differ only in summation order, so a result can land
    one bf16 ulp apart: rtol 2^-7 is one ulp at the bottom of a binade,
    atol 1e-3 covers values near zero where the order difference is all."""
    a32, b32 = _operands(256, 384, 128, seed=2)
    a = torch.from_numpy(a32).to(torch.bfloat16)
    b = torch.from_numpy(b32).to(torch.bfloat16)
    # the same bf16 values on both sides (exact: bf16 widens to f32)
    ja = jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(matmul_pallas(ja, jb).astype(jnp.float32))
    got = matmul(a, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-3)


def test_f16_matches_pallas():
    """f16 in, f16 out, against JAX's ``matmul`` (the Pallas kernel, which
    takes any dtype) at f16 on the same f16 values.  Both sides sum in fp32
    and round once to f16: rtol 2^-10 is one f16 ulp at the bottom of a
    binade, atol 1e-3 covers values near zero."""
    a32, b32 = _operands(256, 384, 128, seed=4)
    a = torch.from_numpy(a32).to(torch.float16)
    b = torch.from_numpy(b32).to(torch.float16)
    want = np.asarray(jax_matmul(jnp.asarray(a.float().numpy()).astype(jnp.float16),
                                 jnp.asarray(b.float().numpy()).astype(jnp.float16))
                      .astype(jnp.float32))
    got = matmul(a, b)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-10, atol=1e-3)


class _FakeCuda:
    """Stands in for a CUDA tensor in a check that reads only its
    attributes: a CUDA tensor cannot be made on this host."""

    def __init__(self, dtype, shape=(128, 128)):
        self.dtype, self.shape, self.ndim, self.is_cuda = dtype, shape, len(shape), True
        self.device = torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32], ids=str)
def test_a_cuda_operand_of_another_dtype_raises(dtype):
    """The GEMM's kernels take bf16, f16 and f32; a CUDA operand of another
    dtype, or two of different dtypes, raises and falls back to nothing."""
    with pytest.raises(TypeError, match="operands of one of"):
        mm._check(_FakeCuda(dtype), _FakeCuda(dtype))
    with pytest.raises(TypeError, match="operands of one of"):
        mm._check(_FakeCuda(torch.float16), _FakeCuda(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16], ids=str)
def test_cpu_path_takes_the_plain_version_in_every_dtype(dtype):
    a, b = (torch.from_numpy(x).to(dtype) for x in _operands(128, 128, 256, seed=5))
    before = dict(matmul_kernel.launches_by_dtype)
    got = matmul_kernel(a, b)
    assert got.dtype == dtype and matmul_kernel.launches_by_dtype == before
    assert torch.equal(got, matmul_reference(a, b))


def test_each_dtype_builds_a_library_of_its_own(monkeypatch):
    """bf16 and f16 build the wgmma source, f16 with ELEM_F16; f32 the FFMA
    source; each into a library named for its dtype."""
    calls = []
    monkeypatch.setattr(mm, "build_shared", lambda *args: calls.append(args))
    monkeypatch.setattr(mm, "nvcc", lambda: "nvcc")
    for dtype in mm.DTYPES:
        mm.build(dtype)
    assert [c[0] for c in calls] == ["libmatmul_bf16.so", "libmatmul_f16.so", "libmatmul_f32.so"]
    assert [c[1] for c in calls] == [[mm.SOURCE], [mm.SOURCE], [mm.F32_SOURCE]]
    assert ["-DELEM_F16" in c[2] for c in calls] == [False, True, False]
    assert [c[3] for c in calls] == [mm.HEADERS, mm.HEADERS, ()]


def test_unaligned_dispatch_matches_jax():
    """Dims that are not multiples of 128 go to the library product, as the
    JAX dispatcher sends them to jnp.dot."""
    a = np.ones((100, 50), np.float32)
    b = np.ones((50, 30), np.float32)
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    a, b = _operands(128, 256, 128, seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = matmul_kernel.launches
    got = matmul_kernel(ta, tb)
    assert matmul_kernel.launches == before  # the count is of kernel launches only
    assert torch.equal(got, matmul_reference(ta, tb))
    assert matmul(ta, tb, use_kernel=False).shape == (128, 128)


@pytest.mark.parametrize(
    "shape_a, shape_b",
    [((128, 256), (256, 128)), ((100, 128), (128, 128))],
)
def test_kernel_refuses_tensors_off_the_cpu_that_are_not_cuda(shape_a, shape_b):
    """Only a CPU tensor takes the plain version; anything else is checked
    for the kernel and raises, never falls back."""
    a = torch.empty(shape_a, dtype=torch.bfloat16, device="meta")
    b = torch.empty(shape_b, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        matmul_kernel(a, b)
