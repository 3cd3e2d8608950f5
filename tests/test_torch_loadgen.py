"""The port's matmul load generator, on the CPU: the JAX generator's tests
(tests/test_jax_workloads.py) mirrored, the longest-prefix peak lookup with
the names H100s report, and burst parity against the JAX generator's jitted
``_burst`` on the same operands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.loadgen.matmul import MatmulLoadGen as JaxMatmulLoadGen
from k8s_gpu_hpa_tpu_torch import device as port_device
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import (
    MatmulLoadGen,
    peak_hbm_gbps_for,
    peak_tflops_for,
)
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul_kernel
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def test_matmul_loadgen_self_reports():
    gen = MatmulLoadGen(size=256, iters_per_burst=2, intensity=1.0, device="cpu")
    gen.warmup()
    for _ in range(3):
        gen.step()
    stats = gen.stats()
    assert stats.steps == 3
    assert stats.utilization > 0.0
    assert stats.achieved_tflops > 0.0
    assert stats.sustained_tflops > 0.0


def test_matmul_loadgen_intensity_knob(tmp_path):
    gen = MatmulLoadGen(size=256, iters_per_burst=1, intensity=1.0, device="cpu")
    knob = tmp_path / "intensity"
    gen.intensity_file = str(knob)
    knob.write_text("0.25")
    gen.step()
    assert gen.intensity == 0.25
    knob.write_text("garbage")
    gen.step()
    assert gen.intensity == 0.25  # bad writes ignored
    gen.set_intensity(7.0)
    assert gen.intensity == 1.0  # clamped


def test_matmul_loadgen_zero_intensity_idles():
    gen = MatmulLoadGen(size=256, intensity=0.0, device="cpu")
    busy = gen.step()
    assert busy == 0.0
    assert gen.stats().utilization == 0.0


def test_burst_length_scales_with_intensity_and_defaults_small_on_cpu():
    gen = MatmulLoadGen(size=128, device="cpu")
    assert gen.iters_per_burst == 4  # 256 on a GPU
    assert gen.burst_iters(1.0) == 4
    assert gen.burst_iters(0.5) == 2
    assert gen.burst_iters(0.01) == 1


def test_cpu_has_no_peak_so_no_tensorcore_gauge():
    gen = MatmulLoadGen(size=128, iters_per_burst=1, intensity=1.0, device="cpu")
    gen.step()
    assert gen.peak_tflops is None
    assert gen.mxu_utilization() is None  # absent, never a fake 0


def test_peak_lookup_prefers_longest_prefix():
    assert peak_tflops_for("NVIDIA H100 80GB HBM3") == 989.0  # the SXM part
    assert peak_hbm_gbps_for("NVIDIA H100 80GB HBM3") == 3350.0
    assert peak_tflops_for("NVIDIA H100 PCIe") == 756.0
    assert peak_hbm_gbps_for("NVIDIA H100 PCIe") == 2000.0
    assert peak_tflops_for("NVIDIA A100-SXM4-80GB") is None
    assert peak_tflops_for(torch.device("cpu")) is None
    assert peak_hbm_gbps_for("cpu") is None


def test_cuda_is_the_default_and_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatmulLoadGen(size=128)
    assert port_device.resolve("cpu") == torch.device("cpu")


def test_set_operands_rejects_a_count_that_does_not_match_the_devices():
    gen = MatmulLoadGen(size=128, device="cpu")
    ops = np.zeros((2, 128, 128), np.float32)
    with pytest.raises(ValueError, match="2 operands for 1 devices"):
        gen.set_operands(ops, ops[0])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_burst_matches_the_jax_generator(use_kernel):
    """Three chained products with the 1/sqrt(size) renorm, f32 operands at
    size 256: the port's burst probe equals the JAX generator's jitted
    ``_burst`` (the Pallas kernel in interpret mode when ``use_kernel``)
    at 1e-4 relative."""
    size, n = 256, 3
    rng = np.random.default_rng(7)
    a = rng.standard_normal((size, size), dtype=np.float32)
    b = rng.standard_normal((size, size), dtype=np.float32)
    ref = JaxMatmulLoadGen(
        size=size, dtype=jnp.float32, use_pallas=use_kernel, device=jax.devices()[0]
    )
    want = float(ref._burst(jnp.asarray(a), jnp.asarray(b), jnp.int32(n)))
    gen = MatmulLoadGen(size=size, dtype=torch.float32, use_kernel=use_kernel, device="cpu")
    gen.set_operands(a, b)
    before = matmul_kernel.launches
    got = gen._burst(n)
    assert matmul_kernel.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, rtol=1e-4)
