"""The port's chained-dwell timer (utils/dwell.py) and bench.py's two rate
blocks built on it (trial.measure_attention_rates, measure_kernel_rates),
on the CPU.

The JAX package's dwell tests (tests/test_dwell.py) ported without their
ratio of two independently timed runs: the accounting is held exactly
instead, with the wall clock stubbed.  The chain itself is held to the JAX
timer's ``lax.fori_loop`` on the same numpy inputs."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bench
from k8s_gpu_hpa_tpu.loadgen.matmul import MatmulLoadGen as JaxMatmulLoadGen
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen
from k8s_gpu_hpa_tpu_torch.utils import dwell
from k8s_gpu_hpa_tpu_torch.utils.dwell import chained_dwell_tflops, timed_chain
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

#: the keys of bench.py's attention dict (measure_attention_rates returns
#: None off a TPU, so they are read from its source)
ATTENTION_KEYS = {"shape", "flash_tflops", "naive_xla_tflops", "flash_vs_naive"}
SMALL_ATTENTION = (1, 256, 2, 64)


def test_dwell_measures_a_real_chain():
    x = torch.ones(64, 64)
    rate = chained_dwell_tflops(lambda y: y @ x, x, iters=8, flops_per_iter=2 * 64**3)
    assert rate > 0.0


@pytest.mark.parametrize("warm_iters,iters", [(2, 8), (0, 5), (3, 1), (2, 0)])
def test_dwell_applies_body_warm_plus_timed_times(warm_iters, iters):
    calls = []

    def body(y):
        calls.append(1)
        return y + 1.0

    out, _ = timed_chain(body, torch.zeros(4), iters, warm_iters)
    assert len(calls) == warm_iters + iters
    # the timed chain starts again from init: warm-up applications do not carry
    assert torch.equal(out, torch.full((4,), float(iters)))


@pytest.mark.parametrize("iters", [1, 8, 64])
def test_dwell_chain_equals_the_jax_timers_fori_loop(iters):
    """``lambda y: y @ x * (1/16)`` in f32 from the same numpy input: the
    port's chain ends where JAX's ``lax.fori_loop`` does."""
    x_np = np.random.default_rng(25).standard_normal((64, 64)).astype(np.float32)
    x = torch.from_numpy(x_np)
    last = {}

    def body(y):
        last["y"] = y @ x * (1.0 / 16.0)
        return last["y"]

    rate = chained_dwell_tflops(body, x, iters=iters, flops_per_iter=2 * 64**3)
    xj = jnp.asarray(x_np)
    want = lax.fori_loop(0, iters, lambda _, y: y @ xj * (1.0 / 16.0), xj)
    assert rate > 0.0
    np.testing.assert_allclose(last["y"].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flops_per_iter", [1e6, 2e6, 3.5e9])
def test_dwell_rate_is_flops_times_iters_over_the_wall(monkeypatch, flops_per_iter):
    """The rate is exactly flops_per_iter x iters / (t1 - t0) / 1e12: no
    round-trip subtraction, no clamp.  The clock reads twice, at the launch
    and after the scalar read."""
    reads = iter([100.0, 100.25])
    monkeypatch.setattr(dwell.time, "perf_counter", lambda: next(reads))
    x = torch.ones(16, 16)
    rate = chained_dwell_tflops(lambda y: y * 0.5, x, iters=64, flops_per_iter=flops_per_iter)
    assert rate == flops_per_iter * 64 / 0.25 / 1e12
    assert next(reads, None) is None


def test_dwell_excludes_warmup_from_the_timed_chain():
    """A body whose very first application sleeps 0.6 s must not depress the
    measured rate: the warm-up absorbs it before the timer starts."""
    state = {"first": True}

    def body(y):
        if state["first"]:
            state["first"] = False
            time.sleep(0.6)
        return y

    rate = chained_dwell_tflops(body, torch.ones(8, 8), iters=4, flops_per_iter=1e9)
    # if the 0.6 s penalty leaked into the timed chain the rate would be
    # at most 4e9 / 0.6 / 1e12
    assert rate > 4 * 1e9 / 0.3 / 1e12
    assert state["first"] is False  # the slow path ran, in the warm-up


def test_attention_rates_return_benchs_keys_on_the_cpu():
    out = trial.measure_attention_rates("cpu", shape=SMALL_ATTENTION, iters=2)
    assert set(out) == ATTENTION_KEYS
    assert out["shape"] == "b1 h2 s256 d64 causal bf16"
    assert out["flash_tflops"] > 0.0 and out["naive_xla_tflops"] > 0.0
    assert out["flash_vs_naive"] == out["flash_tflops"] / out["naive_xla_tflops"]


def test_attention_rates_default_to_benchs_shape_and_dwell():
    assert trial.ATTENTION_RATE_SHAPE == (2, 4096, 8, 128)
    assert trial.ATTENTION_RATE_ITERS == 400


def test_attention_rates_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trial.measure_attention_rates(shape=SMALL_ATTENTION, iters=1)


def test_kernel_rates_return_benchs_keys_on_the_cpu():
    """The same keys, method and MFU as bench.py's block on a CPU backend,
    where JAX's Pallas kernel runs in interpret mode and the port's GEMM
    wrapper runs its plain version."""
    jax_gen = JaxMatmulLoadGen(size=128, all_devices=False, intensity=1.0)
    want = bench.measure_kernel_rates(jax_gen, lambda _msg: None)
    got = trial.measure_kernel_rates(MatmulLoadGen(size=128, device="cpu"))
    assert set(got) == set(want)
    for key in ("per_chip", "peak_tflops", "mfu_pct", "method"):
        assert got[key] == want[key]
    assert got["achieved_tflops"] > 0.0 and got["pallas_tflops"] > 0.0
    assert got["pallas_vs_xla"] == got["pallas_tflops"] / got["achieved_tflops"]


def test_kernel_rates_time_the_kernel_path(monkeypatch):
    """The kernel's dwell goes through a generator built with
    ``use_kernel=True``, the library's through one without."""
    seen = []
    real = MatmulLoadGen.measure_dwell_tflops

    def spy(self, iters=None):
        seen.append((self._op.__name__, self.size, iters))
        return real(self, iters)

    monkeypatch.setattr(MatmulLoadGen, "measure_dwell_tflops", spy)
    trial.measure_kernel_rates(MatmulLoadGen(size=128, device="cpu"))
    assert seen == [("matmul", 128, 8), ("matmul_kernel", 128, 8)]
