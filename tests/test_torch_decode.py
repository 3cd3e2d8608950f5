"""The port's serving load generator (k8s_gpu_hpa_tpu_torch/loadgen/decode.py)
against the JAX package's: the request queue on one script, the byte
accounting for the same config, the windowed rates, the argument checks, and
whole bursts in f32 on the JAX generator's weights and prompt, token for
token.  On the CPU the burst runs eagerly; the CUDA graph is held against an
eager burst on the card by chip_smoke.py."""

import runpy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.loadgen.decode import DecodeLoadGen as JaxDecodeLoadGen
from k8s_gpu_hpa_tpu.loadgen.decode import RequestQueue as JaxRequestQueue
from k8s_gpu_hpa_tpu_torch.loadgen import decode, matmul
from k8s_gpu_hpa_tpu_torch.loadgen.decode import (
    TPU_TOKENS_PER_BURST,
    DecodeLoadGen,
    RequestQueue,
)
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TINY = dict(batch=2, max_seq=16, d_model=32, n_heads=2, n_layers=1, tokens_per_burst=2)


def tiny_gen(**kw) -> DecodeLoadGen:
    return DecodeLoadGen(**(TINY | {"device": "cpu", "dtype": torch.float32} | kw))


def test_queue_follows_the_jax_queue_on_one_script():
    script = [("offer", 10.5), ("take", 4.0), ("offer", -3.0), ("take", 100.0),
              ("offer", 7.25), ("take", -2.0), ("offer", 1e7), ("take", 8.0)]
    port, ref = RequestQueue(max_depth=50.0), JaxRequestQueue(max_depth=50.0)
    for op, amount in script:
        assert getattr(port, op)(amount) == getattr(ref, op)(amount)
        assert (port.depth, port.offered_total, port.served_total) == (
            ref.depth, ref.offered_total, ref.served_total
        )
    assert port.depth == 42.0  # bounded at max_depth, then 8 served


@pytest.mark.parametrize(
    "torch_dtype, jax_dtype, prefill_len",
    [(torch.bfloat16, jnp.bfloat16, 0), (torch.float32, jnp.float32, 4)],
)
def test_cache_and_parameter_bytes_equal_the_jax_generator(torch_dtype, jax_dtype, prefill_len):
    gen = DecodeLoadGen(**(TINY | {"device": "cpu", "dtype": torch_dtype, "prefill_len": prefill_len}))
    ref = JaxDecodeLoadGen(**(TINY | {"dtype": jax_dtype, "prefill_len": prefill_len}))
    itemsize = torch_dtype.itemsize
    # K and V per layer: batch x max_seq x d_model
    assert gen.stats().cache_bytes == ref.stats().cache_bytes == 2 * 2 * 16 * 32 * itemsize
    assert gen._param_bytes == ref._param_bytes
    assert gen.bytes_per_burst() == 2 * (gen.stats().cache_bytes + gen._param_bytes) + (
        (gen._param_bytes + gen.stats().cache_bytes * prefill_len // 16) if prefill_len else 0
    )


def test_token_accounting_and_cpu_defaults():
    gen = tiny_gen()
    assert DecodeLoadGen(**(TINY | {"device": "cpu", "tokens_per_burst": None})).tokens_per_burst == 4
    assert TPU_TOKENS_PER_BURST == 128  # the GPU default
    gen.warmup()  # the first burst is excluded from accounting
    stats = gen.stats()
    assert stats.steps == 0 and stats.tokens_generated == 0
    for _ in range(3):
        gen.step()
    stats = gen.stats()
    assert stats.steps == 3
    assert stats.tokens_generated == 2 * 2 * 3  # batch x tokens_per_burst x bursts
    assert stats.tokens_per_sec > 0 and stats.utilization_pct > 0
    assert stats.prefill_tokens_per_sec == 0.0
    assert gen.replays == 0 and gen.flash_launches_per_burst == 0  # no graph on the CPU


def test_prefill_bytes_counted_in_the_bandwidth_numerator():
    """One burst's accounted bytes are the decode's (tokens x (cache +
    weights)) plus the prefill's (one weight read + the prompt positions'
    cache writes): checked against the generator's own windowed rate, as
    the JAX package checks its generator (tests/test_serve_rung.py)."""
    gen = tiny_gen(prefill_len=4)
    gen.warmup()
    gen.step()
    stats = gen.stats()
    expected = gen.tokens_per_burst * (stats.cache_bytes + gen._param_bytes) + (
        gen._param_bytes + stats.cache_bytes * 4 // gen.cfg.max_seq
    )
    accounted = stats.achieved_gbps * 1e9 * stats.seconds
    assert abs(accounted - expected) / expected < 0.05
    assert stats.prefill_tokens_per_sec > 0
    plain = tiny_gen()
    assert gen.bytes_per_burst() - plain.bytes_per_burst() == (
        gen._param_bytes + stats.cache_bytes * 4 // 16
    )


def test_windowed_rates_decay_when_idle():
    gen = tiny_gen(window=0.4)
    gen.warmup()
    for _ in range(3):
        gen.step()
    assert gen.stats().utilization_pct > 0
    time.sleep(0.6)  # idle past the window
    stats = gen.stats()
    assert stats.utilization_pct == 0.0
    assert stats.achieved_gbps == 0.0


def test_overlong_prompt_raises():
    with pytest.raises(ValueError):
        tiny_gen(prefill_len=15)  # 15 + 2 tokens_per_burst > max_seq 16


def test_bandwidth_gauge_is_none_on_the_cpu():
    gen = tiny_gen()
    gen.warmup()
    gen.step()
    assert gen.peak_hbm_gbps is None
    assert gen.stats().hbm_bw_util_pct is None and gen.hbm_bw_utilization() is None
    assert gen.utilization() > 0


def test_tensor_parallel_serving_raises_instead_of_serving_on_one_device():
    """Without a process group there is no model axis to serve on (the
    ranks' own run is in tests/test_torch_tp_serve.py)."""
    with pytest.raises(RuntimeError, match="needs a process group"):
        tiny_gen(model_parallelism=2)


@pytest.mark.parametrize("prefill_len", [0, 16])
def test_f32_bursts_equal_the_jax_generators(prefill_len):
    """The same weights and prompt through both generators: each burst's
    last tokens, the position and the cache agree (f32; the greedy argmax
    of bf16 logits can break ties differently)."""
    sizes = dict(batch=2, max_seq=64, d_model=64, n_heads=2, n_layers=2,
                 tokens_per_burst=4, prefill_len=prefill_len)
    ref = JaxDecodeLoadGen(**sizes, dtype=jnp.float32)
    gen = DecodeLoadGen(**sizes, dtype=torch.float32, device="cpu")
    gen.set_params(jax.tree.map(np.asarray, ref._params))
    if prefill_len:
        gen.set_prompt(np.asarray(ref._prompt))
    for _ in range(3):
        ref._run_burst()
        gen.run_burst()
        tokens, cache, pos = gen.state()
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref._tokens))
        assert pos == int(ref._pos)
        np.testing.assert_allclose(
            cache["v"].permute(0, 1, 3, 2, 4).numpy(), np.asarray(ref._cache["v"]),
            rtol=2e-4, atol=2e-4,
        )
    gen.reset_state()
    assert int(gen.state()[2]) == 0 and not gen.state()[1]["k"].any()


def test_workload_env_selects_the_generator(monkeypatch):
    monkeypatch.setenv("WORKLOAD", "decode")
    ns = runpy.run_module("k8s_gpu_hpa_tpu_torch.loadgen.__main__", run_name="imported")
    assert ns["main"] is decode.main
    monkeypatch.setenv("WORKLOAD", "matmul")
    ns = runpy.run_module("k8s_gpu_hpa_tpu_torch.loadgen.__main__", run_name="imported")
    assert ns["main"] is matmul.main
