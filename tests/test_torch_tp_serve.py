"""Tensor-parallel serving on the CPU: the port's TP decode step, burst and
prefill on 8 gloo ranks in the (2, 4) and (4, 2) layouts against the JAX
package's on the 8 virtual CPU devices of tests/conftest.py, from the same
parameters, tokens and prompt (tests/test_transformer.py:247-330's sizes,
f32, at 2e-4): logits, tokens and the cache.

Also ``tp_params`` against JAX's shards of the same parameters (exactly) and
``tp_param_specs`` against its PartitionSpecs, shapes that do not divide
refused, ``DecodeLoadGen(model_parallelism=2)`` against JAX's generator
(the same burst, the whole pod's bytes, the param-stream factor and the
aggregate peak), and the serving container with MODEL_PARALLELISM 2 over
two ranks.

Rank bodies live at the top level and JAX is imported inside the tests."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from k8s_gpu_hpa_tpu_torch.loadgen import decode
from k8s_gpu_hpa_tpu_torch.models import transformer as pt
from k8s_gpu_hpa_tpu_torch.parallel import mesh as pm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import (
    JOIN_S, LAYOUTS, QUIET, REPO, WORLD, _placements, _save, run_ranks,
)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 2e-4
#: tests/test_transformer.py's TP config; batch 4, prompt 8
SIZES = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32)
BATCH, PLEN, STEPS, BURST = 4, 8, 3, 4
#: DecodeLoadGen's sizes, and the per-device peak both generators are given
GEN_SIZES = dict(batch=BATCH, max_seq=32, d_model=64, n_heads=4, n_layers=2,
                 tokens_per_burst=BURST, prefill_len=PLEN)
PEAK = 100.0


def _inputs() -> dict:
    rng = np.random.default_rng(5)
    return {"prompt": rng.integers(0, 256, (BATCH, PLEN)),
            "steps": rng.integers(0, 256, (STEPS, BATCH)),  # the tokens fed at positions 0-2
            "next": rng.integers(0, 256, BATCH)}  # the tokens fed after the prompt


def _jax_params(d_ff: int = SIZES["d_ff"]) -> dict:
    """JAX's parameters from key 0: at d_ff 4·d_model they are those JAX's
    ``DecodeLoadGen`` draws."""
    import jax
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(**{**SIZES, "d_ff": d_ff}, dtype=jnp.float32)
    return init_params(jax.random.PRNGKey(0), cfg)


def _cfg(**overrides) -> pt.TransformerConfig:
    return pt.TransformerConfig(**{**SIZES, **overrides}, dtype=torch.float32)


def _clone(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def tp_rank(out_dir, params, gen_params, x, m) -> None:
    """One of 8 ranks at a model axis of ``m``."""
    torch.set_num_threads(1)
    cfg = _cfg()
    mesh = pm.make_mesh(model_parallelism=m)
    local = BATCH // (WORLD // m)
    data, model = mesh.get_local_rank(pm.DATA_AXIS), mesh.get_local_rank(pm.MODEL_AXIS)
    rows = slice(data * local, (data + 1) * local)
    tp = pt.tp_params(params, cfg, mesh, device="cpu")
    out = {"data": data, "model": model, "leaves": pt.param_leaves(tp),
           "specs": pt.tp_param_specs(cfg)}
    # three decode steps from an empty cache
    step = pt.make_tp_decode_step(mesh, cfg)
    cache = pt.init_tp_kv_cache(cfg, BATCH, mesh, device="cpu")
    out["step_logits"] = [step(tp, x["steps"][pos, rows].long(), cache, pos)[0]
                          for pos in range(STEPS)]
    out["step_cache"] = cache
    # prefill, then one step after it
    prefill = pt.make_tp_prefill(mesh, cfg)
    cache = pt.init_tp_kv_cache(cfg, BATCH, mesh, device="cpu")
    out["prefill_logits"], _ = prefill(tp, x["prompt"][rows].long(), cache)
    out["prefill_cache"] = _clone(cache)
    out["after_prefill"], _ = step(tp, x["next"][rows].long(), cache, PLEN)
    # prefill, then a burst of greedy steps
    cache = pt.init_tp_kv_cache(cfg, BATCH, mesh, device="cpu")
    prefill(tp, x["prompt"][rows].long(), cache)
    tokens, pos = x["next"][rows].long().clone(), torch.tensor(PLEN)
    pt.make_tp_decode_burst(mesh, cfg, BURST)(tp, tokens, cache, pos)
    out["burst"] = {"tokens": tokens, "pos": int(pos), "cache": cache}
    # shapes that do not divide
    out["refused"] = {}
    for name, fn in {
        "heads": lambda: pt.make_tp_decode_step(mesh, _cfg(n_heads=3, d_model=48)),
        "d_ff": lambda: pt.make_tp_prefill(mesh, _cfg(d_ff=125)),
        "params": lambda: pt.tp_params(params, _cfg(n_heads=3, d_model=48), mesh),
        "batch": lambda: pt.init_tp_kv_cache(cfg, BATCH + 1, mesh, device="cpu"),
    }.items():
        try:
            fn()
        except ValueError as e:
            out["refused"][name] = str(e)
    out["generator"] = _generator(gen_params, x, m)
    _save(out_dir, out)


def _generator(params, x, m) -> dict:
    """``DecodeLoadGen`` at a model parallelism of ``m``: one burst after
    the warm-up, from the given weights and prompt."""
    decode.peak_hbm_gbps_for = lambda device: PEAK
    gen = decode.DecodeLoadGen(**GEN_SIZES, dtype=torch.float32, model_parallelism=m,
                               device="cpu")
    gen.set_params(params)
    gen.set_prompt(x["prompt"].numpy())
    gen.warmup()
    gen.step()
    tokens, cache, pos = gen.state()
    return {"stats": gen.stats(), "peak": gen.peak_hbm_gbps, "factor": gen._param_stream_factor,
            "param_bytes": gen._param_bytes, "bytes_per_burst": gen.bytes_per_burst(),
            "tokens": tokens.clone(), "pos": pos, "cache": _clone(cache),
            "backend": dist.get_backend(gen.mesh.get_group(pm.MODEL_AXIS))}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    import jax

    params, gen_params = (jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
                          for p in (_jax_params(), _jax_params(4 * SIZES["d_model"])))
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    return {m: run_ranks(tp_rank, WORLD, tmp_path_factory.mktemp(f"tp{m}"), params, gen_params,
                         x, m)
            for _, m in LAYOUTS}


def _jax_mesh(m: int):
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    return make_mesh(n_devices=WORLD, model_parallelism=m)


def _rows(r: dict, m: int) -> slice:
    local = BATCH // (WORLD // m)
    return slice(r["data"] * local, (r["data"] + 1) * local)


def _check_logits(ranks: list, key, want, m: int) -> None:
    """Each rank's logits against its rows of JAX's (every model rank holds
    the same)."""
    want = np.asarray(want)
    for r in ranks:
        got = r[key] if not callable(key) else key(r)
        np.testing.assert_allclose(got.numpy(), want[_rows(r, m)], rtol=TOL, atol=TOL)


def _check_cache(ranks: list, key, want: dict, m: int) -> None:
    """Each rank's head-major cache slice against its rows and heads of
    JAX's [layers, batch, max_seq, heads, head_dim] cache."""
    lh = SIZES["n_heads"] // m
    for r in ranks:
        got = key(r)
        heads = slice(r["model"] * lh, (r["model"] + 1) * lh)
        for name in ("k", "v"):
            w = np.asarray(want[name])[:, _rows(r, m), :, heads].transpose(0, 1, 3, 2, 4)
            np.testing.assert_allclose(got[name].numpy(), w, rtol=TOL, atol=TOL, err_msg=name)


def _lay(m: int) -> str:
    return f"{WORLD // m}x{m}"


@pytest.mark.parametrize("m", [m for _, m in LAYOUTS], ids=_lay)
def test_tp_params_are_jax_s_shards(layouts, m):
    """Each rank's shard of every leaf equals the shard JAX's ``tp_params``
    places on the device of the same index (wqkv viewed by head)."""
    import jax

    from k8s_gpu_hpa_tpu.models.transformer import TransformerConfig, tp_param_specs, tp_params

    cfg = TransformerConfig(**SIZES)
    placed = pt.param_leaves(tp_params(_jax_params(), cfg, _jax_mesh(m)))
    for rank, r in enumerate(layouts[m]):
        for got, arr in zip(r["leaves"], placed, strict=True):
            (shard,) = [s for s in arr.addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    want = [_placements(spec) for spec in pt.param_leaves(tp_param_specs(cfg))]
    assert pt.param_leaves(layouts[m][0]["specs"]) == want


@pytest.mark.parametrize("m", [m for _, m in LAYOUTS], ids=_lay)
def test_tp_decode_steps_match_jax_s(layouts, m):
    """tests/test_transformer.py's ``test_tp_decode_matches_single_device``,
    the port against JAX's ``make_tp_decode_step``: three steps' logits and
    the cache after them."""
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import (
        TransformerConfig, init_tp_kv_cache, make_tp_decode_step, tp_params,
    )

    cfg = TransformerConfig(**SIZES, dtype=jnp.float32)
    mesh, x = _jax_mesh(m), _inputs()
    tp = tp_params(_jax_params(), cfg, mesh)
    cache = init_tp_kv_cache(cfg, BATCH, mesh)
    step = make_tp_decode_step(mesh, cfg)
    for pos in range(STEPS):
        logits, cache = step(tp, jnp.asarray(x["steps"][pos], jnp.int32), cache, jnp.int32(pos))
        _check_logits(layouts[m], lambda r, p=pos: r["step_logits"][p], logits, m)
    _check_cache(layouts[m], lambda r: r["step_cache"], cache, m)


@pytest.mark.parametrize("m", [m for _, m in LAYOUTS], ids=_lay)
def test_tp_prefill_matches_jax_s(layouts, m):
    """tests/test_transformer.py's ``test_tp_prefill_fills_the_same_cache``:
    the last position's logits, the cache, and one decode step after it."""
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import (
        TransformerConfig, init_tp_kv_cache, make_tp_decode_step, make_tp_prefill, tp_params,
    )

    cfg = TransformerConfig(**SIZES, dtype=jnp.float32)
    mesh, x = _jax_mesh(m), _inputs()
    tp = tp_params(_jax_params(), cfg, mesh)
    logits, cache = make_tp_prefill(mesh, cfg)(tp, jnp.asarray(x["prompt"], jnp.int32),
                                               init_tp_kv_cache(cfg, BATCH, mesh))
    _check_logits(layouts[m], "prefill_logits", logits, m)
    _check_cache(layouts[m], lambda r: r["prefill_cache"], cache, m)
    after, _ = make_tp_decode_step(mesh, cfg)(tp, jnp.asarray(x["next"], jnp.int32), cache,
                                              jnp.int32(PLEN))
    _check_logits(layouts[m], "after_prefill", after, m)


@pytest.mark.parametrize("m", [m for _, m in LAYOUTS], ids=_lay)
def test_tp_decode_burst_matches_jax_s(layouts, m):
    """``make_tp_decode_burst`` after a prefill: the greedy tokens, the
    position and the cache after ``BURST`` steps."""
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import (
        TransformerConfig, init_tp_kv_cache, make_tp_decode_burst, make_tp_prefill, tp_params,
    )

    cfg = TransformerConfig(**SIZES, dtype=jnp.float32)
    mesh, x = _jax_mesh(m), _inputs()
    tp = tp_params(_jax_params(), cfg, mesh)
    _, cache = make_tp_prefill(mesh, cfg)(tp, jnp.asarray(x["prompt"], jnp.int32),
                                          init_tp_kv_cache(cfg, BATCH, mesh))
    tokens, cache, pos = make_tp_decode_burst(mesh, cfg, BURST)(
        tp, jnp.asarray(x["next"], jnp.int32), cache, jnp.int32(PLEN))
    for r in layouts[m]:
        np.testing.assert_array_equal(r["burst"]["tokens"].numpy(), np.asarray(tokens)[_rows(r, m)])
        assert r["burst"]["pos"] == int(pos) == PLEN + BURST
    _check_cache(layouts[m], lambda r: r["burst"]["cache"], cache, m)


@pytest.mark.parametrize("m", [m for _, m in LAYOUTS], ids=_lay)
def test_shapes_that_do_not_divide_are_refused(layouts, m):
    """tests/test_transformer.py's ``test_tp_rejects_non_dividing_shapes``:
    heads or d_ff over the model axis, the batch over the data axis."""
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.transformer import TransformerConfig, make_tp_decode_step

    with pytest.raises(ValueError) as jax_error:
        make_tp_decode_step(_jax_mesh(m), TransformerConfig(d_model=48, n_heads=3, n_layers=2,
                                                            d_ff=128, max_seq=32,
                                                            dtype=jnp.float32))
    for r in layouts[m]:
        assert r["refused"]["heads"] == str(jax_error.value)
        assert "must be divisible by the model axis size" in r["refused"]["d_ff"]
        assert r["refused"]["params"] == str(jax_error.value)
        assert "must be divisible by the data axis" in r["refused"]["batch"]


@pytest.mark.parametrize("m", [m for _, m in LAYOUTS], ids=_lay)
def test_the_tp_generator_matches_jax_s(layouts, m, monkeypatch):
    """``DecodeLoadGen(model_parallelism=m)`` beside JAX's on the same
    weights and prompt: the burst's tokens, position and cache; the whole
    pod's cache and weight bytes, the weights streamed once a data replica,
    the per-device peak times the mesh's size; the burst ran eagerly, as
    gloo must."""
    import jax

    from k8s_gpu_hpa_tpu.loadgen import decode as jax_decode

    monkeypatch.setattr(jax_decode, "peak_hbm_gbps_for", lambda device: PEAK)
    gen = jax_decode.DecodeLoadGen(**GEN_SIZES, dtype=jax.numpy.float32, model_parallelism=m)
    gen._prompt = jax.device_put(jax.numpy.asarray(_inputs()["prompt"], jax.numpy.int32),
                                 gen._prompt.sharding)
    gen.warmup()
    gen.step()
    want = gen.stats()
    want_bytes = BURST * (want.cache_bytes + gen._param_bytes * gen._param_stream_factor) + (
        gen._param_bytes * gen._param_stream_factor + want.cache_bytes * PLEN // SIZES["max_seq"])
    for r in layouts[m]:
        got = r["generator"]
        assert got["peak"] == gen.peak_hbm_gbps == PEAK * WORLD
        assert got["factor"] == gen._param_stream_factor == WORLD // m
        assert got["param_bytes"] == gen._param_bytes
        assert got["stats"].cache_bytes == want.cache_bytes
        assert got["bytes_per_burst"] == want_bytes
        assert got["stats"].steps == want.steps == 1
        assert got["stats"].tokens_generated == want.tokens_generated
        assert got["stats"].burst_mode == "eager" and got["backend"] == "gloo"
        assert got["pos"] == int(gen._pos)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(gen._tokens)[_rows(r, m)])
    _check_cache(layouts[m], lambda r: r["generator"]["cache"], gen._cache, m)


_TP_MAIN = (
    "import torch; from k8s_gpu_hpa_tpu_torch.loadgen import decode; "
    "decode.local_devices = lambda device=None: [torch.device('cpu')] * 2; "
    "decode.main(device='cpu')"
)


def test_the_serving_container_serves_tensor_parallel_over_two_ranks(tmp_path):
    """``WORKLOAD=decode`` with MODEL_PARALLELISM 2 on a host of two
    devices (two CPU devices stand in for two GPUs): one rank a device,
    rank 0 prints the pod's banner and reports bursts; SIGTERM reaches both
    ranks through the launcher."""
    env = {**{k: v for k, v in os.environ.items()
              if k not in ("COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE",
                           "TPU_TELEMETRY_DIR")},
           **QUIET, "MODEL_PARALLELISM": "2", "DECODE_BATCH": "2", "MAX_SEQ": "64",
           "D_MODEL": "64", "N_HEADS": "2", "N_LAYERS": "1", "PREFILL_LEN": "8",
           "REPORT_S": "0.2", "TPU_TEST_INTENSITY": "1.0",
           "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob")}
    proc = subprocess.Popen([sys.executable, "-c", _TP_MAIN], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    lines = []
    try:
        deadline = time.monotonic() + JOIN_S
        while sum(ln.startswith("bursts=") for ln in lines) < 2 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=JOIN_S)
    finally:
        proc.kill()
    banners = [ln for ln in lines if ln.startswith("tpu-test decode loadgen")]
    assert len(banners) == 1 and "mesh={'data': 1, 'model': 2}" in banners[0], lines
    reports = [dict(f.split("=", 1) for f in ln.split()[:3]) for ln in lines
               if ln.startswith("bursts=")]
    assert len(reports) >= 2 and int(reports[-1]["bursts"]) > 0
    # the ranks stop together at the forwarded SIGTERM and exit 0, and so
    # does the launcher
    assert proc.returncode == 0, out
