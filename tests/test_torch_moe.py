"""Expert parallelism on the CPU: the port's MoE FFN on gloo ranks in the
(2, 4) and (1, 2) layouts against the JAX package's ``make_ep_moe_ffn`` on
the virtual CPU devices of tests/conftest.py, from the same parameters and
tokens (tests/test_parallelism.py's sizes and bars):

- ``_route`` bit for bit and ``_capacity`` (its floor included) against
  JAX's; ``moe_ffn_reference`` at f32 2e-5;
- ``all_to_all`` and its transpose against ``lax.all_to_all`` (untiled)
  and ``jax.vjp`` of it, on 2 and 4 ranks;
- the EP forward at f32 2e-5 (bf16 within 0.06 of its RMS) and its
  gradients at 2e-4 against ``jax.grad`` of the global loss; the refusal of
  experts that do not divide; the capacity floor at 2 tokens a shard;
- planted faults that must fail: the erf gelu, a capacity without its
  floor, and a gradient not scaled for the model axis's replicated output;
- the parameter converters; ``MoELoadGen``'s bursts and ``MoEStats``
  against JAX's generator (tests/test_parallelism.py:162-186) on the same
  mesh; the slice container with ``WORKLOAD=moe`` over two processes until
  SIGTERM.

Rank bodies live at the top level and JAX is imported inside the tests."""


import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_gpu_hpa_tpu_torch.loadgen.moe import MoELoadGen
from k8s_gpu_hpa_tpu_torch.models import moe
from k8s_gpu_hpa_tpu_torch.parallel import mesh as pm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import _save, run_ranks
from tests.test_torch_ring_attention import run_slice

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TOL, GRAD_TOL = 2e-5, 2e-4
BF16_REL = 0.06
#: tests/test_parallelism.py's MoE: d_model 32, d_ff 64, 4 experts; 32 tokens
SIZES = dict(d_model=32, d_ff=64, n_experts=4)
TOKENS = 32
#: (data, model) layouts, JAX's test's first
LAYOUTS = [(2, 4), (1, 2)]
#: the a2a operands a rank: [n, 3, 2, 5] split on 0, [3, n, 5] split on 1
A2A_CASES = [(0, 1), (1, 0), (1, 2)]
#: the load generator's sizes (tests/test_parallelism.py:166-173), and the
#: bar of its chain of 2 × 2 FFNs with their re-normalizations: JAX's FFN
#: bar, once for each
GEN_SIZES = dict(d_model=32, d_ff=64, tokens_per_shard=16, ffns_per_burst=2)
GEN_TOL = 4 * TOL


def _cfg(dtype=torch.float32) -> moe.MoEConfig:
    return moe.MoEConfig(**SIZES, dtype=dtype)


def _jax_cfg(dtype: str = "float32"):
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.moe import MoEConfig

    return MoEConfig(**SIZES, dtype=getattr(jnp, dtype))


def _jax_inputs() -> dict:
    """tests/test_parallelism.py's parameters (key 0) and tokens (key 1,
    times 0.5), and the 4 tokens of its capacity-floor test, as numpy."""
    import jax

    from k8s_gpu_hpa_tpu.models.moe import init_moe_params

    params = init_moe_params(jax.random.PRNGKey(0), _jax_cfg())
    x = jax.random.normal(jax.random.PRNGKey(1), (TOKENS, SIZES["d_model"])) * 0.5
    small = jax.random.normal(jax.random.PRNGKey(1), (4, SIZES["d_model"])) * 0.5
    return {**{k: np.asarray(v) for k, v in params.items()}, "x": np.asarray(x),
            "small": np.asarray(small)}


def _rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2)))


# ---- one process: routing, capacity, the reference ------------------------


@pytest.mark.parametrize("tokens", [2, 3, 16, 32, 100])
@pytest.mark.parametrize("n_experts, factor", [(4, 1.25), (8, 1.0), (2, 0.3)])
def test_capacity_equals_jax_floor_included(tokens, n_experts, factor):
    from k8s_gpu_hpa_tpu.models import moe as jax_moe

    got = moe._capacity(tokens, moe.MoEConfig(n_experts=n_experts, capacity_factor=factor))
    want = jax_moe._capacity(tokens, jax_moe.MoEConfig(n_experts=n_experts,
                                                       capacity_factor=factor))
    assert got == want >= 1


def _routers(router: np.ndarray) -> dict[str, np.ndarray]:
    """The seeded router; one whose every logit ties (every token takes
    expert 0); one whose experts 2 and 3 tie and lead (those tokens take 2)."""
    tied = router.copy()
    tied[:, 3] = tied[:, 2] = 3.0 * np.abs(router).max(axis=1)
    return {"seeded": router, "all-tied": np.zeros_like(router), "two-tied": tied}


@pytest.mark.parametrize("capacity", [1, 5, 8, 40])
@pytest.mark.parametrize("router", ["seeded", "all-tied", "two-tied"])
def test_route_equals_jax_bit_for_bit(router, capacity):
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models import moe as jax_moe

    x = _jax_inputs()["x"]
    r = _routers(_jax_inputs()["router"])[router]
    got = moe._route(torch.tensor(x), torch.tensor(r), SIZES["n_experts"], capacity)
    want = jax_moe._route(jnp.asarray(x), jnp.asarray(r), SIZES["n_experts"], capacity)
    for i, name in ((0, "expert"), (2, "slot"), (3, "keep")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=name)
    # the probability rounds as the two libraries' f32 products do
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=0)
    expert = got[0].numpy()
    if router == "all-tied":
        assert (expert == 0).all()
    if router == "two-tied":
        assert (expert == 2).any() and not (expert == 3).any()


@pytest.mark.parametrize("tokens", [TOKENS, 2])
def test_reference_matches_jax(tokens):
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models import moe as jax_moe

    inputs = _jax_inputs()
    x = inputs["x"][:tokens]
    got = moe.moe_ffn_reference(moe.moe_params_from_jax(inputs, device="cpu"), _cfg(),
                                torch.tensor(x))
    want = jax_moe.moe_ffn_reference({k: jnp.asarray(inputs[k]) for k in ("router", "w1", "w2")},
                                     _jax_cfg(), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert np.abs(got.numpy()).sum() > 0


def test_a_planted_capacity_without_its_floor_drops_every_token(monkeypatch):
    """2 tokens over 4 experts: int(1.25 · 2 / 4) is 0.  Without the floor
    every token is dropped and the layer is silently the zero function."""
    inputs = _jax_inputs()
    params = moe.moe_params_from_jax(inputs, device="cpu")
    x = torch.tensor(inputs["small"][:2])
    assert np.abs(moe.moe_ffn_reference(params, _cfg(), x).numpy()).sum() > 0
    monkeypatch.setattr(moe, "_capacity",
                        lambda tokens, cfg: int(cfg.capacity_factor * tokens / cfg.n_experts))
    assert np.abs(moe.moe_ffn_reference(params, _cfg(), x).numpy()).sum() == 0


def test_params_from_jax_keep_their_dtypes_and_values():
    import jax

    from k8s_gpu_hpa_tpu.models.moe import init_moe_params

    for dtype in ("float32", "bfloat16"):
        want = {k: np.asarray(v) for k, v in
                init_moe_params(jax.random.PRNGKey(0), _jax_cfg(dtype)).items()}
        got = moe.moe_params_from_jax(want, device="cpu")
        assert got["router"].dtype == torch.float32
        assert got["w1"].dtype == got["w2"].dtype == getattr(torch, dtype)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].float().numpy(), w.astype(np.float32))


def test_moe_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoELoadGen(mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.init_moe_params(torch.Generator().manual_seed(0), _cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.moe_params_from_jax(_jax_inputs())


# ---- all_to_all against lax.all_to_all ------------------------------------


def _a2a_operand(n: int, split: int, rank: int) -> torch.Tensor:
    """A distinct operand for ``rank`` whose dimension ``split`` is ``n``."""
    shape = [3, 2, 5]
    shape.insert(split, n)
    return torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape) + 1000.0 * rank


def a2a_rank(out_dir, n) -> None:
    torch.set_num_threads(1)
    group = pm.make_mesh().get_group(pm.DATA_AXIS)
    me = pm.axis_index(group)
    out = {}
    for split, concat in A2A_CASES:
        x = _a2a_operand(n, split, me).requires_grad_()
        y = pm.all_to_all(x, group, split, concat)
        weight = torch.sin(torch.arange(y.numel(), dtype=torch.float32)).reshape(y.shape) + me
        (y * weight).sum().backward()
        out[(split, concat)] = (y.detach(), weight, x.grad)
    for name, x, split, concat in (("concat", _a2a_operand(n, 0, me), 0, 4),
                                   ("split", torch.zeros(5, 3), 0, 0)):
        try:
            pm.all_to_all(x, group, split, concat)
        except ValueError as e:
            out[("error", name)] = str(e)
    _save(out_dir, out)


@pytest.fixture(scope="module")
def a2a(tmp_path_factory):
    return {n: run_ranks(a2a_rank, n, tmp_path_factory.mktemp(f"a2a{n}"), n) for n in (2, 4)}


def _jax_a2a(n: int, split: int, concat: int, xs: list, weights: list):
    """``lax.all_to_all`` over ``n`` devices of per-device operands ``xs``,
    and its transpose at per-device cotangents ``weights``: JAX's transpose
    rule, the reverse ``all_to_all`` (split and concat swapped).  (``jax.vjp``
    through an untiled ``all_to_all`` under ``shard_map`` fails in this JAX
    with a cotangent of transposed shape where neither axis has size 1.)"""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from k8s_gpu_hpa_tpu.utils.jax_compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))

    def exchange(s, c, blocks):
        f = shard_map(lambda b: lax.all_to_all(b, "model", s, c, tiled=False), mesh=mesh,
                      in_specs=P("model"), out_specs=P("model"), check_vma=False)
        return np.split(np.asarray(f(jnp.concatenate([jnp.asarray(b) for b in blocks]))), n)

    return exchange(split, concat, xs), exchange(concat, split, weights)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("split, concat", A2A_CASES)
def test_all_to_all_and_its_transpose_equal_lax_all_to_all(a2a, n, split, concat):
    ranks = a2a[n]
    xs = [_a2a_operand(n, split, r).numpy() for r in range(n)]
    weights = [ranks[r][(split, concat)][1].numpy() for r in range(n)]
    y, grad = _jax_a2a(n, split, concat, xs, weights)
    for r in range(n):
        got_y, _, got_grad = ranks[r][(split, concat)]
        np.testing.assert_array_equal(got_y.numpy(), y[r])
        np.testing.assert_array_equal(got_grad.numpy(), grad[r])


def test_all_to_all_refuses_shapes_that_do_not_fit_the_group(a2a):
    for r in a2a[4]:
        assert "concat_axis 4" in r[("error", "concat")]
        assert "over a group of 4" in r[("error", "split")]


# ---- the EP FFN on gloo ranks against JAX's -------------------------------


def ep_rank(out_dir, inputs, m) -> None:
    """This rank's EP outputs (f32 and bf16, the erf gelu planted, the
    capacity floor at 2 tokens a shard), its f32 gradients with the loss
    scaled by ``replica_share`` and without, its parameter shard, and the
    refusal of 3 experts."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(model_parallelism=m)
    n_data = pm.mesh_shape(mesh)[pm.DATA_AXIS]
    data = mesh.get_local_rank(pm.DATA_AXIS)
    whole = {k: inputs[k].numpy() for k in ("router", "w1", "w2")}

    def shard(x):
        rows = x.shape[0] // n_data
        return x[data * rows:(data + 1) * rows]

    out = {"index": (data, mesh.get_local_rank(pm.MODEL_AXIS)), "outputs": {}, "grads": {}}
    params = moe.moe_params_from_jax(whole, mesh, device="cpu")
    out["params"] = params
    for dtype in (torch.float32, torch.bfloat16):
        p = {**params, "w1": params["w1"].to(dtype), "w2": params["w2"].to(dtype)}
        ffn = moe.make_ep_moe_ffn(mesh, _cfg(dtype))
        out["outputs"][str(dtype)] = ffn(p, shard(inputs["x"]).to(dtype)).float()
    ffn = moe.make_ep_moe_ffn(mesh, _cfg())
    out["outputs"]["small"] = ffn(params, shard(inputs["small"]))
    for case, share in (("scaled", moe.replica_share(mesh)), ("unscaled", 1.0)):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        (ffn(p, shard(inputs["x"])).square().sum() * share).backward()
        moe.sum_replicated_grads(p, mesh)
        out["grads"][case] = {k: v.grad for k, v in p.items()}
    # the fault: the exact erf gelu in the tanh form's place
    moe._gelu = F.gelu
    out["outputs"]["erf"] = ffn(params, shard(inputs["x"]))
    try:
        moe.make_ep_moe_ffn(mesh, moe.MoEConfig(**{**SIZES, "n_experts": 3}))
    except ValueError as e:
        out["refused"] = str(e)
    _save(out_dir, out)


def _jax_ep(layout: tuple[int, int], inputs: dict) -> dict:
    """JAX's EP outputs (f32, bf16, the 4 small tokens) and the f32
    gradients of the global loss ``sum(out²)``, tests/test_parallelism.py's
    way: through JAX's EP (``grads``) where JAX can differentiate it, and
    through its oracle, ``moe_ffn_reference`` a data shard at a time
    (``ref_grads``).  At a model axis of 2 JAX's own backward fails: under
    ``shard_map`` this JAX transposes an untiled ``all_to_all`` to a
    cotangent of the wrong shape once ``local_e`` is above 1."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from k8s_gpu_hpa_tpu.models.moe import make_ep_moe_ffn, moe_ffn_reference
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    n_data, m = layout
    mesh = make_mesh(n_devices=n_data * m, model_parallelism=m)

    def put(x, params):
        return (jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None))),
                jax.device_put(params, NamedSharding(mesh, P())))

    out = {}
    for dtype in ("float32", "bfloat16"):
        params = {"router": jnp.asarray(inputs["router"]),
                  **{k: jnp.asarray(inputs[k]).astype(getattr(jnp, dtype)) for k in ("w1", "w2")}}
        xs, ps = put(jnp.asarray(inputs["x"]).astype(getattr(jnp, dtype)), params)
        y = make_ep_moe_ffn(mesh, _jax_cfg(dtype))(ps, xs)
        out[dtype] = np.asarray(y.astype(jnp.float32))
    params = {k: jnp.asarray(inputs[k]) for k in ("router", "w1", "w2")}
    ffn = make_ep_moe_ffn(mesh, _jax_cfg())
    xs, ps = put(inputs["small"], params)
    out["small"] = np.asarray(ffn(ps, xs))
    xs, ps = put(inputs["x"], params)
    if SIZES["n_experts"] // m == 1:
        g = jax.grad(lambda p: jnp.sum(jnp.square(ffn(p, xs))))(ps)
        out["grads"] = {k: np.asarray(v) for k, v in g.items()}
    shards = jnp.split(jnp.asarray(inputs["x"]), n_data)
    g = jax.grad(lambda p: sum(jnp.sum(jnp.square(moe_ffn_reference(p, _jax_cfg(), s)))
                               for s in shards))(params)
    out["ref_grads"] = {k: np.asarray(v) for k, v in g.items()}
    return out


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    inputs = _jax_inputs()
    tensors = {k: torch.tensor(v) for k, v in inputs.items()}
    return {layout: (run_ranks(ep_rank, layout[0] * layout[1],
                               tmp_path_factory.mktemp(f"ep{layout[0]}x{layout[1]}"),
                               tensors, layout[1]),
                     _jax_ep(layout, inputs))
            for layout in LAYOUTS}


def _assembled(ranks: list, key: str) -> np.ndarray:
    """The global output from the data shards; every model rank of a data
    row holds the same block."""
    rows = {}
    for r in ranks:
        data, _ = r["index"]
        block = r["outputs"][key].detach().float().numpy()
        if data in rows:
            np.testing.assert_array_equal(block, rows[data])
        rows[data] = block
    return np.concatenate([rows[i] for i in sorted(rows)])


def _ids(layout):
    return f"{layout[0]}x{layout[1]}"


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_ep_forward_matches_jax(ep, layout):
    ranks, want = ep[layout]
    np.testing.assert_allclose(_assembled(ranks, "torch.float32"), want["float32"],
                               rtol=TOL, atol=TOL)
    # and JAX's own oracle, the reference a data shard at a time
    inputs = _jax_inputs()
    params = moe.moe_params_from_jax(inputs, device="cpu")
    shards = np.split(inputs["x"], layout[0])
    ref = np.concatenate([moe.moe_ffn_reference(params, _cfg(), torch.from_numpy(s)).numpy()
                          for s in shards])
    np.testing.assert_allclose(_assembled(ranks, "torch.float32"), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_ep_forward_in_bf16_is_within_the_port_bar(ep, layout):
    ranks, want = ep[layout]
    assert _rel_rms(_assembled(ranks, "torch.bfloat16"), want["bfloat16"]) < BF16_REL


def _grad_blocks(ranks: list, case: str, layout) -> dict[str, np.ndarray]:
    """The router's gradient (equal on every rank) and the experts' (model
    rank r's experts from rank r of each data row, equal across rows)."""
    m = layout[1]
    local_e = SIZES["n_experts"] // m
    router = ranks[0]["grads"][case]["router"].numpy()
    blocks = {"w1": {}, "w2": {}}
    for r in ranks:
        np.testing.assert_array_equal(r["grads"][case]["router"].numpy(), router)
        _, model = r["index"]
        for name in blocks:
            g = r["grads"][case][name].numpy()
            assert g.shape[0] == local_e
            if model in blocks[name]:
                np.testing.assert_array_equal(g, blocks[name][model])
            blocks[name][model] = g
    return {"router": router,
            **{name: np.concatenate([b[i] for i in range(m)]) for name, b in blocks.items()}}


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_ep_gradients_match_jax_grad_of_the_global_loss(ep, layout):
    """Against JAX's EP where JAX differentiates it (2, 4), and against
    JAX's oracle, the gradient through the per-shard reference, on both."""
    ranks, want = ep[layout]
    got = _grad_blocks(ranks, "scaled", layout)
    for key in ("grads", "ref_grads"):
        if key not in want:
            assert layout == (1, 2) and key == "grads"
            continue
        for name, g in got.items():
            np.testing.assert_allclose(g, want[key][name], rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{key} {name}")
    for name, g in got.items():
        assert np.abs(g).max() > 0, f"{name} got no gradient"


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_a_gradient_not_scaled_for_the_replicated_output_fails(ep, layout):
    """Each rank's loss counted whole: every gradient is m times JAX's."""
    ranks, want = ep[layout]
    got = _grad_blocks(ranks, "unscaled", layout)
    for name, g in got.items():
        np.testing.assert_allclose(g / layout[1], want["ref_grads"][name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g, want["ref_grads"][name], rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


def test_a_planted_erf_gelu_fails_the_ep_bar(ep):
    ranks, want = ep[(2, 4)]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_assembled(ranks, "erf"), want["float32"], rtol=TOL, atol=TOL)


def test_ep_capacity_floor_keeps_tiny_blocks_alive(ep):
    """2 tokens a data shard over 4 experts (tests/test_parallelism.py:93)."""
    ranks, want = ep[(2, 4)]
    out = _assembled(ranks, "small")
    assert np.isfinite(out).all() and np.abs(out).sum() > 0, "every token was dropped"
    np.testing.assert_allclose(out, want["small"], rtol=TOL, atol=TOL)


def test_ep_refuses_experts_that_do_not_divide(ep):
    for r in ep[(2, 4)][0]:
        assert "divisible" in r["refused"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_params_from_jax_give_each_model_rank_its_experts(ep, layout):
    ranks, _ = ep[layout]
    inputs = _jax_inputs()
    local_e = SIZES["n_experts"] // layout[1]
    for r in ranks:
        _, model = r["index"]
        np.testing.assert_array_equal(r["params"]["router"].numpy(), inputs["router"])
        for name in ("w1", "w2"):
            np.testing.assert_array_equal(r["params"][name].numpy(),
                                          inputs[name][model * local_e:(model + 1) * local_e])


# ---- the load generator and the container ---------------------------------


def loadgen_rank(out_dir, params, x) -> None:
    """``MoELoadGen`` at (2, 4) with JAX's parameters and tokens: warmup and
    two bursts, as tests/test_parallelism.py runs JAX's."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(model_parallelism=4)
    gen = MoELoadGen(mesh=mesh, dtype=torch.float32, device="cpu", **GEN_SIZES)
    drawn = {"n_experts": gen.cfg.n_experts, "x": gen._x.shape}
    gen._params = moe.moe_params_from_jax({k: v.numpy() for k, v in params.items()}, mesh,
                                          device="cpu")
    data = mesh.get_local_rank(pm.DATA_AXIS)
    rows = GEN_SIZES["tokens_per_shard"]
    gen._x = x[data * rows:(data + 1) * rows].clone()
    gen.warmup()
    gen.step()
    gen.step()
    _save(out_dir, {"index": (data, mesh.get_local_rank(pm.MODEL_AXIS)), "drawn": drawn,
                    "outputs": {"x": gen._x}, "stats": gen.stats()})


def test_the_moe_rung_matches_the_jax_generator(tmp_path):
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.loadgen.moe import MoELoadGen as JaxMoELoadGen
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    jax_gen = JaxMoELoadGen(mesh=make_mesh(n_devices=8, model_parallelism=4),
                            dtype=jnp.float32, **GEN_SIZES)
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_gen._params.items()}
    x = torch.from_numpy(np.asarray(jax_gen._x))
    jax_gen.warmup()
    jax_gen.step()
    jax_gen.step()
    want = jax_gen.stats()
    ranks = run_ranks(loadgen_rank, 8, tmp_path, params, x)
    np.testing.assert_allclose(_assembled(ranks, "x"), np.asarray(jax_gen._x), rtol=GEN_TOL,
                               atol=GEN_TOL)
    for r in ranks:
        s = r["stats"]
        assert r["drawn"] == {"n_experts": jax_gen.cfg.n_experts,
                              "x": (GEN_SIZES["tokens_per_shard"], GEN_SIZES["d_model"])}
        # 16 tokens × 2 data shards × 2 FFNs × 2 bursts
        assert s.bursts == want.bursts == 2
        assert s.tokens_routed == want.tokens_routed == 128
        assert s.a2a_bytes_per_burst == want.a2a_bytes_per_burst > 0
        assert s.tokens_per_sec > 0 and s.a2a_gbps > 0
    # the re-normalization keeps the chain bounded
    assert np.abs(_assembled(ranks, "x")).max() < 50.0


def test_the_slice_container_runs_moe_over_two_processes_until_sigterm(tmp_path):
    """``WORKLOAD=moe`` as the slice's two processes: the generator's own
    mesh, a model axis of 2 (the world is even), in the banner; JAX's report
    line; exit 0 on SIGTERM."""
    lines, codes = run_slice({"WORKLOAD": "moe", "D_MODEL": "32", "D_FF": "64",
                              "TOKENS_PER_SHARD": "16", "REPORT_S": "0.2",
                              "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob")}, "bursts=")
    assert codes == [0, 0], lines
    banner = next(ln for ln in lines if ln.startswith("tpu-test multihost loadgen"))
    assert banner.startswith("tpu-test multihost loadgen (moe): process 0/2 slice=0")
    assert "mesh={'data': 1, 'model': 2}" in banner
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in lines
               if ln.startswith("bursts=")]
    assert len(reports) >= 2 and int(reports[-1]["bursts"]) > 0
    assert float(reports[-1]["a2a"].removesuffix("GB/s")) >= 0  # 20 kB a burst: 0.00 here
    assert float(reports[-1]["tok/s"]) > 0
