"""Pipeline parallelism on the CPU: the port's microbatched stage pipeline
on gloo ranks in the (2, 4) and (1, 2) layouts against the JAX package's
``make_pp_forward`` on the virtual CPU devices of tests/conftest.py, from
the same parameters and batch (tests/test_parallelism.py:119-160's sizes
and bars):

- the forward at f32 2e-5, against JAX's pipeline and its sequential stack;
- the gradients at 2e-4 against ``jax.grad`` of the global loss, and a
  gradient not scaled for the model axis's replicated output planted,
  which must fail;
- the refusals of layers that do not divide and of a local batch that the
  microbatches do not divide;
- ``pp_forward_reference`` against JAX's, and the parameter converter.

Rank bodies live at the top level and JAX is imported inside the tests."""

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu_torch.models import pipeline
from k8s_gpu_hpa_tpu_torch.parallel import mesh as pm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import _save, run_ranks

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TOL, GRAD_TOL = 2e-5, 2e-4
#: tests/test_parallelism.py's pipeline: d_model 32, d_ff 64, 8 layers;
#: batch 16 in 4 microbatches
SIZES = dict(d_model=32, d_ff=64, n_layers=8)
BATCH, N_MICRO = 16, 4
LAYOUTS = [(2, 4), (1, 2)]


def _cfg(**over) -> pipeline.PipelineConfig:
    return pipeline.PipelineConfig(**{**SIZES, "dtype": torch.float32, **over})


def _jax_cfg(dtype: str = "float32"):
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.pipeline import PipelineConfig

    return PipelineConfig(**SIZES, dtype=getattr(jnp, dtype))


def _jax_inputs() -> dict:
    """tests/test_parallelism.py's parameters (key 0) and batch (key 1,
    times 0.5), as numpy."""
    import jax

    from k8s_gpu_hpa_tpu.models.pipeline import init_pp_params

    params = init_pp_params(jax.random.PRNGKey(0), _jax_cfg())
    x = jax.random.normal(jax.random.PRNGKey(1), (BATCH, SIZES["d_model"])) * 0.5
    return {**{k: np.asarray(v) for k, v in params.items()}, "x": np.asarray(x)}


def test_reference_matches_jax():
    import jax.numpy as jnp

    from k8s_gpu_hpa_tpu.models.pipeline import pp_forward_reference

    inputs = _jax_inputs()
    got = pipeline.pp_forward_reference(pipeline.pp_params_from_jax(inputs, device="cpu"),
                                        _cfg(), torch.tensor(inputs["x"]))
    want = pp_forward_reference({k: jnp.asarray(inputs[k]) for k in ("w1", "w2")}, _jax_cfg(),
                                jnp.asarray(inputs["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_params_from_jax_keep_their_dtype_and_values():
    import jax

    from k8s_gpu_hpa_tpu.models.pipeline import init_pp_params

    for dtype in ("float32", "bfloat16"):
        want = {k: np.asarray(v) for k, v in
                init_pp_params(jax.random.PRNGKey(0), _jax_cfg(dtype)).items()}
        got = pipeline.pp_params_from_jax(want, device="cpu")
        for name, w in want.items():
            assert got[name].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(got[name].float().numpy(), w.astype(np.float32))


def test_the_pipeline_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.init_pp_params(torch.Generator().manual_seed(0), _cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.pp_params_from_jax(_jax_inputs())


def pp_rank(out_dir, inputs, p) -> None:
    """This rank's pipeline output, its stage's f32 gradients with the loss
    scaled by 1/p and without, its parameter shard, and the refusals."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(model_parallelism=p)
    n_data = pm.mesh_shape(mesh)[pm.DATA_AXIS]
    data = mesh.get_local_rank(pm.DATA_AXIS)
    rows = BATCH // n_data
    x = inputs["x"][data * rows:(data + 1) * rows]
    params = pipeline.pp_params_from_jax({k: inputs[k].numpy() for k in ("w1", "w2")}, mesh,
                                         device="cpu")
    fwd = pipeline.make_pp_forward(mesh, _cfg(), n_micro=N_MICRO)
    out = {"index": (data, mesh.get_local_rank(pm.MODEL_AXIS)), "params": params,
           "outputs": {"y": fwd(params, x)}, "grads": {}, "refused": {}}
    for case, share in (("scaled", 1.0 / p), ("unscaled", 1.0)):
        w = {k: v.clone().requires_grad_() for k, v in params.items()}
        (fwd(w, x).square().sum() * share).backward()
        for name in w:
            if n_data > 1:
                torch.distributed.all_reduce(w[name].grad, group=mesh.get_group(pm.DATA_AXIS))
        out["grads"][case] = {k: v.grad for k, v in w.items()}
    for case, call in (
        ("layers", lambda: pipeline.make_pp_forward(mesh, _cfg(n_layers=6))),
        ("micro", lambda: pipeline.make_pp_forward(mesh, _cfg(), n_micro=3)(params, x)),
    ):
        try:
            call()
        except ValueError as e:
            out["refused"][case] = str(e)
    _save(out_dir, out)


def _jax_pp(layout: tuple[int, int], inputs: dict) -> dict:
    """JAX's pipeline output and the f32 gradients of the global loss
    ``sum(out²)``; its sequential stack's output and gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from k8s_gpu_hpa_tpu.models.pipeline import make_pp_forward, pp_forward_reference
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh

    n_data, p = layout
    mesh = make_mesh(n_devices=n_data * p, model_parallelism=p)
    params = {k: jnp.asarray(inputs[k]) for k in ("w1", "w2")}
    x = jnp.asarray(inputs["x"])
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    ps = jax.device_put(params, NamedSharding(mesh, P()))
    fwd = make_pp_forward(mesh, _jax_cfg(), n_micro=N_MICRO)
    g = jax.grad(lambda q: jnp.sum(jnp.square(fwd(q, xs))))(ps)
    gref = jax.grad(lambda q: jnp.sum(jnp.square(pp_forward_reference(q, _jax_cfg(), x))))(params)
    return {"y": np.asarray(fwd(ps, xs)), "ref": np.asarray(pp_forward_reference(params,
                                                                                  _jax_cfg(), x)),
            "grads": {k: np.asarray(v) for k, v in g.items()},
            "ref_grads": {k: np.asarray(v) for k, v in gref.items()}}


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    inputs = _jax_inputs()
    tensors = {k: torch.tensor(v) for k, v in inputs.items()}
    return {layout: (run_ranks(pp_rank, layout[0] * layout[1],
                               tmp_path_factory.mktemp(f"pp{layout[0]}x{layout[1]}"),
                               tensors, layout[1]),
                     _jax_pp(layout, inputs))
            for layout in LAYOUTS}


def _ids(layout):
    return f"{layout[0]}x{layout[1]}"


def _assembled(ranks: list) -> np.ndarray:
    """The global output from the data shards; every stage of a data row
    returns the same block."""
    rows = {}
    for r in ranks:
        data, _ = r["index"]
        block = r["outputs"]["y"].detach().numpy()
        if data in rows:
            np.testing.assert_array_equal(block, rows[data])
        rows[data] = block
    return np.concatenate([rows[i] for i in sorted(rows)])


def _stages(ranks: list, case: str, p: int) -> dict[str, np.ndarray]:
    """Each weight's gradient over all layers, stage s's layers from rank s
    of each data row (equal across rows after the data axis's sum)."""
    blocks = {"w1": {}, "w2": {}}
    for r in ranks:
        _, stage = r["index"]
        for name in blocks:
            g = r["grads"][case][name].numpy()
            assert g.shape[0] == SIZES["n_layers"] // p
            if stage in blocks[name]:
                np.testing.assert_array_equal(g, blocks[name][stage])
            blocks[name][stage] = g
    return {name: np.concatenate([b[s] for s in range(p)]) for name, b in blocks.items()}


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_pp_forward_matches_jax_and_the_sequential_stack(pp, layout):
    ranks, want = pp[layout]
    np.testing.assert_allclose(_assembled(ranks), want["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_assembled(ranks), want["ref"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_pp_gradients_match_jax_grad_of_the_global_loss(pp, layout):
    ranks, want = pp[layout]
    got = _stages(ranks, "scaled", layout[1])
    for key in ("grads", "ref_grads"):
        for name, g in got.items():
            np.testing.assert_allclose(g, want[key][name], rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{key} {name}")
    for name, g in got.items():
        assert np.abs(g).max() > 0, f"{name} got no gradient"


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_a_gradient_not_scaled_for_the_replicated_output_fails(pp, layout):
    """Each stage's loss counted whole: every gradient is p times JAX's."""
    ranks, want = pp[layout]
    got = _stages(ranks, "unscaled", layout[1])
    for name, g in got.items():
        np.testing.assert_allclose(g / layout[1], want["grads"][name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g, want["grads"][name], rtol=GRAD_TOL, atol=GRAD_TOL)


def test_pp_refuses_layers_or_batches_that_do_not_divide(pp):
    for r in pp[(2, 4)][0]:
        assert "divisible by the model axis" in r["refused"]["layers"]
        assert "divisible by n_micro (3)" in r["refused"]["micro"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_params_from_jax_give_each_stage_its_layers(pp, layout):
    ranks, _ = pp[layout]
    inputs = _jax_inputs()
    per_stage = SIZES["n_layers"] // layout[1]
    for r in ranks:
        _, stage = r["index"]
        for name in ("w1", "w2"):
            np.testing.assert_array_equal(r["params"][name].numpy(),
                                          inputs[name][stage * per_stage:(stage + 1) * per_stage])
