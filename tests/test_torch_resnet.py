"""The port's ResNet (models/resnet.py) against the JAX package's flax model.

The same numpy images and flax's variables, carried across by
``params_from_jax``, go through both on the CPU.  Flax initialises every
``bn3`` scale to zero, which would hide the blocks' residual branches (and
``conv2``, whose padding is the trap), so the BatchNorm scales, biases and
running statistics are redrawn from a numpy seed first.  f32 is held at
2e-4 and bf16 at 0.06, the port's bars; the training forward's BatchNorm
running statistics are held too.  A planted symmetric stride-2 pad and
PyTorch's own running update (the unbiased variance) each fail the test
they plant into."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_gpu_hpa_tpu.models import resnet as jr
from k8s_gpu_hpa_tpu_torch.models import resnet as pr
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

F32_TOL = 2e-4
BF16_TOL = 0.06


def _variables(jmodel, shape, seed=0):
    """Flax's variables for ``jmodel`` as numpy, BatchNorm leaves redrawn."""
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, *shape[1:])), train=True)
    rng = np.random.default_rng(seed + 100)

    def redraw(tree, draw):
        return {k: redraw(v, draw) if isinstance(v, dict) else draw(k, np.asarray(v))
                for k, v in tree.items()}

    params = redraw(variables["params"], lambda k, v: (
        rng.uniform(0.5, 1.5, v.shape) if k == "scale" else
        rng.normal(0.0, 0.1, v.shape) if k == "bias" else v).astype(np.float32))
    stats = redraw(variables["batch_stats"], lambda k, v: (
        rng.normal(0.0, 0.1, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)
    ).astype(np.float32))
    return {"params": params, "batch_stats": stats}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _forward_errors(jmodel, pmodel, shape, train, seed=0) -> dict:
    """Largest differences between the two forwards on one numpy batch
    (NHWC for flax, the same memory as channels_last NCHW for the port):
    the logits, over the logits' largest magnitude, and in training mode
    each running statistic after the forward."""
    variables = _variables(jmodel, shape, seed)
    pmodel.load_state_dict(pr.params_from_jax(variables))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if train:
        want, updates = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x).permute(0, 3, 1, 2), train=train)
    assert got.dtype == torch.float32 and got.shape == want.shape
    want = np.asarray(want)
    errs = {"logits": float(np.abs(got.numpy() - want).max() / np.abs(want).max())}
    if train:
        state = pmodel.state_dict()
        for name, value in _flatten(jax.tree.map(np.asarray, updates["batch_stats"])).items():
            module, stat = name.rsplit(".", 1)
            key = f"{module}.running_{stat}"
            errs[key] = float(np.abs(state[key].numpy() - value).max())
    return errs


def _assert_within(errs: dict, tol: float) -> None:
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, bad


@pytest.mark.parametrize("size, kernel, stride", [
    (32, 3, 1), (32, 3, 2), (16, 3, 2), (8, 3, 2), (2, 3, 2), (7, 3, 2), (32, 1, 2),
    (224, 7, 2), (112, 3, 2), (36, 7, 2), (9, 3, 2),
])
def test_same_padding_is_flax_s(size, kernel, stride):
    (want,) = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert pr.same_padding(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet18ish_forward_matches_flax(dtype, train):
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    errs = _forward_errors(jr.resnet18ish(dtype=jdtype), pr.resnet18ish(dtype=tdtype),
                           (4, 8, 8, 3), train)
    _assert_within(errs, F32_TOL if dtype == "float32" else BF16_TOL)


def test_resnet50_forward_matches_flax_through_every_stride2_pad_and_projection():
    """Image 32, batch 2: the first block of stages 1-3 has a stride-2 3x3
    conv over an even input (SAME pads (0, 1)) and a stride-2 projection;
    stage 0's first block projects at stride 1."""
    errs = _forward_errors(jr.resnet50(dtype=jnp.float32), pr.resnet50(dtype=torch.float32),
                           (2, 32, 32, 3), train=True)
    _assert_within(errs, F32_TOL)


def test_imagenet_stem_forward_matches_flax():
    """``cifar_stem=False`` at image 36: the 7x7/2 stem pads (2, 3) and the
    SAME max-pool pads (0, 1) with -inf.  In inference mode: in training
    mode stage 3 normalises over 8 values a channel (2x2, batch 2), and the
    two packages' f32 roundings, amplified through the blocks, reach 3e-4
    of the logits there (1e-7 at the stem's statistics)."""
    errs = _forward_errors(
        jr.resnet50(cifar_stem=False, dtype=jnp.float32),
        pr.resnet50(cifar_stem=False, dtype=torch.float32), (2, 36, 36, 3), train=False,
    )
    _assert_within(errs, F32_TOL)


def test_a_symmetric_stride2_pad_fails_the_padding_test(monkeypatch):
    """PyTorch's habit, ``padding=1`` on a stride-2 3x3 conv: the output has
    the right shape and shifted windows."""
    flax_pads = pr.same_padding

    def symmetric(size, kernel, stride):
        return (1, 1) if (kernel, stride) == (3, 2) else flax_pads(size, kernel, stride)

    monkeypatch.setattr(pr, "same_padding", symmetric)
    errs = _forward_errors(jr.resnet50(dtype=jnp.float32), pr.resnet50(dtype=torch.float32),
                           (2, 32, 32, 3), train=True)
    with pytest.raises(AssertionError):
        _assert_within(errs, F32_TOL)


def test_pytorch_s_unbiased_running_variance_fails_the_statistics_test(monkeypatch):
    """``F.batch_norm``'s own running update, momentum 0.1 into the running
    buffers: the unbiased variance, n/(n-1) of flax's."""

    def torch_default(self, x, train, dtype):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=train, momentum=1.0 - pr.BN_MOMENTUM,
                            eps=pr.BN_EPS).to(dtype)

    monkeypatch.setattr(pr.BatchNorm, "forward", torch_default)
    errs = _forward_errors(jr.resnet18ish(dtype=jnp.float32), pr.resnet18ish(dtype=torch.float32),
                           (4, 8, 8, 3), train=True)
    assert errs["logits"] <= F32_TOL  # the forward itself is right
    with pytest.raises(AssertionError, match="running_var"):
        _assert_within(errs, F32_TOL)


def test_params_from_jax_fills_every_parameter_and_buffer_in_place():
    jmodel = jr.resnet18ish()
    variables = _variables(jmodel, (1, 8, 8, 3))
    state = pr.params_from_jax(variables)
    model = pr.resnet18ish()
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict: names and shapes agree
    params = variables["params"]
    np.testing.assert_array_equal(
        model.stage1_block0.conv2.weight.detach().numpy(),
        np.transpose(params["stage1_block0"]["conv2"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(model.head.weight.detach().numpy(),
                                  params["head"]["kernel"].T)
    np.testing.assert_array_equal(model.stem_bn.running_var.numpy(),
                                  variables["batch_stats"]["stem_bn"]["var"])
    assert set(variables["params"]["stage0_block0"]) >= {"proj_conv", "proj_bn"}


def test_init_follows_flax_s_scheme_from_the_generator():
    model = pr.init_params(pr.resnet50(), torch.Generator().manual_seed(3))
    again = pr.init_params(pr.resnet50(), torch.Generator().manual_seed(3))
    other = pr.init_params(pr.resnet50(), torch.Generator().manual_seed(4))
    for (name, p), q, r in zip(model.state_dict().items(), again.state_dict().values(),
                               other.state_dict().values()):
        assert torch.equal(p, q), name
        if p.dim() == 4 or name == "head.weight":
            assert not torch.equal(p, r), name
    w = model.stage2_block0.conv2.weight
    fan_in = w[0].numel()
    limit = 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= limit
    assert abs(float(w.detach().std()) * fan_in**0.5 - 1.0) < 0.05  # lecun: variance 1/fan_in
    assert torch.all(model.stage0_block0.bn3.weight == 0)
    assert torch.all(model.stage0_block0.bn1.weight == 1)
    assert torch.all(model.head.bias == 0)
    assert torch.all(model.stem_bn.running_var == 1) and torch.all(model.stem_bn.running_mean == 0)


def test_channels_last_and_contiguous_inputs_give_the_same_logits():
    model = pr.init_params(pr.resnet18ish(dtype=torch.float32), torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model(x, train=False)
        b = model.to(memory_format=torch.channels_last)(
            x.to(memory_format=torch.channels_last), train=False)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
