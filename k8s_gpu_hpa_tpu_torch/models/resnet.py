"""ResNet-50 as ``nn.Module``s: the training rung's model.

Counterpart of ``k8s_gpu_hpa_tpu/models/resnet.py`` (flax), with the same
module names (``stem_conv``, ``stem_bn``, ``stage{s}_block{b}`` with
``conv1``-``conv3``, ``bn1``-``bn3``, ``proj_conv``, ``proj_bn``; ``head``)
so that ``params_from_jax`` carries flax's variables across name for name.
Convolutions compute in ``dtype`` (bf16 by default) from f32 parameters;
BatchNorm normalises in f32 and returns ``dtype``; the head is f32.  On the
card activations are NCHW tensors in ``torch.channels_last`` memory format,
the JAX model's NHWC in memory.  The convolutions are cuDNN's, BatchNorm
PyTorch's own kernels and the head cuBLAS's, as XLA's are in the JAX
package: no Pallas kernel backs this model there.

Two of flax's conventions differ from PyTorch's defaults, and both are kept:

- ``padding="SAME"`` pads ``total = max((ceil(n/s)-1)*s + k - n, 0)``
  with the smaller half first: a stride-2 3×3 conv over an even input pads
  (0, 1), not (1, 1), and the ImageNet stem's 7×7/2 conv at 224 pads
  (2, 3).  Its max-pool is SAME with −inf.
- BatchNorm's running variance moves by the *biased* batch variance
  (``ra = 0.9·ra + 0.1·var``, statistics in f32).  ``F.batch_norm``'s own
  running update uses the unbiased one, so each layer lets it write the
  batch statistics alone (momentum 1 into scratch buffers) and the model
  folds them into the running buffers at the end of the forward, biased,
  in a few ``foreach`` launches for all layers.

Under data parallelism (loadgen/train.py over a mesh) flax's BatchNorm,
jitted over a batch sharded on ``data``, averages over the whole batch:
XLA inserts the reductions.  Here ``ResNet.set_data_group`` hands every
layer the data group, and a layer with a group of more than one rank
computes its f32 statistics over the global batch in two passes (an
all_reduce of the per-channel sums, then of the squared deviations from
the global mean) whose backward sums the gradients over the group, so the
step's gradient is the global batch's.  With no group, or a group of one,
the layers run ``F.batch_norm`` as above.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

#: flax's BatchNorm: ``momentum=0.9, epsilon=1e-5``
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax's ``padding="SAME"`` for one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Conv(nn.Module):
    """A bias-free convolution with flax's SAME padding; the weight is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        k = self.weight.shape[-1]
        (top, bottom), (left, right) = (
            same_padding(n, k, self.stride) for n in x.shape[-2:]
        )
        w = self.weight.to(dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=self.stride)


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (SUM) over ``group`` whose backward sums the incoming
    gradients over the group in turn: every rank's input reaches every
    rank's output.  (``torch.distributed.nn.functional.all_reduce`` does the
    same and is deprecated in recent PyTorch.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.Module):
    """Flax's ``BatchNorm``: f32 statistics over (N, H, W), normalisation in
    f32, output in the compute dtype.  In training mode the batch's mean and
    unbiased variance land in the scratch buffers, and the owning
    ``ResNet`` folds them into the running buffers (``fold_batch_stats``).
    With a data ``group`` the batch is the global one: every rank of the
    group holds as many values a channel (the training generator splits its
    batch evenly)."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        # zeros, never empty: the momentum-1 update multiplies them by 0
        self.register_buffer("batch_mean", torch.zeros(channels), persistent=False)
        self.register_buffer("batch_var", torch.zeros(channels), persistent=False)
        #: elements a channel's statistics ran over in the last training
        #: forward, on every rank of the group; 0 when there is nothing to fold
        self.count = 0
        #: the data group the statistics run over; None: this rank's batch
        self.group = None

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype) -> torch.Tensor:
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=BN_EPS)
            return y.to(dtype)
        if self.group is not None:
            return self._global_batch(x, dtype)
        self.count = x.numel() // x.shape[1]
        y = F.batch_norm(x, self.batch_mean, self.batch_var, self.weight, self.bias,
                         training=True, momentum=1.0, eps=BN_EPS)
        return y.to(dtype)

    def _global_batch(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Training mode over the group's global batch: the mean from the
        summed per-channel sums over the global count, then the biased
        variance from the summed squared deviations from it."""
        xf = x.float()
        count = xf.numel() // xf.shape[1] * dist.get_world_size(self.group)
        mean = _AllReduceSum.apply(xf.sum((0, 2, 3)), self.group) / count
        centred = xf - mean[:, None, None]
        squares = _AllReduceSum.apply(centred.square().sum((0, 2, 3)), self.group)
        scale = torch.rsqrt(squares / count + BN_EPS) * self.weight
        y = centred * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            self.batch_mean.copy_(mean)
            self.batch_var.copy_(squares / (count - 1))
        self.count = count
        return y.to(dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int = 1, expansion: int = 4):
        super().__init__()
        out_ch = filters * expansion
        self.conv1 = Conv(in_ch, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, strides)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, out_ch, 1)
        self.bn3 = BatchNorm(out_ch, zero_scale=True)
        # flax projects where the residual's shape differs from the output's
        if strides != 1 or in_ch != out_ch:
            self.proj_conv = Conv(in_ch, out_ch, 1, strides)
            self.proj_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, dtype), train, dtype))
        y = F.relu(self.bn2(self.conv2(y, dtype), train, dtype))
        y = self.bn3(self.conv3(y, dtype), train, dtype)
        residual = x
        if hasattr(self, "proj_conv"):
            residual = self.proj_bn(self.proj_conv(x, dtype), train, dtype)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-v1.5 with bottleneck blocks; ``cifar_stem`` swaps the 7×7/maxpool
    ImageNet stem for the 3×3 stem used on 32×32 inputs.  ``forward`` takes
    NCHW images, any float dtype, and returns f32 logits."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        num_classes: int = 10,
        num_filters: int = 64,
        cifar_stem: bool = True,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.cifar_stem = cifar_stem
        self.dtype = dtype
        self.stem_conv = Conv(3, num_filters, 3 if cifar_stem else 7, 1 if cifar_stem else 2)
        self.stem_bn = BatchNorm(num_filters)
        in_ch = num_filters
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blk = BottleneckBlock(in_ch, num_filters * 2**stage, strides)
                self.add_module(f"stage{stage}_block{block}", blk)
                in_ch = blk.conv3.weight.shape[0]
        self.head = nn.Linear(in_ch, num_classes)
        self._norms = [m for m in self.modules() if isinstance(m, BatchNorm)]

    def set_data_group(self, group) -> None:
        """Every BatchNorm's statistics over the global batch of ``group``'s
        ranks; None, or a group of one rank, for this rank's batch alone."""
        if group is not None and dist.get_world_size(group) == 1:
            group = None
        for m in self._norms:
            m.group = group

    def blocks(self) -> list[BottleneckBlock]:
        return [
            getattr(self, f"stage{s}_block{b}")
            for s, n in enumerate(self.stage_sizes)
            for b in range(n)
        ]

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dtype = self.dtype
        x = self.stem_conv(x.to(dtype), dtype)
        x = F.relu(self.stem_bn(x, train, dtype))
        if not self.cifar_stem:
            (top, bottom), (left, right) = (same_padding(n, 3, 2) for n in x.shape[-2:])
            x = F.pad(x, (left, right, top, bottom), value=-math.inf)
            x = F.max_pool2d(x, 3, 2)
        for blk in self.blocks():
            x = blk(x, train, dtype)
        x = x.mean((2, 3))
        logits = self.head(x.float())
        if train:
            self.fold_batch_stats()
        return logits

    @torch.no_grad()
    def fold_batch_stats(self) -> None:
        """Move every running buffer by its layer's last batch statistics, as
        flax does: ``ra = 0.9·ra + 0.1·batch``, with the biased variance
        (the scratch holds the unbiased one: times (n-1)/n)."""
        norms = [m for m in self._norms if m.count]
        if not norms:
            return
        biased = torch._foreach_mul(
            [m.batch_var for m in norms], [(m.count - 1) / m.count for m in norms]
        )
        weight = 1.0 - BN_MOMENTUM
        torch._foreach_lerp_([m.running_mean for m in norms], [m.batch_mean for m in norms], weight)
        torch._foreach_lerp_([m.running_var for m in norms], biased, weight)
        for m in norms:
            m.count = 0


def resnet50(
    num_classes: int = 10, cifar_stem: bool = True, dtype: torch.dtype = torch.bfloat16
) -> ResNet:
    """ResNet-50; its weights come from ``init_params`` or ``params_from_jax``."""
    return ResNet((3, 4, 6, 3), num_classes=num_classes, cifar_stem=cifar_stem, dtype=dtype)


def resnet18ish(num_classes: int = 10, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    """Small bottleneck net for CPU tests (same code path, 1/4 depth)."""
    return ResNet((1, 1, 1, 1), num_classes=num_classes, num_filters=16, cifar_stem=True,
                  dtype=dtype)


def init_params(model: ResNet, gen: torch.Generator) -> ResNet:
    """Flax's initialisation, drawn from ``gen``: lecun-normal convolutions
    and head, a zero head bias, BatchNorm scales one (``bn3``'s zero) and
    biases zero, running means zero and variances one.  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, Conv):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
    _lecun_normal_(model.head.weight, model.head.weight.shape[1], gen)
    with torch.no_grad():
        model.head.bias.zero_()
    return model


def params_from_jax(variables_np: dict) -> dict[str, torch.Tensor]:
    """Flax's ``{"params": ..., "batch_stats": ...}`` (numpy leaves) as a
    ``ResNet`` state dict: conv kernels HWIO → OIHW, the Dense kernel
    (in, out) → (out, in), ``scale``/``bias`` → ``weight``/``bias``,
    ``mean``/``var`` → the running buffers.  Load it with
    ``model.load_state_dict``."""
    state = {}

    def walk(params: dict, stats: dict, prefix: str) -> None:
        for name, leaf in params.items():
            key = f"{prefix}{name}"
            if "kernel" in leaf and np.ndim(leaf["kernel"]) == 4:
                state[f"{key}.weight"] = np.transpose(leaf["kernel"], (3, 2, 0, 1))
            elif "kernel" in leaf:
                state[f"{key}.weight"] = np.transpose(leaf["kernel"])
                state[f"{key}.bias"] = leaf["bias"]
            elif "scale" in leaf:
                state[f"{key}.weight"] = leaf["scale"]
                state[f"{key}.bias"] = leaf["bias"]
                state[f"{key}.running_mean"] = stats[name]["mean"]
                state[f"{key}.running_var"] = stats[name]["var"]
            else:
                walk(leaf, stats.get(name, {}), f"{key}.")

    walk(variables_np["params"], variables_np["batch_stats"], "")
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()
    }
