"""Long-context LLM training load generator: the decoder transformer
(models/transformer.py) taking SGD steps in a busy loop, under the standard
duty-cycle knob.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/llm.py`` for one device: each step
is a forward, its layer-remat recompute and a backward over the whole
context, the attention on the hand-written flash kernels (forward twice a
layer, dQ and dK/dV once a layer) unless ``attn_impl="ring"`` forces the
plain blocking.  The sequence-parallel ring over several devices is ROADMAP
item 10.  Checkpoints go through the training rung's manager
(``loadgen/train.py``, the port's own format, not orbax's).  Selectable in
the multi-host container via ``WORKLOAD=llm`` (loadgen/multihost.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.loadgen.train import CheckpointManager
from k8s_gpu_hpa_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    make_train_step,
    params_from_jax,
)


@dataclass
class LlmStats:
    steps: int
    context_length: int
    last_loss: float
    tokens_per_sec: float
    seconds: float


class LlmLoadGen:
    """Busy-loop of causal-LM training steps over one device's context.
    ``device`` is CUDA unless the caller passes ``"cpu"``."""

    def __init__(
        self,
        seq_per_device: int = 2048,
        batch: int = 1,
        d_model: int = 512,
        # head_dim 128 (512/4) sits inside the flash kernels' envelope, as 8
        # heads of 64 would too; attention FLOPs do not depend on the head
        # count at fixed d_model
        n_heads: int = 4,
        n_layers: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        lr: float = 1e-3,
        attn_impl: str = "auto",
        device: str | torch.device | None = None,
    ):
        self.device = resolve(device)
        self.cfg = TransformerConfig(
            d_model=d_model,
            n_heads=n_heads,
            n_layers=n_layers,
            d_ff=4 * d_model,
            max_seq=seq_per_device,  # times the ring's one device
            dtype=dtype,
        )
        self.batch = batch
        self._params = init_params(self.cfg, torch.Generator().manual_seed(0), self.device)
        self._step = make_train_step(self.cfg, lr=lr, attn_impl=attn_impl)
        self._tokens = torch.randint(
            0, self.cfg.vocab, (batch, self.cfg.max_seq),
            generator=torch.Generator().manual_seed(1),
        ).to(self.device)
        self._steps = 0
        self._busy = 0.0
        self._last_loss = float("nan")

    @property
    def params(self) -> dict:
        """The live parameters: the last step's output."""
        return self._params

    @property
    def tokens(self) -> torch.Tensor:
        """The training batch [batch, seq_per_device] on the device."""
        return self._tokens

    def set_params(self, params_np: dict) -> None:
        """Replace the weights with a JAX parameter pytree of numpy arrays."""
        self._params = params_from_jax(params_np, self.cfg, self.device)

    def set_tokens(self, tokens: np.ndarray) -> None:
        """Replace the training batch [batch, seq_per_device]."""
        self._tokens = torch.from_numpy(np.asarray(tokens, dtype=np.int64)).to(self.device)

    def warmup(self) -> None:
        """One step (builds and loads the kernels); accounting starts after it."""
        self._params, loss = self._step(self._params, self._tokens)
        self._last_loss = float(loss)

    def step(self) -> float:
        t0 = time.perf_counter()
        self._params, loss = self._step(self._params, self._tokens)
        self._last_loss = float(loss)  # reading the loss waits for the step
        dt = time.perf_counter() - t0
        self._busy += dt
        self._steps += 1
        return dt

    def stats(self) -> LlmStats:
        tokens = self.batch * self.cfg.max_seq * self._steps
        return LlmStats(
            steps=self._steps,
            context_length=self.cfg.max_seq,
            last_loss=self._last_loss,
            tokens_per_sec=tokens / self._busy if self._busy else 0.0,
            seconds=self._busy,
        )

    # ---- checkpoint / resume (the same contract as loadgen/train.py) -------

    def checkpoint_state(self) -> dict:
        return {"params": self._params, "step": self._steps, "busy": self._busy}

    def save_checkpoint(self, manager: CheckpointManager) -> None:
        manager.save(self._steps, self.checkpoint_state())

    def restore_checkpoint(self, manager: CheckpointManager) -> bool:
        """Resume from the newest checkpoint; False when none exists."""
        latest = manager.latest_step()
        if latest is None:
            return False
        restored = manager.restore(latest, map_location=self.device)
        self._params = restored["params"]
        self._steps = int(restored["step"])
        self._busy = float(restored["busy"])
        return True
