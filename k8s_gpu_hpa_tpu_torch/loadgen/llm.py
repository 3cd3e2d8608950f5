"""Long-context LLM training load generator: the decoder transformer
(models/transformer.py) taking SGD steps in a busy loop, under the standard
duty-cycle knob.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/llm.py``.  Over a mesh the context
is ``n`` times one rank's, sharded over the data axis: each step runs
``n_layers`` K/V rings (``ops/ring_attention.py``) and one all_reduce of the
gradients, the signature of ring-attention training.  On one rank (no mesh,
or a data axis of one) each step is a forward, its layer-remat recompute and
a backward over the whole context, the attention on the hand-written flash
kernels (forward twice a layer, dQ and dK/dV once a layer) unless
``attn_impl="ring"`` forces the plain blocking.  Checkpoints go through the
training rung's manager (``loadgen/train.py``, the port's own format, not
orbax's); rank 0 writes them.  Selectable in the multi-host container via
``WORKLOAD=llm`` (loadgen/multihost.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.loadgen.train import CheckpointManager
from k8s_gpu_hpa_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    make_train_step,
    params_from_jax,
)
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, mesh_shape


@dataclass
class LlmStats:
    steps: int
    context_length: int
    last_loss: float
    tokens_per_sec: float
    seconds: float


class LlmLoadGen:
    """Busy-loop of causal-LM training steps over a context sharded on the
    mesh's data axis (``mesh``, else ``make_mesh()`` when a process group is
    up, else one device).  ``device`` is CUDA unless the caller passes
    ``"cpu"``."""

    def __init__(
        self,
        mesh: DeviceMesh | None = None,
        seq_per_device: int = 2048,
        batch: int = 1,
        d_model: int = 512,
        # head_dim 128 (512/4) sits inside the flash kernels' envelope, as 8
        # heads of 64 would too, and in bf16 and f16 any multiple of 128 to
        # 512; attention FLOPs do not depend on the head count at fixed d_model
        n_heads: int = 4,
        n_layers: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        lr: float = 1e-3,
        attn_impl: str = "auto",
        device: str | torch.device | None = None,
    ):
        self.device = resolve(device)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh()
        self.mesh = mesh
        n = 1 if mesh is None else mesh_shape(mesh)[DATA_AXIS]
        self.data_index = 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)
        self.cfg = TransformerConfig(
            d_model=d_model,
            n_heads=n_heads,
            n_layers=n_layers,
            d_ff=4 * d_model,
            max_seq=seq_per_device * n,  # the context of the whole ring
            dtype=dtype,
        )
        self.seq_per_device = seq_per_device
        self.batch = batch
        # every rank draws the same weights and the same global batch
        self._params = init_params(self.cfg, torch.Generator().manual_seed(0), self.device)
        self._step = make_train_step(self.cfg, lr=lr, attn_impl=attn_impl, mesh=mesh)
        self.set_tokens(torch.randint(
            0, self.cfg.vocab, (batch, self.cfg.max_seq),
            generator=torch.Generator().manual_seed(1),
        ).numpy())
        self._steps = 0
        self._busy = 0.0
        self._last_loss = float("nan")

    @property
    def params(self) -> dict:
        """The live parameters: the last step's output."""
        return self._params

    @property
    def tokens(self) -> torch.Tensor:
        """This rank's shard of the training batch, [batch, seq_per_device],
        on the device."""
        return self._tokens

    def set_params(self, params_np: dict) -> None:
        """Replace the weights with a JAX parameter pytree of numpy arrays."""
        self._params = params_from_jax(params_np, self.cfg, self.device)

    def set_tokens(self, tokens: np.ndarray) -> None:
        """Replace the training batch by the global [batch, context] array
        ``tokens``: this rank keeps its sequence shard."""
        tokens = np.asarray(tokens, dtype=np.int64)
        if tokens.shape != (self.batch, self.cfg.max_seq):
            raise ValueError(f"a batch of shape {tokens.shape}, not "
                             f"{(self.batch, self.cfg.max_seq)}")
        start = self.data_index * self.seq_per_device
        shard = tokens[:, start:start + self.seq_per_device]
        self._tokens = torch.from_numpy(np.ascontiguousarray(shard)).to(self.device)

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
        """Rank 0 writes; the parameters are the same on every rank."""
        if self.mesh is None or dist.get_rank() == 0:
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
