"""Long-context load generator: ring attention bursts over the mesh.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/ringattn.py``: the
sequence-parallel serving profile.  Each burst is exact causal attention
over a context ``n`` times one rank's (the mesh's data axis), mixing the
products of each ring step with the K/V ring's traffic between ranks.  It
drives the same duty-cycle knob and self-reporting contract as the other
generators; the multi-host container selects it with ``WORKLOAD=ringattn``
(loadgen/multihost.py).

Like the JAX generator's, the attention is plain (``ops/ring_attention.py``):
the JAX package leaves it to XLA, and no kernel is written for it here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import ring_attention
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, mesh_shape


@dataclass
class RingAttnStats:
    bursts: int
    context_length: int  # total sequence length across the ring
    achieved_tflops: float  # attention FLOPs over busy time
    seconds: float


class RingAttentionLoadGen:
    """Busy-loop of causal ring-attention passes over a long context.

    ``mesh`` defaults to ``make_mesh()`` over the process group.  Q, K and V
    are drawn whole from a seeded generator on every rank, which keeps its
    sequence shard; each pass feeds its output back as the next pass's Q, so
    no pass repeats the one before.  ``device`` is CUDA unless the caller
    passes ``"cpu"``."""

    def __init__(
        self,
        mesh: DeviceMesh | None = None,
        seq_per_device: int = 1024,
        batch: int = 1,
        heads: int = 8,
        head_dim: int = 128,
        dtype: torch.dtype = torch.bfloat16,
        passes_per_burst: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        n = mesh_shape(self.mesh)[DATA_AXIS]
        self.seq = seq_per_device * n
        self.batch, self.heads, self.head_dim = batch, heads, head_dim
        if passes_per_burst is None:
            # chain passes so that one burst outlasts its host round-trip
            passes_per_burst = 8 if self.device.type == "cuda" else 1
        self.passes_per_burst = passes_per_burst
        gen = torch.Generator().manual_seed(0)
        shape = (batch, self.seq, heads, head_dim)
        start = self.mesh.get_local_rank(DATA_AXIS) * seq_per_device
        self._q, self._k, self._v = (
            torch.randn(shape, generator=gen)[:, start:start + seq_per_device]
            .to(self.device, dtype).contiguous()
            for _ in range(3)
        )
        self._bursts = 0
        self._busy = 0.0

    def _burst(self) -> float:
        out = self._q
        for _ in range(self.passes_per_burst):
            out = ring_attention(out, self._k, self._v, self.mesh, causal=True)
        return float(out[0, 0, 0, 0])  # one scalar read waits for the burst

    def warmup(self) -> None:
        self._burst()

    def step(self) -> float:
        t0 = time.perf_counter()
        self._burst()
        dt = time.perf_counter() - t0
        self._busy += dt
        self._bursts += 1
        return dt

    def stats(self) -> RingAttnStats:
        # causal attention: half the S^2 score and value work of full
        # attention (JAX's formula)
        flops_per_burst = (
            4.0 * self.batch * self.heads * self.seq**2 * self.head_dim / 2 * self.passes_per_burst
        )
        return RingAttnStats(
            bursts=self._bursts,
            context_length=self.seq,
            achieved_tflops=(
                flops_per_burst * self._bursts / self._busy / 1e12 if self._busy else 0.0
            ),
            seconds=self._busy,
        )
