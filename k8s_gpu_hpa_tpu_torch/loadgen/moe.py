"""Expert-parallel MoE load generator: the ``all_to_all`` rung of the ladder.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/moe.py``.  Every other multi-rank
rung makes ring- or tree-shaped traffic (allreduce: all_reduce, all_gather
and a ring shift; ringattn and llm: point-to-point hops).  A
mixture-of-experts layer is the workload whose hot collective is
``all_to_all``, all-pairs traffic between the ranks of a model group, and
its duty cycle is what the autoscaling loop sees of an MoE pod.  Built on
``models/moe.py`` (experts sharded over the mesh's model axis, top-1
routing, a fixed capacity); a burst chains ``ffns_per_burst`` residual
FFNs, each followed by a re-normalization to the global RMS, so that one
burst outlasts its host round-trip.  It drives the same duty-cycle knob as
the other rungs; the multi-host container selects it with ``WORKLOAD=moe``
(loadgen/multihost.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.models.moe import (
    MoEConfig,
    _capacity,
    init_moe_params,
    make_ep_moe_ffn,
)
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, mesh_shape


@dataclass
class MoEStats:
    bursts: int
    tokens_routed: int
    tokens_per_sec: float
    #: all_to_all bytes each rank exchanges a burst (both directions: (m-1)/m
    #: of the dispatch buffer leaves the rank each way)
    a2a_bytes_per_burst: float
    a2a_gbps: float  # a rank's all_to_all bandwidth over busy time
    seconds: float


class MoELoadGen:
    """Busy-loop of expert-parallel MoE FFN bursts over the mesh.

    ``mesh`` defaults to a model axis of 2 over the process group when its
    size is even and more than 1, else 1 (a rank's experts alone).  The
    parameters (seed 0) and the tokens (seed 1, scaled by 0.5) are drawn
    whole on every rank, which keeps its experts and its data shard.
    ``device`` is CUDA unless the caller passes ``"cpu"``."""

    def __init__(
        self,
        mesh: DeviceMesh | None = None,
        d_model: int = 512,
        d_ff: int = 2048,
        n_experts: int | None = None,
        tokens_per_shard: int = 1024,
        ffns_per_burst: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        self.device = resolve(device)
        if mesh is None:
            n = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_mesh(model_parallelism=2 if n % 2 == 0 and n > 1 else 1)
        self.mesh = mesh
        shape = mesh_shape(mesh)
        m, self.n_data = shape[MODEL_AXIS], shape[DATA_AXIS]
        self.cfg = MoEConfig(
            d_model=d_model,
            d_ff=d_ff,
            # two experts a model rank by default: routing spread enough that
            # most tokens cross ranks, and the dispatch buffer the exchange's
            # accounting sizes from is n_experts buckets wide
            n_experts=n_experts if n_experts is not None else max(2 * m, 2),
            dtype=dtype,
        )
        self.tokens_per_shard = tokens_per_shard
        self.ffns_per_burst = ffns_per_burst
        self._params = init_moe_params(torch.Generator().manual_seed(0), self.cfg, mesh,
                                       self.device)
        x = torch.randn(tokens_per_shard * self.n_data, d_model,
                        generator=torch.Generator().manual_seed(1)).to(dtype) * 0.5
        start = mesh.get_local_rank(DATA_AXIS) * tokens_per_shard
        self._x = x[start:start + tokens_per_shard].to(self.device)
        self._ffn = make_ep_moe_ffn(mesh, self.cfg)
        self._data = mesh.get_group(DATA_AXIS)
        self._bursts = 0
        self._busy = 0.0

    def _renorm(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """``h`` over the RMS of the whole batch (every data shard), times
        ``1 + 1e-6·i``: the residual chain never overflows bf16 in an
        unbounded run, and no two rounds are the same computation."""
        hf = h.float()
        squares = hf.square().sum()
        if self.n_data > 1:
            dist.all_reduce(squares, group=self._data)
        mean = squares / (hf.numel() * self.n_data)
        return (hf * (torch.rsqrt(mean + 1e-6) * (1.0 + 1e-6 * i))).to(h.dtype)

    def _burst(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            for i in range(self.ffns_per_burst):
                x = self._renorm(x + self._ffn(self._params, x), i)
        return x

    def warmup(self) -> None:
        float(self._burst(self._x)[0, 0])

    def step(self) -> float:
        t0 = time.perf_counter()
        self._x = self._burst(self._x)
        float(self._x[0, 0])  # one scalar read waits for the burst
        dt = time.perf_counter() - t0
        self._busy += dt
        self._bursts += 1
        return dt

    def stats(self) -> MoEStats:
        m = mesh_shape(self.mesh)[MODEL_AXIS]
        cap = _capacity(self.tokens_per_shard, self.cfg)
        buf_bytes = self.cfg.n_experts * cap * self.cfg.d_model * self.cfg.dtype.itemsize
        # a rank, an FFN: (m-1)/m of the dispatch buffer leaves on the
        # forward exchange and the same comes back on the reverse
        per_burst = 2.0 * buf_bytes * (m - 1) / m * self.ffns_per_burst
        tokens = self.tokens_per_shard * self.n_data * self.ffns_per_burst * self._bursts
        return MoEStats(
            bursts=self._bursts,
            tokens_routed=tokens,
            tokens_per_sec=tokens / self._busy if self._busy else 0.0,
            a2a_bytes_per_burst=per_burst,
            a2a_gbps=per_burst * self._bursts / self._busy / 1e9 if self._busy else 0.0,
            seconds=self._busy,
        )
