"""Collective load generator: the three collective shapes of a sharded
training step, over a device mesh.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/allreduce.py``, the slice
container's default workload (``WORKLOAD=allreduce``): a pod whose load is
the interconnect rather than one chip's tensor cores, so that the HPA's
metrics reflect communication-bound pods too.  Where the JAX generator
writes ``lax.psum`` / ``lax.all_gather`` / ``lax.ppermute`` inside one
``shard_map``, this one calls ``torch.distributed`` on the mesh's groups:
NCCL on GPUs, gloo on the CPU.

The buffer has JAX's global shape, ``(n·rows, 128)`` with ``n`` every rank
of the mesh, sharded over the data axis: each rank holds ``1/n_data`` of
it, and the model axis replicates the shard.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, mesh_shape


@dataclass
class CollectiveStats:
    rounds: int
    bytes_moved_per_round: float  # algorithm bytes through each rank's links
    achieved_gbps: float  # per-rank algorithmic bandwidth over the run
    seconds: float


class AllReduceLoadGen:
    """Ring-style collective busy-loop over every rank of the mesh.

    Each round: an all_reduce (SUM, then divided by its size) of the shard
    over the data axis, an all_gather over the model axis folded back by
    its mean, then a ring shift to the next data rank — the three
    collective shapes a sharded training step exercises (allreduce grads /
    gather params / pipeline neighbour exchange) — and last the factor
    ``1 + 1e-6·i`` in the buffer's dtype.  A burst is ``rounds_per_burst``
    rounds, waited for once.  On a data axis of one the ring shift is the
    identity and is not sent.  ``device`` is CUDA unless the caller passes
    ``"cpu"``; ``mesh`` defaults to ``make_mesh()`` over the process group.
    """

    def __init__(
        self,
        mesh: DeviceMesh | None = None,
        buffer_mb: float = 64.0,
        rounds_per_burst: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        self.device = resolve(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        shape = mesh_shape(self.mesh)
        self.n_data, self.n_model = shape[DATA_AXIS], shape[MODEL_AXIS]
        n = self.n_data * self.n_model
        elem = torch.empty((), dtype=dtype).element_size()
        # per-data-shard rows x 128 lanes, bf16-tile aligned (the model axis
        # replicates the shard, so capacity is set by the data-axis count)
        rows = max(16, int(buffer_mb * 1e6 / elem / 128 / n) // 16 * 16)
        self.shape = (n * rows, 128)
        self.rounds_per_burst = rounds_per_burst
        self._data = self.mesh.get_group(DATA_AXIS)
        self._model = self.mesh.get_group(MODEL_AXIS)
        # the ring's neighbours on the data axis, as global ranks
        ring = dist.get_process_group_ranks(self._data)
        index = self.mesh.get_local_rank(DATA_AXIS)
        self._next = ring[(index + 1) % self.n_data]
        self._prev = ring[(index - 1) % self.n_data]
        local = (self.shape[0] // self.n_data, self.shape[1])
        self._x = torch.ones(local, dtype=dtype, device=self.device)
        self._recv = torch.empty_like(self._x)
        # the model ranks' shards, concatenated on the first dimension
        self._gathered = torch.empty((self.n_model * local[0], local[1]), dtype=dtype,
                                     device=self.device)
        # the factor computed in f32 and cast to the buffer's dtype, as JAX's
        self._factors = (1.0 + 1e-6 * torch.arange(rounds_per_burst, dtype=torch.float32)).to(
            device=self.device, dtype=dtype)
        self._rounds = 0
        self._busy = 0.0

    def set_buffer(self, full: np.ndarray | torch.Tensor) -> None:
        """Replace the buffer by the global array ``full`` of ``self.shape``
        (f32): this rank keeps its data shard's rows, as JAX's
        ``P("data")`` sharding places them."""
        full = torch.as_tensor(full, dtype=torch.float32)
        if tuple(full.shape) != self.shape:
            raise ValueError(f"a buffer of shape {tuple(full.shape)}, not {self.shape}")
        rows = self._x.shape[0]
        start = self.mesh.get_local_rank(DATA_AXIS) * rows
        self._x.copy_(full[start:start + rows].to(self._x.dtype))

    def _burst(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.rounds_per_burst):
            # grad-allreduce shape
            dist.all_reduce(x, group=self._data)
            x.div_(self.n_data)
            # param-gather shape: gather, then fold back by the mean so the
            # shard keeps its shape across rounds
            dist.all_gather_into_tensor(self._gathered, x, group=self._model)
            torch.mean(self._gathered.view(self.n_model, *x.shape), 0, out=x)
            # pipeline neighbour exchange
            if self.n_data > 1:
                works = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, self._next, group=self._data),
                    dist.P2POp(dist.irecv, self._recv, self._prev, group=self._data),
                ])
                for work in works:
                    work.wait()
                x, self._recv = self._recv, x
            # keep values bounded and make each round's values its own
            x.mul_(self._factors[i])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return x

    def warmup(self) -> None:
        """One burst on a copy of the buffer (the communicators come up),
        not counted; the buffer stays as it was, as JAX's warmup leaves it."""
        self._burst(self._x.clone())

    def step(self) -> float:
        t0 = time.perf_counter()
        self._x = self._burst(self._x)
        dt = time.perf_counter() - t0
        self._busy += dt
        self._rounds += self.rounds_per_burst
        return dt

    def run_for(self, seconds: float) -> CollectiveStats:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self.step()
        return self.stats()

    def stats(self) -> CollectiveStats:
        # the buffer is sharded over the data axis: each rank holds
        # total/n_data (the model axis replicates), NOT total/n_ranks
        shard_bytes = self.shape[0] * self.shape[1] * self._x.element_size() / self.n_data
        # ring allreduce moves 2*(n-1)/n of the shard per rank; gather
        # (n-1)/n; the ring shift exactly one shard
        n_data, n_model = self.n_data, self.n_model
        per_round = shard_bytes * (2 * (n_data - 1) / n_data + (n_model - 1) / n_model + 1)
        gbps = per_round * self._rounds / self._busy / 1e9 if self._busy else 0.0
        return CollectiveStats(
            rounds=self._rounds,
            bytes_moved_per_round=per_round,
            achieved_gbps=gbps,
            seconds=self._busy,
        )
