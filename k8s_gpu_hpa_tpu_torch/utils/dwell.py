"""Chained-dwell rate measurement: the one honest way this repo times kernels.

Counterpart of ``k8s_gpu_hpa_tpu/utils/dwell.py``.  One long uninterrupted
on-device chain of a shape-preserving op, wall-clock timed end to end, a
scalar read to force completion: no round-trip subtraction, no clamp,
nothing estimated.  The single launch and readback amortize to noise over a
dwell of a second or more, so the returned rate is a lower bound on the
kernel's throughput and can never read above peak.

JAX gets its single dispatch from a ``fori_loop`` with a traced trip count.
On CUDA the chain is captured in one ``torch.cuda.CUDAGraph`` and the graph
is replayed once: the timed window is that replay and the scalar read.  On
the CPU the chain is a plain loop, timed the same way.

Shared by ``trial.measure_attention_rates`` (bench.py's attention block);
``MatmulLoadGen.measure_dwell_tflops`` applies the same method through the
generator's own burst (timing the very program the workload runs is the
point there, so it does not route through here).
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _scalar(y: torch.Tensor) -> float:
    """One element of ``y``, read on the host: the read that waits for the
    chain and moves 4 bytes, not the tensor."""
    return y.reshape(-1)[0].float().item()


def _apply(body: Callable[[torch.Tensor], torch.Tensor], y: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        y = body(y)
    return y


def timed_chain(
    body: Callable[[torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    iters: int,
    warm_iters: int = 2,
) -> tuple[torch.Tensor, float]:
    """``body`` applied ``iters`` times starting from ``init``, as one chain,
    and the wall seconds from its launch to a scalar read of its output.

    ``warm_iters`` applications run first and are not timed: they absorb
    building, loading and first-call costs.  On CUDA they run on a side
    stream, as graph capture asks; then the ``iters`` applications are
    captured (not timed) into one CUDA graph, and the timed window is one
    replay and the scalar read.  ``body`` must then be capturable: no host
    sync, no allocation that outlives the call except its output.  Buffers a
    step frees go back to the graph's private pool and are reused by the next
    step, so the pool holds one step's working set, not ``iters`` of them.
    What bounds ``iters`` on CUDA is the graph's size: capture and
    instantiation cost host time and memory in proportion to its nodes
    (``iters`` times the kernels a step launches), some microseconds each,
    and a graph of tens of thousands of nodes is still fine."""
    if init.device.type != "cuda":
        _scalar(_apply(body, init, warm_iters))
        t0 = time.perf_counter()
        out = _apply(body, init, iters)
        _scalar(out)
        return out, time.perf_counter() - t0
    side = torch.cuda.Stream(init.device)
    side.wait_stream(torch.cuda.current_stream(init.device))
    with torch.cuda.stream(side):
        _scalar(_apply(body, init, warm_iters))
    torch.cuda.current_stream(init.device).wait_stream(side)
    if iters == 0:
        out, graph = init, None
    else:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _apply(body, init, iters)
    torch.cuda.synchronize(init.device)
    t0 = time.perf_counter()
    if graph is not None:
        graph.replay()
    _scalar(out)
    wall = time.perf_counter() - t0
    return out, wall


def chained_dwell_tflops(
    body: Callable[[torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    iters: int,
    flops_per_iter: float,
    warm_iters: int = 2,
) -> float:
    """TFLOP/s of ``body`` (a shape-preserving on-device op) over one chained
    dwell of ``iters`` applications starting from ``init``: see
    ``timed_chain`` for what is timed and what bounds ``iters``."""
    _, wall = timed_chain(body, init, iters, warm_iters)
    return flops_per_iter * iters / wall / 1e12
