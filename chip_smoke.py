#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's closed autoscaling loops and its training
loads once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and g++:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device        — the card's name and power limit as nvidia-smi reports them.
2. build         — nvcc builds the GEMM (ops/csrc/matmul.cu), the flash
                   attention forward (ops/csrc/flash_attention.cu) and its
                   backward (ops/csrc/flash_attention_bwd.cu), g++ the
                   exporter core from cpp/exporter, all four at once; the
                   GEMM's tile configuration, its registers by warpgroup role
                   and its shared memory beside ptxas's report; the flash
                   forward's registers and spills for each instantiation
                   (head_dim 64 and 128 by one or two consumer warpgroups)
                   beside its threads, stages, CTAs an SM and shared memory,
                   and the backward's (dQ and dK/dV at head_dim 64 and 128)
                   beside its threads, stages, shared memory and setmaxnreg
                   counts.
3. parity        — the GEMM against its plain PyTorch version at six shapes,
                   among them N = 128 mod 256 and K = 128; an f32 or
                   unaligned operand must raise.
4. timing        — the GEMM at 4096^3 beside its bound, the plain version and
                   torch.matmul (a yardstick the port never calls).
5. loadgen       — MatmulLoadGen on the GEMM tracks the commanded duty cycle,
                   launches the kernel once per product, and sustains more
                   than 44% of the card's peak at full duty (the tensor-core
                   HPA's band edge).
6. profile       — one full-length matmul burst under torch.profiler: one
                   GEMM and one renorm a product, device time by kernel and
                   the device's idle share.
7. loop          — the headline loop, as bench.py runs it: loadgen →
                   TorchDeviceSource → ExporterDaemon over HTTP → Scraper →
                   tpu-test rules → adapter → HPA on tpu_test_tensorcore_avg
                   (the GEMM's MFU) must scale 1 → 4 within the 60 s budget.
8. nvml          — NVML read from this process: the NVML device of the
                   generator's torch device found by UUID (never index 0
                   assumed); exporter/nvml.py's struct layouts against a probe
                   compiled with the card's nvml.h; with the generator idle
                   and the card's power settled, NvmlSource beside
                   nvidia-smi (total within 1 MiB, used
                   within 256 MiB, temperature within 3 °C, power within
                   25 W); the mean duty cycle over 3 s of sweeps at full duty
                   at least 90, and at knob 0.25 within 15 points of the
                   generator's own; tensorcore_util always None; GPM's
                   support and, where served, its DRAM bandwidth; a kubelet
                   ListPodResourcesResponse naming the card's UUID and a
                   plain index under nvidia.com/gpu, whose UUID must resolve
                   to the card's NVML index.
9. node_loop     — the headline loop through the node exporter
                   (run_node_headline_trial): NvmlSource and the kubelet
                   attribution decoded in nvml → ExporterDaemon, merging the
                   generator's self-report from a temporary directory → HTTP
                   → Scraper → HPA on tpu_test_tensorcore_avg must scale 1 → 4
                   within the 60 s budget; /metrics during the dwell carries
                   the power, temperature, tensor-core and duty-cycle
                   families for the real pod.
10. flash_parity — the flash kernel against its plain version on views of
                   one fused QKV product: the serve prefill's shape (causal
                   and not, with the logsumexp), the llm training shape with
                   the logsumexp, one KV tile (seq 64), seq 192 causal and
                   not on one and on two consumer warpgroups, head dim 64
                   on each over ten K/V tiles (each ring wraps), and the
                   long timed shape with the logsumexp; each output within
                   0.02 absolute and its error's RMS within a bar of its
                   own; off-envelope operands and an unknown split must
                   raise.
11. flash_timing — the flash kernel at the prefill's shape, at the llm
                   training shape with the logsumexp on fused-QKV views (as
                   the transformer calls it) and at a long one, beside its
                   bound, the plain version and scaled_dot_product_attention
                   (a yardstick the port never calls), in turns; and each
                   shape on one and on two consumer warpgroups.
12. serve_parity — at the shipped serve sizes in bf16: prefill against
                   stepwise decode, and the CUDA-graph burst against the same
                   burst run eagerly, bit for bit.
13. serve_loadgen— DecodeLoadGen at the shipped sizes: burst times (graph and
                   eager), token rates, bandwidth and the saturated signal's
                   headroom over the serve target.
14. serve_profile— one graph burst under torch.profiler: device time by
                   kernel, the flash kernel once per layer, the idle share.
15. serve_loop   — the serve loop: DecodeLoadGen → TorchDeviceSource →
                   ExporterDaemon → Scraper → tpu-serve rule → adapter → the
                   shipped serve HPA must scale 1 → 4 on tpu_serve_hbm_bw_avg
                   within the 60 s budget.
16. flash_bwd_parity — the dQ and dK/dV kernels against their plain versions
                   at the llm training shape (causal and not), seq 192 with
                   three heads, and head_dim 64 over ten tiles a side (each
                   ring wraps), on views of one fused QKV product; the
                   autograd Function's gradients against autograd through
                   the plain forward at the llm shape; off-envelope operands
                   must raise.
17. flash_bwd_timing — both backward kernels (and the training forward) at the
                   llm shape and at a long one, beside their bounds, their
                   plain versions and scaled_dot_product_attention's backward
                   (a yardstick the port never calls).
18. llm_parity   — at full width, from the same weights and tokens, the
                   loss's gradients with attn_impl "auto" and with "ring"
                   agree leaf by leaf; then one LlmLoadGen step of each: the
                   losses and the updated weights agree, and the auto step
                   launches dQ and dK/dV once a layer and the forward twice.
19. llm_train    — LlmLoadGen at full width, auto and ring: step time,
                   tokens/s and the losses of some twenty steps.
20. llm_profile  — one auto step under torch.profiler: device time by
                   kernel, launches a step, the idle share.
21. train_parity — the ResNet training rung at the shipped tpu-train width
                   (ResNet-50, CIFAR stem, image 32): one step on the card in
                   bf16 and channels_last against the same step on the CPU
                   in f32 from the same seeded weights and batch (16
                   images), the logits and the loss within 0.06 of their
                   RMS; a stage-3 BatchNorm's running statistics moved by
                   flax's update, the biased variance.
22. train_loadgen— TrainLoadGen at the shipped sizes (batch 256): step ms,
                   images/s and peak memory; the windowed duty cycle at
                   knob 0.25.
23. train_profile— one step under torch.profiler: kernels, device time by
                   kind (convolution, BatchNorm, elementwise, SGD, copies),
                   the idle share; the trace must hold every BatchNorm's
                   four kernels and the batch draw's two.
24. train_loop   — the training loop, as bench.py's training rung runs it:
                   TrainLoad → TorchDeviceSource (the windowed duty cycle, no
                   bandwidth gauge) → ExporterDaemon → Scraper → both
                   tpu-train rules → adapter → the shipped two-metric HPA
                   must scale 1 → 4 within the 60 s budget on the duty cycle
                   alone; which metrics it had at each sync.
25. train_entry  — ``python -m k8s_gpu_hpa_tpu_torch.loadgen.train`` with
                   CHECKPOINT_DIR, CHECKPOINT_EVERY 20 and PROFILE_S 1: it
                   writes its Chrome trace, saves on SIGTERM, exits 0, and
                   started again resumes from that save's step.
26. llm_entry    — ``python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with
                   WORKLOAD=llm and CHECKPOINT_DIR trains and reports until
                   SIGTERM, saves, exits 0, and resumes from that step.

No hand-written kernel is on the ResNet path: its convolutions are cuDNN's,
its BatchNorm PyTorch's own kernels and its head cuBLAS's, as XLA's are in
the JAX package.

Launch counts.  Each wrapper counts the launches it makes.  The GEMM's
launches on the main path are those of loop and node_loop, each counted
from zero.  A decode burst
is one replay of a CUDA graph, and the graph's launches happen without the
wrapper: the flash wrapper counts them once, when the burst is captured
(``DecodeLoadGen.flash_launches_per_burst``).  So the serve loop's flash
launches are the wrapper's count in that run plus the replays in that run
times the launches one replay makes.

The training path's launches are those of llm_parity's auto step plus
llm_train's auto steps, each counted from zero; the flash forward's are
those of the serve loop plus the training path's.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
Nothing falls back to the CPU: without a GPU the script exits 1 and prints
no result.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import torch.nn.functional as F

from k8s_gpu_hpa_tpu_torch.device import peak_hbm_gbps_for, peak_tflops_for
from k8s_gpu_hpa_tpu_torch.exporter import native, nvml
from k8s_gpu_hpa_tpu_torch.exporter.podresources import (
    GPU_RESOURCE,
    StaticAttributor,
    parse_list_response,
)
from k8s_gpu_hpa_tpu_torch.exporter.sources import NvmlSource
from k8s_gpu_hpa_tpu_torch.control.hpa import TRAIN_BW_SERIES, TRAIN_DUTY_SERIES
from k8s_gpu_hpa_tpu_torch.loadgen.decode import SERVE_SIZES, DecodeLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.train import TrainLoadGen, make_checkpoint_manager
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.metrics.rules import SERVE_BW_TARGET
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_CHIP_POWER,
    TPU_CHIP_TEMP,
    TPU_DUTY_CYCLE,
    TPU_TENSORCORE_UTIL,
)
from k8s_gpu_hpa_tpu_torch.models import transformer
from k8s_gpu_hpa_tpu_torch.models.resnet import BatchNorm
from k8s_gpu_hpa_tpu_torch.ops import flash_attention, matmul
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_bwd_delta,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq_reference,
    flash_attention_bwd_kernel,
    flash_attention_bwd_launch,
    flash_attention_bwd_reference,
    flash_attention_kernel,
    flash_attention_reference,
)
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul_kernel, matmul_reference
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.trial import (
    REAL_POD,
    SERVE_SERIES,
    TENSORCORE_SERIES,
    TARGET,
    LoadThread,
    WindowedDuty,
    measure_saturated_signal,
    run_headline_trial,
    run_node_headline_trial,
    run_serve_trial,
    run_train_trial,
)
from k8s_gpu_hpa_tpu_torch.utils import protowire

# M, K, N: the loadgen's shape; the JAX parity test's (N 128, half of the
# kernel's 256-wide tile); a shape the JAX package would run on its k-grid
# kernel; a shallow wide one (K 128, two K steps); one tile with K and N 128;
# and N 384 (a tile column half outside C) over five tile rows
PARITY_SHAPES = [
    (4096, 4096, 4096), (256, 384, 128), (1024, 8192, 2048), (512, 128, 1024),
    (128, 128, 128), (640, 2048, 384),
]
# bf16 output: each side rounds its fp32 sum to bf16 once, so two results can
# differ by one bf16 ulp (2^-7 relative at worst) and by the fp32 sums'
# different summation order; rtol 2^-6 allows two ulps, atol the order.
# Readings (NVIDIA H100 80GB HBM3, this phase): at every shape the worst
# error is one bf16 ulp of the reference's value there (2.0 at -278 for
# 1024x8192x2048), and no element is outside the bar.
RTOL = 2.0**-6
ATOL = 1e-2
SIZE = 4096

# (batch, seq, heads, head_dim, causal, with_lse, consumer warpgroups a CTA
# or None for the wrapper's choice): the serve prefill's shape causal and
# not, with the logsumexp; the llm training shape with the logsumexp; one
# KV tile; seq 192 causal and not on each split (on two warpgroups the first
# Q tile leaves the second none); head_dim 64 on each over ten K/V tiles,
# more than twice either ring's stages; and the long timed shape
FLASH_SHAPES = [
    (8, 512, 4, 128, True, False, None),
    (8, 512, 4, 128, False, False, None),
    (8, 512, 4, 128, True, True, None),
    (1, 2048, 4, 128, True, True, None),
    (2, 64, 4, 128, True, True, None),
    *((2, 192, 3, 128, causal, True, split) for causal in (True, False)
      for split in flash_attention.FWD_SPLITS),
    *((2, 640, 2, 64, True, True, split) for split in flash_attention.FWD_SPLITS),
    (2, 4096, 8, 128, True, True, None),
]
# bf16 output, each side rounding P to bf16 once per KV tile it sums: the
# kernel per 64-key tile against its running max, the plain version once
# against the row's max, so a term can differ by one bf16 ulp of P; then the
# output rounds once on each side.  0.02 absolute allows about two ulps at
# the outputs' magnitude (|o| < 2 for these inputs) and is under the JAX
# package's bf16 bar of 0.06.  The logsumexp is fp32 on both sides: 1e-4.
# Where |o| is small, as at the long shape (RMS 0.07), 0.02 is loose: the
# error's RMS over the output's RMS is held to FLASH_REL_RMS as well.  Its
# readings (NVIDIA H100 80GB HBM3, this phase) were 3e-5 to 2.3e-3, the
# worst at seq 192 not causal; the bar is about twice that.  A 64-key tile
# dropped or read stale moves it far past the bar.
FLASH_ATOL = 0.02
LSE_ATOL = 1e-4
FLASH_REL_RMS = 5e-3
# (batch, seq, heads, head_dim, with_lse, on fused-QKV views), causal, for
# timing: the prefill's shape; the llm training shape as the transformer's
# training step calls it; a long one
FLASH_TIMED = [(8, 512, 4, 128, False, False), (1, 2048, 4, 128, True, True),
               (2, 4096, 8, 128, False, False)]
# serve parity at the shipped sizes in bf16: prefill against stepwise decode
# reach the cache and the logits through other products (a [b, 512, d] GEMM
# and the flash kernel against [b, 1, d] GEMMs and the decode's products), so
# bf16 roundings land elsewhere and carry through four layers; the JAX
# package's bf16 attention bar, 0.06, holds the logits, and the cache is held
# to 0.06 plus four bf16 ulps of its value
SERVE_ATOL = 0.06
SERVE_CACHE_RTOL = 2.0**-5

#: the llm training rung's attention (LlmLoadGen's defaults: batch 1, 2048
#: tokens, 4 heads of 128)
LLM_SHAPE = (1, 2048, 4, 128)
# (batch, seq, heads, head_dim, causal): the llm shape causal and not; seq
# 192, whose backward runs three 64-row tiles a side, the dK/dV loop
# starting at the diagonal; and head_dim 64 over ten tiles a side, which
# wraps every ring
BWD_SHAPES = [(*LLM_SHAPE, True), (*LLM_SHAPE, False), (2, 192, 3, 128, True), (2, 640, 2, 64, True)]
# bf16 gradients: each side sums exact bf16 products in fp32, in other
# orders, and rounds each gradient once; dS (and P for dV) is rounded to
# bf16 before the second product, and where the two sides' fp32 dS straddle
# a rounding boundary a term differs by one bf16 ulp of dS.  rtol 2^-6
# allows two bf16 ulps of the gradient.  atol and the RMS bar are set from
# the readings (NVIDIA H100 80GB HBM3, this phase): the worst error above
# the rtol term (``excess_over_rtol``) was 0.0004 over the four shapes, the
# error's RMS at most 1.8e-4 of the gradient's RMS, while the gradients'
# RMS is 0.04-0.09 at the llm shape: a bar near it would pass a fault
# confined to late rows or to the last tile.  atol 2e-3 is five times the
# worst excess; the RMS bar, 1e-3, five times the worst ratio, and a
# dropped 64-row tile of 2048 moves that ratio by some 0.1.
BWD_RTOL = 2.0**-6
BWD_ATOL = 2e-3
BWD_REL_RMS = 1e-3
# The autograd Function against autograd through the plain forward, which
# keeps dS in fp32 and takes delta from the unrounded output: every summand
# differs by a bf16 rounding, so near zero the difference grows with the
# row's terms, not the entry's value.  Its readings at the llm shape: excess
# over the rtol term 0.0059, RMS ratio 0.0034; its bars are twice those.
FN_ATOL = 0.012
FN_REL_RMS = 0.007
# the llm shape and a long causal one, for timing
BWD_TIMED = [LLM_SHAPE, (2, 4096, 8, 128)]
# train parity: the two steps' losses agree within the JAX package's bar for
# the same comparison (tests/test_flash_attention.py:187).  The gradients of
# the same loss from the same weights, auto (flash kernels) against ring
# (plain fp32 blocking), are compared leaf by leaf, wqkv's Q, K and V
# columns apart: the norm of their difference over the ring gradient's norm.
# bf16 roundings downstream of attention differ between the two paths: the
# readings were 0.004-0.011 for every leaf but the last layer's Q and K
# columns, 0.022 and 0.025 (NVIDIA H100 80GB HBM3, this phase); the bar is
# twice the worst.  A leaf whose attention gradient went missing reads 1.  The
# updated bf16 weights p - lr g, with lr 1e-3, differ only where the two
# gradients' differences move a rounding: at most a bf16 ulp, held to two
# (rtol 2^-6); most weights do not move at this lr, hence the gradients.
TRAIN_LOSS_ATOL = 0.05
TRAIN_GRAD_REL = 0.05
TRAIN_PARAM_RTOL = 2.0**-6
TRAIN_PARAM_ATOL = 1e-6


#: spin kernels launched inside a trace before the traced work, and left out
#: of what it reports: late in a long run a trace has missed the first five
#: kernels of an llm step (its first flash forward among them), for a reason
#: not found, so the trace's first kernels are spent on these.  The profile
#: phases also hold the trace's counts against the wrappers' own launches, so
#: a trace that still loses kernels fails as a fault of the trace
TRACE_WARMUP_KERNELS = 8


def _warm_trace() -> None:
    for _ in range(TRACE_WARMUP_KERNELS):
        torch.cuda._sleep(1000)  # ``spin_kernel``, some microseconds
    torch.cuda.synchronize()


def _traced_kernels(prof, width: int) -> dict:
    """Device time and calls by kernel name, the warm-up's spin kernels and
    the regions a user annotated (``Optimizer.step#SGD.step``) left out."""
    kernels = {}
    for event in prof.key_averages():
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and event.self_device_time_total > 0 and "spin_kernel" not in event.key
                and not getattr(event, "is_user_annotation", False)):
            kernels[event.key[:width]] = {
                "ms": event.self_device_time_total / 1e3, "calls": event.count,
            }
    return kernels


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, the best replay
    over ``iters``.  Unlike a timed loop of calls this leaves out the host's
    time to launch each call, which for a kernel of some ten microseconds
    behind a Python wrapper is the larger part."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peak_tflops = peak_tflops_for(name)
    peak_gbps = peak_hbm_gbps_for(name)
    if peak_tflops is None or peak_gbps is None:
        raise RuntimeError(f"no peak table entry for {name!r} (device.py)")
    info = {
        "phase": "device", "nvidia_smi": smi, "torch_name": name,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "peak_bf16_tflops": peak_tflops,
        "peak_hbm_gbps": peak_gbps,
    }
    emit(info)
    return info


def phase_build() -> None:
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def ptxas_lines(out: str) -> list[str]:
        # registers on the "ptxas info" lines, spills on the lines after them
        return [ln.strip() for ln in out.splitlines() if "ptxas info" in ln or "spill" in ln]

    with ThreadPoolExecutor(4) as pool:
        kernel = pool.submit(timed, matmul.build)
        flash = pool.submit(timed, flash_attention.build)
        flash_bwd = pool.submit(timed, flash_attention.build_bwd)
        exporter = pool.submit(timed, native.build_native)
        (_, ptxas), kernel_s = kernel.result()
        (_, flash_ptxas), flash_s = flash.result()
        (_, bwd_ptxas), bwd_s = flash_bwd.result()
        _, exporter_s = exporter.result()
    config = matmul.kernel_config()
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas)]
    # ptxas reports each entry function's registers and spills in turn
    entries = re.findall(
        r"Function properties for \S*flash_fwd_kernelILi(\d+)ELi(\d+)E\S*\s+"
        r"\d+ bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s+"
        r"ptxas info\s+: Used (\d+) registers", flash_ptxas)
    flash_fwd = [
        {"head_dim": int(d), "registers": int(regs), "spill_bytes": int(st) + int(ld),
         "kv_split": int(split), **flash_attention.fwd_config(int(d), int(split))}
        for d, split, st, ld, regs in entries
    ]
    bwd_entries = re.findall(
        r"Function properties for \S*flash_bwd_(dq|dkv)_kernelILi(\d+)E\S*\s+"
        r"\d+ bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s+"
        r"ptxas info\s+: Used (\d+) registers", bwd_ptxas)
    flash_bwd = [
        {"kernel": kernel, "head_dim": int(d), "registers_at_launch": int(regs),
         "spill_bytes": int(st) + int(ld), **flash_attention.bwd_config(kernel, int(d))}
        for kernel, d, st, ld, regs in bwd_entries
    ]
    emit({
        "phase": "build", "matmul_cu_s": round(kernel_s, 3),
        "flash_attention_cu_s": round(flash_s, 3),
        "flash_attention_bwd_cu_s": round(bwd_s, 3),
        "exporter_cc_s": round(exporter_s, 3),
        "ptxas": ptxas_lines(ptxas),
        # ptxas reports the registers a thread is launched with; setmaxnreg
        # then moves them between the warpgroups' roles
        "matmul": {
            "config": config,
            "registers_at_launch": [int(n) for n in re.findall(r"Used (\d+) registers", ptxas)],
            "registers_by_role": {"producer": config["producer_regs"],
                                  "consumers": config["consumer_regs"]},
            "dynamic_smem_bytes": config["smem_bytes"],
            "spill": f"{sum(spills)} bytes spill" if spills else "not reported",
        },
        "flash_ptxas": ptxas_lines(flash_ptxas),
        "flash_fwd": flash_fwd,
        "flash_bwd_ptxas": ptxas_lines(bwd_ptxas),
        # under setmaxnreg (every instantiation but dQ at head_dim 64) a
        # thread launches with 168 registers, and the producer warpgroup's
        # and the consumers' counts are set in the kernel
        "flash_bwd": flash_bwd,
    })
    if len(flash_fwd) != 4 or any(e["spill_bytes"] for e in flash_fwd):
        raise AssertionError(f"the flash forward's ptxas report: {flash_fwd}")
    # setmaxnreg.inc waits for registers the producer's .dec gives up: at
    # 384 threads they add up only from exactly 168 a thread at launch
    if len(flash_bwd) != 4 or any(
        e["spill_bytes"] or (e["consumer_regs"] and e["registers_at_launch"] != 168)
        for e in flash_bwd
    ):
        raise AssertionError(f"the flash backward's ptxas report: {flash_bwd}")
    # a product serialized for want of registers (C7512) or under a branch
    # (C7520)
    if "are serialized" in flash_ptxas + bwd_ptxas:
        raise AssertionError("ptxas serialized a flash kernel's wgmma")


def phase_parity() -> float:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    rows = []
    for m, k, n in PARITY_SHAPES:
        a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
        got = matmul_kernel(a, b)
        torch.cuda.synchronize()
        want = matmul_reference(a, b)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > ATOL + RTOL * want.float().abs()).sum())
        worst_at = int(diff.argmax())
        err = float(diff.view(-1)[worst_at])
        # the reference's value where the error is largest, and the error in
        # units of that value's bf16 ulp
        at = float(want.view(-1)[worst_at])
        ulp = 2.0 ** (math.floor(math.log2(abs(at))) - 7) if at else float("nan")
        rows.append({"mkn": [m, k, n], "max_abs_err": err, "out_of_tol": bad,
                     "want_at_max_err": at, "ulps_at_max_err": err / ulp})
        worst = max(worst, err)
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel disagrees with its plain version at {(m, k, n)}: {rows[-1]}")
    refused = {}
    cases = {
        "f32": (torch.ones(128, 128, device="cuda"), torch.ones(128, 128, device="cuda")),
        "unaligned": (
            torch.ones(100, 128, device="cuda", dtype=torch.bfloat16),
            torch.ones(128, 128, device="cuda", dtype=torch.bfloat16),
        ),
    }
    for case, (a, b) in cases.items():
        try:
            matmul_kernel(a, b)
        except (TypeError, ValueError) as e:
            refused[case] = type(e).__name__
        else:
            raise AssertionError(f"matmul_kernel took a {case} operand")
    emit({"phase": "parity", "rtol": RTOL, "atol": ATOL, "shapes": rows, "refused": refused})
    return worst


def phase_timing(peak_tflops: float, peak_gbps: float) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(SIZE, SIZE, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(SIZE, SIZE, generator=gen, device="cuda").to(torch.bfloat16)
    flops = 2.0 * SIZE**3
    nbytes = 3 * SIZE * SIZE * 2  # A and B read once, C written once
    ms_by_ops = flops / (peak_tflops * 1e12) * 1e3
    ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
    # turns: plain, kernel, library, kernel, plain — compare within one call
    plain = [cuda_time_ms(lambda: matmul_reference(a, b), 10)]
    kernel = [cuda_time_ms(lambda: matmul_kernel(a, b), 50)]
    library = cuda_time_ms(lambda: torch.matmul(a, b), 50)
    kernel.append(cuda_time_ms(lambda: matmul_kernel(a, b), 50))
    plain.append(cuda_time_ms(lambda: matmul_reference(a, b), 10))
    config = matmul.kernel_config()
    tiles = (SIZE // config["tile_m"]) * -(-SIZE // config["tile_n"])
    out = {
        "phase": "timing", "mkn": [SIZE, SIZE, SIZE],
        "tile": [config["tile_m"], config["tile_n"], config["tile_k"]],
        "stages": config["stages"], "tiles": tiles,
        "ctas": min(tiles, torch.cuda.get_device_properties(0).multi_processor_count),
        "ms": min(kernel), "ms_runs": kernel,
        "tflops": flops / min(kernel) / 1e9,
        "plain_ms": min(plain), "plain_ms_runs": plain,
        "library_ms": library, "library": "torch.matmul bf16",
        "bound_ms": max(ms_by_ops, ms_by_bytes),
        "bound_by": "operations" if ms_by_ops >= ms_by_bytes else "bytes",
        "bound_ops_ms": ms_by_ops, "bound_bytes_ms": ms_by_bytes,
    }
    out["fraction_of_bound"] = out["bound_ms"] / out["ms"]
    emit(out)
    return out


def phase_loadgen(knob_dir: str):
    gen = MatmulLoadGen(size=SIZE, use_kernel=True, intensity=1.0, window=3.0, device="cuda:0")
    gen.intensity_file = str(Path(knob_dir) / "intensity")  # absent: API knob only
    gen.warmup()
    rows = []
    for duty in (1.0, 0.25):
        gen.set_intensity(duty)
        gen.run_for(gen.window + 1.0)  # flush the window at the new duty
        matmul_kernel.launches = 0
        steps_before = gen.stats().steps
        stats = gen.run_for(2.0)
        steps = stats.steps - steps_before
        expected = steps * gen.burst_iters(duty)
        row = {
            "duty": duty, "utilization": stats.utilization, "steps": steps,
            "launches": matmul_kernel.launches, "expected_launches": expected,
            "achieved_tflops": stats.achieved_tflops,
            "sustained_tflops": stats.sustained_tflops,
            "mxu_utilization": gen.mxu_utilization(),
        }
        rows.append(row)
        if matmul_kernel.launches != expected or steps == 0:
            raise AssertionError(f"kernel launches do not match the products run: {row}")
        if abs(stats.utilization - 100.0 * duty) > 10.0:
            raise AssertionError(f"utilization does not track the commanded duty: {row}")
    probe = gen._burst(gen.iters_per_burst)
    if not math.isfinite(probe):
        raise AssertionError(f"the product chain went non-finite: {probe}")
    dwell = gen.measure_dwell_tflops()
    out = {"phase": "loadgen", "size": SIZE, "iters_per_burst": gen.iters_per_burst,
           "runs": rows, "probe": probe, "dwell_tflops": dwell,
           "dwell_mfu_pct": 100.0 * dwell / gen.peak_tflops,
           "band_edge_pct": TARGET * 1.1}
    emit(out)
    # the tensor-core HPA scales up only above its target times its 10% band
    if out["dwell_mfu_pct"] <= out["band_edge_pct"]:
        raise AssertionError(f"the GEMM cannot drive the tensor-core loop: {out}")
    return gen


def phase_profile(gen) -> dict:
    """Where one full-length burst's device time goes: ``torch.profiler``
    over one burst at full duty, device time summed by kernel name, and the
    device's idle share of the burst's host wall time (profiled: tracing
    adds host cost, so the share is an upper bound)."""
    gen._burst(8)  # warm the profiler-free path first
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _warm_trace()
        matmul_kernel.launches = 0
        t0 = time.perf_counter()
        gen._burst(gen.iters_per_burst)
        wall_ms = (time.perf_counter() - t0) * 1e3
    wrapper_launches = matmul_kernel.launches
    kernels = _traced_kernels(prof, 80)
    busy_ms = sum(k["ms"] for k in kernels.values())

    def calls_of(name: str) -> int:
        return sum(k["calls"] for key, k in kernels.items() if name in key)

    out = {
        "phase": "profile", "products": gen.iters_per_burst, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "gemm_calls": calls_of("matmul_bf16_kernel"), "wrapper_launches": wrapper_launches,
        # the renorm y.mul_(scale), PyTorch's elementwise kernel; the probe's
        # cast is its copy kernel
        "renorm_calls": calls_of("elementwise_kernel") - calls_of("copy"),
        "kernels": kernels,
    }
    emit(out)
    if wrapper_launches != gen.iters_per_burst:
        raise AssertionError(f"the profiled burst launched {wrapper_launches} GEMMs, "
                             f"not {gen.iters_per_burst}")
    if out["gemm_calls"] != wrapper_launches:
        raise AssertionError(f"the trace lost kernels: it shows {out['gemm_calls']} of the "
                             f"wrapper's {wrapper_launches} GEMM launches")
    if out["renorm_calls"] != gen.iters_per_burst:
        raise AssertionError(f"the profiled burst is not one GEMM and one renorm a product: {out}")
    return out


def phase_loop(gen) -> int:
    """The headline loop on the kernel, as bench.py runs it: the HPA reads
    the tensor-core average, the kernel's MFU, which phase_loadgen showed
    can clear the band above the target.  The series holds both recorded
    averages, tensor-core and duty cycle."""
    matmul_kernel.launches = 0
    t0 = time.perf_counter()
    result = run_headline_trial(gen)
    wall = time.perf_counter() - t0
    launches = matmul_kernel.launches
    if launches <= 0:
        raise AssertionError("the closed loop launched the kernel no time")
    emit({
        "phase": "loop", "hpa_metric": TENSORCORE_SERIES, "time_scale": 1.0,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": wall,
        "launches": launches,
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), tc, duty] for t, tc, duty in result.series],
    })
    return launches


#: exporter/nvml.py's structs, by their nvml.h names, and its constants
NVML_STRUCTS = {
    "nvmlUtilization_t": nvml.Utilization, "nvmlMemory_v2_t": nvml.MemoryV2,
    "nvmlGpmSupport_t": nvml.GpmSupport, "nvmlGpmMetric_t": nvml.GpmMetric,
    "nvmlGpmMetricsGet_t": nvml.GpmMetricsGet,
}
NVML_CONSTANTS = {
    "nvmlMemory_v2": nvml.MEMORY_V2_VERSION,
    "NVML_GPM_METRIC_DRAM_BW_UTIL": nvml.NVML_GPM_METRIC_DRAM_BW_UTIL,
    "NVML_GPM_METRIC_MAX": nvml.NVML_GPM_METRIC_MAX,
    "NVML_GPM_METRICS_GET_VERSION": nvml.NVML_GPM_METRICS_GET_VERSION,
    "NVML_GPM_SUPPORT_VERSION": nvml.NVML_GPM_SUPPORT_VERSION,
    "NVML_ERROR_NOT_SUPPORTED": nvml.NVML_ERROR_NOT_SUPPORTED,
    "NVML_ERROR_NOT_FOUND": nvml.NVML_ERROR_NOT_FOUND,
    "NVML_ERROR_INVALID_ARGUMENT": nvml.NVML_ERROR_INVALID_ARGUMENT,
    "NVML_TEMPERATURE_GPU": nvml.NVML_TEMPERATURE_GPU,
    "NVML_DEVICE_UUID_V2_BUFFER_SIZE": nvml.NVML_DEVICE_UUID_V2_BUFFER_SIZE,
}
NVML_HEADERS = [Path("/usr/local/cuda/include"), Path("/usr/local/cuda/targets/x86_64-linux/include")]
# nvidia-smi against NvmlSource, read back to back with the generator idle
SMI_BARS = {"memory.total": 1.0, "memory.used": 256.0, "temperature.gpu": 3.0, "power.draw": 25.0}
#: NVML's duty cycle: its least mean at full duty, and its greatest distance
#: from the generator's own at knob 0.25
NVML_FULL_DUTY = 90.0
NVML_KNOB = 0.25
NVML_KNOB_POINTS = 15.0


def nvml_layout() -> dict:
    """Every size, offset and constant of exporter/nvml.py against a probe
    compiled with the card's nvml.h; raises on any difference."""
    header_dir = next((d for d in NVML_HEADERS if (d / "nvml.h").exists()), None)
    if header_dir is None:
        raise FileNotFoundError(f"nvml.h under none of {NVML_HEADERS}")
    lines, want = [], {}
    for cname, cls in NVML_STRUCTS.items():
        lines.append(f'printf("{cname} %zu\\n", sizeof({cname}));')
        want[cname] = ctypes.sizeof(cls)
        for field, *_ in cls._fields_:
            lines.append(f'printf("{cname}.{field} %zu\\n", offsetof({cname}, {field}));')
            want[f"{cname}.{field}"] = getattr(cls, field).offset
    for name, value in NVML_CONSTANTS.items():
        lines.append(f'printf("{name} %lld\\n", (long long)({name}));')
        want[name] = value
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.c"
        src.write_text("#include <stddef.h>\n#include <stdio.h>\n#include <nvml.h>\n"
                       "int main(void) {\n" + "\n".join(lines) + "\nreturn 0;\n}\n")
        subprocess.run(["gcc", f"-I{header_dir}", str(src), "-o", f"{tmp}/probe"],
                       check=True, capture_output=True, text=True, timeout=120)
        out = subprocess.run([f"{tmp}/probe"], check=True, capture_output=True, text=True,
                             timeout=60).stdout
    got = {k: int(v) for k, v in (ln.rsplit(" ", 1) for ln in out.splitlines())}
    wrong = {k: {"nvml.h": got.get(k), "ctypes": v} for k, v in want.items() if got.get(k) != v}
    if wrong:
        raise AssertionError(f"exporter/nvml.py disagrees with {header_dir}/nvml.h: {wrong}")
    return {"header": str(header_dir / "nvml.h"), "checked": len(want)}


def _smi(index: int, fields: list[str]) -> dict[str, float]:
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return dict(zip(fields, (float(v) for v in line.split(","))))


def _settle(source: NvmlSource, index: int, most_s: float = 30.0) -> float:
    """Wait until the idle card's power has settled: NVML's reading moves
    less than 5 W over a second (a card that just ran at 700 W falls for
    several seconds), at most ``most_s``.  Returns the seconds waited."""
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < most_s:
        power = next(c for c in source.sample() if c.accel_index == index).power_w
        if last is not None and power is not None and abs(power - last) < 5.0:
            break
        last = power
        time.sleep(1.0)
    return time.monotonic() - t0


def _dwell(source: NvmlSource, index: int, gen, seconds: float, lead: float = 1.0) -> list:
    """Sweep ``source`` every half second for ``seconds`` after ``lead``
    while the generator runs in its own thread; returns (NVML's sample,
    the generator's utilization) at each sweep."""
    worker = LoadThread(gen.step).start()
    rows = []
    try:
        time.sleep(lead)
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            chip = next(c for c in source.sample() if c.accel_index == index)
            rows.append((chip, gen.utilization()))
            worker.check()
            time.sleep(0.5)
    finally:
        worker.stop()
    return rows


def phase_nvml(gen) -> dict[int, tuple[str, str]]:
    """NVML beside nvidia-smi and beside the generator's own readings, and a
    kubelet response resolved through it.  Returns the decoded attribution,
    which node_loop uses."""
    uuid = f"GPU-{torch.cuda.get_device_properties(gen.device).uuid}"
    layout = nvml_layout()
    source = NvmlSource()
    try:
        index = source.uuid_to_index(uuid)
        if index is None:
            raise AssertionError(f"NVML knows no device {uuid} (torch {gen.device})")
        torch.cuda.synchronize()
        settled_s = _settle(source, index)
        # NVML, nvidia-smi, NVML: each of NVML's gauges as the mean of the
        # two readings around nvidia-smi's
        around = []
        for _ in range(2):
            chip = next(c for c in source.sample() if c.accel_index == index)
            around.append({"memory.total": chip.hbm_total_bytes / 2**20,
                           "memory.used": chip.hbm_usage_bytes / 2**20,
                           "temperature.gpu": chip.temperature_c, "power.draw": chip.power_w})
            if len(around) == 1:
                smi = _smi(index, list(SMI_BARS))
        idle = {k: {"nvml": (around[0][k] + around[1][k]) / 2, "nvidia_smi": smi[k], "bar": bar}
                for k, bar in SMI_BARS.items()}
        gen.set_intensity(1.0)
        full = _dwell(source, index, gen, 3.0)
        gen.set_intensity(NVML_KNOB)
        knob = _dwell(source, index, gen, 6.0, lead=gen.window + 1.0)
        readings = [c for c, _ in full + knob] + [chip]
        mapping = parse_list_response(
            kubelet_response({REAL_POD: [uuid], "tpu-test-other": ["7"]}),
            GPU_RESOURCE, resolve_uuid=source.uuid_to_index,
        )
        out = {
            "phase": "nvml", "nvml_index": index, "uuid": uuid,
            "cuda_ordinal": gen.device.index, "layout": layout, "settled_s": settled_s,
            "idle": idle,
            "full_duty": {"duty_cycle": [c.duty_cycle for c, _ in full],
                          "mean": sum(c.duty_cycle for c, _ in full) / len(full),
                          "generator": full[-1][1], "bar": NVML_FULL_DUTY,
                          "gpm_dram_bw_util": [c.hbm_bw_util for c, _ in full]},
            "knob": {"intensity": NVML_KNOB, "duty_cycle": [c.duty_cycle for c, _ in knob],
                     "mean": sum(c.duty_cycle for c, _ in knob) / len(knob),
                     "generator_mean": sum(u for _, u in knob) / len(knob),
                     "bar_points": NVML_KNOB_POINTS},
            "tensorcore_util": sorted({c.tensorcore_util for c in readings}, key=str),
            # GPM served the bandwidth from its second sample on
            "gpm_supported": any(c.hbm_bw_util is not None for c, _ in full),
            "power_w": [c.power_w for c, _ in full], "temperature_c": [c.temperature_c for c, _ in full],
            "kubelet_attribution": {str(k): list(v) for k, v in mapping.items()},
        }
    finally:
        source.close()
    emit(out)
    if any(abs(v["nvml"] - v["nvidia_smi"]) > v["bar"] for v in idle.values()):
        raise AssertionError(f"NVML disagrees with nvidia-smi: {idle}")
    if out["full_duty"]["mean"] < NVML_FULL_DUTY:
        raise AssertionError(f"NVML's duty cycle at full duty: {out['full_duty']}")
    if abs(out["knob"]["mean"] - out["knob"]["generator_mean"]) > NVML_KNOB_POINTS:
        raise AssertionError(f"NVML's duty cycle at knob {NVML_KNOB}: {out['knob']}")
    if out["tensorcore_util"] != [None]:
        raise AssertionError(f"NvmlSource set tensorcore_util: {out['tensorcore_util']}")
    if mapping != {index: ("default", REAL_POD), 7: ("default", "tpu-test-other")}:
        raise AssertionError(f"the kubelet response decoded to {mapping}")
    return mapping


def kubelet_response(pods: dict[str, list[str]]) -> bytes:
    """A ListPodResourcesResponse: each pod in namespace ``default`` with one
    container holding ``device_ids`` of nvidia.com/gpu."""
    body = b""
    for pod, ids in pods.items():
        devices = protowire.encode_string(1, GPU_RESOURCE) + b"".join(
            protowire.encode_string(2, i) for i in ids)
        container = protowire.encode_string(1, "main") + protowire.encode_string(2, devices)
        pod_msg = (protowire.encode_string(1, pod) + protowire.encode_string(2, "default")
                   + protowire.encode_string(3, container))
        body += protowire.encode_string(1, pod_msg)
    return body


def phase_node_loop(gen, attribution: dict[int, tuple[str, str]]) -> int:
    """The headline loop through the node exporter: NVML, the decoded
    kubelet attribution and the merged self-report.  The /metrics of the
    last ten scrapes of the exporter (the dwell at full duty, before all four
    replicas run), as the scraper fetched them over HTTP, must carry the
    power, temperature, tensor-core and duty-cycle families for the real
    pod."""
    sweeps: deque = deque(maxlen=10)
    fetch = trial.http_fetch

    def recording_fetch(port: int) -> str:
        text = fetch(port)
        values = {
            fam.name: s.value for fam in parse_text(text)
            for s in fam.samples if dict(s.labels).get("pod") == REAL_POD
        }
        sweeps.append((values, gen.utilization()))
        return text

    matmul_kernel.launches = 0
    t0 = time.perf_counter()
    trial.http_fetch = recording_fetch
    try:
        with tempfile.TemporaryDirectory() as telemetry_dir:
            result = run_node_headline_trial(gen, telemetry_dir, StaticAttributor(attribution))
    finally:
        trial.http_fetch = fetch
    wall = time.perf_counter() - t0
    launches = matmul_kernel.launches
    families = (TPU_CHIP_POWER, TPU_CHIP_TEMP, TPU_TENSORCORE_UTIL, TPU_DUTY_CYCLE)
    missing = [f for f in families for values, _ in sweeps if f not in values]

    def mean(values) -> float | None:
        values = list(values)
        return sum(values) / len(values) if values else None

    out = {
        "phase": "node_loop", "hpa_metric": TENSORCORE_SERIES, "time_scale": 1.0,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": wall, "launches": launches,
        "dwell_scrapes": len(sweeps), "missing_families": sorted(set(missing)),
        "dwell": {
            "nvml_duty_cycle": mean(v.get(TPU_DUTY_CYCLE, math.nan) for v, _ in sweeps),
            "self_reported_duty_cycle": mean(u for _, u in sweeps),
            "merged_tensorcore_util": mean(v.get(TPU_TENSORCORE_UTIL, math.nan) for v, _ in sweeps),
            "power_w": mean(v.get(TPU_CHIP_POWER, math.nan) for v, _ in sweeps),
            "temperature_c": mean(v.get(TPU_CHIP_TEMP, math.nan) for v, _ in sweeps),
        },
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), tc, duty] for t, tc, duty in result.series],
    }
    emit(out)
    if launches <= 0:
        raise AssertionError("the node loop launched the kernel no time")
    if not sweeps or missing:
        raise AssertionError(f"/metrics lacked families for {REAL_POD}: {out['missing_families']}")
    return launches


def _qkv_views(b: int, s: int, h: int, d: int, gen: torch.Generator):
    """q, k, v as the prefill hands them to the kernel: [b, s, h, d] views of
    one fused [b, s, 3*h*d] projection."""
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    return tuple(t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_flash_parity() -> float:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    rows = []
    for b, s, h, d, causal, with_lse, split in FLASH_SHAPES:
        q, k, v = _qkv_views(b, s, h, d, gen)
        if split is None:
            got = flash_attention_kernel(q, k, v, causal, with_lse=with_lse)
        else:
            got = flash_attention._launch_fwd(q, k, v, causal, with_lse, split)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v, causal, with_lse=with_lse)
        lse_err = None
        if with_lse:
            (got, got_lse), (want, want_lse) = got, want
            lse_err = float((got_lse - want_lse).abs().max())
        diff = (got.float() - want.float()).abs()
        rms_want = float(want.float().square().mean().sqrt())
        row = {"bshd": [b, s, h, d], "causal": causal,
               "kv_split": split or flash_attention.fwd_split(b * h, s, _sms()),
               "max_abs_err": float(diff.max()),
               "rms_err_over_rms_want": float(diff.square().mean().sqrt()) / rms_want,
               "lse_max_abs_err": lse_err, "max_abs_out": float(want.float().abs().max()),
               "rms_out": rms_want}
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
        if (
            row["max_abs_err"] > FLASH_ATOL
            or row["rms_err_over_rms_want"] > FLASH_REL_RMS
            or (lse_err is not None and lse_err > LSE_ATOL)
            or not bool(torch.isfinite(got.float()).all())
        ):
            emit({"phase": "flash_parity", "shapes": rows})
            raise AssertionError(f"flash kernel disagrees with its plain version: {row}")
    refused = {}
    bf16 = torch.bfloat16
    ok = torch.zeros(1, 128, 2, 128, device="cuda", dtype=bf16)
    cases = {
        "f32": (ok.float(), ok.float(), ok.float()),
        "seq_100": (ok[:, :100],) * 3,
        "head_dim_256": (torch.zeros(1, 128, 1, 256, device="cuda", dtype=bf16),) * 3,
        "shape_mismatch": (ok, ok[:, :64], ok[:, :64]),
        "stride_not_8": (torch.zeros(1, 128, 2, 132, device="cuda", dtype=bf16)[..., :128],) * 3,
    }
    for case, (q, k, v) in cases.items():
        try:
            flash_attention_kernel(q, k, v, True)
        except (TypeError, ValueError) as e:
            refused[case] = type(e).__name__
        else:
            raise AssertionError(f"flash_attention_kernel took a {case} operand")
    try:
        flash_attention._launch_fwd(ok, ok, ok, True, False, 3)
    except ValueError as e:
        refused["kv_split_3"] = type(e).__name__
    else:
        raise AssertionError("the forward took three consumer warpgroups a CTA")
    emit({"phase": "flash_parity", "atol": FLASH_ATOL, "lse_atol": LSE_ATOL,
          "rel_rms": FLASH_REL_RMS, "shapes": rows, "refused": refused})
    return worst


def flash_work(b: int, s: int, h: int, d: int, causal: bool) -> tuple[float, float]:
    """(operations, bytes) of one forward: two products of 2 d operations
    per (batch-head, query, key) pair the causal loop visits, and Q, K, V
    read once and O written once in bf16."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return 4.0 * d * pairs, 4.0 * b * s * h * d * 2


def phase_flash_timing(peak_tflops: float, peak_gbps: float) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for b, s, h, d, with_lse, views in FLASH_TIMED:
        if views:
            q, k, v = _qkv_views(b, s, h, d, gen)
        else:
            q, k, v = (
                torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)
            )
        # scaled_dot_product_attention's layout, made before timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = flash_work(b, s, h, d, causal=True)
        if with_lse:
            nbytes += b * h * s * 4  # the fp32 logsumexp, written once
        ms_by_ops = flops / (peak_tflops * 1e12) * 1e3
        ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
        iters = 100 if s <= 1024 else 50 if s <= 2048 else 20

        def kernel_call():
            flash_attention_kernel(q, k, v, True, with_lse=with_lse)

        def library_call():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def plain_call():
            flash_attention_reference(q, k, v, True, with_lse=with_lse)

        # device time from graph replays, in turns: plain, kernel, library,
        # kernel, library, plain; then on one and on two consumer warpgroups;
        # and once the kernel in a host loop of launches
        plain = [graph_time_ms(plain_call, 4)]
        kernel = [graph_time_ms(kernel_call, iters)]
        library = [graph_time_ms(library_call, iters)]
        kernel.append(graph_time_ms(kernel_call, iters))
        library.append(graph_time_ms(library_call, iters))
        plain.append(graph_time_ms(plain_call, 4))
        by_split = {
            split: graph_time_ms(
                lambda n=split: flash_attention._launch_fwd(q, k, v, True, with_lse, n), iters)
            for split in flash_attention.FWD_SPLITS
        }
        host_loop = cuda_time_ms(kernel_call, iters)
        row = {
            "bshd": [b, s, h, d], "causal": True, "with_lse": with_lse, "qkv_views": views,
            "kv_split": flash_attention.fwd_split(b * h, s, _sms()),
            "ms": min(kernel), "ms_runs": kernel, "ms_by_split": by_split,
            "ms_host_launch_loop": host_loop,
            "tflops": flops / min(kernel) / 1e9,
            "plain_ms": min(plain), "plain_ms_runs": plain,
            "library_ms": min(library), "library_ms_runs": library,
            "library": "F.scaled_dot_product_attention(is_causal=True)",
            "over_library": min(kernel) / min(library),
            "bound_ms": max(ms_by_ops, ms_by_bytes),
            "bound_by": "operations" if ms_by_ops >= ms_by_bytes else "bytes",
            "bound_ops_ms": ms_by_ops, "bound_bytes_ms": ms_by_bytes,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        out.append(row)
    emit({"phase": "flash_timing", "shapes": out})
    return out


def _cache_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    diff = (got.float() - want.float()).abs()
    bad = int((diff > SERVE_ATOL + SERVE_CACHE_RTOL * want.float().abs()).sum())
    return float(diff.max()), bad


def phase_serve_parity(gen: DecodeLoadGen) -> dict:
    """At the shipped sizes: (1) prefill's logits and cache against the same
    prompt fed through decode_step one position at a time; (2) the graph
    burst's tokens, position and cache against the eager burst's, exactly."""
    cfg, params, prompt = gen.cfg, gen._params, gen._prompt
    plen = prompt.shape[1]
    logits, cache = transformer.prefill(
        params, cfg, prompt, transformer.init_kv_cache(cfg, gen.batch, gen.device)
    )
    step_cache = transformer.init_kv_cache(cfg, gen.batch, gen.device)
    for pos in range(plen):
        step_logits, step_cache = transformer.decode_step(params, cfg, prompt[:, pos], step_cache, pos)
    torch.cuda.synchronize()
    logit_err = float((logits - step_logits).abs().max())
    k_err, k_bad = _cache_err(cache["k"][:, :, :, :plen], step_cache["k"][:, :, :, :plen])
    v_err, v_bad = _cache_err(cache["v"][:, :, :, :plen], step_cache["v"][:, :, :, :plen])
    out = {
        "phase": "serve_parity", "sizes": SERVE_SIZES, "dtype": "bfloat16",
        "atol": SERVE_ATOL, "cache_rtol": SERVE_CACHE_RTOL,
        "prefill_vs_stepwise": {
            "logits_max_abs_err": logit_err, "k_max_abs_err": k_err, "v_max_abs_err": v_err,
            "cache_out_of_tol": k_bad + v_bad,
            "logits_shape": list(logits.shape),
            "argmax_agree": float((logits.argmax(-1) == step_logits.argmax(-1)).float().mean()),
        },
    }
    if (
        logit_err > SERVE_ATOL or k_bad or v_bad
        or not bool(torch.isfinite(logits).all())
        or list(logits.shape) != [gen.batch, cfg.vocab]
    ):
        raise AssertionError(f"prefill disagrees with stepwise decode: {out}")
    runs = {}
    for mode, use_graph in (("eager", False), ("graph", True)):
        gen.reset_state()
        gen.run_burst(use_graph=use_graph)
        tokens, burst_cache, pos = gen.state()
        runs[mode] = (tokens.clone(), {n: t.clone() for n, t in burst_cache.items()}, pos)
    (et, ec, ep), (gt, gc, gp) = runs["eager"], runs["graph"]
    same = torch.equal(et, gt) and ep == gp and all(torch.equal(ec[n], gc[n]) for n in ec)
    out["graph_vs_eager"] = {
        "bit_identical": same, "pos": gp, "tokens": gt.tolist(),
        "cache_max_abs_diff": max(float((ec[n].float() - gc[n].float()).abs().max()) for n in ec),
    }
    emit(out)
    if not same:
        raise AssertionError(f"the graph burst differs from the eager burst: {out['graph_vs_eager']}")
    return out


def phase_serve_loadgen(gen: DecodeLoadGen) -> dict:
    t0 = time.perf_counter()
    gen.run_burst(use_graph=False)
    eager_ms = (time.perf_counter() - t0) * 1e3
    bursts = 20
    t0 = time.perf_counter()
    for _ in range(bursts):
        gen.run_burst()
    graph_ms = (time.perf_counter() - t0) * 1e3 / bursts
    saturated, headroom = measure_saturated_signal(gen)
    stats = gen.stats()
    out = {
        "phase": "serve_loadgen", "sizes": SERVE_SIZES,
        "tokens_per_burst": gen.tokens_per_burst, "window_s": gen.window,
        "burst_ms_graph": graph_ms, "burst_ms_eager": eager_ms,
        "bytes_per_burst": gen.bytes_per_burst(),
        "device_gbps_at_graph_burst": gen.bytes_per_burst() / graph_ms / 1e6,
        "tokens_per_s": stats.tokens_per_sec,
        "prefill_tokens_per_s": stats.prefill_tokens_per_sec,
        "achieved_gbps": stats.achieved_gbps, "hbm_bw_util_pct": stats.hbm_bw_util_pct,
        "peak_hbm_gbps": gen.peak_hbm_gbps,
        "saturated_signal_pct": saturated, "target_pct": SERVE_BW_TARGET,
        "headroom": headroom, "flash_launches_per_burst": gen.flash_launches_per_burst,
    }
    emit(out)
    if gen.flash_launches_per_burst != gen.cfg.n_layers:
        raise AssertionError(f"the captured burst holds {gen.flash_launches_per_burst} flash launches")
    return out


def _profile_burst(gen: DecodeLoadGen) -> tuple[dict, float]:
    """Device time and calls by kernel of one graph burst under
    torch.profiler, and the burst's host wall time in ms."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        gen.run_burst()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _traced_kernels(prof, 100)
    return kernels, wall_ms


def phase_serve_profile(gen: DecodeLoadGen, attempts: int = 3) -> dict:
    """One graph burst under torch.profiler: device time by kernel, and the
    device's idle share of the burst's host wall time (profiled, so an upper
    bound).  A trace begun right at a graph replay has at times missed the
    replay's first several hundred kernels, the prefill's among them: a
    burst whose trace lacks the flash launches is traced again, up to
    ``attempts`` bursts, and every attempt's kernel count is reported."""
    gen.run_burst()
    torch.cuda.synchronize()
    calls_by_attempt = []
    for _ in range(attempts):
        kernels, wall_ms = _profile_burst(gen)
        flash = {name: k for name, k in kernels.items() if "flash_fwd_kernel" in name}
        calls_by_attempt.append(sum(k["calls"] for k in kernels.values()))
        if sum(k["calls"] for k in flash.values()) == gen.cfg.n_layers:
            break
    busy_ms = sum(k["ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = {
        "phase": "serve_profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_names": len(kernels), "kernel_calls": calls_by_attempt[-1],
        "kernel_calls_by_attempt": calls_by_attempt,
        "flash": flash, "top_kernels": top,
    }
    emit(out)
    if sum(k["calls"] for k in flash.values()) != gen.cfg.n_layers:
        raise AssertionError(f"the profiled burst ran the flash kernel {flash}, not once per layer")
    return out


def phase_serve_loop(gen: DecodeLoadGen) -> int:
    """The serve loop on the flash kernel, at time scale 1."""
    flash_attention_kernel.launches = 0
    replays = gen.replays
    t0 = time.perf_counter()
    result = run_serve_trial(gen)
    wall = time.perf_counter() - t0
    launches = (
        flash_attention_kernel.launches
        + (gen.replays - replays) * gen.flash_launches_per_burst
    )
    if launches <= 0:
        raise AssertionError("the serve loop launched the flash kernel no time")
    emit({
        "phase": "serve_loop", "hpa_metric": SERVE_SERIES, "target": SERVE_BW_TARGET,
        "time_scale": 1.0, "saturated_signal_pct": result.saturated_pct,
        "headroom": result.headroom,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": wall,
        "replays": gen.replays - replays, "flash_launches": launches,
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), v] for t, v in result.series],
    })
    return launches


def _grad_err(
    got: torch.Tensor, want: torch.Tensor, atol: float = BWD_ATOL, rel_rms: float = BWD_REL_RMS
) -> dict:
    want = want.float()
    diff = (got.float() - want).abs()
    bad = int((diff > atol + BWD_RTOL * want.abs()).sum())
    at = int(diff.argmax())
    rms_ratio = float(diff.square().mean().sqrt() / want.square().mean().sqrt())
    finite = bool(torch.isfinite(got.float()).all())
    return {
        "ok": finite and bad == 0 and rms_ratio <= rel_rms,
        "max_abs_err": float(diff.view(-1)[at]), "out_of_tol": bad, "atol": atol,
        "want_at_max_err": float(want.view(-1)[at]),
        "excess_over_rtol": float((diff - BWD_RTOL * want.abs()).max()),
        "rms_err_over_rms_want": rms_ratio, "rel_rms_bar": rel_rms,
        "rms_want": float(want.square().mean().sqrt()),
        "max_abs_want": float(want.abs().max()), "finite": finite,
    }


def phase_flash_bwd_parity() -> dict[str, float]:
    """The two backward kernels against their plain versions, then the
    autograd Function against autograd through the plain forward.  Returns
    the worst absolute error of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"dq": 0.0, "dkv": 0.0}
    rows = []
    failed = []

    def check(row: dict, names) -> None:
        if not all(row[n]["ok"] for n in names):
            failed.append(row)

    for b, s, h, d, causal in BWD_SHAPES:
        q, k, v = _qkv_views(b, s, h, d, gen)
        o, lse = flash_attention_kernel(q, k, v, causal, with_lse=True)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        row = {"bshd": [b, s, h, d], "causal": causal}
        row.update({n: _grad_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)})
        rows.append(row)
        check(row, ("dq", "dk", "dv"))
        worst["dq"] = max(worst["dq"], row["dq"]["max_abs_err"])
        worst["dkv"] = max(worst["dkv"], row["dk"]["max_abs_err"], row["dv"]["max_abs_err"])
    b, s, h, d = LLM_SHAPE
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    grads = {}
    for name, fn in (
        ("function", lambda q, k, v: FlashAttention.apply(q, k, v, True)),
        ("plain_autograd", lambda q, k, v: flash_attention_reference(q, k, v, True)),
    ):
        leaf = qkv.clone().requires_grad_()
        q, k, v = (t.view(b, s, h, d) for t in leaf.split(h * d, dim=-1))
        fn(q, k, v).backward(do)
        grads[name] = leaf.grad
    torch.cuda.synchronize()
    function = {"bshd": list(LLM_SHAPE), "causal": True,
                "dqkv": _grad_err(grads["function"], grads["plain_autograd"], FN_ATOL,
                                         FN_REL_RMS)}
    check(function, ("dqkv",))
    refused = {}
    bf16 = torch.bfloat16
    ok = torch.zeros(1, 128, 2, 128, device="cuda", dtype=bf16)
    lse = torch.zeros(2, 128, 1, device="cuda")
    cases = {
        "f32": (ok.float(), lse),
        "seq_100": (ok[:, :100], lse[:, :100]),
        "head_dim_256": (torch.zeros(1, 128, 2, 256, device="cuda", dtype=bf16), lse),
        "stride_not_8": (torch.zeros(1, 128, 2, 132, device="cuda", dtype=bf16)[..., :128], lse),
        "lse_shape": (ok, lse[:1]),
        "lse_bf16": (ok, lse.to(bf16)),
    }
    for case, (t, l) in cases.items():
        try:
            flash_attention_bwd_kernel(t, t, t, t, l, t, True)
        except (TypeError, ValueError) as e:
            refused[case] = type(e).__name__
        else:
            raise AssertionError(f"flash_attention_bwd_kernel took a {case} operand")
    emit({"phase": "flash_bwd_parity", "atol": BWD_ATOL, "rtol": BWD_RTOL,
          "rel_rms": BWD_REL_RMS, "shapes": rows,
          "function_vs_plain_autograd": function, "refused": refused})
    if failed:
        raise AssertionError(f"flash backward disagrees with its plain version: {failed}")
    return worst


def bwd_work(b: int, s: int, h: int, d: int, causal: bool) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each backward kernel: per (batch-head, query,
    key) pair at or below the diagonal three products of 2 d operations for
    dQ (S, dP, dS K) and four for dK/dV (S, dP, P^T dO, dS^T Q); bf16 Q, K,
    V and dO read once, fp32 lse and delta read once, the bf16 gradients
    written once."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elems, rows = b * s * h * d, b * h * s
    reads = 4 * elems * 2 + 2 * rows * 4
    return {"dq": (6.0 * d * pairs, reads + elems * 2),
            "dkv": (8.0 * d * pairs, reads + 2 * elems * 2)}


def _bound(flops: float, nbytes: float, peak_tflops: float, peak_gbps: float) -> dict:
    ms_by_ops = flops / (peak_tflops * 1e12) * 1e3
    ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
    return {"bound_ms": max(ms_by_ops, ms_by_bytes),
            "bound_by": "operations" if ms_by_ops >= ms_by_bytes else "bytes",
            "bound_ops_ms": ms_by_ops, "bound_bytes_ms": ms_by_bytes,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def phase_flash_bwd_timing(peak_tflops: float, peak_gbps: float) -> list[dict]:
    """Each backward kernel's device time by graph replay, in turns (plain,
    kernel, library, kernel, plain), beside its bound, its plain version and
    scaled_dot_product_attention's backward: SDPA forward plus backward minus
    SDPA forward, one call that computes dQ, dK and dV together.  That call
    is compared whole with the pair (``pair``: dQ ms + dK/dV ms); each
    kernel's ``library_ms`` is the call's time times the kernel's share of
    the pair's operations (6/14 for dQ, 8/14 for dK/dV), so that no row
    reads as one kernel against the whole call.  The training forward (with
    the logsumexp) is timed at the same shapes."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for b, s, h, d in BWD_TIMED:
        q, k, v, do = (
            torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4)
        )
        o, lse = flash_attention_kernel(q, k, v, True, with_lse=True)
        delta = flash_attention_bwd_delta(o, do)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        iters = 50 if s <= 2048 else 10
        plain_iters = 2

        def sdpa_fwd():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        library_fwd = graph_time_ms(sdpa_fwd, iters)
        library_bwd = graph_time_ms(sdpa_fwd_bwd, iters) - library_fwd
        row = {"bshd": [b, s, h, d], "causal": True,
               "library": "F.scaled_dot_product_attention backward (fwd+bwd minus fwd)",
               "library_fwd_ms": library_fwd}
        plains = {
            "dq": lambda: flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, True),
            "dkv": lambda: flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, True),
        }
        work = bwd_work(b, s, h, d, causal=True)
        pair_flops = sum(flops for flops, _ in work.values())
        for name, (flops, nbytes) in work.items():
            def kernel_call(name=name):
                flash_attention_bwd_launch(name, q, k, v, do, lse, delta, True)

            plain = [graph_time_ms(plains[name], plain_iters)]
            kernel = [graph_time_ms(kernel_call, iters)]
            kernel.append(graph_time_ms(kernel_call, iters))
            plain.append(graph_time_ms(plains[name], plain_iters))
            row[name] = {
                "ms": min(kernel), "ms_runs": kernel, "tflops": flops / min(kernel) / 1e9,
                "plain_ms": min(plain), "plain_ms_runs": plain,
                "library_ms": library_bwd * flops / pair_flops,
                "library_share": flops / pair_flops,
                **_bound(flops, nbytes, peak_tflops, peak_gbps),
            }
            row[name]["fraction_of_bound"] = row[name]["bound_ms"] / row[name]["ms"]
        pair_ms = row["dq"]["ms"] + row["dkv"]["ms"]
        row["pair"] = {"ms": pair_ms, "library_ms": library_bwd,
                       "over_library": pair_ms / library_bwd}
        fwd_flops, fwd_bytes = flash_work(b, s, h, d, causal=True)
        fwd_ms = graph_time_ms(lambda: flash_attention_kernel(q, k, v, True, with_lse=True), iters)
        row["fwd_with_lse"] = {"ms": fwd_ms, "tflops": fwd_flops / fwd_ms / 1e9,
                               "library_ms": library_fwd,
                               **_bound(fwd_flops, fwd_bytes, peak_tflops, peak_gbps)}
        out.append(row)
    emit({"phase": "flash_bwd_timing", "shapes": out})
    return out


def _bwd_counts() -> dict[str, int]:
    return {"fwd": flash_attention_kernel.launches, "dq": flash_attention_bwd_kernel.dq_launches,
            "dkv": flash_attention_bwd_kernel.dkv_launches}


def _zero_counts() -> None:
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.dq_launches = 0
    flash_attention_bwd_kernel.dkv_launches = 0


def phase_llm_parity() -> tuple[dict[str, LlmLoadGen], dict[str, int]]:
    """At full width, from the same seeded weights and tokens (LlmLoadGen's):
    the gradients of the training loss through the flash kernels (auto) and
    through the plain blocking (ring), leaf by leaf; then one step of each
    generator.  Returns the generators, one step in, and the auto step's
    launches."""
    gens = {impl: LlmLoadGen(attn_impl=impl, device="cuda:0") for impl in ("auto", "ring")}
    cfg = gens["auto"].cfg
    grads = {impl: transformer.make_loss_and_grad(cfg, impl)(g.params, g.tokens)[1]
             for impl, g in gens.items()}
    names = ["embed", "pos", "out_norm"] + [
        f"blocks[{i}].{leaf}" for i in range(cfg.n_layers)
        for leaf in ("attn_norm", "wqkv", "wo", "mlp_norm", "w1", "w2")
    ]
    grad_rel = {}
    for name, ga, gr in zip(names, grads["auto"], grads["ring"], strict=True):
        # wqkv's gradient apart for its Q, K and V columns: dQ reaches the
        # first third only, dK and dV the others
        parts = zip(("q", "k", "v"), ga.split(cfg.d_model, -1), gr.split(cfg.d_model, -1)) \
            if name.endswith("wqkv") else ((None, ga, gr),)
        for part, a, r in parts:
            a, r = a.float(), r.float()
            key = f"{name}.{part}" if part else name
            grad_rel[key] = float((a - r).norm() / r.norm())
    del grads
    before = {n: t.clone() for n, t in enumerate(transformer.param_leaves(gens["auto"].params))}
    _zero_counts()
    gens["auto"].warmup()
    counts = _bwd_counts()
    gens["ring"].warmup()
    losses = {impl: g.stats().last_loss for impl, g in gens.items()}
    worst, bad, moved = 0.0, 0, 0
    leaves = zip(*(transformer.param_leaves(g.params) for g in gens.values()), strict=True)
    for n, (a, r) in enumerate(leaves):
        diff = (a.float() - r.float()).abs()
        worst = max(worst, float(diff.max()))
        bad += int((diff > TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * r.float().abs()).sum())
        moved += int((a != before[n]).sum())
    out = {
        "phase": "llm_parity", "cfg": {"batch": gens["auto"].batch, "seq": cfg.max_seq,
                                         "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                                         "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
                                         "dtype": "bfloat16"},
        "loss": losses, "loss_diff": abs(losses["auto"] - losses["ring"]),
        "loss_atol": TRAIN_LOSS_ATOL,
        "grad_rel_err": grad_rel, "grad_rel_err_max": max(grad_rel.values()),
        "grad_rel_bar": TRAIN_GRAD_REL,
        "param_max_abs_diff": worst, "param_out_of_tol": bad,
        "param_rtol": TRAIN_PARAM_RTOL, "params_moved_by_auto_step": moved,
        "auto_step_launches": counts,
    }
    emit(out)
    want = {"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers, "dkv": cfg.n_layers}
    if not all(math.isfinite(x) for x in losses.values()) or out["loss_diff"] > TRAIN_LOSS_ATOL:
        raise AssertionError(f"the auto and ring steps disagree: {out}")
    if not all(x <= TRAIN_GRAD_REL for x in grad_rel.values()):  # a NaN fails too
        raise AssertionError(f"the auto and ring gradients disagree: {grad_rel}")
    if bad or moved == 0:
        raise AssertionError(f"the updated weights disagree or did not move: {out}")
    if counts != want:
        raise AssertionError(f"one auto step launched {counts}, not {want}")
    return gens, counts


def phase_llm_train(gens: dict[str, LlmLoadGen], seconds: float = 3.0) -> dict[str, int]:
    """Each generator steps for ``seconds`` and at least twenty steps: step
    times, tokens/s and the losses.  Returns the auto run's launches."""
    out = {"phase": "llm_train"}
    counts = {}
    for impl, gen in gens.items():
        if impl == "auto":
            _zero_counts()
        ms, losses = [], []
        t0 = time.perf_counter()
        while len(ms) < 20 or time.perf_counter() - t0 < seconds:
            ms.append(gen.step() * 1e3)
            losses.append(gen.stats().last_loss)
        if impl == "auto":
            counts = _bwd_counts()
        stats = gen.stats()
        out[impl] = {
            "steps": len(ms), "step_ms_median": sorted(ms)[len(ms) // 2], "step_ms_min": min(ms),
            "tokens_per_s": stats.tokens_per_sec, "context_length": stats.context_length,
            "losses": losses,
        }
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"the {impl} run's loss went non-finite: {losses}")
    n_layers, steps = gens["auto"].cfg.n_layers, out["auto"]["steps"]
    out["auto"]["launches"] = counts
    out["auto_tokens_per_s_over_ring"] = out["auto"]["tokens_per_s"] / out["ring"]["tokens_per_s"]
    emit(out)
    want = {"fwd": 2 * n_layers * steps, "dq": n_layers * steps, "dkv": n_layers * steps}
    if counts != want:
        raise AssertionError(f"{steps} auto steps launched {counts}, not {want}")
    return counts


def phase_llm_profile(gen: LlmLoadGen) -> dict:
    """One auto step under torch.profiler: device time by kernel, the
    launches of the step, and the device's idle share of the step's host
    wall time (profiled, so an upper bound)."""
    gen.step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _warm_trace()
        _zero_counts()
        t0 = time.perf_counter()
        gen.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    wrapper = _bwd_counts()
    kernels = _traced_kernels(prof, 100)
    busy_ms = sum(k["ms"] for k in kernels.values())

    def calls_of(name: str) -> int:
        return sum(k["calls"] for key, k in kernels.items() if name in key)

    flash = {key: k for key, k in kernels.items() if "flash_" in key}
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16])
    # device time by kind: the flash kernels, cuBLAS's products, copies and
    # casts, and everything else (elementwise, reductions, the update)
    kinds = {"flash": ("flash_",), "products": ("nvjet", "gemm", "xmma"), "copies": ("copy",)}
    by_kind = {kind: {"ms": 0.0, "calls": 0} for kind in (*kinds, "other")}
    for key, k in kernels.items():
        kind = next((n for n, marks in kinds.items() if any(m in key for m in marks)), "other")
        by_kind[kind]["ms"] += k["ms"]
        by_kind[kind]["calls"] += k["calls"]
    out = {
        "phase": "llm_profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_names": len(kernels), "kernel_calls": sum(k["calls"] for k in kernels.values()),
        "by_kind": by_kind, "flash": flash, "top_kernels": top, "wrapper_launches": wrapper,
    }
    emit(out)
    n = gen.cfg.n_layers
    traced = {name: calls_of(f"flash_{kind}_kernel") for name, kind in
              (("fwd", "fwd"), ("dq", "bwd_dq"), ("dkv", "bwd_dkv"))}
    if wrapper != {"fwd": 2 * n, "dq": n, "dkv": n}:
        raise AssertionError(f"the profiled step launched the flash kernels {wrapper}")
    if traced != wrapper:
        raise AssertionError(f"the trace lost kernels: it shows {traced} of the wrappers' "
                             f"launches {wrapper}")
    return out


def phase_llm_entry(work_dir: str, seconds: float = 15.0) -> dict:
    """The rung's container command, ``python -m
    k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with WORKLOAD=llm at its
    defaults and CHECKPOINT_DIR (CHECKPOINT_EVERY 200), for ``seconds``
    after its banner, then SIGTERM: it must exit 0 having reported steps at
    the full context and a finite loss; started again it resumes from its
    last save's step."""
    ckpt_dir = str(Path(work_dir) / "llm-ckpt")
    env = dict(os.environ, WORKLOAD="llm", REPORT_S="2", CHECKPOINT_DIR=ckpt_dir,
               CHECKPOINT_EVERY="200", TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    module = "k8s_gpu_hpa_tpu_torch.loadgen.multihost"
    entry = _Entry(module, env)
    try:
        banner = entry.wait_for("tpu-test multihost")
        time.sleep(seconds)
    finally:
        code = entry.stop()
    report_lines = [ln for ln in entry.lines if ln.startswith("steps=")]
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in report_lines]
    out = {"phase": "llm_entry", "exit_code": code, "run_s": seconds, "banner": banner,
           "reports": report_lines,
           "final": [ln for ln in entry.lines if ln.startswith("final checkpoint")]}
    last = reports[-1] if reports else {}
    if (
        code != 0 or not reports or last.get("ctx") != "2048"
        or int(last.get("steps", "0")) <= 0 or not math.isfinite(float(last.get("loss", "nan")))
    ):
        emit(out)
        raise AssertionError(f"the llm entry point did not train as expected: {entry.lines[-20:]}")
    out["restart"] = _resume(module, env, ckpt_dir, entry)
    emit(out)
    return out



# The training rung at the shipped tpu-train sizes (deploy/tpu-train-deployment.yaml:
# ResNet-50 with the CIFAR stem, BATCH_SIZE 256, IMAGE_SIZE 32).  Its convolutions
# are cuDNN's, its BatchNorm PyTorch's own kernels and its head cuBLAS's, as XLA's
# are in the JAX package: no Pallas kernel backs the path, so no hand-written
# kernel runs on it.
TRAIN_BATCH = 256
TRAIN_IMAGE = 32
#: train_parity's batch: the step on the card in bf16 against the same step on
#: the CPU in f32.  At 16 images stage 3's BatchNorms normalise over 256 values
#: a channel, where bf16's roundings stay well inside the bar
TRAIN_PARITY_BATCH = 16
#: the port's bf16 bar, on the loss and on the logits, relative to their RMS
TRAIN_BF16_REL = 0.06
#: the batch statistics a running buffer's move implies, (ra' - 0.9 ra) / 0.1,
#: against the layer input's mean and biased variance, relative to their
#: largest: the unbiased variance differs by 1/255 at stage 3 (n = 256)
TRAIN_STATS_REL = 1e-3
TRAIN_KNOB = 0.25
TRAIN_KNOB_POINTS = 7.5
#: kernels of one training step a trace must hold, by name mark: each
#: BatchNorm's four (statistics and normalisation forward, reduction and
#: input gradient backward; PyTorch's channels_last kernels on the card), and
#: the batch draw's two (images and labels), the step's first kernels
TRAIN_BN_KERNELS = 4
TRAIN_DRAW_KERNELS = 2


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def phase_train_parity() -> dict:
    """One training step of the port at full width on the card (bf16,
    channels_last) against the same step on the CPU in f32, from the same
    seeded weights and the same batch: the train-mode logits and the step's
    loss within 0.06 of their RMS.  And the running statistics of a stage-3
    BatchNorm after one training forward against flax's update from that
    layer's input, ``0.9 ra + 0.1 batch`` with the biased variance."""
    gen = TrainLoadGen(batch_size=TRAIN_PARITY_BATCH, image_size=TRAIN_IMAGE, device="cuda:0")
    ref = TrainLoadGen(batch_size=TRAIN_PARITY_BATCH, image_size=TRAIN_IMAGE,
                       dtype=torch.float32, device="cpu")
    ref.model.load_state_dict(gen.model.state_dict())
    images, labels = gen.batch()
    bn = gen.model.stage3_block2.bn2
    seen = {}
    hook = bn.register_forward_pre_hook(lambda m, args: seen.update(x=args[0].detach().clone()))
    before = (bn.running_mean.clone(), bn.running_var.clone())
    with torch.no_grad():
        logits = gen.model(images, train=True)
        want_logits = ref.model(images.cpu(), train=True)
    hook.remove()
    var, mean = torch.var_mean(seen["x"].float(), (0, 2, 3), correction=0)
    n = seen["x"][:, 0].numel()

    def implied_err(running, ra, want):
        implied = (running - 0.9 * ra) / 0.1
        return float((implied - want).abs().max() / want.abs().max())

    stats_err = {"running_mean": implied_err(bn.running_mean, before[0], mean),
                 "running_var": implied_err(bn.running_var, before[1], var)}
    unbiased_err = implied_err(bn.running_var, before[1], var * n / (n - 1))
    loss = float(gen.train_step(images, labels))
    want_loss = float(ref.train_step(images.cpu(), labels.cpu()))
    out = {
        "phase": "train_parity", "model": "resnet50 cifar_stem", "batch": TRAIN_PARITY_BATCH,
        "image": TRAIN_IMAGE, "dtype": "bfloat16 against float32 on the CPU",
        "activations_channels_last": seen["x"].is_contiguous(memory_format=torch.channels_last),
        "logits_rel_rms": _rel_rms(logits.float().cpu(), want_logits),
        "loss": loss, "loss_cpu_f32": want_loss, "loss_rel": abs(loss - want_loss) / abs(want_loss),
        "bar": TRAIN_BF16_REL, "stage3_bn_stats_rel_err": stats_err,
        "stage3_bn_values_a_channel": n,
        "stage3_bn_var_if_unbiased_rel_err": unbiased_err, "stats_bar": TRAIN_STATS_REL,
    }
    emit(out)
    if not out["logits_rel_rms"] <= TRAIN_BF16_REL or not out["loss_rel"] <= TRAIN_BF16_REL:
        raise AssertionError(f"the step on the card disagrees with the f32 step: {out}")
    if not all(e <= TRAIN_STATS_REL for e in stats_err.values()):
        raise AssertionError(f"the running statistics did not move as flax's do: {out}")
    if not out["activations_channels_last"]:
        raise AssertionError("the activations are not channels_last on the card")
    return out


def phase_train_loadgen() -> tuple[TrainLoadGen, dict]:
    """TrainLoadGen at the shipped sizes: step time (median), images/s and
    the peak memory over some twenty steps at full duty; then the
    container's knob at 0.25, whose 3 s windowed duty cycle must read 0.25."""
    gen = TrainLoadGen(batch_size=TRAIN_BATCH, image_size=TRAIN_IMAGE, device="cuda:0")
    gen.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    t0 = time.perf_counter()
    while len(ms) < 20 or time.perf_counter() - t0 < 3.0:
        ms.append(gen.step() * 1e3)
    images_per_s = len(ms) * TRAIN_BATCH / (sum(ms) / 1e3)
    peak = torch.cuda.max_memory_allocated()
    knob = IntensityKnob(TRAIN_KNOB)
    duty = WindowedDuty(3.0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 7.0:
        t_iter = time.perf_counter()
        busy = gen.step()
        duty.record(time.perf_counter() - t_iter)
        knob.throttle(busy)
    out = {
        "phase": "train_loadgen", "model": "resnet50 cifar_stem", "batch": TRAIN_BATCH,
        "image": TRAIN_IMAGE, "dtype": "bfloat16", "steps": len(ms),
        "step_ms_median": sorted(ms)[len(ms) // 2], "step_ms_min": min(ms),
        "images_per_s": images_per_s, "peak_memory_gib": peak / 2**30,
        "last_loss": gen.stats().last_loss,
        "knob": TRAIN_KNOB, "duty_at_knob_pct": duty.value(),
    }
    emit(out)
    if not math.isfinite(out["last_loss"]):
        raise AssertionError(f"the training loss went non-finite: {out}")
    if abs(out["duty_at_knob_pct"] - 100.0 * TRAIN_KNOB) > TRAIN_KNOB_POINTS:
        raise AssertionError(f"the duty cycle does not track the knob: {out}")
    return gen, out


#: device time by kind in train_profile, by kernel-name marks (cuDNN's
#: convolution kernels; BatchNorm's; the SGD update's foreach kernels;
#: copies, casts and memsets); the rest is elementwise work and reductions
TRAIN_KINDS = {  # the first kind whose marks a name holds
    "batchnorm": ("batch_norm", "batchnorm", "bn_", "welford"),
    "sgd": ("multi_tensor_apply", "foreach"),
    "copies": ("copy", "Memcpy", "Memset", "cast"),
    "convolution": ("conv", "xmma", "implicit_gemm", "cudnn", "cutlass", "sm90_", "nchw", "nhwc",
                    "gemm", "nvjet"),
}


def _profile_train_step(gen: TrainLoadGen) -> dict:
    """Trace a lead step and then the measured one, each under a named
    range, and keep the device's kernels inside the measured step's range
    on the device's timeline: a trace that drops kernels at its head (as
    some late in a long run have) drops the lead step's, not these."""
    gen.step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _warm_trace()
        with torch.profiler.record_function("lead_step"):
            gen.step()
        t0 = time.perf_counter()
        with torch.profiler.record_function("traced_step"):
            gen.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = {e.name: e.time_range for e in on_device
             if e.is_user_annotation and e.name in ("lead_step", "traced_step")}
    kernels, lead_calls = {}, 0
    for e in on_device:
        if e.is_user_annotation or "spin_kernel" in e.name:
            continue
        start = e.time_range.start
        if "lead_step" in spans and spans["lead_step"].start <= start <= spans["lead_step"].end:
            lead_calls += 1
        if "traced_step" in spans and spans["traced_step"].start <= start <= spans["traced_step"].end:
            k = kernels.setdefault(e.name[:100], {"ms": 0.0, "calls": 0})
            k["ms"] += e.time_range.elapsed_us() / 1e3
            k["calls"] += 1
    by_kind = {kind: {"ms": 0.0, "calls": 0} for kind in (*TRAIN_KINDS, "elementwise and other")}
    for key, k in kernels.items():
        kind = next((n for n, marks in TRAIN_KINDS.items()
                     if any(m in key for m in marks)), "elementwise and other")
        by_kind[kind]["ms"] += k["ms"]
        by_kind[kind]["calls"] += k["calls"]
    busy_ms = sum(k["ms"] for k in kernels.values())
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_calls": sum(k["calls"] for k in kernels.values()),
        "lead_step_calls": lead_calls,
        "spin_kernels_seen": sum("spin_kernel" in e.name for e in on_device),
        "by_kind": by_kind,
        "draw_calls": sum(k["calls"] for key, k in kernels.items() if "distribution" in key),
        "top_kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16]),
    }


def phase_train_profile(gen: TrainLoadGen, attempts: int = 2) -> dict:
    """One step at the shipped sizes under torch.profiler: the kernels it
    launched, device time by kind, and the device's idle share of the
    step's host wall time (profiled, so an upper bound).  The trace must
    hold the step's batch draw, its first two kernels, and four kernels for
    each BatchNorm layer; a trace short of them is traced again, up to
    ``attempts`` times, then fails."""
    n_bn = sum(isinstance(m, BatchNorm) for m in gen.model.modules())
    want = {"batchnorm": TRAIN_BN_KERNELS * n_bn, "draw": TRAIN_DRAW_KERNELS}
    for attempt in range(1, attempts + 1):
        row = _profile_train_step(gen)
        got = {"batchnorm": row["by_kind"]["batchnorm"]["calls"], "draw": row["draw_calls"]}
        if got == want:
            break
    out = {"phase": "train_profile", "batch": TRAIN_BATCH, "attempts": attempt,
           "batchnorm_layers": n_bn, "expected": want, **row}
    emit(out)
    if got != want:
        raise AssertionError(f"the trace lost kernels: it holds {got}, not {want}")
    return out


def phase_train_loop(gen: TrainLoadGen) -> dict:
    """The training loop, as bench.py's training rung runs it: TrainLoad at
    0.15 then 1.0 → TorchDeviceSource (the windowed duty cycle; no bandwidth
    gauge, none is measured on the card) → ExporterDaemon over HTTP →
    Scraper → both tpu-train rules → adapter → the shipped two-metric HPA
    must scale 1 → 4 within the 60 s budget on the duty cycle alone."""
    t0 = time.perf_counter()
    steps0 = gen.stats().steps
    result = run_train_trial(gen)
    out = {
        "phase": "train_loop", "hpa_metrics": [TRAIN_DUTY_SERIES, TRAIN_BW_SERIES],
        "time_scale": 1.0, "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": time.perf_counter() - t0,
        "steps": gen.stats().steps - steps0,
        "bw_gauge": "absent: no source on the card measures it",
        "replicas": [list(r) for r in result.replicas],
        "metrics_at_sync": [[round(t, 2), m] for t, m in result.metrics],
        "series": [[round(t, 2), duty, bw] for t, duty, bw in result.series],
    }
    emit(out)
    if any(m[TRAIN_BW_SERIES] is not None for _, m in result.metrics):
        raise AssertionError("the HPA had a bandwidth series no source serves")
    if not all(m[TRAIN_DUTY_SERIES] is not None for _, m in result.metrics):
        raise AssertionError(f"the HPA lacked the duty cycle at a sync: {result.metrics}")
    return out


class _Entry:
    """A container command run as a subprocess from the repository root,
    its output gathered by a thread."""

    def __init__(self, module: str, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module], cwd=Path(__file__).resolve().parent, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines: list[str] = []
        self._reader = threading.Thread(
            target=lambda: self.lines.extend(ln.rstrip() for ln in self.proc.stdout))
        self._reader.start()

    def wait_for(self, prefix: str, seconds: float = 180) -> str:
        deadline = time.monotonic() + seconds
        while True:
            found = [ln for ln in self.lines if ln.startswith(prefix)]
            if found:
                return found[-1]
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"no line {prefix!r}: {self.lines[-20:]}")
            time.sleep(0.2)

    def stop(self) -> int:
        """SIGTERM, then its exit code."""
        try:
            self.proc.send_signal(signal.SIGTERM)
            return self.proc.wait(timeout=60)
        finally:
            self.proc.kill()
            self._reader.join(timeout=10)


def _saved_step(entry: _Entry, ckpt_dir: str) -> int:
    """The step of the newest save a SIGTERM'd entry point left: its final
    save's, or a periodic one's where the last step had just been saved."""
    steps = make_checkpoint_manager(ckpt_dir).all_steps()
    final = [ln for ln in entry.lines if ln.startswith("final checkpoint at step ")]
    if not steps or (final and int(final[-1].rsplit(" ", 1)[1]) != steps[-1]):
        raise AssertionError(f"the saves {steps} do not end at the final one: {final}")
    return steps[-1]


def _resume(module: str, env: dict, ckpt_dir: str, first: _Entry) -> dict:
    """Restart a SIGTERM'd entry point on its checkpoint directory: it must
    resume from the step of its last save, step on and exit 0 on SIGTERM."""
    saved = _saved_step(first, ckpt_dir)
    entry = _Entry(module, env)
    try:
        resumed = entry.wait_for("resumed from step ")
        report = entry.wait_for("steps=")
    finally:
        code = entry.stop()
    steps = int(dict(f.split("=", 1) for f in report.split())["steps"])
    out = {"saved_step": saved, "resumed": resumed, "report_after": report, "exit_code": code}
    if resumed != f"resumed from step {saved} in {ckpt_dir}" or steps <= saved or code != 0:
        raise AssertionError(f"the restart did not resume from the last save: {out}")
    return out


def phase_train_entry(work_dir: str, seconds: float = 8.0) -> dict:
    """The tpu-train container command, ``python -m
    k8s_gpu_hpa_tpu_torch.loadgen.train`` at its defaults (ResNet-50,
    batch 256, image 32), with CHECKPOINT_DIR, CHECKPOINT_EVERY 20 and a
    1 s PROFILE_S: it trains and reports, writes its Chrome trace, saves on
    SIGTERM and exits 0; started again it resumes from that save's step."""
    ckpt_dir = str(Path(work_dir) / "train-ckpt")
    profile_dir = Path(work_dir) / "train-profile"
    env = dict(os.environ, REPORT_S="2", CHECKPOINT_DIR=ckpt_dir, CHECKPOINT_EVERY="20",
               PROFILE_S="1", PROFILE_DIR=str(profile_dir),
               TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    module = "k8s_gpu_hpa_tpu_torch.loadgen.train"
    first = _Entry(module, env)
    try:
        banner = first.wait_for("tpu-train loadgen")
        first.wait_for("profiling: trace written")
        time.sleep(seconds)
        report = first.wait_for("steps=")
    finally:
        code = first.stop()
    traces = sorted(p.name for p in profile_dir.glob("*.json"))
    out = {"phase": "train_entry", "exit_code": code, "banner": banner, "report": report,
           "final": [ln for ln in first.lines if ln.startswith("final checkpoint")],
           "traces": traces, "trace_bytes": sum(p.stat().st_size for p in profile_dir.glob("*.json"))}
    if code != 0 or traces != [f"trace-{first.proc.pid}.json"]:
        emit(out)
        raise AssertionError(f"the train entry point did not run as expected: {first.lines[-20:]}")
    out["restart"] = _resume(module, env, ckpt_dir, first)
    emit(out)
    loss = float(dict(f.split("=", 1) for f in report.split())["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"the train entry point's loss went non-finite: {report}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    device = phase_device()
    peaks = device["peak_bf16_tflops"], device["peak_hbm_gbps"]
    phase_build()
    max_err = phase_parity()
    timing = phase_timing(*peaks)
    with tempfile.TemporaryDirectory() as knob_dir:
        gen = phase_loadgen(knob_dir)
        phase_profile(gen)
        launches = phase_loop(gen)
        attribution = phase_nvml(gen)
        launches += phase_node_loop(gen, attribution)
    del gen
    flash_err = phase_flash_parity()
    flash_timing = phase_flash_timing(*peaks)
    serve = DecodeLoadGen(**SERVE_SIZES, window=3.0, device="cuda:0")
    serve.warmup()
    phase_serve_parity(serve)
    phase_serve_loadgen(serve)
    phase_serve_profile(serve)
    flash_launches = phase_serve_loop(serve)
    del serve
    bwd_err = phase_flash_bwd_parity()
    bwd_timing = phase_flash_bwd_timing(*peaks)
    gens, parity_counts = phase_llm_parity()
    train_counts = phase_llm_train(gens)
    phase_llm_profile(gens["auto"])
    del gens
    phase_train_parity()
    train_gen, _ = phase_train_loadgen()
    phase_train_profile(train_gen)
    phase_train_loop(train_gen)
    del train_gen
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        phase_train_entry(work_dir)
        phase_llm_entry(work_dir)
    train = {n: parity_counts[n] + train_counts[n] for n in parity_counts}
    path = flash_timing[0]  # the serve prefill's shape
    llm = bwd_timing[0]  # the llm training shape
    emit({"kernels": [
        {
            "name": "matmul_bf16", "route": "cuda",
            "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/matmul.cu",
            "replaces": "k8s_gpu_hpa_tpu/ops/pallas_matmul.py:56",
            "launches": launches, "max_abs_err": max_err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
        },
        {
            "name": "flash_attention_fwd_bf16", "route": "cuda",
            "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "k8s_gpu_hpa_tpu/ops/flash_attention.py:59",
            # the serve loop's launches and the training path's
            "launches": flash_launches + train["fwd"], "max_abs_err": flash_err,
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
            # the same at each timed shape: the serve prefill (above), the
            # llm training shape with the logsumexp, the long one
            "shapes": [
                {key: row[key] for key in ("bshd", "with_lse", "kv_split", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms")}
                for row in flash_timing
            ],
        },
        *(
            {
                "name": f"flash_attention_bwd_{name}_bf16", "route": "cuda",
                "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": f"k8s_gpu_hpa_tpu/ops/flash_attention.py:{line}",
                "launches": train[name], "max_abs_err": bwd_err[name],
                "ms": llm[name]["ms"], "plain_ms": llm[name]["plain_ms"],
                "bound_ms": llm[name]["bound_ms"], "bound_by": llm[name]["bound_by"],
                # SDPA's backward computes dQ, dK and dV in one call: its
                # time times this kernel's share of the pair's operations
                "library_ms": llm[name]["library_ms"],
                "library": "SDPA backward x {:.4f} of the pair's operations; whole call {} ms"
                           " against dQ + dK/dV {} ms".format(
                               llm[name]["library_share"], llm["pair"]["library_ms"],
                               llm["pair"]["ms"]),
            }
            for name, line in (("dq", 165), ("dkv", 207))
        ),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
