#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two closed autoscaling loops once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and g++:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device        — the card's name and power limit as nvidia-smi reports them.
2. build         — nvcc builds the GEMM (ops/csrc/matmul.cu) and the flash
                   attention forward (ops/csrc/flash_attention.cu), g++ the
                   exporter core from cpp/exporter, all three at once.
3. parity        — the GEMM against its plain PyTorch version at four shapes;
                   an f32 or unaligned operand must raise.
4. timing        — the GEMM at 4096^3 beside its bound, the plain version and
                   torch.matmul (a yardstick the port never calls).
5. loadgen       — MatmulLoadGen on the GEMM tracks the commanded duty cycle,
                   and launches the kernel once per product.
6. profile       — one full-length matmul burst under torch.profiler: device
                   time by kernel and the device's idle share.
7. loop          — the headline loop: loadgen → TorchDeviceSource →
                   ExporterDaemon over HTTP → Scraper → tpu-test rules →
                   adapter → HPA must scale 1 → 4 within the 60 s budget.  The
                   HPA reads tpu_test_duty_cycle_avg (see the phase's note).
8. flash_parity  — the flash kernel against its plain version at the serve
                   prefill's shape (causal and not, with the logsumexp), a
                   ragged causal shape whose Q and KV tiles differ, and head
                   dim 64; off-envelope operands must raise.
9. flash_timing  — the flash kernel at the prefill's shape and at a long one,
                   beside its bound, the plain version and
                   scaled_dot_product_attention (a yardstick the port never
                   calls).
10. serve_parity — at the shipped serve sizes in bf16: prefill against
                   stepwise decode, and the CUDA-graph burst against the same
                   burst run eagerly, bit for bit.
11. serve_loadgen— DecodeLoadGen at the shipped sizes: burst times (graph and
                   eager), token rates, bandwidth and the saturated signal's
                   headroom over the serve target.
12. serve_profile— one graph burst under torch.profiler: device time by
                   kernel, the flash kernel once per layer, the idle share.
13. serve_loop   — the serve loop: DecodeLoadGen → TorchDeviceSource →
                   ExporterDaemon → Scraper → tpu-serve rule → adapter → the
                   shipped serve HPA must scale 1 → 4 on tpu_serve_hbm_bw_avg
                   within the 60 s budget.

Launch counts.  Each wrapper counts the launches it makes.  A decode burst
is one replay of a CUDA graph, and the graph's launches happen without the
wrapper: the flash wrapper counts them once, when the burst is captured
(``DecodeLoadGen.flash_launches_per_burst``).  So the serve loop's flash
launches are the wrapper's count in that run plus the replays in that run
times the launches one replay makes.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
Nothing falls back to the CPU: without a GPU the script exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import torch.nn.functional as F

from k8s_gpu_hpa_tpu_torch.device import peak_hbm_gbps_for, peak_tflops_for
from k8s_gpu_hpa_tpu_torch.exporter import native
from k8s_gpu_hpa_tpu_torch.loadgen.decode import SERVE_SIZES, DecodeLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen
from k8s_gpu_hpa_tpu_torch.metrics.rules import SERVE_BW_TARGET
from k8s_gpu_hpa_tpu_torch.models import transformer
from k8s_gpu_hpa_tpu_torch.ops import flash_attention, matmul
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import (
    flash_attention_kernel,
    flash_attention_reference,
)
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul_kernel, matmul_reference
from k8s_gpu_hpa_tpu_torch.trial import (
    DUTY_SERIES,
    SERVE_SERIES,
    measure_saturated_signal,
    run_headline_trial,
    run_serve_trial,
)

# M, K, N: the loadgen's shape, the JAX parity test's, a shape the JAX
# package would run on its k-grid kernel, and a shallow wide one
PARITY_SHAPES = [(4096, 4096, 4096), (256, 384, 128), (1024, 8192, 2048), (512, 128, 1024)]
# bf16 output: each side rounds its fp32 sum to bf16 once, so two results can
# differ by one bf16 ulp (2^-7 relative at worst) and by the fp32 sums'
# different summation order; rtol 2^-6 allows two ulps, atol the order.
RTOL = 2.0**-6
ATOL = 1e-2
SIZE = 4096

# (batch, seq, heads, head_dim, causal, with_lse): the serve prefill's shape
# causal and not, with the logsumexp; seq 192 cuts two Q tiles of 128 (the
# second ragged) against three KV tiles of 64, so the causal loop bound
# min(n_kv, ceil((i+1)*128/64)) clips; and head_dim 64
FLASH_SHAPES = [
    (8, 512, 4, 128, True, False),
    (8, 512, 4, 128, False, False),
    (8, 512, 4, 128, True, True),
    (2, 192, 3, 128, True, True),
    (2, 256, 2, 64, True, False),
]
# bf16 output, each side rounding P to bf16 once per KV tile it sums: the
# kernel per 64-key tile against its running max, the plain version once
# against the row's max, so a term can differ by one bf16 ulp of P; then the
# output rounds once on each side.  0.02 absolute allows about two ulps at
# the outputs' magnitude (|o| < 2 for these inputs) and is under the JAX
# package's bf16 bar of 0.06.  The logsumexp is fp32 on both sides: 1e-4.
FLASH_ATOL = 0.02
LSE_ATOL = 1e-4
# the prefill's shape and a long causal one, for timing
FLASH_TIMED = [(8, 512, 4, 128), (2, 4096, 8, 128)]
# serve parity at the shipped sizes in bf16: prefill against stepwise decode
# reach the cache and the logits through other products (a [b, 512, d] GEMM
# and the flash kernel against [b, 1, d] GEMMs and the decode's products), so
# bf16 roundings land elsewhere and carry through four layers; the JAX
# package's bf16 attention bar, 0.06, holds the logits, and the cache is held
# to 0.06 plus four bf16 ulps of its value
SERVE_ATOL = 0.06
SERVE_CACHE_RTOL = 2.0**-5


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

    with ThreadPoolExecutor(3) as pool:
        kernel = pool.submit(timed, matmul.build)
        flash = pool.submit(timed, flash_attention.build)
        exporter = pool.submit(timed, native.build_native)
        (_, ptxas), kernel_s = kernel.result()
        (_, flash_ptxas), flash_s = flash.result()
        _, exporter_s = exporter.result()
    emit({
        "phase": "build", "matmul_cu_s": round(kernel_s, 3),
        "flash_attention_cu_s": round(flash_s, 3),
        "exporter_cc_s": round(exporter_s, 3),
        "ptxas": [ln.strip() for ln in ptxas.splitlines() if "ptxas info" in ln],
        "flash_ptxas": [ln.strip() for ln in flash_ptxas.splitlines() if "ptxas info" in ln],
    })


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
    out = {
        "phase": "timing", "mkn": [SIZE, SIZE, SIZE],
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
    emit({"phase": "loadgen", "size": SIZE, "iters_per_burst": gen.iters_per_burst,
          "runs": rows, "probe": probe, "dwell_tflops": dwell,
          "dwell_mfu_pct": 100.0 * dwell / gen.peak_tflops})
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
        t0 = time.perf_counter()
        gen._burst(gen.iters_per_burst)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.self_device_time_total > 0:
            kernels[event.key[:80]] = {
                "ms": event.self_device_time_total / 1e3, "calls": event.count,
            }
    busy_ms = sum(k["ms"] for k in kernels.values())
    out = {
        "phase": "profile", "products": gen.iters_per_burst, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels": kernels,
    }
    emit(out)
    return out


def phase_loop(gen) -> int:
    """The headline loop on the kernel.  The HPA reads the duty-cycle average:
    the tensor-core average is the kernel's MFU, and with the HPA's 10%
    tolerance band it scales up only above 44%, which a first, simple kernel
    need not reach; the duty cycle goes to 100% when commanded whatever the
    kernel's speed.  The tensor-core series is printed beside it."""
    matmul_kernel.launches = 0
    t0 = time.perf_counter()
    result = run_headline_trial(gen)
    wall = time.perf_counter() - t0
    launches = matmul_kernel.launches
    if launches <= 0:
        raise AssertionError("the closed loop launched the kernel no time")
    emit({
        "phase": "loop", "hpa_metric": DUTY_SERIES, "time_scale": 1.0,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": wall,
        "launches": launches,
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), tc, duty] for t, tc, duty in result.series],
    })
    return launches


def _qkv_views(b: int, s: int, h: int, d: int, gen: torch.Generator):
    """q, k, v as the prefill hands them to the kernel: [b, s, h, d] views of
    one fused [b, s, 3*h*d] projection."""
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    return tuple(t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def phase_flash_parity() -> float:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    rows = []
    for b, s, h, d, causal, with_lse in FLASH_SHAPES:
        q, k, v = _qkv_views(b, s, h, d, gen)
        got = flash_attention_kernel(q, k, v, causal, with_lse=with_lse)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v, causal, with_lse=with_lse)
        lse_err = None
        if with_lse:
            (got, got_lse), (want, want_lse) = got, want
            lse_err = float((got_lse - want_lse).abs().max())
        err = float((got.float() - want.float()).abs().max())
        row = {"bshd": [b, s, h, d], "causal": causal, "max_abs_err": err,
               "lse_max_abs_err": lse_err, "max_abs_out": float(want.float().abs().max())}
        rows.append(row)
        worst = max(worst, err)
        if (
            err > FLASH_ATOL
            or (lse_err is not None and lse_err > LSE_ATOL)
            or not bool(torch.isfinite(got.float()).all())
        ):
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
    emit({"phase": "flash_parity", "atol": FLASH_ATOL, "lse_atol": LSE_ATOL,
          "shapes": rows, "refused": refused})
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
    for b, s, h, d in FLASH_TIMED:
        q, k, v = (
            torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)
        )
        # scaled_dot_product_attention's layout, made before timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = flash_work(b, s, h, d, causal=True)
        ms_by_ops = flops / (peak_tflops * 1e12) * 1e3
        ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
        iters = 100 if s <= 1024 else 20

        def kernel_call():
            flash_attention_kernel(q, k, v, True)

        def library_call():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def plain_call():
            flash_attention_reference(q, k, v, True)

        # device time from graph replays, in turns: plain, kernel, library,
        # kernel, plain; and once the kernel in a host loop of launches
        plain = [graph_time_ms(plain_call, 4)]
        kernel = [graph_time_ms(kernel_call, iters)]
        library = graph_time_ms(library_call, iters)
        kernel.append(graph_time_ms(kernel_call, iters))
        plain.append(graph_time_ms(plain_call, 4))
        host_loop = cuda_time_ms(kernel_call, iters)
        row = {
            "bshd": [b, s, h, d], "causal": True,
            "ms": min(kernel), "ms_runs": kernel, "ms_host_launch_loop": host_loop,
            "tflops": flops / min(kernel) / 1e9,
            "plain_ms": min(plain), "plain_ms_runs": plain,
            "library_ms": library, "library": "F.scaled_dot_product_attention(is_causal=True)",
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


def phase_serve_profile(gen: DecodeLoadGen) -> dict:
    """One graph burst under torch.profiler: device time by kernel, and the
    device's idle share of the burst's host wall time (profiled, so an upper
    bound)."""
    gen.run_burst()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        gen.run_burst()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.self_device_time_total > 0:
            kernels[event.key[:100]] = {
                "ms": event.self_device_time_total / 1e3, "calls": event.count,
            }
    busy_ms = sum(k["ms"] for k in kernels.values())
    flash = {name: k for name, k in kernels.items() if "flash_fwd_kernel" in name}
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = {
        "phase": "serve_profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_names": len(kernels), "kernel_calls": sum(k["calls"] for k in kernels.values()),
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
    del gen
    flash_err = phase_flash_parity()
    flash_timing = phase_flash_timing(*peaks)
    serve = DecodeLoadGen(**SERVE_SIZES, window=3.0, device="cuda:0")
    serve.warmup()
    phase_serve_parity(serve)
    phase_serve_loadgen(serve)
    phase_serve_profile(serve)
    flash_launches = phase_serve_loop(serve)
    path = flash_timing[0]  # the serve prefill's shape
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
            "launches": flash_launches, "max_abs_err": flash_err,
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
