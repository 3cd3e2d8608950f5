#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's closed autoscaling loop once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and g++:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device   — the card's name and power limit as nvidia-smi reports them.
2. build    — nvcc builds the GEMM from k8s_gpu_hpa_tpu_torch/ops/csrc/matmul.cu
              and g++ the exporter core from cpp/exporter, both at once.
3. parity   — the kernel against its plain PyTorch version at four shapes;
              an f32 or unaligned operand must raise.
4. timing   — the kernel at 4096^3 beside its bound, the plain version and
              torch.matmul (a yardstick the port never calls).
5. loadgen  — MatmulLoadGen on the kernel tracks the commanded duty cycle,
              and launches the kernel once per product.
6. profile  — one full-length burst under torch.profiler: device time by
              kernel and the device's idle share.
7. loop     — loadgen → TorchDeviceSource → ExporterDaemon over HTTP →
              Scraper → tpu-test rules → adapter → HPA must scale 1 → 4 within
              the 60 s budget.  The HPA reads tpu_test_duty_cycle_avg (see
              the phase's note).

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

from k8s_gpu_hpa_tpu_torch.device import peak_hbm_gbps_for, peak_tflops_for
from k8s_gpu_hpa_tpu_torch.exporter import native
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen
from k8s_gpu_hpa_tpu_torch.ops import matmul
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul_kernel, matmul_reference
from k8s_gpu_hpa_tpu_torch.trial import DUTY_SERIES, run_headline_trial

# M, K, N: the loadgen's shape, the JAX parity test's, a shape the JAX
# package would run on its k-grid kernel, and a shallow wide one
PARITY_SHAPES = [(4096, 4096, 4096), (256, 384, 128), (1024, 8192, 2048), (512, 128, 1024)]
# bf16 output: each side rounds its fp32 sum to bf16 once, so two results can
# differ by one bf16 ulp (2^-7 relative at worst) and by the fp32 sums'
# different summation order; rtol 2^-6 allows two ulps, atol the order.
RTOL = 2.0**-6
ATOL = 1e-2
SIZE = 4096


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

    with ThreadPoolExecutor(2) as pool:
        kernel = pool.submit(timed, matmul.build)
        exporter = pool.submit(timed, native.build_native)
        (_, ptxas), kernel_s = kernel.result()
        _, exporter_s = exporter.result()
    emit({
        "phase": "build", "matmul_cu_s": round(kernel_s, 3),
        "exporter_cc_s": round(exporter_s, 3),
        "ptxas": [ln.strip() for ln in ptxas.splitlines() if "ptxas info" in ln],
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    device = phase_device()
    phase_build()
    max_err = phase_parity()
    timing = phase_timing(device["peak_bf16_tflops"], device["peak_hbm_gbps"])
    with tempfile.TemporaryDirectory() as knob_dir:
        gen = phase_loadgen(knob_dir)
        phase_profile(gen)
        launches = phase_loop(gen)
    emit({"kernels": [{
        "name": "matmul_bf16", "route": "cuda",
        "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/matmul.cu",
        "replaces": "k8s_gpu_hpa_tpu/ops/pallas_matmul.py:56",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
