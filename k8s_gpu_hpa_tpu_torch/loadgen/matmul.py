"""Single-GPU load generator: a matmul busy-loop with a duty-cycle knob.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/matmul.py``, and like it the analog
of the reference workload — a CUDA vectorAdd busy-loop whose only "knob" is
running more loop iterations via ``kubectl exec``
(cuda-test-deployment.yaml:19, README.md:113-116).  Intensity is a duty cycle
in [0,1] settable at runtime three ways (API, env var at start, or a watched
file: ``echo 0.9 > /tmp/tpu-test-intensity``), and the generator
*self-reports* its achieved utilization and TFLOP/s, which is what feeds
``TorchDeviceSource``.

Details: bf16 operands, fp32 accumulation, a burst of ``n`` chained products
with one host sync at its end (a 4-byte readback), static shapes, and the
hand-written Hopper GEMM (ops/matmul.py) as the opt-in hot op.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from k8s_gpu_hpa_tpu_torch.device import (  # noqa: F401  (re-exported names)
    PEAK_BF16_TFLOPS,
    PEAK_HBM_GBPS,
    local_devices,
    peak_hbm_gbps_for,
    peak_tflops_for,
    resolve,
)
from k8s_gpu_hpa_tpu_torch.loadgen.knob import (  # noqa: F401  (re-exported names)
    DEFAULT_INTENSITY_FILE,
    INTENSITY_ENV,
    INTENSITY_FILE_ENV,
    IntensityKnob,
)
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul_kernel


@dataclass
class LoadGenStats:
    utilization: float  # achieved duty-cycle percent over the last window
    achieved_tflops: float  # compute rate over busy time (kernel efficiency)
    sustained_tflops: float  # compute rate over WALL time (includes idle)
    steps: int
    busy_seconds: float
    wall_seconds: float
    #: True when the achieved-TFLOPs estimate is unreliable: the per-burst
    #: 10%-floor guard dominated (bursts near the RTT estimate) or the raw
    #: rate exceeded device peak and was capped.  For a trustworthy kernel
    #: rate use ``MatmulLoadGen.measure_dwell_tflops`` instead.
    floor_clamped: bool = False


class MatmulLoadGen:
    """Busy-loop generator.  ``step()`` runs one burst then sleeps to match the
    target duty cycle; ``stats()`` reports utilization over a sliding window.

    ``device`` is CUDA unless the caller passes ``device="cpu"``.  On a host
    with several GPUs and no pinned device, each GPU runs its own product
    chain, with no collectives."""

    def __init__(
        self,
        size: int = 4096,
        iters_per_burst: int | None = None,
        intensity: float | None = None,
        dtype: torch.dtype = torch.bfloat16,
        use_kernel: bool = False,
        device: str | torch.device | None = None,
        window: float = 10.0,
        all_devices: bool | None = None,
    ):
        self.size = size
        if all_devices is None:
            all_devices = device is None
        self._devices = local_devices(device) if all_devices else [resolve(device)]
        self.n_devices = len(self._devices)
        self.device = self._devices[0]
        if iters_per_burst is None:
            # On a GPU make bursts long enough to dominate launch and
            # readback overhead; on the CPU keep tests fast.
            iters_per_burst = 256 if self.device.type == "cuda" else 4
        self.iters_per_burst = iters_per_burst
        self.dtype = dtype
        self.window = window
        self.knob = IntensityKnob(intensity)
        self.peak_tflops = peak_tflops_for(self.device)
        # Default hot op: torch.matmul, as the JAX generator defaults to
        # XLA's dot.  use_kernel calls the hand-written kernel directly: an
        # unaligned size or a dtype it does not take raises, nothing falls
        # back.
        self._op = matmul_kernel if use_kernel else torch.matmul
        gen = torch.Generator().manual_seed(0)
        a = [torch.randn(size, size, generator=gen) for _ in self._devices]
        b = torch.randn(size, size, generator=gen)
        self._set(a, b)
        self._rtt = 0.0  # measured dispatch+readback floor, set by warmup()
        self._history: list[tuple[float, float, float]] = []  # (t, busy, flops)
        # step() runs in the workload's thread while the exporter's thread
        # reads stats(): both go through this lock
        self._hist_lock = threading.Lock()
        self._steps = 0

    def _set(self, a: list[torch.Tensor], b: torch.Tensor) -> None:
        self._a = [x.to(self.dtype).to(d) for x, d in zip(a, self._devices)]
        self._b = [b.to(self.dtype).to(d) for d in self._devices]
        # 1/sqrt(size) in f32, cast to the operand dtype before the multiply
        scale = (1.0 / torch.sqrt(torch.tensor(float(self.size)))).to(self.dtype)
        self._scale = [scale.to(d) for d in self._devices]

    def set_operands(self, a: np.ndarray, b: np.ndarray) -> None:
        """Replace the operands (the generator's "weights") with given
        arrays, so that a test can hand the JAX generator's operands to both.
        ``a`` is [size, size] (every device gets it) or one matrix per device
        stacked as [n_devices, size, size]."""
        a = torch.from_numpy(np.asarray(a, dtype=np.float32))
        per_device = list(a) if a.ndim == 3 else [a] * self.n_devices
        if len(per_device) != self.n_devices:
            raise ValueError(f"{len(per_device)} operands for {self.n_devices} devices")
        self._set(per_device, torch.from_numpy(np.asarray(b, dtype=np.float32)))

    def _burst(self, n: int) -> float:
        # Chain products so the device stays busy for the whole burst without
        # a host round-trip per product; the renorm keeps values from
        # overflowing bf16.  The return value is a scalar probe: fetching it
        # forces completion and transfers 4 bytes, not the matrix.  step()
        # shortens bursts at low intensity so the duty cycle stays smooth.
        xs = list(self._a)
        for _ in range(n):
            for d in range(self.n_devices):
                y = self._op(xs[d], self._b[d])
                xs[d] = y.mul_(self._scale[d])  # in place: y is fresh
        probes = [x[0, 0].float().item() for x in xs]
        return probes[0]

    # ---- intensity knob (shared semantics: loadgen/knob.py) ----------------

    @property
    def intensity(self) -> float:
        return self.knob.value

    def set_intensity(self, value: float) -> None:
        self.knob.set(value)

    @property
    def intensity_file(self) -> str:
        return self.knob.file

    @intensity_file.setter
    def intensity_file(self, path: str) -> None:
        self.knob.file = path

    def poll_intensity_file(self) -> None:
        """The kubectl-exec knob: read a float duty cycle from the watched file
        (analog of rerunning the vectorAdd loop inside the pod,
        README.md:113-116)."""
        self.knob.poll()

    # ---- run loop ----------------------------------------------------------

    def warmup(self) -> None:
        # first run (builds and loads the kernel when use_kernel is set)
        self._burst(self.iters_per_burst)
        # calibrate the dispatch/readback floor so achieved-FLOPs numbers can
        # exclude it
        tiny = self._a[0]
        (tiny * 2)[0, 0].item()
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            (tiny * 2)[0, 0].item()
            samples.append(time.perf_counter() - t0)
        samples.sort()
        self._rtt = samples[len(samples) // 2]

    def burst_iters(self, intensity: float) -> int:
        """Products in one burst at ``intensity``.  Intensity-scaled: keep the
        busy/idle CYCLE short (about one full-length burst) so the windowed
        duty reading is smooth at any intensity — a full burst at 0.05 would
        idle ~19 burst lengths per cycle, longer than the reporting window."""
        if intensity >= 1.0:
            return self.iters_per_burst
        return max(1, round(self.iters_per_burst * intensity))

    def step(self) -> float:
        """One burst + duty-cycle sleep; returns busy seconds."""
        intensity = self.knob.poll()
        if intensity <= 0.0:
            self.knob.throttle(0.0)  # idle-poll, don't spin
            self._record(0.0, 0.0)
            return 0.0
        n_iters = self.burst_iters(intensity)
        t0 = time.perf_counter()
        self._burst(n_iters)  # scalar fetch forces completion
        busy = time.perf_counter() - t0
        flops = 2.0 * self.size**3 * n_iters * self.n_devices
        self._record(busy, flops)
        self._steps += 1
        self.knob.throttle(busy)  # duty cycle: busy/(busy+idle) = intensity
        return busy

    def measure_dwell_tflops(self, iters: int | None = None) -> float:
        """Honest MFU numerator: one long uninterrupted on-device chain of
        ``iters`` products, wall-clock timed end to end — no RTT subtraction,
        no clamp, nothing estimated.  The single readback amortizes to noise
        over a dwell of seconds, so the returned TFLOP/s is a lower bound on
        kernel throughput and can never exceed peak."""
        if iters is None:
            iters = 2000 if self.device.type == "cuda" else 8
        self._burst(iters)
        t0 = time.perf_counter()
        self._burst(iters)
        wall = time.perf_counter() - t0
        return 2.0 * self.size**3 * iters * self.n_devices / wall / 1e12

    def run_for(self, seconds: float) -> LoadGenStats:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self.step()
        return self.stats()

    def _record(self, busy: float, flops: float) -> None:
        now = time.perf_counter()
        with self._hist_lock:
            self._history.append((now, busy, flops))
            cutoff = now - self.window
            while self._history and self._history[0][0] < cutoff:
                self._history.pop(0)

    # ---- self-reporting ----------------------------------------------------

    def stats(self) -> LoadGenStats:
        with self._hist_lock:
            history = list(self._history)
        if not history:
            return LoadGenStats(0.0, 0.0, 0.0, self._steps, 0.0, 0.0)
        busy = sum(b for _, b, _ in history)
        flops = sum(f for _, _, f in history)
        t_first = history[0][0]
        wall = max(time.perf_counter() - t_first, 1e-9)
        # exclude the calibrated dispatch/readback floor from compute-rate
        # accounting (it still counts toward duty-cycle utilization, which is
        # about load patterns, not kernel efficiency).  Per-burst floor: a
        # short low-intensity burst can be smaller than the RTT estimate's
        # jitter, and subtracting the full RTT from it would divide by ~zero
        # and report an absurd rate — keep at least 10% of each burst's
        # measured time as compute.
        bursts = [b for _, b, _ in history if b > 0]
        compute = max(sum(max(b - self._rtt, 0.1 * b) for b in bursts), 1e-9)
        # the 0.1*b floor branch dominating means the RTT estimate is of the
        # same order as the bursts themselves — the subtraction is then noise
        # amplification, not calibration
        floor_dominated = (
            bool(bursts)
            and sum(1 for b in bursts if b - self._rtt < 0.1 * b) > len(bursts) / 2
        )
        achieved = (flops / compute / 1e12) if flops > 0 else 0.0
        capped = False
        if self.peak_tflops is not None:
            device_peak = self.peak_tflops * self.n_devices
            if achieved > device_peak:
                # a busy-time rate above physical peak is an artifact of the
                # RTT over-correction; never report >100% of the devices
                achieved = device_peak
                capped = True
        return LoadGenStats(
            utilization=min(100.0, 100.0 * busy / wall),
            achieved_tflops=achieved,
            sustained_tflops=flops / wall / 1e12,
            steps=self._steps,
            busy_seconds=busy,
            wall_seconds=wall,
            floor_clamped=floor_dominated or capped,
        )

    def utilization(self, _chip_index: int = 0) -> float:
        """Duty-cycle utilization percent — the ``util_fn`` for TorchDeviceSource."""
        return self.stats().utilization

    def mxu_utilization(self, _chip_index: int = 0) -> float | None:
        """Tensor-core utilization percent: FLOPs over WALL time divided by
        peak (the name keeps the JAX package's).

        Time-averaged by definition — a 20 % duty cycle at full kernel
        efficiency reads ~19 %, and a memory-bound workload reads near 0 even
        while 100 % busy."""
        if self.peak_tflops is None:
            return None
        return min(100.0, 100.0 * self.stats().sustained_tflops / self.peak_tflops)


def main(device: str | torch.device | None = None) -> None:
    """``python -m k8s_gpu_hpa_tpu_torch.loadgen.matmul`` — the tpu-test
    container command.

    Env: MATMUL_SIZE, TPU_TEST_INTENSITY (initial duty cycle),
    TPU_TEST_INTENSITY_FILE (runtime knob), REPORT_S (stats print period),
    PROFILE_S and PROFILE_DIR (one trace window, utils/profiling.py).
    ``device`` is CUDA unless the caller passes ``"cpu"``.
    """
    from k8s_gpu_hpa_tpu_torch.device import device_name
    from k8s_gpu_hpa_tpu_torch.loadgen.telemetry import TelemetryWriter
    from k8s_gpu_hpa_tpu_torch.utils.profiling import ProfileWindow

    profile = ProfileWindow()

    size = int(os.environ.get("MATMUL_SIZE", "4096"))
    report_every = float(os.environ.get("REPORT_S", "10"))
    gen = MatmulLoadGen(size=size, device=device)
    gen.warmup()
    telemetry = TelemetryWriter()
    print(
        f"tpu-test loadgen: {size}x{size} bf16 matmul bursts on "
        f"{device_name(gen.device)} x{gen.n_devices}, intensity={gen.intensity} "
        f"(knob: {gen.intensity_file}"
        + (f", telemetry: {telemetry.path}" if telemetry.enabled else "")
        + ")",
        flush=True,
    )
    last_report = time.perf_counter()
    while True:
        profile.poll()
        gen.step()
        s = gen.stats()
        # self-report the gauges only the workload can measure: duty cycle
        # (busy fraction) and the genuine tensor-core rate — distinct numbers
        # with distinct meanings (metrics/schema.py's table)
        telemetry.write(
            tensorcore_util_pct=gen.mxu_utilization(),
            duty_cycle_pct=s.utilization,
            achieved_tflops=s.achieved_tflops,
        )
        if time.perf_counter() - last_report >= report_every:
            mxu = gen.mxu_utilization()
            print(
                f"util={s.utilization:.1f}% achieved={s.achieved_tflops:.1f}TFLOP/s"
                + (" (floor-clamped)" if s.floor_clamped else "")
                + (f" mxu={mxu:.1f}%" if mxu is not None else "")
                + f" steps={s.steps}",
                flush=True,
            )
            last_report = time.perf_counter()


if __name__ == "__main__":
    main()
