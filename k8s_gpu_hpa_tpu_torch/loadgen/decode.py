"""Serving load generator: prefill plus autoregressive KV-cache decode.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/decode.py``.  The inference-side
load profile: one token per step against the whole cache — small matmuls,
large sequential reads of device memory — so the device's signature is
memory *bandwidth*, not tensor-core occupancy.  That is the signal the serve
HPA (deploy/tpu-serve-hpa.yaml) scales on.

A burst is greedy decode kept on the device: the sampled token feeds the
next step with no host round-trip, ``tokens_per_burst`` steps, then one
host sync.  With ``prefill_len > 0`` each burst first admits a fresh request
batch: the prompt is scored in one causal pass (``models/transformer.py``
``prefill``, on the hand-written flash-attention kernel), then its
continuation is decoded.  On a GPU the burst is captured once, in
``warmup()``, as a ``torch.cuda.CUDAGraph`` on the generator's own stream,
and each burst is one replay of it — the counterpart of the JAX burst's one
``lax.fori_loop`` dispatch.  Eager PyTorch would launch some hundred small
kernels per token from the host and spend more time launching than the
device spends reading the cache.  On the CPU the burst runs eagerly.

Kernel launches inside the graph happen at every replay, but the wrapper's
``launches`` count moves only while the burst is captured:
``flash_launches_per_burst`` is that count, and ``replays`` counts the
replays, so a run's launches are their product.

Two self-reported signals feed the pipeline where device counters cannot:

- **achieved bandwidth** — each decode token-step reads the full static KV
  cache plus the weights, so bytes/s is known exactly; divided by the
  device's public peak (``device.peak_hbm_gbps_for``) it becomes the
  ``tpu_hbm_memory_bandwidth_utilization`` gauge.  None on the CPU.
- **queue depth** — a request queue sits in front of the worker, exported
  as ``tpu_test_queue_depth`` (``main()``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from k8s_gpu_hpa_tpu_torch.device import device_name, peak_hbm_gbps_for, resolve
from k8s_gpu_hpa_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    init_kv_cache,
    init_params,
    param_leaves,
    params_from_jax,
    prefill,
)
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import flash_attention_kernel


@dataclass
class DecodeStats:
    steps: int  # bursts
    tokens_generated: int
    tokens_per_sec: float
    cache_bytes: int
    seconds: float
    achieved_gbps: float  # bytes streamed / busy second
    hbm_bw_util_pct: float | None  # sustained/peak, None where no peak is known
    utilization_pct: float  # busy fraction of wall time (duty cycle)
    #: prompt tokens scored per busy second (0 unless prefill_len > 0).
    #: Prefill's bytes count in the bandwidth numerators (one weight read
    #: plus the cache writes for the prompt positions per burst); its
    #: activation traffic is not modeled, so the numbers are a lower bound.
    prefill_tokens_per_sec: float = 0.0


#: decode-chain length per burst on a GPU (launch amortization); the CPU
#: default is 4
TPU_TOKENS_PER_BURST = 128

#: the shipped serving deployment's sizes (deploy/tpu-serve-deployment.yaml's
#: env: DECODE_BATCH, MAX_SEQ, D_MODEL, N_HEADS, N_LAYERS, PREFILL_LEN), as
#: DecodeLoadGen keyword arguments; tests hold them to the manifest
SERVE_SIZES = {
    "batch": 8,
    "max_seq": 2048,
    "d_model": 512,
    "n_heads": 4,
    "n_layers": 4,
    "prefill_len": 512,
}


class RequestQueue:
    """Offered-load generator → queue → worker, in one process.

    Arrivals accumulate continuously (``offered_rps × dt``, fractional);
    the decode worker takes up to ``batch`` requests per burst.  ``depth`` is
    the demand signal the External HPA divides by replicas."""

    def __init__(self, max_depth: float = 1e6):
        self._depth = 0.0
        self.max_depth = max_depth
        self.offered_total = 0.0
        self.served_total = 0.0

    @property
    def depth(self) -> float:
        return self._depth

    def offer(self, requests: float) -> None:
        requests = max(0.0, requests)
        self.offered_total += requests
        self._depth = min(self.max_depth, self._depth + requests)

    def take(self, up_to: float) -> float:
        served = min(self._depth, max(0.0, up_to))
        self._depth -= served
        self.served_total += served
        return served


class DecodeLoadGen:
    """Busy-loop of greedy KV-cache decode bursts on one device.

    Windowed accounting (``window`` seconds): utilization and bandwidth are
    rates over the recent wall clock, so an idle worker decays to 0 instead
    of reporting its historical average — the serve HPA must see demand drop
    to scale in.  ``device`` is CUDA unless the caller passes ``"cpu"``.
    """

    def __init__(
        self,
        batch: int = 8,
        max_seq: int = 2048,
        d_model: int = 512,
        n_heads: int = 8,
        n_layers: int = 4,
        tokens_per_burst: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        window: float = 10.0,
        prefill_len: int = 0,
        model_parallelism: int = 1,
        device: str | torch.device | None = None,
    ):
        if model_parallelism > 1:
            raise NotImplementedError(
                "tensor-parallel serving (model_parallelism > 1) waits for the "
                "multi-device slice, ROADMAP item 10"
            )
        self.device = resolve(device)
        self.window = window
        self.prefill_len = prefill_len
        self.model_parallelism = model_parallelism
        self.cfg = TransformerConfig(
            d_model=d_model,
            n_heads=n_heads,
            n_layers=n_layers,
            d_ff=4 * d_model,
            max_seq=max_seq,
            dtype=dtype,
        )
        self.batch = batch
        if tokens_per_burst is None:
            tokens_per_burst = TPU_TOKENS_PER_BURST if self.device.type == "cuda" else 4
        self.tokens_per_burst = tokens_per_burst
        if prefill_len > 0 and prefill_len + tokens_per_burst >= max_seq:
            # ValueError, not assert: prefill_len arrives via PREFILL_LEN from
            # the pod env, and an out-of-range value must fail, not clamp
            raise ValueError(
                f"prefill_len {prefill_len} + tokens_per_burst "
                f"{tokens_per_burst} must stay inside max_seq {max_seq}"
            )
        dev = self.device
        self._params = init_params(self.cfg, torch.Generator().manual_seed(0), dev)
        self._cache = init_kv_cache(self.cfg, batch, dev)
        self._tokens = torch.zeros(batch, dtype=torch.long, device=dev)
        self._pos = torch.zeros((), dtype=torch.long, device=dev)
        self._prompt = None
        if prefill_len > 0:
            self._prompt = torch.randint(
                0, self.cfg.vocab, (batch, prefill_len),
                generator=torch.Generator().manual_seed(2),
            ).to(dev)
        #: the captured burst (GPU only) and the stream it was captured on
        self._graph: torch.cuda.CUDAGraph | None = None
        self._stream: torch.cuda.Stream | None = None
        #: flash-kernel launches one replay of the graph makes
        self.flash_launches_per_burst = 0
        self.replays = 0
        self._steps = 0
        self._busy = 0.0
        #: (t, busy_seconds) of recent bursts, pruned to the window.  The
        #: worker thread steps while the exporter's thread reads stats():
        #: every access holds _hist_lock.
        self._history: list[tuple[float, float]] = []
        self._hist_lock = threading.Lock()
        self._param_bytes = sum(t.numel() * t.element_size() for t in param_leaves(self._params))
        self.peak_hbm_gbps = peak_hbm_gbps_for(dev)

    # ---- state -------------------------------------------------------------

    def set_params(self, params_np: dict) -> None:
        """Replace the weights with a JAX parameter pytree of numpy arrays.
        The copy is in place: a captured graph keeps reading these tensors."""
        new = params_from_jax(params_np, self.cfg, self.device)
        for dst, src in zip(param_leaves(self._params), param_leaves(new), strict=True):
            dst.copy_(src)

    def set_prompt(self, prompt: np.ndarray) -> None:
        """Replace the prompt batch [batch, prefill_len] (in place)."""
        if self._prompt is None:
            raise ValueError("a decode-only generator (prefill_len 0) has no prompt")
        self._prompt.copy_(torch.from_numpy(np.asarray(prompt, dtype=np.int64)))

    def reset_state(self) -> None:
        """Zero the cache, the carried tokens and the position, in place."""
        for t in (*self._cache.values(), self._tokens, self._pos):
            t.zero_()

    def state(self) -> tuple[torch.Tensor, dict, int]:
        """(tokens, cache, pos) as they stand: the live tensors."""
        return self._tokens, self._cache, int(self._pos)

    # ---- the burst ---------------------------------------------------------

    def _burst_ops(self) -> None:
        """The burst's operations, in place on the generator's tensors: what
        runs eagerly on the CPU and what the GPU captures once."""
        cfg = self.cfg
        if self._prompt is not None:
            logits, _ = prefill(self._params, cfg, self._prompt, self._cache)
            self._tokens.copy_(logits.argmax(dim=-1))
            self._pos.fill_(self.prefill_len)
        for _ in range(self.tokens_per_burst):
            logits, _ = decode_step(self._params, cfg, self._tokens, self._cache, self._pos)
            self._tokens.copy_(logits.argmax(dim=-1))
            # wrap before max_seq so the burst never writes past the cache
            self._pos.add_(1).remainder_(cfg.max_seq - 1)

    def _capture(self) -> None:
        """Capture the burst as a CUDA graph on the generator's own stream,
        after one eager burst on that stream (lazy library and allocator
        set-up must not happen inside capture)."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._burst_ops()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = flash_attention_kernel.launches
        with torch.cuda.graph(graph, stream=stream):
            self._burst_ops()
        self.flash_launches_per_burst = flash_attention_kernel.launches - before
        self._graph, self._stream = graph, stream

    def run_burst(self, use_graph: bool = True) -> int:
        """One burst — a graph replay where one was captured and
        ``use_graph``, else the eager operations — then one host sync.
        Returns the first sequence's last token."""
        if use_graph and self._graph is not None:
            with torch.cuda.device(self.device):
                self._graph.replay()
            self.replays += 1
        else:
            self._burst_ops()
        return int(self._tokens[0])  # the one host sync

    def warmup(self) -> None:
        """First burst (builds and loads the kernel), then on a GPU the
        capture.  Accounting starts after both."""
        self.run_burst(use_graph=False)
        if self.device.type == "cuda":
            self._capture()
            self.run_burst()
        self._steps = 0
        self._busy = 0.0
        with self._hist_lock:
            self._history = []

    def _prune(self, now: float) -> None:
        cutoff = now - self.window
        while self._history and self._history[0][0] < cutoff:
            self._history.pop(0)

    def step(self) -> float:
        t0 = time.perf_counter()
        self.run_burst()
        now = time.perf_counter()
        dt = now - t0
        self._busy += dt
        self._steps += 1
        with self._hist_lock:
            self._history.append((now, dt))
            self._prune(now)
        return dt

    # ---- self-reporting ----------------------------------------------------

    def bytes_per_burst(self) -> int:
        """Bytes one burst must move: per decode token-step the whole static
        KV cache plus the weights; with prefill, one more weight read and the
        cache writes for the prompt positions."""
        cache_bytes = sum(t.numel() * t.element_size() for t in self._cache.values())
        total = self.tokens_per_burst * (cache_bytes + self._param_bytes)
        if self.prefill_len:
            total += self._param_bytes + cache_bytes * self.prefill_len // self.cfg.max_seq
        return total

    def stats(self) -> DecodeStats:
        tokens = self.batch * self.tokens_per_burst * self._steps
        cache_bytes = sum(t.numel() * t.element_size() for t in self._cache.values())
        now = time.perf_counter()
        with self._hist_lock:
            self._prune(now)
            win_busy = sum(b for _, b in self._history)
            win_bursts = len(self._history)
            first_t = self._history[0][0] if self._history else None
        # Windowed rates divide by WALL time over the window, so an idle
        # worker decays to 0 within ``window`` seconds instead of freezing at
        # its historical average.
        bytes_per_burst = self.bytes_per_burst()
        if first_t is not None:
            wall = max(now - first_t, win_busy, 1e-9)
        else:
            wall = 1.0  # empty window: all rates are exactly 0 below
        sustained_gbps = win_bursts * bytes_per_burst / wall / 1e9
        achieved_gbps = win_bursts * bytes_per_burst / win_busy / 1e9 if win_busy else 0.0
        bw_pct = (
            min(100.0, 100.0 * sustained_gbps / self.peak_hbm_gbps)
            if self.peak_hbm_gbps
            else None
        )
        prefill_tokens = self.batch * self.prefill_len * self._steps
        return DecodeStats(
            steps=self._steps,
            tokens_generated=tokens,
            tokens_per_sec=tokens / self._busy if self._busy else 0.0,
            cache_bytes=cache_bytes,
            seconds=self._busy,
            achieved_gbps=achieved_gbps,
            hbm_bw_util_pct=bw_pct,
            utilization_pct=min(100.0, 100.0 * win_busy / wall),
            prefill_tokens_per_sec=prefill_tokens / self._busy if self._busy else 0.0,
        )

    def utilization(self, _chip_index: int = 0) -> float:
        """Duty-cycle percent — a ``util_fn`` for TorchDeviceSource."""
        return self.stats().utilization_pct

    def hbm_bw_utilization(self, _chip_index: int = 0) -> float | None:
        """Sustained bandwidth as a percent of the device's peak — the
        ``bw_fn`` for TorchDeviceSource; None where no peak is known."""
        return self.stats().hbm_bw_util_pct


def main(device: str | torch.device | None = None) -> None:
    """``WORKLOAD=decode python -m k8s_gpu_hpa_tpu_torch.loadgen`` — the
    serving container: offered-load generator → request queue → decode
    worker.

    Env: DECODE_BATCH, MAX_SEQ, D_MODEL, N_HEADS, N_LAYERS, PREFILL_LEN
    (prompt tokens scored per burst; 0 = decode-only, the default),
    MODEL_PARALLELISM (only 1 is ported), OFFERED_RPS_MAX (offered load at
    knob 1.0; default 4× one worker's measured capacity), REPORT_S, plus the
    intensity knob (TPU_TEST_INTENSITY / the watched file), meaning the
    fraction of OFFERED_RPS_MAX offered; PROFILE_S and PROFILE_DIR open one
    trace window (utils/profiling.py).  ``device`` is CUDA unless the caller
    passes ``"cpu"``.
    """
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.loadgen.telemetry import TelemetryWriter
    from k8s_gpu_hpa_tpu_torch.utils.profiling import ProfileWindow

    profile = ProfileWindow()

    gen = DecodeLoadGen(
        batch=int(os.environ.get("DECODE_BATCH", "8")),
        max_seq=int(os.environ.get("MAX_SEQ", "2048")),
        d_model=int(os.environ.get("D_MODEL", "512")),
        # the flash kernel's envelope needs head_dim 64 or 128: both N_HEADS=4
        # and the default 8 at D_MODEL=512 prefill on it
        n_heads=int(os.environ.get("N_HEADS", "8")),
        n_layers=int(os.environ.get("N_LAYERS", "4")),
        prefill_len=int(os.environ.get("PREFILL_LEN", "0")),
        model_parallelism=int(os.environ.get("MODEL_PARALLELISM", "1")),
        device=device,
    )
    gen.warmup()
    knob = IntensityKnob()
    telemetry = TelemetryWriter()
    queue = RequestQueue()
    # calibrate one worker's request throughput (batch requests per burst)
    # so the default offered ceiling exceeds one pod's capacity
    burst_seconds = max(gen.step(), 1e-6)
    capacity_rps = gen.batch / burst_seconds
    offered_rps_max = float(os.environ.get("OFFERED_RPS_MAX", str(4.0 * capacity_rps)))
    report_every = float(os.environ.get("REPORT_S", "10"))
    print(
        f"tpu-test decode loadgen: batch={gen.batch} ctx={gen.cfg.max_seq} "
        f"cache={gen.stats().cache_bytes / 1e6:.0f}MB on {device_name(gen.device)} "
        f"capacity~{capacity_rps:.1f}rps offered_max={offered_rps_max:.1f}rps "
        f"(knob: {knob.file}"
        + (f", telemetry: {telemetry.path}" if telemetry.enabled else "")
        + ")",
        flush=True,
    )
    last_report = time.perf_counter()
    last_tick = time.perf_counter()
    while True:
        profile.poll()
        now = time.perf_counter()
        queue.offer((now - last_tick) * knob.poll() * offered_rps_max)
        last_tick = now
        if queue.depth >= 1.0:
            gen.step()
            queue.take(gen.batch)
        else:
            time.sleep(0.05)  # idle: wait for demand, don't spin
        s = gen.stats()
        telemetry.write(
            duty_cycle_pct=s.utilization_pct,
            hbm_bw_util_pct=s.hbm_bw_util_pct,
            queue_depth=queue.depth,
        )
        if time.perf_counter() - last_report >= report_every:
            print(
                f"bursts={s.steps} tok/s={s.tokens_per_sec:.0f} "
                f"busy={s.seconds:.1f}s queue={queue.depth:.0f} "
                f"bw={s.achieved_gbps:.0f}GB/s"
                + (
                    f" ({s.hbm_bw_util_pct:.1f}% of peak)"
                    if s.hbm_bw_util_pct is not None
                    else ""
                ),
                flush=True,
            )
            last_report = time.perf_counter()
