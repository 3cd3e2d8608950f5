"""Env-gated profiling window: one ``torch.profiler`` trace per process.

Counterpart of ``k8s_gpu_hpa_tpu/utils/profiling.py``.  The profiler is the
tool that explains a utilization number: the trace shows each kernel on
the device's timeline, the host's launches behind it and the gaps between.

Contract: set ``PROFILE_S=10`` on any load-generator container and the
process captures ONE 10-second trace starting at its next main-loop tick,
written under ``PROFILE_DIR`` (default ``/tmp/tpu-profile``) as one Chrome
trace, ``trace-<pid>.json``.  The window is polled from the generator's own
loop rather than a timer thread, so the trace brackets exactly the
steady-state work the loop does, and the profiler stops on the thread that
started it.

Fetch from a pod:  kubectl cp <pod>:/tmp/tpu-profile ./trace  (then open the
JSON in ``chrome://tracing`` or Perfetto; README "Profiling a workload").
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import torch


class ProfileWindow:
    """One-shot trace window driven by ``poll()`` calls from a main loop.

    Disabled (every call a no-op) unless ``PROFILE_S`` parses to a positive
    number of seconds.  The first ``poll()`` starts the trace; the first
    ``poll()`` at least ``PROFILE_S`` seconds later stops it and writes the
    file.  A second window never opens: one process, one trace, so the
    artifact a runbook step fetches is unambiguous.  The device's activity
    is traced where a GPU is present, the host's always.
    """

    def __init__(self, env: dict | None = None):
        env = os.environ if env is None else env
        try:
            self.seconds = float(env.get("PROFILE_S", "0") or "0")
        except ValueError:
            self.seconds = 0.0
        self.path = Path(env.get("PROFILE_DIR", "/tmp/tpu-profile")) / f"trace-{os.getpid()}.json"
        self._profiler: torch.profiler.profile | None = None
        self._started_at: float | None = None
        self._done = self.seconds <= 0

    @property
    def enabled(self) -> bool:
        return self.seconds > 0

    def poll(self) -> None:
        if self._done:
            return
        now = time.perf_counter()
        if self._started_at is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._started_at = now
            print(
                f"profiling: capturing {self.seconds:.0f}s trace to {self.path}",
                flush=True,
            )
        elif now - self._started_at >= self.seconds:
            self._stop()
            print(f"profiling: trace written to {self.path}", flush=True)

    def close(self) -> None:
        """Stop an open window early (shutdown path) so a SIGTERM mid-window
        still leaves a readable trace on disk."""
        if self._started_at is not None and not self._done:
            self._stop()

    def _stop(self) -> None:
        self._done = True
        self._profiler.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(str(self.path))
        self._profiler = None
