"""Clock abstraction so every control-plane loop is testable without wall time.

The reference's pipeline is a stack of polling loops with fixed intervals — 10 s
exporter collection (dcgm-exporter.yaml:37), 1 s Prometheus scrape
(kube-prometheus-stack-values.yaml:5), 15 s HPA sync (README.md:123 discussion) —
and its only "tests" are humans waiting for those loops (README.md:80-88).  Every
loop in this rebuild takes a ``Clock`` so integration tests drive the entire
closed loop in virtual time in milliseconds of real time.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable


class Clock:
    """Interface: monotonic ``now()`` in seconds and a cooperative ``sleep()``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """Real wall-clock time (used by the exporter daemon and bench)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic manually-advanced clock with scheduled callbacks.

    ``advance(dt)`` moves time forward, firing any callbacks scheduled via
    ``call_at``/``call_later`` in timestamp order.  This is the spine of the
    closed-loop simulator: exporter sampling, scrapes, rule evaluations, HPA
    syncs, and pod-start latencies are all events on one virtual timeline.
    """

    def __init__(self, start: float = 0.0):
        self._now = start
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._advancing = False

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        # Cooperative: in virtual time a "sleep" is just an advance.  Illegal
        # from inside an event callback (it would fire future events early and
        # then rewind time when the outer advance() finishes) — event-driven
        # components must use call_later instead.
        self.advance(seconds)

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        with self._lock:
            heapq.heappush(self._events, (when, self._seq, fn))
            self._seq += 1

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        self.call_at(self._now + delay, fn)

    def advance(self, dt: float) -> None:
        """Advance virtual time by ``dt`` seconds, firing due callbacks in order.

        Not reentrant: a callback that calls advance()/sleep() would fire future
        events early and let the outer call rewind time, so that is rejected.
        """
        if self._advancing:
            raise RuntimeError(
                "VirtualClock.advance()/sleep() called from inside an event "
                "callback; use call_later() to schedule follow-up work"
            )
        self._advancing = True
        try:
            deadline = self._now + dt
            while True:
                with self._lock:
                    if not self._events or self._events[0][0] > deadline:
                        break
                    when, _, fn = heapq.heappop(self._events)
                self._now = max(self._now, when)
                fn()
            self._now = deadline
        finally:
            self._advancing = False

    def run_until(self, t: float) -> None:
        if t > self._now:
            self.advance(t - self._now)
