"""The runtime intensity knob, shared by every load generator.

One duty-cycle in [0,1], settable three ways: constructor/env at start
(``TPU_TEST_INTENSITY``), API (``set``), or the watched file — the
``kubectl exec`` equivalent of the reference's "rerun the busy-loop" trick
(cuda-test-deployment.yaml:19, README.md:113-116):

    kubectl exec <pod> -- sh -c 'echo 0.9 > /tmp/tpu-test-intensity'

Extracted so the single-chip matmul generator and the multi-host collective
generator share one definition of clamping, file polling, and the
duty-cycle throttle.
"""

from __future__ import annotations

import os
import time

INTENSITY_ENV = "TPU_TEST_INTENSITY"
INTENSITY_FILE_ENV = "TPU_TEST_INTENSITY_FILE"
DEFAULT_INTENSITY_FILE = "/tmp/tpu-test-intensity"


class IntensityKnob:
    def __init__(self, initial: float | None = None):
        if initial is None:
            initial = float(os.environ.get(INTENSITY_ENV, "1.0"))
        self._value = max(0.0, min(1.0, initial))
        self.file = os.environ.get(INTENSITY_FILE_ENV, DEFAULT_INTENSITY_FILE)

    @property
    def value(self) -> float:
        return self._value

    def set(self, value: float) -> None:
        self._value = max(0.0, min(1.0, value))

    def poll(self) -> float:
        """Refresh from the watched file; keeps the current value when the
        file is absent or mid-write."""
        try:
            with open(self.file) as f:
                self.set(float(f.read().strip()))
        except (OSError, ValueError):
            pass
        return self._value

    def throttle(self, busy: float) -> None:
        """Sleep so busy/(busy+idle) matches the duty cycle; at zero
        intensity, idle-poll instead of spinning."""
        intensity = self._value
        if intensity <= 0.0:
            time.sleep(0.05)
        elif intensity < 1.0:
            time.sleep(busy * (1.0 - intensity) / intensity)
