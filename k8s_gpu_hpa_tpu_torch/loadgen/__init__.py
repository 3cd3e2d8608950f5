"""Load generators (L1): the matmul busy-loop, its intensity knob, its telemetry."""
