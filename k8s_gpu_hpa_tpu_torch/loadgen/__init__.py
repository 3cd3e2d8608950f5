"""Load generators (L1): the matmul busy-loop, the serving decode loop, their
intensity knob and telemetry."""
