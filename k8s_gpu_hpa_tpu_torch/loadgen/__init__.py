"""Load generators (L1): the matmul busy-loop, the serving decode loop, the
training loads, the slice container's collective rung, their intensity knob
and telemetry."""
