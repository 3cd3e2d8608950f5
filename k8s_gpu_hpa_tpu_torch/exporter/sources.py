"""Device-metric sources for the exporter daemon.

Counterpart of ``k8s_gpu_hpa_tpu/exporter/sources.py``.  Two implementations
of one protocol — ``sample() -> list[ChipSample]``:

- ``StubSource``       — scripted utilization curves for hardware-free tests.
- ``TorchDeviceSource``— real local readings: device memory in use from
                         PyTorch's caching allocator, and the activity gauges
                         self-reported by the in-process load generator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol

import torch

from k8s_gpu_hpa_tpu_torch.device import local_devices
from k8s_gpu_hpa_tpu_torch.metrics.schema import ChipSample
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock


class MetricsSource(Protocol):
    def sample(self) -> list[ChipSample]: ...


@dataclass
class StubSource:
    """Synthetic devices driven by a utilization function of time.

    ``util_fn(t, chip_index) -> percent``; memory and bandwidth derive from
    utilization as in the JAX package's stub, so both agree on the schema.
    """

    num_chips: int = 4
    util_fn: Callable[[float, int], float] = lambda t, i: 50.0
    hbm_total: float = 16e9
    clock: Clock = field(default_factory=SystemClock)

    def __post_init__(self):
        self._t0 = self.clock.now()

    def sample(self) -> list[ChipSample]:
        t = self.clock.now() - self._t0
        chips = []
        for i in range(self.num_chips):
            util = max(0.0, min(100.0, self.util_fn(t, i)))
            chips.append(
                ChipSample(
                    accel_index=i,
                    tensorcore_util=util,
                    duty_cycle=min(100.0, util * 1.1),
                    hbm_usage_bytes=0.5e9 + (self.hbm_total - 0.5e9) * util / 100.0,
                    hbm_total_bytes=self.hbm_total,
                    hbm_bw_util=util * 0.6,
                    temperature_c=40.0 + util * 0.35,
                    power_w=60.0 + util * 1.4,
                )
            )
        return chips


class TorchDeviceSource:
    """Samples the local PyTorch devices directly.

    Device memory in use is ``torch.cuda.memory_allocated(i)`` — the bytes
    this process's tensors hold, the counterpart of XLA's ``bytes_in_use`` —
    and the total is the device's ``total_memory``.  The CPU reports zeros.
    The two activity gauges keep their distinct meanings (schema.py's table):

    - ``util_fn(i)``  → ``tpu_duty_cycle``: the in-process load generator's
      busy fraction (loadgen/matmul.py ``utilization()``);
    - ``mxu_fn(i)``   → ``tpu_tensorcore_utilization``: achieved/peak FLOPs
      (``mxu_utilization()``).

    Either callback may be None (or return None): that gauge is then absent
    for the device — never a fake 0, and never an alias of the other gauge.
    """

    def __init__(
        self,
        util_fn: Callable[[int], float] | None = None,
        mxu_fn: Callable[[int], float | None] | None = None,
        bw_fn: Callable[[int], float | None] | None = None,
        device: str | torch.device | None = None,
    ):
        self._devices = local_devices(device)
        self._util_fn = util_fn
        self._mxu_fn = mxu_fn
        self._bw_fn = bw_fn

    @staticmethod
    def _eval(fn, i) -> float | None:
        if fn is None:
            return None
        value = fn(i)
        return None if value is None else max(0.0, min(100.0, value))

    def sample(self) -> list[ChipSample]:
        chips = []
        for i, dev in enumerate(self._devices):
            if dev.type == "cuda":
                used = float(torch.cuda.memory_allocated(dev))
                total = float(torch.cuda.get_device_properties(dev).total_memory)
            else:
                used = total = 0.0
            chips.append(
                ChipSample(
                    accel_index=i,
                    tensorcore_util=self._eval(self._mxu_fn, i),
                    duty_cycle=self._eval(self._util_fn, i),
                    hbm_usage_bytes=used,
                    hbm_total_bytes=total,
                    hbm_bw_util=self._eval(self._bw_fn, i),
                )
            )
        return chips
