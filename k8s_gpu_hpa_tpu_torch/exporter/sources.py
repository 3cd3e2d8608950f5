"""Device-metric sources for the exporter daemon.

Counterpart of ``k8s_gpu_hpa_tpu/exporter/sources.py``.  Three
implementations of one protocol — ``sample() -> list[ChipSample]``:

- ``StubSource``       — scripted utilization curves for hardware-free tests.
- ``TorchDeviceSource``— readings from inside the workload's process: device
                         memory from PyTorch's caching allocator, and the
                         activity gauges self-reported by the in-process load
                         generator (the JAX package's ``JaxDeviceSource``).
- ``NvmlSource``       — the production path: every GPU of the node read
                         through the driver's NVML (``exporter/nvml.py``), the
                         source DCGM samples (the JAX package's
                         ``LibtpuSource``).

The JAX package also merges several libtpu endpoints (``MergedLibtpuSource``),
because libtpu serves one port for each workload process.  NVML needs no
such merge: one handle sees every GPU of the node, whoever uses it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Protocol

import torch

from k8s_gpu_hpa_tpu_torch.device import local_devices
from k8s_gpu_hpa_tpu_torch.exporter import nvml
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


def file_util_fn(path: str, default: float = 20.0):
    """A StubSource ``util_fn`` that reads a percent from a watched file —
    the exporter-side analog of the loadgen's intensity knob, so the kind-e2e
    harness can drive scale-up with one ``kubectl exec`` (README.md:113-116's
    "double the load" trick without any accelerator)."""

    def util_fn(t: float, chip_index: int) -> float:
        try:
            with open(path) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return default

    return util_fn


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


@dataclass
class _GpmPair:
    """One device's two GPM samples: the last sweep's and the next one's."""

    last: int
    spare: int
    primed: bool = False  # ``last`` holds a reading


class NvmlSource:
    """Every GPU of the node, read through NVML (the production path).

    The counterpart of the JAX package's ``LibtpuSource``; its gauges:

    - ``duty_cycle`` ← ``utilization.gpu``: the share of NVML's last sample
      period (1/6 s to 1 s, by product) in which a kernel ran — the
      reference's ``dcgm_gpu_utilization`` and libtpu's duty cycle;
    - ``hbm_usage_bytes`` and ``hbm_total_bytes`` ← ``nvmlDeviceGetMemoryInfo_v2``:
      the bytes in use on the device, by every process, without the
      driver's reservation — what ``nvidia-smi`` reports as ``memory.used``
      and what libtpu's HBM usage means, not the bytes one process holds;
    - ``tensorcore_util`` is None, always: NVML serves no achieved/peak
      FLOPs number, as libtpu serves none.  The workload's self-report
      supplies it through the daemon's merge (``exporter/selfreport.py``);
    - ``hbm_bw_util`` ← GPM's ``DRAM_BW_UTIL`` (percent of peak), where
      ``nvmlGpmQueryDeviceSupport`` says the device has GPM.  GPM computes a
      metric between two samples, so each device keeps its last sample across
      sweeps and the first sweep has no bandwidth.  Without GPM (a driver
      before R520 exports none of its functions), or where the first sample
      is refused (a container can refuse it although the device advertises
      it), the gauge is absent (None), never 0, and a self-report may fill
      it;
    - ``temperature_c`` and ``power_w`` (watts, from NVML's milliwatts) only
      where the call succeeds: a failing gauge is absent, alone.

    ``fetch_bw`` and ``fetch_temp_power`` prune what is read: a family the
    operator's field list disables costs no NVML call.  Utilization and
    memory are always read; a failure of either raises, after ``close()``,
    and the daemon's freshness watchdog turns ``up`` to 0.

    ``accel_index`` is NVML's index: the node-level index the kubelet's
    UUIDs resolve to (``uuid_to_index``), not a CUDA ordinal, which
    ``CUDA_VISIBLE_DEVICES`` and ``CUDA_DEVICE_ORDER`` can hide or reorder.

    The library is loaded on construction (``OSError`` where it is absent)
    and initialised at the first ``sample()``; ``close()`` shuts NVML down
    and frees the GPM samples, and the next ``sample()`` initialises again.
    A reentrant lock for each instance serialises ``sample`` and ``close``.
    """

    def __init__(
        self,
        library: str = nvml.DEFAULT_LIBRARY,
        fetch_bw: bool = True,
        fetch_temp_power: bool = True,
    ):
        self.fetch_bw = fetch_bw
        self.fetch_temp_power = fetch_temp_power
        self._nvml = nvml.Nvml(library)
        self._mu = threading.RLock()
        #: (NVML index, handle) of every device while NVML is initialised
        self._devices: list[tuple[int, int]] | None = None
        self._gpm: dict[int, _GpmPair] = {}

    def _open(self) -> None:
        self._nvml.init()
        gpm: dict[int, _GpmPair] = {}
        try:
            devices = []
            for i in range(self._nvml.device_count()):
                handle = self._nvml.handle_by_index(i)
                devices.append((self._nvml.index(handle), handle))
            for index, handle in devices if self.fetch_bw else ():
                try:
                    supported = self._nvml.gpm_supported(handle)
                except nvml.NvmlError:
                    supported = False  # a capability, probed once: not a failure
                if supported:
                    last = self._nvml.gpm_sample_alloc()
                    try:
                        spare = self._nvml.gpm_sample_alloc()
                    except nvml.NvmlError:
                        self._nvml.gpm_sample_free(last)
                        raise
                    gpm[index] = _GpmPair(last, spare)
        except nvml.NvmlError:
            self._free(gpm)
            self._nvml.shutdown()
            raise
        self._devices, self._gpm = devices, gpm

    def _free(self, gpm: dict[int, _GpmPair]) -> None:
        for pair in gpm.values():
            self._nvml.gpm_sample_free(pair.last)
            self._nvml.gpm_sample_free(pair.spare)

    def close(self) -> None:
        with self._mu:
            if self._devices is None:
                return
            gpm, self._gpm, self._devices = self._gpm, {}, None
            try:
                self._free(gpm)
            finally:
                self._nvml.shutdown()

    def _optional(self, read: Callable[[int], float], handle: int) -> float | None:
        try:
            return read(handle)
        except nvml.NvmlError:
            return None

    def _bandwidth(self, index: int, handle: int) -> float | None:
        pair = self._gpm.get(index)
        if pair is None:
            return None
        try:
            self._nvml.gpm_sample_get(handle, pair.spare)
        except nvml.NvmlError:
            if not pair.primed:
                # refused at the first sample although the device advertises
                # GPM (a container can): a missing capability, not retried.
                # _mu is reentrant and sample() holds it already; taken here
                # so every write of _gpm holds it where it is written
                with self._mu:
                    del self._gpm[index]
                self._free({index: pair})
            # else a transient failure: the next sample pairs with ``last``
            return None
        value = None
        if pair.primed:
            try:
                value = self._nvml.gpm_dram_bw_util(pair.last, pair.spare)
            except nvml.NvmlError:
                pass
        pair.last, pair.spare, pair.primed = pair.spare, pair.last, True
        return value

    def _read(self, index: int, handle: int) -> ChipSample:
        util = self._nvml.utilization(handle)
        mem = self._nvml.memory(handle)
        temp = power = None
        if self.fetch_temp_power:
            temp = self._optional(self._nvml.temperature_c, handle)
            power_mw = self._optional(self._nvml.power_mw, handle)
            power = None if power_mw is None else power_mw / 1000.0
        return ChipSample(
            accel_index=index,
            tensorcore_util=None,
            duty_cycle=float(util.gpu),
            hbm_usage_bytes=float(mem.used),
            hbm_total_bytes=float(mem.total),
            hbm_bw_util=self._bandwidth(index, handle),
            temperature_c=None if temp is None else float(temp),
            power_w=power,
        )

    def sample(self) -> list[ChipSample]:
        with self._mu:
            if self._devices is None:
                self._open()
            try:
                return [self._read(index, handle) for index, handle in self._devices]
            except nvml.NvmlError:
                self.close()  # initialise again next sweep
                raise

    def uuid_to_index(self, uuid: str) -> int | None:
        """The NVML index of the device with this ``GPU-…`` UUID, None where
        no device has it: the kubelet attributor's resolver."""
        with self._mu:
            if self._devices is None:
                self._open()
            try:
                handle = self._nvml.handle_by_uuid(uuid)
            except nvml.NvmlError as e:
                if e.code in (nvml.NVML_ERROR_NOT_FOUND, nvml.NVML_ERROR_INVALID_ARGUMENT):
                    return None
                raise
            return self._nvml.index(handle)
