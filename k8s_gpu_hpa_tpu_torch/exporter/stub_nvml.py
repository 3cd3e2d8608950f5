"""A stub NVML library for hardware-free tests of ``NvmlSource``.

The counterpart of ``k8s_gpu_hpa_tpu/exporter/stub_libtpu.py``.  Where the
JAX package stands a gRPC server in for the libtpu runtime-metrics service,
the port builds a shared library (``csrc/stub_nvml.cc``, with g++ into the
package's ``_build/`` at first use) that exports the NVML functions
``exporter/nvml.py`` declares, with NVML's signatures, struct layouts,
versions and units.  ``NvmlSource(library=build_stub())`` then runs its
production code through the same ctypes prototypes it uses on the card.

``StubNvml`` scripts the library's devices: each one's utilization, memory,
temperature, power (milliwatts, as NVML reports it), UUID, GPM support and
DRAM bandwidth, and any call's return code (``NVML_ERROR_NOT_SUPPORTED`` on
one gauge, a failing core call).  It reads back how often each function was
called, the live GPM samples and the init count.  The state is one per
process, as NVML's is: ``StubNvml(...)`` resets it.
"""

from __future__ import annotations

import ctypes
from ctypes import c_char_p, c_double, c_int, c_uint, c_ulonglong
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.utils.build import build_shared

SOURCE = Path(__file__).resolve().parent / "csrc" / "stub_nvml.cc"
CXX_FLAGS = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_SETTERS = {
    "stub_nvml_set_uuid": [c_uint, c_char_p],
    "stub_nvml_set_utilization": [c_uint, c_uint, c_uint],
    "stub_nvml_set_memory": [c_uint, c_ulonglong, c_ulonglong, c_ulonglong],
    "stub_nvml_set_temperature": [c_uint, c_uint],
    "stub_nvml_set_power": [c_uint, c_uint],
    "stub_nvml_set_gpm": [c_uint, c_int, c_double],
}


def build_stub(gpm: bool = True) -> Path:
    """Compile the stub library if needed; returns its path.  Without
    ``gpm`` it exports no GPM function, as a driver before R520."""
    if gpm:
        return build_shared("libstub_nvml.so", [SOURCE], CXX_FLAGS)[0]
    return build_shared("libstub_nvml_nogpm.so", [SOURCE], [*CXX_FLAGS, "-DSTUB_NVML_NO_GPM"])[0]


class StubNvml:
    """Scripts the stub library's ``count`` devices (reset on construction).

    A device starts with utilization 0, 80 GiB of memory (512 MiB reserved,
    1 MiB used), 35 °C, 70 W, no GPM, and the UUID ``default_uuid(i)``.
    Without ``gpm`` the library exports no GPM function at all."""

    def __init__(self, count: int = 1, gpm: bool = True):
        self.path = str(build_stub(gpm))
        self._lib = ctypes.CDLL(self.path)
        for name, argtypes in _SETTERS.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = c_int
        self._lib.stub_nvml_reset.argtypes = [c_uint]
        self._lib.stub_nvml_set_return.argtypes = [c_char_p, c_int, c_int]
        self._lib.stub_nvml_calls.argtypes = [c_char_p]
        self._lib.stub_nvml_calls.restype = c_int
        self._lib.stub_nvml_live_samples.restype = c_int
        self._lib.stub_nvml_init_count.restype = c_int
        self.reset(count)

    def reset(self, count: int) -> None:
        self._lib.stub_nvml_reset(count)

    def _set(self, name: str, *args) -> None:
        if getattr(self._lib, name)(*args) != 0:
            raise IndexError(f"{name}: no device {args[0]}")

    def set_uuid(self, i: int, uuid: str) -> None:
        self._set("stub_nvml_set_uuid", i, uuid.encode())

    def set_utilization(self, i: int, gpu: int, memory: int = 0) -> None:
        self._set("stub_nvml_set_utilization", i, gpu, memory)

    def set_memory(self, i: int, total: int, reserved: int, used: int) -> None:
        self._set("stub_nvml_set_memory", i, total, reserved, used)

    def set_temperature(self, i: int, celsius: int) -> None:
        self._set("stub_nvml_set_temperature", i, celsius)

    def set_power(self, i: int, milliwatts: int) -> None:
        self._set("stub_nvml_set_power", i, milliwatts)

    def set_gpm(self, i: int, supported: bool, dram_bw_util: float = 0.0) -> None:
        self._set("stub_nvml_set_gpm", i, int(supported), dram_bw_util)

    def set_return(self, function: str, code: int, device: int = -1) -> None:
        """``function`` returns ``code`` for ``device`` (-1: every device, or
        a call that takes none) until set back to 0."""
        self._lib.stub_nvml_set_return(function.encode(), device, code)

    def calls(self, function: str) -> int:
        return self._lib.stub_nvml_calls(function.encode())

    def live_samples(self) -> int:
        """GPM samples allocated and not yet freed."""
        return self._lib.stub_nvml_live_samples()

    def init_count(self) -> int:
        """nvmlInit_v2 calls not yet matched by nvmlShutdown."""
        return self._lib.stub_nvml_init_count()

    @staticmethod
    def default_uuid(i: int) -> str:
        return f"GPU-5e1f{i:04x}-0000-4000-8000-{0xABC000 + i:012x}"
