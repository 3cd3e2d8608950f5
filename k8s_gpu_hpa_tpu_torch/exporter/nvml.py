"""The ctypes ABI with NVML (``libnvidia-ml.so.1``): the one place it is
spelled out.

NVML is the driver's management library, the source DCGM itself samples
(the reference's ``dcgm_gpu_utilization`` is NVML's ``utilization.gpu``).
This module plays the part ``exporter/libtpu_proto.py`` plays in the JAX
package: every function the exporter calls, with its argument and result
types, and every struct, with the layout of NVIDIA's ``nvml.h`` (CUDA 12.8's;
``chip_smoke.py`` compiles a probe against the header of the toolkit it runs
beside and checks every size, offset and constant below).  ``sources.NvmlSource`` is
its one user; the CPU tests point it at a stub library built from
``csrc/stub_nvml.cc`` that exports the same symbols with the same layouts.

Nothing is loaded at import: ``Nvml(library)`` opens the library when a
source is constructed.  Every call returns an ``nvmlReturn_t``; a code other
than ``NVML_SUCCESS`` raises ``NvmlError`` carrying it, and
``NvmlError.not_supported`` singles out ``NVML_ERROR_NOT_SUPPORTED``, which
the source treats as a missing capability rather than a failure.
"""

from __future__ import annotations

import ctypes
from ctypes import POINTER, byref, c_char_p, c_double, c_int, c_uint, c_ulonglong, c_void_p

DEFAULT_LIBRARY = "libnvidia-ml.so.1"

# nvmlReturn_t
NVML_SUCCESS = 0
NVML_ERROR_INVALID_ARGUMENT = 2
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_NOT_FOUND = 6
NVML_ERROR_GPU_IS_LOST = 15

#: nvmlTemperatureSensors_t: the GPU die
NVML_TEMPERATURE_GPU = 0
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96
#: nvmlGpmMetricId_t: DRAM bandwidth used, percent of peak (0-100)
NVML_GPM_METRIC_DRAM_BW_UTIL = 10
#: length of nvmlGpmMetricsGet_t.metrics in nvml.h
NVML_GPM_METRIC_MAX = 210
NVML_GPM_METRICS_GET_VERSION = 1
NVML_GPM_SUPPORT_VERSION = 1


class Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample period in which a
    kernel ran (``gpu``) or device memory was read or written (``memory``)."""

    _fields_ = [("gpu", c_uint), ("memory", c_uint)]


class MemoryV2(ctypes.Structure):
    """nvmlMemory_v2_t, bytes.  ``used`` leaves out the memory the driver
    reserves (``reserved``), as ``nvidia-smi``'s ``memory.used`` does; it
    counts every process's allocations on the device."""

    _fields_ = [
        ("version", c_uint),
        ("total", c_ulonglong),
        ("reserved", c_ulonglong),
        ("free", c_ulonglong),
        ("used", c_ulonglong),
    ]


#: NVML_STRUCT_VERSION(Memory, 2): the struct's size, the version in the top byte
MEMORY_V2_VERSION = ctypes.sizeof(MemoryV2) | (2 << 24)


class GpmSupport(ctypes.Structure):
    """nvmlGpmSupport_t."""

    _fields_ = [("version", c_uint), ("isSupportedDevice", c_uint)]


class GpmMetricInfo(ctypes.Structure):
    _fields_ = [("shortName", c_char_p), ("longName", c_char_p), ("unit", c_char_p)]


class GpmMetric(ctypes.Structure):
    """nvmlGpmMetric_t: the caller sets ``metricId``; NVML fills the rest."""

    _fields_ = [
        ("metricId", c_uint),
        ("nvmlReturn", c_int),
        ("value", c_double),
        ("metricInfo", GpmMetricInfo),
    ]


class GpmMetricsGet(ctypes.Structure):
    """nvmlGpmMetricsGet_t: the metrics computed between two samples."""

    _fields_ = [
        ("version", c_uint),
        ("numMetrics", c_uint),
        ("sample1", c_void_p),
        ("sample2", c_void_p),
        ("metrics", GpmMetric * NVML_GPM_METRIC_MAX),
    ]


#: every function called, with its argument types; each returns nvmlReturn_t.
#: nvmlDevice_t and nvmlGpmSample_t are opaque pointers.
PROTOTYPES: dict[str, list] = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [POINTER(c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [c_uint, POINTER(c_void_p)],
    "nvmlDeviceGetHandleByUUID": [c_char_p, POINTER(c_void_p)],
    "nvmlDeviceGetIndex": [c_void_p, POINTER(c_uint)],
    "nvmlDeviceGetUUID": [c_void_p, c_char_p, c_uint],
    "nvmlDeviceGetUtilizationRates": [c_void_p, POINTER(Utilization)],
    "nvmlDeviceGetMemoryInfo_v2": [c_void_p, POINTER(MemoryV2)],
    "nvmlDeviceGetTemperature": [c_void_p, c_int, POINTER(c_uint)],
    "nvmlDeviceGetPowerUsage": [c_void_p, POINTER(c_uint)],
}

#: GPM's functions, which drivers before R520 do not export: bound only where
#: the library has them all, and a device is then asked whether it has GPM.
GPM_PROTOTYPES: dict[str, list] = {
    "nvmlGpmQueryDeviceSupport": [c_void_p, POINTER(GpmSupport)],
    "nvmlGpmSampleAlloc": [POINTER(c_void_p)],
    "nvmlGpmSampleFree": [c_void_p],
    "nvmlGpmSampleGet": [c_void_p, c_void_p],
    "nvmlGpmMetricsGet": [POINTER(GpmMetricsGet)],
}


class NvmlError(RuntimeError):
    """An NVML call returned ``code`` (an ``nvmlReturn_t`` other than 0)."""

    def __init__(self, function: str, code: int, message: str):
        super().__init__(f"{function}: {message} (nvmlReturn_t {code})")
        self.function = function
        self.code = code

    @property
    def not_supported(self) -> bool:
        return self.code == NVML_ERROR_NOT_SUPPORTED


class Nvml:
    """NVML opened from ``library`` with every prototype declared.

    Opening loads the library (``OSError`` where it is absent or lacks a
    function of ``PROTOTYPES``) and calls nothing: ``init()`` and
    ``shutdown()`` are the caller's, and the driver counts them, so several
    users in one process may each init and shut down.  A library without
    GPM's functions opens all the same, and no device of it has GPM."""

    def __init__(self, library: str = DEFAULT_LIBRARY):
        self._lib = ctypes.CDLL(library)
        missing = [name for name in (*PROTOTYPES, "nvmlErrorString")
                   if not hasattr(self._lib, name)]
        if missing:
            raise OSError(f"{library} is not NVML: it lacks {', '.join(missing)}")
        self.has_gpm = all(hasattr(self._lib, name) for name in GPM_PROTOTYPES)
        for name, argtypes in (PROTOTYPES | GPM_PROTOTYPES if self.has_gpm else PROTOTYPES).items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = c_int
        self._lib.nvmlErrorString.argtypes = [c_int]
        self._lib.nvmlErrorString.restype = c_char_p

    def _call(self, name: str, *args) -> None:
        code = getattr(self._lib, name)(*args)
        if code != NVML_SUCCESS:
            message = self._lib.nvmlErrorString(code) or b"unknown error"
            raise NvmlError(name, code, message.decode(errors="replace"))

    def init(self) -> None:
        self._call("nvmlInit_v2")

    def shutdown(self) -> None:
        self._call("nvmlShutdown")

    def device_count(self) -> int:
        n = c_uint()
        self._call("nvmlDeviceGetCount_v2", byref(n))
        return n.value

    def handle_by_index(self, index: int) -> int:
        handle = c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, byref(handle))
        return handle.value

    def handle_by_uuid(self, uuid: str) -> int:
        handle = c_void_p()
        self._call("nvmlDeviceGetHandleByUUID", uuid.encode(), byref(handle))
        return handle.value

    def index(self, handle: int) -> int:
        index = c_uint()
        self._call("nvmlDeviceGetIndex", handle, byref(index))
        return index.value

    def uuid(self, handle: int) -> str:
        buf = ctypes.create_string_buffer(NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        self._call("nvmlDeviceGetUUID", handle, buf, len(buf))
        return buf.value.decode()

    def utilization(self, handle: int) -> Utilization:
        util = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", handle, byref(util))
        return util

    def memory(self, handle: int) -> MemoryV2:
        mem = MemoryV2(version=MEMORY_V2_VERSION)
        self._call("nvmlDeviceGetMemoryInfo_v2", handle, byref(mem))
        return mem

    def temperature_c(self, handle: int) -> int:
        temp = c_uint()
        self._call("nvmlDeviceGetTemperature", handle, NVML_TEMPERATURE_GPU, byref(temp))
        return temp.value

    def power_mw(self, handle: int) -> int:
        power = c_uint()
        self._call("nvmlDeviceGetPowerUsage", handle, byref(power))
        return power.value

    def gpm_supported(self, handle: int) -> bool:
        if not self.has_gpm:
            return False
        support = GpmSupport(version=NVML_GPM_SUPPORT_VERSION)
        self._call("nvmlGpmQueryDeviceSupport", handle, byref(support))
        return bool(support.isSupportedDevice)

    def gpm_sample_alloc(self) -> int:
        sample = c_void_p()
        self._call("nvmlGpmSampleAlloc", byref(sample))
        return sample.value

    def gpm_sample_free(self, sample: int) -> None:
        self._call("nvmlGpmSampleFree", sample)

    def gpm_sample_get(self, handle: int, sample: int) -> None:
        self._call("nvmlGpmSampleGet", handle, sample)

    def gpm_dram_bw_util(self, sample1: int, sample2: int) -> float:
        """DRAM bandwidth used between two samples, percent of peak."""
        query = GpmMetricsGet(
            version=NVML_GPM_METRICS_GET_VERSION, numMetrics=1,
            sample1=sample1, sample2=sample2,
        )
        query.metrics[0].metricId = NVML_GPM_METRIC_DRAM_BW_UTIL
        self._call("nvmlGpmMetricsGet", byref(query))
        metric = query.metrics[0]
        if metric.nvmlReturn != NVML_SUCCESS:
            raise NvmlError("nvmlGpmMetricsGet(DRAM_BW_UTIL)", metric.nvmlReturn,
                            "metric not computed")
        return metric.value
