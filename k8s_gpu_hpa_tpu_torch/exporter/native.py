"""ctypes binding to the native exporter core (``cpp/exporter``).

Counterpart of ``k8s_gpu_hpa_tpu/exporter/native.py``, with the same C ABI.
The C++ library owns the serving hot path (registry, text rendering, HTTP
/metrics); Python pushes each sweep through this binding.  The library is
built from the repository's ``cpp/exporter/tpu_exporter.cc`` with a plain
``g++`` call into the port's own build directory, at first use.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.metrics.schema import ChipSample
from k8s_gpu_hpa_tpu_torch.utils.build import build_shared

SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "exporter" / "tpu_exporter.cc"
CXX_FLAGS = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]


class _CChipSample(ctypes.Structure):
    # None ("source cannot measure this") crosses the ABI as NaN; the C++
    # renderer omits NaN samples so the series is absent, not a fake 0.
    _fields_ = [
        ("accel_index", ctypes.c_int32),
        ("tensorcore_util", ctypes.c_double),
        ("duty_cycle", ctypes.c_double),
        ("hbm_usage_bytes", ctypes.c_double),
        ("hbm_total_bytes", ctypes.c_double),
        ("hbm_bw_util", ctypes.c_double),
        ("temperature_c", ctypes.c_double),
        ("power_w", ctypes.c_double),
    ]


_NAN = float("nan")


def _opt(value: float | None) -> float:
    return _NAN if value is None else value


def build_native() -> Path:
    """Compile the exporter core if needed; returns the library's path."""
    return build_shared("libtpu_exporter.so", [SOURCE], CXX_FLAGS)[0]


_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.tpu_exporter_create.restype = ctypes.c_void_p
        lib.tpu_exporter_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.tpu_exporter_destroy.argtypes = [ctypes.c_void_p]
        lib.tpu_exporter_push_samples.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_CChipSample), ctypes.c_int32,
        ]
        lib.tpu_exporter_replace_attribution.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
        ]
        lib.tpu_exporter_set_enabled_metrics.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
        ]
        lib.tpu_exporter_replace_queue_gauges.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
        ]
        lib.tpu_exporter_render.restype = ctypes.c_int64
        lib.tpu_exporter_render.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.tpu_exporter_port.restype = ctypes.c_int32
        lib.tpu_exporter_port.argtypes = [ctypes.c_void_p]
        lib.tpu_exporter_request_count.restype = ctypes.c_uint64
        lib.tpu_exporter_request_count.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeExporter:
    """RAII wrapper over the C ABI.

    ``port=0`` binds an ephemeral port, ``port=-1`` disables HTTP
    (render-only).  ``staleness_ms`` controls when /metrics flips
    ``tpu_metrics_exporter_up`` to 0 and withholds device gauges.
    """

    def __init__(
        self,
        node_name: str,
        listen_addr: str = "0.0.0.0",
        port: int = 9400,
        staleness_ms: int = 10_000,
    ):
        self._lib = _load()
        self._handle = self._lib.tpu_exporter_create(
            node_name.encode(), listen_addr.encode(), port, staleness_ms
        )
        if not self._handle:
            raise OSError(f"native exporter failed to bind {listen_addr}:{port}")

    def push(self, chips: list[ChipSample]) -> None:
        arr = (_CChipSample * len(chips))(
            *[
                _CChipSample(
                    c.accel_index,
                    _opt(c.tensorcore_util),
                    _opt(c.duty_cycle),
                    c.hbm_usage_bytes,
                    c.hbm_total_bytes,
                    _opt(c.hbm_bw_util),
                    _opt(c.temperature_c),
                    _opt(c.power_w),
                )
                for c in chips
            ]
        )
        self._lib.tpu_exporter_push_samples(self._handle, arr, len(chips))

    def set_attribution(self, mapping: dict[int, tuple[str, str]]) -> None:
        """Atomically replace the device→(namespace, pod) attribution table."""
        n = len(mapping)
        indices = (ctypes.c_int32 * n)(*mapping.keys())
        namespaces = (ctypes.c_char_p * n)(*[ns.encode() for ns, _ in mapping.values()])
        pods = (ctypes.c_char_p * n)(*[pod.encode() for _, pod in mapping.values()])
        self._lib.tpu_exporter_replace_attribution(
            self._handle, indices, namespaces, pods, n
        )

    def set_enabled_metrics(self, names: list[str]) -> None:
        """Restrict exposition to the named device-metric families — the
        analog of dcgm-exporter's ``-f <metrics.csv>`` field list
        (dcgm-exporter.yaml:37).  An empty list restores every family."""
        arr = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
        self._lib.tpu_exporter_set_enabled_metrics(self._handle, arr, len(names))

    def set_queue_gauges(self, gauges: list[tuple[str, str, str, float]]) -> None:
        """Atomically replace the per-pod serving-queue gauges; each entry is
        (queue, namespace, pod, depth) → tpu_test_queue_depth samples."""
        n = len(gauges)
        queues = (ctypes.c_char_p * n)(*[q.encode() for q, _, _, _ in gauges])
        namespaces = (ctypes.c_char_p * n)(*[ns.encode() for _, ns, _, _ in gauges])
        pods = (ctypes.c_char_p * n)(*[p.encode() for _, _, p, _ in gauges])
        depths = (ctypes.c_double * n)(*[d for _, _, _, d in gauges])
        self._lib.tpu_exporter_replace_queue_gauges(
            self._handle, queues, namespaces, pods, depths, n
        )

    def render(self) -> str:
        size = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.tpu_exporter_render(self._handle, buf, size)
            if n >= 0:
                return buf.raw[:n].decode()
            size = -n

    @property
    def port(self) -> int:
        return self._lib.tpu_exporter_port(self._handle)

    @property
    def request_count(self) -> int:
        """/metrics requests served over HTTP."""
        return self._lib.tpu_exporter_request_count(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.tpu_exporter_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
