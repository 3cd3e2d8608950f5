"""The port's node exporter: the self-report reader and merge and the daemon
against the JAX package's, ``NvmlSource`` over the stub NVML library (built
here with g++; the same ctypes prototypes as on the card), and the container
entry point in a subprocess.  The node headline trial, a closed loop against
the wall clock, is in tests/test_torch_slice.py."""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from k8s_gpu_hpa_tpu.exporter import selfreport as jax_selfreport
from k8s_gpu_hpa_tpu.exporter.daemon import ExporterDaemon as JaxExporterDaemon
from k8s_gpu_hpa_tpu.exporter.podresources import StaticAttributor as JaxStaticAttributor
from k8s_gpu_hpa_tpu.exporter.sources import StubSource as JaxStubSource
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu_torch.exporter import nvml, selfreport
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import NvmlSource, StubSource
from k8s_gpu_hpa_tpu_torch.exporter.stub_nvml import StubNvml
from k8s_gpu_hpa_tpu_torch.metrics import schema
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NOW = 1_000_000.0  # the readers' clock, seconds


# ---- self-reports ----------------------------------------------------------


def _write(path: Path, doc) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(doc if isinstance(doc, str) else json.dumps(doc))


def report_dir(root: Path) -> Path:
    """Report files of every kind the reader must sort out."""
    d = root / "telemetry"
    _write(d / "default_tpu-test-real.json", {  # flat: no physical anchor
        "namespace": "default", "pod": "tpu-test-real", "ts": NOW - 2,
        "tensorcore_util_pct": 53.9, "duty_cycle_pct": 99.5, "achieved_tflops": 533.0})
    _write(d / "default_stale.json", {
        "namespace": "default", "pod": "stale", "ts": NOW - 31, "tensorcore_util_pct": 90})
    _write(d / "default_torn.json", '{"namespace": "default", "pod": "torn", "ts"')
    _write(d / "not_json.txt", "ignored")
    _write(d / "default_tpu-serve-real" / "r.json", {  # in its own subPathExpr mount
        "namespace": "default", "pod": "tpu-serve-real", "ts": NOW - 1,
        "hbm_bw_util_pct": 130.0, "queue_depth": 4, "queue": "tpu-serve",
        "achieved_tflops": "not a number"})
    _write(d / "default_victim" / "r.json", {  # a spoof: claims another pod
        "namespace": "default", "pod": "tpu-test-real", "ts": NOW, "tensorcore_util_pct": 1.0})
    _write(d / "team_b.json", {
        "namespace": "team", "pod": "b", "ts": NOW - 5, "duty_cycle_pct": -4,
        "queue_depth": -3, "queue": "q"})
    _write(d / "default_no_pod.json", {"namespace": "default", "ts": NOW})
    _write(d / "default_bad_ts.json", {"namespace": "default", "pod": "x", "ts": "soon"})
    return d


ATTRIBUTIONS = {
    "kubelet": {0: ("default", "tpu-test-real"), 1: ("default", "tpu-serve-real"), 3: ("x", "y")},
    "empty": {},
    "one": {2: ("team", "b")},
}


def _reports(module, directory):
    return module.SelfReportReader(str(directory), now_fn=lambda: NOW).read()


def _as_tuples(reports):
    return {k: dataclasses.astuple(r) for k, r in reports.items()}


def test_reader_reads_as_the_jax_reader_does(tmp_path):
    d = report_dir(tmp_path)
    port, ref = _reports(selfreport, d), _reports(jax_selfreport, d)
    assert _as_tuples(port) == _as_tuples(ref)
    # fresh flat and anchored reports only: not the stale, torn, spoofed,
    # anonymous or untimed ones
    assert sorted(port) == [("default", "tpu-serve-real"), ("default", "tpu-test-real"),
                            ("team", "b")]
    assert port[("default", "tpu-test-real")].tensorcore_util_pct == 53.9  # not the spoof's 1.0
    assert port[("default", "tpu-serve-real")].hbm_bw_util_pct == 100.0  # clamped
    assert port[("default", "tpu-serve-real")].achieved_tflops is None
    assert port[("default", "tpu-serve-real")].queue_depth == 4.0


def test_reader_of_a_missing_directory_reads_nothing(tmp_path):
    assert _reports(selfreport, tmp_path / "absent") == {} == _reports(jax_selfreport, tmp_path / "absent")


@pytest.mark.parametrize("attribution", sorted(ATTRIBUTIONS))
def test_filter_and_merge_as_the_jax_package_does(tmp_path, attribution):
    d = report_dir(tmp_path)
    table = ATTRIBUTIONS[attribution]
    outs = []
    for module, schema_module in ((selfreport, schema), (jax_selfreport, jax_schema)):
        reports = module.filter_to_attribution(_reports(module, d), table)
        chips = [
            schema_module.ChipSample(0, None, 97.0, 1e9, 8e10, None, 60.0, 690.0),
            schema_module.ChipSample(1, None, None, 1e9, 8e10, 12.0),
            schema_module.ChipSample(2, 40.0, None, 0.0, 8e10, None),
            schema_module.ChipSample(3, None, 5.0, 0.0, 8e10, None),
        ]
        merged = module.merge_reports(chips, table, reports)
        outs.append((_as_tuples(reports), [dataclasses.astuple(c) for c in merged]))
    assert outs[0] == outs[1]
    if attribution == "kubelet":
        merged = dict((c[0], c) for c in outs[0][1])
        assert merged[0][1] == 53.9 and merged[0][2] == 97.0  # device duty wins
        assert merged[1][5] == 12.0  # the device's bandwidth wins over 100


# ---- the daemon against the JAX daemon ---------------------------------------

FIELD_LISTS = {
    "all": None,
    "headline": [schema.TPU_TENSORCORE_UTIL, schema.TPU_DUTY_CYCLE, schema.TPU_CHIP_POWER],
    "bandwidth": [schema.TPU_HBM_BW_UTIL, schema.TPU_HBM_USAGE],
}


def _mask_age(text: str) -> str:
    return re.sub(r"(tpu_metrics_exporter_sample_age_seconds\{[^}]*\}) \S+", r"\1 AGE", text)


@pytest.mark.parametrize("fields", sorted(FIELD_LISTS))
@pytest.mark.parametrize("with_reports", [False, True])
def test_daemon_renders_what_the_jax_daemon_renders(native_built, tmp_path, fields, with_reports):
    d = report_dir(tmp_path)
    clock = VirtualClock()
    attribution = {0: ("default", "tpu-test-real"), 1: ("default", "tpu-serve-real"),
                   2: ("team", "b")}

    def util(t, i):
        return 20.0 * i + 3.0 * t

    def rows():
        return [("tpu-test", "default", "tpu-test-stub", 7.0)]

    daemons = []
    for daemon_cls, source_cls, attributor_cls, module in (
        (ExporterDaemon, StubSource, StaticAttributor, selfreport),
        (JaxExporterDaemon, JaxStubSource, JaxStaticAttributor, jax_selfreport),
    ):
        daemon = daemon_cls(
            source_cls(num_chips=4, util_fn=util, clock=clock), attributor_cls(attribution),
            node_name="gpu-node-0", port=-1, clock=clock,
            selfreport=module.SelfReportReader(str(d), now_fn=lambda: NOW) if with_reports else None,
            metric_fields=FIELD_LISTS[fields],
        )
        daemon.queue_fn = rows
        daemons.append(daemon)
    try:
        texts = []
        for _ in range(3):
            clock.advance(1.0)
            for daemon in daemons:
                daemon.step()
            texts.append([_mask_age(daemon.native.render()) for daemon in daemons])
        assert all(daemon.sweeps == 3 for daemon in daemons)
    finally:
        for daemon in daemons:
            daemon.close()
    for port_text, jax_text in texts:
        assert port_text == jax_text
    last = texts[-1][0]
    assert ('tpu_test_queue_depth{namespace="default",node="gpu-node-0",pod="tpu-test-stub",'
            'queue="tpu-test"} 7') in last
    if with_reports:
        assert 'queue="tpu-serve"} 4' in last  # the anchored report's queue, attributed
        assert 'queue="q"' in last  # team/b is attributed too


def test_unknown_metric_field_raises_in_both_daemons():
    for daemon_cls, source in ((ExporterDaemon, StubSource()), (JaxExporterDaemon, JaxStubSource())):
        with pytest.raises(ValueError, match="unknown metric fields"):
            daemon_cls(source, port=-1, metric_fields=["tpu_duty_cycle", "dcgm_gpu_utilization"])


# ---- NvmlSource over the stub NVML -------------------------------------------


@pytest.fixture
def stub():
    """Two scripted devices; every test starts from the stub's defaults."""
    return StubNvml(2)


def _source(stub, **kw) -> NvmlSource:
    return NvmlSource(stub.path, **kw)


def test_struct_layouts_are_those_of_the_cards_nvml_h():
    # sizes and versions as CUDA 12.8's nvml.h gives them (chip_smoke.py's
    # nvml phase compiles a probe against the header and checks each offset)
    assert ctypes_sizes() == {"Utilization": 8, "MemoryV2": 40, "GpmSupport": 8,
                              "GpmMetric": 40, "GpmMetricsGet": 8424}
    assert nvml.MEMORY_V2_VERSION == 0x2000028
    assert nvml.GpmMetricsGet.metrics.offset == 24


def ctypes_sizes():
    import ctypes

    return {name: ctypes.sizeof(getattr(nvml, name))
            for name in ("Utilization", "MemoryV2", "GpmSupport", "GpmMetric", "GpmMetricsGet")}


def test_every_gauge_and_its_units(stub):
    stub.set_utilization(1, 73, 41)
    stub.set_memory(1, total=80 << 30, reserved=480 << 20, used=3 << 30)
    stub.set_temperature(1, 61)
    stub.set_power(1, 412_345)  # milliwatts
    source = _source(stub)
    try:
        chips = source.sample()
    finally:
        source.close()
    assert [c.accel_index for c in chips] == [0, 1]
    chip = chips[1]
    assert chip == schema.ChipSample(
        accel_index=1, tensorcore_util=None, duty_cycle=73.0,
        hbm_usage_bytes=float(3 << 30), hbm_total_bytes=float(80 << 30), hbm_bw_util=None,
        temperature_c=61.0, power_w=412.345,
    )


@pytest.mark.parametrize("call,gauge", [("nvmlDeviceGetTemperature", "temperature_c"),
                                        ("nvmlDeviceGetPowerUsage", "power_w")])
def test_not_supported_drops_that_gauge_alone(stub, call, gauge):
    stub.set_return(call, nvml.NVML_ERROR_NOT_SUPPORTED, device=0)
    source = _source(stub)
    try:
        first, second = source.sample()
    finally:
        source.close()
    assert getattr(first, gauge) is None and getattr(second, gauge) is not None
    other = "power_w" if gauge == "temperature_c" else "temperature_c"
    assert getattr(first, other) is not None
    assert first.duty_cycle == 0.0 and first.hbm_total_bytes > 0


def test_gpm_unsupported_leaves_the_gauge_absent(stub):
    source = _source(stub)
    try:
        sweeps = [source.sample() for _ in range(3)]
    finally:
        source.close()
    assert all(c.hbm_bw_util is None for sweep in sweeps for c in sweep)
    assert stub.calls("nvmlGpmQueryDeviceSupport") == 2  # probed once a device
    assert stub.calls("nvmlGpmSampleGet") == 0


def test_gpm_bandwidth_from_the_second_sweep_on(stub):
    stub.set_gpm(0, True, 37.5)
    source = _source(stub)
    try:
        first = source.sample()[0].hbm_bw_util
        second = source.sample()[0].hbm_bw_util
        stub.set_gpm(0, True, 80.25)
        third = source.sample()[0].hbm_bw_util
        assert stub.live_samples() == 2  # two a GPM device, allocated once
        assert stub.calls("nvmlGpmSampleGet") == 3  # device 0 alone, once a sweep
    finally:
        source.close()
    assert (first, second, third) == (None, 37.5, 80.25)
    assert stub.live_samples() == 0


def test_gpm_refused_at_the_first_sample_is_a_missing_capability(stub):
    # the card's container: nvmlGpmQueryDeviceSupport says yes, sampling 999
    stub.set_gpm(0, True, 50.0)
    stub.set_return("nvmlGpmSampleGet", 999, device=0)
    source = _source(stub)
    try:
        sweeps = [source.sample()[0].hbm_bw_util for _ in range(3)]
        assert stub.live_samples() == 0  # freed when refused
    finally:
        source.close()
    assert sweeps == [None, None, None]
    assert stub.calls("nvmlGpmSampleGet") == 1  # not retried


def test_a_gpm_failure_after_the_first_sample_is_transient(stub):
    stub.set_gpm(0, True, 20.0)
    source = _source(stub)
    try:
        readings = [source.sample()[0].hbm_bw_util]
        readings.append(source.sample()[0].hbm_bw_util)
        stub.set_return("nvmlGpmSampleGet", 999, device=0)
        readings.append(source.sample()[0].hbm_bw_util)
        stub.set_return("nvmlGpmSampleGet", 0, device=0)
        readings.append(source.sample()[0].hbm_bw_util)
    finally:
        source.close()
    assert readings == [None, 20.0, None, 20.0]


@pytest.mark.parametrize("fetch_bw", [False, True])
@pytest.mark.parametrize("fetch_temp_power", [False, True])
def test_fetch_flags_prune_nvml_calls(stub, fetch_bw, fetch_temp_power):
    stub.set_gpm(0, True, 10.0)
    source = _source(stub, fetch_bw=fetch_bw, fetch_temp_power=fetch_temp_power)
    try:
        for _ in range(2):
            chips = source.sample()
    finally:
        source.close()
    assert stub.calls("nvmlDeviceGetTemperature") == (4 if fetch_temp_power else 0)
    assert stub.calls("nvmlDeviceGetPowerUsage") == (4 if fetch_temp_power else 0)
    assert stub.calls("nvmlGpmQueryDeviceSupport") == (2 if fetch_bw else 0)
    assert stub.calls("nvmlGpmSampleGet") == (2 if fetch_bw else 0)
    assert stub.calls("nvmlDeviceGetUtilizationRates") == 4  # the core calls always
    assert stub.calls("nvmlDeviceGetMemoryInfo_v2") == 4
    assert (chips[0].hbm_bw_util == 10.0) is fetch_bw
    assert (chips[0].power_w is not None) is fetch_temp_power


@pytest.mark.parametrize("call", ["nvmlDeviceGetUtilizationRates", "nvmlDeviceGetMemoryInfo_v2"])
def test_a_failing_core_call_raises_and_the_next_sweep_recovers(stub, call):
    stub.set_gpm(1, True, 5.0)
    source = _source(stub)
    try:
        source.sample()
        stub.set_return(call, nvml.NVML_ERROR_GPU_IS_LOST, device=1)
        with pytest.raises(nvml.NvmlError) as err:
            source.sample()
        assert err.value.code == nvml.NVML_ERROR_GPU_IS_LOST and not err.value.not_supported
        assert stub.init_count() == 0 and stub.live_samples() == 0  # closed
        stub.set_return(call, 0, device=1)
        assert len(source.sample()) == 2
        assert stub.init_count() == 1
    finally:
        source.close()


def test_a_failing_init_raises_nvmls_error(stub):
    stub.set_return("nvmlInit_v2", 9)  # NVML_ERROR_DRIVER_NOT_LOADED
    source = _source(stub)
    with pytest.raises(nvml.NvmlError, match="nvmlInit_v2") as err:
        source.sample()
    assert err.value.code == 9


def test_a_missing_library_raises_at_construction(tmp_path):
    with pytest.raises(OSError):
        NvmlSource(str(tmp_path / "libnvidia-ml.so.1"))


def test_close_then_sample_initialises_again(stub):
    stub.set_gpm(0, True, 12.0)
    source = _source(stub)
    source.sample()
    source.sample()
    source.close()
    source.close()  # twice: a no-op
    assert stub.init_count() == 0 and stub.live_samples() == 0
    try:
        assert source.sample()[0].hbm_bw_util is None  # GPM starts over
        assert source.sample()[0].hbm_bw_util == 12.0
        assert stub.init_count() == 1
    finally:
        source.close()
    assert stub.calls("nvmlInit_v2") == 2 and stub.calls("nvmlShutdown") == 2


def test_concurrent_sample_and_close(stub):
    stub.set_gpm(0, True, 30.0)
    stub.set_gpm(1, True, 31.0)
    source = _source(stub)
    errors, counts = [], {"sample": 0, "close": 0}
    stop = time.monotonic() + 1.5
    interval = sys.getswitchinterval()

    def run(name, fn):
        try:
            while time.monotonic() < stop:
                fn()
                counts[name] += 1
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=("sample", source.sample)),
                   threading.Thread(target=run, args=("sample", source.sample)),
                   threading.Thread(target=run, args=("close", source.close))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        source.close()
    assert errors == []
    assert counts["sample"] > 0 and counts["close"] > 0
    # every init matched by a shutdown, every GPM sample freed
    assert stub.init_count() == 0 and stub.live_samples() == 0
    assert stub.calls("nvmlInit_v2") == stub.calls("nvmlShutdown")


def test_uuid_to_index_resolves_through_nvml(stub):
    # a UUID ending in digits (the trailing-integer rule would say 7)
    stub.set_uuid(0, "GPU-12ab2938-905b-7039-2e15-9ce2bc90abc7")
    source = _source(stub)
    try:
        assert source.uuid_to_index("GPU-12ab2938-905b-7039-2e15-9ce2bc90abc7") == 0
        assert source.uuid_to_index(StubNvml.default_uuid(1)) == 1
        assert source.uuid_to_index("GPU-00000000-0000-0000-0000-0000000000f3") is None
    finally:
        source.close()
    assert stub.calls("nvmlDeviceGetHandleByUUID") == 3


def test_uuid_of_a_handle(stub):
    lib = nvml.Nvml(stub.path)
    lib.init()
    try:
        assert lib.uuid(lib.handle_by_index(1)) == StubNvml.default_uuid(1)
    finally:
        lib.shutdown()


def test_a_driver_without_gpm_serves_every_other_gauge():
    # drivers before R520 export no nvmlGpm* function: GPM is then a
    # missing capability, and the source opens all the same
    stub = StubNvml(2, gpm=False)
    stub.set_utilization(0, 55)
    assert not nvml.Nvml(stub.path).has_gpm
    source = _source(stub)
    try:
        sweeps = [source.sample() for _ in range(2)]
    finally:
        source.close()
    assert all(c.hbm_bw_util is None for sweep in sweeps for c in sweep)
    assert sweeps[1][0].duty_cycle == 55.0 and sweeps[1][0].power_w == 70.0
    assert stub.init_count() == 0


def test_a_library_that_is_not_nvml_raises_oserror():
    with pytest.raises(OSError, match="nvmlInit_v2"):
        NvmlSource("libc.so.6")


# ---- the container entry point ----------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exporter(env: dict) -> subprocess.Popen:
    full = {k: v for k, v in os.environ.items() if not k.startswith(("SOURCE", "STUB_"))}
    full.update(env)
    return subprocess.Popen(
        [sys.executable, "-m", "k8s_gpu_hpa_tpu_torch.exporter"], cwd=REPO, env=full,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _fetch(port: int) -> str | None:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
            return r.read().decode()
    except OSError:
        return None


def test_main_serves_the_stub_source(tmp_path):
    port = _free_port()
    (tmp_path / "util").write_text("66\n")
    proc = _exporter({"SOURCE": "stub", "LISTEN_PORT": str(port), "COLLECT_MS": "100",
                      "STUB_CHIPS": "2", "STUB_UTIL_FILE": str(tmp_path / "util"),
                      "STUB_QUEUE_NAME": "tpu-test", "STUB_QUEUE_FILE": str(tmp_path / "q"),
                      "NODE_NAME": "gpu-node-7", "TPU_TELEMETRY_DIR": str(tmp_path / "tel")})
    try:
        deadline = time.monotonic() + 120
        text = None
        while time.monotonic() < deadline and proc.poll() is None:
            text = _fetch(port)
            if text and "tpu_duty_cycle" in text:
                break
            time.sleep(0.2)
        assert text and "tpu_duty_cycle" in text, (proc.poll(), text)
    finally:
        proc.terminate()
        proc.wait(30)
    values = {(f.name, dict(s.labels).get("chip")): s.value for f in parse_text(text)
              for s in f.samples}
    assert values[("tpu_tensorcore_utilization", "1")] == 66.0
    assert values[("tpu_chip_power_watts", "0")] == 60.0 + 66.0 * 1.4
    assert values[("tpu_metrics_exporter_up", None)] == 1.0
    assert values[("tpu_test_queue_depth", None)] == 0.0
    assert 'node="gpu-node-7"' in text


@pytest.mark.parametrize("env", [{"SOURCE": "nvml"}, {}, {"SOURCE": "nvml", "TPU_METRIC_FIELDS": "tpu_duty_cycle"}])
def test_main_without_nvml_exits_non_zero_and_serves_nothing(env):
    port = _free_port()
    proc = _exporter({**env, "LISTEN_PORT": str(port)})
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode != 0
    assert "NVML" in err and "libnvidia-ml.so.1" in err
    assert _fetch(port) is None


def test_main_refuses_an_unknown_source():
    proc = _exporter({"SOURCE": "libtpu", "LISTEN_PORT": str(_free_port())})
    _, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "expected nvml, torch or stub" in err
