"""The port's doctor against the JAX package's: each joint check gives the
same detail, or raises the same words, on the payloads of
tests/test_doctor.py; ``diagnose`` stops at the first broken joint; the
CLI probes an exporter and a Prometheus over HTTP; and ``probe_nvml`` over
the stub NVML library: exit 0 with GPM served, with GPM refused and with no
GPM at all, exit 1 when NVML or a device call fails."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from k8s_gpu_hpa_tpu import doctor as jax_doctor
from k8s_gpu_hpa_tpu_torch import doctor
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import StubSource
from k8s_gpu_hpa_tpu_torch.exporter.stub_nvml import StubNvml
from tests.test_doctor import exposition, prom_payload
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

ADDRESSED = prom_payload([{
    "metric": {"__name__": "tpu_test_multihost_tensorcore_avg", "namespace": "default",
               "statefulset": "tpu-test-multihost"},
    "value": [1700000000, "53.3"],
}])
UNADDRESSED = prom_payload([{"metric": {"__name__": "m"}, "value": [0, "1"]}])
UP = prom_payload([{"metric": {"job": "tpu-metrics", "instance": f"n{i}:9400"},
                    "value": [0, "1"]} for i in range(3)])
DOWN = prom_payload([
    {"metric": {"job": "tpu-metrics", "instance": "n0:9400"}, "value": [0, "1"]},
    {"metric": {"job": "tpu-metrics", "instance": "n1:9400"}, "value": [0, "0"]},
])
API = json.dumps({"resources": [{"name": "statefulsets.apps/tpu_test_multihost_tensorcore_avg"}]})
HPA_ACTIVE = json.dumps({"status": {"currentReplicas": 2, "desiredReplicas": 6, "conditions": [
    {"type": "ScalingActive", "status": "True"}]}})
HPA_FAILED = json.dumps({"status": {"conditions": [
    {"type": "ScalingActive", "status": "False", "reason": "FailedGetObjectMetric",
     "message": "unable to get metric"}]}})
METRIC = "tpu_test_multihost_tensorcore_avg"

CASES = [
    ("check_exporter_text", (exposition(),)),
    ("check_exporter_text", (exposition(up=0.0),)),
    ("check_exporter_text", (exposition(attributed=False, chips=3),)),
    ("check_exporter_text", ("",)),
    ("check_prom_vector", (ADDRESSED, METRIC)),
    ("check_prom_vector", (prom_payload([]), METRIC)),
    ("check_prom_vector", (UNADDRESSED, "m")),
    ("check_prom_vector", (json.dumps({"status": "error"}), METRIC)),
    ("check_scrape_up", (UP,)),
    ("check_scrape_up", (DOWN,)),
    ("check_scrape_up", (prom_payload([]),)),
    ("check_custom_metrics_api", (API, METRIC)),
    ("check_custom_metrics_api", (json.dumps({"resources": []}), METRIC)),
    ("check_hpa_status", (HPA_ACTIVE,)),
    ("check_hpa_status", (HPA_FAILED,)),
    ("check_hpa_status", (json.dumps({"status": {}}),)),
]


def _outcome(fn, *args) -> tuple[bool, str]:
    try:
        return True, fn(*args)
    except AssertionError as e:
        return False, str(e)


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_each_check_gives_jax_s_result(name, args):
    assert _outcome(getattr(doctor, name), *args) == _outcome(getattr(jax_doctor, name), *args)


def _fetchers(**payloads):
    """A fetcher per joint, each recording its call; ``None`` raises
    ConnectionError, as an unreachable endpoint."""
    called = []

    def make(name):
        def fetch():
            called.append(name)
            if payloads[name] is None:
                raise ConnectionError(f"{name}: connection refused")
            return payloads[name]
        return fetch

    return {f"{name}_fetch": make(name) for name in payloads}, called


@pytest.mark.parametrize("broken", [None, "exporter", "prom", "up", "api", "hpa"])
def test_diagnose_stops_at_the_first_broken_joint_as_jax_s_does(broken):
    good = {"exporter": exposition(), "prom": ADDRESSED, "up": UP, "api": API, "hpa": HPA_ACTIVE}
    order = ["exporter", "prom", "up", "api", "hpa"]
    payloads = {k: (None if k == broken else v) for k, v in good.items()}
    port_fetch, port_called = _fetchers(**payloads)
    jax_fetch, _ = _fetchers(**payloads)
    port = doctor.diagnose(metric=METRIC, **port_fetch)
    ref = {r.name: r for r in jax_doctor.diagnose(metric=METRIC, **jax_fetch)}
    for r in port:
        assert (r.ok, r.detail) == (ref[r.name].ok, ref[r.name].detail)
    stop = order.index(broken) + 1 if broken else len(order)
    assert len(port) == stop and port_called == order[:stop]
    assert [r.ok for r in port] == [True] * (stop - 1) + [broken is None]


def test_diagnose_skips_absent_fetchers():
    results = doctor.diagnose(exporter_fetch=exposition)
    assert [r.name for r in results] == [
        "L2 exporter", "L3 prometheus", "L3 scrape health", "L4 custom-metrics API", "L5 HPA"]
    assert all(r.ok for r in results)
    assert all(r.detail.startswith("skipped") for r in results[1:])


class _Prometheus(BaseHTTPRequestHandler):
    """Answers the doctor's two instant queries."""

    def do_GET(self):  # noqa: N802 — the handler's name
        body = ADDRESSED if f"query={METRIC}" in self.path else UP
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def test_the_cli_probes_a_live_exporter_and_prometheus(monkeypatch, capsys):
    """``main`` over HTTP: the port's exporter daemon on a stub source and
    a Prometheus that answers both queries.  Without kubectl the API and
    HPA joints are skipped."""
    daemon = ExporterDaemon(
        StubSource(num_chips=2), StaticAttributor({0: ("default", "tpu-test-multihost-0")}),
        node_name="doctor-node", listen_addr="127.0.0.1", port=0,
    )
    prom = ThreadingHTTPServer(("127.0.0.1", 0), _Prometheus)
    server = threading.Thread(target=prom.serve_forever, daemon=True)
    server.start()
    try:
        daemon.step()
        monkeypatch.setenv("EXPORTER_URL", f"http://127.0.0.1:{daemon.port}/metrics")
        monkeypatch.setenv("PROM_URL", f"http://127.0.0.1:{prom.server_address[1]}")
        monkeypatch.setenv("METRIC", METRIC)
        monkeypatch.setattr(doctor.shutil, "which", lambda cmd: None)
        assert doctor.cli([]) == 0
    finally:
        prom.shutdown()
        server.join(10)
        prom.server_close()
        daemon.close()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[ok ] L2 exporter: 2 chips exported, 1 attributed")
    assert out[1] == f"[ok ] L3 prometheus: {METRIC}=53.3 " + str(
        {"namespace": "default", "statefulset": "tpu-test-multihost"})
    assert out[2] == "[ok ] L3 scrape health: all 3 scrape targets up"
    assert out[3:] == ["[ok ] L4 custom-metrics API: skipped (no fetcher)",
                       "[ok ] L5 HPA: skipped (no fetcher)"]


def _probe(library: str, capsys) -> tuple[int, list[str]]:
    code = doctor.cli(["nvml", "--library", library])
    return code, capsys.readouterr().out.splitlines()


def test_probe_nvml_answers_on_every_device_with_gpm_served(capsys):
    stub = StubNvml(2)
    stub.set_gpm(1, True, 37.5)
    code, out = _probe(stub.path, capsys)
    assert code == 0
    assert not any(line.startswith("[FAIL]") for line in out)
    for i in range(2):
        for fn in ("nvmlDeviceGetHandleByIndex_v2", "nvmlDeviceGetIndex", "nvmlDeviceGetUUID",
                   "nvmlDeviceGetHandleByUUID", "nvmlDeviceGetUtilizationRates",
                   "nvmlDeviceGetMemoryInfo_v2", "nvmlDeviceGetTemperature",
                   "nvmlDeviceGetPowerUsage"):
            assert any(line.startswith(f"[ok ] device {i}: {fn}") for line in out), (i, fn)
    assert "[-- ] device 0: GPM advertised: False" in out
    assert "[-- ] device 1: GPM sample served: DRAM bandwidth 37.50% of peak" in out
    assert stub.init_count() == 0 and stub.live_samples() == 0


def test_probe_nvml_reports_gpm_refused_as_a_finding(capsys):
    """The card's driver advertises GPM and refuses its sample (999)."""
    stub = StubNvml(1)
    stub.set_gpm(0, True, 10.0)
    stub.set_return("nvmlGpmSampleGet", 999)
    code, out = _probe(stub.path, capsys)
    assert code == 0
    assert any(line.startswith("[-- ] device 0: GPM sample refused") and "999" in line
               for line in out)
    assert stub.init_count() == 0 and stub.live_samples() == 0


def test_probe_nvml_without_gpm_functions(capsys):
    stub = StubNvml(2, gpm=False)
    code, out = _probe(stub.path, capsys)
    assert code == 0
    assert sum("exports no GPM function" in line for line in out) == 2


def test_probe_nvml_fails_when_a_device_call_fails(capsys):
    stub = StubNvml(2)
    stub.set_return("nvmlDeviceGetUtilizationRates", 999, device=1)
    code, out = _probe(stub.path, capsys)
    assert code == 1
    assert [line for line in out if line.startswith("[FAIL]")] == [
        line for line in out if line.startswith("[FAIL] device 1: nvmlDeviceGetUtilizationRates")]
    assert len([line for line in out if line.startswith("[FAIL]")]) == 1
    assert stub.init_count() == 0


@pytest.mark.parametrize("fault", ["no library", "init"])
def test_probe_nvml_fails_without_nvml(fault, tmp_path, capsys):
    if fault == "no library":
        library = str(tmp_path / "libnvidia-ml.so.1")
    else:
        stub = StubNvml(1)
        stub.set_return("nvmlInit_v2", 9)  # NVML_ERROR_DRIVER_NOT_LOADED
        library = stub.path
    code, out = _probe(library, capsys)
    assert code == 1
    assert out[0].startswith("[FAIL] NVML not usable")
