"""The port's doctor against the JAX package's: each joint check gives the
same detail, or raises the same words, on the payloads of
tests/test_doctor.py, and ``check_alerts`` and ``check_histograms`` on
alert payloads and on a traced pipeline's self-metrics exposition, whole
and broken; ``check_self_metrics`` passes on either package's traced
series (the port serves JAX's ten families); ``diagnose``, with the shard
topology, query-planner, capacity-pool and operator probes, stops at the
first broken joint as JAX's does; ``check_capacity_pool`` and
``check_operator_metrics`` give JAX's verdicts on whole and broken
payloads; the CLI probes an exporter and a Prometheus over HTTP, its
alerts and, with SELF_METRICS=1, its self-metric series, and with
OPERATOR_URL and CAPACITY_SELFCHECK=1 an operator's /metrics and the
capacity selfcheck; ``gen-pipeline`` writes JAX's pipeline but where a
GPU node needs another value, and refuses what JAX's refuses; and
``probe_nvml`` over the stub NVML library: exit 0 with GPM served, with GPM
refused and with no GPM at all, exit 1 when NVML or a device call fails."""

import functools
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

import pytest
import torch
import yaml

import k8s_gpu_hpa_tpu.__main__ as jax_cli
from k8s_gpu_hpa_tpu import doctor as jax_doctor
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.obs import selfmetrics as jax_selfmetrics
import k8s_gpu_hpa_tpu_torch.__main__ as cli
from k8s_gpu_hpa_tpu_torch import doctor, simulate
from k8s_gpu_hpa_tpu_torch.control import capacity, operator
from k8s_gpu_hpa_tpu_torch.metrics import downsample, federation, planner, rules, tsdb
from k8s_gpu_hpa_tpu_torch.obs import selfmetrics
from k8s_gpu_hpa_tpu_torch.utils import clock
from k8s_gpu_hpa_tpu_torch.exporter.daemon import ExporterDaemon
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import StubSource
from k8s_gpu_hpa_tpu_torch.exporter.stub_nvml import StubNvml
from tests.test_doctor import exposition, prom_payload
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_manifests import _EXPORTER, GPU_PATHS, _under, _walk

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


def _alerts(*alerts) -> str:
    return json.dumps({"status": "success", "data": {"alerts": [
        {"state": state, "labels": {"alertname": name}} for name, state in alerts]}})


ALERTS_QUIET = _alerts()


def _operator_text(reconciles: int = 3, held: dict | None = None, up: int = 1) -> str:
    """An operator's /metrics after ``reconciles`` passes, its held gauges."""
    m = operator.OperatorMetrics()
    m.reconciles_total, m.repairs_total["up"] = reconciles, up
    for target, value in (held or {}).items():
        m.set_held(target, value)
    return m.render()


OPERATOR_LIVE = _operator_text(held={"StatefulSet/a": False})
_SELFCHECK = capacity.capacity_selfcheck()


@functools.cache
def _traced(package: str = "port") -> tuple[str, str]:
    """The SLO check's traced pipeline (``simulate._slo_pipeline``) of one
    package after 200 s, one load step scaled: its self-metric series as
    Prometheus answers ``SELF_METRICS_QUERY``, and its ``pipeline-self``
    exposition."""
    sim, names = ((simulate, selfmetrics.SELF_METRIC_NAMES) if package == "port"
                  else (jax_simulate, jax_selfmetrics.SELF_METRIC_NAMES))
    pipe = sim._slo_pipeline(12.0)
    pipe.clock.advance(200.0)
    results = [{"metric": {"__name__": name, **dict(s.labels)}, "value": [0, str(s.value)]}
               for name in names for s in pipe.db.instant_vector(name)]
    return prom_payload(results), pipe.selfmetrics.exposition()


def _broken(how: str) -> str:
    """The traced exposition with one histogram contract broken."""
    text = _traced()[1]
    name = selfmetrics.SELF_HISTOGRAM_NAMES[0]
    if how == "no_inf":
        return "\n".join(l for l in text.splitlines() if not (
            l.startswith(name + "_bucket") and 'le="+Inf"' in l))
    if how == "count":
        return re.sub(rf"^({name}_count(?:{{[^}}]*}})?) (\S+)", r"\1 99999", text, count=1,
                      flags=re.M)
    if how == "not_cumulative":
        return re.sub(rf"^({name}_bucket{{[^}}]*}}) (\S+)", r"\1 99999", text, count=1,
                      flags=re.M)
    if how == "negative_sum":
        return re.sub(rf"^({name}_sum(?:{{[^}}]*}})?) (\S+)", r"\1 -5", text, count=1,
                      flags=re.M)
    if how == "no_sum":
        return "\n".join(l for l in text.splitlines() if not l.startswith(name + "_sum"))
    if how == "missing":
        return "\n".join(l for l in text.splitlines() if name not in l)
    raise KeyError(how)

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
    ("check_alerts", (ALERTS_QUIET,)),
    ("check_alerts", (_alerts(("Watchdog", "firing")),)),
    ("check_alerts", (_alerts(("TpuExporterStale", "pending")),)),
    ("check_alerts", (_alerts(("TpuExporterDown", "firing"), ("TpuChipHot", "firing"),
                              ("TpuExporterStale", "pending")),)),
    ("check_alerts", (json.dumps({}),)),
    ("check_capacity_pool", (json.dumps(_SELFCHECK),)),
    ("check_capacity_pool", (json.dumps({**_SELFCHECK, "conserved_all": False}),)),
    ("check_capacity_pool", (json.dumps({**_SELFCHECK, "violations": [
        "node n: used 3 + free 0 != capacity 4", "pod p: holds 1 chips, requested 2"]}),)),
    ("check_capacity_pool", (json.dumps({**_SELFCHECK, "preemption_roundtrip": False}),)),
    ("check_capacity_pool", (json.dumps({**_SELFCHECK, "lo_running": 0}),)),
    ("check_capacity_pool", (json.dumps({}),)),
    ("check_operator_metrics", (OPERATOR_LIVE,)),
    ("check_operator_metrics", (_operator_text(0),)),
    ("check_operator_metrics", (_operator_text(held={"StatefulSet/a": True,
                                                      "StatefulSet/b": True}),)),
    ("check_operator_metrics", (_operator_text(held={"StatefulSet/b": True}),)),
    ("check_operator_metrics", ("",)),
    ("check_operator_metrics", (exposition(),)),
]
HISTOGRAM_CASES = ["whole", "no_inf", "count", "not_cumulative", "negative_sum", "no_sum",
                   "missing", "empty"]


def _outcome(fn, *args) -> tuple[bool, str]:
    try:
        return True, fn(*args)
    except AssertionError as e:
        return False, str(e)


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_each_check_gives_jax_s_result(name, args):
    assert _outcome(getattr(doctor, name), *args) == _outcome(getattr(jax_doctor, name), *args)


@pytest.mark.parametrize("how", HISTOGRAM_CASES)
def test_the_histogram_probe_gives_jax_s_result(how):
    if how == "whole":
        text = _traced()[1]
    elif how == "empty":
        text = selfmetrics.PipelineSelfMetrics(clock=clock.VirtualClock()).exposition()
    else:
        text = _broken(how)
    port = _outcome(doctor.check_histograms, text)
    assert port == _outcome(jax_doctor.check_histograms, text)
    assert port[0] == (how == "whole"), port


def test_the_self_metrics_probe_passes_on_each_package_s_traced_pipeline():
    """Each package's probe passes on its own pipeline's series and on the
    other's, with one detail: the port serves JAX's ten families, the query
    planner's and the decode cache's six counters among them."""
    port = _outcome(doctor.check_self_metrics, _traced()[0])
    assert port == (True, "all 10 self-metric families fresh (14 series)")
    assert _outcome(jax_doctor.check_self_metrics, _traced()[0]) == port
    assert _outcome(jax_doctor.check_self_metrics, _traced("jax")[0]) == port
    assert _outcome(doctor.check_self_metrics, _traced("jax")[0]) == port


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


@functools.cache
def _shards_and_planner() -> tuple[str, str]:
    """A sharded scrape plane's status (three shards over a fleet of ten)
    and the planner's selfcheck of an instant and an ``avg_over_time`` rule
    over ten minutes of four series (sealed chunks, so the fast path runs)."""
    plane = federation.ShardedScrapePlane(clock.VirtualClock(), 3)
    for i in range(10):
        plane.add_target(lambda: "", name=f"exporter/node-{i}")
    vclock = clock.VirtualClock()
    db = tsdb.TimeSeriesDB(vclock, retention=900.0)
    for t in range(1, 601):
        vclock.advance(1.0)
        for i in range(4):
            db.append("m", (("i", str(i)),), float((t * 7 + i) % 13), float(t))
    selfcheck = planner.planner_selfcheck(db, [
        rules.RecordingRule("m_avg", rules.Avg(rules.Select("m"))),
        rules.RecordingRule("m_5m", rules.Avg(rules.AvgOverTime("m", 300.0))),
    ])
    return plane.shard_status_json(), json.dumps(selfcheck)


@functools.cache
def _capacity_selfcheck() -> str:
    """The capacity economy's small crunch as JSON (the JAX package's, field
    for field: tests/test_torch_capacity.py)."""
    return json.dumps(capacity.capacity_selfcheck())


@functools.cache
def _rollup_selfcheck() -> str:
    """The rollup tiers' selfcheck of six hours of four series at 30 s on
    the default 5m/1h policy (both tiers hold buckets, raw still covers
    them)."""
    vclock = clock.VirtualClock()
    db = tsdb.TimeSeriesDB(vclock, retention=7 * 3600.0, downsample=downsample.DownsamplePolicy())
    for t in range(1, 721):
        vclock.advance(30.0)
        for i in range(4):
            db.append("m", (("i", str(i)),), float((t * 7 + i) % 13), 30.0 * t)
    return json.dumps(downsample.downsample_selfcheck(db, ["m"]))


@pytest.mark.parametrize("broken", [None, "exporter", "prom", "up", "shards", "self_metrics",
                                    "self_exposition", "planner", "downsample", "api", "hpa",
                                    "alerts", "capacity", "operator"])
def test_diagnose_stops_at_the_first_broken_joint_as_jax_s_does(broken):
    shards, selfcheck = _shards_and_planner()
    good = {"exporter": exposition(), "prom": ADDRESSED, "up": UP, "shards": shards,
            "self_metrics": _traced()[0], "self_exposition": _traced()[1], "planner": selfcheck,
            "downsample": _rollup_selfcheck(), "capacity": _capacity_selfcheck(), "api": API,
            "hpa": HPA_ACTIVE, "operator": OPERATOR_LIVE, "alerts": ALERTS_QUIET}
    order = ["exporter", "prom", "up", "shards", "self_metrics", "self_exposition", "planner",
             "downsample", "capacity", "api", "hpa", "operator", "alerts"]
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
        "L2 exporter", "L3 prometheus", "L3 scrape health", "L3 shard topology",
        "L3 self-metrics", "L3 histogram conformance", "L3 query planner",
        "L3 rollup tiers", "capacity pool", "L4 custom-metrics API", "L5 HPA",
        "quantum operator", "alerts"]
    assert all(r.ok for r in results)
    assert all(r.detail.startswith("skipped") for r in results[1:])


class _Prometheus(BaseHTTPRequestHandler):
    """Answers the doctor's instant queries and its alerts."""

    def do_GET(self):  # noqa: N802 — the handler's name
        if self.path.startswith("/api/v1/alerts"):
            body = ALERTS_QUIET
        elif f"query={METRIC}" in self.path:
            body = ADDRESSED
        elif unquote(self.path).endswith(f"query={doctor.SELF_METRICS_QUERY}"):
            body = _traced()[0]
        else:
            body = UP
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.mark.parametrize("self_metrics", [False, True])
def test_the_cli_probes_a_live_exporter_and_prometheus(monkeypatch, capsys, self_metrics):
    """``main`` over HTTP: the port's exporter daemon on a stub source and
    a Prometheus that answers the queries and the alerts.  Without kubectl
    the API and HPA joints are skipped, and without SELF_METRICS=1 the
    self-metrics joint; the exposition's histogram joint has no fetcher
    there."""
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
        if self_metrics:
            monkeypatch.setenv("SELF_METRICS", "1")
        else:
            monkeypatch.delenv("SELF_METRICS", raising=False)
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
    assert out[3] == "[ok ] L3 shard topology: skipped (no fetcher)"
    payload = _traced()[0]
    assert out[4] == ("[ok ] L3 self-metrics: " + doctor.check_self_metrics(payload)
                      if self_metrics else "[ok ] L3 self-metrics: skipped (no fetcher)")
    assert out[5:] == ["[ok ] L3 histogram conformance: skipped (no fetcher)",
                       "[ok ] L3 query planner: skipped (no fetcher)",
                       "[ok ] L3 rollup tiers: skipped (no fetcher)",
                       "[ok ] capacity pool: skipped (no fetcher)",
                       "[ok ] L4 custom-metrics API: skipped (no fetcher)",
                       "[ok ] L5 HPA: skipped (no fetcher)",
                       "[ok ] quantum operator: skipped (no fetcher)",
                       "[ok ] alerts: no pipeline alerts firing"]


class _Operator(BaseHTTPRequestHandler):
    """Serves an operator's /metrics: ``OPERATOR_LIVE``."""

    def do_GET(self):  # noqa: N802 — the handler's name
        data = OPERATOR_LIVE.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def test_the_cli_probes_the_operator_and_the_capacity_selfcheck(monkeypatch, capsys):
    """``main`` with OPERATOR_URL (an operator's /metrics over HTTP) and
    CAPACITY_SELFCHECK=1 (the small crunch in process), its exporter and
    Prometheus unreachable: the first joint fails, so nothing after it
    runs; with those two alone wired into ``diagnose``, each probe answers
    as the JAX doctor's on the same payloads."""
    operator = ThreadingHTTPServer(("127.0.0.1", 0), _Operator)
    server = threading.Thread(target=operator.serve_forever, daemon=True)
    server.start()
    fetched = {}
    try:
        monkeypatch.setenv("OPERATOR_URL", f"http://127.0.0.1:{operator.server_address[1]}/m")
        monkeypatch.setenv("CAPACITY_SELFCHECK", "1")
        monkeypatch.setattr(doctor.shutil, "which", lambda cmd: None)
        real = doctor.diagnose

        def wired(**kw):
            fetched.update(operator=kw["operator_fetch"](), capacity=kw["capacity_fetch"]())
            return real(operator_fetch=kw["operator_fetch"], capacity_fetch=kw["capacity_fetch"])

        monkeypatch.setattr(doctor, "diagnose", wired)
        assert doctor.cli([]) == 0
    finally:
        operator.shutdown()
        server.join(10)
        operator.server_close()
    out = capsys.readouterr().out.splitlines()
    assert fetched["operator"] == OPERATOR_LIVE
    assert json.loads(fetched["capacity"]) == json.loads(_capacity_selfcheck())
    assert ("[ok ] capacity pool: "
            + jax_doctor.check_capacity_pool(fetched["capacity"])) in out
    assert ("[ok ] quantum operator: "
            + jax_doctor.check_operator_metrics(OPERATOR_LIVE)) in out


# ---- gen-pipeline ----------------------------------------------------------------


def _written(main, argv: list[str], out) -> dict:
    assert main(["gen-pipeline", *argv, "-o", str(out)]) == 0
    return {p.name: list(yaml.safe_load_all(p.read_text())) for p in sorted(out.iterdir())}


@pytest.mark.parametrize("argv", [
    ["--app", "my-app"],
    ["--app", "my-app", "--metric", "duty-cycle", "--target", "55", "--min-replicas", "2",
     "--max-replicas", "6", "--namespace", "ml"],
    ["--app", "slice-app", "--metric", "hbm-bw", "--hosts-per-slice", "4", "--min-slices", "1",
     "--max-slices", "3"],
    ["--app", "my-app", "--node-selector", "accel=h100", "--node-selector", "zone=a",
     "--toleration", "gpu=yes:NoSchedule", "--toleration", "spot:NoExecute"],
], ids=["default", "duty", "slices", "selector"])
def test_gen_pipeline_writes_jax_s_pipeline_but_where_a_gpu_node_needs_another(argv, tmp_path,
                                                                               capsys):
    port = _written(cli.main, argv + ["--gpu-limit", "2"], tmp_path / "port")
    ref = _written(jax_cli.main, argv + ["--tpu-limit", "2"], tmp_path / "jax")
    assert list(port) == list(ref)
    diffs: list = []
    for name, docs in port.items():
        _walk(docs, ref[name], (name,), diffs)
    # a pipeline's own exporter DaemonSet differs where the bundle's does
    exporter = [(f"{argv[1]}-exporter-daemonset.yaml", "0", *p[2:])
                for p in GPU_PATHS if p[:2] == _EXPORTER]
    assert [d for d in diffs if not any(_under(d, p) for p in GPU_PATHS + exporter)] == []
    lines = capsys.readouterr().out.splitlines()
    assert sorted(line.rsplit("/", 1)[-1] for line in lines if "/port/" in line) == list(port)


def test_gen_pipeline_prints_the_pipeline_without_an_out_directory(capsys):
    assert cli.main(["gen-pipeline", "--app", "my-app"]) == 0
    text = capsys.readouterr().out
    names = re.findall(r"^# ===== (\S+) =====$", text, flags=re.M)
    assert names == ["my-app-deployment.yaml", "my-app-prometheusrule.yaml",
                     "my-app-adapter-values.yaml", "my-app-hpa.yaml"]


@pytest.mark.parametrize("argv", [
    ["--node-selector", "novalue"], ["--node-selector", "=v"], ["--toleration", "noeffect"],
    ["--toleration", ":NoSchedule"], ["--toleration", "key:"],
])
def test_gen_pipeline_refuses_what_jax_s_refuses(argv, capsys):
    assert cli.main(["gen-pipeline", "--app", "my-app", *argv]) == 2
    port = capsys.readouterr()
    assert jax_cli.main(["gen-pipeline", "--app", "my-app", *argv]) == 2
    ref = capsys.readouterr()
    assert (port.out, port.err) == (ref.out, ref.err) and port.err


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
