"""Pipeline doctor: the runbook's per-joint probes as one command, and the
NVML probe of a GPU node.

Counterpart of ``k8s_gpu_hpa_tpu/doctor.py``, cut to the joints the port
runs.  The reference's only test story is four manual curl probes
interleaved with install steps (exporter text, README.md:42-47; Prometheus
query, :80-88; custom-metrics raw API, :98-102; the scale-up watch,
:112-121), with the discipline "don't advance past a failing probe"
implicit in their order.  ``diagnose`` makes it executable: an ordered list
of probes, one per string-contract joint, that stops at the first broken
joint and says which contract broke.

- ``diagnose(...)`` takes plain callables (the tests' in-process payloads,
  ``main``'s HTTP and kubectl fetchers);
- ``python -m k8s_gpu_hpa_tpu_torch.doctor`` probes a cluster.  Its
  environment: EXPORTER_URL (default http://localhost:9400/metrics),
  PROM_URL (default http://localhost:9090), METRIC (default
  tpu_test_tensorcore_avg), HPA and NAMESPACE for the HPA check (the
  custom-metrics and HPA probes need ``kubectl``);
- ``python -m k8s_gpu_hpa_tpu_torch.doctor nvml`` runs ``probe_nvml``, the
  counterpart of the JAX doctor's libtpu probe: every NVML call the node
  exporter's ``NvmlSource`` makes, on every GPU of the host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable
from urllib.parse import quote

from k8s_gpu_hpa_tpu_torch.exporter import nvml
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import CHIP_METRICS, CORE_CHIP_METRICS


@dataclass
class ProbeResult:
    name: str
    ok: bool
    detail: str


@dataclass
class Probe:
    """One joint check: ``run`` returns a detail string on success and
    raises on failure; None where the joint has no fetcher (skipped)."""

    name: str
    description: str
    run: Callable[[], str] | None


def check_exporter_text(text: str) -> str:
    """L2 joint: the exporter serves fresh per-device gauges with the
    attribution labels the rules depend on."""
    fams = {f.name: f for f in parse_text(text)}
    up = fams.get("tpu_metrics_exporter_up")
    if up is None or not up.samples:
        raise AssertionError("tpu_metrics_exporter_up missing from exposition")
    if up.samples[0].value != 1.0:
        raise AssertionError(
            "tpu_metrics_exporter_up=0: exporter is serving but its metric "
            "source is stale (no fresh sweep within the staleness window)"
        )
    # only the CORE families exist on every healthy source; the optional ones
    # are absent where nothing can measure them
    missing = [m for m in CORE_CHIP_METRICS if m not in fams or not fams[m].samples]
    if missing:
        raise AssertionError(f"core chip metric families missing/empty: {missing}")
    probe_fam = fams.get("tpu_duty_cycle") or fams[CORE_CHIP_METRICS[0]]
    sample = probe_fam.samples[0]
    for label in ("node", "chip"):
        if sample.label(label) is None:
            raise AssertionError(f"per-chip samples lack the {label!r} label")
    n = len(probe_fam.samples)
    attributed = sum(1 for s in probe_fam.samples if s.label("pod"))
    optional = sorted(
        m for m in CHIP_METRICS
        if m not in CORE_CHIP_METRICS and m in fams and fams[m].samples
    )
    return (
        f"{n} chips exported, {attributed} attributed to pods"
        + (f", optional families: {', '.join(optional)}" if optional else "")
    )


def check_prom_vector(payload: str, metric: str) -> str:
    """L3 joint: the recorded series exists with its addressing labels.
    ``payload`` is the Prometheus instant-query JSON response body."""
    doc = json.loads(payload)
    if doc.get("status") != "success":
        raise AssertionError(f"prometheus query failed: {doc}")
    results = doc["data"]["result"]
    if not results:
        raise AssertionError(
            f"series {metric} absent: scrape job, recording rule, or the "
            "kube_pod_labels join is broken (or the workload isn't running — "
            "deploy it first, README ordering)"
        )
    labels = results[0]["metric"]
    addressed = {
        k: v for k, v in labels.items() if k in ("namespace", "deployment", "statefulset", "pod")
    }
    if "namespace" not in addressed or len(addressed) < 2:
        raise AssertionError(
            f"series {metric} lacks object-addressing labels (got {labels}); "
            "prometheus-adapter cannot associate it with a Kubernetes object"
        )
    value = results[0]["value"][1]
    return f"{metric}={value} {addressed}"


def check_scrape_up(payload: str) -> str:
    """L3 scrape health: every scrape target answers (``up == 1``).  A down
    target degrades coverage silently from the recorded series' point of
    view (the average is served from the survivors).  ``payload`` is the
    instant-query JSON for ``up``."""
    doc = json.loads(payload)
    if doc.get("status") != "success":
        raise AssertionError(f"prometheus query failed: {doc}")
    results = doc["data"]["result"]
    if not results:
        raise AssertionError("no up series at all: the scrape config matched zero targets")
    down = []
    for r in results:
        if float(r["value"][1]) != 1.0:
            labels = r["metric"]
            down.append(
                labels.get("target") or labels.get("instance") or labels.get("job") or "?"
            )
    if down:
        raise AssertionError(
            f"{len(down)}/{len(results)} scrape target(s) down: " + ", ".join(sorted(down))
        )
    return f"all {len(results)} scrape targets up"


def check_custom_metrics_api(payload: str, metric: str) -> str:
    """L4 joint: the aggregated API lists the metric (README.md:98-102)."""
    doc = json.loads(payload)
    names = {r.get("name", "") for r in doc.get("resources", [])}
    if not any(metric in n for n in names):
        raise AssertionError(
            f"{metric} not in custom.metrics.k8s.io discovery "
            f"({len(names)} resources); adapter rules config is broken or the "
            "series has gone stale upstream"
        )
    return f"{metric} discoverable among {len(names)} resources"


def check_hpa_status(payload: str) -> str:
    """L5 joint: the HPA read the metric (ScalingActive true)."""
    doc = json.loads(payload)
    conditions = {c["type"]: c for c in doc.get("status", {}).get("conditions", [])}
    active = conditions.get("ScalingActive")
    if active is None:
        raise AssertionError("HPA has no ScalingActive condition yet")
    if active.get("status") != "True":
        raise AssertionError(
            f"ScalingActive={active.get('status')}: {active.get('reason')} — "
            f"{active.get('message')}"
        )
    cur = doc.get("status", {}).get("currentReplicas")
    des = doc.get("status", {}).get("desiredReplicas")
    return f"ScalingActive, replicas current={cur} desired={des}"


def diagnose(
    exporter_fetch: Callable[[], str] | None = None,
    prom_fetch: Callable[[], str] | None = None,
    api_fetch: Callable[[], str] | None = None,
    hpa_fetch: Callable[[], str] | None = None,
    metric: str = "tpu_test_tensorcore_avg",
    up_fetch: Callable[[], str] | None = None,
) -> list[ProbeResult]:
    """Run the ordered joint probes, stopping at the first failure (the
    runbook's discipline).  Fetchers set to None are skipped."""

    def probe(name: str, description: str, check: Callable[[str], str],
              fetch: Callable[[], str] | None) -> Probe:
        return Probe(name, description, (lambda: check(fetch())) if fetch else None)

    probes = [
        probe("L2 exporter", "per-chip gauges fresh with node/pod attribution",
              check_exporter_text, exporter_fetch),
        probe("L3 prometheus", f"recorded series {metric} exists and is object-addressed",
              lambda p: check_prom_vector(p, metric), prom_fetch),
        probe("L3 scrape health", "every scrape target serving (up==1)",
              check_scrape_up, up_fetch),
        probe("L4 custom-metrics API", f"{metric} discoverable on custom.metrics.k8s.io",
              lambda p: check_custom_metrics_api(p, metric), api_fetch),
        probe("L5 HPA", "HPA is reading the metric (ScalingActive)",
              check_hpa_status, hpa_fetch),
    ]
    results: list[ProbeResult] = []
    for p in probes:
        if p.run is None:
            results.append(ProbeResult(p.name, True, "skipped (no fetcher)"))
            continue
        try:
            detail = p.run()
        except Exception as e:  # noqa: BLE001 — any failure is a diagnosis
            results.append(ProbeResult(p.name, False, f"{p.description}: {e}"))
            break  # don't advance past a failing probe
        results.append(ProbeResult(p.name, True, detail))
    return results


def _gpm(lib: nvml.Nvml, handle: int, i: int) -> None:
    """GPM on device ``i``: whether it is advertised, and what one pair of
    samples gives.  Every answer is a finding; none is a failure."""
    if not lib.has_gpm:
        print(f"[-- ] device {i}: GPM: the library exports no GPM function "
              "(a driver before R520): no bandwidth gauge")
        return
    try:
        supported = lib.gpm_supported(handle)
    except nvml.NvmlError as e:
        print(f"[-- ] device {i}: GPM support query refused: {e}")
        return
    print(f"[-- ] device {i}: GPM advertised: {supported}")
    if not supported:
        return
    samples: list[int] = []
    try:
        samples = [lib.gpm_sample_alloc(), lib.gpm_sample_alloc()]
        lib.gpm_sample_get(handle, samples[0])
        time.sleep(0.1)
        lib.gpm_sample_get(handle, samples[1])
        bw = lib.gpm_dram_bw_util(samples[0], samples[1])
        print(f"[-- ] device {i}: GPM sample served: DRAM bandwidth {bw:.2f}% of peak")
    except nvml.NvmlError as e:
        print(f"[-- ] device {i}: GPM sample refused ({e}): the exporter serves "
              "no bandwidth gauge on this node")
    finally:
        for sample in samples:
            lib.gpm_sample_free(sample)


def _mib(mem: nvml.MemoryV2) -> str:
    return f"{mem.used / 2**20:.0f} of {mem.total / 2**20:.0f}"


def probe_nvml(library: str = nvml.DEFAULT_LIBRARY) -> int:
    """Call every NVML function the node exporter's ``NvmlSource`` calls,
    on every device of the host, through ``exporter/nvml.py``: the device
    count, the handle by index and by UUID, the index, the UUID,
    utilization, memory, temperature and power.  Prints each answer; exit
    code 0 only when every call answered, 1 otherwise.  GPM is probed too
    (advertised, and one pair of samples), and its refusal is printed as a
    finding: it costs the bandwidth gauge, not the exporter."""
    try:
        lib = nvml.Nvml(library)
        lib.init()
    except (OSError, nvml.NvmlError) as e:
        print(f"[FAIL] NVML not usable from {library}: {e}")
        return 1
    failures = 0

    def call(what: str, fn: Callable[[], object]) -> object:
        nonlocal failures
        try:
            value = fn()
        except nvml.NvmlError as e:
            failures += 1
            print(f"[FAIL] {what}: {e}")
            return None
        print(f"[ok ] {what}: {value}")
        return value

    try:
        count = call("nvmlDeviceGetCount_v2", lib.device_count)
        for i in range(count or 0):
            handle = call(f"device {i}: nvmlDeviceGetHandleByIndex_v2",
                          lambda i=i: lib.handle_by_index(i))
            if handle is None:
                continue
            call(f"device {i}: nvmlDeviceGetIndex", lambda: lib.index(handle))
            uuid = call(f"device {i}: nvmlDeviceGetUUID", lambda: lib.uuid(handle))
            if uuid is not None:
                call(f"device {i}: nvmlDeviceGetHandleByUUID -> index",
                     lambda: lib.index(lib.handle_by_uuid(uuid)))
            call(f"device {i}: nvmlDeviceGetUtilizationRates (gpu %)",
                 lambda: lib.utilization(handle).gpu)
            call(f"device {i}: nvmlDeviceGetMemoryInfo_v2 (MiB used of total)",
                 lambda: _mib(lib.memory(handle)))
            call(f"device {i}: nvmlDeviceGetTemperature (C)", lambda: lib.temperature_c(handle))
            call(f"device {i}: nvmlDeviceGetPowerUsage (W)", lambda: lib.power_mw(handle) / 1000.0)
            _gpm(lib, handle, i)
    finally:
        lib.shutdown()
    if failures:
        print(f"\n{failures} NVML call(s) failed: the node exporter cannot serve this host")
        return 1
    if not count:
        print("\nNVML answered but sees no GPU on this host")
        return 1
    print(f"\nNVML answered every call the node exporter makes, on {count} device(s)")
    return 0


def _http_fetch(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def _kubectl_raw(path: str) -> str:
    return subprocess.run(
        ["kubectl", "get", "--raw", path], check=True, capture_output=True, text=True
    ).stdout


def main() -> int:
    """The runbook's probes against a cluster, from the environment."""
    exporter_url = os.environ.get("EXPORTER_URL", "http://localhost:9400/metrics")
    prom_url = os.environ.get("PROM_URL", "http://localhost:9090")
    metric = os.environ.get("METRIC", "tpu_test_tensorcore_avg")
    namespace = os.environ.get("NAMESPACE", "default")
    hpa_name = os.environ.get("HPA", "tpu-test")
    have_kubectl = shutil.which("kubectl") is not None
    results = diagnose(
        exporter_fetch=lambda: _http_fetch(exporter_url),
        prom_fetch=lambda: _http_fetch(f"{prom_url}/api/v1/query?query={quote(metric)}"),
        api_fetch=(
            (lambda: _kubectl_raw("/apis/custom.metrics.k8s.io/v1beta1"))
            if have_kubectl else None
        ),
        hpa_fetch=(
            (lambda: _kubectl_raw(
                f"/apis/autoscaling/v2/namespaces/{namespace}/horizontalpodautoscalers/{hpa_name}"
            ))
            if have_kubectl else None
        ),
        metric=metric,
        up_fetch=lambda: _http_fetch(f"{prom_url}/api/v1/query?query=up"),
    )
    broken = False
    for r in results:
        print(f"[{'ok ' if r.ok else 'FAIL'}] {r.name}: {r.detail}")
        broken = broken or not r.ok
    if broken:
        print(
            "\npipeline broken at the first FAILing joint above; fix it "
            "before looking further down the stack (each layer only consumes "
            "the one below)"
        )
    return 1 if broken else 0


def cli(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m k8s_gpu_hpa_tpu_torch.doctor")
    parser.add_argument("probe", nargs="?", choices=["nvml"],
                        help="nvml: probe this host's NVML instead of the cluster's joints")
    parser.add_argument("--library", default=nvml.DEFAULT_LIBRARY,
                        help="the NVML library to load (probe nvml)")
    args = parser.parse_args(argv)
    return probe_nvml(args.library) if args.probe == "nvml" else main()


if __name__ == "__main__":
    sys.exit(cli())
