"""The five older lints as registered passes, over the port's modules.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/legacy.py``.  The JAX package's
adapters load the scripts under ``tools/``, which import the JAX package, so
the port keeps its own copies of their lint bodies here, applied to its own
modules, with the scripts' messages:

- ``fault-registry``    <- tools/lint_faults.py, over the port's tests
  (``tests/test_torch_*.py`` and their ``NATURAL_SPECS`` tables)
- ``promql-parity``     <- tools/lint_promql_parity.py (the rule manifest of
  ``manifests.default_bundle()``)
- ``dashboard-parity``  <- tools/lint_promql_parity.py (the Grafana panels
  of ``deploy/grafana-dashboard.yaml``)
- ``trace-schema``      <- tools/lint_trace_schema.py --selfcheck
- ``rollup-probe``      <- tools/downsample_probe.py
"""

from __future__ import annotations

import ast
import json
import math
import tempfile
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.analysis import AnalysisPass, Finding, register
from k8s_gpu_hpa_tpu_torch.analysis.contracts import BUNDLE, configmap_data, read_surface

#: the rule manifest and the board the parity passes read
RULE_MANIFEST = BUNDLE + "tpu-test-prometheusrule.yaml"
DASHBOARD = "deploy/grafana-dashboard.yaml"

# ---- fault-registry ---------------------------------------------------------


def natural_spec_kinds(test_file: Path) -> set[str]:
    """The string keys of a test module's ``NATURAL_SPECS`` dict, read from
    its AST, so the lint sees the literal table and works even when the
    test module cannot import."""
    tree = ast.parse(test_file.read_text())
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == "NATURAL_SPECS" for t in targets):
            continue
        if isinstance(node.value, ast.Dict):
            return {
                k.value
                for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
    return set()


def lint_fault_kinds(tests_dir: Path) -> list[str]:
    """Every violation of the fault registry, as readable strings: each kind
    callable, documented in the chaos/faults.py docstring table, named by a
    port test, given a ``NATURAL_SPECS`` row (the inject, clear-twice and
    survive parametrization of tests/test_torch_chaos.py, and of
    tests/test_torch_evacuate.py for the kinds that need a region) and in
    the fuzzer's mutation pool, and the pool naming no dropped kind."""
    import k8s_gpu_hpa_tpu_torch.chaos.faults as faults_mod
    from k8s_gpu_hpa_tpu_torch.chaos.faults import FAULT_KINDS
    from k8s_gpu_hpa_tpu_torch.chaos.fuzz import MUTATION_FAULT_KINDS

    errors: list[str] = []
    docstring = faults_mod.__doc__ or ""
    tests = sorted(tests_dir.glob("test_torch_*.py"))
    blobs = [p.read_text() for p in tests]
    covered = set().union(*(natural_spec_kinds(p) for p in tests))
    for kind, injector in sorted(FAULT_KINDS.items()):
        if not callable(injector):
            errors.append(f"{kind}: registry entry is not callable ({injector!r})")
        if f"``{kind}``" not in docstring:
            errors.append(f"{kind}: not documented in the chaos/faults.py docstring table")
        if not any(kind in blob for blob in blobs):
            errors.append(f"{kind}: no file under tests/ references it")
        if kind not in covered:
            errors.append(
                f"{kind}: no NATURAL_SPECS row in tests/test_torch_*.py "
                "— excluded from the auto-covering injector parametrization"
            )
        if kind not in MUTATION_FAULT_KINDS:
            errors.append(
                f"{kind}: missing from the fuzzer's mutation pool "
                "(chaos/fuzz.py MUTATION_FAULT_KINDS) — the adversarial "
                "search can never schedule it"
            )
    for kind in sorted(set(MUTATION_FAULT_KINDS) - set(FAULT_KINDS)):
        errors.append(
            f"{kind}: in the fuzzer's mutation pool but not in FAULT_KINDS "
            "— stale pool entry"
        )
    return errors


# ---- promql-parity and dashboard-parity -------------------------------------


def _registry() -> dict[str, list]:
    """``record/<name>`` and ``alert/<name>`` -> the Exprs the closed loop
    evaluates under that name (a list: alert names legitimately repeat)."""
    from k8s_gpu_hpa_tpu_torch.manifests import shipped_rule_groups
    from k8s_gpu_hpa_tpu_torch.metrics.rules import shipped_alert_rules
    from k8s_gpu_hpa_tpu_torch.obs.slo import shipped_slo_alerts

    registry: dict[str, list] = {}
    for _, rules in shipped_rule_groups():
        for rule in rules:
            registry.setdefault(f"record/{rule.record}", []).append(rule.expr)
    for alert in shipped_alert_rules() + shipped_slo_alerts():
        registry.setdefault(f"alert/{alert.alert}", []).append(alert.expr)
    return registry


def lint_parity(manifest_text: str) -> list[str]:
    """Every parity violation of a PrometheusRule manifest: each ``expr:``
    must parse back to the AST the in-process registry evaluates under its
    name and be that AST's canonical rendering, and no rule may be
    one-sided (in the manifest or the registry alone)."""
    from k8s_gpu_hpa_tpu_torch.manifests import load_yaml
    from k8s_gpu_hpa_tpu_torch.metrics.promql import PromQLError, parse

    doc = load_yaml(manifest_text)
    registry = _registry()
    errors: list[str] = []
    for group in doc["spec"]["groups"]:
        for entry in group["rules"]:
            kind = "record" if "record" in entry else "alert"
            key = f"{kind}/{entry[kind]}"
            text = entry["expr"]
            candidates = registry.get(key)
            if not candidates:
                errors.append(
                    f"{key}: in the manifest but not in the in-process "
                    "registry (one-sided: only Prometheus would run it)"
                )
                continue
            try:
                tree = parse(text)
            except PromQLError as e:
                errors.append(f"{key}: manifest expr does not parse: {e}")
                continue
            if tree in candidates:
                candidates.remove(tree)  # matched: consume the registry copy
            else:
                errors.append(
                    f"{key}: manifest expr parses to a DIFFERENT AST than "
                    f"the registry evaluates:\n  manifest: {text}\n"
                    "  registry: " + " | ".join(e.promql() for e in candidates)
                )
                continue
            if tree.promql() != text:
                errors.append(
                    f"{key}: expr is not the canonical rendering "
                    f"({text!r} -> {tree.promql()!r})"
                )
    for key, leftovers in sorted(registry.items()):
        for expr in leftovers:
            errors.append(
                f"{key}: in the in-process registry but not in the manifest "
                f"(one-sided: only the simulator would run it): {expr.promql()}"
            )
    return errors


def lint_dashboard(dashboard_text: str) -> tuple[list[str], int]:
    """(violations, expression count) over every Grafana panel target: each
    must parse in the PromQL QUERY subset and be its canonical rendering."""
    from k8s_gpu_hpa_tpu_torch.metrics.promql import PromQLError, parse_query

    errors: list[str] = []
    count = 0
    for fname, blob in sorted(configmap_data(dashboard_text).items()):
        dash = json.loads(blob)
        for panel in dash.get("panels", []):
            for target in panel.get("targets", []):
                expr = target["expr"]
                where = (
                    f"dashboard {fname} panel {panel['id']} "
                    f"({panel['title']!r}) ref {target.get('refId', '?')}"
                )
                count += 1
                try:
                    tree = parse_query(expr)
                except PromQLError as e:
                    errors.append(f"{where}: expr does not parse: {e}")
                    continue
                if tree.promql() != expr:
                    errors.append(
                        f"{where}: expr is not the canonical rendering "
                        f"({expr!r} -> {tree.promql()!r})"
                    )
    return errors, count


# ---- trace-schema -------------------------------------------------------------


def lint_spans(spans: list) -> list[str]:
    """Every schema violation in ``spans``: attrs against SPAN_SCHEMA,
    unique ids, links that resolve in the list to an allowed kind, no span
    ending before it starts or linking to itself."""
    from k8s_gpu_hpa_tpu_torch.obs import SPAN_SCHEMA
    from k8s_gpu_hpa_tpu_torch.obs.schema import validate_span_fields

    errors: list[str] = []
    by_id: dict = {}
    for span in spans:
        if span.span_id in by_id:
            errors.append(f"span {span.span_id}: duplicate span id")
        by_id[span.span_id] = span
    for span in spans:
        try:
            validate_span_fields(span.kind, span.attrs, span_id=span.span_id)
        except ValueError as e:
            errors.append(str(e))
            continue
        if span.end < span.start:
            errors.append(
                f"span {span.span_id} ({span.kind}): end {span.end} before start {span.start}"
            )
        allowed = SPAN_SCHEMA[span.kind]["link_kinds"]
        for link in span.links:
            if link == span.span_id:
                errors.append(f"span {span.span_id} ({span.kind}): links to itself")
                continue
            target = by_id.get(link)
            if target is None:
                errors.append(f"span {span.span_id} ({span.kind}): link {link} not in file")
            elif target.kind not in allowed:
                errors.append(
                    f"span {span.span_id} ({span.kind}): link {link} is a "
                    f"{target.kind!r} span, schema allows {sorted(allowed)}"
                )
    return errors


def lint_exemplars(text: str, spans: list) -> list[str]:
    """Every broken exemplar link in a metrics exposition against a trace
    export: each bucket exemplar's trace_id and span_id must agree and
    resolve to a span of the export, and no ``# {`` trailer may be dropped
    by the parser."""
    from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text

    errors: list[str] = []
    by_id = {s.span_id: s for s in spans}
    seen = 0
    for fam in parse_text(text):
        for sample in fam.samples:
            ex = sample.exemplar
            if ex is None:
                continue
            seen += 1
            where = fam.name + sample.suffix
            if ex.trace_id != ex.span_id:
                errors.append(
                    f"{where}: exemplar trace_id {ex.trace_id} != span_id "
                    f"{ex.span_id} (single-process tracer: they must agree)"
                )
            if ex.span_id not in by_id:
                errors.append(
                    f"{where}: exemplar span_id {ex.span_id} resolves to no "
                    "span in the trace export"
                )
    trailers = sum(1 for line in text.splitlines() if " # {" in line)
    if trailers != seen:
        errors.append(
            f"{trailers - seen} exemplar trailer(s) present in the text but "
            "dropped by the parser (malformed labels/value)"
        )
    if seen == 0 and not errors:
        errors.append("exposition carries no exemplars at all")
    return errors


def trace_selfcheck() -> list[str]:
    """Run a short traced simulation with a load step that makes it scale,
    export it to JSONL, and lint the export's spans and the pipeline's
    self-metric exemplars against it: the live emitters against the
    schema.  Returns the violations (empty: the check passed)."""
    from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
    from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
    from k8s_gpu_hpa_tpu_torch.obs import Tracer, read_jsonl
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    clock = VirtualClock()
    tracer = Tracer(clock)
    cluster = SimCluster(clock, nodes=[("lint-node-0", 4), ("lint-node-1", 4)])
    dep = SimDeployment(
        cluster,
        "tpu-test",
        "tpu-test",
        load_fn=lambda t: 30.0 if t < 60.0 else 95.0,
        load_mode="shared",
    )
    cluster.add_deployment(dep, replicas=1)
    pipe = AutoscalingPipeline(cluster, dep, target_value=40.0, max_replicas=4, tracer=tracer)
    pipe.start()
    clock.advance(150.0)
    if not tracer.spans_of("scale_event"):
        return ["the scenario produced no scale_event span"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.jsonl"
        tracer.write_jsonl(path)
        try:
            exported = read_jsonl(path)
        except Exception as e:  # noqa: BLE001 — an unreadable line is a finding
            return [f"{path.name}: unparseable JSONL ({e})"]
    errors = lint_spans(exported) if exported else [f"{path.name}: no spans"]
    return errors + lint_exemplars(pipe.selfmetrics.exposition(), exported)


# ---- rollup-probe -------------------------------------------------------------

#: the probe DB: six virtual hours of eight 30 s-cadence series
PROBE_HOURS = 6.0
PROBE_SERIES = 8
PROBE_INTERVAL_S = 30.0


def build_probe_db():
    """A deterministic DB aged through the 5m/1h compactor: a quantized
    diurnal gauge per series with an occasional staleness NaN."""
    from k8s_gpu_hpa_tpu_torch.metrics.downsample import DownsamplePolicy
    from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    clock = VirtualClock()
    db = TimeSeriesDB(
        clock, retention=(PROBE_HOURS + 1.0) * 3600.0, downsample=DownsamplePolicy()
    )
    labels = [
        tuple(sorted({"job": "probe", "instance": f"p-{i:02d}"}.items()))
        for i in range(PROBE_SERIES)
    ]
    ts = 0.0
    for tick in range(int(PROBE_HOURS * 3600.0 / PROBE_INTERVAL_S)):
        ts += PROBE_INTERVAL_S
        clock.advance(PROBE_INTERVAL_S)
        for i, lab in enumerate(labels):
            value = 10.0 + i + round(math.sin(ts / 900.0) * 4.0) / 4.0
            if tick % 97 == 13 and i == 0:
                value = math.nan
            db.append("probe_duty_cycle", lab, value)
    return db


def rollup_probe() -> tuple[bool, str]:
    """The doctor's rollup-tier probe over the probe DB: (ok, the line
    ``tools/downsample_probe.py`` prints).  It fails when a tier holds no
    sealed bucket, when a rollup disagrees with the raw bucketed twin, or
    when no window could be verified."""
    from k8s_gpu_hpa_tpu_torch.doctor import diagnose
    from k8s_gpu_hpa_tpu_torch.metrics.downsample import downsample_selfcheck

    payload = json.dumps(downsample_selfcheck(build_probe_db(), ["probe_duty_cycle"]))
    probe = {r.name: r for r in diagnose(downsample_fetch=lambda: payload)}["L3 rollup tiers"]
    status = "ok" if probe.ok else "FAIL"
    return probe.ok, f"downsample_probe: [{status}] {probe.name}: {probe.detail}"


# ---- the passes -----------------------------------------------------------------


class FaultRegistryPass(AnalysisPass):
    name = "fault-registry"
    description = (
        "every chaos fault kind has an injector, a docstring row, and "
        "auto-covering test parametrization (the port's copy of tools/lint_faults.py)"
    )

    def run(self, root: Path) -> list[Finding]:
        return [
            self.finding(
                "fault-kind",
                "k8s_gpu_hpa_tpu_torch/chaos/faults.py",
                1,
                err.split(":", 1)[0],
                err,
            )
            for err in lint_fault_kinds(root / "tests")
        ]


class PromQLParityPass(AnalysisPass):
    name = "promql-parity"
    description = (
        "every shipped PrometheusRule expr parses back to the exact AST "
        "the closed loop evaluates (the port's copy of tools/lint_promql_parity.py)"
    )

    def run(self, root: Path) -> list[Finding]:
        text = read_surface(root, RULE_MANIFEST)
        return [
            self.finding("parity", RULE_MANIFEST, 1, err.split(":", 1)[0], err)
            for err in lint_parity(text)
        ]


class DashboardParityPass(AnalysisPass):
    name = "dashboard-parity"
    description = (
        "every Grafana panel target parses canonically in the PromQL "
        "QUERY subset (the port's copy of tools/lint_promql_parity.py)"
    )

    def run(self, root: Path) -> list[Finding]:
        errors, _count = lint_dashboard((root / DASHBOARD).read_text())
        return [
            self.finding("parity", DASHBOARD, 1, err.split(":", 1)[0], err)
            for err in errors
        ]


class TraceSchemaPass(AnalysisPass):
    name = "trace-schema"
    description = (
        "live span emitters match obs/schema.py and self-metric exemplars "
        "resolve into the trace export (the port's copy of "
        "tools/lint_trace_schema.py --selfcheck: runs a short traced sim in-process)"
    )

    def run(self, root: Path) -> list[Finding]:
        return [
            self.finding(
                "trace-schema",
                "k8s_gpu_hpa_tpu_torch/obs/trace.py",
                1,
                "selfcheck",
                f"selfcheck: {err}",
            )
            for err in trace_selfcheck()
        ]


class RollupProbePass(AnalysisPass):
    name = "rollup-probe"
    description = (
        "the 5m/1h rollup tiers hold sealed buckets and bit-agree with the "
        "raw bucketed twin (the port's copy of "
        "tools/downsample_probe.py: ages a deterministic "
        "DB through the compactor in-process)"
    )

    def run(self, root: Path) -> list[Finding]:
        ok, line = rollup_probe()
        if ok:
            return []
        return [
            self.finding(
                "rollup", "k8s_gpu_hpa_tpu_torch/metrics/downsample.py", 1, "probe", line
            )
        ]


register(FaultRegistryPass())
register(PromQLParityPass())
register(DashboardParityPass())
register(TraceSchemaPass())
register(RollupProbePass())
