"""The metrics-contract pass: every consumed series must have a producer.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/contracts.py``, over the port's
own surfaces.  A dangling metric name in a rule, dashboard panel, adapter
seriesQuery, HPA manifest or doctor probe fails *silently* at runtime (an
empty instant vector, a panel showing "No data", an HPA stuck on
``FailedGetPodsMetric``).  This pass makes it fail at lint time instead,
the way ``promtool check`` keeps a real Prometheus honest:

- **producers** come from the static symbol table (:mod:`.symbols`):
  exporter families, pool metrics, self-metric histograms, recording-rule
  outputs, SLO counters, the native exporter's TYPE lines;
- **consumers** come from every surface that names a series: ``Expr``
  constructions in package code, TSDB reads with literal names, the
  PrometheusRule parsed with :mod:`..metrics.promql`, Grafana panel
  targets parsed in QUERY mode, adapter ``seriesQuery`` strings, HPA
  manifest metric names, and metric-shaped literals in the curated
  operator surfaces (doctor, the simulate CLI, the trials);
- **checks**: dangling consumer, orphan producer, label-set mismatch
  (only when the producer's label schema was statically visible), and
  type misuse: ``rate()``/``increase()``/``BurnRate`` over a gauge,
  ``histogram_quantile`` over a non-histogram family.

The port commits no manifests: ``manifests.default_bundle()`` renders them
(``gen-manifests``), so a surface named ``manifests:<file>`` is that file of
the bundle, rendered in memory with ``manifests.to_yaml`` and read back with
the port's own reader.  The Grafana board is the committed
``deploy/grafana-dashboard.yaml``, read as a data file: the port ships no
board of its own and its families carry the same names.

Recorded series get their output label schema from the top-level
``by(...)`` aggregation of their manifest expression, so an adapter
``seriesQuery`` matching on a label the recording rule aggregates away is
caught statically.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.analysis import AnalysisPass, Finding, register
from k8s_gpu_hpa_tpu_torch.analysis.symbols import (
    Consumption,
    METRIC_NAME_RE,
    SymbolTable,
    build_symbol_table,
)
from k8s_gpu_hpa_tpu_torch.metrics import promql
from k8s_gpu_hpa_tpu_torch.metrics.promql import (
    Increase,
    PromQLError,
    QHistogramQuantile,
    QSelect,
    Rate,
)
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    AggregateBy,
    AvgOverTime,
    BurnRate,
    Expr,
    HistogramQuantile,
    MaxBy,
    Select,
)

#: literal prefixes that mark a string in the curated surfaces (doctor,
#: simulate, trial) as a metric reference even without full context.
#: Narrow on purpose: ``slo_``-shaped strings are mostly report-row keys
#: and rung names, and the real SLO counters resolve through the producer
#: table anyway.
CURATED_PREFIXES = ("tpu_", "kube_", "quantum_operator_", "fleet_")


#: prefix of a surface that is a file of ``manifests.default_bundle()``
BUNDLE = "manifests:"


@dataclass
class ContractConfig:
    """Scan surfaces, as repo-relative paths or ``manifests:<file>`` bundle
    files; tests point these at golden fixture trees, the default is the
    port's tree."""

    package_roots: tuple[str, ...] = ("k8s_gpu_hpa_tpu_torch",)
    native_sources: tuple[str, ...] = ("cpp/exporter/tpu_exporter.cc",)
    rule_manifests: tuple[str, ...] = (BUNDLE + "tpu-test-prometheusrule.yaml",)
    dashboards: tuple[str, ...] = ("deploy/grafana-dashboard.yaml",)
    adapter_values: tuple[str, ...] = (BUNDLE + "prometheus-adapter-values.yaml",)
    hpa_manifests: tuple[str, ...] = (
        BUNDLE + "tpu-test-hpa.yaml",
        BUNDLE + "tpu-test-hbm-hpa.yaml",
        BUNDLE + "tpu-test-external-hpa.yaml",
        BUNDLE + "tpu-test-multihost-hpa.yaml",
        BUNDLE + "tpu-serve-hpa.yaml",
        BUNDLE + "tpu-train-hpa.yaml",
    )
    curated: tuple[str, ...] = (
        "k8s_gpu_hpa_tpu_torch/doctor.py",
        "k8s_gpu_hpa_tpu_torch/simulate.py",
        "k8s_gpu_hpa_tpu_torch/trial.py",
    )


def read_surface(root: Path, rel: str) -> str | None:
    """The text of a scan surface: a ``manifests:<file>`` of the rendered
    bundle, or a file under ``root``; None when it does not exist."""
    if rel.startswith(BUNDLE):
        from k8s_gpu_hpa_tpu_torch import manifests

        docs = manifests.default_bundle().get(rel[len(BUNDLE):])
        return None if docs is None else manifests.to_yaml(docs)
    path = root / rel
    return path.read_text() if path.exists() else None


def configmap_data(text: str) -> dict[str, str]:
    """The ``data:`` entries of a ConfigMap whose values are literal block
    scalars (``key: |``), the shape of the Grafana board's file, read
    without a YAML library: each value is its block's lines with the
    block's indentation removed, ending in one newline (YAML's clip)."""
    lines = text.splitlines()
    data: dict[str, str] = {}
    i = next((n + 1 for n, line in enumerate(lines) if line.rstrip() == "data:"), len(lines))
    while i < len(lines):
        line = lines[i]
        m = re.match(r"^(\s+)([^\s:#][^:]*):\s*\|\s*$", line)
        if not line.strip() or line.lstrip().startswith("#"):
            i += 1
            continue
        if not line.startswith(" "):
            break
        i += 1
        if m is None:
            continue
        key_indent = len(m.group(1))
        block: list[str] = []
        indent = None
        while i < len(lines):
            body = lines[i]
            if body.strip():
                lead = len(body) - len(body.lstrip(" "))
                if lead <= key_indent:
                    break
                indent = lead if indent is None else indent
            block.append(body[indent:] if indent is not None and body.strip() else "")
            i += 1
        while block and not block[-1]:
            block.pop()
        data[m.group(2).strip()] = "\n".join(block) + "\n"
    return data


# ---------------------------------------------------------------------------
# expression walking
# ---------------------------------------------------------------------------


def iter_expr_consumptions(
    expr: Expr, file: str, line: int, surface: str, usage: str = "plain"
):
    """Yield a :class:`Consumption` for every series an Expr reads, with
    the usage context (rate/burn/quantile) type checks need."""
    if isinstance(expr, (Rate, Increase)):
        yield from iter_expr_consumptions(expr.child, file, line, surface, "rate")
        return
    if isinstance(expr, BurnRate):
        yield Consumption(
            expr.good_name,
            file,
            line,
            surface,
            frozenset(expr.good_matchers),
            "burn",
        )
        yield Consumption(
            expr.total_name,
            file,
            line,
            surface,
            frozenset(expr.total_matchers),
            "burn",
        )
        return
    if isinstance(expr, HistogramQuantile):
        yield Consumption(
            expr.name + "_bucket",
            file,
            line,
            surface,
            frozenset(expr.matchers),
            "quantile",
        )
        return
    if isinstance(expr, QHistogramQuantile):
        yield from iter_expr_consumptions(
            expr.child, file, line, surface, "quantile-child"
        )
        return
    if isinstance(expr, Select):
        yield Consumption(
            expr.name, file, line, surface, frozenset(expr.matchers), usage
        )
        return
    if isinstance(expr, QSelect):
        yield Consumption(
            expr.name,
            file,
            line,
            surface,
            frozenset(k for k, _, _ in expr.matchers),
            usage,
        )
        return
    if isinstance(expr, AvgOverTime):
        yield Consumption(
            expr.name, file, line, surface, frozenset(expr.matchers), usage
        )
        return
    # generic: recurse into every Expr-valued dataclass field
    if dataclasses.is_dataclass(expr):
        for f in dataclasses.fields(expr):
            v = getattr(expr, f.name)
            if isinstance(v, Expr):
                yield from iter_expr_consumptions(v, file, line, surface, usage)
            elif isinstance(v, (tuple, list)):
                for item in v:
                    if isinstance(item, Expr):
                        yield from iter_expr_consumptions(
                            item, file, line, surface, usage
                        )
    else:  # pragma: no cover - future node shapes
        for name in expr.input_names():
            yield Consumption(name, file, line, surface, frozenset(), usage)


def _record_output_labels(expr: Expr) -> set[str] | None:
    """The label schema a recording rule's output series carries, when it
    is statically clear: a top-level ``by(...)`` aggregation keeps exactly
    its keys.  Anything else (joins, scalar aggregates) returns None —
    unknown, exempt from label checks."""
    if isinstance(expr, MaxBy):
        return set(expr.keys)
    if isinstance(expr, AggregateBy):
        return set(expr.keys)
    return None


def _find_line(text_lines: list[str], needle: str, start: int = 0) -> int:
    # the rendered bundle writes strings double-quoted, JSON-escaped
    for probe in (needle, json.dumps(needle)[1:-1]):
        for i in range(start, len(text_lines)):
            if probe in text_lines[i]:
                return i + 1
    return 1


# ---------------------------------------------------------------------------
# manifest surfaces
# ---------------------------------------------------------------------------


def scan_rule_manifest(
    root: Path, rel: str, table: SymbolTable
) -> tuple[list[Consumption], list[str]]:
    """PrometheusRule: ``expr:`` strings are consumers (parsed to ASTs),
    ``record:`` names are producers (type "recorded", labels from the
    top-level by-aggregation).  Unparseable exprs are skipped — the
    promql-parity pass owns reporting those."""
    from k8s_gpu_hpa_tpu_torch.manifests import load_yaml

    consumptions: list[Consumption] = []
    errors: list[str] = []
    text = read_surface(root, rel)
    if text is None:
        return consumptions, errors
    text_lines = text.splitlines()
    doc = load_yaml(text)
    cursor = 0
    for group in doc.get("spec", {}).get("groups", []):
        for entry in group.get("rules", []):
            expr_text = entry.get("expr", "")
            needle = expr_text.splitlines()[0][:60] if expr_text else ""
            line = _find_line(text_lines, needle, cursor) if needle else 1
            cursor = max(cursor, line - 1)
            try:
                ast_expr = promql.parse(expr_text)
            except PromQLError:
                continue
            consumptions.extend(
                iter_expr_consumptions(ast_expr, rel, line, "manifest")
            )
            if "record" in entry:
                from k8s_gpu_hpa_tpu_torch.analysis.symbols import Site

                table.add(
                    entry["record"],
                    "recorded",
                    Site(rel, line, "manifest-record"),
                    _record_output_labels(ast_expr),
                )
    return consumptions, errors


def scan_dashboard(root: Path, rel: str) -> list[Consumption]:
    """Grafana ConfigMap: every panel target expr, parsed in QUERY mode.
    Parse failures are the dashboard-parity pass's findings, not ours."""
    out: list[Consumption] = []
    text = read_surface(root, rel)
    if text is None:
        return out
    text_lines = text.splitlines()
    for _, blob in sorted(configmap_data(text).items()):
        try:
            dash = json.loads(blob)
        except (TypeError, json.JSONDecodeError):
            continue
        for panel in dash.get("panels", []):
            for target in panel.get("targets", []):
                expr_text = target.get("expr", "")
                if not expr_text:
                    continue
                try:
                    ast_expr = promql.parse_query(expr_text)
                except PromQLError:
                    continue
                # the ConfigMap embeds JSON with escaped quotes; locate by
                # a matcher-free fragment of the expression
                needle = expr_text.split("{")[0].split("(")[-1][:40]
                line = _find_line(text_lines, needle) if needle else 1
                out.extend(
                    iter_expr_consumptions(ast_expr, rel, line, "dashboard")
                )
    return out


_SERIES_QUERY_RE = re.compile(
    r"""seriesQuery:\s*['"]([A-Za-z_:][A-Za-z0-9_:]*)\{([^}]*)\}"""
)
_MATCHER_KEY_RE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:!=|=~|!~|=)")


def scan_adapter_values(root: Path, rel: str) -> list[Consumption]:
    """prometheus-adapter values: the series each seriesQuery discovers,
    with its matcher label keys."""
    out: list[Consumption] = []
    text = read_surface(root, rel)
    if text is None:
        return out
    for lineno, line in enumerate(text.splitlines(), 1):
        m = _SERIES_QUERY_RE.search(line)
        if m is None:
            continue
        keys = frozenset(_MATCHER_KEY_RE.findall(m.group(2)))
        out.append(Consumption(m.group(1), rel, lineno, "adapter", keys))
    return out


_HPA_METRIC_RE = re.compile(r"^\s+name:\s+([a-z][a-z0-9_:]*_[a-z0-9_:]*)\s*$")


def scan_hpa_manifest(root: Path, rel: str) -> list[Consumption]:
    """HPA specs: Pods/External metric names (underscore-shaped ``name:``
    values; resource metrics like ``cpu`` don't match the grammar)."""
    out: list[Consumption] = []
    text = read_surface(root, rel)
    if text is None:
        return out
    for lineno, line in enumerate(text.splitlines(), 1):
        m = _HPA_METRIC_RE.match(line)
        if m is not None:
            out.append(Consumption(m.group(1), rel, lineno, "hpa"))
    return out


def scan_curated_literals(root: Path, rel: str, table: SymbolTable) -> list[Consumption]:
    """Doctor/CLI/trial surfaces: any string literal that either names a
    known producer (credits consumption, so the orphan check sees doctor
    probes) or carries an unmistakable metric prefix (catches danglers)."""
    import ast as pyast

    path = root / rel
    out: list[Consumption] = []
    if not path.exists():
        return out
    try:
        tree = pyast.parse(path.read_text())
    except SyntaxError:
        return out
    for node in pyast.walk(tree):
        if not (isinstance(node, pyast.Constant) and isinstance(node.value, str)):
            continue
        value = node.value
        if not METRIC_NAME_RE.match(value):
            continue
        if table.resolve_series(value) is not None or value.startswith(
            CURATED_PREFIXES
        ):
            out.append(
                Consumption(value, rel, node.lineno, "literal")
            )
    return out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


class MetricsContractPass(AnalysisPass):
    name = "metrics-contract"
    description = (
        "every consumed series resolves to a statically discovered "
        "producer; no orphan families, label or type misuse"
    )

    def __init__(self, config: ContractConfig | None = None):
        self.config = config or ContractConfig()

    def run(self, root: Path) -> list[Finding]:
        cfg = self.config
        table, consumptions = build_symbol_table(
            root, cfg.package_roots, cfg.native_sources
        )
        for rel in cfg.rule_manifests:
            cons, _ = scan_rule_manifest(root, rel, table)
            consumptions.extend(cons)
        for rel in cfg.dashboards:
            consumptions.extend(scan_dashboard(root, rel))
        for rel in cfg.adapter_values:
            consumptions.extend(scan_adapter_values(root, rel))
        for rel in cfg.hpa_manifests:
            consumptions.extend(scan_hpa_manifest(root, rel))
        for rel in cfg.curated:
            consumptions.extend(scan_curated_literals(root, rel, table))
        return self.check(table, consumptions)

    def check(
        self, table: SymbolTable, consumptions: list[Consumption]
    ) -> list[Finding]:
        findings: list[Finding] = []
        consumed_families: set[str] = set()
        seen_dangling: set[tuple[str, str, int]] = set()
        for c in consumptions:
            fam = table.resolve_series(c.name)
            if fam is None:
                key = (c.name, c.file, c.line)
                if key not in seen_dangling:
                    seen_dangling.add(key)
                    findings.append(
                        self.finding(
                            "dangling-consumer",
                            c.file,
                            c.line,
                            c.name,
                            f"{c.surface} reads series {c.name!r} but no "
                            "producer declares it — the read will be "
                            "silently empty at runtime",
                        )
                    )
                continue
            consumed_families.add(fam.name)
            findings.extend(self._check_types(c, fam))
            findings.extend(self._check_labels(c, fam))
        for name, fam in sorted(table.families.items()):
            if name in consumed_families:
                continue
            site = fam.sites[0]
            findings.append(
                self.finding(
                    "orphan-producer",
                    site.file,
                    site.line,
                    name,
                    f"family {name!r} ({fam.type}) is produced but no rule, "
                    "dashboard, probe, or manifest consumes it — dead "
                    "telemetry or a missing panel",
                )
            )
        return findings

    def _check_types(self, c: Consumption, fam) -> list[Finding]:
        out: list[Finding] = []
        histogram_series = fam.type == "histogram" and c.name != fam.name
        if c.usage == "rate" and fam.type == "gauge":
            out.append(
                self.finding(
                    "type-misuse",
                    c.file,
                    c.line,
                    c.name,
                    f"rate()/increase() over {c.name!r}, which is declared a "
                    "gauge — counter semantics over last-value data",
                )
            )
        if c.usage == "burn" and fam.type == "gauge" and not histogram_series:
            out.append(
                self.finding(
                    "type-misuse",
                    c.file,
                    c.line,
                    c.name,
                    f"BurnRate counts increase() over {c.name!r}, which is "
                    "declared a gauge — burn math needs cumulative counters",
                )
            )
        if c.usage in ("quantile", "quantile-child"):
            if c.name.endswith("_bucket") and fam.type != "histogram":
                out.append(
                    self.finding(
                        "type-misuse",
                        c.file,
                        c.line,
                        c.name,
                        f"histogram_quantile over {c.name!r} but "
                        f"{fam.name!r} is declared {fam.type}, not a "
                        "histogram",
                    )
                )
        return out

    def _check_labels(self, c: Consumption, fam) -> list[Finding]:
        if not c.matcher_keys or fam.labels is None:
            return []
        schema = set(fam.labels)
        if fam.type == "histogram":
            schema.add("le")
        missing = sorted(k for k in c.matcher_keys if k not in schema)
        if not missing:
            return []
        return [
            self.finding(
                "label-mismatch",
                c.file,
                c.line,
                c.name,
                f"matcher label(s) {', '.join(missing)} on {c.name!r} are "
                f"not in the producer's schema {{{', '.join(sorted(schema))}}}"
                " — the selector can never match",
            )
        ]


register(MetricsContractPass())
