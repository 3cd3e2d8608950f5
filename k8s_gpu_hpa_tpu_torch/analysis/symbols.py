"""Whole-program metric *producer* symbol table, built statically.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/symbols.py``, pointed at
``k8s_gpu_hpa_tpu_torch`` by its caller (``analysis/contracts.py``).

Every series the pipeline can emit is declared somewhere in source:

- ``MetricFamily(NAME, "gauge", ...)`` constructions (exporter families,
  pool metrics, self-metric counters, the sim's kube-state surrogate);
- ``Histogram(NAME, ...)`` constructions, which expand to the
  ``_bucket``/``_sum``/``_count`` series OpenMetrics renders;
- chip-table dicts (``CHIP_METRICS``-style: name -> ("gauge", help));
- ``db.append(NAME, labels, value)`` direct writes (the scraper's ``up``
  series, the SLO recorder's counters);
- recording-rule outputs: ``record="..."`` keyword arguments and the
  ``record: str = "..."`` defaults of the rule factories, plus the
  ``record:`` entries of the shipped PrometheusRule manifest;
- the native exporter's text exposition (``# TYPE name type`` lines in
  ``cpp/exporter/tpu_exporter.cc``, the source ``exporter/native.py``
  builds).

Names are resolved through module-level constants — including
``from X import Y`` chains and ``CONST + "_suffix"`` concatenations — via
a cross-module fixed point, so renaming a constant moves the producer with
it.  A bounded for-loop unroller resolves the
``for name, help, value in ((CONST_A, ...), (CONST_B, ...))`` idiom the
self-metrics exposition uses.  Label schemas are harvested from
``fam.add(value, key=...)`` call sites where the receiver traces back to a
family construction; a family whose labels were never statically visible
carries ``labels=None`` and is exempt from label checks (no guessing).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

#: Prometheus metric-name grammar, restricted to the lowercase form every
#: family in this repo uses (screams and dashes are config keys, not metrics)
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_:]*_[a-z0-9_:]*$")

HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")

_FAMILY_TYPES = ("gauge", "counter", "histogram", "untyped")

#: TSDB read methods whose first argument is a series name (consumers)
TSDB_READ_METHODS = (
    "instant_vector",
    "range_avg",
    "range_avg_bucketed",
    "rollup_range_avg",
    "latest",
)

_NATIVE_TYPE_RE = re.compile(
    r"#\s*TYPE\s+([a-z][a-z0-9_:]*)\s+(gauge|counter|histogram|untyped)"
)


@dataclass(frozen=True)
class Site:
    """One provenance point: where a producer or consumer was seen."""

    file: str  # repo-relative
    line: int
    kind: str


@dataclass
class ProducerFamily:
    """One metric family the program can emit, merged across sites."""

    name: str
    type: str  # gauge | counter | histogram | series | recorded
    sites: list[Site] = field(default_factory=list)
    #: observed exposition labels; None = never statically visible
    labels: set[str] | None = None

    def merge(self, type_: str, site: Site, labels: set[str] | None) -> None:
        self.sites.append(site)
        # a concrete type beats the placeholder "series"/"recorded" markers
        if self.type in ("series", "recorded") and type_ not in (
            "series",
            "recorded",
        ):
            self.type = type_
        if labels:
            self.labels = (self.labels or set()) | labels


@dataclass(frozen=True)
class Consumption:
    """One consumer reference: a series name some surface reads."""

    name: str
    file: str
    line: int
    surface: str  # expr | tsdb-read | manifest | dashboard | adapter | hpa | literal
    matcher_keys: frozenset = frozenset()
    usage: str = "plain"  # plain | rate | burn | quantile


class SymbolTable:
    """Producer families keyed by base name, with histogram expansion."""

    def __init__(self) -> None:
        self.families: dict[str, ProducerFamily] = {}

    def add(
        self,
        name: str,
        type_: str,
        site: Site,
        labels: set[str] | None = None,
    ) -> None:
        fam = self.families.get(name)
        if fam is None:
            self.families[name] = ProducerFamily(
                name, type_, [site], set(labels) if labels else None
            )
        else:
            fam.merge(type_, site, labels)

    def resolve_series(self, series: str) -> ProducerFamily | None:
        """The family producing ``series``: exact match, else the histogram
        whose ``_bucket``/``_sum``/``_count`` expansion it is."""
        fam = self.families.get(series)
        if fam is not None:
            return fam
        for suffix in HISTOGRAM_SUFFIXES:
            if series.endswith(suffix):
                base = self.families.get(series[: -len(suffix)])
                if base is not None and base.type == "histogram":
                    return base
        return None


# ---------------------------------------------------------------------------
# constant resolution
# ---------------------------------------------------------------------------


def _module_name(path: Path, root: Path) -> str:
    rel = path.relative_to(root).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ModuleIndex:
    """Cross-module string-constant table: ``module.NAME -> value``.

    Built in two phases — literal collection per module, then an import
    fixed point so re-exported constants resolve through chains."""

    def __init__(self) -> None:
        #: fully-qualified constant name -> string value
        self.constants: dict[str, str] = {}
        #: per-module import alias: (module, local) -> imported fullname
        self.imports: dict[tuple[str, str], str] = {}

    def build(self, trees: dict[str, ast.Module]) -> None:
        pending: list[tuple[str, str, ast.expr]] = []
        for mod, tree in trees.items():
            for node in tree.body:
                if isinstance(node, ast.ImportFrom) and node.level == 0:
                    for alias in node.names:
                        local = alias.asname or alias.name
                        self.imports[(mod, local)] = (
                            f"{node.module}.{alias.name}"
                        )
                elif isinstance(node, ast.Import):
                    for alias in node.names:
                        local = alias.asname or alias.name.split(".")[0]
                        self.imports[(mod, local)] = alias.name
                targets: list[ast.expr] = []
                value: ast.expr | None = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                if value is None:
                    continue
                for t in targets:
                    if isinstance(t, ast.Name):
                        pending.append((mod, t.id, value))
        # fixed point: module-level constants may chain through imports and
        # concatenations of other constants; three rounds cover every chain
        # in the tree (and any longer chain is not worth modelling)
        for _ in range(3):
            progress = False
            for mod, name, value in pending:
                full = f"{mod}.{name}"
                if full in self.constants:
                    continue
                resolved = self._resolve_literal(mod, value)
                if resolved is not None:
                    self.constants[full] = resolved
                    progress = True
            if not progress:
                break

    def _resolve_literal(self, mod: str, node: ast.expr) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.lookup(mod, node.id)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self._resolve_literal(mod, node.left)
            right = self._resolve_literal(mod, node.right)
            if left is not None and right is not None:
                return left + right
        return None

    def lookup(self, mod: str, name: str) -> str | None:
        full = self.imports.get((mod, name), f"{mod}.{name}")
        return self.constants.get(full)


class FileResolver:
    """Resolve an expression inside one module to its possible string
    values: module constants, imported constants, ``A + "_x"`` concats,
    and names multi-bound by unrolled literal for-loops."""

    #: cap on the candidate set a single name may carry — beyond this the
    #: binding is treated as dynamic (resolution refuses, no guessing)
    MAX_CANDIDATES = 64

    def __init__(self, mod: str, index: ModuleIndex, tree: ast.Module):
        self.mod = mod
        self.index = index
        #: scope-insensitive local bindings: name -> candidate string values
        self.local: dict[str, set[str]] = {}
        self._collect_local(tree)

    def _collect_local(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    vals = self.resolve(node.value, _local=False)
                    if vals:
                        self.local.setdefault(t.id, set()).update(vals)
            elif isinstance(node, ast.For):
                self._unroll_for(node)

    def _unroll_for(self, node: ast.For) -> None:
        """``for a, b, c in ((X, "…", v), (Y, "…", v)): …`` — bind each
        target name to the union of its column's resolvable values."""
        if not isinstance(node.iter, (ast.Tuple, ast.List)):
            return
        rows = [
            r for r in node.iter.elts if isinstance(r, (ast.Tuple, ast.List))
        ]
        if not rows:
            return
        targets: list[ast.expr]
        if isinstance(node.target, (ast.Tuple, ast.List)):
            targets = list(node.target.elts)
        else:
            targets = [node.target]
        for i, t in enumerate(targets):
            if not isinstance(t, ast.Name):
                continue
            for row in rows:
                if isinstance(node.target, (ast.Tuple, ast.List)):
                    if i >= len(row.elts):
                        continue
                    cell = row.elts[i]
                else:
                    cell = row
                vals = self.resolve(cell, _local=False)
                if vals:
                    self.local.setdefault(t.id, set()).update(vals)

    def resolve(self, node: ast.expr, _local: bool = True) -> set[str]:
        """Every string value ``node`` can statically denote (empty set =
        not resolvable; treat as dynamic and skip)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return {node.value}
        if isinstance(node, ast.Name):
            out: set[str] = set()
            mod_val = self.index.lookup(self.mod, node.id)
            if mod_val is not None:
                out.add(mod_val)
            if _local and node.id in self.local:
                out |= self.local[node.id]
            if len(out) > self.MAX_CANDIDATES:
                return set()
            return out
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            # schema.TPU_DUTY_CYCLE style: resolve via the imported module
            base = self.index.imports.get(
                (self.mod, node.value.id), node.value.id
            )
            val = self.index.constants.get(f"{base}.{node.attr}")
            return {val} if val is not None else set()
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            lefts = self.resolve(node.left, _local=_local)
            rights = self.resolve(node.right, _local=_local)
            out = {
                left + right for left in lefts for right in rights
            }
            return out if len(out) <= self.MAX_CANDIDATES else set()
        return set()


# ---------------------------------------------------------------------------
# python-source scan: producers and in-code consumers
# ---------------------------------------------------------------------------


def _call_name(func: ast.expr) -> str:
    """The final identifier of a call target: ``MetricFamily``,
    ``schema.Histogram`` -> ``Histogram``, ``db.append`` -> ``append``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _arg(call: ast.Call, pos: int, kw: str) -> ast.expr | None:
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    if len(call.args) > pos:
        return call.args[pos]
    return None


def _dict_keys(resolver: FileResolver, node: ast.expr | None) -> frozenset:
    if not isinstance(node, ast.Dict):
        return frozenset()
    keys: set[str] = set()
    for k in node.keys:
        if k is None:
            continue
        for v in resolver.resolve(k):
            keys.add(v)
    return frozenset(keys)


@dataclass
class PyScanResult:
    producers: list[tuple[str, str, Site, set | None]] = field(
        default_factory=list
    )
    consumptions: list[Consumption] = field(default_factory=list)


def scan_python_file(
    path: Path, root: Path, index: ModuleIndex, tree: ast.Module
) -> PyScanResult:
    """Extract every producer declaration and in-code consumer reference
    from one module (see the module docstring for the idiom catalogue)."""
    mod = _module_name(path, root)
    rel = str(path.relative_to(root))
    resolver = FileResolver(mod, index, tree)
    out = PyScanResult()

    # family-variable bindings for label harvesting: var -> family names
    fam_vars: dict[str, set[str]] = {}
    fam_labels: dict[str, set[str]] = {}

    for node in ast.walk(tree):
        # chip-table dicts: {NAME: ("gauge", help), ...} at any level
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value if not isinstance(node, ast.Assign) else node.value
            if isinstance(value, ast.Dict) and value.keys:
                entries = []
                for k, v in zip(value.keys, value.values):
                    if k is None or not isinstance(v, (ast.Tuple, ast.List)):
                        entries = []
                        break
                    if not v.elts or not (
                        isinstance(v.elts[0], ast.Constant)
                        and v.elts[0].value in _FAMILY_TYPES
                    ):
                        entries = []
                        break
                    names = resolver.resolve(k)
                    if len(names) != 1:
                        entries = []
                        break
                    entries.append((next(iter(names)), v.elts[0].value))
                if entries and all(
                    METRIC_NAME_RE.match(n) for n, _ in entries
                ):
                    for name, type_ in entries:
                        out.producers.append(
                            (
                                name,
                                type_,
                                Site(rel, node.lineno, "chip-table"),
                                None,
                            )
                        )
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            v = node.value
            if isinstance(t, ast.Name) and isinstance(v, ast.Call):
                cname = _call_name(v.func)
                if cname in ("MetricFamily", "Histogram"):
                    names = resolver.resolve(_arg(v, 0, "name") or ast.Constant(value=None))
                    if names:
                        fam_vars.setdefault(t.id, set()).update(names)
        if isinstance(node, ast.FunctionDef):
            # record: str = "..." factory defaults are recorded-series
            # producers even when never overridden at a call site
            args = node.args
            all_args = args.posonlyargs + args.args + args.kwonlyargs
            defaults = (
                [None] * (len(args.posonlyargs) + len(args.args) - len(args.defaults))
                + list(args.defaults)
                + list(args.kw_defaults)
            )
            for a, d in zip(all_args, defaults):
                if (
                    a.arg == "record"
                    and isinstance(d, ast.Constant)
                    and isinstance(d.value, str)
                ):
                    out.producers.append(
                        (
                            d.value,
                            "recorded",
                            Site(rel, node.lineno, "record-default"),
                            None,
                        )
                    )
        if not isinstance(node, ast.Call):
            continue
        call = node
        cname = _call_name(call.func)
        line = call.lineno

        # record="..." at any call site (RecordingRule itself or a factory
        # override) declares a recorded output series
        for k in call.keywords:
            if k.arg == "record":
                for name in resolver.resolve(k.value):
                    if METRIC_NAME_RE.match(name):
                        out.producers.append(
                            (
                                name,
                                "recorded",
                                Site(rel, line, "record-kwarg"),
                                None,
                            )
                        )

        if cname == "MetricFamily":
            names = resolver.resolve(_arg(call, 0, "name") or ast.Constant(value=None))
            type_node = _arg(call, 1, "type")
            types = resolver.resolve(type_node) if type_node is not None else set()
            type_ = next(iter(types)) if len(types) == 1 else "untyped"
            for name in names:
                if METRIC_NAME_RE.match(name):
                    out.producers.append(
                        (name, type_, Site(rel, line, "family"), None)
                    )
        elif cname == "Histogram":
            arg0 = _arg(call, 0, "name")
            if arg0 is not None:
                for name in resolver.resolve(arg0):
                    if METRIC_NAME_RE.match(name):
                        out.producers.append(
                            (
                                name,
                                "histogram",
                                Site(rel, line, "histogram"),
                                {"le"},
                            )
                        )
        elif cname == "append" and isinstance(call.func, ast.Attribute):
            # TimeSeriesDB.append(name, labels, value): require the arity so
            # list.append(x) never matches
            if len(call.args) >= 3:
                for name in resolver.resolve(call.args[0]):
                    if METRIC_NAME_RE.match(name) or name == "up":
                        out.producers.append(
                            (name, "series", Site(rel, line, "append"), None)
                        )
        elif cname == "add" and isinstance(call.func, ast.Attribute):
            recv = call.func.value
            if isinstance(recv, ast.Name) and recv.id in fam_vars:
                kws = {k.arg for k in call.keywords if k.arg}
                for fam in fam_vars[recv.id]:
                    fam_labels.setdefault(fam, set()).update(kws)

        # ---- consumers ----------------------------------------------------
        if cname in ("Select", "QSelect"):
            arg0 = _arg(call, 0, "name")
            if arg0 is not None:
                keys = _dict_keys(resolver, _arg(call, 1, "matchers"))
                for name in resolver.resolve(arg0):
                    if METRIC_NAME_RE.match(name) or name == "up":
                        out.consumptions.append(
                            Consumption(name, rel, line, "expr", keys)
                        )
        elif cname == "AvgOverTime":
            arg0 = _arg(call, 0, "name")
            if arg0 is not None:
                keys = _dict_keys(resolver, _arg(call, 2, "matchers"))
                for name in resolver.resolve(arg0):
                    if METRIC_NAME_RE.match(name) or name == "up":
                        out.consumptions.append(
                            Consumption(name, rel, line, "expr", keys)
                        )
        elif cname == "HistogramQuantile":
            arg1 = _arg(call, 1, "name")
            if arg1 is not None:
                for name in resolver.resolve(arg1):
                    if METRIC_NAME_RE.match(name):
                        out.consumptions.append(
                            Consumption(
                                name + "_bucket",
                                rel,
                                line,
                                "expr",
                                usage="quantile",
                            )
                        )
        elif cname == "BurnRate":
            for pos, kw in ((0, "good_name"), (1, "total_name")):
                node_ = _arg(call, pos, kw)
                if node_ is None:
                    continue
                for name in resolver.resolve(node_):
                    if METRIC_NAME_RE.match(name) or name == "up":
                        out.consumptions.append(
                            Consumption(name, rel, line, "expr", usage="burn")
                        )
        elif cname == "SLODefinition":
            for kw in ("good_series", "total_series"):
                node_ = _arg(call, 999, kw)
                if node_ is None:
                    continue
                for name in resolver.resolve(node_):
                    if name and (METRIC_NAME_RE.match(name) or name == "up"):
                        out.consumptions.append(
                            Consumption(name, rel, line, "expr")
                        )
        elif cname in TSDB_READ_METHODS and isinstance(
            call.func, ast.Attribute
        ):
            if call.args:
                keys = frozenset()
                m = _arg(call, 1, "matchers")
                if m is not None:
                    keys = _dict_keys(resolver, m)
                for name in resolver.resolve(call.args[0]):
                    if METRIC_NAME_RE.match(name) or name == "up":
                        out.consumptions.append(
                            Consumption(name, rel, line, "tsdb-read", keys)
                        )
        elif cname in ("adapter_rule", "external_rule"):
            if call.args:
                for name in resolver.resolve(call.args[0]):
                    if METRIC_NAME_RE.match(name):
                        out.consumptions.append(
                            Consumption(name, rel, line, "adapter")
                        )

    # fold harvested labels back into this file's family producers
    folded = []
    for name, type_, site, labels in out.producers:
        harvested = fam_labels.get(name)
        if harvested:
            labels = (labels or set()) | harvested
        folded.append((name, type_, site, labels))
    out.producers = folded
    return out


# ---------------------------------------------------------------------------
# whole-tree builders
# ---------------------------------------------------------------------------


def parse_package(
    root: Path, package_roots: tuple[str, ...]
) -> dict[str, tuple[Path, ast.Module]]:
    """Parse every .py under the given roots (files or directories),
    keyed by dotted module name."""
    trees: dict[str, tuple[Path, ast.Module]] = {}
    for entry in package_roots:
        base = root / entry
        paths = sorted(base.rglob("*.py")) if base.is_dir() else [base]
        for path in paths:
            if "__pycache__" in path.parts:
                continue
            try:
                tree = ast.parse(path.read_text())
            except SyntaxError:
                continue
            trees[_module_name(path, root)] = (path, tree)
    return trees


def build_symbol_table(
    root: Path, package_roots: tuple[str, ...], native_sources: tuple[str, ...]
) -> tuple[SymbolTable, list[Consumption]]:
    """Scan the python package(s) and native sources; return the producer
    table plus every in-code consumption found along the way."""
    trees = parse_package(root, package_roots)
    index = ModuleIndex()
    index.build({mod: tree for mod, (_, tree) in trees.items()})
    table = SymbolTable()
    consumptions: list[Consumption] = []
    for mod, (path, tree) in sorted(trees.items()):
        result = scan_python_file(path, root, index, tree)
        for name, type_, site, labels in result.producers:
            table.add(name, type_, site, labels)
        consumptions.extend(result.consumptions)
    for entry in native_sources:
        path = root / entry
        if not path.exists():
            continue
        rel = str(path.relative_to(root))
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            m = _NATIVE_TYPE_RE.search(line)
            if m is not None:
                table.add(m.group(1), m.group(2), Site(rel, lineno, "native"))
    return table, consumptions
