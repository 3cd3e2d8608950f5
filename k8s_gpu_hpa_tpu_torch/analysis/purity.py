"""The sim-purity pass: simulation hot paths must stay deterministic.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/purity.py``, scoped to the port's
simulation core.

The whole repo's evidence model rests on replay: a drill, a bench rung, or
a WAL recovery re-runs the same virtual timeline and must reach the same
bytes.  That breaks the moment sim-scope code reads the wall clock, draws
from the process-global RNG, or spawns ambient threads:

- **wall-clock**: ``time.time()``/``time_ns()``, ``datetime.now()``/
  ``utcnow()``/``today()``, ``date.today()`` — virtual time must come from
  ``utils/clock.py``; ``time.sleep()`` blocks real time inside a virtual
  timeline.  ``time.perf_counter`` is deliberately allowed: it measures
  *durations* of the simulator itself (self-latency histograms), never a
  timestamp that lands in the timeline.
- **unseeded-random**: module-level ``random.*`` draws share global state
  across the process — one extra call anywhere reorders every later draw.
  ``random.Random(seed)`` instances are allowed; ``random.Random()`` with
  no seed is not.
- **ambient-threading**: ``threading.Thread``/``Timer`` and executor pools
  introduce scheduling nondeterminism.  Locks are fine (deterministic
  under a single thread); a thread-construct call site is only tolerated
  when a structured :class:`~.concurrency.ConcurrencyContract` declares
  the boundary, and the concurrency passes then *verify* that contract
  (no blanket allowlist entry excuses a thread).

Scope is the simulation core of ``k8s_gpu_hpa_tpu_torch/`` (``metrics/``,
``control/``, ``chaos/``, ``obs/``, ``utils/``, ``simulate.py``), not the
production workload generators (``loadgen/``, ``models/``, ``exporter/``,
``ops/``), which run against real hardware and real clocks by design.

Every exemption is an :class:`~.allowlist.AllowEntry` keyed
``<file>:<qualified call>`` with a one-line justification, and a stale
entry (the call it excused is gone) is itself a finding.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.analysis import AnalysisPass, Finding, register

#: fully-qualified call -> (category, what to do instead)
FORBIDDEN_CALLS: dict[str, tuple[str, str]] = {
    "time.time": ("wall-clock", "read the injected Clock (utils/clock.py)"),
    "time.time_ns": ("wall-clock", "read the injected Clock (utils/clock.py)"),
    "time.sleep": (
        "wall-clock",
        "advance the VirtualClock; real sleeps stall the virtual timeline",
    ),
    "datetime.datetime.now": (
        "wall-clock",
        "derive timestamps from the injected Clock",
    ),
    "datetime.datetime.utcnow": (
        "wall-clock",
        "derive timestamps from the injected Clock",
    ),
    "datetime.datetime.today": (
        "wall-clock",
        "derive timestamps from the injected Clock",
    ),
    "datetime.date.today": (
        "wall-clock",
        "derive timestamps from the injected Clock",
    ),
    "threading.Thread": (
        "ambient-threading",
        "sim work must run on the virtual timeline, not OS threads",
    ),
    "threading.Timer": (
        "ambient-threading",
        "schedule on the VirtualClock instead",
    ),
    "concurrent.futures.ThreadPoolExecutor": (
        "ambient-threading",
        "only the declared shard fan-out may pool threads",
    ),
    "concurrent.futures.ProcessPoolExecutor": (
        "ambient-threading",
        "only the declared shard fan-out may pool threads",
    ),
    "multiprocessing.Process": (
        "ambient-threading",
        "sim work must run in-process",
    ),
}

#: module-level random functions = draws from the process-global RNG
_GLOBAL_RANDOM_FNS = frozenset(
    {
        "random",
        "randint",
        "randrange",
        "uniform",
        "choice",
        "choices",
        "sample",
        "shuffle",
        "gauss",
        "normalvariate",
        "expovariate",
        "betavariate",
        "triangular",
        "vonmisesvariate",
        "seed",
        "getrandbits",
    }
)


@dataclass
class PurityConfig:
    """Sim-scope roots, repo-relative (directories or files)."""

    scope: tuple[str, ...] = (
        "k8s_gpu_hpa_tpu_torch/metrics",
        "k8s_gpu_hpa_tpu_torch/control",
        "k8s_gpu_hpa_tpu_torch/chaos",
        "k8s_gpu_hpa_tpu_torch/obs",
        "k8s_gpu_hpa_tpu_torch/utils",
        "k8s_gpu_hpa_tpu_torch/simulate.py",
    )


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> fully-qualified import target, for both ``import x``
    and ``from x import y`` forms."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                aliases[local] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
                if alias.asname:
                    aliases[alias.asname] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for alias in node.names:
                local = alias.asname or alias.name
                aliases[local] = f"{node.module}.{alias.name}"
    return aliases


def _qualified_name(func: ast.expr, aliases: dict[str, str]) -> str | None:
    """Resolve a call target to its dotted import-level name:
    ``time.time`` -> "time.time", ``Thread`` (from threading) ->
    "threading.Thread", ``concurrent.futures.ThreadPoolExecutor`` in full."""
    parts: list[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = aliases.get(node.id)
    if base is None:
        return None
    parts.append(base)
    return ".".join(reversed(parts))


def scan_purity_file(path: Path, root: Path) -> list[tuple[str, int, str, str, str]]:
    """(qualified call, line, category, remedy, subject) per violation."""
    rel = str(path.relative_to(root))
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError:
        return []
    aliases = _import_aliases(tree)
    out: list[tuple[str, int, str, str, str]] = []

    def report(qual: str, line: int, category: str, remedy: str) -> None:
        out.append((qual, line, category, remedy, f"{rel}:{qual}"))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        qual = _qualified_name(node.func, aliases)
        if qual is None:
            continue
        if qual in FORBIDDEN_CALLS:
            category, remedy = FORBIDDEN_CALLS[qual]
            report(qual, node.lineno, category, remedy)
        elif qual == "random.Random":
            if not node.args and not node.keywords:
                report(
                    qual,
                    node.lineno,
                    "unseeded-random",
                    "pass an explicit seed: random.Random(seed)",
                )
        elif qual.startswith("random.") and qual.split(".", 1)[1] in (
            _GLOBAL_RANDOM_FNS
        ):
            report(
                qual,
                node.lineno,
                "unseeded-random",
                "draw from an explicitly seeded random.Random instance",
            )
    return out


class SimPurityPass(AnalysisPass):
    name = "sim-purity"
    description = (
        "sim hot paths stay deterministic and replay-safe: no wall clock, "
        "no unseeded random, no ambient threading"
    )

    def __init__(self, config: PurityConfig | None = None):
        self.config = config or PurityConfig()

    def run(self, root: Path) -> list[Finding]:
        # Imported lazily: analysis/__init__ registers this pass before the
        # concurrency module (which holds the contracts) is importable.
        from k8s_gpu_hpa_tpu_torch.analysis.concurrency import contract_for

        findings: list[Finding] = []
        for entry in self.config.scope:
            base = root / entry
            paths = sorted(base.rglob("*.py")) if base.is_dir() else [base]
            for path in paths:
                if "__pycache__" in path.parts or not path.exists():
                    continue
                rel = str(path.relative_to(root))
                for qual, line, category, remedy, subject in scan_purity_file(
                    path, root
                ):
                    if (
                        category == "ambient-threading"
                        and contract_for(rel, qual) is not None
                    ):
                        # Declared boundary: the concurrency passes verify
                        # the contract instead of a blanket exemption.
                        continue
                    findings.append(
                        self.finding(
                            category,
                            rel,
                            line,
                            subject,
                            f"{qual}() in sim scope — {remedy}",
                        )
                    )
        return findings


register(SimPurityPass())
