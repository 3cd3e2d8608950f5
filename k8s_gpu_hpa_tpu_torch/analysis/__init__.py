"""Static analysis: one registry, one finding format, one gate.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/__init__.py``, run over the
port's own tree (``k8s_gpu_hpa_tpu_torch/``).  The pipeline's contracts
between its components (exporter → scrape → TSDB → rules → adapter → HPA),
its simulator's determinism and its thread boundaries are checked by ten
passes that share this spine:

- :class:`Finding`: one violation, with file:line provenance and a
  ``subject`` key the allowlist matches on;
- :class:`AnalysisPass`: a named check producing findings; passes
  register themselves through :func:`register`, so ``python -m
  k8s_gpu_hpa_tpu_torch.analysis --all`` and the tests enumerate the same
  set;
- :func:`run_passes`: runs a selection, applies the reviewed exemptions in
  ``analysis/allowlist.py`` and flags *stale* allowlist entries (an
  exemption that no longer suppresses anything is itself a finding, so the
  allowlist shrinks when the tree gets cleaner).

The whole-program passes live in :mod:`.contracts` (the metrics contract
over the :mod:`.symbols` producer table), :mod:`.purity` (the simulator's
determinism), :mod:`.coverage` (the probe registry against its call sites)
and :mod:`.concurrency` (locksets, closure escapes and the thread-boundary
contracts); :mod:`.legacy` carries the five older lints as passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

#: repo root (the directory holding k8s_gpu_hpa_tpu_torch/ and deploy/)
REPO_ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True, order=True)
class Finding:
    """One violation: where it is, what rule it breaks, how to name it.

    ``subject`` is the stable key an allowlist entry matches — the metric
    family name for contract findings, ``<file>:<qualified call>`` for
    purity findings — so an exemption survives the file growing lines."""

    pass_name: str
    category: str
    file: str  # repo-relative path
    line: int
    subject: str
    message: str

    def as_dict(self) -> dict:
        return {
            "pass": self.pass_name,
            "category": self.category,
            "file": self.file,
            "line": self.line,
            "subject": self.subject,
            "message": self.message,
        }

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}: [{self.pass_name}/{self.category}] "
            f"{self.message}"
        )


class AnalysisPass:
    """Base class: subclasses set ``name``/``description`` and implement
    ``run(root)`` returning every finding on the tree under ``root``."""

    name: str = ""
    description: str = ""

    def run(self, root: Path) -> list[Finding]:  # pragma: no cover - abstract
        raise NotImplementedError

    def finding(
        self, category: str, file: str, line: int, subject: str, message: str
    ) -> Finding:
        return Finding(self.name, category, file, line, subject, message)


_REGISTRY: dict[str, AnalysisPass] = {}


def register(analysis_pass: AnalysisPass) -> AnalysisPass:
    """Add a pass to the global registry (idempotent by name)."""
    if not analysis_pass.name:
        raise ValueError("analysis pass needs a non-empty name")
    _REGISTRY[analysis_pass.name] = analysis_pass
    return analysis_pass


def registered_passes() -> list[AnalysisPass]:
    """Every registered pass, in registration order (import side effect of
    the submodules below)."""
    return list(_REGISTRY.values())


def get_pass(name: str) -> AnalysisPass:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"no analysis pass {name!r} (known: {known})") from None


@dataclass
class Report:
    """The outcome of one analyzer run: active findings fail the gate,
    ``allowed`` records what the reviewed exemptions suppressed."""

    passes: list[str]
    findings: list[Finding] = field(default_factory=list)
    allowed: list[tuple[Finding, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "passes": [
                {
                    "name": p.name,
                    "description": p.description,
                    "findings": sum(
                        1 for f in self.findings if f.pass_name == p.name
                    ),
                    "allowed": sum(
                        1 for f, _ in self.allowed if f.pass_name == p.name
                    ),
                }
                for p in registered_passes()
                if p.name in self.passes
            ],
            "findings": [f.as_dict() for f in sorted(self.findings)],
            "allowed": [
                {**f.as_dict(), "justification": why}
                for f, why in sorted(self.allowed)
            ],
            "ok": self.ok,
        }


def run_passes(
    names: list[str] | None = None,
    root: Path | None = None,
    allowlist=None,
) -> Report:
    """Run the named passes (default: all registered) and apply the
    allowlist.  A matched entry moves its finding to ``report.allowed``;
    an entry for a pass that ran but matched nothing becomes a
    ``stale-allowlist`` finding — exemptions are reviewed both ways."""
    from k8s_gpu_hpa_tpu_torch.analysis.allowlist import ALLOWLIST

    root = root or REPO_ROOT
    entries = ALLOWLIST if allowlist is None else allowlist
    selected = names if names is not None else [p.name for p in registered_passes()]
    report = Report(passes=list(selected))
    used: set = set()
    for name in selected:
        analysis_pass = get_pass(name)
        for f in analysis_pass.run(root):
            entry = next(
                (
                    e
                    for e in entries
                    if e.pass_name == f.pass_name
                    and e.category == f.category
                    and e.subject == f.subject
                ),
                None,
            )
            if entry is not None:
                used.add(entry)
                report.allowed.append((f, entry.justification))
            else:
                report.findings.append(f)
    for e in entries:
        if e.pass_name in selected and e not in used:
            report.findings.append(
                Finding(
                    e.pass_name,
                    "stale-allowlist",
                    "k8s_gpu_hpa_tpu_torch/analysis/allowlist.py",
                    1,
                    e.subject,
                    f"allowlist entry matched no finding "
                    f"({e.category}/{e.subject!r}) — the violation it excused "
                    "is gone; delete the entry",
                )
            )
    report.findings.sort()
    return report


# Importing the submodules registers the passes; keep this at the bottom so
# they can import the framework symbols above.
from k8s_gpu_hpa_tpu_torch.analysis import contracts as _contracts  # noqa: E402,F401
from k8s_gpu_hpa_tpu_torch.analysis import purity as _purity  # noqa: E402,F401
from k8s_gpu_hpa_tpu_torch.analysis import legacy as _legacy  # noqa: E402,F401
from k8s_gpu_hpa_tpu_torch.analysis import coverage as _coverage  # noqa: E402,F401
from k8s_gpu_hpa_tpu_torch.analysis import concurrency as _concurrency  # noqa: E402,F401
