"""The coverage-probes pass: the probe registry and its call sites agree.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/coverage.py``, over the port's
registry (``obs/coverage.py``) and its call sites.  The coverage plane is
evidence only while the registry and the instrumented joints cannot drift
apart.  Two silent failure modes would rot it:

- **dangling call site**: ``coverage.hit("hpa_condition:typo")`` runs, and
  raises KeyError only when a map is collecting, i.e. in a coverage run,
  not in the tests of the plane it sits in.  Worse, a call under a probe id
  that was *renamed* records nothing, and the scorecard quietly reports
  the old branch as never hit.
- **orphan probe**: a registered probe whose call site was deleted.  It
  shows up as "never hit" forever, and the gap list, the work queue of
  scenario authoring, fills with a gap no code can close.

So the pass walks every call in the package that resolves (through the
import-alias resolution of sim-purity; ``ast.walk`` sees imports inside
functions too, which ``metrics/rules.py`` uses against an import cycle) to
``k8s_gpu_hpa_tpu_torch.obs.coverage.hit`` or ``.hit_dynamic`` and checks:

- ``hit()`` takes exactly one **string literal**, a registered probe id.
  A non-literal argument is a finding: the analyzer cannot prove a
  computed id exists, so computed ids go through ``hit_dynamic``.
- ``hit_dynamic()``'s first argument is a literal **registered domain**
  (the second may be computed); such a call marks its whole domain as
  having call sites.
- every registered probe has a call site (a literal one, or its domain's
  ``hit_dynamic``): orphans are findings.
- ``obs/coverage.FAULT_PROBE_KINDS`` matches ``chaos/faults.FAULT_KINDS``
  exactly: obs must not import chaos to read it, so the mirror is checked
  here.

The registry's truth comes from importing the live modules: the analyzer
runs against the tree it sits in, so the import is the source under
analysis.
"""

from __future__ import annotations

import ast
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.analysis import AnalysisPass, Finding, register
from k8s_gpu_hpa_tpu_torch.analysis.purity import _import_aliases, _qualified_name

HIT_QUAL = "k8s_gpu_hpa_tpu_torch.obs.coverage.hit"
HIT_DYNAMIC_QUAL = "k8s_gpu_hpa_tpu_torch.obs.coverage.hit_dynamic"

#: the registry module itself and this pass are not call-site scope
_SKIP_RELS = (
    "k8s_gpu_hpa_tpu_torch/obs/coverage.py",
    "k8s_gpu_hpa_tpu_torch/analysis/coverage.py",
)


def _literal_str(node: ast.expr) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def scan_coverage_calls(
    path: Path, root: Path
) -> list[tuple[str, int, str | None, bool]]:
    """(call qual, line, literal first arg or None, is_dynamic) per call."""
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError:
        return []
    aliases = _import_aliases(tree)
    out: list[tuple[str, int, str | None, bool]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        qual = _qualified_name(node.func, aliases)
        if qual not in (HIT_QUAL, HIT_DYNAMIC_QUAL):
            continue
        first = _literal_str(node.args[0]) if node.args else None
        out.append((qual, node.lineno, first, qual == HIT_DYNAMIC_QUAL))
    return out


class CoverageProbesPass(AnalysisPass):
    name = "coverage-probes"
    description = (
        "every coverage.hit() names a registered probe, every registered "
        "probe has a call site, and the fault_kind family mirrors the "
        "chaos injector registry"
    )

    def run(self, root: Path) -> list[Finding]:
        from k8s_gpu_hpa_tpu_torch.chaos import faults
        from k8s_gpu_hpa_tpu_torch.obs import coverage as registry

        findings: list[Finding] = []
        reg_file = "k8s_gpu_hpa_tpu_torch/obs/coverage.py"
        hit_ids: set[str] = set()
        dynamic_domains: set[str] = set()

        base = root / "k8s_gpu_hpa_tpu_torch"
        for path in sorted(base.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = str(path.relative_to(root))
            if rel in _SKIP_RELS:
                continue
            for qual, line, literal, is_dynamic in scan_coverage_calls(
                path, root
            ):
                short = qual.rsplit(".", 1)[1]
                if literal is None:
                    findings.append(
                        self.finding(
                            "non-literal-probe",
                            rel,
                            line,
                            f"{rel}:{line}:{short}",
                            f"coverage.{short}() first argument must be a "
                            "string literal so the registry check can prove "
                            "it exists (computed probe names go through "
                            "hit_dynamic with a literal domain)",
                        )
                    )
                elif is_dynamic:
                    if literal not in registry.DOMAINS:
                        findings.append(
                            self.finding(
                                "dangling-call-site",
                                rel,
                                line,
                                f"{rel}:{literal}",
                                f"coverage.hit_dynamic({literal!r}, ...) "
                                "names no registered domain "
                                f"(registered: {', '.join(registry.DOMAINS)})",
                            )
                        )
                    else:
                        dynamic_domains.add(literal)
                elif literal not in registry.PROBES:
                    findings.append(
                        self.finding(
                            "dangling-call-site",
                            rel,
                            line,
                            f"{rel}:{literal}",
                            f"coverage.hit({literal!r}) names no registered "
                            "probe — register it in obs/coverage.py or fix "
                            "the id",
                        )
                    )
                else:
                    hit_ids.add(literal)

        for probe_id, probe in sorted(registry.PROBES.items()):
            if probe_id in hit_ids or probe.domain in dynamic_domains:
                continue
            findings.append(
                self.finding(
                    "orphan-probe",
                    reg_file,
                    1,
                    f"probe:{probe_id}",
                    f"registered probe {probe_id!r} has no call site — it "
                    "can never be hit, so it pollutes every gap list; "
                    "instrument the branch or retire the probe",
                )
            )

        mirrored = set(registry.FAULT_PROBE_KINDS)
        injectors = set(faults.FAULT_KINDS)
        for kind in sorted(injectors - mirrored):
            findings.append(
                self.finding(
                    "fault-registry-drift",
                    reg_file,
                    1,
                    f"fault-kind:{kind}",
                    f"injector {kind!r} (chaos/faults.FAULT_KINDS) has no "
                    "fault_kind probe — add it to FAULT_PROBE_KINDS",
                )
            )
        for kind in sorted(mirrored - injectors):
            findings.append(
                self.finding(
                    "fault-registry-drift",
                    reg_file,
                    1,
                    f"fault-kind:{kind}",
                    f"fault_kind probe {kind!r} mirrors no injector in "
                    "chaos/faults.FAULT_KINDS — retire it",
                )
            )
        return findings


register(CoverageProbesPass())
