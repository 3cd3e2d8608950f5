"""Run the static-analysis passes: one gate, one finding format.

Counterpart of ``tools/analyze.py``, over the port's tree.  ``--all`` runs
every registered pass and exits 1 on any unsuppressed finding.  ``--pass
<name>`` (repeatable) selects passes; a name matching a registered prefix
group expands to every pass under it (``--pass concurrency`` runs both
``concurrency-lockset`` and ``concurrency-escape``).  ``--list`` enumerates
the registry without running anything; ``--json`` prints the
machine-readable report.  Exit 0 clean, 1 on a finding, 2 on a usage error
or an unknown pass.

Usage:
    python -m k8s_gpu_hpa_tpu_torch.analysis --all [--json]
    python -m k8s_gpu_hpa_tpu_torch.analysis --pass metrics-contract [--pass sim-purity] [--json]
    python -m k8s_gpu_hpa_tpu_torch.analysis --pass concurrency [--json]
    python -m k8s_gpu_hpa_tpu_torch.analysis --list [--json]
"""

from __future__ import annotations

import json
import sys

from k8s_gpu_hpa_tpu_torch import analysis


def main(argv: list[str]) -> int:
    want_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if argv == ["--list"]:
        passes = analysis.registered_passes()
        if want_json:
            print(
                json.dumps(
                    {"passes": [{"name": p.name, "description": p.description} for p in passes]},
                    indent=2,
                )
            )
        else:
            for p in passes:
                print(f"{p.name}: {p.description}")
        return 0
    names: list[str] | None = None
    if argv == ["--all"]:
        names = None
    elif argv and len(argv) % 2 == 0 and all(a == "--pass" for a in argv[0::2]):
        known = {p.name for p in analysis.registered_passes()}
        # prefix-group expansion: "concurrency" -> every concurrency-* pass
        names = []
        for n in argv[1::2]:
            group = sorted(k for k in known if k.startswith(n + "-"))
            if n not in known and group:
                names.extend(group)
            else:
                names.append(n)
        unknown = [n for n in names if n not in known]
        if unknown:
            print(
                f"analyze: unknown pass(es): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return 2
    else:
        print(__doc__.split("Usage:")[1].strip(), file=sys.stderr)
        return 2
    report = analysis.run_passes(names)
    if want_json:
        print(json.dumps(report.as_dict(), indent=2))
        return 0 if report.ok else 1
    for f in report.findings:
        print(f"analyze: {f.render()}")
    ran = report.passes
    if report.ok:
        print(
            f"analyze ok: {len(ran)} pass(es) clean ({', '.join(ran)}); "
            f"{len(report.allowed)} reviewed exemption(s) applied"
        )
        return 0
    print(
        f"analyze: {len(report.findings)} finding(s) across {len(ran)} pass(es) — fix them "
        "or add a justified allowlist entry (k8s_gpu_hpa_tpu_torch/analysis/allowlist.py)",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
