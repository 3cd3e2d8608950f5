"""Coverage-guided adversarial chaos fuzzing, minimized by delta debugging.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/fuzz.py``.  The canned chaos (storm,
crunch, drill) replays scenarios someone already thought of.  This module
searches the space nobody writes by hand: a seeded generator mutates fault
schedules (kind, timing, overlap, duration, drawn from the whole
``chaos/faults.FAULT_KINDS`` registry) and the tenants' traffic bases
against the fixed harness of :mod:`k8s_gpu_hpa_tpu_torch.control.fuzz_harness`,
steered by two signals:

- **coverage novelty**: each case runs under a
  :class:`~k8s_gpu_hpa_tpu_torch.obs.coverage.CoverageMap` of its own; a
  mutation that hits probes the campaign has never seen is kept however
  it scored, and the mutation operators lean toward fault kinds whose
  ``fault_kind:*`` probes are still dark;
- **fitness**: the harness scores contract violations, SLO burn, audit
  noise, preemption churn and lineage breaks; a mutation that scores
  higher joins the corpus of mutation bases (a greedy climb).

The loop (``run_fuzz``): mutate, run, accept or reject; on the FIRST
contract failure, run the case again to show it reproduces exactly
(:func:`~k8s_gpu_hpa_tpu_torch.control.fuzz_harness.outcome_fingerprint`),
delta-debug it down (:func:`minimize_schedule`: drop chunks ddmin-style,
halve durations, pull starts toward 0; no randomness, so two same-seed
campaigns minimize alike) and export a replayable ``seed + schedule``
artifact.  Artifacts committed under ``tests/scenarios/`` are regression
tests: :func:`replay_artifact` runs the case again and asks for the same
fingerprint.

One ``random.Random(seed)`` drives everything, with the draws in the JAX
package's order: no wall clock and no ambient entropy, so a seed gives the
same campaign, export and corpus in both packages.

The fuzzer's own decision points are coverage probes (the ``fuzz``
domain): ``mutation_accepted``, ``mutation_rejected``, ``minimizer_step``
and ``corpus_replay``.  ``simulate --scenario coverage --run fuzz`` drives
the search end to end, and each case's hits are forwarded into the outer
map, so a fuzz coverage session also covers whatever the cases touched.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.chaos.faults import FAULT_KINDS, FaultSpec
from k8s_gpu_hpa_tpu_torch.control import fuzz_harness
from k8s_gpu_hpa_tpu_torch.control.fuzz_harness import (
    DEFAULT_TRAFFIC,
    FUZZ_MAX_AT_S,
    FUZZ_MAX_DURATION_S,
    FUZZ_MAX_FAULTS,
    FUZZ_TRAFFIC_MAX,
    FUZZ_TRAFFIC_MIN,
    outcome_fingerprint,
    run_fuzz_case,
)
from k8s_gpu_hpa_tpu_torch.obs import coverage

#: every fault kind the mutator draws from, the whole registry in the JAX
#: package's order (the order is part of the rng stream: ``rng.choice``
#: indexes this tuple)
MUTATION_FAULT_KINDS = (
    "exporter_outage",
    "frozen_samples",
    "slow_scrape",
    "scrape_blackout",
    "node_preempt",
    "node_drain",
    "pod_crash",
    "crashloop",
    "adapter_blackout",
    "tsdb_restart",
    "hpa_restart",
    "adapter_restart",
    "wal_truncate",
    "tenant_spike",
    "provision_fail",
    # the region kinds: the single-pipeline harness has no
    # GlobalControlPlane, so their injectors raise ValueError there, which
    # _FuzzSchedule records and survives, as provision_fail without an
    # autoscaler.  They stay in the pool so the pool is the registry.
    "region_kill",
    "region_partition",
    "objstore_outage",
)

#: impulse kinds always get duration 0 (FaultSpec semantics: clear immediately)
_IMPULSE_KINDS = frozenset(
    ("pod_crash", "tsdb_restart", "hpa_restart", "adapter_restart", "wal_truncate")
)

#: kind → the harness entities a target may name (None = injector default)
_TARGET_POOLS: dict[str, tuple[str | None, ...]] = {
    "exporter_outage": (None, "exporter/fuzz-node-0", "exporter/fuzz-node-1"),
    "frozen_samples": (None, "exporter/fuzz-node-0", "exporter/fuzz-node-1"),
    "slow_scrape": (None, "exporter/fuzz-node-0", "exporter/fuzz-node-1"),
    "node_preempt": ("fuzz-node-0", "fuzz-node-1"),
    "node_drain": ("fuzz-node-0", "fuzz-node-1"),
    "crashloop": (None, "tpu-batch"),
    "tenant_spike": ("tpu-prod", "tpu-batch"),
}


def spec_to_dict(spec: FaultSpec) -> dict:
    return {
        "kind": spec.kind,
        "at": spec.at,
        "duration": spec.duration,
        "target": spec.target,
        "params": dict(spec.params),
    }


def spec_from_dict(d: dict) -> FaultSpec:
    return FaultSpec(
        kind=d["kind"],
        at=float(d["at"]),
        duration=float(d.get("duration", 0.0)),
        target=d.get("target"),
        params=dict(d.get("params") or {}),
    )


def _random_spec(rng: random.Random, prefer_kinds: list[str]) -> dict:
    """One random fault dict; ``prefer_kinds`` (the coverage-dark kinds)
    win a biased coin so the search reaches unexplored injectors first."""
    if prefer_kinds and rng.random() < 0.7:
        kind = rng.choice(prefer_kinds)
    else:
        kind = rng.choice(MUTATION_FAULT_KINDS)
    at = float(rng.randrange(0, int(FUZZ_MAX_AT_S) + 1))
    duration = (
        0.0
        if kind in _IMPULSE_KINDS
        else float(rng.randrange(5, int(FUZZ_MAX_DURATION_S) + 1))
    )
    target = None
    pool = _TARGET_POOLS.get(kind)
    if pool is not None:
        target = rng.choice(pool)
    params: dict = {}
    if kind == "tenant_spike":
        params["add"] = float(rng.randrange(40, 201))
    elif kind == "wal_truncate":
        params["records"] = rng.randrange(1, 17)
    return {
        "kind": kind,
        "at": at,
        "duration": duration,
        "target": target,
        "params": params,
    }


def mutate_case(case: dict, rng: random.Random, prefer_kinds: list[str]) -> dict:
    """Return a mutated copy of ``case`` (``{"faults": [...], "traffic":
    {...}}``): 1-3 operators drawn from add / drop / shift / stretch /
    swap-kind / traffic."""
    faults = [dict(f, params=dict(f["params"])) for f in case["faults"]]
    traffic = dict(case["traffic"])
    ops = rng.randrange(1, 4)
    for _ in range(ops):
        op = rng.choice(("add", "drop", "shift", "stretch", "swap", "traffic"))
        if op == "add" or not faults:
            if len(faults) < FUZZ_MAX_FAULTS:
                faults.append(_random_spec(rng, prefer_kinds))
        elif op == "drop":
            faults.pop(rng.randrange(len(faults)))
        elif op == "shift":
            f = faults[rng.randrange(len(faults))]
            f["at"] = float(
                max(0, min(int(FUZZ_MAX_AT_S), int(f["at"]) + rng.randrange(-120, 121)))
            )
        elif op == "stretch":
            f = faults[rng.randrange(len(faults))]
            if f["kind"] not in _IMPULSE_KINDS:
                f["duration"] = float(
                    max(
                        5,
                        min(
                            int(FUZZ_MAX_DURATION_S),
                            int(f["duration"] * rng.choice((0.5, 1.5, 2.0))),
                        ),
                    )
                )
        elif op == "swap":
            i = rng.randrange(len(faults))
            keep_at = faults[i]["at"]
            faults[i] = _random_spec(rng, prefer_kinds)
            faults[i]["at"] = keep_at
        else:  # traffic
            name = rng.choice(sorted(traffic))
            traffic[name] = (
                round(rng.uniform(FUZZ_TRAFFIC_MIN, FUZZ_TRAFFIC_MAX) * 2) / 2
            )
    return {"faults": faults, "traffic": traffic}


def _run_case_covered(case: dict, break_grace: bool, label: str) -> tuple[dict, set[str]]:
    """Run one case under its own CoverageMap, restoring (and forwarding
    hits into) whatever map was active around the campaign."""
    outer = coverage.active()
    cmap = coverage.CoverageMap(label)
    coverage.activate(cmap)
    try:
        outcome = run_fuzz_case(
            [spec_from_dict(f) for f in case["faults"]],
            traffic=case["traffic"],
            break_grace=break_grace,
        )
    finally:
        if outer is not None:
            coverage.activate(outer)
        else:
            coverage.deactivate()
    hit_ids = {pid for pid, count in cmap.counts.items() if count > 0}
    if outer is not None:
        for pid in sorted(hit_ids):
            outer.record(pid)
    return outcome, hit_ids


# ---- failure classification + minimization ---------------------------------

#: substring → category; a minimized schedule must still fail in every
#: category the original failed in (not necessarily with identical text —
#: shrinking a schedule legally changes counts inside the messages)
_VIOLATION_CATEGORIES = (
    ("conservation", "conservation"),
    ("time-to-capacity", "ttc"),
    ("starved", "starvation"),
    ("evicted", "preemption_budget"),
    ("did not converge", "convergence"),
    ("not every fault recovered", "recovery"),
    ("lineage", "lineage"),
)


def violation_signature(violations: list[str]) -> tuple[str, ...]:
    cats = set()
    for v in violations:
        for needle, cat in _VIOLATION_CATEGORIES:
            if needle in v:
                cats.add(cat)
                break
        else:
            cats.add("other")
    return tuple(sorted(cats))


def _make_still_fails(traffic: dict, break_grace: bool, signature, label: str):
    """The minimizer predicate: a candidate still fails when it violates the
    contract in (at least) every category the original failure did — exact
    message equality would reject legal shrinks whose counts differ."""

    def still_fails(candidate: list[dict]) -> bool:
        probe, _ = _run_case_covered(
            {"faults": candidate, "traffic": traffic}, break_grace, label
        )
        if not probe["violations"]:
            return False
        return set(signature) <= set(violation_signature(probe["violations"]))

    return still_fails


def minimize_schedule(
    faults: list[dict],
    still_fails,
    max_runs: int = 64,
) -> tuple[list[dict], int]:
    """Delta-debug ``faults`` down to a minimal failing core.

    Three deterministic, rng-free phases (same input ⇒ same output, which
    is what makes two same-seed campaigns minimize bit-identically):

    1. **drop** — ddmin over the fault list: try complements of ever-finer
       chunkings, keep any subset that still fails;
    2. **shrink** — halve each surviving fault's duration while the
       failure persists;
    3. **shift** — pull each fault's start toward 0 (``at → at // 2``)
       while the failure persists.

    ``still_fails(candidate_faults) -> bool`` runs the candidate (counting
    one ``fuzz:minimizer_step`` each); ``max_runs`` bounds the re-run
    budget.  Returns ``(minimized, runs_used)``."""
    runs = 0

    def check(candidate: list[dict]) -> bool:
        nonlocal runs
        if runs >= max_runs:
            return False
        runs += 1
        coverage.hit("fuzz:minimizer_step")
        return still_fails(candidate)

    current = list(faults)
    # phase 1: ddmin drop
    n = 2
    while len(current) >= 2 and runs < max_runs:
        size = max(1, len(current) // n)
        chunks = [current[i : i + size] for i in range(0, len(current), size)]
        reduced = False
        for i in range(len(chunks)):
            complement = [f for j, c in enumerate(chunks) for f in c if j != i]
            if complement and check(complement):
                current = complement
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(current):
                break
            n = min(len(current), n * 2)
    # phase 2: shrink durations
    for i in range(len(current)):
        while current[i]["duration"] >= 10.0 and runs < max_runs:
            candidate = [dict(f, params=dict(f["params"])) for f in current]
            candidate[i]["duration"] = float(int(candidate[i]["duration"] // 2))
            if check(candidate):
                current = candidate
            else:
                break
    # phase 3: shift starts toward 0
    for i in range(len(current)):
        while current[i]["at"] >= 2.0 and runs < max_runs:
            candidate = [dict(f, params=dict(f["params"])) for f in current]
            candidate[i]["at"] = float(int(candidate[i]["at"] // 2))
            if check(candidate):
                current = candidate
            else:
                break
    return current, runs


#: the known minimal canary failure (what seed-7 discovery minimizes down
#: to): a prod spike while the cloud API is down forces a preemption, and
#: under ``--break-grace`` the evicted batch pod never finishes
#: Terminating — convergence broken.  The coverage session minimizes and
#: replays this core so the minimizer/replay probes are driven by a real
#: failing case without paying a full discovery campaign per coverage run.
CANARY_CORE = {
    "faults": [
        {
            "kind": "tenant_spike",
            "at": 1.0,
            "duration": 9.0,
            "target": "tpu-prod",
            "params": {"add": 198.0},
        },
        {
            "kind": "provision_fail",
            "at": 1.0,
            "duration": 7.0,
            "target": None,
            "params": {},
        },
    ],
    "traffic": {"tpu-prod": 49.0, "tpu-batch": 35.0},
}


def _copy_case(case: dict) -> dict:
    return {
        "faults": [dict(f, params=dict(f["params"])) for f in case["faults"]],
        "traffic": dict(case["traffic"]),
    }


# ---- corpus artifacts ------------------------------------------------------

ARTIFACT_VERSION = 1


def build_artifact(
    name: str,
    seed: int,
    case: dict,
    outcome: dict,
    break_grace: bool,
) -> dict:
    """The replayable ``seed + schedule`` record committed under
    tests/scenarios/ — everything a regression replay needs, nothing
    environmental."""
    return {
        "version": ARTIFACT_VERSION,
        "name": name,
        "seed": seed,
        "harness": {"break_grace": break_grace},
        "traffic": {k: case["traffic"][k] for k in sorted(case["traffic"])},
        "faults": case["faults"],
        "expect": {
            "violations": list(outcome["violations"]),
            "fingerprint": outcome["fingerprint"],
        },
    }


def replay_artifact(artifact: dict | str | Path) -> dict:
    """Re-run a corpus artifact and demand the recorded outcome, bit for
    bit.  Accepts the artifact dict or a path to its JSON file.  Returns
    ``{"ok", "name", "fingerprint_match", "violations_match", ...}`` —
    ``ok`` only when the fingerprint (and therefore every violation)
    reproduces exactly."""
    if not isinstance(artifact, dict):
        artifact = json.loads(Path(artifact).read_text())
    coverage.hit("fuzz:corpus_replay")
    outcome = run_fuzz_case(
        [spec_from_dict(f) for f in artifact["faults"]],
        traffic=artifact.get("traffic"),
        break_grace=bool(artifact.get("harness", {}).get("break_grace")),
    )
    expected = artifact["expect"]
    return {
        "name": artifact.get("name", "<unnamed>"),
        "fingerprint_match": outcome["fingerprint"] == expected["fingerprint"],
        "violations_match": outcome["violations"] == expected["violations"],
        "violations": outcome["violations"],
        "expected_violations": expected["violations"],
        "ok": outcome["fingerprint"] == expected["fingerprint"],
    }


# ---- the campaign ----------------------------------------------------------


def run_fuzz(
    budget: int,
    seed: int,
    break_grace: bool = False,
    out_dir: str | Path | None = None,
) -> dict:
    """Run a fuzz campaign of ``budget`` exploration cases from ``seed``.

    The FIRST case failing the contract is verified (re-run must fingerprint
    identically), minimized, and exported as an artifact (written under
    ``out_dir`` when given); exploration then continues for coverage until
    the budget is spent.  Returns a JSON-able report; ``report["ok"]`` is
    False only on a non-reproducing or unminimizable failure (CLI exit 2) —
    a cleanly minimized failure is the fuzzer *working*."""
    rng = random.Random(seed)
    seen_union: set[str] = set()
    fault_probe_prefix = "fault_kind:"
    corpus: list[dict] = []  # accepted cases, mutation bases
    base_case = {"faults": [], "traffic": dict(DEFAULT_TRAFFIC)}
    best_score = float("-inf")
    accepted = rejected = novel_accepts = 0
    failure: dict | None = None

    for index in range(budget):
        if not corpus:
            # open rich: a handful of random faults straight away, so the
            # very first cases already compose overlapping windows instead
            # of waiting for "add" mutations to accrete them one by one
            case = {
                "faults": [
                    _random_spec(rng, list(MUTATION_FAULT_KINDS))
                    for _ in range(rng.randrange(3, 6))
                ],
                "traffic": dict(base_case["traffic"]),
            }
        else:
            dark_kinds = [
                k
                for k in MUTATION_FAULT_KINDS
                if f"{fault_probe_prefix}{k}" not in seen_union
            ]
            parent = corpus[rng.randrange(len(corpus))]
            case = mutate_case(parent, rng, dark_kinds)
        outcome, hit_ids = _run_case_covered(
            case, break_grace, f"fuzz-case-{seed}-{index}"
        )
        novel = sorted(hit_ids - seen_union)
        if novel or outcome["score"] > best_score:
            coverage.hit("fuzz:mutation_accepted")
            accepted += 1
            if novel:
                novel_accepts += 1
            corpus.append(case)
            seen_union |= hit_ids
            best_score = max(best_score, outcome["score"])
        else:
            coverage.hit("fuzz:mutation_rejected")
            rejected += 1
        if outcome["violations"] and failure is None:
            failure = _handle_failure(
                case, outcome, seed, index, break_grace, out_dir
            )

    report = {
        "scenario": "fuzz",
        "mode": "virtual",
        "budget": budget,
        "seed": seed,
        "break_grace": break_grace,
        "cases_run": budget,
        "accepted": accepted,
        "rejected": rejected,
        "novel_accepts": novel_accepts,
        "best_score": best_score if best_score != float("-inf") else None,
        "coverage_probes_hit": len(seen_union),
        "failure": failure,
        "ok": failure is None
        or (failure["reproducible"] and failure["minimized"] is not None),
    }
    return report


def _handle_failure(
    case: dict,
    outcome: dict,
    seed: int,
    index: int,
    break_grace: bool,
    out_dir: str | Path | None,
) -> dict:
    """Verify → minimize → export one failing case."""
    # reproduce: the same case must fingerprint identically or nothing
    # downstream (minimization, corpus replay) can be trusted
    verify, _ = _run_case_covered(
        case, break_grace, f"fuzz-verify-{seed}-{index}"
    )
    reproducible = verify["fingerprint"] == outcome["fingerprint"]
    record: dict = {
        "case_index": index,
        "case": case,
        "violations": outcome["violations"],
        "signature": list(violation_signature(outcome["violations"])),
        "score": outcome["score"],
        "reproducible": reproducible,
        "minimized": None,
        "minimizer_runs": 0,
        "shrink_ratio": None,
        "artifact": None,
        "artifact_path": None,
    }
    if not reproducible:
        return record

    signature = violation_signature(outcome["violations"])
    traffic = case["traffic"]
    minimized, runs = minimize_schedule(
        case["faults"],
        _make_still_fails(
            traffic, break_grace, signature, f"fuzz-minimize-{seed}-{index}"
        ),
    )
    record["minimizer_runs"] = runs
    min_case = {"faults": minimized, "traffic": traffic}
    final, _ = _run_case_covered(
        min_case, break_grace, f"fuzz-final-{seed}-{index}"
    )
    if not final["violations"]:
        # the "minimized" core no longer fails — unminimizable (exit 2)
        return record
    record["minimized"] = min_case
    record["shrink_ratio"] = (
        round(len(minimized) / len(case["faults"]), 3)
        if case["faults"]
        else None
    )
    name = f"fuzz-seed{seed}-case{index}"
    artifact = build_artifact(name, seed, min_case, final, break_grace)
    record["artifact"] = artifact
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{name}.json"
        path.write_text(json.dumps(artifact, indent=2, sort_keys=True) + "\n")
        record["artifact_path"] = str(path)
    return record


def run_fuzz_coverage_session() -> dict:
    """The ``simulate coverage --run fuzz`` payload, deterministically
    driving all four ``fuzz:*`` probes into the active map: a small
    canary-armed campaign (its seed/budget are pinned so it both accepts
    and rejects mutations), then a real minimization + corpus replay of
    the canned :data:`CANARY_CORE` — cheaper than paying a full discovery
    campaign on every coverage run, but every probe hit is real work."""
    from k8s_gpu_hpa_tpu_torch import perfgates

    report = run_fuzz(
        budget=perfgates.FUZZ_COVERAGE_BUDGET,
        seed=perfgates.FUZZ_COVERAGE_SEED,
        break_grace=True,
    )
    core = _copy_case(CANARY_CORE)
    outcome, _ = _run_case_covered(core, True, "fuzz-coverage-core")
    signature = violation_signature(outcome["violations"])
    minimized, runs = minimize_schedule(
        core["faults"],
        _make_still_fails(
            core["traffic"], True, signature, "fuzz-coverage-minimize"
        ),
    )
    min_case = {"faults": minimized, "traffic": core["traffic"]}
    final, _ = _run_case_covered(min_case, True, "fuzz-coverage-final")
    artifact = build_artifact(
        "coverage-session-core",
        perfgates.FUZZ_COVERAGE_SEED,
        min_case,
        final,
        True,
    )
    replay = replay_artifact(artifact)
    report["coverage_session"] = {
        "core_violations": outcome["violations"],
        "minimizer_runs": runs,
        "replay_ok": replay["ok"],
    }
    return report


def render_fuzz_report(report: dict) -> str:
    lines = [
        f"fuzz campaign: budget {report['budget']}, seed {report['seed']}"
        + (" [canary: --break-grace armed]" if report["break_grace"] else ""),
        f"cases: {report['cases_run']} run, {report['accepted']} accepted "
        f"({report['novel_accepts']} for novel coverage), "
        f"{report['rejected']} rejected",
        f"campaign coverage: {report['coverage_probes_hit']} probes hit, "
        f"best fitness {report['best_score']}",
    ]
    failure = report["failure"]
    if failure is None:
        lines.append("no contract failure found within budget")
        return "\n".join(lines)
    lines += [
        "",
        f"FAILURE at case {failure['case_index']}: "
        f"{len(failure['violations'])} violation(s), "
        f"signature {'/'.join(failure['signature'])}",
    ]
    lines += [f"  - {v}" for v in failure["violations"]]
    if not failure["reproducible"]:
        lines.append("NON-REPRODUCIBLE: re-run fingerprint diverged (exit 2)")
        return "\n".join(lines)
    if failure["minimized"] is None:
        lines.append(
            f"UNMINIMIZABLE: minimizer exhausted "
            f"{failure['minimizer_runs']} re-runs without a failing core "
            "(exit 2)"
        )
        return "\n".join(lines)
    lines.append(
        f"minimized {len(failure['case']['faults'])} → "
        f"{len(failure['minimized']['faults'])} fault(s) "
        f"(shrink ratio {failure['shrink_ratio']}, "
        f"{failure['minimizer_runs']} minimizer re-runs):"
    )
    for f in failure["minimized"]["faults"]:
        target = f" target={f['target']}" if f.get("target") else ""
        params = f" params={f['params']}" if f.get("params") else ""
        lines.append(
            f"  {f['kind']} at={f['at']:g}s duration={f['duration']:g}s"
            f"{target}{params}"
        )
    if failure["artifact_path"]:
        lines.append(f"artifact written: {failure['artifact_path']}")
    return "\n".join(lines)
