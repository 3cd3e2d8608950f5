"""Canned profiled runs for the continuous-profiling plane.

Counterpart of ``k8s_gpu_hpa_tpu/control/profile_harness.py``.
``run_profile`` runs the named canned run(s) under a fresh
:class:`~k8s_gpu_hpa_tpu_torch.obs.profile.ProfileMap` and returns one
record per run with both export forms: the canonical structural export
(bit-identical for the same seed, the baseline a ``--diff`` checks
against) and the timed export (scorecard, diff, metrics).

The wall-clock denominator of the attribution is chosen per run:

- the **scale** run takes ``run_fleet_scale``'s own ``wall_s``, the
  gc-disabled measured window the sim_scale rungs gate on, so the set-up
  (building the SimTargets) does not dilute attribution, and the 90%
  floor (perfgates.PROFILE_MIN_ATTRIBUTION) means 90% of the time the
  rung already measures is named;
- **storm** and **crunch** are timed around the harness call, so their
  attribution is informational (the pipeline's orchestration between
  brackets is real unnamed time): the floor applies to scale only.

``run_profile_coverage_session`` is the deterministic session behind
``simulate --scenario coverage --run profile``: a tiny profiled fleet run,
both exporters and a synthetic regression and overflow, so all four
``profile:*`` coverage probes fire with machine-independent counts.
"""

from __future__ import annotations

import time

from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.obs import profile

#: the canned runs ``simulate profile --run`` accepts (plus "all")
PROFILE_RUNS = ("storm", "crunch", "scale")


def _scale_shape(smoke: bool) -> tuple[int, float]:
    if smoke:
        return (
            perfgates.PROFILE_SCALE_SMOKE_TARGETS,
            perfgates.PROFILE_SCALE_SMOKE_HORIZON_S,
        )
    return perfgates.PROFILE_SCALE_TARGETS, perfgates.PROFILE_SCALE_HORIZON_S


def run_profile(
    run: str = "storm",
    seed: int | None = None,
    smoke: bool = False,
    plant: dict[str, float] | None = None,
) -> list[dict]:
    """Profile the named canned run(s) (``run="all"`` does each in turn,
    each under its own fresh map so scorecards don't conflate runs).

    ``seed`` feeds the storm's schedule-variant derivation and the run
    label; ``smoke`` shrinks the scale run's shape (the tests' sizing);
    ``plant`` maps stage_id -> artificial extra seconds per call — the
    regression canary used to prove the ``--diff`` gate trips.

    Each record: ``run``, ``wall_s``, ``canonical`` (bit-identical
    same-seed JSON string), ``export`` (its dict form), ``timed`` (the
    scorecard/diff artifact), ``attribution``, ``attribution_ok`` (vs
    perfgates.PROFILE_MIN_ATTRIBUTION), ``open_spans`` (must be empty —
    the balanced-bracket property), and the live ``pmap`` for exporters
    (strip it before JSON-serializing the record).
    """
    from k8s_gpu_hpa_tpu_torch.chaos.crunch import run_capacity_crunch
    from k8s_gpu_hpa_tpu_torch.chaos.storm import run_fault_storm
    from k8s_gpu_hpa_tpu_torch.control.scale_harness import run_fleet_scale

    names = PROFILE_RUNS if run == "all" else (run,)
    records = []
    for name in names:
        label = name if seed is None else f"{name}@{seed}"
        with profile.collect(label, plant=plant) as pmap:
            if name == "storm":
                t0 = time.perf_counter()
                run_fault_storm(seed=seed)
                wall_s = time.perf_counter() - t0
            elif name == "crunch":
                t0 = time.perf_counter()
                run_capacity_crunch()
                wall_s = time.perf_counter() - t0
            elif name == "scale":
                targets, horizon_s = _scale_shape(smoke)
                result = run_fleet_scale(targets=targets, horizon_s=horizon_s)
                wall_s = result["wall_s"]
            else:
                raise ValueError(
                    f"unknown profile run {name!r} "
                    f"(known: {', '.join(PROFILE_RUNS + ('all',))})"
                )
            open_spans = pmap.open_spans()
            timed = pmap.timed_export(wall_s)
        # planted seconds are part of the accounting, so attribution can
        # legitimately exceed 1.0 under a canary — the floor still holds
        attribution = timed["attribution"]
        records.append(
            {
                "run": name,
                "wall_s": round(wall_s, 6),
                "export": pmap.export(),
                "canonical": pmap.export_json(),
                "timed": timed,
                "attribution": attribution,
                "attribution_ok": profile.check_attribution(
                    timed, perfgates.PROFILE_MIN_ATTRIBUTION
                ),
                "open_spans": open_spans,
                "pmap": pmap,
            }
        )
    return records


def run_profile_coverage_session() -> dict:
    """Deterministically exercise every ``profile:*`` coverage probe.

    Sized by perfgates.PROFILE_COVERAGE_* (a ~10-target fleet run) so the
    session stays cheap inside ``simulate coverage --run all``.  The
    probes are fired on *synthetic* artifacts (a real-vs-empty diff, an
    empty-map attribution check) rather than on the real run's timings,
    so the per-probe hit counts are machine-independent.
    """
    from k8s_gpu_hpa_tpu_torch.control.scale_harness import run_fleet_scale

    with profile.collect("coverage-session") as pmap:
        run_fleet_scale(
            targets=perfgates.PROFILE_COVERAGE_TARGETS,
            horizon_s=perfgates.PROFILE_COVERAGE_HORIZON_S,
        )
        timed = pmap.timed_export(1.0)
    # exporter selection paths: profile:export_trace / profile:export_flame
    profile.render_chrome_trace(pmap)
    profile.render_collapsed(pmap)
    # diff-gate trip: the real run diffed against an empty candidate loses
    # every path -> profile:diff_regression
    empty = profile.ProfileMap("empty").timed_export(1.0)
    diff = profile.diff_exports(timed, empty)
    assert diff["regression"]
    # unattributed-bucket overflow: an empty map attributes 0% of any
    # wall time -> profile:unattributed_overflow
    assert not profile.check_attribution(
        empty, perfgates.PROFILE_MIN_ATTRIBUTION
    )
    return timed
