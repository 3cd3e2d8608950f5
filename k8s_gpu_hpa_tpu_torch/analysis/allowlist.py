"""Reviewed exemptions for the port's static-analysis gate.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/allowlist.py``: the JAX
package's entries, pointed at the port's paths, and one of the port's own
(the rollup probe's synthetic series, which the JAX package keeps in a
script outside its package).

Every entry excuses exactly one (pass, category, subject) and must say
why in one line.  The framework (:func:`..analysis.run_passes`) enforces
review in both directions: a finding matching an entry is suppressed and
reported under ``allowed``; an entry matching *nothing* becomes a
``stale-allowlist`` finding — when the tree gets cleaner, the allowlist
must shrink with it.

Subjects: metric family name for ``metrics-contract``;
``<repo-relative file>:<qualified call>`` for ``sim-purity``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AllowEntry:
    pass_name: str
    category: str
    subject: str
    justification: str

    def __post_init__(self) -> None:
        if not self.justification.strip():
            raise ValueError(
                f"allowlist entry {self.subject!r} needs a justification"
            )


ALLOWLIST: tuple[AllowEntry, ...] = (
    # ---- metrics-contract: series Kubernetes itself produces -------------
    AllowEntry(
        "metrics-contract",
        "dangling-consumer",
        "kube_horizontalpodautoscaler_status_current_replicas",
        "produced by kube-state-metrics in a real cluster; the sim's KSM "
        "surrogate scopes to pod labels/phase",
    ),
    AllowEntry(
        "metrics-contract",
        "dangling-consumer",
        "kube_horizontalpodautoscaler_status_desired_replicas",
        "produced by kube-state-metrics in a real cluster; the sim's KSM "
        "surrogate scopes to pod labels/phase",
    ),
    AllowEntry(
        "metrics-contract",
        "dangling-consumer",
        "ALERTS",
        "synthesized by Prometheus itself for every loaded alerting rule; "
        "no exporter produces it",
    ),
    AllowEntry(
        "metrics-contract",
        "orphan-producer",
        "tpu_prod_tensorcore_avg",
        "the capacity-crunch drill's primary-tenant record; consumed "
        "in-sim through the pipeline's dynamic record wiring, never by a "
        "shipped rule or panel",
    ),
    AllowEntry(
        "metrics-contract",
        "orphan-producer",
        "probe_duty_cycle",
        "the rollup-probe pass's synthetic input series (analysis/legacy.py), "
        "written into a scratch DB the pass builds and read back through "
        "downsample_selfcheck; it lies off every simulator path and no "
        "shipped rule or panel reads it",
    ),
    # ---- sim-purity: the declared wall-clock boundaries ------------------
    AllowEntry(
        "sim-purity",
        "wall-clock",
        "k8s_gpu_hpa_tpu_torch/utils/clock.py:time.sleep",
        "SystemClock IS the declared wall-clock boundary; every sim path "
        "runs on VirtualClock",
    ),
    AllowEntry(
        "sim-purity",
        "wall-clock",
        "k8s_gpu_hpa_tpu_torch/control/operator.py:time.sleep",
        "the operator daemon's production serve loop; sims drive "
        "reconcile_once on a VirtualClock instead",
    ),
    # Thread boundaries are not allowlisted: each one carries a structured,
    # machine-checked ConcurrencyContract in analysis/concurrency.py.
)
