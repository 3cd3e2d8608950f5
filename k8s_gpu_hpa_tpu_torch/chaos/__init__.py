"""Declarative fault injection on virtual time: FaultSpecs armed by a
ChaosSchedule, each fault's recovery accounted as a RecoveryReport
(detection time, degraded duration, MTTR), the canned storm, the
capacity crunch and the region evacuation.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/``.  The coverage-guided fuzzer
(``chaos.fuzz``) and the paging drills (``chaos.paging``) are imported by
name, as the JAX package's are."""

from k8s_gpu_hpa_tpu_torch.chaos.crunch import (
    CRUNCH_FAULTS,
    evaluate_crunch_contract,
    render_crunch_report,
    run_capacity_crunch,
)
from k8s_gpu_hpa_tpu_torch.chaos.evacuate import (
    evaluate_evacuation_contract,
    render_evacuation_report,
    render_evacuation_why,
    replay_evacuation_artifact,
    run_region_evacuation,
)
from k8s_gpu_hpa_tpu_torch.chaos.faults import FAULT_KINDS, FaultSpec
from k8s_gpu_hpa_tpu_torch.chaos.schedule import ChaosSchedule, RecoveryReport
from k8s_gpu_hpa_tpu_torch.chaos.storm import STORM_FAULTS, render_chaos_report, run_fault_storm

__all__ = [
    "FAULT_KINDS",
    "FaultSpec",
    "ChaosSchedule",
    "RecoveryReport",
    "STORM_FAULTS",
    "render_chaos_report",
    "run_fault_storm",
    "CRUNCH_FAULTS",
    "evaluate_crunch_contract",
    "render_crunch_report",
    "run_capacity_crunch",
    "evaluate_evacuation_contract",
    "render_evacuation_report",
    "render_evacuation_why",
    "replay_evacuation_artifact",
    "run_region_evacuation",
]
