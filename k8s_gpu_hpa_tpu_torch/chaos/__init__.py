"""Declarative fault injection on virtual time: FaultSpecs armed by a
ChaosSchedule, each fault's recovery accounted as a RecoveryReport
(detection time, degraded duration, MTTR), the canned storm and the
capacity crunch.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/``; the region evacuation, the
fuzzer and the paging drill come with later slices."""

from k8s_gpu_hpa_tpu_torch.chaos.crunch import (
    CRUNCH_FAULTS,
    evaluate_crunch_contract,
    render_crunch_report,
    run_capacity_crunch,
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
]
