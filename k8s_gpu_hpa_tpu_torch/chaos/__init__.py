"""Declarative fault injection on virtual time: FaultSpecs armed by a
ChaosSchedule, each fault's recovery accounted as a RecoveryReport
(detection time, degraded duration, MTTR), and the canned storm.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/``; the capacity crunch, the region
evacuation, the fuzzer and the paging drill come with later slices."""

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
]
