"""ChaosSchedule: arm declarative faults against a pipeline on virtual time.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/schedule.py``.  The schedule injects
each :class:`FaultSpec` at its time, clears it after its duration, and runs
a 1 Hz monitor that turns the pipeline's observable state into a
:class:`RecoveryReport` per fault: when the degradation became detectable,
and the MTTR from the fault's clearing to the pipeline converging again on
the right replica count and staying there.  On a traced pipeline each
resolved fault leaves a ``fault_window`` span.

Everything is scheduled through ``clock.call_at``/``call_later``
(``VirtualClock.advance`` is not reentrant, so callbacks never advance the
clock).  Faults are taken not to overlap in time (the storm is built so);
the monitor puts unhealth down to the earliest unresolved fault.

A restart fault leaves its recovery stats in the pipeline's restart log,
and ``RecoveryReport.replay_gap`` takes the worst replay gap of the
restarts logged while the fault was injected.  Health is judged on every
autoscaled tenant of the pipeline (its own deployment and each
``add_tenant_hpa``'s).  Given a ``GlobalControlPlane`` (``plane=``), health
is the plane's: every live region's pipeline judged so, a killed region
passed over; and each report names the region of the pipeline it judged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from k8s_gpu_hpa_tpu_torch.chaos.faults import ClearFn, FaultSpec, inject_fault

if TYPE_CHECKING:  # pragma: no cover - typing only
    from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline


def pipeline_healthy(pipe: "AutoscalingPipeline") -> bool:
    """Converged and observable: every declared replica running, no pod
    looping, every node schedulable, every scrape target answering, and the
    HPA able to read its metric.  Not "replicas == the count before the
    fault": load may move the goal while a fault is live; whether the final
    count is right is the caller's check.  On a pool shared by tenants
    (control/capacity.py) each tenant HPA's deployment is judged so too: a
    fault that leaves a second tenant's pods Pending is not recovered."""
    controllers = [(pipe.deployment, pipe.hpa)] + [
        (pipe.cluster.deployments[name], hpa) for name, hpa in pipe.tenant_hpas.items()
    ]
    for dep, hpa in controllers:
        if len(pipe.cluster.running_pods(dep.name)) != dep.replicas:
            return False
        if any(
            p.phase == "CrashLoopBackOff"
            for p in pipe.cluster.pods.values()
            if p.deployment == dep.name
        ):
            return False
        active = hpa.status.condition("ScalingActive")
        if active is not None and not active.status:
            return False
    for node in pipe.cluster.nodes.values():
        if not (node.ready and node.schedulable):
            return False
    return all(target.healthy for target in pipe.scraper.targets)


@dataclass
class RecoveryReport:
    """One fault's outcome; every timestamp is clock seconds.

    - ``detection_time``: injected → the first monitor tick that saw
      unhealth (how long the break stayed invisible).
    - ``degraded_duration``: detected → recovered.
    - ``mttr``: cleared → recovered, the pipeline's own recovery work
      without the fault's dwell.  A fault nobody noticed recovers with
      ``detected_at`` None.
    - ``replay_gap``: for a restart fault, the seconds of data its replay
      could not restore (the clock less the newest point recovered).
    - ``time_to_first_good_sync``: cleared → the HPA's first sync that
      computed a valid replica count (``last_good_sync_at``).
    - ``region``: the region of the pipeline this report judged, None
      outside a region; ``as_dict`` gives it only when it is set, so the
      reports of a single cluster keep their shape.
    """

    fault: FaultSpec
    injected_at: float | None = None
    cleared_at: float | None = None
    detected_at: float | None = None
    recovered_at: float | None = None
    expected_replicas: int | None = None
    replay_gap: float | None = None
    first_good_sync_at: float | None = None
    region: str | None = None
    #: id of the fault_window span covering injected → recovered, when the
    #: pipeline is traced
    trace_span_id: int | None = None

    @property
    def detection_time(self) -> float | None:
        if self.detected_at is None or self.injected_at is None:
            return None
        return self.detected_at - self.injected_at

    @property
    def degraded_duration(self) -> float | None:
        if self.recovered_at is None or self.detected_at is None:
            return None
        return self.recovered_at - self.detected_at

    @property
    def mttr(self) -> float | None:
        if self.recovered_at is None or self.cleared_at is None:
            return None
        return max(0.0, self.recovered_at - self.cleared_at)

    @property
    def time_to_first_good_sync(self) -> float | None:
        if self.first_good_sync_at is None or self.cleared_at is None:
            return None
        return max(0.0, self.first_good_sync_at - self.cleared_at)

    @property
    def recovered(self) -> bool:
        return self.recovered_at is not None

    def as_dict(self) -> dict:
        def r(x: float | None) -> float | None:
            return None if x is None else round(x, 1)

        out = {
            "fault": self.fault.name,
            "kind": self.fault.kind,
            "injected_at": r(self.injected_at),
            "cleared_at": r(self.cleared_at),
            "detected_at": r(self.detected_at),
            "recovered_at": r(self.recovered_at),
            "detection_time": r(self.detection_time),
            "degraded_duration": r(self.degraded_duration),
            "mttr": r(self.mttr),
            "replay_gap": r(self.replay_gap),
            "time_to_first_good_sync": r(self.time_to_first_good_sync),
            "recovered": self.recovered,
            "trace_span_id": self.trace_span_id,
        }
        if self.region is not None:
            out["region"] = self.region
        return out


@dataclass
class _Armed:
    spec: FaultSpec
    report: RecoveryReport
    clear_fn: ClearFn | None = None
    resolved: bool = False
    #: start of the current healthy run after the clear, else None
    healthy_since: float | None = None


class ChaosSchedule:
    """Arm a list of faults against a pipeline and account their recovery.

    ``stable_for``: a fault counts as recovered once the pipeline has been
    healthy for this many seconds on end after the fault cleared
    (``recovered_at`` is the start of that healthy run).

    ``plane``: a GlobalControlPlane that judges health region by region, so
    a killed region is expected to be unhealthy (``plane.healthy()`` passes
    it over) instead of holding the whole drill unrecovered."""

    def __init__(
        self,
        pipeline: "AutoscalingPipeline",
        faults: list[FaultSpec],
        monitor_interval: float = 1.0,
        stable_for: float = 10.0,
        plane=None,
    ):
        self.pipeline = pipeline
        self.plane = plane
        self.monitor_interval = monitor_interval
        self.stable_for = stable_for
        self._armed = [
            _Armed(spec=s, report=RecoveryReport(fault=s)) for s in sorted(faults, key=lambda s: s.at)
        ]
        self._armed_at: float | None = None

    @property
    def reports(self) -> list[RecoveryReport]:
        return [a.report for a in self._armed]

    def arm(self) -> None:
        """Schedule every injection and clear and start the monitor.  Call
        once, then drive the clock (``pipeline.clock.advance(...)``)."""
        if self._armed_at is not None:
            raise RuntimeError("ChaosSchedule.arm() called twice")
        clock = self.pipeline.clock
        base = self._armed_at = clock.now()
        for armed in self._armed:
            clock.call_at(base + armed.spec.at, lambda a=armed: self._inject(a))
            if armed.spec.duration > 0:
                clock.call_at(
                    base + armed.spec.at + armed.spec.duration, lambda a=armed: self._clear(a)
                )
        clock.call_later(self.monitor_interval, self._tick)

    def _inject(self, armed: _Armed) -> None:
        armed.report.injected_at = self.pipeline.clock.now()
        armed.report.region = getattr(getattr(self.pipeline, "region", None), "name", None)
        # the replica count before the fault, for the report (callers check
        # the final count against it when the load holds still)
        armed.report.expected_replicas = self.pipeline.deployment.replicas
        restarts_before = len(self.pipeline.restart_log)
        armed.clear_fn = inject_fault(self.pipeline, armed.spec)
        # a restart fault's stats are in the restart log: the worst replay
        # gap of this fault's restarts goes on its report
        for entry in self.pipeline.restart_log[restarts_before:]:
            gap = entry.get("replay_gap_seconds")
            worst = armed.report.replay_gap
            if gap is not None and (worst is None or gap > worst):
                armed.report.replay_gap = gap
        if armed.spec.duration <= 0:  # an impulse: nothing to undo later
            self._clear(armed)

    def _clear(self, armed: _Armed) -> None:
        armed.report.cleared_at = self.pipeline.clock.now()
        if armed.clear_fn is not None:
            armed.clear_fn()
            armed.clear_fn = None

    def _healthy(self) -> bool:
        if self.plane is not None:
            return self.plane.healthy()
        return pipeline_healthy(self.pipeline)

    def _tick(self) -> None:
        now = self.pipeline.clock.now()
        current = next((a for a in self._armed if not a.resolved), None)
        if current is None:
            return  # every fault accounted: the tick chain stops
        report = current.report
        if report.injected_at is not None:
            healthy = self._healthy()
            if not healthy and report.detected_at is None:
                report.detected_at = now
            if report.cleared_at is not None:
                if report.first_good_sync_at is None:
                    last_good = self.pipeline.hpa.last_good_sync_at
                    if last_good is not None and last_good >= report.cleared_at:
                        report.first_good_sync_at = last_good
                if healthy:
                    if current.healthy_since is None:
                        current.healthy_since = now
                    if now - current.healthy_since >= self.stable_for:
                        report.recovered_at = current.healthy_since
                        current.resolved = True
                        self._annotate_trace(report)
                else:
                    current.healthy_since = None
        self.pipeline.clock.call_later(self.monitor_interval, self._tick)

    def _annotate_trace(self, report: RecoveryReport) -> None:
        """On a traced pipeline, emit a ``fault_window`` span whose start and
        end are the fault's injected → recovered window, and keep its id on
        the report: a scale event in the window can be read against it."""
        tracer = self.pipeline.tracer
        if tracer is None or report.injected_at is None:
            return
        attrs = {"fault": report.fault.name, "kind": report.fault.kind}
        if report.detected_at is not None:
            attrs["detected_at"] = report.detected_at
        if report.mttr is not None:
            attrs["mttr"] = report.mttr
        if report.replay_gap is not None:
            attrs["replay_gap"] = report.replay_gap
        if report.time_to_first_good_sync is not None:
            attrs["time_to_first_good_sync"] = report.time_to_first_good_sync
        span = tracer.emit("fault_window", attrs, start=report.injected_at, end=report.recovered_at)
        report.trace_span_id = span.span_id

    def all_recovered(self) -> bool:
        return all(a.report.recovered for a in self._armed)
