"""The whole slice on the CPU: load generator → TorchDeviceSource → exporter
daemon over HTTP → scrape → recording rule → adapter → HPA, through the
port's entry point ``run_headline_trial``, with the GEMM wrapper on its
plain version; and through the node exporter, ``run_node_headline_trial``
over the stub NVML library.  The headline trial drains after its scale-up,
as bench.py's does.  Then the same scripted load trace through the port's
trial loop and its overshoot probe twice, once over the port's planes and
once over the JAX package's, which must give identical timelines; and a
planted flapping behavior whose flaps the drain must count."""

import pytest
import torch

from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxVirtualClock
from k8s_gpu_hpa_tpu.metrics import exposition as jax_exposition
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import NvmlSource
from k8s_gpu_hpa_tpu_torch.exporter.stub_nvml import StubNvml
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen
from k8s_gpu_hpa_tpu_torch.metrics import exposition, schema
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.trial import (
    DUTY_SERIES,
    MAX_REPLICAS,
    REAL_POD,
    Pipeline,
    _Grid,
    run_headline_trial,
    run_node_headline_trial,
    run_overshoot_probe,
    run_trial,
    wire_pipeline,
)
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_pipeline import _jax_pipeline
from tests.test_torch_cores import confined_to_port_cores, keep_priority  # noqa: F401

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

#: control-plane periods times this, as bench.py's BENCH_TIME_SCALE
#: compresses its smoke run: in real time, pod start 2.4 s, HPA sync 3 s and
#: a 12 s budget leave room for a loaded host; virtual time needs none
REAL_TIME_SCALE = 0.2
VIRTUAL_TIME_SCALE = 0.1
#: bench.py's scale-down budget on a chip (``SCALE_DOWN_BUDGET_S``) and its
#: flaps, at time scale 1
SCALE_DOWN_BUDGET_S = 255.0
SCALE_DOWN_MAX_FLAPS = 0


def _scaled_up_then_drained(result, time_scale: float) -> None:
    """All replicas ran once, then the drain reached one replica within
    bench.py's budget, times ``time_scale``, without a flap."""
    assert (MAX_REPLICAS, MAX_REPLICAS) in [r[1:] for r in result.replicas]
    assert result.scale_up_s <= 60.0 * time_scale
    assert result.replicas[-1][1] == 1
    assert result.scale_down_s is not None
    assert result.scale_down_s <= SCALE_DOWN_BUDGET_S * time_scale
    assert result.scale_down_flaps == SCALE_DOWN_MAX_FLAPS


@pytest.mark.usefixtures("keep_priority")
def test_slice_on_cpu_scales_one_to_four(tmp_path):
    gen = MatmulLoadGen(size=256, use_kernel=True, intensity=0.2, window=0.5, device="cpu")
    gen.intensity_file = str(tmp_path / "intensity")  # absent: API knob only
    gen.warmup()
    result = run_headline_trial(gen, time_scale=REAL_TIME_SCALE, metric=DUTY_SERIES)
    _scaled_up_then_drained(result, REAL_TIME_SCALE)
    assert gen.stats().steps > 0
    # the duty-cycle average crossed 40 after the spike.  The CPU has no
    # peak to divide by, so the real pod serves no tensor-core gauge and the
    # series is absent until a mirror pod runs.
    assert max(duty for t, _, duty in result.series if t >= 0 and duty is not None) > 40.0
    assert all(tc is None for t, tc, _ in result.series if t < 0)


@pytest.mark.usefixtures("keep_priority")
def test_slice_on_cpu_scales_one_to_four_on_the_tensorcore_series(tmp_path):
    """``run_headline_trial``'s default, as bench.py runs its headline trial:
    the HPA reads the tensor-core average.  The CPU has no published peak,
    so the generator's is calibrated from a full-tilt step, as bench.py's
    CPU smoke run calibrates its own (make_gen)."""
    gen = MatmulLoadGen(size=256, use_kernel=True, intensity=1.0, window=0.5, device="cpu")
    gen.intensity_file = str(tmp_path / "intensity")  # absent: API knob only
    gen.warmup()
    assert gen.peak_tflops is None
    gen.step()
    gen.peak_tflops = max(gen.stats().achieved_tflops, 1e-9)
    result = run_headline_trial(gen, time_scale=REAL_TIME_SCALE)
    _scaled_up_then_drained(result, REAL_TIME_SCALE)
    # the real pod served the tensor-core gauge from the start, and its
    # average crossed the target after the spike
    assert all(tc is not None for _, tc, _ in result.series)
    assert max(tc for t, tc, _ in result.series if t >= 0) > 40.0


@pytest.mark.usefixtures("keep_priority")
def test_node_headline_trial_on_cpu_scales_one_to_four(tmp_path, monkeypatch):
    """``run_node_headline_trial``: NvmlSource over the stub NVML library as
    the card (NVML index 1 of two), the attribution the kubelet would give,
    and the generator's self-report merged into the tensor-core gauge the
    HPA reads."""
    stub = StubNvml(2)
    stub.set_utilization(1, 95)
    gen = MatmulLoadGen(size=256, use_kernel=True, intensity=1.0, window=0.5, device="cpu")
    gen.intensity_file = str(tmp_path / "intensity")  # absent: API knob only
    gen.warmup()
    gen.step()
    gen.peak_tflops = max(gen.stats().achieved_tflops, 1e-9)  # the CPU has no peak
    renders = []  # the exporter's /metrics, as the scraper fetched them
    fetch = trial.http_fetch
    monkeypatch.setattr(trial, "http_fetch", lambda port: renders.append(fetch(port)) or renders[-1])
    result = run_node_headline_trial(
        gen, str(tmp_path / "telemetry"), StaticAttributor({1: ("default", REAL_POD)}),
        source=NvmlSource(stub.path), time_scale=REAL_TIME_SCALE,
    )
    assert result.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert result.scale_up_s <= 60.0 * REAL_TIME_SCALE
    assert max(tc for t, tc, _ in result.series if t >= 0 and tc is not None) > 40.0
    real = {(f.name, dict(s.labels).get("chip")): s.value for f in parse_text(renders[-1])
            for s in f.samples if dict(s.labels).get("pod") == REAL_POD}
    # NVML's gauges for the card, and the tensor-core gauge only the merge gives
    assert real[(schema.TPU_DUTY_CYCLE, "1")] == 95.0
    assert real[(schema.TPU_CHIP_POWER, "1")] == 70.0
    assert (schema.TPU_TENSORCORE_UTIL, "1") in real
    assert not any(chip == "0" for _, chip in real)  # device 0 is no pod's
    assert stub.init_count() == 0  # the source was closed
    assert not (tmp_path / "telemetry" / f"default_{REAL_POD}.json").exists()  # report cleared


class ScriptedLoad:
    """A load generator stand-in on a virtual clock: its duty cycle is the
    commanded intensity averaged over a sliding window, as the generator's
    own windowed utilization would read."""

    def __init__(self, clock, window: float = 3.0):
        self.clock = clock
        self.window = window
        self.commands = [(clock.now(), 0.0)]

    def set_intensity(self, value: float) -> None:
        if value != self.commands[-1][1]:
            self.commands.append((self.clock.now(), value))

    def utilization(self, _chip_index: int = 0) -> float:
        now = self.clock.now()
        start = now - self.window
        ends = [t for t, _ in self.commands[1:]] + [now]
        busy = sum(
            v * max(0.0, min(t1, now) - max(t0, start))
            for (t0, v), t1 in zip(self.commands, ends)
        )
        return 100.0 * busy / self.window


def _real(mod_schema, mod_exposition, load):
    def fetch():
        duty = load.utilization()
        chip = mod_schema.ChipSample(0, 0.3 * duty, duty, 2e9, 85e9, None)
        return mod_exposition.encode_text(
            mod_schema.families_from_chips([chip], "real-0", {0: ("default", REAL_POD)})
        )

    return fetch


def _both_pipelines(time_scale: float, load=None):
    """The scripted load on a virtual clock and the headline loop around it,
    once over the port's planes and once over the JAX package's (scaled by
    ``time_scale`` as bench.py scales them): two (load, pipeline, clock)."""
    load = load or ScriptedLoad
    port_clock = VirtualClock()
    port_load = load(port_clock)
    port_pipe = wire_pipeline(
        _real(schema, exposition, port_load), port_load.utilization, port_clock, time_scale
    )
    jax_clock = JaxVirtualClock()
    jax_load = load(jax_clock)
    deployment, db, scraper, evaluator, hpa = _jax_pipeline(
        _real(jax_schema, jax_exposition, jax_load), jax_load.utilization, jax_clock, DUTY_SERIES
    )
    # bench.py scales the pod start latency and the behavior stanza the same way
    deployment.pod_start_latency *= time_scale
    for rules in (hpa.behavior.scale_up, hpa.behavior.scale_down):
        rules.stabilization_window_seconds *= time_scale
        for policy in rules.policies:
            policy.period_seconds *= time_scale
    jax_pipe = Pipeline(deployment, db, scraper, evaluator, hpa, DUTY_SERIES)
    return (port_load, port_pipe, port_clock), (jax_load, jax_pipe, jax_clock)


@pytest.mark.parametrize("time_scale", [1.0, VIRTUAL_TIME_SCALE])
def test_same_trace_through_both_packages_gives_identical_timelines(time_scale):
    """Through the scale-up and the drain back to one replica."""
    port_side, jax_side = _both_pipelines(time_scale)
    port = run_trial(*port_side, time_scale)
    ref = run_trial(*jax_side, time_scale)
    assert port.series == ref.series
    assert port.replicas == ref.replicas
    assert (port.scale_up_s, port.spike_to_cross_s) == (ref.scale_up_s, ref.spike_to_cross_s)
    assert (port.scale_down_s, port.scale_down_flaps) == (ref.scale_down_s, ref.scale_down_flaps)
    _scaled_up_then_drained(port, time_scale)


@pytest.mark.parametrize("time_scale", [1.0, VIRTUAL_TIME_SCALE])
def test_the_overshoot_probe_gives_the_jax_components_timeline(time_scale):
    """bench.py's probe over both packages' planes: the same syncs, the same
    readings and the same count.  At time scale 1 the 3 pods run 3 s
    before the next sync, which reads the scrape of its own tick: the load's
    3 s window has flushed to 33.33, below the band edge 44, and nothing
    overshoots (bench.py's bar on a chip).  At 0.1 the window is not scaled
    with the loop, the sync comes 0.3 s after the pods start and reads the
    full load still, and both overshoot to 4."""
    port_side, jax_side = _both_pipelines(time_scale)
    port_log, jax_log = [], []
    port = run_overshoot_probe(*port_side, time_scale, log=port_log.append)
    ref = run_overshoot_probe(*jax_side, time_scale, log=jax_log.append)
    assert port_log == jax_log
    assert port == ref == (0 if time_scale == 1.0 else 1)
    assert any("running=3" in line for line in port_log)


def test_the_loop_takes_each_due_time_on_its_grid():
    """A tick within half a tick of a due time takes it, and a late tick
    takes it late but moves none of the due times after it: a trial's
    scrapes keep their period however late the loop's ticks come."""
    grid = _Grid(0.0, 1.0, tick=0.05)
    ticks = [0.0, 0.7, 1.3, 1.98, 2.6, 3.4, 4.02, 4.5]
    assert [t for t in ticks if grid.due(t)] == [0.0, 1.3, 1.98, 3.4, 4.02]


class OscillatingLoad(ScriptedLoad):
    """Once the trial drops the load (the first command below 0.1), its
    duty cycle swings between 30 (3 of 4 replicas' worth) and 100 every
    20 s."""

    def __init__(self, clock, window: float = 3.0):
        super().__init__(clock, window)
        self.dropped_at = None

    def set_intensity(self, value: float) -> None:
        if value < 0.1 and self.dropped_at is None:
            self.dropped_at = self.clock.now()
        super().set_intensity(value)

    def utilization(self, _chip_index: int = 0) -> float:
        if self.dropped_at is None:
            return super().utilization()
        return 100.0 if int((self.clock.now() - self.dropped_at) // 20.0) % 2 else 30.0


@pytest.mark.parametrize("window", [0.0, None], ids=["no-window", "shipped-window"])
def test_a_drain_counts_the_flaps_of_a_load_that_oscillates(window):
    """The planted fault: a scale-down window of 0 under a load that swings
    after the drop scales down, then up again, and the drain counts the
    flaps, as both packages' planes do.  The shipped 120 s window holds the
    replicas through the swings: no flap, and no drain within its bound."""
    port_side, jax_side = _both_pipelines(1.0, OscillatingLoad)
    results = []
    for load, pipe, clock in (port_side, jax_side):
        if window is not None:
            pipe.hpa.behavior.scale_down.stabilization_window_seconds = window
        results.append(run_trial(load, pipe, clock))
    port, ref = results
    assert port.replicas == ref.replicas
    assert port.scale_down_flaps == ref.scale_down_flaps
    if window is None:
        assert port.scale_down_flaps == 0 and port.scale_down_s is None
        assert port.replicas[-1][1] == MAX_REPLICAS
    else:
        assert port.scale_down_flaps > SCALE_DOWN_MAX_FLAPS
