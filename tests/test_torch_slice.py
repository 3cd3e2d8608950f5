"""The whole slice on the CPU: load generator → TorchDeviceSource → exporter
daemon over HTTP → scrape → recording rule → adapter → HPA, through the
port's entry point ``run_headline_trial``, with the GEMM wrapper on its
plain version; and through the node exporter, ``run_node_headline_trial``
over the stub NVML library.  Then the same scripted load trace through the port's trial
loop twice, once over the port's planes and once over the JAX package's,
which must give identical timelines."""

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
    run_headline_trial,
    run_node_headline_trial,
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


@pytest.mark.usefixtures("keep_priority")
def test_slice_on_cpu_scales_one_to_four(tmp_path):
    gen = MatmulLoadGen(size=256, use_kernel=True, intensity=0.2, window=0.5, device="cpu")
    gen.intensity_file = str(tmp_path / "intensity")  # absent: API knob only
    gen.warmup()
    result = run_headline_trial(gen, time_scale=REAL_TIME_SCALE, metric=DUTY_SERIES)
    assert result.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert result.scale_up_s <= 60.0 * REAL_TIME_SCALE
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
    assert result.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert result.scale_up_s <= 60.0 * REAL_TIME_SCALE
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


@pytest.mark.parametrize("time_scale", [1.0, VIRTUAL_TIME_SCALE])
def test_same_trace_through_both_packages_gives_identical_timelines(time_scale):
    port_clock = VirtualClock()
    port_load = ScriptedLoad(port_clock)
    port_pipe = wire_pipeline(
        _real(schema, exposition, port_load), port_load.utilization, port_clock, time_scale
    )
    port = run_trial(port_load, port_pipe, port_clock, time_scale)

    jax_clock = JaxVirtualClock()
    jax_load = ScriptedLoad(jax_clock)
    deployment, db, scraper, evaluator, hpa = _jax_pipeline(
        _real(jax_schema, jax_exposition, jax_load), jax_load.utilization, jax_clock, DUTY_SERIES
    )
    # bench.py scales the pod start latency and the behavior stanza the same way
    deployment.pod_start_latency *= time_scale
    for rules in (hpa.behavior.scale_up, hpa.behavior.scale_down):
        rules.stabilization_window_seconds *= time_scale
        for policy in rules.policies:
            policy.period_seconds *= time_scale
    ref = run_trial(
        jax_load, Pipeline(deployment, db, scraper, evaluator, hpa, DUTY_SERIES),
        jax_clock, time_scale,
    )
    assert port.series == ref.series
    assert port.replicas == ref.replicas
    assert (port.scale_up_s, port.spike_to_cross_s) == (ref.scale_up_s, ref.spike_to_cross_s)
    assert port.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert port.scale_up_s <= 60.0 * time_scale
