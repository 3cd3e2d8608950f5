"""The External-metric plane on a virtual clock (``control/external_sim.py``)
against the JAX package's, and bench.py's External rung
(``run_external_queue_trial``).

- The port's sim built from the generator's queue HPA
  (``manifests.external_hpa_doc()``) and JAX's built from the shipped
  deploy/tpu-test-external-hpa.yaml, driven by the same seeded demand:
  the same replicas, reasons, metric values and condition histories at
  every sync.
- The rung: 40 queued, 240 from 10 s, a sync every 15 s; 3 replicas 5.0 s
  after the spike, as bench.py's rung records it (BENCH_r05.json), and the
  drain back to one replica under the shipped behavior, as JAX's sim drains.
- The queue's path on a node (``QueueJoint``) around the serving container
  run on the CPU as its own process: the served depth is the one its
  telemetry file held, the HPA proposes JAX's formula, the queue drains at
  knob 0 and the container exits 0 on SIGTERM.
"""

import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu.control.external_sim import (
    external_sim_from_manifest as jax_external_sim_from_manifest,
)
from k8s_gpu_hpa_tpu_torch import manifests
from k8s_gpu_hpa_tpu_torch.control.external_sim import ScaleTarget, external_sim_from_manifest
from k8s_gpu_hpa_tpu_torch.exporter.podresources import StaticAttributor
from k8s_gpu_hpa_tpu_torch.exporter.sources import StubSource
from k8s_gpu_hpa_tpu_torch.trial import QueueJoint, run_external_queue_trial
from tests.test_torch_cores import confined_to_port_cores, keep_priority  # noqa: F401
from tests.test_torch_mesh import QUIET

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHIPPED = yaml.safe_load((REPO / "deploy" / "tpu-test-external-hpa.yaml").read_text())


def test_the_generator_s_queue_hpa_is_the_shipped_manifest():
    assert manifests.external_hpa_doc() == SHIPPED


def _drive(sim, demand, syncs_every: float = 15.0) -> list[tuple]:
    """Publish ``demand[t]`` each second and sync every ``syncs_every``."""
    out = []
    next_sync = syncs_every
    for value in demand:
        now = sim.clock.now()
        sim.publish(float(value))
        if now >= next_sync:
            status = sim.hpa.sync_once()
            next_sync += syncs_every
            out.append((now, sim.target.replicas, status.desired_replicas, status.last_reason,
                        dict(status.last_metric_values),
                        [c.as_k8s() for c in status.conditions.values()]))
        sim.clock.advance(1.0)
    out.append(list(sim.hpa.condition_history))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_sim_decides_as_jax_s_on_the_same_demand(seed):
    """A random walk of queued requests, 0..600, for 20 minutes."""
    rng = np.random.default_rng(seed)
    demand = np.clip(np.cumsum(rng.normal(0.0, 25.0, 1200)) + 200.0, 0.0, 600.0)
    port = external_sim_from_manifest(manifests.external_hpa_doc())
    ref = jax_external_sim_from_manifest(SHIPPED)
    assert port.labels == ref.labels == (("namespace", "default"), ("queue", "tpu-serve"))
    got = _drive(port, demand)
    assert got == _drive(ref, demand)
    # the walk moves the replicas both ways
    replicas = {row[1] for row in got[:-1]}
    assert len(replicas) > 1


def test_the_sim_scopes_by_namespace_as_jax_s():
    for build, doc in ((external_sim_from_manifest, manifests.external_hpa_doc()),
                       (jax_external_sim_from_manifest, SHIPPED)):
        sim = build(doc, namespace="prod")
        sim.publish(500.0)
        sim.clock.advance(15.0)
        sim.hpa.sync_once()
        # the spec's namespace is the manifest's default: a prod series is not read
        assert sim.target.replicas == 1
        assert sim.hpa.status.last_reason == "metrics unavailable; holding"


def test_a_manifest_without_one_external_metric_is_refused_as_jax_s():
    hbm = manifests.hbm_hpa_doc()
    for build in (external_sim_from_manifest, jax_external_sim_from_manifest):
        with pytest.raises(ValueError, match="PodsMetricSpec"):
            build(hbm)
    two = manifests.external_hpa_doc()
    two["spec"]["metrics"] *= 2
    with pytest.raises(ValueError, match="single External"):
        external_sim_from_manifest(two)


def test_scale_target():
    target = ScaleTarget(2)
    target.scale_to(3)
    assert target.replicas == 3


def _bench_external_queue() -> dict:
    """bench.py's External rung as BENCH_r05.json recorded it."""
    tail = json.loads((REPO / "BENCH_r05.json").read_text())["tail"]
    return json.loads(re.search(r'"external_queue": (\{[^}]*\})', tail).group(1))


def test_the_external_rung_reaches_bench_s_numbers():
    bench = _bench_external_queue()
    result = run_external_queue_trial()
    assert result.spike_to_desired_s == bench["spike_to_desired_s"] == 5.0
    assert result.replicas_reached == bench["replicas_reached"] == 3
    assert result.syncs == [(15.0, 3, "scale up 1->3 (policy limit 3)")]


def test_the_queue_drains_to_one_replica_as_jax_s_sim_drains():
    """After the spike, the queue falls back to 40: the replicas hold for
    the 120 s window, then halve at most every 60 s, to 1."""
    timelines = []
    for build, doc in ((external_sim_from_manifest, manifests.external_hpa_doc()),
                       (jax_external_sim_from_manifest, SHIPPED)):
        sim = build(doc)
        demand = [40.0] * 10 + [240.0] * 20 + [40.0] * 300
        timelines.append(_drive(sim, demand))
        assert sim.target.replicas == 1
    assert timelines[0] == timelines[1]
    changes = [(t, r) for t, r, *_ in timelines[0][:-1]]
    first_down = next(t for t, r in changes if t > 30.0 and r < 3)
    assert first_down >= 30.0 + 120.0 - 15.0
    assert [r for _, r in changes][-1] == 1


#: the serving container on the CPU: the port's entry point with the device
#: given, as the TP serving test runs it
_SERVE_MAIN = "from k8s_gpu_hpa_tpu_torch.loadgen import decode; decode.main(device='cpu')"
POD = "tpu-serve-real"


def _proposal(total: float, current: int = 1) -> int:
    """JAX's formula for the queue HPA from one replica: ceil(current ×
    total / current / 100) outside the 10% band, within 1..4 and the
    shipped policy's limit of 3 (max of +2 pods and +100%) a period."""
    ratio = total / current / 100.0
    if abs(ratio - 1.0) <= 0.1:
        return current
    return min(max(math.ceil(current * ratio), 1), 4, max(current + 2, 2 * current))


def test_the_serving_container_s_queue_reaches_the_queue_hpa(tmp_path):
    """The CPU twin of the card's queue_external phase: the serving
    container's self-reported depth, merged by the node exporter, served on
    external.metrics.k8s.io as the telemetry file held it; the queue HPA's
    proposal from one replica; the drain at knob 0; exit 0 on SIGTERM,
    the report removed."""
    telemetry, knob = tmp_path / "telemetry", tmp_path / "knob"
    knob.write_text("1.0")
    env = {**{k: v for k, v in os.environ.items()
              if k not in ("COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE",
                           "MODEL_PARALLELISM")},
           **QUIET, "WORKLOAD": "decode", "DECODE_BATCH": "2", "MAX_SEQ": "64", "D_MODEL": "64",
           "N_HEADS": "2", "N_LAYERS": "1", "PREFILL_LEN": "8", "REPORT_S": "0.5",
           "QUEUE_NAME": "tpu-serve", "TPU_TELEMETRY_DIR": str(telemetry), "POD_NAME": POD,
           "POD_NAMESPACE": "default", "TPU_TEST_INTENSITY": "1.0",
           "TPU_TEST_INTENSITY_FILE": str(knob)}
    proc = subprocess.Popen([sys.executable, "-c", _SERVE_MAIN], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    joint = None
    try:
        report = telemetry / f"default_{POD}.json"
        deadline = time.monotonic() + 120
        while not report.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert report.exists(), proc.poll()
        joint = QueueJoint(StubSource(num_chips=1), StaticAttributor({0: ("default", POD)}),
                           str(telemetry), POD)
        first, served_first = joint.sweep()
        time.sleep(1.0)
        depth, served = joint.sweep()
        assert served_first == [first] and served == [depth] and depth > first
        status = joint.hpa.sync_once()
        assert status.last_metric_values["external/tpu_test_queue_depth"] == depth
        assert joint.target.replicas == status.desired_replicas == _proposal(depth)
        knob.write_text("0")
        deadline = time.monotonic() + 60
        while depth >= 1.0 and time.monotonic() < deadline:
            time.sleep(0.2)
            depth, served = joint.sweep()
            assert served == [depth]
        assert depth < 1.0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if joint is not None:
            joint.close()
        proc.kill()
    assert proc.returncode == 0, out
    assert not report.exists()
    (stopped,) = [ln for ln in out.splitlines() if ln.startswith("stopped: ")]
    assert stopped.endswith(" flash=0")  # the CPU runs the plain attention


@pytest.mark.parametrize("total,want", [(40.0, 1), (105.0, 1), (111.0, 2), (240.0, 3),
                                        (5000.0, 3), (0.0, 1)])
def test_the_proposal_formula_is_the_controller_s(total, want):
    assert _proposal(total) == want
    sim = external_sim_from_manifest(manifests.external_hpa_doc())
    sim.publish(total)
    sim.clock.advance(15.0)
    sim.publish(total)
    sim.hpa.sync_once()
    assert sim.target.replicas == want
