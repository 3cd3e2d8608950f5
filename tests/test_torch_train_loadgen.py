"""The training rung on the CPU: the port's ResNet training generator
(loadgen/train.py) against the JAX package's, its checkpoints and those of
the llm rung, both container entry points across a SIGTERM and a restart,
and the two-metric closed loop (trial.py ``run_train_trial``).

The training step is held against ``TrainLoadGen._train_step`` itself: the
same flax variables, carried across by ``params_from_jax``, and the JAX
batch reproduced from the generator's key; two steps, compared in the
loss, the parameters, the BatchNorm statistics and the momentum at 2e-4 in
f32 and 0.06 in bf16, at batch 8 and image 16: at image 8 stage 3 is one
pixel and its BatchNorms normalise over the batch's 4 values, where bf16's
roundings moved one element of 131,072 by 0.09 (f32 agrees there too).
The generator's other tests run at batch 4 and image 8."""

import dataclasses
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import bench
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.loadgen.train import TrainLoadGen as JaxTrainLoadGen
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.models import resnet as jr
from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.control.hpa import TRAIN_BW_SERIES, TRAIN_DUTY_SERIES, shipped_behavior
from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.train import TrainLoadGen, make_checkpoint_manager
from k8s_gpu_hpa_tpu_torch.metrics import schema
from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text, parse_text
from k8s_gpu_hpa_tpu_torch.models import resnet as pr
from k8s_gpu_hpa_tpu_torch.trial import (
    MAX_REPLICAS,
    TRAIN_POD,
    WindowedDuty,
    mirror_exposition,
    run_train_trial,
    train_spec,
    wire_pipeline,
)
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores, keep_priority  # noqa: F401

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy"
F32_TOL = 2e-4
BF16_TOL = 0.06
BATCH, IMAGE = 4, 8
#: the training step's parity size (the module docstring says why)
STEP_BATCH, STEP_IMAGE = 8, 16
REAL_TIME_SCALE = 0.2


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jax_batch(key):
    """The batch ``TrainLoadGen.step`` draws from ``key``, and the key after."""
    key, step_key = jax.random.split(key)
    img_key, lbl_key = jax.random.split(step_key)
    images = jax.random.normal(img_key, (STEP_BATCH, STEP_IMAGE, STEP_IMAGE, 3), jnp.float32)
    labels = jax.random.randint(lbl_key, (STEP_BATCH,), 0, 10)
    return key, np.asarray(images), np.asarray(labels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_training_steps_match_the_jax_train_step(dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jgen = JaxTrainLoadGen(mesh=make_mesh(1), batch_size=STEP_BATCH, image_size=STEP_IMAGE,
                           small=True, seed=7)
    jgen.model = jr.resnet18ish(10, dtype=getattr(jnp, dtype))  # read when the step traces
    gen = TrainLoadGen(batch_size=STEP_BATCH, image_size=STEP_IMAGE, small=True,
                       dtype=getattr(torch, dtype), device="cpu")
    gen.model.load_state_dict(pr.params_from_jax(
        {"params": _np(jgen.params), "batch_stats": _np(jgen.batch_stats)}))
    key = jgen._key
    for _ in range(2):
        key, images, labels = _jax_batch(key)
        jgen.step()
        loss = gen.train_step(torch.from_numpy(images.copy()).permute(0, 3, 1, 2),
                              torch.from_numpy(labels).long())
        assert abs(float(loss) - jgen.stats().last_loss) <= tol
    want = pr.params_from_jax({"params": _np(jgen.params), "batch_stats": _np(jgen.batch_stats)})
    got = gen.model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=tol, atol=tol,
                                   err_msg=name)
    trace = pr.params_from_jax({"params": _np(jgen.opt_state[0].trace),
                                "batch_stats": _np(jgen.batch_stats)})
    momentum = gen.checkpoint_state()["opt_state"]
    assert set(momentum) == {n for n, _ in gen.model.named_parameters()}
    for name, value in momentum.items():
        np.testing.assert_allclose(value.numpy(), trace[name].numpy(), rtol=tol, atol=tol,
                                   err_msg=name)


def test_run_for_steps_until_the_time_is_up_as_jax_s(monkeypatch):
    """``TrainLoadGen.run_for(seconds)``: steps while the clock is short of
    the end, then ``stats()``.  On a stubbed clock that each step moves by
    1 s both packages take three steps in 2.5 s over the same batches (the
    JAX generator's, reproduced from its key) and report JAX's stats, the
    loss within the f32 tolerance."""
    jgen = JaxTrainLoadGen(mesh=make_mesh(1), batch_size=STEP_BATCH, image_size=STEP_IMAGE,
                           small=True, seed=7)
    jgen.model = jr.resnet18ish(10, dtype=jnp.float32)  # read when the step traces
    gen = TrainLoadGen(batch_size=STEP_BATCH, image_size=STEP_IMAGE, small=True,
                       dtype=torch.float32, device="cpu")
    gen.model.load_state_dict(pr.params_from_jax(
        {"params": _np(jgen.params), "batch_stats": _np(jgen.batch_stats)}))
    key = jgen._key
    batches = []
    for _ in range(4):
        key, images, labels = _jax_batch(key)
        batches.append((torch.from_numpy(images.copy()).permute(0, 3, 1, 2),
                        torch.from_numpy(labels.copy()).long()))
    drawn = iter(batches)
    gen.batch = lambda: next(drawn)
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    for g in (jgen, gen):
        real = g.step

        def step(real=real):
            dt = real()
            now[0] += 1.0
            return dt

        g.step = step
    want = jgen.run_for(2.5)
    got = gen.run_for(2.5)
    assert got.steps == want.steps == 3
    assert (got.images_per_sec, got.utilization) == (want.images_per_sec, want.utilization)
    assert abs(got.last_loss - want.last_loss) <= F32_TOL
    assert gen.run_for(0.0) == gen.stats()  # no time: no step


def test_loadgen_steps_report_and_draw_seeded_channels_last_batches():
    gen = TrainLoadGen(batch_size=BATCH, image_size=IMAGE, small=True, dtype=torch.float32,
                       device="cpu")
    images, labels = gen.batch()
    assert images.shape == (BATCH, 3, IMAGE, IMAGE)
    assert images.is_contiguous(memory_format=torch.channels_last)
    assert labels.dtype == torch.int64 and 0 <= int(labels.min()) and int(labels.max()) < 10
    again = TrainLoadGen(batch_size=BATCH, image_size=IMAGE, small=True, dtype=torch.float32,
                         device="cpu")
    assert torch.equal(again.batch()[0], images)  # seeded: the same batch
    assert gen.stats().steps == 0 and gen.utilization() == 0.0
    busy = gen.step()
    stats = gen.stats()
    assert busy > 0 and stats.steps == 1 and math.isfinite(stats.last_loss)
    assert stats.images_per_sec == pytest.approx(BATCH / busy)
    assert 0.0 < stats.utilization <= 100.0


def test_loadgen_runs_on_cuda_unless_asked_for_the_cpu_and_refuses_a_mesh(monkeypatch):
    with pytest.raises(TypeError, match="torch DeviceMesh"):  # a JAX mesh
        TrainLoadGen(mesh=make_mesh(1), small=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoadGen(small=True)


# ---- checkpoints (tests/test_train_checkpoint.py's cases) -------------------


def _small_gen():
    return TrainLoadGen(batch_size=BATCH, image_size=IMAGE, small=True, seed=7,
                        dtype=torch.float32, device="cpu")


def _leaves(state, prefix=""):
    if isinstance(state, dict):
        return [x for k, v in state.items() for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(state, list):
        return [x for i, v in enumerate(state) for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix, state)]


def _same_state(a: dict, b: dict) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, name


def test_save_restore_roundtrip_resumes_exactly(tmp_path):
    manager = make_checkpoint_manager(str(tmp_path / "ckpts"))
    gen = _small_gen()
    for _ in range(3):
        gen.step()
    gen.save_checkpoint(manager)
    manager.wait_until_finished()

    fresh = _small_gen()
    assert fresh.restore_checkpoint(manager)
    assert fresh.stats().steps == 3
    # params, BatchNorm statistics, momentum, the batch generator and busy
    _same_state(gen.checkpoint_state(), fresh.checkpoint_state())
    gen.step()
    fresh.step()
    assert gen.stats().last_loss == fresh.stats().last_loss
    manager.close()


def test_restore_without_checkpoint_returns_false(tmp_path):
    manager = make_checkpoint_manager(str(tmp_path / "ckpts"))
    gen = _small_gen()
    assert gen.restore_checkpoint(manager) is False
    assert gen.stats().steps == 0


def test_checkpoint_rotation_keeps_the_two_newest(tmp_path):
    manager = make_checkpoint_manager(str(tmp_path / "ckpts"))
    gen = _small_gen()
    for _ in range(4):
        gen.step()
        gen.save_checkpoint(manager)
    assert manager.latest_step() == 4
    assert manager.all_steps() == [3, 4]
    fresh = _small_gen()
    assert fresh.restore_checkpoint(manager)
    assert fresh.stats().steps == 4


_KILLED_MID_SAVE = """
import os, signal, sys, torch
from k8s_gpu_hpa_tpu_torch.loadgen.train import make_checkpoint_manager
manager = make_checkpoint_manager(sys.argv[1])
manager.save(1, {"x": torch.ones(4), "step": 1})
os.replace = lambda *a: os.kill(os.getpid(), signal.SIGKILL)  # killed before the rename
manager.save(2, {"x": torch.full((4,), 2.0), "step": 2})
"""


def test_a_kill_between_the_write_and_the_rename_leaves_the_last_good_step(tmp_path):
    directory = tmp_path / "ckpts"
    proc = subprocess.run([sys.executable, "-c", _KILLED_MID_SAVE, str(directory)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert [p.name for p in directory.iterdir() if p.name.startswith(".tmp-")]  # the torn write
    manager = make_checkpoint_manager(str(directory))
    assert manager.all_steps() == [1]
    assert not [p for p in directory.iterdir() if p.name.startswith(".tmp-")]
    assert torch.equal(manager.restore(1)["x"], torch.ones(4))


def _small_llm():
    return LlmLoadGen(seq_per_device=64, d_model=64, n_heads=2, n_layers=2, dtype=torch.float32,
                      lr=0.5, device="cpu")


def test_llm_save_restore_roundtrip_resumes_exactly(tmp_path):
    manager = make_checkpoint_manager(str(tmp_path / "ckpts"))
    gen = _small_llm()
    assert gen.restore_checkpoint(manager) is False
    for _ in range(2):
        gen.step()
    gen.save_checkpoint(manager)
    fresh = _small_llm()
    assert fresh.restore_checkpoint(manager)
    assert fresh.stats().steps == 2 and fresh.stats().seconds == gen.stats().seconds
    _same_state(gen.checkpoint_state(), fresh.checkpoint_state())
    gen.step()
    fresh.step()
    assert gen.stats().last_loss == fresh.stats().last_loss


_TRAIN_MAIN = "from k8s_gpu_hpa_tpu_torch.loadgen.train import main; main(device='cpu')"
_LLM_MAIN = "from k8s_gpu_hpa_tpu_torch.loadgen.multihost import main; main(device='cpu')"
_ENTRIES = {
    "train": (_TRAIN_MAIN, {"BATCH_SIZE": "4", "IMAGE_SIZE": "8", "SMALL_MODEL": "1"}),
    "llm": (_LLM_MAIN, {"WORKLOAD": "llm", "SEQ_PER_DEVICE": "64", "D_MODEL": "64",
                        "N_HEADS": "2", "N_LAYERS": "1"}),
}


def _steps(lines: list[str]) -> list[int]:
    return [int(dict(f.split("=", 1) for f in ln.split())["steps"])
            for ln in lines if ln.startswith("steps=")]


def _run_until_sigterm(code: str, env: dict, min_steps: int) -> list[str]:
    """Start an entry point, read until a report of at least ``min_steps``
    steps, SIGTERM it; every line it printed (it must exit 0)."""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines = []
    try:
        deadline = time.monotonic() + 120
        while not any(n >= min_steps for n in _steps(lines)):
            line = proc.stdout.readline()
            if not line or time.monotonic() > deadline:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    return lines + out.splitlines()


def _final_step(lines: list[str]) -> int:
    (final,) = [ln for ln in lines if ln.startswith("final checkpoint at step ")]
    return int(final.rsplit(" ", 1)[1])


@pytest.mark.parametrize("entry", ["train", "llm"])
def test_entry_point_saves_on_sigterm_and_resumes_from_that_step(entry, tmp_path):
    code, sizes = _ENTRIES[entry]
    env = {
        **{k: v for k, v in os.environ.items() if k not in ("HOSTS_PER_SLICE", "PROFILE_S")},
        **sizes, "REPORT_S": "0.2", "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
        "CHECKPOINT_EVERY": "100000", "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob"),
    }
    # the first run saves once, on SIGTERM
    first = _run_until_sigterm(code, env, min_steps=3)
    assert not any(ln.startswith("resumed") for ln in first)
    saved = _final_step(first)
    assert saved > 0
    manager = make_checkpoint_manager(env["CHECKPOINT_DIR"])
    assert manager.all_steps() == [saved]
    # the second resumes there and saves every 3 steps (and on SIGTERM, where
    # its last periodic save is older than its last step)
    second = _run_until_sigterm(code, {**env, "CHECKPOINT_EVERY": "3"}, min_steps=saved + 8)
    assert second[0] == f"resumed from step {saved} in {env['CHECKPOINT_DIR']}"
    steps = _steps(second)
    assert steps and min(steps) > saved and max(steps) >= saved + 8  # the count goes on
    assert len(manager.all_steps()) == 2 and manager.latest_step() >= steps[-1]
    assert manager.all_steps()[0] > saved


# ---- the two-metric closed loop ---------------------------------------------

TRAIN_HPA = yaml.safe_load((DEPLOY / "tpu-train-hpa.yaml").read_text())


def test_train_loop_equals_the_hpa_manifest_and_the_rule_group():
    spec = train_spec()
    want = jax_hpa.metrics_from_manifest(TRAIN_HPA)
    assert [(m.metric_name, m.target_value, m.described_object.kind, m.described_object.name)
            for m in spec.metrics] == [
        (m.metric_name, m.target_value, m.described_object.kind, m.described_object.name)
        for m in want]
    assert [m.metric_name for m in spec.metrics] == [TRAIN_DUTY_SERIES, TRAIN_BW_SERIES]
    assert spec.app == TRAIN_HPA["spec"]["scaleTargetRef"]["name"] == "tpu-train"
    assert (TRAIN_HPA["spec"]["minReplicas"], TRAIN_HPA["spec"]["maxReplicas"]) == (1, MAX_REPLICAS)
    assert dataclasses.asdict(shipped_behavior()) == dataclasses.asdict(
        jax_hpa.behavior_from_manifest(TRAIN_HPA))
    for rule, (gauge, record) in zip(spec.rules, ((jax_schema.TPU_DUTY_CYCLE, TRAIN_DUTY_SERIES),
                                                  (jax_schema.TPU_HBM_BW_UTIL, TRAIN_BW_SERIES)),
                                     strict=True):
        ref = jax_rules.tpu_test_avg_rule(app="tpu-train", deployment="tpu-train", metric=gauge,
                                          record=record)
        assert (rule.record, rule.labels) == (ref.record, ref.labels)
        assert rule.expr.child.left.child.name == gauge


def test_mirror_pods_export_the_duty_cycle_and_no_bandwidth():
    deployment = trial.MirrorDeployment(VirtualClock(), 0.0, TRAIN_POD, "tpu-train")
    deployment.scale_to(3)
    families = {f.name: f for f in parse_text(
        mirror_exposition(deployment, 80.0, train_spec().mirror_chip))}
    duty = [s.value for s in families[schema.TPU_DUTY_CYCLE].samples]
    assert duty == [80.0, 80.0]
    assert not families.get(schema.TPU_HBM_BW_UTIL) or not families[schema.TPU_HBM_BW_UTIL].samples


def _one_sync(duty: float, bw: float | None):
    """One scrape, rule pass and HPA sync of the training loop over a real
    pod that serves ``duty`` and ``bw`` (None: the gauge is absent)."""
    clock = VirtualClock()

    def real() -> str:
        chips = [schema.ChipSample(0, None, duty, 0.0, 0.0, bw)]
        return encode_text(schema.families_from_chips(chips, "real-0", {0: ("default", TRAIN_POD)}))

    pipe = wire_pipeline(real, lambda: duty, clock, spec=train_spec())
    clock.sleep(1.0)
    pipe.scraper.scrape_once()
    pipe.evaluator.evaluate_once()
    pipe.hpa.sync_once()
    return pipe


@pytest.mark.parametrize("duty, bw, replicas, seen", [
    (100.0, None, 2, {TRAIN_DUTY_SERIES}),  # bandwidth absent: duty alone decides
    (20.0, None, 1, {TRAIN_DUTY_SERIES}),
    (20.0, 60.0, 2, {TRAIN_DUTY_SERIES, TRAIN_BW_SERIES}),  # bandwidth decides
    (20.0, 25.0, 1, {TRAIN_DUTY_SERIES, TRAIN_BW_SERIES}),
])
def test_the_hpa_takes_the_largest_proposal_of_the_metrics_it_has(duty, bw, replicas, seen):
    pipe = _one_sync(duty, bw)
    assert pipe.deployment.replicas == replicas
    assert set(pipe.hpa.status.last_metric_values) == seen


def test_windowed_duty_matches_bench_s(monkeypatch):
    """The same busy records at the same times through the port's window and
    bench.py's ``_WindowedDuty``."""
    now = [100.0]
    monkeypatch.setattr(trial.time, "perf_counter", lambda: now[0])
    ours, theirs = WindowedDuty(3.0), bench._WindowedDuty(3.0)
    readings = []
    for dt, busy in [(0.0, 0.5), (0.5, 0.2), (1.0, 1.0), (2.5, 0.1), (4.0, 0.0), (9.0, 0.3)]:
        now[0] += dt
        ours.record(busy)
        theirs.record(busy)
        now[0] += 0.25
        readings.append((ours.value(), theirs.value()))
    assert all(a == pytest.approx(b) for a, b in readings), readings
    assert WindowedDuty().value() == 0.0


@pytest.mark.usefixtures("keep_priority")
def test_train_trial_on_cpu_scales_one_to_four_on_duty_alone():
    gen = TrainLoadGen(batch_size=8, image_size=IMAGE, small=True, dtype=torch.float32,
                       device="cpu")
    gen.warmup()
    result = run_train_trial(gen, time_scale=REAL_TIME_SCALE)
    assert result.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert result.scale_up_s <= 60.0 * REAL_TIME_SCALE
    # the duty-cycle average crossed 50 after the spike; no bandwidth series
    # ever existed, and the HPA had the duty cycle alone at every sync
    assert max(d for t, d, _ in result.series if t >= 0 and d is not None) > 50.0
    assert all(bw is None for _, _, bw in result.series)
    assert result.metrics and all(
        m[TRAIN_BW_SERIES] is None and m[TRAIN_DUTY_SERIES] is not None for _, m in result.metrics)
    assert gen.stats().steps > 0
