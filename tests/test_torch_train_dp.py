"""Data-parallel ResNet training on the CPU: the port's ``TrainLoadGen``
over a mesh of gloo ranks against flax's training step on the global batch.

Each rank of a world of 2, and of a (2, 2) mesh, takes its data shard of one
global batch of 8 images of 16 pixels (``SMALL_MODEL``, f32) and one step
from flax's initial variables; the assembled logits, the global loss, the
parameters and the BatchNorm running statistics must agree with flax's
step on the whole batch at 2e-4.  The batch's halves are drawn from N(0, 1)
and N(2, 1): per-shard statistics of N(0, 1) images differ from the global
ones by little, and would pass.  Three planted faults must fail the same
check: BatchNorm statistics over each rank's shard, the fold's count left
at the shard's, and the gradients summed without the ``1/n_data``.

The ranks are processes started through the port's launcher
(``multihost.launch``), so their bodies live here at top level, and this
module imports JAX inside the tests only: a rank never loads it."""

import math
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from k8s_gpu_hpa_tpu_torch.loadgen.multihost import free_port
from k8s_gpu_hpa_tpu_torch.loadgen.train import TrainLoadGen, make_checkpoint_manager
from k8s_gpu_hpa_tpu_torch.models import resnet as pr
from k8s_gpu_hpa_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_mesh import JOIN_S, QUIET, REPO, _save, run_ranks

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 2e-4
BATCH, IMAGE, SEED = 8, 16, 7
FAULTS = ("per_shard_stats", "local_count", "summed_grads")


def global_batch() -> tuple[np.ndarray, np.ndarray]:
    """NHWC images, the first half N(0, 1) and the second N(2, 1), and labels."""
    rng = np.random.default_rng(SEED)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    images[BATCH // 2:] += 2.0
    return images, rng.integers(0, 10, BATCH)


def _tensors(images: np.ndarray, labels: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.from_numpy(images), torch.from_numpy(labels).long()


def _gen(state: dict, mesh=None) -> TrainLoadGen:
    gen = TrainLoadGen(mesh=mesh, batch_size=BATCH, image_size=IMAGE, small=True, seed=SEED,
                       dtype=torch.float32, device="cpu")
    gen.model.load_state_dict(state)
    return gen


def _plant(gen: TrainLoadGen, fault: str) -> None:
    if fault == "per_shard_stats":
        gen.model.set_data_group(None)
    elif fault == "local_count":
        fold = gen.model.fold_batch_stats

        def fold_with_local_count():
            for m in gen.model.modules():
                if isinstance(m, pr.BatchNorm) and m.count:
                    m.count //= gen.n_data
            fold()

        gen.model.fold_batch_stats = fold_with_local_count
    elif fault == "summed_grads":
        gen._grad_scale = 1.0


def _step(gen: TrainLoadGen, images: torch.Tensor, labels: torch.Tensor) -> dict:
    """One step on this rank's data shard; the shard's logits, the loss, the
    state after."""
    rows = BATCH // gen.n_data
    shard = slice(gen.data_index * rows, (gen.data_index + 1) * rows)
    seen = {}
    hook = gen.model.head.register_forward_hook(lambda m, a, out: seen.update(logits=out.detach()))
    loss = gen.train_step(images[shard].permute(0, 3, 1, 2), labels[shard])
    hook.remove()
    return {"data_index": gen.data_index, "loss": float(loss), "logits": seen["logits"].numpy(),
            "state": {k: v.numpy().copy() for k, v in gen.model.state_dict().items()}}


def dp_step_rank(out_dir, state, images, labels, model_parallelism, cases, ckpt_dir) -> None:
    """A rank of the data-parallel run: one step from ``state`` for each of
    ``cases`` ("right" and the planted faults); with ``ckpt_dir``, then a
    save of the right step's generator and its restore into a fresh one."""
    torch.set_num_threads(1)
    mesh = make_mesh(model_parallelism=model_parallelism)
    out = {}
    for case in cases:
        gen = _gen(state, mesh)
        _plant(gen, case)
        out[case] = _step(gen, images, labels)
        if case == "right":
            right = gen
    if ckpt_dir is not None:
        right.step()  # a step on its own draw: the generators move
        manager = make_checkpoint_manager(ckpt_dir)
        right.save_checkpoint(manager)
        dist.barrier()
        fresh = _gen(state, mesh)
        restored = fresh.restore_checkpoint(manager)
        want, got = right.checkpoint_state(), fresh.checkpoint_state()
        same = all(torch.equal(want["params"][k], got["params"][k]) for k in want["params"])
        same &= all(torch.equal(want["opt_state"][k], got["opt_state"][k])
                    for k in want["opt_state"])
        losses = [float(g.train_step(*g.batch())) for g in (right, fresh)]
        out["restore"] = {"dir": ckpt_dir, "restored": restored, "same_state": same,
                          "key": fresh._gen.get_state(),
                          "own_key": torch.equal(fresh._gen.get_state(), right._gen.get_state()),
                          "key_rows": want["key"].shape[0], "losses": losses,
                          "step": fresh.stats().steps}
    try:
        TrainLoadGen(mesh=mesh, batch_size=7, image_size=IMAGE, small=True, device="cpu")
    except ValueError as e:
        out["uneven"] = str(e)
    out["jax_loaded"] = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    _save(out_dir, out)


@pytest.fixture(scope="module")
def flax_step():
    """Flax's variables (its BatchNorm leaves redrawn, as tests/test_torch_resnet.py
    does: flax's zero ``bn3`` scales would hide the residual branches), as a
    port state dict, and the JAX generator's step (``TrainLoadGen._train_step``
    but for the draw: its model in f32, its optimizer) on the whole global
    batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from k8s_gpu_hpa_tpu.models import resnet as jr
    from tests.test_torch_resnet import _variables

    # the JAX generator's optimizer at its default learning rate
    # (k8s_gpu_hpa_tpu/loadgen/train.py:58), built alone: building the
    # generator would initialise a second model, eagerly
    tx = optax.sgd(0.1, momentum=0.9)
    model = jr.resnet18ish(10, dtype=jnp.float32)
    # flax's init jitted: eagerly it takes some 18 s on the CPU
    jitted = types.SimpleNamespace(init=jax.jit(model.init, static_argnames="train"))
    variables = _variables(jitted, (BATCH, IMAGE, IMAGE, 3), seed=SEED)
    images, labels = global_batch()

    def loss_fn(params):
        logits, updates = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      jnp.asarray(images), train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()
        return loss, (logits, updates["batch_stats"])

    @jax.jit
    def step(params):
        (loss, (logits, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, logits, optax.apply_updates(params, updates), stats

    loss, logits, params, stats = step(jax.tree.map(jnp.asarray, variables["params"]))
    after = pr.params_from_jax({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, stats)})
    return {"state": pr.params_from_jax(variables), "loss": float(loss),
            "logits": np.asarray(logits), "after": {k: v.numpy() for k, v in after.items()}}


def _assemble(ranks: list, case: str) -> tuple[float, np.ndarray]:
    """The global batch's logits from each data index's first rank; the
    loss every rank reported (all equal)."""
    by_index = {}
    for r in ranks:
        by_index.setdefault(r[case]["data_index"], r[case]["logits"])
    losses = {r[case]["loss"] for r in ranks}
    assert len(losses) == 1, losses
    return losses.pop(), np.concatenate([by_index[i] for i in sorted(by_index)])


def _check(ranks: list, case: str, want: dict) -> None:
    loss, logits = _assemble(ranks, case)
    assert abs(loss - want["loss"]) <= TOL, (loss, want["loss"])
    np.testing.assert_allclose(logits, want["logits"], rtol=TOL, atol=TOL)
    for r in ranks:
        for name, value in want["after"].items():
            np.testing.assert_allclose(r[case]["state"][name], value, rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.fixture(scope="module")
def world_two(flax_step, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp2")
    images, labels = global_batch()
    return run_ranks(dp_step_rank, 2, out, flax_step["state"], *_tensors(images, labels), 1,
                     ("right", *FAULTS), str(out / "ckpt"))


@pytest.fixture(scope="module")
def mesh_two_by_two(flax_step, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp22")
    images, labels = global_batch()
    return run_ranks(dp_step_rank, 4, out, flax_step["state"], *_tensors(images, labels), 2,
                     ("right",),
                     None)


def test_the_batch_halves_differ_so_per_shard_statistics_cannot_pass():
    images, _ = global_batch()
    halves = images[: BATCH // 2].mean(), images[BATCH // 2:].mean()
    assert halves[1] - halves[0] > 1.5


@pytest.mark.parametrize("layout", ["world_two", "mesh_two_by_two"])
def test_one_data_parallel_step_matches_flax_on_the_global_batch(layout, request, flax_step):
    ranks = request.getfixturevalue(layout)
    _check(ranks, "right", flax_step)
    # model-axis replicas took the same shard and hold the same state
    assert {r["right"]["data_index"] for r in ranks} == {0, 1}
    assert all(r["jax_loaded"] == [] for r in ranks)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_parity_check(fault, world_two, flax_step):
    with pytest.raises(AssertionError):
        _check(world_two, fault, flax_step)


def test_the_checkpoint_restores_across_two_ranks(world_two):
    for rank, r in enumerate(world_two):
        got = r["restore"]
        assert got["restored"] and got["same_state"] and got["step"] == 1, (rank, got)
        # rank 0 wrote every data index's generator; each rank took its own
        assert got["key_rows"] == 2 and got["own_key"], (rank, got)
        # the restored generator steps on exactly as the saved one
        assert got["losses"][0] == got["losses"][1] and math.isfinite(got["losses"][0])
    # the data indices draw from generators of their own
    assert not torch.equal(world_two[0]["restore"]["key"], world_two[1]["restore"]["key"])


def test_a_restore_on_a_data_axis_of_another_size_raises(world_two, flax_step):
    gen = _gen(flax_step["state"])
    with pytest.raises(ValueError, match="data axis of 2 ranks; this mesh has 1"):
        gen.restore_checkpoint(make_checkpoint_manager(world_two[0]["restore"]["dir"]))


def test_a_checkpoint_of_the_single_device_format_restores(tmp_path, flax_step):
    """A checkpoint whose ``key`` is one generator's state, not a row a data
    index, restores as a data axis of one: the generator steps on as saved."""
    gen = _gen(flax_step["state"])
    gen.step()
    state = gen.checkpoint_state()
    state["key"] = gen._gen.get_state()
    manager = make_checkpoint_manager(str(tmp_path))
    manager.save(gen.stats().steps, state)
    fresh = _gen(flax_step["state"])
    assert fresh.restore_checkpoint(manager) and fresh.stats().steps == 1
    assert torch.equal(fresh._gen.get_state(), gen._gen.get_state())
    gen.step()
    fresh.step()
    assert fresh.stats().last_loss == gen.stats().last_loss


def three_steps_rank(out_dir) -> None:
    torch.set_num_threads(1)
    gen = TrainLoadGen(mesh=make_mesh(), batch_size=BATCH, image_size=IMAGE, small=True,
                       seed=SEED, dtype=torch.float32, device="cpu")
    losses = []
    for _ in range(3):
        gen.step()
        losses.append(gen.stats().last_loss)
    _save(out_dir, {"losses": losses, "state": gen.model.state_dict()})


def test_world_one_is_bit_identical_to_no_mesh(tmp_path):
    plain = TrainLoadGen(batch_size=BATCH, image_size=IMAGE, small=True, seed=SEED,
                         dtype=torch.float32, device="cpu")
    assert plain.mesh is None and plain.n_data == 1
    losses = []
    for _ in range(3):
        plain.step()
        losses.append(plain.stats().last_loss)
    (got,) = run_ranks(three_steps_rank, 1, tmp_path)
    assert got["losses"] == losses
    for name, value in plain.model.state_dict().items():
        assert torch.equal(got["state"][name], value), name
    assert not dist.is_initialized()  # the launcher took its group down


def test_the_global_batch_must_split_over_the_data_axis(world_two):
    assert [r["uneven"] for r in world_two] == ["batch 7 does not split over 2 data ranks"] * 2


_TRAIN_RANKS = (
    "import sys; from k8s_gpu_hpa_tpu_torch.loadgen.multihost import launch; "
    "from k8s_gpu_hpa_tpu_torch.loadgen.train import run_rank; "
    "sys.exit(launch(run_rank, ('cpu',), devices=['cpu', 'cpu'], timeout_s=30))"
)


def _train_env(tmp_path, **extra) -> dict:
    return {**{k: v for k, v in os.environ.items()
               if k not in ("COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE",
                            "PROFILE_S")},
            "BATCH_SIZE": "4", "IMAGE_SIZE": "8", "SMALL_MODEL": "1", "REPORT_S": "0.2",
            "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob"), **QUIET, **extra}


def _two_reports_then_sigterm(code: str, env: dict) -> list[str]:
    """Start ``code``, read until two ``steps=`` reports, SIGTERM it; every
    line it printed (it must exit 0)."""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines = []
    try:
        deadline = time.monotonic() + JOIN_S
        while sum(ln.startswith("steps=") for ln in lines) < 2 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=JOIN_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    return lines + out.splitlines()


def test_the_train_container_on_two_ranks_saves_once_on_sigterm_and_exits_0(tmp_path):
    """The tpu-train container's rank body on two ranks of the CPU: rank 0
    alone reports, SIGTERM reaches both, rank 0 writes the final save with
    both data indices' generators, and the launcher exits 0."""
    ckpt = tmp_path / "ckpt"
    env = _train_env(tmp_path, CHECKPOINT_DIR=str(ckpt), CHECKPOINT_EVERY="100000")
    lines = _two_reports_then_sigterm(_TRAIN_RANKS, env)
    assert [ln for ln in lines if ln.startswith("tpu-train loadgen")] == [
        "tpu-train loadgen: ResNet-18ish batch=4 image=8 on cpu x2, intensity=1.0 "
        f"(knob: {tmp_path / 'knob'})"]
    (final,) = [ln for ln in lines if ln.startswith("final checkpoint at step ")]
    step = int(final.rsplit(" ", 1)[1])
    manager = make_checkpoint_manager(str(ckpt))
    assert manager.all_steps() == [step] and step >= max(
        int(ln.split()[0].removeprefix("steps=")) for ln in lines if ln.startswith("steps="))
    assert manager.restore(step)["key"].shape[0] == 2


def test_the_train_container_reads_no_slice_topology(tmp_path):
    """A slice's topology in the environment (here a second process that
    never comes) leaves the tpu-train container alone: its group is its
    host's devices, as the JAX container's command resolves no topology."""
    env = _train_env(tmp_path, COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                     NUM_PROCESSES="2", PROCESS_ID="0")
    code = "from k8s_gpu_hpa_tpu_torch.loadgen.train import main; main(device='cpu')"
    lines = _two_reports_then_sigterm(code, env)
    assert sum(ln.startswith("steps=") for ln in lines) >= 2
    assert any(ln.startswith("tpu-train loadgen") and " on cpu x1," in ln for ln in lines)
