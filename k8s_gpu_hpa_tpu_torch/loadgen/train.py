"""Training load generator: ResNet-50 on synthetic CIFAR over a device mesh.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/train.py``: the ``tpu-train``
container (deploy/tpu-train-deployment.yaml, BASELINE configs[3]), a real
training pod whose busy fraction drives a two-metric HPA.  Each step draws
a synthetic batch on the device from the generator's own
``torch.Generator`` (N(0, 1) images, uniform labels: no host-to-device
transfer in the steady loop), runs the forward in training mode, the mean
softmax cross-entropy of the f32 logits and the backward, and takes one
``torch.optim.SGD(lr, momentum=0.9)`` step, which is ``optax.sgd(lr,
momentum=0.9)`` from a zero trace.  The BatchNorm running statistics move
inside the forward, as flax's ``mutable=["batch_stats"]`` returns them.

Data parallelism, as the JAX generator shards its batch over the mesh's
``data`` axis and XLA inserts the collectives: with a mesh (given, or
``make_mesh()`` over the process group when one is up) each rank starts
from the same seeded parameters, broadcast from rank 0, and draws its
``batch_size / n_data`` images from a generator seeded by its data index
(model-axis replicas train on the same shard).  Its BatchNorms take their
statistics over the global batch (models/resnet.py), and after the
backward its gradients and its loss are summed over the data group in one
all_reduce and divided by its size: the step is the global batch's, and the
loss reported is the global mean.  Only all_reduce and broadcast are used,
so gloo can carry the step on CUDA tensors too.  Without a group, or on a
data axis of one, the step is the single-device one.

Checkpoints (``make_checkpoint_manager``) are the port's own format, one
``torch.save`` file a step, not orbax's: a JAX checkpoint does not restore
here, nor the other way round.  Rank 0 writes them; every rank restores the
same file, which holds each data index's batch generator, and a restore on
a data axis of another size raises.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import local_devices, resolve
from k8s_gpu_hpa_tpu_torch.models.resnet import init_params, resnet18ish, resnet50
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, mesh_shape


@dataclass
class TrainStats:
    steps: int
    images_per_sec: float
    last_loss: float
    utilization: float  # busy fraction percent (duty-cycle analog)


class TrainLoadGen:
    """Busy-loop of ResNet training steps, data-parallel over ``mesh``'s data
    axis.  ``batch_size`` is the global batch.  ``device`` is CUDA unless the
    caller passes ``"cpu"``; ``dtype`` is the convolutions' compute type
    (parameters stay f32)."""

    def __init__(
        self,
        mesh: DeviceMesh | None = None,
        batch_size: int = 256,
        image_size: int = 32,
        num_classes: int = 10,
        small: bool = False,
        learning_rate: float = 0.1,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh (parallel/mesh.py), not {mesh!r}")
        self.device = resolve(device)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh()
        self.mesh = mesh
        self.n_data = 1 if mesh is None else mesh_shape(mesh)[DATA_AXIS]
        self.data_index = 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)
        if batch_size % self.n_data:
            raise ValueError(f"batch {batch_size} does not split over {self.n_data} data ranks")
        # the data group; None on a data axis of one, where nothing is summed
        self._group = mesh.get_group(DATA_AXIS) if self.n_data > 1 else None
        #: what the summed gradients are multiplied by: their mean
        self._grad_scale = 1.0 / self.n_data
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        model = resnet18ish(num_classes, dtype) if small else resnet50(num_classes, dtype=dtype)
        init_params(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device, memory_format=torch.channels_last)
        if mesh is not None and dist.get_world_size() > 1:
            self._broadcast_state()
        self.model.set_data_group(self._group)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=learning_rate, momentum=0.9)
        self._seed = seed
        self._gen = torch.Generator(self.device).manual_seed(self._batch_seed())
        self._steps = 0
        self._busy = 0.0
        self._t0: float | None = None
        self._last_loss = float("nan")

    def _batch_seed(self) -> int:
        """The seed of this rank's batch generator: its data index's."""
        return self._seed + 1 + self.data_index

    def _broadcast_state(self) -> None:
        """Every rank's parameters and buffers made rank 0's, in one
        broadcast over the whole group."""
        state = list(self.model.state_dict().values())
        flat = torch.cat([t.reshape(-1).float() for t in state])
        dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, value in zip(state, flat.split([t.numel() for t in state])):
                t.copy_(value.view_as(t))

    def batch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's shard of the next synthetic batch, drawn on the
        device: NCHW images in channels_last memory (drawn as NHWC, the JAX
        generator's layout) and int64 labels."""
        hw, n = self.image_size, self.batch_size // self.n_data
        images = torch.randn(n, hw, hw, 3, generator=self._gen, device=self.device).permute(
            0, 3, 1, 2)
        labels = torch.randint(0, self.num_classes, (n,), generator=self._gen, device=self.device)
        return images, labels

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One SGD step on this rank's shard of the batch; returns the loss
        of the global batch (on the device, not waited for)."""
        self.opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(self.model(images, train=True), labels)
        loss.backward()
        loss = loss.detach()
        if self._group is not None:
            loss = self._mean_over_data(loss)
        self.opt.step()
        return loss

    def _mean_over_data(self, loss: torch.Tensor) -> torch.Tensor:
        """The gradients and the loss, flattened into one buffer, summed over
        the data group and multiplied by ``1/n_data``; returns the loss."""
        grads = [p.grad for p in self.model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, group=self._group)
        flat.mul_(self._grad_scale)
        for g, value in zip(grads, flat[:-1].split([g.numel() for g in grads])):
            g.copy_(value.view_as(g))
        return flat[-1]

    def warmup(self) -> None:
        self.step()

    def step(self) -> float:
        """Draw a batch and take one step; returns the seconds it took,
        waited for (reading the loss waits for the device)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        t0 = time.perf_counter()
        loss = self.train_step(*self.batch())
        self._last_loss = float(loss)
        dt = time.perf_counter() - t0
        self._busy += dt
        self._steps += 1
        return dt

    def stats(self) -> TrainStats:
        wall = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        return TrainStats(
            steps=self._steps,
            images_per_sec=self._steps * self.batch_size / self._busy if self._busy else 0.0,
            last_loss=self._last_loss,
            utilization=min(100.0, 100.0 * self._busy / wall) if wall > 0 else 0.0,
        )

    def utilization(self, _chip_index: int = 0) -> float:
        return self.stats().utilization

    # ---- checkpoint / resume -----------------------------------------------
    #
    # A training pod being autoscaled loses work on every scale-down unless
    # it checkpoints: the scale-down's SIGTERM triggers a final save, and a
    # new pod resumes from the newest step.

    def _batch_keys(self) -> torch.Tensor:
        """Every data index's batch generator state, one row each: an
        all_reduce of the rows each rank fills in (its own, zeros elsewhere)
        over the data group."""
        state = self._gen.get_state()
        if self._group is None:
            return state[None]
        keys = torch.zeros(self.n_data, state.numel(), dtype=torch.uint8, device=self.device)
        keys[self.data_index] = state.to(self.device)
        dist.all_reduce(keys, group=self._group)
        return keys.cpu()

    def checkpoint_state(self) -> dict:
        """Parameters, BatchNorm statistics, momentum, every data index's
        batch generator state, the step and the busy seconds.  ``busy``
        travels too, or a resumed pod's images/s (steps × batch / busy)
        would be inflated.  Over a data axis of several ranks each of them
        calls it (it sums the generators' states over the data group)."""
        params = dict(self.model.named_parameters())
        return {
            "params": {k: p.detach() for k, p in params.items()},
            "batch_stats": {k: b for k, b in self.model.state_dict().items() if k not in params},
            # the trace optax starts at zero; SGD's buffer is absent until a step
            "opt_state": {
                k: self.opt.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                for k, p in params.items()
            },
            "key": self._batch_keys(),
            "step": self._steps,
            "busy": self._busy,
        }

    def save_checkpoint(self, manager: CheckpointManager) -> None:
        """Every rank calls it at the same step; rank 0 writes."""
        state = self.checkpoint_state()
        if self.mesh is None or dist.get_rank() == 0:
            manager.save(self._steps, state)

    def restore_checkpoint(self, manager: CheckpointManager) -> bool:
        """Resume from the newest checkpoint; False when none exists.  Every
        rank reads the same file and takes its own data index's batch
        generator; a checkpoint of a data axis of another size raises.  A
        checkpoint of the single-device format, whose ``key`` is one
        generator's state rather than a row a data index, restores as a
        data axis of one."""
        latest = manager.latest_step()
        if latest is None:
            return False
        restored = manager.restore(latest, map_location=self.device)
        keys = restored["key"].cpu()
        if keys.dim() == 1:  # the single-device format: one generator's state
            keys = keys[None]
        if keys.shape[0] != self.n_data:
            raise ValueError(
                f"the checkpoint at step {latest} was written on a data axis of "
                f"{keys.shape[0]} ranks; this mesh has {self.n_data}"
            )
        self.model.load_state_dict({**restored["params"], **restored["batch_stats"]})
        for name, p in self.model.named_parameters():
            self.opt.state[p]["momentum_buffer"] = restored["opt_state"][name]
        self._gen.set_state(keys[self.data_index].clone())  # a view with an offset crashes it
        self._steps = int(restored["step"])
        self._busy = float(restored["busy"])
        return True


class CheckpointManager:
    """The port's counterpart of orbax's ``CheckpointManager``, in its own
    format: ``<directory>/step_<n>.pt``, one ``torch.save`` of a state dict
    a step.

    ``save`` writes a temporary file in the directory, flushes it to disk
    and ``os.replace``s it into place, so a kill mid-write leaves the last
    good step and no torn file; temporary files a killed writer left behind
    are removed when a manager opens the directory.  It keeps the newest
    ``max_to_keep`` steps.  Saves are synchronous."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 2):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        for stale in self.directory.glob(".tmp-*"):
            stale.unlink(missing_ok=True)

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def all_steps(self) -> list[int]:
        steps = []
        for path in self.directory.glob("step_*.pt"):
            tail = path.stem.removeprefix("step_")
            if tail.isdigit():
                steps.append(int(tail))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)  # the rename itself
        finally:
            os.close(fd)
        for old in self.all_steps()[: -self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: int, map_location: str | torch.device | None = None) -> dict:
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release: each save and restore opens and closes its file."""


def make_checkpoint_manager(directory: str, max_to_keep: int = 2) -> CheckpointManager:
    """A manager on a directory (the pod would mount a volume there); keeps
    the newest ``max_to_keep`` steps."""
    return CheckpointManager(directory, max_to_keep)


def main(device: str | torch.device | None = None) -> None:
    """``python -m k8s_gpu_hpa_tpu_torch.loadgen.train`` — the tpu-train
    container command: one rank a local device (multihost.py ``launch``; on
    a host of one GPU, this process alone), all of them data-parallel over
    the mesh of the group.  The group spans this host's devices alone, at
    ``127.0.0.1`` on a free port: the container is no multi-host slice, and
    reads none of the slice's topology variables.

    Training runs continuously with the shared duty-cycle knob between steps
    (TPU_TEST_INTENSITY, the watched intensity file; rank 0's sets every
    rank's).  Env: BATCH_SIZE (256, the global batch), IMAGE_SIZE (32),
    SMALL_MODEL=1 for the reduced-depth model, REPORT_S; CHECKPOINT_DIR
    enables resume-on-restart with a save every CHECKPOINT_EVERY (100)
    steps and a final save on SIGTERM or SIGINT, which reach every rank;
    PROFILE_S and PROFILE_DIR open one trace window a rank
    (utils/profiling.py).  ``device`` is CUDA unless the caller passes
    ``"cpu"``.
    """
    from k8s_gpu_hpa_tpu_torch.loadgen.multihost import HostTopology, free_port, launch

    host = HostTopology(0, 1, f"127.0.0.1:{free_port()}")
    code = launch(run_rank, (device,), devices=local_devices(device), topology=host)
    if code:
        sys.exit(code)


def run_rank(device: str | torch.device | None = None) -> None:
    """One rank of the tpu-train container (``main``); rank 0 prints."""
    from k8s_gpu_hpa_tpu_torch.device import device_name
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.loadgen.multihost import agree
    from k8s_gpu_hpa_tpu_torch.utils.profiling import ProfileWindow

    batch = int(os.environ.get("BATCH_SIZE", "256"))
    image = int(os.environ.get("IMAGE_SIZE", "32"))
    small = os.environ.get("SMALL_MODEL", "0") == "1"
    report_every = float(os.environ.get("REPORT_S", "10"))
    ckpt_dir = os.environ.get("CHECKPOINT_DIR", "")
    ckpt_every = int(os.environ.get("CHECKPOINT_EVERY", "100"))
    knob = IntensityKnob()
    gen = TrainLoadGen(batch_size=batch, image_size=image, small=small, device=device)
    lead = gen.mesh is None or dist.get_rank() == 0
    manager = None
    if ckpt_dir:
        manager = make_checkpoint_manager(ckpt_dir)
        if gen.restore_checkpoint(manager) and lead:
            print(f"resumed from step {gen.stats().steps} in {ckpt_dir}", flush=True)
    gen.warmup()
    if lead:
        world = dist.get_world_size() if gen.mesh is not None else 1
        print(
            f"tpu-train loadgen: ResNet-{'18ish' if small else '50'} "
            f"batch={batch} image={image} on {device_name(gen.device)} x{world}, "
            f"intensity={knob.value} (knob: {knob.file})",
            flush=True,
        )
    # HPA scale-down delivers SIGTERM with a grace period (default 30 s):
    # time for one final synchronous save, so downscaling loses no steps
    stopping = False

    def _terminate(signum, frame):
        nonlocal stopping
        stopping = True

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    profile = ProfileWindow()
    last_report = time.perf_counter()
    last_ckpt_step = gen.stats().steps
    while True:
        profile.poll()
        # the ranks stop, idle and save together: each step is a collective
        stop, intensity = agree(stopping, knob.poll(), gen.device)
        if stop:
            profile.close()
            if manager is not None and gen.stats().steps > last_ckpt_step:
                gen.save_checkpoint(manager)
                manager.wait_until_finished()
                if lead:
                    print(f"final checkpoint at step {gen.stats().steps}", flush=True)
            return
        knob.set(intensity)
        knob.throttle(0.0 if intensity <= 0.0 else gen.step())
        if manager is not None and gen.stats().steps - last_ckpt_step >= ckpt_every:
            gen.save_checkpoint(manager)
            last_ckpt_step = gen.stats().steps
        if lead and time.perf_counter() - last_report >= report_every:
            s = gen.stats()
            print(
                f"steps={s.steps} imgs/s={s.images_per_sec:.1f} "
                f"loss={s.last_loss:.3f} util={s.utilization:.1f}%",
                flush=True,
            )
            last_report = time.perf_counter()


if __name__ == "__main__":
    main()
