"""Training load generator: ResNet-50 on synthetic CIFAR, one device.

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

The JAX generator shards the batch over a data-parallel mesh; that mesh is
ROADMAP item 9, so this one runs on one device and refuses a mesh.

Checkpoints (``make_checkpoint_manager``) are the port's own format, one
``torch.save`` file a step, not orbax's: a JAX checkpoint does not restore
here, nor the other way round.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.models.resnet import init_params, resnet18ish, resnet50


@dataclass
class TrainStats:
    steps: int
    images_per_sec: float
    last_loss: float
    utilization: float  # busy fraction percent (duty-cycle analog)


class TrainLoadGen:
    """Busy-loop of ResNet training steps on one device.  ``device`` is CUDA
    unless the caller passes ``"cpu"``; ``dtype`` is the convolutions'
    compute type (parameters stay f32)."""

    def __init__(
        self,
        mesh: object | None = None,
        batch_size: int = 256,
        image_size: int = 32,
        num_classes: int = 10,
        small: bool = False,
        learning_rate: float = 0.1,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel training over a device mesh is ROADMAP item 9; "
                "this generator runs on one device"
            )
        self.device = resolve(device)
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        model = resnet18ish(num_classes, dtype) if small else resnet50(num_classes, dtype=dtype)
        init_params(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=learning_rate, momentum=0.9)
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)
        self._steps = 0
        self._busy = 0.0
        self._t0: float | None = None
        self._last_loss = float("nan")

    def batch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The next synthetic batch, drawn on the device: NCHW images in
        channels_last memory (drawn as NHWC, the JAX generator's layout)
        and int64 labels."""
        hw = self.image_size
        images = torch.randn(
            self.batch_size, hw, hw, 3, generator=self._gen, device=self.device
        ).permute(0, 3, 1, 2)
        labels = torch.randint(
            0, self.num_classes, (self.batch_size,), generator=self._gen, device=self.device
        )
        return images, labels

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One SGD step on the given batch; returns the loss (on the device,
        not waited for)."""
        self.opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(self.model(images, train=True), labels)
        loss.backward()
        self.opt.step()
        return loss.detach()

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

    def checkpoint_state(self) -> dict:
        """Parameters, BatchNorm statistics, momentum, the batch generator's
        state, the step and the busy seconds.  ``busy`` travels too, or a
        resumed pod's images/s (steps × batch / busy) would be inflated."""
        params = dict(self.model.named_parameters())
        return {
            "params": {k: p.detach() for k, p in params.items()},
            "batch_stats": {k: b for k, b in self.model.state_dict().items() if k not in params},
            # the trace optax starts at zero; SGD's buffer is absent until a step
            "opt_state": {
                k: self.opt.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                for k, p in params.items()
            },
            "key": self._gen.get_state(),
            "step": self._steps,
            "busy": self._busy,
        }

    def save_checkpoint(self, manager: CheckpointManager) -> None:
        manager.save(self._steps, self.checkpoint_state())

    def restore_checkpoint(self, manager: CheckpointManager) -> bool:
        """Resume from the newest checkpoint; False when none exists."""
        latest = manager.latest_step()
        if latest is None:
            return False
        restored = manager.restore(latest, map_location=self.device)
        self.model.load_state_dict({**restored["params"], **restored["batch_stats"]})
        for name, p in self.model.named_parameters():
            self.opt.state[p]["momentum_buffer"] = restored["opt_state"][name]
        self._gen.set_state(restored["key"].cpu())
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
    container command.

    Training runs continuously with the shared duty-cycle knob between steps
    (TPU_TEST_INTENSITY, the watched intensity file).  Env: BATCH_SIZE (256),
    IMAGE_SIZE (32), SMALL_MODEL=1 for the reduced-depth model, REPORT_S;
    CHECKPOINT_DIR enables resume-on-restart with a save every
    CHECKPOINT_EVERY (100) steps and a final save on SIGTERM or SIGINT;
    PROFILE_S and PROFILE_DIR open one trace window (utils/profiling.py).
    ``device`` is CUDA unless the caller passes ``"cpu"``.
    """
    from k8s_gpu_hpa_tpu_torch.device import device_name
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.utils.profiling import ProfileWindow

    batch = int(os.environ.get("BATCH_SIZE", "256"))
    image = int(os.environ.get("IMAGE_SIZE", "32"))
    small = os.environ.get("SMALL_MODEL", "0") == "1"
    report_every = float(os.environ.get("REPORT_S", "10"))
    ckpt_dir = os.environ.get("CHECKPOINT_DIR", "")
    ckpt_every = int(os.environ.get("CHECKPOINT_EVERY", "100"))
    knob = IntensityKnob()
    gen = TrainLoadGen(batch_size=batch, image_size=image, small=small, device=device)
    manager = None
    if ckpt_dir:
        manager = make_checkpoint_manager(ckpt_dir)
        if gen.restore_checkpoint(manager):
            print(f"resumed from step {gen.stats().steps} in {ckpt_dir}", flush=True)
    gen.warmup()
    print(
        f"tpu-train loadgen: ResNet-{'18ish' if small else '50'} "
        f"batch={batch} image={image} on {device_name(gen.device)}, "
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
        if stopping:
            profile.close()
            if manager is not None and gen.stats().steps > last_ckpt_step:
                gen.save_checkpoint(manager)
                manager.wait_until_finished()
                print(f"final checkpoint at step {gen.stats().steps}", flush=True)
            return
        if knob.poll() <= 0.0:
            knob.throttle(0.0)
        else:
            knob.throttle(gen.step())
        if manager is not None and gen.stats().steps - last_ckpt_step >= ckpt_every:
            gen.save_checkpoint(manager)
            last_ckpt_step = gen.stats().steps
        if time.perf_counter() - last_report >= report_every:
            s = gen.stats()
            print(
                f"steps={s.steps} imgs/s={s.images_per_sec:.1f} "
                f"loss={s.last_loss:.3f} util={s.utilization:.1f}%",
                flush=True,
            )
            last_report = time.perf_counter()


if __name__ == "__main__":
    main()
