"""Multi-host slice wiring: topology resolution, and the slice container's
command cut to one process.

Counterpart of ``k8s_gpu_hpa_tpu/loadgen/multihost.py``.  Topology is
resolved from the environment, in precedence order:

1. **Explicit** — ``COORDINATOR_ADDRESS`` + ``NUM_PROCESSES`` + ``PROCESS_ID``.
2. **GKE TPU webhook** — ``TPU_WORKER_HOSTNAMES`` (comma-separated) +
   ``TPU_WORKER_ID``.
3. **StatefulSet convention** (deploy/tpu-test-multihost.yaml) —
   ``HOSTS_PER_SLICE`` + ``HEADLESS_SERVICE``: pod ordinal ``N`` in
   ``<name>-N`` maps to slice ``N // hosts`` and worker ``N % hosts``; the
   slice coordinator is the slice's worker-0 pod through the headless
   service's per-pod DNS.

The resolution is pure and ported whole.  Bringing up a group of more than
one process (``torch.distributed``) is ROADMAP item 13, so ``initialize``
raises for one; ``main`` runs the ``llm`` workload only, and names the
ROADMAP item of every other.
"""

from __future__ import annotations

import os
import signal
import socket
import time
from dataclasses import dataclass
from typing import Mapping

import torch

#: the JAX coordinator's default port, kept for the addresses it resolves;
#: overridable via COORDINATOR_PORT
DEFAULT_COORDINATOR_PORT = 8476

#: workloads of the JAX container that wait for a later slice, by ROADMAP
#: item; an unknown WORKLOAD means allreduce there, as here
_LATER = {"allreduce": 9, "ringattn": 10, "moe": 12}


@dataclass(frozen=True)
class HostTopology:
    """One host's place in a multi-host slice."""

    process_id: int  # global process index within the slice
    num_processes: int  # hosts per slice
    coordinator_address: str  # host:port of the slice's process 0
    slice_index: int = 0  # which slice replica this host belongs to

    @property
    def worker_index(self) -> int:
        return self.process_id


def pod_ordinal(hostname: str) -> int | None:
    """StatefulSet pods are named ``<set>-<ordinal>``."""
    base, sep, tail = hostname.rpartition("-")
    if sep and base and tail.isdigit():
        return int(tail)
    return None


def topology_from_env(
    env: Mapping[str, str] | None = None, hostname: str | None = None
) -> HostTopology | None:
    """Resolve this host's topology; ``None`` means single-process."""
    env = os.environ if env is None else env
    hostname = hostname if hostname is not None else socket.gethostname()
    port = int(env.get("COORDINATOR_PORT", DEFAULT_COORDINATOR_PORT))

    if "COORDINATOR_ADDRESS" in env:
        return HostTopology(
            process_id=int(env.get("PROCESS_ID", env.get("TPU_WORKER_ID", "0"))),
            num_processes=int(env.get("NUM_PROCESSES", "1")),
            coordinator_address=env["COORDINATOR_ADDRESS"],
            slice_index=int(env.get("SLICE_INDEX", "0")),
        )

    if env.get("TPU_WORKER_HOSTNAMES"):  # empty string = single-host pool
        hosts = [h for h in env["TPU_WORKER_HOSTNAMES"].split(",") if h]
        if hosts:
            return HostTopology(
                process_id=int(env.get("TPU_WORKER_ID", "0")),
                num_processes=len(hosts),
                coordinator_address=f"{hosts[0]}:{port}",
                slice_index=int(env.get("SLICE_INDEX", "0")),
            )

    if "HOSTS_PER_SLICE" in env:
        hosts_per_slice = int(env["HOSTS_PER_SLICE"])
        if hosts_per_slice <= 1:
            return None
        ordinal = pod_ordinal(hostname)
        if ordinal is None:
            raise ValueError(
                f"HOSTS_PER_SLICE set but hostname {hostname!r} has no "
                "StatefulSet ordinal suffix"
            )
        slice_index = ordinal // hosts_per_slice
        base = hostname[: hostname.rfind("-")]
        coordinator_pod = f"{base}-{slice_index * hosts_per_slice}"
        service = env.get("HEADLESS_SERVICE", base)
        namespace = env.get("POD_NAMESPACE", "default")
        return HostTopology(
            process_id=ordinal % hosts_per_slice,
            num_processes=hosts_per_slice,
            # per-pod DNS through the headless service
            coordinator_address=(
                f"{coordinator_pod}.{service}.{namespace}.svc.cluster.local:{port}"
            ),
            slice_index=slice_index,
        )

    return None


def initialize(topology: HostTopology | None = None) -> HostTopology | None:
    """This host's topology, for a slice of one process.  A slice of more
    raises: its process group waits for ROADMAP item 13."""
    if topology is None:
        topology = topology_from_env()
    if topology is None or topology.num_processes <= 1:
        return topology
    raise NotImplementedError(
        f"a slice of {topology.num_processes} processes needs a torch.distributed "
        "process group, ROADMAP item 13"
    )


def main(device: str | torch.device | None = None) -> None:
    """``WORKLOAD=llm python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost`` —
    the slice container's command: resolve the slice, then take training
    steps under the same runtime intensity knob as the single-chip
    generator, reporting every ``REPORT_S`` seconds, until SIGTERM or
    SIGINT.  Env: SEQ_PER_DEVICE, BATCH_SIZE, D_MODEL, N_HEADS, N_LAYERS,
    LLM_ATTN (``auto`` or ``ring``), REPORT_S; CHECKPOINT_DIR enables
    resume-on-restart with a save every CHECKPOINT_EVERY (100) steps and a
    final save on SIGTERM or SIGINT (scale-down kills whole slices).
    ``device`` is CUDA unless the caller passes ``"cpu"``."""
    from k8s_gpu_hpa_tpu_torch.device import device_name
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
    from k8s_gpu_hpa_tpu_torch.loadgen.train import make_checkpoint_manager

    topology = initialize()
    workload = os.environ.get("WORKLOAD", "allreduce")
    if workload != "llm":
        item = _LATER.get(workload, _LATER["allreduce"])
        raise NotImplementedError(
            f"WORKLOAD={workload!r} is not ported yet (ROADMAP item {item}); "
            "this slice runs WORKLOAD=llm"
        )
    gen = LlmLoadGen(
        seq_per_device=int(os.environ.get("SEQ_PER_DEVICE", "2048")),
        batch=int(os.environ.get("BATCH_SIZE", "1")),
        d_model=int(os.environ.get("D_MODEL", "512")),
        # head_dim = D_MODEL/N_HEADS; 64 or 128 rides the flash kernels
        n_heads=int(os.environ.get("N_HEADS", "4")),
        n_layers=int(os.environ.get("N_LAYERS", "4")),
        attn_impl=os.environ.get("LLM_ATTN", "auto"),
        device=device,
    )

    def report(s):
        return (
            f"steps={s.steps} ctx={s.context_length} loss={s.last_loss:.3f} "
            f"tok/s={s.tokens_per_sec:.0f} busy={s.seconds:.1f}s"
        )

    manager = None
    ckpt_dir = os.environ.get("CHECKPOINT_DIR", "")
    ckpt_every = int(os.environ.get("CHECKPOINT_EVERY", "100"))
    if ckpt_dir:
        manager = make_checkpoint_manager(ckpt_dir)
        if gen.restore_checkpoint(manager):
            print(f"resumed from step {gen.stats().steps} in {ckpt_dir}", flush=True)

    gen.warmup()
    knob = IntensityKnob()
    report_every = float(os.environ.get("REPORT_S", "10"))
    print(
        f"tpu-test multihost loadgen ({workload}): process 0/1 "
        f"slice={topology.slice_index if topology else 0} "
        f"device={device_name(gen.device)} (knob: {knob.file})",
        flush=True,
    )

    stopping = False

    def _terminate(signum, frame):
        nonlocal stopping
        stopping = True

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    last_report = time.perf_counter()
    last_ckpt_step = gen.stats().steps
    while True:
        if stopping:
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
            print(report(gen.stats()), flush=True)
            last_report = time.perf_counter()


if __name__ == "__main__":
    main()
