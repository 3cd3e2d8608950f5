"""Multi-host slice wiring: topology resolution, the process group, one
rank per local GPU, and the slice container's command.

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

The resolution is pure and ported whole.  ``initialize`` applies it to
``torch.distributed``.  A JAX process drives every chip of its host, so a
topology counts hosts; PyTorch runs one process a GPU, so each host's
process becomes ``local_devices`` ranks: ``world = num_processes ×
local_devices`` and ``rank = process_id × local_devices + local_rank``.
``launch`` is the container's side of that: it starts one rank a local
device (``forkserver``), forwards SIGTERM and SIGINT to them, and fails with the
exit code of a rank that dies; the fork server it starts is stopped when the
process exits (``stop_rank_server``).  With one local device it starts nothing and
runs the rank in its own process.  With no topology the rendezvous is
``127.0.0.1`` on a free port.

``main`` runs ``WORKLOAD=allreduce`` (the default), ``ringattn`` and
``llm`` over the mesh of every rank of the slice; ``moe`` names the ROADMAP
item that ports it.
"""

from __future__ import annotations

import atexit
import datetime
import multiprocessing.connection
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import random
import signal
import socket
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from k8s_gpu_hpa_tpu_torch.device import local_devices, resolve

#: the JAX coordinator's default port, kept for the addresses it resolves;
#: overridable via COORDINATOR_PORT
DEFAULT_COORDINATOR_PORT = 8476

#: workloads of the JAX container that wait for a later slice, by ROADMAP
#: item; an unknown WORKLOAD means allreduce there, as here
_LATER = {"moe": 12}

#: seconds a rank waits for the rendezvous, and for a collective on gloo
#: (NCCL's watchdog aborts one that outlasts it), before it raises
DEFAULT_TIMEOUT_S = 300.0
#: seconds ranks get to exit after a SIGTERM when one of them has died
_GRACE_S = 10.0
#: seconds a failing rank watches for a peer's exit before it counts its
#: failure as its own
_PEER_EXIT_S = 1.0


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


def initialize(
    topology: HostTopology | None = None,
    *,
    local_rank: int = 0,
    local_devices: int = 1,
    device: str | torch.device | None = None,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> HostTopology | None:
    """Bring up this rank's ``torch.distributed`` group for its host's slice
    (once, before any collective).  Returns the resolved topology; with none
    (a single host, no environment) nothing is brought up.

    The group's rendezvous is ``tcp://<coordinator_address>``; ``device`` is
    the rank's (CUDA by default: it becomes the current device) and
    ``backend`` NCCL for CUDA, gloo for the CPU unless named."""
    if topology is None:
        topology = topology_from_env()
    if topology is None:
        return None
    if not 0 <= topology.process_id < topology.num_processes:
        raise ValueError(
            f"process {topology.process_id} of a slice of {topology.num_processes}"
        )
    if not 0 <= local_rank < local_devices:
        raise ValueError(f"local rank {local_rank} of {local_devices} local devices")
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{topology.coordinator_address}",
        world_size=topology.num_processes * local_devices,
        rank=topology.process_id * local_devices + local_rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return topology


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing is bound to now, drawn at random
    below the kernel's ephemeral range.  A port from that range (what a bind
    to port 0 returns) is what the kernel hands the next socket bound to
    port 0, as each gloo pair binds its own: one could take it before the
    rendezvous binds it."""
    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    draw = random.SystemRandom()
    for _ in range(100):
        port = draw.randrange(max(1024, low - 16384), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free TCP port below the ephemeral range on 127.0.0.1")


def _has_exited(pid: int) -> bool:
    """Whether process ``pid`` has ended: reaped, or a zombie."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return True
    return stat[stat.rindex(")") + 2] in "ZX"


def _after_a_peer(pids, me: int) -> bool:
    """Whether a peer of rank ``me`` (``pids``, 0 where not started) has
    exited, now or within ``_PEER_EXIT_S``: a collective fails as soon as
    the peer's sockets close, a moment before the peer has exited."""
    deadline = time.monotonic() + _PEER_EXIT_S
    while not any(pid and i != me and _has_exited(pid) for i, pid in enumerate(pids)):
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


def _rank_main(fn, args, topology, local_rank, n_local, device, backend, timeout_s,
               pids=None, late=None) -> None:
    """One rank: its group, ``fn``, the closing barrier.  A rank that fails
    after a peer has exited marks itself in ``late``: its failure is the
    peer's (a collective that lost it), not the first."""
    if n_local > 1 and "OMP_NUM_THREADS" not in os.environ:
        # the host's cores shared among its ranks: each rank's intra-op
        # threads spinning on all of them stalls every collective
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // n_local))
    initialize(topology, local_rank=local_rank, local_devices=n_local, device=device,
               backend=backend, timeout_s=timeout_s)
    try:
        fn(*args)
        # rank 0 serves the rendezvous store: it goes last
        dist.barrier()
    except BaseException:
        if late is not None and _after_a_peer(pids, local_rank):
            late[local_rank] = 1
        raise
    finally:
        dist.destroy_process_group()


def stop_rank_server() -> None:
    """Stop the fork server that ``launch`` starts ranks from, and the
    resource tracker that comes with it, and wait for each to exit.  Left to
    themselves both end only after the process that started them has, the
    server half a second later (it imported torch); ``launch`` registers this
    to run at exit.  A later ``launch`` starts them anew."""
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


def _exit_code(process) -> int:
    code = process.exitcode
    return 128 - code if code < 0 else code  # killed by signal N: 128 + N


def launch(
    fn: Callable[..., object],
    args: Sequence = (),
    *,
    devices: Sequence[str | torch.device],
    topology: HostTopology | None = None,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    join_timeout_s: float | None = None,
) -> int:
    """Run ``fn(*args)`` once a rank, one rank a device of ``devices`` (a
    container passes ``local_devices()``), each inside its group
    (``initialize``) on this host's slice (``topology``, else the
    environment's, else this host alone at ``127.0.0.1`` on a free port).

    With one device ``fn`` runs here.  With more, each rank is a process
    started by a fork server (``forkserver``: ``fn`` and ``args`` are
    pickled, so ``fn`` lives at a module's top level); SIGTERM and SIGINT
    sent here are forwarded to every rank.  The server outlives the call,
    for the next one, until ``stop_rank_server`` or exit.  Returns 0 when
    every rank has exited 0, else the exit code of the first that did not
    (128 + N for signal N), after the others were sent SIGTERM and, after
    10 s, killed.  ``join_timeout_s`` bounds
    the wait: past it every rank is killed and TimeoutError raised."""
    devices = [resolve(d) for d in devices]
    if topology is None:
        topology = topology_from_env() or HostTopology(0, 1, f"127.0.0.1:{free_port()}")
    if len(devices) == 1:
        _rank_main(fn, args, topology, 0, 1, devices[0], backend, timeout_s)
        return 0
    # each rank forked by a server that imported torch once, before any
    # thread or CUDA context: a rank starts in milliseconds, not the seconds
    # of a fresh interpreter's import
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch"])
    atexit.unregister(stop_rank_server)
    atexit.register(stop_rank_server)
    # each rank's pid, and whether it failed after a peer had exited
    pids, late = ctx.RawArray("i", len(devices)), ctx.RawArray("i", len(devices))
    procs = [
        ctx.Process(target=_rank_main, args=(fn, tuple(args), topology, i, len(devices), dev,
                                             backend, timeout_s, pids, late))
        for i, dev in enumerate(devices)
    ]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    before = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for i, p in enumerate(procs):
            p.start()
            pids[i] = p.pid
        return _join(procs, join_timeout_s, late)
    finally:
        for s, handler in before.items():
            signal.signal(s, handler)
        for p in procs:
            if p.pid is not None:
                if p.exitcode is None:
                    p.kill()
                p.join()


def _join(procs: list, join_timeout_s: float | None, late) -> int:
    """Wait for every rank; on a failure stop the others and return the
    first failure's code.  Ranks found exited in one wake-up are in no
    order of their own: one that failed after a peer had exited (``late``)
    is not the first failure, unless every one of them did."""
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    running = list(procs)
    while running:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise TimeoutError(f"{len(running)} of {len(procs)} ranks still running "
                               f"after {join_timeout_s} s")
        multiprocessing.connection.wait([p.sentinel for p in running], left)
        done = [p for p in running if p.exitcode is not None]
        for p in done:
            running.remove(p)
        failed = [p for p in done if p.exitcode != 0]
        if failed:
            first = next((p for p in failed if not late[procs.index(p)]), failed[0])
            print(f"rank {procs.index(first)} exited with code {first.exitcode}; "
                  "stopping the others", file=sys.stderr, flush=True)
            for other in running:
                other.terminate()
            multiprocessing.connection.wait([o.sentinel for o in running], _GRACE_S)
            return _exit_code(first)
    return 0


def say(line: str) -> None:
    """Print ``line`` in one write, so that the lines of ranks sharing a
    stdout do not interleave (``print`` writes the newline apart)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def agree(stopping: bool, intensity: float, device: torch.device) -> tuple[bool, float]:
    """Whether any rank was asked to stop, and rank 0's intensity: the ranks
    of a group step together (each step is a collective), so they must stop
    and idle together.  One all_reduce over the group; with no group, or a
    group of one, the arguments as they are."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return stopping, intensity
    flags = torch.tensor([float(stopping), intensity if dist.get_rank() == 0 else 0.0],
                         device=device)
    dist.all_reduce(flags)
    stop, value = flags.tolist()
    return stop > 0, value


def _run(gen, knob, report, device, manager=None, ckpt_every: int = 0,
         lead: bool = True) -> None:
    """The container's loop: a step under the duty-cycle ``knob``, a report
    every ``REPORT_S`` seconds, a save every ``ckpt_every`` steps where a
    ``manager`` is given, until SIGTERM or SIGINT (then a final save).  Only
    a ``lead`` rank prints its reports and its final save."""
    report_every = float(os.environ.get("REPORT_S", "10"))
    stopping = False

    def _terminate(signum, frame):
        nonlocal stopping
        stopping = True

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    last_report = time.perf_counter()
    last_ckpt_step = gen.stats().steps if manager is not None else 0
    while True:
        stop, intensity = agree(stopping, knob.poll(), device)
        if stop:
            if manager is not None and gen.stats().steps > last_ckpt_step:
                gen.save_checkpoint(manager)
                manager.wait_until_finished()
                if lead:
                    say(f"final checkpoint at step {gen.stats().steps}")
            return
        knob.set(intensity)
        knob.throttle(0.0 if intensity <= 0.0 else gen.step())
        if manager is not None and gen.stats().steps - last_ckpt_step >= ckpt_every:
            gen.save_checkpoint(manager)
            last_ckpt_step = gen.stats().steps
        if lead and time.perf_counter() - last_report >= report_every:
            say(report(gen.stats()))
            last_report = time.perf_counter()


def _banner(workload: str, topology: HostTopology | None, where: str, knob) -> str:
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return (
        f"tpu-test multihost loadgen ({workload}): process {rank}/{world} "
        f"slice={topology.slice_index if topology else 0} {where} (knob: {knob.file})"
    )


def run_allreduce(topology: HostTopology | None, device: str | torch.device | None) -> None:
    """One rank of ``WORKLOAD=allreduce``: ``AllReduceLoadGen`` over the mesh
    of every rank of the group (pure data parallel, as the JAX container
    builds it), BUFFER_MB (64) a buffer."""
    from k8s_gpu_hpa_tpu_torch.loadgen.allreduce import AllReduceLoadGen
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    mesh = make_mesh()
    gen = AllReduceLoadGen(mesh=mesh, buffer_mb=float(os.environ.get("BUFFER_MB", "64")),
                           device=device)
    gen.warmup()
    knob = IntensityKnob()
    say(_banner("allreduce", topology, f"mesh={mesh_shape(mesh)}", knob))

    def report(s):
        return f"rounds={s.rounds} ici={s.achieved_gbps:.1f}GB/s busy={s.seconds:.1f}s"

    _run(gen, knob, report, gen.device)


def run_ringattn(topology: HostTopology | None, device: str | torch.device | None) -> None:
    """One rank of ``WORKLOAD=ringattn``: ``RingAttentionLoadGen`` over the
    mesh of every rank of the group, the sequence on its data axis
    (SEQ_PER_DEVICE 1024 a rank, HEADS 8 of HEAD_DIM 128)."""
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.loadgen.ringattn import RingAttentionLoadGen
    from k8s_gpu_hpa_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    mesh = make_mesh()
    gen = RingAttentionLoadGen(
        mesh=mesh,
        seq_per_device=int(os.environ.get("SEQ_PER_DEVICE", "1024")),
        heads=int(os.environ.get("HEADS", "8")),
        head_dim=int(os.environ.get("HEAD_DIM", "128")),
        device=device,
    )
    gen.warmup()
    knob = IntensityKnob()
    say(_banner("ringattn", topology, f"mesh={mesh_shape(mesh)}", knob))

    def report(s):
        return (f"bursts={s.bursts} ctx={s.context_length} "
                f"attn={s.achieved_tflops:.1f}TFLOP/s busy={s.seconds:.1f}s")

    _run(gen, knob, report, gen.device)


def run_llm(topology: HostTopology | None, device: str | torch.device | None) -> None:
    """One rank of ``WORKLOAD=llm``: ``LlmLoadGen`` over the mesh of every
    rank of the group, the context sharded over its data axis; rank 0
    prints, saves and reports the resume."""
    from k8s_gpu_hpa_tpu_torch.device import device_name
    from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
    from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
    from k8s_gpu_hpa_tpu_torch.loadgen.train import make_checkpoint_manager
    from k8s_gpu_hpa_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    mesh = make_mesh()
    lead = dist.get_rank() == 0
    gen = LlmLoadGen(
        mesh=mesh,
        seq_per_device=int(os.environ.get("SEQ_PER_DEVICE", "2048")),
        batch=int(os.environ.get("BATCH_SIZE", "1")),
        d_model=int(os.environ.get("D_MODEL", "512")),
        # head_dim = D_MODEL/N_HEADS; 64 or 128 rides the flash kernels on
        # a ring of one
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
    if ckpt_dir:
        manager = make_checkpoint_manager(ckpt_dir)
        if gen.restore_checkpoint(manager) and lead:
            say(f"resumed from step {gen.stats().steps} in {ckpt_dir}")
    gen.warmup()
    knob = IntensityKnob()
    if lead:
        say(_banner("llm", topology, f"device={device_name(gen.device)} mesh={mesh_shape(mesh)}",
                    knob))
    _run(gen, knob, report, gen.device, manager, int(os.environ.get("CHECKPOINT_EVERY", "100")),
         lead)


_WORKLOADS = {"allreduce": run_allreduce, "ringattn": run_ringattn, "llm": run_llm}


def main(device: str | torch.device | None = None) -> None:
    """``python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost`` — the slice
    container's command: resolve the slice, start one rank a local device
    (``launch``), and drive the workload over the mesh of every rank of the
    slice under the same runtime intensity knob as the single-chip
    generator, reporting every ``REPORT_S`` seconds, until SIGTERM or
    SIGINT.

    ``WORKLOAD=allreduce`` (the default, and any name not below) drives the
    collectives (BUFFER_MB).  ``WORKLOAD=ringattn`` runs causal ring
    attention over a context of SEQ_PER_DEVICE (1024) a rank, HEADS (8) of
    HEAD_DIM (128).  ``WORKLOAD=llm`` takes sequence-parallel training
    steps (SEQ_PER_DEVICE, BATCH_SIZE, D_MODEL, N_HEADS, N_LAYERS, LLM_ATTN
    ``auto`` or ``ring``); CHECKPOINT_DIR enables its resume-on-restart with
    a save every CHECKPOINT_EVERY (100) steps and a final save on SIGTERM or
    SIGINT (scale-down kills whole slices), written by rank 0.
    DIST_BACKEND names the group's backend (NCCL on GPUs and gloo on the CPU
    unless set): for tests and bring-up only, where gloo lets the ranks of
    several processes share one GPU; no deployment sets it.
    ``device`` is CUDA unless the caller passes ``"cpu"``."""
    workload = os.environ.get("WORKLOAD", "allreduce")
    if workload in _LATER:
        raise NotImplementedError(
            f"WORKLOAD={workload!r} is not ported yet (ROADMAP item {_LATER[workload]})"
        )
    topology = topology_from_env()
    code = launch(_WORKLOADS.get(workload, run_allreduce), (topology, device),
                  devices=local_devices(device), topology=topology,
                  backend=os.environ.get("DIST_BACKEND") or None)
    if code:
        sys.exit(code)


if __name__ == "__main__":
    main()
