"""The port's device mesh over ``torch.distributed`` on the CPU: the JAX
package's mesh on the 8 virtual CPU devices of tests/conftest.py against
the port's over 8 gloo ranks, ``initialize`` from an explicit topology, and
the launcher's contract (one rank a device, SIGTERM forwarded, a dead rank
fails it, a deadline).

The ranks are processes forked by the launcher's fork server from pickled
functions, so their bodies live at the top level of these modules, and the
modules import JAX inside the tests only: a rank never loads it.  Every group has a rendezvous on a free port of
127.0.0.1, a timeout on its collectives and a deadline on its ranks."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from k8s_gpu_hpa_tpu_torch.loadgen.multihost import HostTopology, free_port, initialize, launch
from k8s_gpu_hpa_tpu_torch.parallel import mesh as pm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
#: seconds a group waits for a rendezvous or a collective; and for its ranks
TIMEOUT_S, JOIN_S = 30, 120
#: the environment of ranks started in a subprocess: one intra-op thread each
#: (``run_ranks`` says why)
QUIET = {"OMP_NUM_THREADS": "1"}
#: JAX's 8 virtual devices, and the model parallelisms of its tests
WORLD = 8
LAYOUTS = [(4, 2), (2, 4)]


def run_ranks(body, n: int, out_dir, *args) -> list:
    """``body(out_dir, *args)`` on ``n`` gloo ranks of the CPU through the
    port's launcher; what each rank saved (``_save``), by rank.  Each body
    holds torch to one intra-op thread, as a rank started in a subprocess
    is held by ``OMP_NUM_THREADS=1`` (``QUIET``): ranks whose OpenMP threads
    spun on every port core, nice 19 or not, stalled the JAX package's
    wall-clock test ``tests/test_dwell.py::test_dwell_scales_with_declared_flops``
    in a neighbouring worker.  Arrays go to the ranks as tensors: a rank
    that unpickles a numpy array takes seconds longer to start."""
    code = launch(body, (out_dir, *args), devices=["cpu"] * n, timeout_s=TIMEOUT_S,
                  join_timeout_s=JOIN_S)
    assert code == 0
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _save(out_dir, obj) -> None:
    torch.save(obj, out_dir / f"rank{dist.get_rank()}.pt")


def _jax_loaded() -> list[str]:
    return [m for m in sys.modules if m == "jax" or m.startswith("jax.")]


def mesh_rank(out_dir) -> None:
    """What one of 8 ranks sees of its meshes."""
    torch.set_num_threads(1)
    out = {"jax_loaded": _jax_loaded(), "shapes": {}, "errors": {}}
    for mp in (1, 2, 4):
        mesh = pm.make_mesh(model_parallelism=mp)
        out["shapes"][mp] = pm.mesh_shape(mesh)
        out[mp] = {
            "grid": mesh.mesh.tolist(),
            "data": dist.get_process_group_ranks(mesh.get_group(pm.DATA_AXIS)),
            "model": dist.get_process_group_ranks(mesh.get_group(pm.MODEL_AXIS)),
            "index": (mesh.get_local_rank(pm.DATA_AXIS), mesh.get_local_rank(pm.MODEL_AXIS)),
            "device_type": mesh.device_type,
        }
    out["placements"] = {
        "data_sharding": pm.data_sharding(mesh), "replicated": pm.replicated(mesh),
        "model_sharding": pm.model_sharding(mesh), "model_sharding_0": pm.model_sharding(mesh, 0),
    }
    for name, kwargs in {"mp3": {"model_parallelism": 3}, "n4": {"n_devices": 4}}.items():
        try:
            pm.make_mesh(**kwargs)
        except ValueError as e:
            out["errors"][name] = str(e)
    out["n8"] = pm.mesh_shape(pm.make_mesh(n_devices=WORLD))
    _save(out_dir, out)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    return run_ranks(mesh_rank, WORLD, tmp_path_factory.mktemp("mesh"))


def test_make_mesh_shapes(eight_ranks):
    """tests/test_jax_workloads.py's ``test_make_mesh_shapes``, at 8 ranks."""
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh as jax_make_mesh

    for r in eight_ranks:
        for mp in (1, 2, 4):
            assert r["shapes"][mp] == dict(jax_make_mesh(model_parallelism=mp).shape)
        assert r["shapes"][1] == {"data": 8, "model": 1}
        assert r["n8"] == {"data": 8, "model": 1}
        with pytest.raises(ValueError) as jax_error:
            jax_make_mesh(model_parallelism=3)
        assert r["errors"]["mp3"] == str(jax_error.value)
        assert "the mesh spans the whole group" in r["errors"]["n4"]
        assert r[1]["device_type"] == "cpu" and r["jax_loaded"] == []


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_each_rank_s_groups_are_the_rows_and_columns_of_jax_s_device_grid(layout, eight_ranks):
    from k8s_gpu_hpa_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mp = layout[1]
    grid = [[d.id for d in row] for row in jax_make_mesh(model_parallelism=mp).devices]
    assert len(grid) == layout[0]
    for rank, r in enumerate(eight_ranks):
        assert r[mp]["grid"] == grid
        (row,) = [i for i, ids in enumerate(grid) if rank in ids]
        col = grid[row].index(rank)
        assert r[mp]["model"] == grid[row]  # contiguous ranks: one model group
        assert r[mp]["data"] == [ids[col] for ids in grid]
        assert r[mp]["index"] == (row, col)


def _placements(spec, names=("data", "model")) -> list:
    """A JAX PartitionSpec as DTensor placements, one a mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in names:
        dims = [i for i, entry in enumerate(spec) if entry == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def test_placements_are_jax_s_partition_specs(eight_ranks):
    from k8s_gpu_hpa_tpu.parallel import mesh as jm

    mesh = jm.make_mesh(model_parallelism=4)
    want = {
        "data_sharding": jm.data_sharding(mesh), "replicated": jm.replicated(mesh),
        "model_sharding": jm.model_sharding(mesh), "model_sharding_0": jm.model_sharding(mesh, 0),
    }
    for name, sharding in want.items():
        assert eight_ranks[0]["placements"][name] == _placements(sharding.spec), name
    with pytest.raises(ValueError):
        pm.model_sharding(None, axis=2, ndim=2)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        pm.make_mesh()


def initialize_rank(out_dir, process_id, local_rank, port) -> None:
    """One rank of 2 hosts × 2 local devices, brought up by ``initialize``."""
    torch.set_num_threads(1)
    topology = initialize(HostTopology(process_id, 2, f"127.0.0.1:{port}"), local_rank=local_rank,
                          local_devices=2, device="cpu", timeout_s=TIMEOUT_S)
    ones = torch.ones(1)
    dist.all_reduce(ones)
    _save(out_dir, {"rank": dist.get_rank(), "world": dist.get_world_size(),
                    "backend": dist.get_backend(), "sum": float(ones), "topology": topology})
    dist.barrier()  # rank 0 serves the store: nobody leaves before the others
    dist.destroy_process_group()


def test_initialize_brings_up_a_group_from_an_explicit_two_process_topology(tmp_path):
    ctx = torch.multiprocessing.get_context("forkserver")  # the launcher's: torch imported once
    port = free_port()
    procs = [ctx.Process(target=initialize_rank, args=(tmp_path, pid, local, port))
             for pid in (0, 1) for local in (0, 1)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        p.kill()
    assert [p.exitcode for p in procs] == [0] * 4
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    # rank = process_id × local_devices + local_rank, world = processes × local
    assert [(g["rank"], g["world"], g["backend"], g["sum"]) for g in got] == [
        (r, 4, "gloo", 4.0) for r in range(4)]
    assert [g["topology"].process_id for g in got] == [0, 0, 1, 1]


def test_initialize_without_a_topology_brings_up_nothing_and_checks_what_it_is_given(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE"):
        monkeypatch.delenv(name, raising=False)
    assert initialize(device="cpu") is None and not dist.is_initialized()
    with pytest.raises(ValueError, match="process 2 of a slice of 2"):
        initialize(HostTopology(2, 2, "127.0.0.1:1"), device="cpu")
    with pytest.raises(ValueError, match="local rank 2 of 2"):
        initialize(HostTopology(0, 2, "127.0.0.1:1"), local_rank=2, local_devices=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(HostTopology(0, 1, "127.0.0.1:1"))
    assert not dist.is_initialized()


def die_on_rank_one() -> None:
    """Rank 1 dies with code 3; rank 0 waits in a collective for it."""
    if dist.get_rank() == 1:
        os._exit(3)
    dist.barrier()


def block() -> None:
    time.sleep(600)


_LAUNCH = (
    "import sys; from k8s_gpu_hpa_tpu_torch.loadgen.multihost import launch; {imports}; "
    "sys.exit(launch({fn}, {args}, devices=['cpu', 'cpu'], timeout_s={timeout}))"
)


def _launcher(fn: str, imports: str, args: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE")}
    code = _LAUNCH.format(imports=imports, fn=fn, args=args, timeout=TIMEOUT_S)
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                            env={**env, **QUIET, "REPORT_S": "0.2", "BUFFER_MB": "0.1",
                                 "TPU_TEST_INTENSITY_FILE": str(REPO / "no-such-knob")},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def test_the_launcher_forwards_sigterm_and_every_rank_exits_0():
    proc = _launcher("run_allreduce", "from k8s_gpu_hpa_tpu_torch.loadgen.multihost import "
                     "run_allreduce", "(None, 'cpu')")
    lines = []
    try:
        deadline = time.monotonic() + JOIN_S
        while sum(ln.startswith("rounds=") for ln in lines) < 4 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=JOIN_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, lines + out.splitlines()
    banners = sorted(ln for ln in lines if ln.startswith("tpu-test multihost loadgen"))
    assert [b.split(" slice=")[0] for b in banners] == [
        f"tpu-test multihost loadgen (allreduce): process {r}/2" for r in (0, 1)]
    assert all("mesh={'data': 2, 'model': 1}" in b for b in banners)


def _live_in_session(sid: int) -> list[str]:
    """The processes of session ``sid`` that have not exited (zombies
    aside), as ``pid state command``."""
    live = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # exited meanwhile
            continue
        name, fields = text[text.index("(") + 1:text.rindex(")")], text[text.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] != "Z":
            live.append(f"{stat.parent.name} {fields[0]} {name}")
    return live


def test_the_launcher_leaves_no_process_behind_it():
    """Once a process that launched ranks has exited, nothing it started
    runs on: not its ranks, not the fork server they came from (which, left
    to itself, outlives it by half a second), not the resource tracker."""
    proc = _launcher("time.sleep", "import time", "(0,)")
    # its exit, not the end of its output: the server holds its stdout too
    code = proc.wait(timeout=JOIN_S)
    live = _live_in_session(proc.pid)
    out, _ = proc.communicate(timeout=JOIN_S)
    assert code == 0, out
    assert live == []


def test_a_rank_that_dies_fails_the_launcher_with_its_exit_code(capfd):
    code = launch(die_on_rank_one, devices=["cpu", "cpu"], timeout_s=TIMEOUT_S,
                  join_timeout_s=JOIN_S)
    assert code == 3
    assert "rank 1 exited with code 3; stopping the others" in capfd.readouterr().err


def test_the_launcher_names_the_first_failure_when_it_wakes_after_both_ranks_exited(
        monkeypatch, capfd):
    """Under load the launcher may wake only once rank 1 has died (code 3)
    and rank 0, whose barrier lost it, has exited too (code 1): the code is
    still rank 1's.  The launcher's wait is made to return only once every
    rank it waits for has exited."""
    import multiprocessing.connection
    import types

    from k8s_gpu_hpa_tpu_torch.loadgen import multihost

    real = multiprocessing.connection.wait

    def late(objects, timeout=None):
        deadline = time.monotonic() + JOIN_S
        while len(real(objects, 0)) < len(objects) and time.monotonic() < deadline:
            time.sleep(0.05)
        return real(objects, 0)

    monkeypatch.setattr(multihost, "multiprocessing", types.SimpleNamespace(
        connection=types.SimpleNamespace(wait=late), forkserver=multiprocessing.forkserver,
        resource_tracker=multiprocessing.resource_tracker))
    code = launch(die_on_rank_one, devices=["cpu", "cpu"], timeout_s=TIMEOUT_S,
                  join_timeout_s=JOIN_S)
    err = capfd.readouterr().err
    assert "rank 0 exited" not in err
    assert code == 3
    assert "rank 1 exited with code 3; stopping the others" in err


def test_the_launcher_kills_its_ranks_past_its_deadline():
    with pytest.raises(TimeoutError, match="2 of 2 ranks still running after 1 s"):
        launch(block, devices=["cpu", "cpu"], timeout_s=TIMEOUT_S, join_timeout_s=1)
    assert not dist.is_initialized()


def test_a_free_port_is_free():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", free_port()))


def test_a_free_port_lies_below_the_ephemeral_range():
    """Where a socket bound to port 0 (a gloo pair's) can never take it
    before the rendezvous binds it."""
    low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    assert all(1024 <= free_port() < low for _ in range(20))


def test_matmul_loadgen_loads_every_local_device(monkeypatch):
    """tests/test_jax_workloads.py's ``test_matmul_loadgen_loads_every_local_device``
    on two devices: a host whose ``local_devices`` lists two runs one product
    chain on each, with operands of its own, and counts the FLOPs of both.
    (A one-GPU card cannot run this path: the CPU stands in for both.)"""
    from k8s_gpu_hpa_tpu_torch.loadgen import matmul

    two = [torch.device("cpu"), torch.device("cpu")]
    monkeypatch.setattr(matmul, "local_devices", lambda device=None: two)
    gen = matmul.MatmulLoadGen(size=128, iters_per_burst=1, intensity=1.0)
    assert gen.n_devices == 2 and gen._devices == two
    assert len(gen._a) == len(gen._b) == 2 and not torch.equal(gen._a[0], gen._a[1])
    gen.warmup()
    gen.step()
    assert gen.stats().steps == 1 and gen.stats().busy_seconds > 0
    single = matmul.MatmulLoadGen(size=128, iters_per_burst=1, intensity=1.0, all_devices=False,
                                  device="cpu")
    single.warmup()
    single.step()
    assert single.n_devices == 1
    # FLOPs accounting: two devices record twice a burst's
    assert sum(f for _, _, f in gen._history) == 2 * sum(f for _, _, f in single._history)
