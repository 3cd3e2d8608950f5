"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package ``k8s_gpu_hpa_tpu``.

This test process has JAX loaded already (conftest.py imports it), so the
import check runs in a fresh interpreter.  The port's name starts with
``k8s_gpu_hpa_tpu``, so the JAX package is matched exactly (the name itself
or ``k8s_gpu_hpa_tpu.`` followed by a submodule), never by prefix."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "k8s_gpu_hpa_tpu_torch"

_FORBIDDEN = ("jax", "k8s_gpu_hpa_tpu")


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".") for name in _FORBIDDEN)


_IMPORT_ALL = """
import importlib, importlib.util, json, pkgutil, sys
import k8s_gpu_hpa_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_importing_every_port_module_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # the walk really reached the slice's modules, kernel wrapper included
    for name in (
        "k8s_gpu_hpa_tpu_torch.ops.matmul",
        "k8s_gpu_hpa_tpu_torch.loadgen.matmul",
        "k8s_gpu_hpa_tpu_torch.exporter.daemon",
        "k8s_gpu_hpa_tpu_torch.control.hpa",
        "k8s_gpu_hpa_tpu_torch.trial",
        "k8s_gpu_hpa_tpu_torch.ops.flash_attention",
        "k8s_gpu_hpa_tpu_torch.ops.ring_attention",
        "k8s_gpu_hpa_tpu_torch.models.transformer",
        "k8s_gpu_hpa_tpu_torch.loadgen.llm",
        "k8s_gpu_hpa_tpu_torch.loadgen.multihost",
        "k8s_gpu_hpa_tpu_torch.exporter.nvml",
        "k8s_gpu_hpa_tpu_torch.exporter.stub_nvml",
        "k8s_gpu_hpa_tpu_torch.exporter.selfreport",
        "k8s_gpu_hpa_tpu_torch.exporter.kubeapi",
        "k8s_gpu_hpa_tpu_torch.utils.protowire",
        "k8s_gpu_hpa_tpu_torch.utils.profiling",
        "k8s_gpu_hpa_tpu_torch.models.resnet",
        "k8s_gpu_hpa_tpu_torch.loadgen.train",
        "k8s_gpu_hpa_tpu_torch.parallel.mesh",
        "k8s_gpu_hpa_tpu_torch.models.tp_mlp",
        "k8s_gpu_hpa_tpu_torch.loadgen.allreduce",
        "k8s_gpu_hpa_tpu_torch.loadgen.ringattn",
        "k8s_gpu_hpa_tpu_torch.loadgen.decode",
        "k8s_gpu_hpa_tpu_torch.models.moe",
        "k8s_gpu_hpa_tpu_torch.models.pipeline",
        "k8s_gpu_hpa_tpu_torch.loadgen.moe",
        "k8s_gpu_hpa_tpu_torch.metrics.rules",
        "k8s_gpu_hpa_tpu_torch.manifests",
        "k8s_gpu_hpa_tpu_torch.doctor",
        "k8s_gpu_hpa_tpu_torch.control.external_sim",
        "k8s_gpu_hpa_tpu_torch.utils.quantity",
        "k8s_gpu_hpa_tpu_torch.control.cluster",
        "k8s_gpu_hpa_tpu_torch.control.loop",
        "k8s_gpu_hpa_tpu_torch.simulate",
        "k8s_gpu_hpa_tpu_torch.__main__",
        "k8s_gpu_hpa_tpu_torch.chaos",
        "k8s_gpu_hpa_tpu_torch.chaos.faults",
        "k8s_gpu_hpa_tpu_torch.chaos.schedule",
        "k8s_gpu_hpa_tpu_torch.chaos.storm",
        "k8s_gpu_hpa_tpu_torch.metrics.wal",
        "k8s_gpu_hpa_tpu_torch.control.checkpoint",
        "k8s_gpu_hpa_tpu_torch.control.scale_harness",
        "k8s_gpu_hpa_tpu_torch.metrics.gorilla",
        "k8s_gpu_hpa_tpu_torch.metrics.tsdb",
        "k8s_gpu_hpa_tpu_torch.metrics.promql",
        "k8s_gpu_hpa_tpu_torch.metrics.planner",
        "k8s_gpu_hpa_tpu_torch.metrics.federation",
        "k8s_gpu_hpa_tpu_torch.metrics.downsample",
        "k8s_gpu_hpa_tpu_torch.obs.selfmetrics",
        "k8s_gpu_hpa_tpu_torch.perfgates",
        "k8s_gpu_hpa_tpu_torch.control.capacity",
        "k8s_gpu_hpa_tpu_torch.control.operator",
        "k8s_gpu_hpa_tpu_torch.chaos.crunch",
        "k8s_gpu_hpa_tpu_torch.metrics.objstore",
        "k8s_gpu_hpa_tpu_torch.metrics.global_query",
        "k8s_gpu_hpa_tpu_torch.control.region",
        "k8s_gpu_hpa_tpu_torch.chaos.evacuate",
        "k8s_gpu_hpa_tpu_torch.obs.coverage",
        "k8s_gpu_hpa_tpu_torch.obs.profile",
        "k8s_gpu_hpa_tpu_torch.control.profile_harness",
        "k8s_gpu_hpa_tpu_torch.control.fuzz_harness",
        "k8s_gpu_hpa_tpu_torch.chaos.fuzz",
        "k8s_gpu_hpa_tpu_torch.obs.alerting",
        "k8s_gpu_hpa_tpu_torch.obs.incident",
        "k8s_gpu_hpa_tpu_torch.chaos.paging",
        "k8s_gpu_hpa_tpu_torch.control.race_harness",
        "k8s_gpu_hpa_tpu_torch.analysis",
        "k8s_gpu_hpa_tpu_torch.analysis.__main__",
        "k8s_gpu_hpa_tpu_torch.analysis.allowlist",
        "k8s_gpu_hpa_tpu_torch.analysis.concurrency",
        "k8s_gpu_hpa_tpu_torch.analysis.contracts",
        "k8s_gpu_hpa_tpu_torch.analysis.coverage",
        "k8s_gpu_hpa_tpu_torch.analysis.legacy",
        "k8s_gpu_hpa_tpu_torch.analysis.purity",
        "k8s_gpu_hpa_tpu_torch.analysis.symbols",
        "k8s_gpu_hpa_tpu_torch.utils.dwell",
        "k8s_gpu_hpa_tpu_torch.utils.lazy",
    ):
        assert name in out["imported"]
    assert "torch" in out["loaded"]
    assert [m for m in out["loaded"] if _forbidden(m)] == []
    # the kubelet client imports grpc when it is called, never at import; and
    # on a host without NVML the imports above succeed: none loads it at import
    assert "grpc" not in out["loaded"]


_RUN_MESH_PATHS = """
import json, sys
import torch, torch.distributed as dist
from k8s_gpu_hpa_tpu_torch.loadgen.multihost import free_port
from k8s_gpu_hpa_tpu_torch.loadgen.ringattn import RingAttentionLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.decode import DecodeLoadGen
from k8s_gpu_hpa_tpu_torch.models import transformer as t
from k8s_gpu_hpa_tpu_torch.parallel.mesh import make_mesh
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                        world_size=1)
mesh = make_mesh()
ring = RingAttentionLoadGen(mesh=mesh, seq_per_device=16, heads=1, head_dim=8, device="cpu")
ring.warmup()
cfg = t.TransformerConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=16,
                          dtype=torch.float32)
params = t.init_params(cfg, torch.Generator().manual_seed(0))
tokens = torch.zeros(1, 16, dtype=torch.long)
t.make_train_step(cfg, mesh=mesh)(params, tokens)
serve = DecodeLoadGen(batch=1, max_seq=16, d_model=32, n_heads=2, n_layers=1,
                      tokens_per_burst=2, prefill_len=4, dtype=torch.float32, device="cpu",
                      mesh=mesh)
serve.warmup()
dist.destroy_process_group()
print(json.dumps({"loaded": sorted(sys.modules)}))
"""


def test_running_the_ring_tp_and_sequence_parallel_paths_loads_no_jax():
    """The ring rung, a sequence-parallel step and a tensor-parallel burst,
    run on a gloo group of one in a fresh interpreter, load neither JAX nor
    the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_MESH_PATHS], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])["loaded"]
    assert "k8s_gpu_hpa_tpu_torch.loadgen.ringattn" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


_RUN_DEPLOY_SIDE = """
import json, sys
from k8s_gpu_hpa_tpu_torch import doctor, manifests
from k8s_gpu_hpa_tpu_torch.exporter.stub_nvml import StubNvml
from k8s_gpu_hpa_tpu_torch.trial import run_trial, slice_spec, wire_pipeline
from k8s_gpu_hpa_tpu_torch.metrics import exposition, schema
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
for docs in manifests.default_bundle().values():
    manifests.to_yaml(docs)
doctor.diagnose(exporter_fetch=lambda: "")
assert doctor.probe_nvml(StubNvml(1).path) == 0
class Load:
    intensity = 0.0
    def set_intensity(self, value): self.intensity = value
    def utilization(self, _chip_index=0): return 100.0 * self.intensity
load, clock = Load(), VirtualClock()
def real():
    duty = load.utilization()
    chip = schema.ChipSample(0, duty, duty, 1.0, 2.0, None)
    return exposition.encode_text(schema.families_from_chips(
        [chip], "real-0", {0: ("default", "tpu-test-multihost-0")}))
pipe = wire_pipeline(real, load.utilization, clock, 0.1, spec=slice_spec())
assert run_trial(load, pipe, clock, 0.1).slice_boundary_violations == 0
print(json.dumps({"loaded": sorted(sys.modules)}))
"""


def test_running_the_deploy_side_and_the_slice_loop_loads_no_jax():
    """The manifest generator, the doctor (its joints and the NVML probe
    over the stub library) and the slice loop on a virtual clock, run in a
    fresh interpreter, load neither JAX nor the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_DEPLOY_SIDE], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])["loaded"]
    assert {"k8s_gpu_hpa_tpu_torch.manifests", "k8s_gpu_hpa_tpu_torch.doctor"} <= set(loaded)
    # the generator writes its YAML itself: the port imports no YAML library
    assert "yaml" not in loaded
    assert [m for m in loaded if _forbidden(m)] == []


_RUN_PODS_EXTERNAL = """
import json, sys
from k8s_gpu_hpa_tpu_torch import manifests
from k8s_gpu_hpa_tpu_torch.control import hpa
from k8s_gpu_hpa_tpu_torch.trial import GIB, run_external_queue_trial, run_hbm_pods_trial
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
class Hold:
    held = 0
    def held_bytes(self): return self.held
    def set_target(self, target): self.held = int(target) // (GIB // 4) * (GIB // 4)
    def clear(self): self.held = 0
assert run_hbm_pods_trial("cpu", 1.0, Hold(), VirtualClock()).replicas[-1][1:] == (4, 4)
assert run_external_queue_trial().replicas_reached == 3
for doc in (manifests.hbm_hpa_doc(), manifests.external_hpa_doc()):
    hpa.metrics_from_manifest(doc), hpa.behavior_from_manifest(doc)
    manifests.to_yaml([doc])
print(json.dumps({"loaded": sorted(sys.modules)}))
"""


def test_running_the_pods_and_external_paths_loads_no_jax_or_yaml():
    """The HBM Pods loop and the External rung on virtual clocks, and the
    two HPAs parsed from the generator's dicts and rendered, run in a fresh
    interpreter, load neither JAX, nor the JAX package, nor a YAML
    library."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_PODS_EXTERNAL], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])["loaded"]
    assert {"k8s_gpu_hpa_tpu_torch.control.external_sim",
            "k8s_gpu_hpa_tpu_torch.utils.quantity"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m == "yaml"] == []


def test_the_simulate_command_loads_no_jax_yaml_or_torch():
    """``python -m k8s_gpu_hpa_tpu_torch simulate --scenario spike`` as a
    user runs it, in a fresh interpreter: its report, exit 0, and the
    interpreter's import log (``-X importtime``) names neither JAX, the JAX
    package, PyYAML nor torch: the command reads the manifest with the
    port's own YAML reader and runs on the host alone."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "k8s_gpu_hpa_tpu_torch", "simulate",
         "--scenario", "spike"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    )
    assert "scale-up latency (signal crossing -> all replicas running): 45s" in proc.stdout
    imported = {line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "k8s_gpu_hpa_tpu_torch.simulate" in imported
    assert "k8s_gpu_hpa_tpu_torch.control.loop" in imported
    heavy = [m for m in imported if _forbidden(m) or m.split(".")[0] in ("yaml", "torch")]
    assert heavy == []


@pytest.mark.parametrize("argv,says", [
    (["simulate", "--scenario", "chaos"], "all recovered:            True"),
    (["simulate", "--scenario", "slo"], "verdict: OK"),
    (["gen-pipeline", "--app", "my-app"], "# ===== my-app-hpa.yaml ====="),
    (["simulate", "--scenario", "spike", "--shards", "2", "--explain"],
     "IndexScan kube_pod_labels"),
    (["simulate", "--scenario", "history", "--days", "0.125"],
     "hourly view from the rollup tiers"),
    (["simulate", "--scenario", "crunch"], "contract: all clauses hold"),
    (["simulate", "--scenario", "evacuate", "--smoke"], "contract: all clauses hold"),
    (["simulate", "--scenario", "coverage", "--run", "crunch"], "coverage scorecard — run: crunch"),
    (["simulate", "--scenario", "profile", "--run", "scale", "--smoke"],
     "profile scorecard — run: scale"),
    (["simulate", "--scenario", "fuzz", "--replay", "tests/scenarios/break-grace-canary.json"],
     "scenario break-grace-canary: reproduced bit-identically"),
    (["simulate", "--scenario", "incident", "--smoke"], "incident drill: scenario=paging_evacuate"),
    (["simulate", "--scenario", "races"], "PASS: all schedules bit-identical to serial"),
    (["simulate", "--scenario", "coverage", "--run", "races"], "coverage scorecard — run: races"),
], ids=["chaos", "slo", "gen-pipeline", "shards-explain", "history", "crunch", "evacuate",
        "coverage", "profile", "fuzz-replay", "incident", "races", "coverage-races"])
def test_the_chaos_slo_and_gen_pipeline_commands_load_no_jax_yaml_or_torch(argv, says):
    """The storm, the SLO check, the pipeline generator, the sharded spike
    with its plans, the flight recorder, the capacity crunch, the region
    evacuation, the coverage and profile scenarios, a fuzz artifact's replay,
    the smoke paging drill and the race sweep as a user runs them, in a
    fresh interpreter: exit 0, and the import log names neither JAX, the
    JAX package, PyYAML nor torch."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "k8s_gpu_hpa_tpu_torch", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    )
    assert says in proc.stdout
    imported = {line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    heavy = [m for m in imported if _forbidden(m) or m.split(".")[0] in ("yaml", "torch")]
    assert heavy == []


def test_the_analysis_gate_loads_no_jax_yaml_torch_or_tools():
    """``python -m k8s_gpu_hpa_tpu_torch.analysis --all`` as a user runs it,
    in a fresh interpreter: exit 0 on the port's tree, and the import log
    names neither JAX, the JAX package, PyYAML, torch nor a script of
    ``tools/`` (the port keeps its own copies of their lint bodies)."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "k8s_gpu_hpa_tpu_torch.analysis", "--all"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    )
    assert proc.stdout.startswith("analyze ok: 10 pass(es) clean")
    imported = {line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "k8s_gpu_hpa_tpu_torch.analysis.legacy" in imported
    heavy = [m for m in imported if _forbidden(m) or m.split(".")[0] in ("yaml", "torch", "tools")
             or m.startswith("_analyze_") or m.startswith("lint_")]
    assert heavy == []


_RUN_OPERATOR = """
import json, subprocess, sys
from k8s_gpu_hpa_tpu_torch.control import operator
proc = subprocess.run([sys.executable, "-X", "importtime", "-c",
                       "import k8s_gpu_hpa_tpu_torch.control.operator"],
                      capture_output=True, text=True, check=True)
print(json.dumps({"stderr": proc.stderr, "quantum": operator.quantum_desired(5, 6, 4, 4, 16)}))
"""


def test_the_operator_loads_no_jax_yaml_or_torch():
    """The slice-quantum operator's module, as its container imports it
    (``python -m k8s_gpu_hpa_tpu_torch.control.operator``), in a fresh
    interpreter: the import log names neither JAX, the JAX package, PyYAML
    nor torch, and its rule answers."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_OPERATOR], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    imported = {line.rsplit("|", 1)[1].strip() for line in out["stderr"].splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "k8s_gpu_hpa_tpu_torch.control.operator" in imported
    heavy = [m for m in imported if _forbidden(m) or m.split(".")[0] in ("yaml", "torch")]
    assert heavy == [] and out["quantum"] == 8


def test_no_port_source_names_jax_or_the_jax_package():
    """Static twin of the import check: an import inside a function body
    never runs at import time, so every import statement is read."""
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    found = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                modules = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                modules = [node.module or ""]
            else:
                continue
            found += [(path.name, m) for m in modules if _forbidden(m)]
    assert found == []


def test_no_port_source_imports_a_yaml_library():
    """The port reads and writes no YAML through a library: the GPU
    machine has none.  Shipped specs are dicts or code."""
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                modules = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                modules = [node.module or ""]
            else:
                continue
            found += [(path.name, m) for m in modules if m == "yaml" or m.startswith("yaml.")]
    assert found == []


def test_forbidden_match_is_exact_not_by_prefix():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("k8s_gpu_hpa_tpu") and _forbidden("k8s_gpu_hpa_tpu.metrics.tsdb")
    assert not _forbidden("k8s_gpu_hpa_tpu_torch")
    assert not _forbidden("k8s_gpu_hpa_tpu_torch.ops.matmul")
    assert not _forbidden("jaxlib_free_module")


_RESOLVE_REEXPORTS = """
import importlib, json, sys
torch_free = {}
for package in ("control", "metrics", "utils", "exporter", "loadgen", "models", "ops"):
    module = importlib.import_module("k8s_gpu_hpa_tpu_torch." + package)
    for name in module.__all__:
        getattr(module, name)
    torch_free[package] = "torch" not in sys.modules
print(json.dumps({"torch_free": torch_free, "loaded": sorted(sys.modules)}))
"""


def test_the_packages_re_exports_resolve_lazily_and_load_no_jax():
    """Every name a port package lists in ``__all__`` (the JAX package's
    re-exports) resolves on access, in a fresh interpreter; the control,
    metrics and utils names load no torch, and none loads JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", _RESOLVE_REEXPORTS], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["torch_free"] == {"control": True, "metrics": True, "utils": True,
                                 "exporter": False, "loadgen": False, "models": False,
                                 "ops": False}
    assert [m for m in out["loaded"] if _forbidden(m)] == []
