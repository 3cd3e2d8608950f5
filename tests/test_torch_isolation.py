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


def test_forbidden_match_is_exact_not_by_prefix():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("k8s_gpu_hpa_tpu") and _forbidden("k8s_gpu_hpa_tpu.metrics.tsdb")
    assert not _forbidden("k8s_gpu_hpa_tpu_torch")
    assert not _forbidden("k8s_gpu_hpa_tpu_torch.ops.matmul")
    assert not _forbidden("jaxlib_free_module")
