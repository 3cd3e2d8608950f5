"""The port's public surface held to the JAX package's.

Both packages are parsed with ``ast``; neither is imported.  Every module of
``k8s_gpu_hpa_tpu/`` must have a file under the same path in
``k8s_gpu_hpa_tpu_torch/``, and every public name the JAX module defines a
counterpart of the same name in that file:

- a function, with each of its parameters;
- a class (private ones too: their public members count), with each public
  method and its parameters, each class attribute or dataclass field, and
  each parameter of its ``__init__``, which the port's class may take as an
  ``__init__`` parameter, a field or an attribute;
- a module-level constant;
- a package's re-export (its ``__all__``), which the port's package lists
  in its own ``__all__`` or ``_EXPORTS``.

The port's counterpart may be bound any way: defined, assigned or imported.
The only exceptions are the rows of ``NO_COUNTERPART``: the JAX name (a
glob where one reason covers several), the port's counterpart under
another name or None, and the reason.  A row on a module covers its names,
a row on a class its members.  Stale rows fail too: one whose JAX name no
longer exists, one that excuses nothing because the port has the name, and
one whose counterpart the port lacks.
"""

import ast
from fnmatch import fnmatchcase
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "k8s_gpu_hpa_tpu"
PORT = REPO / "k8s_gpu_hpa_tpu_torch"

#: JAX name -> (the port's counterpart, or None; why there is no same-named one)
NO_COUNTERPART = {
    "utils/jax_compat.py": (None, "JAX API shims across JAX versions"),
    "ops/pallas_matmul.py": ("ops/matmul.py", "the Pallas GEMM; the port's is the Hopper GEMM"),
    "exporter/libtpu_proto.py": (
        None, "libtpu's gRPC messages; NVML is a C library read through ctypes"),
    "exporter/stub_libtpu.py": ("exporter/stub_nvml.py", "the stub of the device runtime"),
    "exporter/sources.py::LibtpuSource": ("NvmlSource", "the device runtime's metrics source"),
    "exporter/sources.py::MergedLibtpuSource": (
        None, "libtpu serves each chip group on its own port; one NVML handle reads every GPU"),
    "exporter/sources.py::JaxDeviceSource": (
        "TorchDeviceSource", "the in-process source of the framework's devices"),
    "exporter/sources.py::LIBTPU_*": (
        None, "libtpu's metric names; NVML reads fields by number (exporter/nvml.py)"),
    "exporter/sources.py::parse_metric_response": (None, "decodes libtpu's gRPC response"),
    "exporter/__init__.py::LibtpuSource": ("NvmlSource", "the device runtime's metrics source"),
    "exporter/__init__.py::JaxDeviceSource": (
        "TorchDeviceSource", "the in-process source of the framework's devices"),
    "exporter/podresources.py::TPU_RESOURCE": ("GPU_RESOURCE", "the device plugin's resource"),
    "doctor.py::probe_libtpu": ("probe_nvml", "the probe of the device runtime"),
    "loadgen/matmul.py::MatmulLoadGen.__init__(use_pallas)": (
        "use_kernel", "selects the hand-written kernel, not Pallas"),
    "manifests.py::TPU_RESOURCE": ("GPU_RESOURCE", "the device plugin's resource"),
    "manifests.py::ACCEL_V5E": ("ACCEL_H100", "the accelerator's node label value"),
    "manifests.py::ACCEL_V5P": (None, "one GPU accelerator is shipped, not two TPU generations"),
    "manifests.py::NODE_SELECTOR_TOPO": (None, "a GPU node has no TPU topology label"),
    "manifests.py::tpu_tolerations": ("gpu_tolerations", "the device plugin's taint"),
    "manifests.py::*(tpu_limit)": ("gpu_limit", "the devices a pod asks for"),
    "manifests.py::*(topology)": (None, "a GPU node has no TPU topology label"),
    "manifests.py::PipelineSpec.tpu_limit": ("gpu_limit", "the devices a pod asks for"),
    "manifests.py::PipelineSpec.topology": (None, "a GPU node has no TPU topology label"),
    "models/*::init_*(key)": ("generator", "a seeded torch.Generator, not a JAX PRNG key"),
    "models/transformer.py::tp_params(params)": (
        "params_np", "takes the full parameters as numpy arrays"),
    "models/resnet.py::ModuleDef": (None, "flax's module-constructor type"),
    "models/resnet.py::BottleneckBlock.conv": (
        None, "flax's choice of convolution module; the block builds torch's Conv2d"),
    "models/resnet.py::BottleneckBlock.norm": (
        None, "flax's choice of norm module; the block builds the port's BatchNorm"),
    "ops/__init__.py::flash_attention": (
        None, "the port's ops.flash_attention is the kernel's module, which its callers build "
              "and launch through"),
    "ops/__init__.py::matmul": (None, "the port's ops.matmul is the GEMM's module"),
    "ops/__init__.py::matmul_pallas": ("matmul_kernel", "the hand-written GEMM's wrapper"),
    "parallel/mesh.py::make_mesh(devices)": (None, "the mesh spans the process group's ranks"),
    "perfgates.py::PROFILE_SMOKE_*": (
        None, "they size tools/profile_sim.py, which drives the JAX package"),
    "control/loop.py::PipelineIntervals.exporter_sample": (
        None, "never read by JAX's pipeline; the sweep period is "
              "SimCluster(exporter_sample_interval=) in both packages"),
}

JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _targets(node: ast.stmt) -> list[str]:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _literal_names(tree: ast.Module, name: str) -> list[str]:
    """The strings of a module-level list, tuple or dict (its keys) literal."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and name in _targets(node):
            value = node.value
            items = value.keys if isinstance(value, ast.Dict) else getattr(value, "elts", [])
            return [e.value for e in items if isinstance(e, ast.Constant)]
    return []


def jax_surface(path: Path) -> dict[str, list[str] | None]:
    """The public names a JAX module defines: ``name`` or ``Class.member``
    (with the parameter list of a function or method, else None), and
    ``Class.__init__(param)`` for each constructor parameter."""
    tree = ast.parse(path.read_text())
    exported = set(_literal_names(tree, "__all__"))
    out: dict[str, list[str] | None] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            if not node.name.startswith("_"):
                out[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name == "__init__":
                        out.update({f"{node.name}.__init__({p})": None for p in _params(sub)})
                    elif not sub.name.startswith("_"):
                        out[f"{node.name}.{sub.name}"] = _params(sub)
                out.update({f"{node.name}.{t}": None for t in _targets(sub)
                            if not t.startswith("_")})
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update({al.asname or al.name: None for al in node.names
                        if (al.asname or al.name) in exported})
        else:
            out.update({t: None for t in _targets(node) if not t.startswith("_")})
    return out


def _members(cls: ast.ClassDef, classes: dict[str, ast.ClassDef]) -> dict:
    """A port class's members: its methods (with parameters), class
    attributes, ``self.x`` attributes and ``__init__`` parameters, and those
    of its bases in the same module."""
    out: dict[str, list[str] | None] = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id in classes and base.id != cls.name:
            out.update(_members(classes[base.id], classes))
    for sub in ast.walk(cls):
        if (isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store)
                and isinstance(sub.value, ast.Name) and sub.value.id == "self"):
            out.setdefault(sub.attr, None)
    for sub in cls.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[sub.name] = _params(sub)
        out.update({t: None for t in _targets(sub)})
    for p in out.get("__init__") or []:
        out.setdefault(p, None)
    return out


def _port_source(node: ast.stmt) -> dict | None:
    """The surface of the port module a ``from k8s_gpu_hpa_tpu_torch.x
    import y`` reads, so that an imported function keeps its parameters."""
    if not (isinstance(node, ast.ImportFrom) and node.module
            and node.module.startswith("k8s_gpu_hpa_tpu_torch.")):
        return None
    path = PORT.joinpath(*node.module.split(".")[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return port_surface(path) if path.exists() else None


#: path -> its port surface; a module whose surface is being read (an import
#: cycle) reads as empty, so its names carry no parameters there
_PORT_SURFACES: dict[Path, dict] = {}


def port_surface(path: Path) -> dict[str, list[str] | None]:
    """Every name a port module binds, public or not, and its classes'
    members as ``Class.member``; a name imported from another port module
    carries what it has there."""
    if path not in _PORT_SURFACES:
        _PORT_SURFACES[path] = {}
        _PORT_SURFACES[path] = _read_port_surface(path)
    return _PORT_SURFACES[path]


def _read_port_surface(path: Path) -> dict[str, list[str] | None]:
    tree = ast.parse(path.read_text())
    out: dict[str, list[str] | None] = {}
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            out.update({f"{node.name}.{m}": p for m, p in _members(node, classes).items()})
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            source = _port_source(node)
            for al in node.names:
                bound = al.asname or al.name.split(".")[0]
                out[bound] = source.get(al.name) if source else None
                if source:  # an imported class brings its members
                    out.update({f"{bound}.{k.split('.', 1)[1]}": v for k, v in source.items()
                                if k.startswith(al.name + ".")})
        else:
            out.update({t: None for t in _targets(node)})
    for name in _literal_names(tree, "__all__") + _literal_names(tree, "_EXPORTS"):
        out.setdefault(name, None)
    return out


def _has(port: dict, name: str) -> bool:
    """Whether the port binds JAX's ``name`` (``f(param)``, ``C.__init__(param)``
    or a plain name) under the same name."""
    if "(" not in name:
        return name in port
    owner, param = name[:-1].split("(")
    if owner.endswith(".__init__"):
        cls = owner[: -len(".__init__")]
        return param in (port.get(f"{cls}.__init__") or []) or f"{cls}.{param}" in port
    return param in (port.get(owner) or [])


def jax_keys(module: str) -> list[str]:
    """The module's key, then ``module::name`` for each public name and
    ``module::function(param)`` for each parameter."""
    keys = [module]
    for name, params in jax_surface(JAX / module).items():
        keys.append(f"{module}::{name}")
        keys += [f"{module}::{name}({p})" for p in params or []]
    return keys


def _covers(row: str, key: str) -> bool:
    return (key == row or fnmatchcase(key, row)
            or any(key.startswith(row + sep) for sep in ("::", ".", "(")))


def missing(module: str) -> list[str]:
    """The JAX keys of ``module`` the port has no same-named counterpart for."""
    port_file = PORT / module
    if not port_file.exists():
        return [module]
    port = port_surface(port_file)
    return [key for key in jax_keys(module)[1:] if not _has(port, key.split("::", 1)[1])]


def _excused(key: str) -> bool:
    return any(_covers(row, key) for row in NO_COUNTERPART)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_name_has_a_counterpart(module):
    lacking = [key for key in missing(module) if not _excused(key)]
    assert not lacking, f"no counterpart in k8s_gpu_hpa_tpu_torch/ and no NO_COUNTERPART row: {lacking}"


def test_no_counterpart_rows_are_current():
    """Each row names JAX keys that exist, excuses at least one key the port
    lacks, and gives a reason."""
    keys = [key for module in JAX_MODULES for key in jax_keys(module)]
    lacking = {key for module in JAX_MODULES for key in missing(module)}
    stale = [row for row in NO_COUNTERPART if not any(_covers(row, key) for key in keys)]
    assert not stale, f"NO_COUNTERPART rows whose JAX name no longer exists: {stale}"
    idle = [row for row in NO_COUNTERPART if not any(_covers(row, key) for key in lacking)]
    assert not idle, f"NO_COUNTERPART rows the port no longer needs: {idle}"
    assert all(len(reason) > 10 for _, reason in NO_COUNTERPART.values())


def test_each_named_counterpart_exists_in_the_port():
    """A row's counterpart is the port's module, name or parameter there."""
    absent = []
    for row, (counterpart, _) in NO_COUNTERPART.items():
        if counterpart is None:
            continue
        if counterpart.endswith(".py"):
            found = (PORT / counterpart).exists()
        else:
            module = row.split("::")[0]
            keys = [key for m in JAX_MODULES if fnmatchcase(m, module)
                    for key in jax_keys(m) if "::" in key and fnmatchcase(key, row)]
            found = bool(keys) and all(_counterpart_of(key, counterpart) for key in keys)
        if not found:
            absent.append((row, counterpart))
    assert not absent, f"counterparts the port lacks: {absent}"


def _counterpart_of(key: str, counterpart: str) -> bool:
    """Whether the port binds ``counterpart`` in JAX's ``key``'s place: a
    parameter of the same function, a member of the same class, or a name
    of the same module."""
    module, name = key.split("::", 1)
    port = port_surface(PORT / module)
    if name.endswith(")"):
        return _has(port, f"{name.split('(')[0]}({counterpart})")
    if "." in name:
        return f"{name.split('.')[0]}.{counterpart}" in port
    return counterpart in port


def test_the_check_sees_a_missing_method_and_parameter(tmp_path, monkeypatch):
    """The check itself: a port module copied with a method and a parameter
    taken out reports both, and the full check fails on it."""
    module = "loadgen/train.py"
    source = (PORT / module).read_text()
    assert "    def run_for(self, seconds: float)" in source
    cut = source.replace("    def run_for(self, seconds: float)", "    def _gone(self, seconds: float)")
    cut = cut.replace("def make_checkpoint_manager(directory: str, max_to_keep",
                      "def make_checkpoint_manager(directory: str, keep", 1)
    (tmp_path / "loadgen").mkdir()
    (tmp_path / module).write_text(cut)
    monkeypatch.setitem(globals(), "PORT", tmp_path)
    lacking = missing(module)
    assert f"{module}::TrainLoadGen.run_for" in lacking
    assert f"{module}::make_checkpoint_manager(max_to_keep)" in lacking
    with pytest.raises(AssertionError, match="run_for"):
        test_every_public_jax_name_has_a_counterpart(module)
