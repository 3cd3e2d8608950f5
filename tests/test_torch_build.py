"""The port's native build (k8s_gpu_hpa_tpu_torch/utils/build.py): a library
is built once, rebuilt when a source is newer, and a failed build raises and
leaves nothing behind.  The C++ compiler stands in for nvcc, which builds the
CUDA kernels the same way on the GPU's machine."""

import os
import subprocess

import pytest

from k8s_gpu_hpa_tpu_torch.utils import build
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

CXX = ["g++", "-O1", "-shared", "-fPIC"]


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    return out


def test_builds_once_and_again_when_a_source_is_newer(build_dir, tmp_path):
    src = tmp_path / "one.cc"
    src.write_text('extern "C" int one() { return 1; }\n')
    lib, _ = build.build_shared("libone.so", [src], CXX)
    assert lib == build_dir / "libone.so" and lib.exists()
    assert build.build_shared("libone.so", [src], CXX) == (lib, "")  # up to date
    later = lib.stat().st_mtime + 10
    os.utime(src, (later, later))
    rebuilt, _ = build.build_shared("libone.so", [src], CXX)
    assert rebuilt.stat().st_mtime >= lib.stat().st_mtime
    assert build.build_shared("libone.so", [src], CXX) == (lib, "")
    assert sorted(p.name for p in build_dir.iterdir()) == ["libone.so"]


def test_rebuilds_when_an_included_header_is_newer(build_dir, tmp_path):
    header = tmp_path / "one.h"
    header.write_text("#define ONE 1\n")
    src = tmp_path / "one.cc"
    src.write_text('#include "one.h"\nextern "C" int one() { return ONE; }\n')
    lib, _ = build.build_shared("libone.so", [src], CXX, (header,))
    # as if the library had been built from this source before the header changed
    stale = header.stat().st_mtime - 10
    os.utime(src, (stale - 10, stale - 10))
    os.utime(lib, (stale, stale))
    assert build.build_shared("libone.so", [src], CXX) == (lib, "")
    assert lib.stat().st_mtime == stale  # the header was not named: no rebuild
    build.build_shared("libone.so", [src], CXX, (header,))
    assert lib.stat().st_mtime > stale


def test_failed_build_raises_and_leaves_no_file(build_dir, tmp_path):
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    with pytest.raises(subprocess.CalledProcessError) as err:
        build.build_shared("libbad.so", [src], CXX)
    assert "bad.cc" in err.value.stderr
    assert list(build_dir.iterdir()) == []


def test_force_rebuilds_an_up_to_date_library(build_dir, tmp_path):
    src = tmp_path / "one.cc"
    src.write_text('extern "C" int one() { return 1; }\n')
    lib, _ = build.build_shared("libone.so", [src], CXX)
    old = lib.stat().st_mtime - 10
    os.utime(lib, (old, old))  # still newer than nothing it was built from
    os.utime(src, (old - 10, old - 10))
    assert build.build_shared("libone.so", [src], CXX) == (lib, "")
    rebuilt, _ = build.build_shared("libone.so", [src], CXX, force=True)
    assert rebuilt == lib and lib.stat().st_mtime > old


@pytest.mark.parametrize("present,force", [(False, False), (True, False), (True, True),
                                           (False, True)])
def test_build_native_builds_when_jax_s_does(build_dir, tmp_path, monkeypatch, present, force):
    """``build_native(force=)``: the exporter core is compiled when its
    library is missing or when forced, and left alone otherwise, as the JAX
    package's cmake build is.  Both compilers are stubbed: each records the
    call and writes a placeholder where its library goes."""
    from k8s_gpu_hpa_tpu.exporter import native as jax_native
    from k8s_gpu_hpa_tpu_torch.exporter import native

    jax_lib = tmp_path / "cpp-build" / "libtpu_exporter.so"
    monkeypatch.setattr(jax_native, "_BUILD_DIR", jax_lib.parent)
    monkeypatch.setattr(jax_native, "_LIB_PATH", jax_lib)
    port_lib = build_dir / "libtpu_exporter.so"
    if present:
        for lib in (jax_lib, port_lib):
            lib.parent.mkdir(parents=True, exist_ok=True)
            lib.write_bytes(b"built")
    calls = []

    def compiler(command, **_):
        calls.append(command[0])
        if "-o" in command:
            out = command[command.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"rebuilt")
        return subprocess.CompletedProcess(command, 0, "", "")

    monkeypatch.setattr(subprocess, "run", compiler)
    assert native.build_native(force=force) == port_lib
    port_built = bool(calls)
    calls.clear()
    assert jax_native.build_native(force=force) == jax_lib
    jax_built = bool(calls)
    assert port_built == jax_built == (force or not present)
