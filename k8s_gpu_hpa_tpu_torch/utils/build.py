"""Build a shared library from sources in the checkout, at first use.

Both native parts of the port (the CUDA kernels under ``ops/csrc`` and the
exporter core in ``cpp/exporter``) are compiled by calling the compiler
directly and loaded with ctypes.  Outputs go to the package's ``_build``
directory, which ``.gitignore`` lists.  A library is rebuilt when it is
missing or older than any of its sources.  The compiler writes a temporary
file, named for its process and thread, that is then renamed into place, so
processes or threads that build at once never load a half-written library.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: nvcc flags of every CUDA kernel of the port: Hopper with its arch-specific
#: features (the ``a`` of ``sm_90a``), a plain C interface for ctypes, and
#: ptxas's register and shared-memory report
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc() -> str:
    """The CUDA compiler: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found on PATH or under /usr/local/cuda/bin")


def build_shared(
    name: str, sources: list[Path], command: list[str], headers: tuple[Path, ...] = ()
) -> tuple[Path, str]:
    """Build ``BUILD_DIR/name`` with ``command + ["-o", tmp] + sources``.
    ``headers`` are files the sources include: a newer one rebuilds too.

    Returns the library's path and the compiler's output (empty when the
    library was already up to date).  A failed build raises
    ``subprocess.CalledProcessError`` carrying the compiler's output."""
    out = BUILD_DIR / name
    if out.exists() and all(
        out.stat().st_mtime >= s.stat().st_mtime for s in [*sources, *headers]
    ):
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{name}.tmp.{os.getpid()}.{threading.get_ident()}")
    try:
        proc = subprocess.run(
            [*command, "-o", str(tmp), *map(str, sources)],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out, proc.stdout + proc.stderr
