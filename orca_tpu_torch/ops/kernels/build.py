"""Build the port's native sources and load them with ctypes.

Each source under ``orca_tpu_torch/csrc/`` is compiled on first use into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), in a directory keyed by a hash of the source and the flags: a
``.cu`` file (a CUDA kernel) with nvcc, a ``.cpp`` file (host code) with the
host's C++ compiler. All sources of a call are compiled in parallel, one
compiler process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Sequence

CSRC_DIR = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# no -march=native: a build directory copied to another host would hold an
# illegal instruction there, and the host code's output does not depend on it
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc")
    return path


def cxx_path() -> Optional[str]:
    """The host's C++ compiler on PATH (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def source_path(name: str) -> pathlib.Path:
    """csrc/<name>.cu if there is one, else csrc/<name>.cpp."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _flags(src: pathlib.Path):
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def _compiler(src: pathlib.Path) -> str:
    if src.suffix == ".cu":
        return nvcc_path()
    cxx = cxx_path()
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler (g++ or c++) on PATH to build {src.name}")
    return cxx


def library_path(name: str) -> pathlib.Path:
    """Where the library built from csrc/<name>.cu or .cpp lives for the
    current source and flags."""
    src = source_path(name)
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / key / f"lib{name}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every csrc/<name> not built yet, all compiler processes at
    once. Returns each name's compiler output (nvcc's: the ptxas report;
    empty for a library already built)."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        src = source_path(name)
        compiler = _compiler(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [compiler, *_flags(src), "-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{source_path(name).name}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """A ctypes handle of csrc/<name>.cu or .cpp, built on first use; the caller
    keeps it and declares its functions' argument types."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
