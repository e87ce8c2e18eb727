"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``orca_tpu_torch/csrc/`` is compiled on first use into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), in a directory keyed by a hash of the source and the flags. All
sources of a call are compiled in parallel, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

CSRC_DIR = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc")
    return path


def library_path(name: str) -> pathlib.Path:
    """Where the library built from csrc/<name>.cu lives for the current
    source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / f"lib{name}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every csrc/<name>.cu not built yet, all nvcc processes at once.
    Returns each name's ptxas report (empty for a library already built)."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
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
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """A ctypes handle of csrc/<name>.cu, built on first use; the caller
    keeps it and declares its functions' argument types."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
