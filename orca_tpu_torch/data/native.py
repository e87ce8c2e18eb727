"""ctypes bindings of the host codec, csrc/orca_native.cpp (counterpart of
orca_tpu/data/native.py, with its names, dtypes and shapes).

The source is compiled with the host's C++ compiler on first use, never at
import, into ``orca_tpu_torch/_build/<hash>/`` (``ops/kernels/build.py``).
``available()`` says whether the library loads. Where no C++ compiler is on
PATH it is False and every entry point returns None, so callers take the
numpy path (``data/genome.py``), as in the JAX package. Where a compiler is
there and the build fails, the first call raises with the compiler's output.

Each call of a C function adds one to ``calls[name]`` and the bytes it wrote
into its output buffers to ``bytes_written[name]``, keyed by the C function
(``codes_to_onehot(rc=True)`` runs ``codes_to_onehot_rc``);
``reset_counts()`` sets both to 0.

The bytes out are the JAX package's codec's, quirks included:
  * a FASTA header's name runs to its first blank or its '\\n', so a '\\r'
    before the '\\n' stays in the name (">chr1\\r\\n" names "chr1\\r"), where
    the numpy reader strips it;
  * codes above 4 read as N (0.25 each), where the numpy lookup raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional

import numpy as np

from orca_tpu_torch.ops.kernels import build

C_FUNCTIONS = ("fasta_to_codes", "codes_to_onehot", "codes_to_onehot_rc",
               "onehot_batch_gather")
calls: Dict[str, int] = dict.fromkeys(C_FUNCTIONS, 0)
bytes_written: Dict[str, int] = dict.fromkeys(C_FUNCTIONS, 0)

_lib: Optional[ctypes.CDLL] = None
_no_compiler = False
_lock = threading.Lock()


def reset_counts() -> None:
    for name in C_FUNCTIONS:
        calls[name] = 0
        bytes_written[name] = 0


def _count(name: str, nbytes: int) -> None:
    calls[name] += 1
    bytes_written[name] += nbytes


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fasta_to_codes.restype = ctypes.c_longlong
    lib.fasta_to_codes.argtypes = [ctypes.c_char_p, u8p, i64p,
                                   ctypes.c_char_p, ctypes.c_longlong]
    for fn in (lib.codes_to_onehot, lib.codes_to_onehot_rc):
        fn.restype = None
        fn.argtypes = [u8p, ctypes.c_longlong, f32p]
    lib.onehot_batch_gather.restype = None
    lib.onehot_batch_gather.argtypes = [
        u8p, ctypes.c_longlong, i64p, u8p, ctypes.c_longlong,
        ctypes.c_longlong, f32p,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _no_compiler
    with _lock:
        if _lib is None and not _no_compiler:
            if build.cxx_path() is None:
                _no_compiler = True
            else:
                _lib = _declare(build.load("orca_native"))
        return _lib


def available() -> bool:
    return _load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def fasta_to_codes(path: str, max_size: Optional[int] = None,
                   max_chroms: int = 4096):
    """Parse FASTA into (codes: uint8 array, [(name, start, end), ...]).
    Returns None if the library is unavailable, the file cannot be opened or
    it holds more than `max_chroms` records."""
    lib = _load()
    if lib is None:
        return None
    file_size = os.path.getsize(path)
    # the parser writes codes and names with no bound: neither can outgrow
    # the file, so buffers of its size are safe
    if max_size and max_size < file_size:
        raise ValueError(f"max_size {max_size} is below the file's "
                         f"{file_size} bytes")
    codes = np.empty(max_size or file_size, dtype=np.uint8)
    offsets = np.zeros(2 * max_chroms, dtype=np.int64)
    names = ctypes.create_string_buffer(max(max_chroms * 256, file_size + 1))
    n = lib.fasta_to_codes(path.encode(), _u8ptr(codes), _i64ptr(offsets),
                           names, max_chroms)
    if n < 0:  # -1: the file does not open; -2: more than max_chroms records
        return None
    name_list = names.raw.split(b"\0")[:n]
    chroms = [
        (name_list[i].decode(), int(offsets[2 * i]), int(offsets[2 * i + 1]))
        for i in range(n)
    ]
    total = chroms[-1][2] if chroms else 0
    _count("fasta_to_codes",
           total + 16 * n + sum(len(m) + 1 for m in name_list))
    return codes[:total].copy(), chroms


def codes_to_onehot(codes: np.ndarray, rc: bool = False) -> Optional[np.ndarray]:
    """(n,) uint8 codes -> (n, 4) float32 one-hot, 0.25 for N; with `rc` the
    reverse complement (the reference's encoding[::-1, ::-1])."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty((len(codes), 4), dtype=np.float32)
    name = "codes_to_onehot_rc" if rc else "codes_to_onehot"
    getattr(lib, name)(_u8ptr(codes), len(codes), _f32ptr(out))
    _count(name, out.nbytes)
    return out


def onehot_batch_gather(genome_codes: np.ndarray, starts: np.ndarray,
                        strands: np.ndarray, window_len: int
                        ) -> Optional[np.ndarray]:
    """Batched window expansion: (W,) starts/strands -> (W, window_len, 4);
    a nonzero strand takes the reverse complement, positions outside the
    genome read 0.25."""
    lib = _load()
    if lib is None:
        return None
    genome_codes = np.ascontiguousarray(genome_codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    strands = np.ascontiguousarray(strands, dtype=np.uint8)
    if starts.ndim != 1 or strands.shape != starts.shape or window_len < 0:
        raise ValueError(f"starts {starts.shape} and strands {strands.shape} "
                         f"must be one (W,) each, window_len {window_len} "
                         ">= 0")
    out = np.empty((len(starts), window_len, 4), dtype=np.float32)
    lib.onehot_batch_gather(
        _u8ptr(genome_codes), len(genome_codes), _i64ptr(starts),
        _u8ptr(strands), len(starts), window_len, _f32ptr(out),
    )
    _count("onehot_batch_gather", out.nbytes)
    return out
