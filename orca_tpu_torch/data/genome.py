"""Genome sequence store: compact base codes + one-hot retrieval.

The reference stores the genome as a float32 one-hot memmap — 16 bytes/bp,
47 GB for hg38 (selene_utils2.py:38-151). Here the persistent format is one
uint8 *base code* per bp (~3 GB for hg38): A=0, C=1, G=2, T=3, other=4.
One-hot expansion is a table lookup at retrieval time: the C++ codec
(data/native.py) where a C++ compiler is on PATH, else numpy. Unknown bases
expand to 0.25 per channel and out-of-bounds queries are padded with 0.25,
matching the reference semantics (selene_utils2.py:201-230).

Coordinates are 0-based half-open. Negative-strand queries return the
reverse complement via the double flip encoding[::-1, ::-1] (valid because
the channel order ACGT is its own complement under reversal).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from orca_tpu_torch.data import native

_CODE = np.full(256, 4, dtype=np.uint8)
for i, base in enumerate("ACGT"):
    _CODE[ord(base)] = i
    _CODE[ord(base.lower())] = i

# code -> one-hot row; row 4 (unknown) is uniform 0.25
_ONEHOT = np.vstack([np.eye(4, dtype=np.float32), np.full(4, 0.25, np.float32)])

# packed quarter-scale uint8 one-hot (one-hot * 4): {0, 1, 4} values, the
# 16x-cheaper wire format consumed by nn.encoders.to_compute_dtype
_ONEHOT_PACKED = np.vstack(
    [np.eye(4, dtype=np.uint8) * 4, np.full(4, 1, np.uint8)]
)


def codes_from_str(seq: str) -> np.ndarray:
    """DNA string -> uint8 base codes."""
    return _CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def sequence_to_encoding(seq: str) -> np.ndarray:
    """DNA string -> (L, 4) float32 one-hot with 0.25 for unknown bases
    (capability of selene's Genome.sequence_to_encoding used at
    orca_predict.py:2365)."""
    return _ONEHOT[codes_from_str(seq)]


def codes_to_encoding(codes: np.ndarray) -> np.ndarray:
    return _ONEHOT[codes]


def encoding_to_codes(encoding: np.ndarray) -> np.ndarray:
    """(L, 4) one-hot -> uint8 codes (0.25-rows -> 4)."""
    is_unk = np.max(encoding, axis=-1) < 0.75
    codes = np.argmax(encoding, axis=-1).astype(np.uint8)
    codes[is_unk] = 4
    return codes


class CodeGenome:
    """Genome backed by per-chromosome uint8 code arrays."""

    def __init__(self, chroms: Dict[str, np.ndarray]):
        self._chroms = dict(chroms)

    def get_chrs(self) -> List[str]:
        return list(self._chroms)

    def get_chr_lens(self) -> List[Tuple[str, int]]:
        return [(c, len(a)) for c, a in self._chroms.items()]

    def chr_len(self, chrom: str) -> int:
        return len(self._chroms[chrom])

    def get_codes(self, chrom: str, start: int, end: int) -> np.ndarray:
        """uint8 codes for [start, end), padding out-of-bounds with code 4."""
        arr = self._chroms[chrom]
        lo, hi = max(start, 0), min(end, len(arr))
        if lo >= hi:
            return np.full(end - start, 4, dtype=np.uint8)
        core = arr[lo:hi]
        if lo == start and hi == end:
            return core
        return np.concatenate(
            [
                np.full(lo - start, 4, dtype=np.uint8),
                core,
                np.full(end - hi, 4, dtype=np.uint8),
            ]
        )

    def get_encoding_from_coords(
        self, chrom: str, start: int, end: int, strand: str = "+"
    ) -> np.ndarray:
        """(end-start, 4) float32 one-hot; '-' returns reverse complement."""
        if strand not in ("+", "-"):
            raise ValueError(f"bad strand {strand!r}")
        codes = self.get_codes(chrom, start, end)
        # the C++ codec where a compiler built it (data/native.py); called
        # through the module, so a wrapper installed there sees every call
        if native.available():
            return native.codes_to_onehot(codes, rc=(strand == "-"))
        enc = codes_to_encoding(codes)
        if strand == "-":
            enc = enc[::-1, ::-1]
        return np.ascontiguousarray(enc)

    def get_packed_encoding_from_coords(
        self, chrom: str, start: int, end: int, strand: str = "+"
    ) -> np.ndarray:
        """(end-start, 4) packed quarter-scale uint8 one-hot ({0, 1, 4}
        values; see nn.encoders.to_compute_dtype). 16x less memory/IPC
        traffic than the float32 encoding — the training input pipeline's
        wire format."""
        if strand not in ("+", "-"):
            raise ValueError(f"bad strand {strand!r}")
        codes = self.get_codes(chrom, start, end)
        enc = _ONEHOT_PACKED[codes]
        if strand == "-":
            enc = enc[::-1, ::-1]
        return np.ascontiguousarray(enc)

    def get_sequence_from_coords(self, chrom: str, start: int, end: int,
                                 strand: str = "+") -> str:
        codes = self.get_codes(chrom, start, end)
        s = "".join("ACGTN"[c] for c in codes)
        if strand == "-":
            comp = str.maketrans("ACGTN", "TGCAN")
            s = s.translate(comp)[::-1]
        return s


class FastaGenome(CodeGenome):
    """CodeGenome parsed directly from a FASTA file (small genomes/tests)."""

    def __init__(self, fasta_path: str):
        super().__init__(read_fasta_codes(fasta_path))


def read_fasta_codes(path: str) -> Dict[str, np.ndarray]:
    chroms: Dict[str, np.ndarray] = {}
    name = None
    parts: List[bytes] = []
    opener = open
    if path.endswith(".gz"):
        import gzip

        opener = gzip.open
    with opener(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    chroms[name] = _codes_from_bytes(b"".join(parts))
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
    if name is not None:
        chroms[name] = _codes_from_bytes(b"".join(parts))
    return chroms


def _codes_from_bytes(b: bytes) -> np.ndarray:
    return _CODE[np.frombuffer(b, dtype=np.uint8)]


class MemmapGenome(CodeGenome):
    """Genome over an on-disk uint8 code memmap (one file + JSON index).

    The framework equivalent of the reference MemmapGenome
    (selene_utils2.py:38-151) at 1/16th the footprint. Build once with
    `MemmapGenome.build`, open many times cheaply (fork-safe: the mmap is
    opened lazily per process).
    """

    def __init__(self, memmap_path: str):
        self.memmap_path = memmap_path
        with open(memmap_path + ".json") as f:
            meta = json.load(f)
        self._index = {c: (int(s), int(e)) for c, s, e in meta["chroms"]}
        self._mmap: Optional[np.memmap] = None
        self._pid = None

    def _data(self) -> np.memmap:
        if self._mmap is None or self._pid != os.getpid():
            self._mmap = np.memmap(self.memmap_path, dtype=np.uint8, mode="r")
            self._pid = os.getpid()
        return self._mmap

    def get_chrs(self):
        return list(self._index)

    def get_chr_lens(self):
        return [(c, e - s) for c, (s, e) in self._index.items()]

    def chr_len(self, chrom):
        s, e = self._index[chrom]
        return e - s

    def get_codes(self, chrom, start, end):
        s, e = self._index[chrom]
        arr = self._data()[s:e]
        lo, hi = max(start, 0), min(end, e - s)
        if lo >= hi:
            return np.full(end - start, 4, dtype=np.uint8)
        core = np.asarray(arr[lo:hi])
        if lo == start and hi == end:
            return core
        return np.concatenate(
            [
                np.full(lo - start, 4, dtype=np.uint8),
                core,
                np.full(end - hi, 4, dtype=np.uint8),
            ]
        )

    @classmethod
    def build(cls, fasta_path: str, memmap_path: str,
              blacklist_intervals: Optional[Sequence] = None) -> "MemmapGenome":
        """One-time FASTA -> code-memmap conversion (the framework's
        equivalent of misc/make_genome_memmap.py). Optionally masks
        blacklist intervals (chrom, start, end) to code 4."""
        chroms = read_fasta_codes(fasta_path)
        if blacklist_intervals:
            for chrom, start, end in blacklist_intervals:
                if chrom in chroms:
                    chroms[chrom][start:end] = 4
        total = sum(len(a) for a in chroms.values())
        mm = np.memmap(memmap_path, dtype=np.uint8, mode="w+", shape=(total,))
        meta = []
        off = 0
        for c, a in chroms.items():
            mm[off : off + len(a)] = a
            meta.append([c, off, off + len(a)])
            off += len(a)
        mm.flush()
        with open(memmap_path + ".json", "w") as f:
            json.dump({"chroms": meta}, f)
        return cls(memmap_path)
