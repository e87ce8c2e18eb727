"""Native cooler/mcool reader over h5py.

Implements the retrieval semantics the reference depends on —
``cooler.Cooler(uri).matrix(balance=True).fetch(q1, q2)``
(selene_utils2.py:561-584) — directly against the HDF5 cooler schema
(bins/pixels/indexes + balancing weights), so the production contact-data
path runs in environments without the `cooler` package. `cooler` itself
remains an optional fast path in targets.CoolerContactMatrix.

Cooler schema (single-resolution group):
  chroms/{name, length}
  bins/{chrom, start, end, weight}       # uniform bins, weight may be NaN
  pixels/{bin1_id, bin2_id, count}       # upper triangle, sorted
  indexes/{chrom_offset, bin1_offset}    # CSR row offsets into pixels

Balanced fetch: dense[i, j] = count * weight[bin1] * weight[bin2],
symmetrized (storage is upper-triangular), with every row/column whose
weight is non-finite set to NaN — including zero-count entries, matching
cooler's rescale-and-mask behavior.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def parse_cooler_uri(uri: str) -> Tuple[str, Optional[str]]:
    """'file.mcool::/resolutions/4000' -> (path, group); plain paths give
    (path, None)."""
    if "::" in uri:
        path, group = uri.split("::", 1)
        return path, group or None
    return uri, None


class NativeCooler:
    """Lazy, fork-safe h5py handle to one cooler resolution.

    uri: a cooler URI ('x.cool', 'x.mcool::/resolutions/4000'); a bare
    .mcool path with exactly one stored resolution resolves to it.
    """

    def __init__(self, uri: str):
        self.uri = uri
        self.path, self.group = parse_cooler_uri(uri)
        self._h5 = None  # opened lazily (h5py handles don't survive fork)
        self._weights = None
        self._chrom_index = None

    # -- file plumbing ----------------------------------------------------

    def _root(self):
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self.path, "r")
        g = self._h5
        if self.group:
            return g[self.group]
        if "bins" in g:
            return g
        if "resolutions" in g:
            names = list(g["resolutions"])
            if len(names) == 1:
                return g["resolutions"][names[0]]
            raise ValueError(
                f"{self.path} holds resolutions {names}; pick one with "
                f"'{self.path}::/resolutions/<res>'"
            )
        raise ValueError(f"{self.path} is not a cooler file")

    @property
    def binsize(self) -> int:
        root = self._root()
        # the "bin-size" attr (written by write_cooler and standard
        # coolers) is authoritative; the start-difference heuristic is
        # wrong when the first chromosome holds exactly one bin (starts[1]
        # is then the next chromosome's 0).
        bs = root.attrs.get("bin-size")
        if bs is not None:
            return int(bs)
        starts = root["bins"]["start"]
        chrom = root["bins"]["chrom"]
        if starts.shape[0] > 1 and int(chrom[1]) == int(chrom[0]):
            return int(starts[1]) - int(starts[0])
        return int(root["bins"]["end"][0])

    def chromnames(self):
        return [
            n.decode() if isinstance(n, bytes) else str(n)
            for n in self._root()["chroms"]["name"][:]
        ]

    def _chrom(self, name: str) -> int:
        if self._chrom_index is None:
            self._chrom_index = {n: i for i, n in enumerate(self.chromnames())}
        try:
            return self._chrom_index[name]
        except KeyError:
            raise KeyError(
                f"chromosome {name!r} not in {self.uri} "
                f"({sorted(self._chrom_index)})"
            ) from None

    def _extent(self, chrom: str, start: int, end: int) -> Tuple[int, int]:
        """Bin range [b0, b1) covering [start, end) on chrom (cooler
        region_to_extent: first bin containing start, last containing
        end-1)."""
        root = self._root()
        res = self.binsize
        ci = self._chrom(chrom)
        off = int(root["indexes"]["chrom_offset"][ci])
        nxt = int(root["indexes"]["chrom_offset"][ci + 1])
        b0 = off + int(start) // res
        b1 = off + -(-int(end) // res)
        if b0 < off or b1 > nxt:
            raise ValueError(
                f"{chrom}:{start}-{end} outside chromosome bins"
            )
        return b0, b1

    def weights(self, name: str = "weight") -> np.ndarray:
        if self._weights is None:
            bins = self._root()["bins"]
            if name in bins:
                self._weights = np.asarray(bins[name][:], np.float64)
            else:
                raise KeyError(
                    f"no balancing weights {name!r} in {self.uri}"
                )
        return self._weights

    # -- retrieval --------------------------------------------------------

    def _pixel_block(self, r0, r1, c0, c1):
        """COO (rows, cols, counts) of stored pixels with bin1 in [r0, r1)
        and bin2 in [c0, c1) — one contiguous CSR slab + a bin2 mask."""
        root = self._root()
        b1off = root["indexes"]["bin1_offset"]
        lo, hi = int(b1off[r0]), int(b1off[r1])
        if lo == hi:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.float64)
        px = root["pixels"]
        bin1 = np.asarray(px["bin1_id"][lo:hi], np.int64)
        bin2 = np.asarray(px["bin2_id"][lo:hi], np.int64)
        cnt = np.asarray(px["count"][lo:hi], np.float64)
        m = (bin2 >= c0) & (bin2 < c1)
        return bin1[m], bin2[m], cnt[m]

    def fetch(self, chrom: str, start: int, end: int,
              chrom2: Optional[str] = None, start2: Optional[int] = None,
              end2: Optional[int] = None, balance: bool = True) -> np.ndarray:
        """Dense (rows, cols) matrix for [start, end) x [start2, end2)."""
        if chrom2 is None:
            chrom2, start2, end2 = chrom, start, end
        r0, r1 = self._extent(chrom, start, end)
        c0, c1 = self._extent(chrom2, start2, end2)
        n1, n2 = r1 - r0, c1 - c0
        out = np.zeros((n1, n2), np.float64)

        # upper-triangle slab (bin1 rows) + its mirror (bin1 in the column
        # range, bin2 in the row range) — together they cover the full
        # rectangle; the shared diagonal is deduplicated below.
        i, j, v = self._pixel_block(r0, r1, c0, c1)
        np.add.at(out, (i - r0, j - c0), v)
        i2, j2, v2 = self._pixel_block(c0, c1, r0, r1)
        keep = i2 != j2  # diagonal already added by the first slab
        np.add.at(out, (j2[keep] - r0, i2[keep] - c0), v2[keep])

        if balance:
            w = self.weights()
            w1 = w[r0:r1]
            w2 = w[c0:c1]
            out *= w1[:, None] * w2[None, :]
            out[~np.isfinite(w1), :] = np.nan
            out[:, ~np.isfinite(w2)] = np.nan
        return out.astype(np.float32)

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None


def write_cooler(path: str, chromlens: dict, resolution: int,
                 pixels: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 weights: Optional[np.ndarray] = None,
                 group: Optional[str] = None) -> None:
    """Write a minimal standards-conforming cooler (test fixtures + the
    expectation pipeline's intermediate stores). pixels = (bin1_id,
    bin2_id, count) upper-triangular, will be sorted here."""
    import h5py

    bin1, bin2, count = (np.asarray(a) for a in pixels)
    if np.any(bin1 > bin2):
        raise ValueError("pixels must be upper-triangular (bin1 <= bin2)")
    order = np.lexsort((bin2, bin1))
    bin1, bin2, count = bin1[order], bin2[order], count[order]

    names = list(chromlens)
    lens = np.array([chromlens[n] for n in names], np.int64)
    nbins_per = -(-lens // resolution)
    chrom_offset = np.concatenate([[0], np.cumsum(nbins_per)])
    nbins = int(chrom_offset[-1])

    bchrom = np.concatenate([
        np.full(nb, i, np.int32) for i, nb in enumerate(nbins_per)
    ])
    bstart = np.concatenate([
        np.arange(nb, dtype=np.int64) * resolution for nb in nbins_per
    ])
    bend = np.concatenate([
        np.minimum((np.arange(nb, dtype=np.int64) + 1) * resolution, ln)
        for nb, ln in zip(nbins_per, lens)
    ])

    bin1_offset = np.searchsorted(bin1, np.arange(nbins + 1))

    with h5py.File(path, "a") as f:
        g = f.require_group(group) if group else f
        for name in ("chroms", "bins", "pixels", "indexes"):
            if name in g:
                del g[name]
        g.create_group("chroms")
        g["chroms"]["name"] = np.array([n.encode() for n in names])
        g["chroms"]["length"] = lens
        g.create_group("bins")
        g["bins"]["chrom"] = bchrom
        g["bins"]["start"] = bstart
        g["bins"]["end"] = bend
        if weights is not None:
            g["bins"]["weight"] = np.asarray(weights, np.float64)
        g.create_group("pixels")
        g["pixels"]["bin1_id"] = bin1.astype(np.int64)
        g["pixels"]["bin2_id"] = bin2.astype(np.int64)
        g["pixels"]["count"] = count
        g.create_group("indexes")
        g["indexes"]["chrom_offset"] = chrom_offset.astype(np.int64)
        g["indexes"]["bin1_offset"] = bin1_offset.astype(np.int64)
        g.attrs["bin-size"] = resolution
        g.attrs["format"] = "HDF5::Cooler"
