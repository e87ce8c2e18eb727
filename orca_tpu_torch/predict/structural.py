"""Structural-variant algebra over genomic segment lists.

Represents a (possibly rearranged) chromosome as an ordered list of oriented
reference segments and supports duplication, deletion, inversion, insertion
and concatenation, with coordinate queries in both directions. Capability
parity with the reference's StructuralChange2 (orca_utils.py:733-965).

Note on a reference quirk: the reference's `invert` always sets segment
strand to "-" even for already-inverted segments
(``"-" if strand == "+" else "-"``, orca_utils.py:870), so double inversion
does not round-trip there. Here inversion flips the strand properly; a
compat flag reproduces the reference behavior for bit-parity testing.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Segment:
    """An oriented reference interval [start, end) on `chrom`."""

    chrom: str
    start: int
    end: int
    strand: str = "+"

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"segment end < start: {self}")
        if self.strand not in ("+", "-"):
            raise ValueError(f"bad strand {self.strand!r}")

    @property
    def length(self) -> int:
        return self.end - self.start

    def flipped(self) -> "Segment":
        return dataclasses.replace(
            self, strand="-" if self.strand == "+" else "+"
        )


class StructuralChange:
    """Mutable rearranged-chromosome model.

    Coordinates in all operations refer to the *current* (mutated) chromosome
    state; each operation updates the coordinate system.
    """

    def __init__(self, chrom: str, length: int,
                 ref_invert_quirk: bool = False):
        self.chrom = chrom
        self.segments: List[Segment] = [Segment(chrom, 0, length, "+")]
        self.ref_invert_quirk = ref_invert_quirk

    # -- derived state ----------------------------------------------------

    @property
    def coord_points(self) -> List[int]:
        pts = [0]
        for seg in self.segments:
            pts.append(pts[-1] + seg.length)
        return pts

    @property
    def length(self) -> int:
        return sum(s.length for s in self.segments)

    # -- internals --------------------------------------------------------

    def _split(self, pos: int) -> None:
        """Ensure `pos` is a segment boundary."""
        pts = self.coord_points
        if pos in pts:
            return
        if not 0 <= pos <= pts[-1]:
            raise ValueError(f"position {pos} outside chromosome [0, {pts[-1]}]")
        i = bisect(pts, pos) - 1
        seg = self.segments[i]
        off = pos - pts[i]
        if seg.strand == "+":
            left = Segment(seg.chrom, seg.start, seg.start + off, "+")
            right = Segment(seg.chrom, seg.start + off, seg.end, "+")
        else:
            left = Segment(seg.chrom, seg.end - off, seg.end, "-")
            right = Segment(seg.chrom, seg.start, seg.end - off, "-")
        self.segments[i : i + 1] = [left, right]

    def _span_indices(self, start: int, end: int) -> Tuple[int, int]:
        self._split(start)
        self._split(end)
        pts = self.coord_points
        return bisect(pts, start) - 1, bisect(pts, end) - 1

    # -- operations -------------------------------------------------------

    def duplicate(self, start: int, end: int) -> "StructuralChange":
        """Tandem-duplicate [start, end)."""
        i, j = self._span_indices(start, end)
        self.segments[j:j] = [dataclasses.replace(s) for s in self.segments[i:j]]
        return self

    def delete(self, start: int, end: int) -> "StructuralChange":
        i, j = self._span_indices(start, end)
        del self.segments[i:j]
        return self

    def invert(self, start: int, end: int) -> "StructuralChange":
        i, j = self._span_indices(start, end)
        if self.ref_invert_quirk:
            flipped = [
                dataclasses.replace(s, strand="-") for s in self.segments[i:j]
            ]
        else:
            flipped = [s.flipped() for s in self.segments[i:j]]
        self.segments[i:j] = flipped[::-1]
        return self

    def insert(self, start: int, length: int, strand: str = "+",
               name: Optional[str] = None) -> "StructuralChange":
        """Insert a novel sequence of `length` bp at `start`. The inserted
        segment gets a synthetic chromosome name so downstream retrieval can
        recognize it."""
        self._split(start)
        pts = self.coord_points
        i = bisect(pts, start) - 1
        name = name or f"ins{start}_{length}"
        self.segments.insert(i, Segment(name, 0, length, strand))
        return self

    def __add__(self, other: "StructuralChange") -> "StructuralChange":
        out = StructuralChange(self.chrom, 0,
                               ref_invert_quirk=self.ref_invert_quirk)
        out.segments = [dataclasses.replace(s) for s in self.segments] + [
            dataclasses.replace(s) for s in other.segments
        ]
        return out

    # -- queries ----------------------------------------------------------

    def query(self, start: int, end: int) -> List[Segment]:
        """Reference segments composing current-interval [start, end)."""
        if not 0 <= start < end <= self.length:
            raise ValueError(
                f"query [{start}, {end}) outside chromosome [0, {self.length})"
            )
        pts = self.coord_points
        i = bisect(pts, start) - 1
        j = bisect(pts, end - 1)
        segs = [dataclasses.replace(s) for s in self.segments[i:j]]
        head_off = start - pts[i]
        if head_off:
            s = segs[0]
            segs[0] = (
                dataclasses.replace(s, start=s.start + head_off)
                if s.strand == "+"
                else dataclasses.replace(s, end=s.end - head_off)
            )
        tail_off = pts[j] - end
        if tail_off:
            s = segs[-1]
            segs[-1] = (
                dataclasses.replace(s, end=s.end - tail_off)
                if s.strand == "+"
                else dataclasses.replace(s, start=s.start + tail_off)
            )
        return segs

    def __getitem__(self, key) -> List[Segment]:
        if isinstance(key, slice):
            return self.query(key.start, key.stop)
        raise TypeError("use slice indexing: sc[start:end]")

    def query_ref(self, chrom: str, start: int, end: int):
        """Map a reference interval into current coordinates.

        Returns (ref_intervals, current_intervals) where each current
        interval is [cur_start, cur_end, strand] (reference
        orca_utils.py:928-961).
        """
        pts = self.coord_points
        ref_coords, cur_coords = [], []
        for i, seg in enumerate(self.segments):
            if seg.chrom != chrom:
                continue
            lo = max(start, seg.start)
            hi = min(end, seg.end)
            if lo >= hi:
                continue
            ref_coords.append([lo, hi])
            if seg.strand == "+":
                cur_coords.append(
                    [pts[i] + lo - seg.start, pts[i] + hi - seg.start, "+"]
                )
            else:
                cur_coords.append(
                    [pts[i + 1] - (lo - seg.start), pts[i + 1] - (hi - seg.start),
                     "-"]
                )
        return ref_coords, cur_coords
