"""Random genomic-window sampler for training (a copy of
orca_tpu/data/sampler.py: numpy only, it never touches torch or the card).

Capability parity with the reference RandomPositionsSamplerHiC
(selene_utils2.py:761-1304): length-weighted random chromosome/position
sampling with chromosome-level train/validate/test holdouts, position
rounding, random shift, random strand (reverse complement),
cross-chromosome multi-segment assembly (fills a 256Mb window from several
chromosomes), max segment length, probabilistic length schedule, segment
permutation, mosaic 2D target assembly across all segment pairs, optional
1D targets, and per-sample background normmats built from the cis/trans
expectations.

Differences from the reference (deliberate):
  * an explicit np.random.Generator per sampler (seeded), instead of global
    np.random state + a 200k-draw cache (selene_utils2.py:1082-1091);
  * returns float32 channels-last arrays ((B, L, 4) sequence, (B, bins, F)
    1D targets) ready for device upload.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SegmentCoord:
    chrom: str
    start: int
    end: int
    strand: str


class RandomWindowSampler:
    """Samples (sequence, target[, normmat][, target_1d]) training examples."""

    MODES = ("train", "validate", "test")

    def __init__(
        self,
        genome,
        target,
        target_1d=None,
        background_cis: Optional[np.ndarray] = None,
        background_trans: Optional[float] = None,
        seed: int = 436,
        validation_holdout: Sequence[str] = ("chr6", "chr7"),
        test_holdout: Sequence[str] = ("chr8", "chr9"),
        sequence_length: int = 1_000_000,
        max_seg_length: Optional[int] = None,
        length_schedule=None,
        position_resolution: int = 1,
        random_shift: int = 0,
        random_strand: bool = True,
        cross_chromosome: bool = True,
        permute_segments: bool = False,
        mode: str = "train",
        packed_sequence: bool = False,
    ):
        self.genome = genome
        self.target = target
        self.target_1d = target_1d
        if background_cis is not None and background_trans is not None:
            # tail-pad like the reference so distance lookups past the
            # expectation table produce NaN (orca_models.py:640)
            self.background_cis = np.hstack(
                [np.asarray(background_cis, np.float64), np.full(2000, np.nan)]
            )
            self.background_trans = float(background_trans)
            self.bg = True
        else:
            self.bg = False
        self.sequence_length = sequence_length
        self.max_seg_length = max_seg_length
        self.length_schedule = length_schedule
        self.position_resolution = position_resolution
        self.random_shift = random_shift
        self.random_strand = random_strand
        self.cross_chromosome = cross_chromosome
        self.permute_segments = permute_segments
        self.mode = mode
        # packed quarter-scale uint8 sequences: a 32Mb stage-b window ships
        # 32MB through the worker queue instead of 512MB (float32); the
        # training steps expand on device via nn.encoders.to_compute_dtype
        self.packed_sequence = packed_sequence
        self.rng = np.random.default_rng(seed)

        chr_lens = genome.get_chr_lens()
        holdsets = {
            "validate": set(validation_holdout),
            "test": set(test_holdout or ()),
        }
        self._pools = {m: ([], []) for m in self.MODES}
        for chrom, length in chr_lens:
            if chrom in holdsets["validate"]:
                m = "validate"
            elif chrom in holdsets["test"]:
                m = "test"
            else:
                m = "train"
            self._pools[m][0].append((chrom, length))
            self._pools[m][1].append(length)
        for m in self.MODES:
            lens = np.array(self._pools[m][1], dtype=np.float64)
            probs = lens / lens.sum() if lens.sum() else lens
            self._pools[m] = (self._pools[m][0], probs)

    # -- coordinate sampling ---------------------------------------------

    def _sample_coords(self, mode: str) -> List[SegmentCoord]:
        chroms, probs = self._pools[mode]
        segments: List[SegmentCoord] = []
        current = 0
        chrom, clen = None, None
        while current < self.sequence_length:
            if chrom is None or self.cross_chromosome:
                idx = self.rng.choice(len(chroms), p=probs)
                chrom, clen = chroms[idx]
            next_length = self.sequence_length - current
            if self.length_schedule is not None and self.cross_chromosome:
                p, (lo, hi) = self.length_schedule
                if self.rng.random() < p:
                    next_length = min(next_length, int(self.rng.integers(lo, hi)))
            if self.max_seg_length is not None and self.cross_chromosome:
                next_length = min(next_length, self.max_seg_length)

            start = int(self.rng.integers(0, max(1, clen - next_length)))
            start -= start % self.position_resolution
            if start + next_length > clen:
                if (self.cross_chromosome or self.length_schedule is not None
                        or self.max_seg_length is not None):
                    end = clen
                else:
                    continue
            else:
                end = start + next_length
            end -= end % self.position_resolution
            if end <= start:
                continue
            strand = (
                "+-"[int(self.rng.integers(0, 2))] if self.random_strand else "+"
            )
            segments.append(SegmentCoord(chrom, start, end, strand))
            current += end - start
        if self.permute_segments:
            perm = self.rng.permutation(len(segments))
            segments = [segments[i] for i in perm]
        return segments

    # -- retrieval --------------------------------------------------------

    def _retrieve(self, segments: List[SegmentCoord]):
        L = self.sequence_length
        seq_dtype = np.uint8 if self.packed_sequence else np.float32
        seq = np.zeros((L, 4), dtype=seq_dtype)
        offset = 0
        for s in segments:
            r = (
                int(self.rng.integers(-self.random_shift, self.random_shift))
                if self.random_shift > 0
                else 0
            )
            if self.packed_sequence:
                enc = self.genome.get_packed_encoding_from_coords(
                    s.chrom, s.start + r, s.end + r, s.strand
                )
            else:
                enc = self.genome.get_encoding_from_coords(
                    s.chrom, s.start + r, s.end + r, s.strand
                )
            seq[offset : offset + len(enc)] = enc
            offset += len(enc)

        tshape = self.target.shape
        target = np.zeros(tshape, dtype=np.float32)
        normmat = np.zeros(tshape, dtype=np.float32) if self.bg else None
        ox = 0
        for a in segments:
            oy = 0
            nx = 0
            for b in segments:
                t = self.target.get_feature_data(
                    a.chrom, a.start, a.end,
                    chrom2=b.chrom, start2=b.start, end2=b.end,
                )
                if self.bg:
                    if a.chrom != b.chrom:
                        bg = np.full_like(t, self.background_trans)
                    else:
                        binsize = (a.end - a.start) / t.shape[-2]
                        acoor = a.start + binsize * np.arange(t.shape[-2])
                        bcoor = b.start + binsize * np.arange(t.shape[-1])
                        bg = self.background_cis[
                            (np.abs(acoor[:, None] - bcoor[None, :]) / binsize)
                            .astype(int)
                        ]
                if a.strand == "-":
                    t = np.flip(t, -2)
                    if self.bg:
                        bg = np.flip(bg, -2)
                if b.strand == "-":
                    t = np.flip(t, -1)
                    if self.bg:
                        bg = np.flip(bg, -1)
                nx, ny = t.shape[-2], t.shape[-1]
                # ellipsis: multi-head targets carry a leading dataset axis
                # (StackedContactMatrix, orca_leukemia-style training)
                target[..., ox : ox + nx, oy : oy + ny] = t
                if self.bg:
                    normmat[..., ox : ox + nx, oy : oy + ny] = bg
                oy += ny
            ox += nx

        target_1d = None
        if self.target_1d is not None:
            nb = self.target_1d.shape[1]
            target_1d = np.zeros((nb, self.target_1d.n_features), np.float32)
            off = 0
            for s in segments:
                t1 = self.target_1d.get_feature_data(s.chrom, s.start, s.end)
                if s.strand == "-":
                    t1 = t1[:, ::-1]
                target_1d[off : off + t1.shape[1]] = t1.T
                off += t1.shape[1]
        return seq, target, normmat, target_1d

    def sample(self, batch_size: int = 1, mode: Optional[str] = None,
               coordinate_only: bool = False):
        """Draw a minibatch. Returns (sequences, targets[, normmats]
        [, target_1ds]) stacked along the batch axis, or segment coordinate
        lists if coordinate_only."""
        mode = mode or self.mode
        allcoords = [self._sample_coords(mode) for _ in range(batch_size)]
        if coordinate_only:
            return allcoords
        seqs, targets, normmats, t1ds = [], [], [], []
        for coords in allcoords:
            seq, target, normmat, t1d = self._retrieve(coords)
            seqs.append(seq)
            targets.append(target)
            if self.bg:
                normmats.append(normmat)
            if t1d is not None:
                t1ds.append(t1d)
        out = (np.stack(seqs), np.stack(targets))
        if self.bg:
            out = out + (np.stack(normmats),)
        if t1ds:
            out = out + (np.stack(t1ds),)
        return out

    def __iter__(self):
        while True:
            yield self.sample(1)
