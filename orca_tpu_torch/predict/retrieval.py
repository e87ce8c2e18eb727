"""Multi-segment sequence / target / background retrieval.

The framework equivalent of the reference `_retrieve_multi`
(orca_predict.py:881-980): assemble a 256Mb (or any) input from a list of
oriented regions, the matching mosaic of observed contact matrices, and the
per-region background normmats built from each model's 1D cis expectation
(distance lookup) and scalar trans expectation. Host-side numpy, as in the
JAX package (orca_tpu/predict/retrieval.py): the same values and dtypes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from orca_tpu_torch.data.genome import CodeGenome, sequence_to_encoding
from orca_tpu_torch.predict.structural import Segment


def _region_tuple(region) -> tuple:
    if isinstance(region, Segment):
        return (region.chrom, region.start, region.end, region.strand)
    if len(region) == 3:
        return (*region, "+")
    return tuple(region)


def encode_regions(regionlist: Sequence, genome: CodeGenome,
                   ins_sequences: Optional[dict] = None) -> np.ndarray:
    """Concatenate one-hot encodings of oriented regions -> (1, L, 4).

    Segments whose chrom starts with 'ins' are looked up in `ins_sequences`
    (name -> DNA string), supporting insertion variants
    (orca_predict.py:2363-2369).
    """
    parts = []
    for region in regionlist:
        chrom, start, end, strand = _region_tuple(region)
        if chrom.startswith("ins") and ins_sequences and chrom in ins_sequences:
            enc = sequence_to_encoding(ins_sequences[chrom][start:end])
            if strand == "-":
                enc = enc[::-1, ::-1]
        else:
            enc = genome.get_encoding_from_coords(chrom, start, end, strand)
        parts.append(enc)
    return np.concatenate(parts, axis=0)[None]


def assemble_normmat(regionlist: Sequence, background_cis: np.ndarray,
                     background_trans: float, binsize: int = 32000) -> np.ndarray:
    """Blockwise background matrix over the region mosaic
    (orca_predict.py:945-973): cis blocks are distance lookups into the 1D
    expectation, trans blocks are the scalar trans expectation; strand flips
    mirror the corresponding rows/columns."""
    regions = [_region_tuple(r) for r in regionlist]
    rows = []
    for chrom, start, end, strand in regions:
        row = []
        n1 = int((end - start) / binsize)
        for chrom2, start2, end2, strand2 in regions:
            n2 = int((end2 - start2) / binsize)
            if chrom2 != chrom:
                block = np.full((n1, n2), background_trans)
            else:
                acoor = start + binsize * np.arange(n1)
                bcoor = start2 + binsize * np.arange(n2)
                dist = (
                    np.abs(acoor[:, None] - bcoor[None, :]) / binsize
                ).astype(int)
                block = background_cis[dist]
                if strand == "-":
                    block = block[::-1, :]
                if strand2 == "-":
                    block = block[:, ::-1]
            row.append(block)
        rows.append(np.hstack(row))
    return np.vstack(rows)


def assemble_targets(regionlist: Sequence, target_obj) -> np.ndarray:
    """Mosaic of observed matrices across all region pairs
    (orca_predict.py:903-931). `target_obj` implements
    get_feature_data(chrom, start, end, chrom2=..., start2=..., end2=...)."""
    regions = [_region_tuple(r) for r in regionlist]
    rows = []
    for chrom, start, end, strand in regions:
        row = []
        for chrom2, start2, end2, strand2 in regions:
            t = target_obj.get_feature_data(
                chrom, start, end, chrom2=chrom2, start2=start2, end2=end2
            )
            if strand == "-":
                t = t[::-1, :]
            if strand2 == "-":
                t = t[:, ::-1]
            row.append(t)
        rows.append(np.hstack(row))
    return np.vstack(rows)


def retrieve_multi(
    regionlist: Sequence,
    genome: CodeGenome,
    models_256m: Sequence = (),
    targets: Optional[Sequence] = None,
    normmat: bool = True,
    normmat_regionlist: Optional[Sequence] = None,
    ins_sequences: Optional[dict] = None,
):
    """Returns (sequence, normmats?, targets?) like the reference
    `_retrieve_multi` (orca_predict.py:881)."""
    sequence = encode_regions(regionlist, genome, ins_sequences)
    out = (sequence,)
    if normmat:
        nm_regions = normmat_regionlist if normmat_regionlist is not None else regionlist
        normmats = [
            assemble_normmat(nm_regions, m.background_cis, m.background_trans)
            for m in models_256m
        ]
        out = out + (normmats,)
    if targets:
        tgt = [assemble_targets(regionlist, t)[None] for t in targets]
        out = out + (tgt,)
    return out
