"""End-to-end variant prediction pipelines (counterpart of
orca_tpu/predict/pipelines.py).

The reference `process_*` functions (orca_predict.py:983-3165): region,
duplication, deletion, inversion, insertion, custom chimeric assemblies,
single-breakpoint translocations and sequence strings, each over the 1-32 Mb
models (window_radius=16Mb) or the 32-256 Mb models (window_radius=128Mb).

Models are passed explicitly as bundles (no module globals): `models` is a
list of ModelBundle (32 Mb path) or Model256MBundle (256 Mb path) whose
parameters live on `device` (None = CUDA), which every function passes on to
`genomepredict` / `genomepredict_256mb`. The JAX package's behaviour is kept
as it is, quirks included; each quirk is noted where it acts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from orca_tpu_torch.data.genome import CodeGenome
from orca_tpu_torch.predict import retrieval
from orca_tpu_torch.predict.multiscale import genomepredict, genomepredict_256mb
from orca_tpu_torch.predict.structural import StructuralChange
from orca_tpu_torch.utils.coords import coord_clip, coord_round

WR32 = 16000000
WR256 = 128000000


def process_anno(anno_scaled, base=0, window_radius=WR32):
    """Rescale annotations to window-relative 0..1 (orca_utils.py:968)."""
    out = []
    for r in anno_scaled:
        if len(r) == 3:
            out.append(
                [(r[0] - base) / (window_radius * 2),
                 (r[1] - base) / (window_radius * 2), r[2]]
            )
        elif len(r) == 2:
            out.append([(r[0] - base) / (window_radius * 2), r[1]])
        else:
            raise ValueError("annotation must have 2 or 3 entries")
    return out


def _chrlen(genome: CodeGenome, chrom: str) -> int:
    return genome.chr_len(chrom)


def _fetch_targets(targets, mchr, wpos, window_radius):
    if not targets:
        return None
    return [
        t.get_feature_data(
            mchr, coord_round(wpos - window_radius),
            coord_round(wpos + window_radius),
        )[None]
        for t in targets
    ]


def _predict_ref_window(genome, mchr, mpos_zoom, wpos, models, targets,
                        annotation, device=None):
    """Reference-allele 32Mb window prediction."""
    sequence = genome.get_encoding_from_coords(mchr, wpos - WR32, wpos + WR32)[None]
    tgt = _fetch_targets(targets, mchr, wpos, WR32)
    return genomepredict(
        sequence, mchr, mpos_zoom, wpos, models=models, targets=tgt,
        annotation=annotation, device=device,
    )


def _predict_alt_window(genome, sc, mchr, mpos_zoom, wpos, models, annotation,
                        ins_sequences=None, device=None):
    """Alternative-allele 32Mb window prediction from a StructuralChange."""
    segs = sc[wpos - WR32 : wpos + WR32]
    sequence = retrieval.encode_regions(segs, genome, ins_sequences)
    return genomepredict(
        sequence, mchr, mpos_zoom, wpos, models=models, annotation=annotation,
        device=device,
    )


def _whole_chrom_256m(genome, mchr, padding_chr, models, targets):
    """Whole-chromosome + padding-chromosome 256Mb retrieval."""
    chrlen = _chrlen(genome, mchr)
    chrlen_round = chrlen - chrlen % 32000
    regions = [
        [mchr, 0, chrlen_round, "+"],
        [padding_chr, 0, 256000000 - chrlen_round, "+"],
    ]
    if targets:
        sequence, normmats, tgts = retrieval.retrieve_multi(
            regions, genome, models_256m=models, targets=targets
        )
    else:
        sequence, normmats = retrieval.retrieve_multi(
            regions, genome, models_256m=models
        )
        tgts = None
    return sequence, normmats, tgts, chrlen_round


def _alt_256m(genome, sc, mchr, mpos_zoom, models, padding_chr,
              ins_sequences=None):
    """Alternative-allele 256Mb retrieval for a StructuralChange; returns
    (sequence, normmats, chrlen_alt_round, wpos)."""
    chrlen_alt = sc.length
    chrlen_alt_round = chrlen_alt - chrlen_alt % 32000
    if chrlen_alt_round < 256000000:
        wpos = WR256
        sequence, normmats = retrieval.retrieve_multi(
            list(sc[0:chrlen_alt_round])
            + [Segment4(padding_chr, 0, 256000000 - chrlen_alt_round)],
            genome,
            models_256m=models,
            normmat_regionlist=[
                [mchr, 0, chrlen_alt_round, "+"],
                [padding_chr, 0, 256000000 - chrlen_alt_round, "+"],
            ],
            ins_sequences=ins_sequences,
        )
    else:
        wpos = coord_clip(mpos_zoom, chrlen_alt_round, window_radius=WR256)
        sequence, normmats = retrieval.retrieve_multi(
            list(sc[wpos - WR256 : wpos + WR256]),
            genome,
            models_256m=models,
            normmat_regionlist=[[mchr, wpos - WR256, wpos + WR256, "+"]],
            ins_sequences=ins_sequences,
        )
    return sequence, normmats, chrlen_alt_round, wpos


def Segment4(chrom, start, end, strand="+"):
    return [chrom, start, end, strand]


def _maybe_plot(output, file, suffix, window_radius, model_labels,
                show_genes=True, show_tracks=False, show_coordinates=True):
    if file is None:
        return
    # matplotlib is needed only here, when a plot is asked for
    from orca_tpu_torch import viz

    if window_radius == WR256:
        viz.genomeplot_256mb(
            output, show_coordinates=show_coordinates,
            model_labels=model_labels, file=f"{file}{suffix}.256m.pdf",
        )
    else:
        viz.genomeplot(
            output, show_genes=show_genes, show_tracks=show_tracks,
            show_coordinates=show_coordinates, model_labels=model_labels,
            file=f"{file}{suffix}.pdf",
        )


def process_region(
    mchr: str,
    mstart: int,
    mend: int,
    genome: CodeGenome,
    models: Sequence,
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    padding_chr: str = "chr1",
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Multiscale prediction for a reference region (orca_predict.py:983)."""
    chrlen = _chrlen(genome, mchr)
    mpos = (int(mstart) + int(mend)) // 2

    if window_radius == WR32:
        # quirk kept from the JAX package: coord_clip's default 16 Mb radius,
        # whatever WR32 is
        wpos = coord_clip(mpos, chrlen)
    elif window_radius == WR256:
        wpos = WR256
    else:
        raise ValueError("window_radius must be 16000000 or 128000000")

    # quirk kept from the JAX package: mstart - mend is never positive, so
    # this is always true and the annotation always drawn
    if mstart - mend < 2 * window_radius:
        anno_scaled = process_anno(
            [[np.clip(mstart, wpos - window_radius, wpos + window_radius),
              np.clip(mend, wpos - window_radius, wpos + window_radius),
              "black"]],
            base=wpos - window_radius,
            window_radius=window_radius,
        )
    else:
        anno_scaled = None

    if window_radius == WR256:
        sequence, normmats, tgts, chrlen_round = _whole_chrom_256m(
            genome, mchr, padding_chr, models, targets
        )
        outputs_ref = genomepredict_256mb(
            sequence, mchr, normmats, chrlen_round, mpos, wpos, models=models,
            targets=tgts, annotation=anno_scaled, padding_chr=padding_chr,
            device=device,
        )
    else:
        outputs_ref = _predict_ref_window(
            genome, mchr, mpos, wpos, models, targets, anno_scaled, device
        )
    _maybe_plot(outputs_ref, file, "", window_radius, model_labels,
                show_genes, show_tracks)
    return outputs_ref


def process_dup(
    mchr: str,
    mstart: int,
    mend: int,
    genome: CodeGenome,
    models: Sequence,
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    padding_chr: str = "chr1",
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Duplication variant prediction (orca_predict.py:1172): ref windows at
    both boundaries plus the alternative allele with the tandem duplication."""
    chrlen = _chrlen(genome, mchr)
    outputs = []

    if window_radius == WR256:
        sequence, normmats, tgts, chrlen_round = _whole_chrom_256m(
            genome, mchr, padding_chr, models, targets
        )

    # ref.l / ref.r
    for mpos_zoom, clip_hi in ((mstart, True), (mend, False)):
        if window_radius == WR32:
            wpos = coord_clip(mpos_zoom, chrlen)
            lo = max(mstart, wpos - window_radius)
            hi = min(mend, wpos + window_radius)
            anno = process_anno(
                [[lo, hi, "black"]], base=wpos - window_radius,
                window_radius=window_radius,
            )
            outputs.append(
                _predict_ref_window(
                    genome, mchr, mpos_zoom, wpos, models, targets, anno,
                    device,
                )
            )
        else:
            wpos = WR256
            lo = max(mstart, wpos - window_radius)
            hi = min(mend, wpos + window_radius)
            anno = process_anno(
                [[lo, hi, "black"]], base=wpos - window_radius,
                window_radius=window_radius,
            )
            outputs.append(
                genomepredict_256mb(
                    sequence, mchr, normmats, chrlen_round, mpos_zoom, wpos,
                    models=models, targets=tgts, annotation=anno,
                    padding_chr=padding_chr, device=device,
                )
            )
        _maybe_plot(outputs[-1], file, ".ref.l" if clip_hi else ".ref.r",
                    window_radius, model_labels, show_genes, show_tracks)

    # alt: tandem duplication, zoom at the new junction (== mend)
    sc = StructuralChange(mchr, chrlen)
    sc.duplicate(mstart, mend)
    chrlen_alt = chrlen + mend - mstart
    duplen = mend - mstart
    if window_radius == WR32:
        wpos = coord_clip(mend, chrlen_alt)
        anno = process_anno(
            [
                [max(mstart, wpos - window_radius), mend, "black"],
                [mend, min(mend + duplen, wpos + window_radius), "gray"],
            ],
            base=wpos - window_radius,
            window_radius=window_radius,
        )
        outputs_alt = _predict_alt_window(
            genome, sc, mchr, mend, wpos, models, anno, device=device
        )
    else:
        seq_alt, normmats_alt, chrlen_alt_round, wpos = _alt_256m(
            genome, sc, mchr, mend, models, padding_chr
        )
        anno = process_anno(
            [
                [max(mstart, wpos - window_radius), mend, "black"],
                [mend, min(mend + duplen, wpos + window_radius), "gray"],
            ],
            base=wpos - window_radius,
            window_radius=window_radius,
        )
        outputs_alt = genomepredict_256mb(
            seq_alt, mchr, normmats_alt, chrlen_alt_round, mend, wpos,
            models=models, annotation=anno, padding_chr=padding_chr,
            device=device,
        )
    _maybe_plot(outputs_alt, file, ".alt", window_radius, model_labels,
                show_genes, show_tracks)
    return outputs[0], outputs[1], outputs_alt


def process_del(
    mchr: str,
    mstart: int,
    mend: int,
    genome: CodeGenome,
    models: Sequence,
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    padding_chr: str = "chr1",
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Deletion variant prediction (orca_predict.py:1510). On the 256 Mb
    branch the reference and the alternative one-hots (4.1 GB of float32
    each) are held at once, as in the JAX package."""
    chrlen = _chrlen(genome, mchr)
    outputs = []

    if window_radius == WR256:
        sequence, normmats, tgts, chrlen_round = _whole_chrom_256m(
            genome, mchr, padding_chr, models, targets
        )

    for mpos_zoom, tag in ((mstart, ".ref.l"), (mend, ".ref.r")):
        if window_radius == WR32:
            wpos = coord_clip(mpos_zoom, chrlen)
            anno = process_anno(
                [[max(mstart, wpos - window_radius),
                  min(mend, wpos + window_radius), "black"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            outputs.append(
                _predict_ref_window(
                    genome, mchr, mpos_zoom, wpos, models, targets, anno,
                    device,
                )
            )
        else:
            wpos = WR256
            anno = process_anno(
                [[max(mstart, wpos - window_radius),
                  min(mend, wpos + window_radius), "black"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            outputs.append(
                genomepredict_256mb(
                    sequence, mchr, normmats, chrlen_round, mpos_zoom, wpos,
                    models=models, targets=tgts, annotation=anno,
                    padding_chr=padding_chr, device=device,
                )
            )
        _maybe_plot(outputs[-1], file, tag, window_radius, model_labels,
                    show_genes, show_tracks)

    sc = StructuralChange(mchr, chrlen)
    sc.delete(mstart, mend)
    chrlen_alt = chrlen - (mend - mstart)
    if window_radius == WR32:
        wpos = coord_clip(mstart, chrlen_alt)
        anno = process_anno(
            [[mstart, "double"]], base=wpos - window_radius,
            window_radius=window_radius,
        )
        outputs_alt = _predict_alt_window(
            genome, sc, mchr, mstart, wpos, models, anno, device=device
        )
    else:
        seq_alt, normmats_alt, chrlen_alt_round, wpos = _alt_256m(
            genome, sc, mchr, mstart, models, padding_chr
        )
        anno = process_anno(
            [[mstart, "double"]], base=wpos - window_radius,
            window_radius=window_radius,
        )
        outputs_alt = genomepredict_256mb(
            seq_alt, mchr, normmats_alt, chrlen_alt_round, mstart, wpos,
            models=models, annotation=anno, padding_chr=padding_chr,
            device=device,
        )
    _maybe_plot(outputs_alt, file, ".alt", window_radius, model_labels,
                show_genes, show_tracks)
    return outputs[0], outputs[1], outputs_alt


def process_inv(
    mchr: str,
    mstart: int,
    mend: int,
    genome: CodeGenome,
    models: Sequence,
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    padding_chr: str = "chr1",
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Inversion variant prediction (orca_predict.py:1820): ref and alt
    windows at both inversion boundaries. Backgrounds are unchanged by
    inversion (orca_predict.py:2092)."""
    chrlen = _chrlen(genome, mchr)
    outputs = []

    if window_radius == WR256:
        sequence, normmats, tgts, chrlen_round = _whole_chrom_256m(
            genome, mchr, padding_chr, models, targets
        )
        chrlen_round_ref = chrlen_round

    for mpos_zoom, tag in ((mstart, ".ref.l"), (mend, ".ref.r")):
        if window_radius == WR32:
            wpos = coord_clip(mpos_zoom, chrlen)
            anno = process_anno(
                [[max(mstart, wpos - window_radius),
                  min(mend, wpos + window_radius), "black"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            outputs.append(
                _predict_ref_window(
                    genome, mchr, mpos_zoom, wpos, models, targets, anno,
                    device,
                )
            )
        else:
            wpos = WR256
            anno = process_anno(
                [[max(mstart, wpos - window_radius),
                  min(mend, wpos + window_radius), "black"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            outputs.append(
                genomepredict_256mb(
                    sequence, mchr, normmats, chrlen_round, mpos_zoom, wpos,
                    models=models, targets=tgts, annotation=anno,
                    padding_chr=padding_chr, device=device,
                )
            )
        _maybe_plot(outputs[-1], file, tag, window_radius, model_labels,
                    show_genes, show_tracks)

    sc = StructuralChange(mchr, chrlen)
    sc.invert(mstart, mend)
    for mpos_zoom, tag in ((mstart, ".alt.l"), (mend, ".alt.r")):
        if window_radius == WR32:
            wpos = coord_clip(mpos_zoom, chrlen)
            anno = process_anno(
                [[max(mstart, wpos - window_radius),
                  min(mend, wpos + window_radius), "gray"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            out_alt = _predict_alt_window(
                genome, sc, mchr, mpos_zoom, wpos, models, anno,
                device=device,
            )
        else:
            wpos = WR256
            chrlen_round = _chrlen(genome, mchr) - _chrlen(genome, mchr) % 32000
            seq_alt = retrieval.encode_regions(
                list(sc[0:chrlen_round])
                + [Segment4(padding_chr, 0, 256000000 - chrlen_round)],
                genome,
            )
            anno = process_anno(
                [[max(mstart, wpos - window_radius),
                  min(mend, wpos + window_radius), "gray"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            # as in the JAX package, the alt windows reuse the reference
            # backgrounds: an inversion leaves the region list's lengths
            # as they are
            out_alt = genomepredict_256mb(
                seq_alt, mchr, normmats, chrlen_round_ref, mpos_zoom, wpos,
                models=models, annotation=anno, padding_chr=padding_chr,
                device=device,
            )
        outputs.append(out_alt)
        _maybe_plot(out_alt, file, tag, window_radius, model_labels,
                    show_genes, show_tracks)
    return tuple(outputs)


def process_ins(
    mchr: str,
    mpos: int,
    ins_seq: str,
    genome: CodeGenome,
    models: Sequence,
    strand: str = "+",
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    padding_chr: str = "chr1",
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Insertion variant prediction (orca_predict.py:2178): reference window
    plus alternative windows zooming at both insertion junctions."""
    chrlen = _chrlen(genome, mchr)
    inslen = len(ins_seq)

    if window_radius == WR32:
        wpos = coord_clip(mpos, chrlen)
        anno = process_anno(
            [[mpos, "single"]], base=wpos - window_radius,
            window_radius=window_radius,
        )
        outputs_ref = _predict_ref_window(
            genome, mchr, mpos, wpos, models, targets, anno, device
        )
    else:
        sequence, normmats, tgts, chrlen_round = _whole_chrom_256m(
            genome, mchr, padding_chr, models, targets
        )
        wpos = WR256
        anno = process_anno(
            [[mpos, "single"]], base=wpos - window_radius,
            window_radius=window_radius,
        )
        outputs_ref = genomepredict_256mb(
            sequence, mchr, normmats, chrlen_round, mpos, wpos, models=models,
            targets=tgts, annotation=anno, padding_chr=padding_chr,
            device=device,
        )
    _maybe_plot(outputs_ref, file, ".ref", window_radius, model_labels,
                show_genes, show_tracks)

    sc = StructuralChange(mchr, chrlen)
    sc.insert(mpos, inslen, strand=strand, name="ins")
    ins_sequences = {"ins": ins_seq}
    chrlen_alt = chrlen + inslen

    alt_outputs = []
    for mpos_zoom, tag in ((mpos, ".alt.l"), (mpos + inslen, ".alt.r")):
        if window_radius == WR32:
            wpos = coord_clip(mpos_zoom, chrlen_alt)
            anno = process_anno(
                [[max(mpos, wpos - window_radius),
                  min(mpos + inslen, wpos + window_radius), "gray"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            out = _predict_alt_window(
                genome, sc, mchr, mpos_zoom, wpos, models, anno,
                ins_sequences=ins_sequences, device=device,
            )
        else:
            seq_alt, normmats_alt, chrlen_alt_round, wpos = _alt_256m(
                genome, sc, mchr, mpos_zoom, models, padding_chr,
                ins_sequences=ins_sequences,
            )
            anno = process_anno(
                [[max(mpos, wpos - window_radius),
                  min(mpos + inslen, wpos + window_radius), "gray"]],
                base=wpos - window_radius, window_radius=window_radius,
            )
            out = genomepredict_256mb(
                seq_alt, mchr, normmats_alt, chrlen_alt_round, mpos_zoom,
                wpos, models=models, annotation=anno, padding_chr=padding_chr,
                device=device,
            )
        alt_outputs.append(out)
        _maybe_plot(out, file, tag, window_radius, model_labels,
                    show_genes, show_tracks)
    return outputs_ref, alt_outputs[0], alt_outputs[1]


def process_custom(
    region_list: Sequence,
    ref_region_list: Sequence,
    mpos: int,
    genome: CodeGenome,
    models: Sequence,
    ref_mpos_list: Optional[Sequence[int]] = None,
    anno_list=None,
    ref_anno_list=None,
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Arbitrary multi-segment chimeric variant (orca_predict.py:2500).

    region_list segments must sum to the window size; each ref region is
    predicted in its native context, then the concatenated alternative."""

    def validate(regions, enforce_strand=None):
        sumlen = 0
        for chrom, start, end, strand in (retrieval._region_tuple(r) for r in regions):
            chrlen = _chrlen(genome, chrom)
            if not (0 <= start and end <= chrlen):
                raise ValueError(f"region out of bounds: {chrom}:{start}-{end}")
            if enforce_strand and strand != enforce_strand:
                raise ValueError(f"strand must be {enforce_strand}")
            sumlen += end - start
        if sumlen != 2 * window_radius:
            raise ValueError(
                f"regions sum to {sumlen}, expected {2 * window_radius}"
            )

    validate(region_list)
    outputs_ref = None
    for i, ref_region in enumerate(ref_region_list):
        validate([ref_region], enforce_strand="+")
        chrom, start, end, _ = retrieval._region_tuple(ref_region)
        ref_sequence = genome.get_encoding_from_coords(chrom, start, end)[None]
        tgt = (
            [
                t.get_feature_data(chrom, coord_round(start), coord_round(end))[None]
                for t in targets
            ]
            if targets
            else None
        )
        anno = (
            process_anno(ref_anno_list, base=0, window_radius=window_radius)
            if ref_anno_list
            else None
        )
        outputs_ref = genomepredict(
            ref_sequence,
            chrom,
            start + window_radius if ref_mpos_list is None else ref_mpos_list[i],
            start + window_radius,
            models=models,
            targets=tgt,
            annotation=anno,
            device=device,
        )
        _maybe_plot(outputs_ref, file, f".ref.{i}", window_radius,
                    model_labels, show_genes, show_tracks)

    alt_sequence = retrieval.encode_regions(region_list, genome)
    anno = (
        process_anno(anno_list, base=0, window_radius=window_radius)
        if anno_list
        else None
    )
    outputs_alt = genomepredict(
        alt_sequence, "chimeric", mpos, window_radius, models=models,
        annotation=anno, device=device,
    )
    _maybe_plot(outputs_alt, file, ".alt", window_radius, model_labels,
                show_genes, show_tracks, show_coordinates=False)
    return outputs_ref, outputs_alt


def process_single_breakpoint(
    chr1: str,
    pos1: int,
    chr2: str,
    pos2: int,
    orientation1: str,
    orientation2: str,
    genome: CodeGenome,
    models: Sequence,
    targets: Optional[Sequence] = None,
    file: Optional[str] = None,
    show_genes: bool = True,
    show_tracks: bool = False,
    window_radius: int = WR32,
    padding_chr: str = "chr1",
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Translocation / fusion-chromosome prediction (orca_predict.py:2684).

    Builds chr1-side and chr2-side derivatives per the breakpoint
    orientations ('+' keeps the left/upstream side of chr1; '-' for chr2
    keeps the downstream side), concatenates them, and predicts around the
    fusion junction; both reference loci are also predicted.
    """
    outputs_refs = []
    for chrom, pos, tag in ((chr1, pos1, ".ref.1"), (chr2, pos2, ".ref.2")):
        chrlen = _chrlen(genome, chrom)
        if window_radius == WR32:
            wpos = coord_clip(pos, chrlen)
            anno = process_anno(
                [[pos, "single"]], base=wpos - window_radius,
                window_radius=window_radius,
            )
            outputs_refs.append(
                _predict_ref_window(genome, chrom, pos, wpos, models, targets,
                                    anno, device)
            )
        else:
            sequence, normmats, tgts, chrlen_round = _whole_chrom_256m(
                genome, chrom, padding_chr, models, targets
            )
            wpos = WR256
            anno = process_anno(
                [[pos, "single"]], base=wpos - window_radius,
                window_radius=window_radius,
            )
            outputs_refs.append(
                genomepredict_256mb(
                    sequence, chrom, normmats, chrlen_round, pos, wpos,
                    models=models, targets=tgts, annotation=anno,
                    padding_chr=padding_chr, device=device,
                )
            )
        _maybe_plot(outputs_refs[-1], file, tag, window_radius, model_labels,
                    show_genes, show_tracks)

    # Fusion chromosome: left part from chr1, right part from chr2
    # (orca_predict.py:2950-2967).
    chrlen1 = _chrlen(genome, chr1)
    s = StructuralChange(chr1, chrlen1)
    if orientation1 == "+":
        s.delete(pos1, chrlen1)
    else:
        s.delete(0, pos1 - 1)
        s.invert(0, chrlen1 - pos1 + 1)

    chrlen2 = _chrlen(genome, chr2)
    s2 = StructuralChange(chr2, chrlen2)
    if orientation2 == "-":
        s2.delete(0, pos2 - 1)
    else:
        s2.delete(pos2, chrlen2)
        s2.invert(0, pos2)

    breakpos = s.length
    s = s + s2
    fused_name = f"{chr1}|{chr2}"

    if window_radius == WR32:
        total = s.length
        if total < 2 * window_radius + 128000:
            adjusted_radius = total // 2
            wpos = adjusted_radius
        else:
            adjusted_radius = window_radius
            wpos = coord_clip(breakpos, total, window_radius=adjusted_radius)
        segs = s[wpos - adjusted_radius : wpos + adjusted_radius]
        sequence = retrieval.encode_regions(segs, genome)
        junction = sum(
            seg.length for seg in segs[:1]
        )  # junction offset of first segment end
        # as in the JAX package: a fused chromosome shorter than the window
        # is padded with 0.25 at its end and the window centre shifted by
        # half the padding
        if sequence.shape[1] != 2 * window_radius:
            pad_len = 2 * window_radius - sequence.shape[1]
            sequence = np.concatenate(
                [sequence, np.full((1, pad_len, 4), 0.25, np.float32)], axis=1
            )
            wpos = wpos + pad_len // 2
        anno = process_anno(
            [[junction, "double"]], base=0, window_radius=window_radius
        )
        outputs_alt = genomepredict(
            sequence, fused_name, breakpos, wpos, models=models,
            annotation=anno, device=device,
        )
    else:
        seq_alt, normmats_alt, chrlen_alt_round, wpos = _alt_256m(
            genome, s, fused_name, breakpos, models, padding_chr
        )
        segs = (
            s[0:chrlen_alt_round]
            if chrlen_alt_round < 256000000
            else s[wpos - WR256 : wpos + WR256]
        )
        junction = segs[0].length if segs else 0
        anno = process_anno(
            [[junction, "double"]], base=0, window_radius=window_radius
        )
        outputs_alt = genomepredict_256mb(
            seq_alt, fused_name, normmats_alt, chrlen_alt_round, breakpos,
            wpos, models=models, annotation=anno, padding_chr=padding_chr,
            device=device,
        )
    _maybe_plot(outputs_alt, file, ".alt", window_radius, model_labels,
                show_genes, show_tracks, show_coordinates=False)
    return outputs_refs[0], outputs_refs[1], outputs_alt


def process_seqstr(
    seqstr_input: str,
    mpos: int,
    genome: CodeGenome,
    models: Sequence,
    file: Optional[str] = None,
    window_radius: int = WR32,
    model_labels: Optional[List[str]] = None,
    *,
    device=None,
):
    """Prediction from a Seqstr sequence string (orca_predict.py:3060).

    The optional `seqstr` dependency parses the string; if unavailable a
    plain DNA string is accepted directly. The middle 32Mb is predicted.
    """
    try:
        from seqstr import seqstr as _seqstr  # type: ignore

        parsed = _seqstr(seqstr_input)
        seq = parsed[0].Seq if hasattr(parsed[0], "Seq") else parsed[0]
    except ImportError:
        seq = seqstr_input
    from orca_tpu_torch.data.genome import sequence_to_encoding

    encoding = sequence_to_encoding(seq)
    L = encoding.shape[0]
    if L < 2 * window_radius:
        pad = 2 * window_radius - L
        lpad = pad // 2
        encoding = np.concatenate(
            [
                np.full((lpad, 4), 0.25, np.float32),
                encoding,
                np.full((pad - lpad, 4), 0.25, np.float32),
            ]
        )
        mpos = mpos + lpad
    elif L > 2 * window_radius:
        off = (L - 2 * window_radius) // 2
        encoding = encoding[off : off + 2 * window_radius]
        mpos = mpos - off
    outputs = genomepredict(
        encoding[None], "seqstr", mpos, window_radius, models=models,
        device=device,
    )
    _maybe_plot(outputs, file, "", window_radius, model_labels,
                show_coordinates=False)
    return outputs
