"""Visualization: multiscale contact-map grids to PDF (counterpart of
orca_tpu/viz.py, the same code over the port's config and colormaps).

Prediction (and observation) heatmap grids across zoom levels, window
annotations, unscaled mode (adds back the log background),
chromosome-boundary marks for padded 256 Mb runs, and gene/chromatin-track
panels drawn with matplotlib (bigWig tracks through pyBigWig when it is
installed).

All plotting is host-side matplotlib, imported only inside the functions, so
importing this module needs no matplotlib.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt


def contact_cmap():
    """Default contact-map palette: the reference's `hnh_cmap_ext5`
    (value-matched, see orca_tpu_torch.colormaps)."""
    from orca_tpu_torch.colormaps import hnh_cmap_ext5

    return hnh_cmap_ext5()


def _draw_anno(ax, annos, n: int):
    """Draw region (span) and site (line) annotations on a heatmap axis."""
    for r in annos or []:
        if len(r) == 3:
            start, end, color = r
            ax.plot(
                [start * n, end * n], [n * 0.99, n * 0.99],
                color=color, linewidth=3, solid_capstyle="butt",
            )
        else:
            pos, style = r
            ls = "-" if style == "single" else "--"
            ax.axvline(pos * n, color="black", linewidth=0.8, linestyle=ls)
            ax.axhline(pos * n, color="black", linewidth=0.8, linestyle=ls)


def _plot_grid(
    output: dict,
    n_levels: int,
    level_span_bp: int,
    file: Optional[str],
    model_labels: Optional[List[str]],
    show_coordinates: bool,
    unscaled: bool,
    cmap,
    vmin: float,
    vmax: float,
    maskpred: bool,
    colorbar: bool,
    boundary_key: Optional[str] = None,
):
    mpl, plt = _mpl()
    cmap = cmap or contact_cmap()
    preds = output["predictions"]
    exps = output.get("experiments")
    n_models = len(preds)
    model_labels = model_labels or [f"Model {i}" for i in range(n_models)]
    rows = []
    for i in range(n_models):
        rows.append(("pred", i))
        if exps:
            rows.append(("exp", i))

    fig, axes = plt.subplots(
        len(rows), n_levels,
        figsize=(3.2 * n_levels, 3.4 * len(rows)),
        squeeze=False,
    )
    for ri, (kind, mi) in enumerate(rows):
        for j in range(n_levels):
            ax = axes[ri][j]
            if kind == "pred":
                mat = np.array(preds[mi][j], dtype=float)
                label = f"{model_labels[mi]} pred"
            else:
                mat = np.array(exps[mi][j], dtype=float)
                label = f"{model_labels[mi]} obs"
            if unscaled:
                nm = output["normmats"][mi]
                nm_j = nm[j] if not isinstance(nm, dict) else list(nm.values())[j]
                mat = mat + np.log(np.asarray(nm_j, dtype=float))
                # reference scales unscaled panels to the first
                # off-diagonal's max (orca_utils.py:195-202)
                im = ax.imshow(mat, cmap=cmap,
                               vmax=np.max(np.diag(mat, k=1)),
                               interpolation="none")
            else:
                im = ax.imshow(mat, cmap=cmap, vmin=vmin, vmax=vmax,
                               interpolation="none")
            if kind == "pred" and maskpred and exps:
                # semi-transparent overlay of the observed-data NaN mask
                # (orca_utils.py:217-221)
                from orca_tpu_torch.colormaps import bwcmap

                ax.imshow(np.isnan(np.array(exps[mi][j], dtype=float)),
                          cmap=bwcmap(), interpolation="none")
            _draw_anno(ax, (output.get("annos") or [None] * n_levels)[j],
                       mat.shape[0])
            ax.set_xticks([])
            ax.set_yticks([])
            if ri == 0:
                span = level_span_bp // 2**j
                ax.set_title(f"{span / 1e6:.0f} Mb", fontsize=11)
            if j == 0:
                ax.set_ylabel(label, fontsize=10)
            if show_coordinates and ri == len(rows) - 1:
                start = output["start_coords"][j]
                end = output["end_coords"][j]
                ax.set_xlabel(
                    f"{output['chr']}:{start:,}-{end:,}", fontsize=7
                )
            if boundary_key and output.get(boundary_key):
                # chromosome boundary lines for padded 256Mb windows
                chr_end = output["end_coords"][j] - output["start_coords"][j]
                frac = chr_end / (level_span_bp / 2**j)
                if 0 < frac < 1:
                    n = mat.shape[0]
                    ax.axvline(frac * n, color="black", linewidth=0.6)
                    ax.axhline(frac * n, color="black", linewidth=0.6)
    if colorbar:
        fig.colorbar(im, ax=axes, fraction=0.012, pad=0.01)
    if file is not None:
        if str(file).endswith(".pdf"):
            # PdfPages output like the reference (orca_utils.py:528-538)
            from matplotlib.backends.backend_pdf import PdfPages

            with PdfPages(file) as pdf:
                pdf.savefig(fig, dpi=300, bbox_inches="tight")
        else:
            fig.savefig(file, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


def genomeplot(
    output: dict,
    show_genes: bool = False,
    show_tracks: bool = False,
    show_coordinates: bool = True,
    unscaled: bool = False,
    file: Optional[str] = None,
    cmap=None,
    unscaled_cmap=None,
    colorbar: bool = True,
    maskpred: bool = False,
    vmin: float = -1,
    vmax: float = 2,
    model_labels: Optional[List[str]] = None,
    genes_bed: Optional[str] = None,
    track_bigwigs: Optional[List[str]] = None,
):
    """32Mb multiscale plot (reference orca_utils.py:67-538). With
    show_genes/show_tracks and a `file`, gene/chromatin-track panels for
    each zoom window are written to `<stem>.anno.pdf` (resource paths
    default to the configured resource/extra dirs)."""
    fig = _plot_grid(
        output, n_levels=len(output["predictions"][0]), level_span_bp=32000000,
        file=file, model_labels=model_labels,
        show_coordinates=show_coordinates, unscaled=unscaled,
        cmap=(unscaled_cmap if unscaled else cmap), vmin=vmin, vmax=vmax,
        maskpred=maskpred, colorbar=colorbar,
    )
    if file is not None and (show_genes or show_tracks):
        plot_annotation_panels(output, file, show_genes, show_tracks,
                               genes_bed=genes_bed,
                               track_bigwigs=track_bigwigs)
    return fig


def genomeplot_256mb(
    output: dict,
    show_coordinates: bool = True,
    unscaled: bool = False,
    file: Optional[str] = None,
    cmap=None,
    unscaled_cmap=None,
    colorbar: bool = True,
    maskpred: bool = False,
    vmin: float = -1,
    vmax: float = 2,
    model_labels: Optional[List[str]] = None,
):
    """256Mb multiscale plot with padding-chromosome boundary marks
    (reference orca_utils.py:541-730)."""
    return _plot_grid(
        output, n_levels=len(output["predictions"][0]),
        level_span_bp=256000000, file=file, model_labels=model_labels,
        show_coordinates=show_coordinates, unscaled=unscaled,
        cmap=(unscaled_cmap if unscaled else cmap), vmin=vmin, vmax=vmax,
        maskpred=maskpred, colorbar=colorbar, boundary_key="padding_chr",
    )


def _default_panel_resources(genes_bed, track_bigwigs):
    """Resolve gene/track resource paths against the configured dirs
    (the reference hardcodes ORCA_PATH/resources + ORCA_PATH/extra,
    orca_utils.py:258-295); missing files disable the panel with a
    warning, like the reference's availability checks."""
    import glob
    import os
    import warnings

    from orca_tpu_torch.utils.config import get_config

    cfg = get_config()
    if genes_bed is None:
        genes_bed = os.path.join(
            cfg.resource_dir, "hg38.refGeneSelectMANE.bed.gz"
        )
    if genes_bed and not os.path.exists(genes_bed):
        warnings.warn(f"gene panel disabled: {genes_bed} not found")
        genes_bed = None
    if track_bigwigs is None:
        track_bigwigs = sorted(glob.glob(os.path.join(cfg.extra_dir,
                                                      "*.bigWig")))
    track_bigwigs = [p for p in track_bigwigs if os.path.exists(p)]
    return genes_bed, track_bigwigs


def _read_bed_intervals(path: str, chrom: str, start: int, end: int):
    """Minimal BED reader ((chrom, start, end, name) rows overlapping the
    window); handles .gz."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    rows = []
    with opener(path, "rt") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or parts[0] != chrom:
                continue
            s, e = int(parts[1]), int(parts[2])
            if e <= start or s >= end:
                continue
            name = parts[3] if len(parts) > 3 else ""
            rows.append((s, e, name))
    return rows


def plot_annotation_panels(output: dict, file: str, show_genes: bool,
                           show_tracks: bool,
                           genes_bed: Optional[str] = None,
                           track_bigwigs: Optional[List[str]] = None):
    """Gene / chromatin-track panels for each zoom window, written as a
    multi-page `<stem>.anno.pdf` (one page per level, like the reference's
    pygenometracks pages, orca_utils.py:295-538).

    Rendering is built-in matplotlib: genes from the BED(.gz) as stacked
    interval glyphs; bigWig signal tracks via pyBigWig when importable
    (warned and skipped otherwise — pyBigWig is the only optional native
    dependency here).
    """
    import os
    import warnings

    _, plt = _mpl()
    from matplotlib.backends.backend_pdf import PdfPages

    genes_bed, track_bigwigs = _default_panel_resources(
        genes_bed, track_bigwigs
    )
    if show_genes and genes_bed is None:
        show_genes = False
    bw_handles = []
    if show_tracks:
        if not track_bigwigs:
            warnings.warn("track panel disabled: no .bigWig files found")
            show_tracks = False
        else:
            try:
                import pyBigWig  # noqa: F401

                bw_handles = [(os.path.basename(p).rsplit(".", 1)[0],
                               pyBigWig.open(p)) for p in track_bigwigs]
            except ImportError:
                warnings.warn("pyBigWig not installed; skipping tracks")
                show_tracks = False
    if not (show_genes or show_tracks):
        return

    stem = file.rsplit(".", 1)[0] if "." in os.path.basename(file) else file
    anno_path = f"{stem}.anno.pdf"
    chrom = output["chr"]
    with PdfPages(anno_path) as pdf:
        for start, end in zip(output["start_coords"], output["end_coords"]):
            n_rows = (1 if show_genes else 0) + len(bw_handles)
            fig, axes = plt.subplots(
                n_rows, 1, figsize=(10, 1.2 * n_rows + 1.2), squeeze=False,
                sharex=True,
            )
            axes = axes[:, 0]
            ri = 0
            if show_genes:
                ax = axes[ri]
                ri += 1
                genes = _read_bed_intervals(genes_bed, chrom, start, end)
                for k, (gs, ge, name) in enumerate(genes):
                    lane = k % 6
                    ax.plot([max(gs, start), min(ge, end)], [lane, lane],
                            lw=3, color="#2166ac", solid_capstyle="butt")
                    if len(genes) <= 40 and name:
                        ax.text(max(gs, start), lane + 0.25, name,
                                fontsize=5, clip_on=True)
                ax.set_ylim(-0.7, 6)
                ax.set_yticks([])
                ax.set_ylabel("genes", fontsize=8)
            for label, bw in bw_handles:
                ax = axes[ri]
                ri += 1
                try:
                    nb = 1000
                    vals = bw.stats(chrom, int(start), int(end), nBins=nb)
                    vals = np.array(
                        [v if v is not None else 0.0 for v in vals]
                    )
                    xs = np.linspace(start, end, nb)
                    ax.fill_between(xs, 0, vals, color="#555555", lw=0)
                except RuntimeError:
                    pass
                ax.set_yticks([])
                ax.set_ylabel(label, fontsize=6)
            axes[-1].set_xlim(start, end)
            axes[-1].set_xlabel(f"{chrom}:{start:,}-{end:,}", fontsize=8)
            pdf.savefig(fig, bbox_inches="tight")
            plt.close(fig)
    for _, bw in bw_handles:
        bw.close()
