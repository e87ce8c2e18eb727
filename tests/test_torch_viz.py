"""The port's plots (orca_tpu_torch/viz.py, colormaps.py) against the JAX
package's: colormap LUTs equal (atol 0); the contact-map grids of
tests/test_viz.py's fake output rendered to the same RGBA pixels (scaled,
unscaled and with the NaN-mask overlay, 32 Mb and 256 Mb); the PDF and
`.anno.pdf` files written, the panel warnings raised, and the pipelines'
plot files named as in the JAX package."""

import os

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from orca_tpu import colormaps as jcmaps  # noqa: E402
from orca_tpu import viz as jviz  # noqa: E402
from orca_tpu.predict import pipelines as jpipe  # noqa: E402
from orca_tpu_torch import colormaps as tcmaps  # noqa: E402
from orca_tpu_torch import viz as tviz  # noqa: E402
from orca_tpu_torch.data.genome import CodeGenome  # noqa: E402
from orca_tpu_torch.predict import pipelines as tpipe  # noqa: E402
from test_viz import _fake_output  # noqa: E402


def test_colormap_luts_equal():
    x = np.linspace(0, 1, 1025)
    np.testing.assert_array_equal(tcmaps.hnh_cmap_ext5()(x),
                                  jcmaps.hnh_cmap_ext5()(x))
    np.testing.assert_array_equal(tcmaps.bwcmap()._lut, jcmaps.bwcmap()._lut)
    assert tcmaps.hnh_cmap_ext5().N == jcmaps.hnh_cmap_ext5().N
    np.testing.assert_array_equal(tcmaps.hnh_cmap_ext5()(np.nan),
                                  jcmaps.hnh_cmap_ext5()(np.nan))


def _output(kind):
    out = _fake_output()
    out["annos"] = [[(0.1, 0.4, "black"), (0.5, "single"), (0.7, "double")]
                    for _ in range(3)]
    if kind == "256mb":
        out["padding_chr"] = "chr2"
        out["normmats"] = [dict(zip((256, 128, 64), out["normmats"][0]))]
    return out


def _pixels(fig):
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return buf


@pytest.mark.parametrize("kind", ["32mb", "256mb"])
@pytest.mark.parametrize("mode", ["scaled", "unscaled", "maskpred"])
def test_rendered_pixels_equal(kind, mode):
    kw = {"unscaled": mode == "unscaled", "maskpred": mode == "maskpred",
          "model_labels": ["H1-ESC"]}
    figs = []
    for viz in (jviz, tviz):
        plot = viz.genomeplot if kind == "32mb" else viz.genomeplot_256mb
        fig = plot(_output(kind), file=None, **kw)
        assert fig is not None
        figs.append(_pixels(fig))
    want, got = figs
    assert got.shape == want.shape and got.dtype == np.uint8
    assert len(np.unique(want.reshape(-1, 4), axis=0)) > 10  # not blank
    np.testing.assert_array_equal(got, want)


def test_pdf_and_anno_pdf_written(tmp_path):
    import gzip

    bed = tmp_path / "genes.bed.gz"
    with gzip.open(bed, "wt") as f:
        f.write("chr1\t1050000\t1200000\tGENE_A\n")
        f.write("chr2\t1000000\t1100000\tOTHER\n")
    pdf = str(tmp_path / "plot.pdf")
    assert tviz.genomeplot(_output("32mb"), file=pdf, maskpred=True,
                           show_genes=True, genes_bed=str(bed)) is None
    for path in (pdf, str(tmp_path / "plot.anno.pdf")):
        assert os.path.getsize(path) > 0
    with open(pdf, "rb") as f:
        assert f.read(5) == b"%PDF-"
    png = str(tmp_path / "plot256.png")
    tviz.genomeplot_256mb(_output("256mb"), file=png, unscaled=True)
    assert os.path.getsize(png) > 0


def test_panel_warnings(tmp_path):
    out = _output("32mb")
    pdf = str(tmp_path / "plot.pdf")
    with pytest.warns(UserWarning, match="gene panel disabled"):
        tviz.genomeplot(out, file=pdf, show_genes=True,
                        genes_bed=str(tmp_path / "nope.bed.gz"))
    with pytest.warns(UserWarning, match="no .bigWig files"):
        tviz.genomeplot(out, file=pdf, show_tracks=True, track_bigwigs=[],
                        genes_bed=str(tmp_path / "nope.bed.gz"))
    fake = tmp_path / "H3K27ac.bigWig"
    fake.write_bytes(b"")
    try:
        import pyBigWig  # noqa: F401
    except ImportError:
        with pytest.warns(UserWarning, match="pyBigWig not installed"):
            tviz.genomeplot(out, file=pdf, show_tracks=True,
                            track_bigwigs=[str(fake)],
                            genes_bed=str(tmp_path / "nope.bed.gz"))
    assert not os.path.exists(str(tmp_path / "plot.anno.pdf"))


def test_bed_reader_equal(tmp_path):
    bed = tmp_path / "genes.bed"
    bed.write_text("chr1\t10\t20\tA\nchr1\t30\t40\nchr2\t0\t5\tB\nbad\n"
                   "chr1\t50\t60\tC\n")
    for q in (("chr1", 0, 100), ("chr1", 15, 35), ("chr2", 5, 9)):
        assert (tviz._read_bed_intervals(str(bed), *q)
                == jviz._read_bed_intervals(str(bed), *q))


@pytest.mark.parametrize("branch", ["32mb", "256mb"])
def test_pipeline_plot_files(tmp_path, monkeypatch, branch):
    """With `file` given, a pipeline writes one PDF per output, named as the
    JAX package's pipeline names them."""
    genome = CodeGenome({"chrA": np.zeros(40_000_000, np.uint8)})
    names = []
    for pkg, pipe in (("jax", jpipe), ("port", tpipe)):
        stem = str(tmp_path / pkg / "dup")
        os.makedirs(os.path.dirname(stem))
        fake = _output(branch)
        monkeypatch.setattr(pipe, "genomepredict", lambda *a, **k: fake)
        monkeypatch.setattr(pipe, "genomepredict_256mb", lambda *a, **k: fake)
        monkeypatch.setattr(pipe.retrieval, "retrieve_multi",
                            lambda *a, **k: (None, None))
        monkeypatch.setattr(pipe.retrieval, "encode_regions",
                            lambda *a, **k: None)
        # a 256 kb 32 Mb-branch window, as in tests/test_torch_pipelines.py
        monkeypatch.setattr(pipe, "WR32", 256_000)
        kw = {"device": "cpu"} if pkg == "port" else {}
        radius = 256_000 if branch == "32mb" else 128_000_000
        pipe.process_dup("chrA", 20_000_000, 20_500_000, genome, ["m"],
                         file=stem, show_genes=False, window_radius=radius,
                         **kw)
        names.append(sorted(os.listdir(os.path.dirname(stem))))
        monkeypatch.undo()
    assert names[0] == names[1]
    suffix = ".pdf" if branch == "32mb" else ".256m.pdf"
    assert names[1] == [f"dup{t}{suffix}" for t in (".alt", ".ref.l", ".ref.r")]
