"""The port's host-side retrieval layer against the JAX package's: the genome
stores (orca_tpu_torch/data/genome.py), coordinate helpers
(utils/coords.py), the structural-variant algebra (predict/structural.py),
the contact-matrix readers (data/mcool.py, data/targets.py) and
`retrieve_multi` (predict/retrieval.py).

Everything is numpy on the host, so every output must be equal: base codes,
one-hot encodings (out-of-bounds padding and '-' strands included), segment
lists, and the sequence, backgrounds and targets of a region mosaic. The
genome is a synthetic FASTA with lowercase letters and N; the observed maps
come from a synthetic cooler written by the port's `write_cooler`.
"""

import types

import numpy as np
import pytest

from orca_tpu.data import genome as jgenome
from orca_tpu.data import targets as jtargets
from orca_tpu.predict import retrieval as jret
from orca_tpu.predict import structural as jstruct
from orca_tpu.utils import coords as jcoords
from orca_tpu_torch.data import genome as tgenome
from orca_tpu_torch.data import mcool as tmcool
from orca_tpu_torch.data import targets as ttargets
from orca_tpu_torch.predict import retrieval as tret
from orca_tpu_torch.predict import structural as tstruct
from orca_tpu_torch.utils import coords as tcoords

RES = 32_000
CHROMS = {"chrA": 30 * RES, "chrB": 20 * RES + 700}


def _fasta_text(rng):
    letters = np.array(list("ACGTacgtN"))
    lines = []
    for name, length in CHROMS.items():
        seq = "".join(letters[rng.randint(0, 9, length)])
        seq = "NNNN" + seq[4:]
        lines.append(f">{name} synthetic")
        lines += [seq[i : i + 60] for i in range(0, length, 60)]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """(JAX FastaGenome, port FastaGenome, JAX MemmapGenome, port
    MemmapGenome) over one synthetic FASTA."""
    d = tmp_path_factory.mktemp("genome")
    fasta = d / "toy.fa"
    fasta.write_text(_fasta_text(np.random.RandomState(0)))
    return (jgenome.FastaGenome(str(fasta)), tgenome.FastaGenome(str(fasta)),
            jgenome.MemmapGenome.build(str(fasta), str(d / "j.mmap")),
            tgenome.MemmapGenome.build(str(fasta), str(d / "t.mmap")))


QUERIES = [("chrA", 0, 5000), ("chrA", 123_457, 190_001),
           ("chrA", -3000, 4000), ("chrB", 640_000, 650_000),
           ("chrB", -100, -10), ("chrB", 0, CHROMS["chrB"])]


@pytest.mark.parametrize("query", QUERIES, ids=str)
@pytest.mark.parametrize("strand", ["+", "-"])
def test_genome_codes_and_encodings_equal(genomes, query, strand):
    jfa, tfa, jmm, tmm = genomes
    assert tfa.get_chr_lens() == jfa.get_chr_lens() == tmm.get_chr_lens()
    for j, t in ((jfa, tfa), (jmm, tmm)):
        np.testing.assert_array_equal(t.get_codes(*query), j.get_codes(*query))
        got = t.get_encoding_from_coords(*query, strand)
        want = j.get_encoding_from_coords(*query, strand)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            t.get_packed_encoding_from_coords(*query, strand),
            j.get_packed_encoding_from_coords(*query, strand))
        assert (t.get_sequence_from_coords(*query, strand)
                == j.get_sequence_from_coords(*query, strand))


def test_sequence_helpers_equal():
    s = "ACGTNacgtnRYK-"
    np.testing.assert_array_equal(tgenome.sequence_to_encoding(s),
                                  jgenome.sequence_to_encoding(s))
    enc = jgenome.sequence_to_encoding(s)
    np.testing.assert_array_equal(tgenome.encoding_to_codes(enc),
                                  jgenome.encoding_to_codes(enc))


def test_coords_equal():
    chrlen = 145_138_636
    for pos in list(range(0, chrlen, 1_234_567)) + [5, 127_999, chrlen - 5]:
        for radius in (16_000_000, 128_000_000 // 2):
            assert (tcoords.coord_clip(pos, chrlen, window_radius=radius)
                    == jcoords.coord_clip(pos, chrlen, window_radius=radius))
        assert tcoords.coord_round(pos) == jcoords.coord_round(pos)
        assert (tcoords.coord_round(pos, 32_000)
                == jcoords.coord_round(pos, 32_000))


def _segs(segments):
    return [(s.chrom, s.start, s.end, s.strand) for s in segments]


def _apply(module, quirk):
    sc = module.StructuralChange("chr1", 1_000_000, ref_invert_quirk=quirk)
    sc.duplicate(100_000, 200_000)
    sc.delete(500_000, 550_000)
    sc.invert(300_000, 700_000)
    sc.insert(250_000, 5000, name="ins_x")
    sc.invert(50_000, 350_000)
    sc.invert(320_000, 340_000)
    other = module.StructuralChange("chr2", 30_000).invert(10_000, 20_000)
    return sc + other


@pytest.mark.parametrize("quirk", [False, True])
def test_structural_change_equal(quirk):
    got, want = _apply(tstruct, quirk), _apply(jstruct, quirk)
    assert _segs(got.segments) == _segs(want.segments)
    assert got.coord_points == want.coord_points
    assert got.length == want.length
    assert _segs(got[40_000:400_000]) == _segs(want[40_000:400_000])
    assert got.query_ref("chr1", 150_000, 650_000) == want.query_ref(
        "chr1", 150_000, 650_000)


@pytest.fixture(scope="module")
def cooler_path(tmp_path_factory):
    """A cooler at 32 kb over both chromosomes, written by the port, with
    NaN balancing weights on a few bins."""
    rng = np.random.RandomState(1)
    nbins = sum(-(-n // RES) for n in CHROMS.values())
    i, j = np.triu_indices(nbins)
    keep = rng.rand(i.size) < 0.7
    counts = rng.randint(1, 50, keep.sum()).astype(np.int32)
    weights = rng.uniform(0.5, 1.5, nbins)
    weights[[3, 17, 33]] = np.nan
    path = str(tmp_path_factory.mktemp("mcool") / "toy.mcool")
    tmcool.write_cooler(path, CHROMS, RES, (i[keep], j[keep], counts),
                        weights=weights, group="/resolutions/32000")
    return path + "::/resolutions/32000"


def _mosaic(struct, kind):
    """The region list of a duplication, a deletion or an inversion on chrA,
    padded by chrB to 40 bins, in the given module's own Segment."""
    sc = struct.StructuralChange("chrA", CHROMS["chrA"])
    getattr(sc, {"dup": "duplicate", "del": "delete",
                 "inv": "invert"}[kind])(8 * RES, 14 * RES)
    return list(sc[0:sc.length]) + [
        struct.Segment("chrB", 0, 40 * RES - sc.length)]


@pytest.mark.parametrize("kind", ["dup", "del", "inv"])
def test_retrieve_multi_equal(genomes, cooler_path, kind):
    jfa, tfa, _, _ = genomes
    jregions, tregions = _mosaic(jstruct, kind), _mosaic(tstruct, kind)
    assert _segs(tregions) == _segs(jregions)
    d = np.arange(20, dtype=np.float64)
    model = types.SimpleNamespace(  # cis expectation NaN past 20 bins
        background_cis=np.hstack([np.exp(-1.2 * np.log1p(d) - 3.0),
                                  np.repeat(np.nan, 20)]),
        background_trans=float(np.exp(-9.0)))
    shape = (40, 40)
    want = jret.retrieve_multi(
        jregions, jfa, models_256m=[model],
        targets=[jtargets.CoolerContactMatrix(cooler_path, shape)])
    got = tret.retrieve_multi(
        tregions, tfa, models_256m=[model],
        targets=[ttargets.CoolerContactMatrix(cooler_path, shape)])
    assert len(got) == len(want) == 3
    (gseq, gnm, gtg), (wseq, wnm, wtg) = got, want
    assert gseq.shape == (1, 40 * RES, 4) and gseq.dtype == wseq.dtype
    np.testing.assert_array_equal(gseq, wseq)
    assert gnm[0].shape == shape and gnm[0].dtype == wnm[0].dtype
    assert np.isnan(gnm[0]).any()
    np.testing.assert_array_equal(gnm[0], wnm[0])
    assert gtg[0].shape == (1,) + shape and gtg[0].dtype == wtg[0].dtype
    assert np.isnan(gtg[0]).any() and np.isfinite(gtg[0]).any()
    np.testing.assert_array_equal(gtg[0], wtg[0])


def test_retrieve_multi_insertion_equal(genomes):
    """An inserted sequence by name, on both strands, with the backgrounds
    taken over a separate reference region list."""
    jfa, tfa, _, _ = genomes
    ins = {"ins_a": "ACGTNacgt" * 4000}
    model = types.SimpleNamespace(
        background_cis=np.exp(-np.arange(40.0)), background_trans=1e-4)
    nm_regions = [["chrA", 0, 20 * RES, "+"], ["chrB", 0, 4 * RES, "+"]]
    outs = []
    for struct, ret, genome in ((jstruct, jret, jfa), (tstruct, tret, tfa)):
        sc = struct.StructuralChange("chrA", 20 * RES)
        sc.insert(5 * RES, RES, name="ins_a")
        sc.insert(11 * RES, RES, strand="-", name="ins_a")
        sc.invert(10 * RES, 13 * RES)
        regions = list(sc[0:sc.length]) + [["chrB", 0, 2 * RES]]
        outs.append(ret.retrieve_multi(regions, genome, models_256m=[model],
                                       normmat_regionlist=nm_regions,
                                       ins_sequences=ins))
    (wseq, wnm), (gseq, gnm) = outs
    assert gseq.shape == (1, 24 * RES, 4)
    np.testing.assert_array_equal(gseq, wseq)
    np.testing.assert_array_equal(gnm[0], wnm[0])
