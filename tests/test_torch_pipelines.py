"""The port's variant pipelines (orca_tpu_torch/predict/pipelines.py) against
the JAX package's, on what they pass to the cascades and what they return.

In both packages `genomepredict` and `genomepredict_256mb` are replaced by
one recorder that returns a deterministic stand-in output, so no model runs.
The 32 Mb branch runs at a 256 kb window radius (`WR32` set to it in both
modules, `window_radius` passed explicitly) with the real retrieval; the
256 Mb branch keeps the production radius and replaces
`retrieval.retrieve_multi` and `retrieval.encode_regions` too, because a
256 Mb one-hot is 4.1 GB (retrieval itself is held to JAX's by
tests/test_torch_retrieval.py).

Every recorded call must agree: sequences, chromosome, zoom and window
positions, chromosome lengths, backgrounds, targets, padding chromosome,
region lists and inserted sequences equal; annotations to 1e-12. So must the
returned tuples. The genome is two ~40 Mb chromosomes of seeded random codes
in each package's own CodeGenome, the targets a DenseContactMatrix at 32 kb
in each package.
"""

import numbers

import numpy as np
import pytest

from orca_tpu.data import genome as jgenome
from orca_tpu.data import targets as jtargets
from orca_tpu.predict import pipelines as jpipe
from orca_tpu.predict import retrieval as jret
from orca_tpu_torch.data import genome as tgenome
from orca_tpu_torch.data import targets as ttargets
from orca_tpu_torch.predict import pipelines as tpipe
from orca_tpu_torch.predict import retrieval as tret

WR = 256_000  # the 32 Mb branch's window radius in these tests
WR256 = 128_000_000
RES = 32_000
CHROMS = {"chrA": 40_012_345, "chrB": 38_000_777}
LONG_BP = 300_000_000  # a chromosome longer than the 256 Mb window
MODELS = ["model0", "model1"]  # the recorders pass these through untouched
ANNO_TOL = 1e-12


@pytest.fixture(scope="module")
def inputs():
    """{'jax' | 'torch': (genome, long genome, targets)} over the same codes
    and contact matrices."""
    rng = np.random.default_rng(0)
    codes = {c: rng.integers(0, 5, n, dtype=np.uint8) for c, n in CHROMS.items()}
    mats = {}
    for c, n in CHROMS.items():
        nb = -(-n // RES)
        m = rng.random((nb, nb), dtype=np.float32)
        m = m + m.T
        m[rng.integers(0, nb, 20)] = np.nan
        mats[c] = m
    # np.zeros maps untouched pages: only the length of this one is read
    long_codes = {"chrL": np.zeros(LONG_BP, np.uint8), "chrB": codes["chrB"]}
    out = {}
    for key, g, t in (("jax", jgenome, jtargets), ("torch", tgenome, ttargets)):
        out[key] = (g.CodeGenome(codes), g.CodeGenome(long_codes),
                    t.DenseContactMatrix(mats, RES))
    return out


def _region(r):
    if hasattr(r, "strand"):
        return (r.chrom, r.start, r.end, r.strand)
    return tuple(r) if len(r) == 4 else (*r, "+")


class Recorder:
    """Stands in for the cascades (and, on the 256 Mb branch, retrieval) of
    one package; records each call and returns outputs made only from what
    it was given."""

    def __init__(self, port):
        self.port = port
        self.calls = []

    def _record(self, name, **fields):
        self.calls.append((name, fields))
        return len(self.calls)

    def _check_device(self, device):
        # the port passes its device on; the JAX package has none
        assert device == ("cpu" if self.port else None), device

    def genomepredict(self, sequence, mchr, mpos=-1, wpos=-1, models=(),
                      targets=None, annotation=None, device=None, **kw):
        self._check_device(device)
        n = self._record("genomepredict", sequence=np.asarray(sequence),
                         mchr=mchr, mpos=mpos, wpos=wpos, models=list(models),
                         targets=targets, annotation=annotation, kw=kw)
        return {"call": n, "chr": mchr, "mpos": mpos, "wpos": wpos,
                "seq_sum": float(np.asarray(sequence, np.float64).sum()),
                "annos": annotation}

    def genomepredict_256mb(self, sequence, mchr, normmats, chrlen, mpos=-1,
                            wpos=-1, models=(), targets=None, annotation=None,
                            padding_chr=None, device=None, **kw):
        self._check_device(device)
        n = self._record("genomepredict_256mb",
                         sequence=np.asarray(sequence), mchr=mchr,
                         normmats=normmats, chrlen=chrlen, mpos=mpos,
                         wpos=wpos, models=list(models), targets=targets,
                         annotation=annotation, padding_chr=padding_chr, kw=kw)
        return {"call": n, "chr": mchr, "chrlen": chrlen, "mpos": mpos,
                "wpos": wpos, "padding_chr": padding_chr, "annos": annotation}

    def _stand_in_sequence(self, regions):
        n = len(self.calls)
        total = sum(r[2] - r[1] for r in regions)
        return np.array([[[n, len(regions), total / 1e6, 0.25]]], np.float32)

    def retrieve_multi(self, regionlist, genome, models_256m=(), targets=None,
                       normmat=True, normmat_regionlist=None,
                       ins_sequences=None):
        regions = [_region(r) for r in regionlist]
        nm = (None if normmat_regionlist is None
              else [_region(r) for r in normmat_regionlist])
        self._record("retrieve_multi", regions=regions,
                     models=list(models_256m), normmat=normmat,
                     normmat_regionlist=nm, ins_sequences=ins_sequences,
                     n_targets=len(targets) if targets else 0)
        out = (self._stand_in_sequence(regions),)
        if normmat:
            out += ([np.full((3, 3), 10.0 * len(self.calls) + k)
                     for k in range(len(models_256m))],)
        if targets:
            # a small real fetch from the caller's target object
            chrom = regions[0][0]
            out += ([t.get_feature_data(chrom, 0, 4 * RES)[None]
                     for t in targets],)
        return out

    def encode_regions(self, regionlist, genome, ins_sequences=None):
        regions = [_region(r) for r in regionlist]
        self._record("encode_regions", regions=regions,
                     ins_sequences=ins_sequences)
        return self._stand_in_sequence(regions)


def assert_same(got, want, path, tol=0.0):
    """Recursive equality: arrays exactly (with dtype), numbers to `tol`,
    containers by type, length and element."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]", tol)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, numbers.Number) and not isinstance(want, bool):
        assert isinstance(got, numbers.Number), path
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def assert_calls_equal(got, want):
    assert [c[0] for c in got] == [c[0] for c in want]
    for i, ((name, g), (_, w)) in enumerate(zip(got, want)):
        assert list(g) == list(w), (i, name)
        for key in w:
            tol = ANNO_TOL if key == "annotation" else 0.0
            assert_same(g[key], w[key], f"call {i} {name} {key}", tol)


def _ins_seq(n, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"ACGTN", np.uint8), n).tobytes().decode()


# (id, function, positional args, keyword args, pass targets?)
CASES_32 = [
    ("region", "process_region", ("chrA", 20_100_000, 20_300_000), {}, True),
    ("region_near_start", "process_region", ("chrB", 100_000, 900_000), {},
     True),
    ("dup", "process_dup", ("chrA", 20_000_000, 20_150_000), {}, True),
    ("dup_near_end", "process_dup",
     ("chrB", CHROMS["chrB"] - 400_000, CHROMS["chrB"] - 100_000), {}, False),
    ("del", "process_del", ("chrB", 10_000_000, 10_200_000), {}, True),
    ("inv", "process_inv", ("chrA", 30_000_000, 30_100_000), {}, True),
    ("ins_plus", "process_ins", ("chrB", 5_000_000, _ins_seq(50_000, 1)),
     {}, True),
    ("ins_minus", "process_ins", ("chrA", 7_000_123, _ins_seq(70_001, 2)),
     {"strand": "-"}, False),
    ("custom", "process_custom",
     ([["chrA", 1_000_000, 1_300_000, "+"], ["chrB", 2_000_000, 2_212_000, "-"]],
      [["chrA", 1_000_000, 1_512_000, "+"], ["chrB", 2_000_000, 2_512_000]],
      300_000),
     {"ref_mpos_list": [1_100_000, 2_400_000],
      "anno_list": [[300_000, "double"]],
      "ref_anno_list": [[100_000, 200_000, "black"]]}, True),
    ("custom_defaults", "process_custom",
     ([["chrB", 3_000_000, 3_512_000, "-"]], [["chrB", 3_000_000, 3_512_000]],
      256_000), {}, False),
    ("breakpoint_plus_minus", "process_single_breakpoint",
     ("chrA", 20_000_000, "chrB", 15_000_000, "+", "-"), {}, True),
    ("breakpoint_minus_plus", "process_single_breakpoint",
     ("chrA", 20_000_000, "chrB", 15_000_000, "-", "+"), {}, False),
    # the fused chromosome (350 kb) is shorter than the window: padded
    ("breakpoint_short_fused", "process_single_breakpoint",
     ("chrA", 200_000, "chrB", CHROMS["chrB"] - 150_000, "+", "-"), {}, False),
    ("seqstr_short", "process_seqstr", (_ins_seq(300_001, 3), 100_000), {},
     None),
    ("seqstr_long", "process_seqstr", (_ins_seq(700_003, 4), 350_000), {},
     None),
]

CASES_256 = [
    ("region", "process_region", ("chrA", 20_100_000, 20_300_000), {}, True),
    ("dup", "process_dup", ("chrA", 20_000_000, 22_000_000), {}, True),
    ("del", "process_del", ("chrB", 10_000_000, 12_000_000), {}, True),
    ("inv", "process_inv", ("chrA", 30_000_000, 31_000_000), {}, True),
    ("ins", "process_ins", ("chrB", 5_000_000, _ins_seq(40_000, 5)),
     {"strand": "-"}, True),
    ("breakpoint_plus_minus", "process_single_breakpoint",
     ("chrA", 20_000_000, "chrB", 15_000_000, "+", "-"), {}, True),
    ("breakpoint_minus_plus", "process_single_breakpoint",
     ("chrA", 20_000_000, "chrB", 15_000_000, "-", "+"), {}, False),
    # the alternative chromosome is longer than the window: clipped window
    ("dup_long_chrom", "process_dup", ("chrL", 200_000_000, 202_000_000),
     {"genome": "long"}, False),
    ("del_long_chrom", "process_del", ("chrL", 280_000_000, 281_000_000),
     {"genome": "long", "padding_chr": "chrB"}, False),
]


def _run(pkg, case, inputs, monkeypatch, window_radius):
    """Run one case through one package with its cascades (and, on the
    256 Mb branch, retrieval) replaced; returns (output, recorded calls)."""
    _, fn_name, args, kwargs, use_targets = case
    pipe, ret = (jpipe, jret) if pkg == "jax" else (tpipe, tret)
    genome, long_genome, target = inputs[pkg]
    rec = Recorder(port=pkg == "torch")
    monkeypatch.setattr(pipe, "genomepredict", rec.genomepredict)
    monkeypatch.setattr(pipe, "genomepredict_256mb", rec.genomepredict_256mb)
    monkeypatch.setattr(pipe, "WR32", WR)
    if window_radius == WR256:
        monkeypatch.setattr(ret, "retrieve_multi", rec.retrieve_multi)
        monkeypatch.setattr(ret, "encode_regions", rec.encode_regions)
    kwargs = dict(kwargs)
    genome = long_genome if kwargs.pop("genome", None) == "long" else genome
    if use_targets:
        kwargs["targets"] = [target]
    if pkg == "torch":
        kwargs["device"] = "cpu"
    out = getattr(pipe, fn_name)(*args, genome=genome, models=MODELS,
                                 window_radius=window_radius, **kwargs)
    monkeypatch.undo()
    return out, rec.calls


@pytest.mark.parametrize("case", CASES_32, ids=[c[0] for c in CASES_32])
def test_pipeline_32mb_branch_equal(case, inputs, monkeypatch):
    want, want_calls = _run("jax", case, inputs, monkeypatch, WR)
    got, got_calls = _run("torch", case, inputs, monkeypatch, WR)
    assert want_calls and all(c[0] == "genomepredict" for c in want_calls)
    for name, fields in want_calls:
        assert fields["sequence"].shape == (1, 2 * WR, 4)
    if case[4]:  # targets were fetched for every reference window
        assert any(c[1]["targets"] is not None for c in want_calls)
    assert_calls_equal(got_calls, want_calls)
    assert_same(got, want, "output", ANNO_TOL)


@pytest.mark.parametrize("case", CASES_256, ids=[c[0] for c in CASES_256])
def test_pipeline_256mb_branch_equal(case, inputs, monkeypatch):
    want, want_calls = _run("jax", case, inputs, monkeypatch, WR256)
    got, got_calls = _run("torch", case, inputs, monkeypatch, WR256)
    names = [c[0] for c in want_calls]
    assert "genomepredict_256mb" in names and "genomepredict" not in names
    assert_calls_equal(got_calls, want_calls)
    assert_same(got, want, "output", ANNO_TOL)


def test_process_region_rejects_other_radii(inputs):
    for pipe, key in ((jpipe, "jax"), (tpipe, "torch")):
        kw = {"device": "cpu"} if key == "torch" else {}
        with pytest.raises(ValueError, match="window_radius"):
            pipe.process_region("chrA", 1_000_000, 2_000_000, inputs[key][0],
                                MODELS, window_radius=1_000_000, **kw)


CUSTOM_ERRORS = [
    ("sum", [["chrA", 0, 500_000, "+"]], [["chrA", 0, 512_000]],
     "regions sum to 500000"),
    ("bounds", [["chrB", CHROMS["chrB"] - 100_000, CHROMS["chrB"] + 412_000]],
     [["chrA", 0, 512_000]], "out of bounds"),
    ("ref_strand", [["chrA", 0, 512_000, "+"]], [["chrA", 0, 512_000, "-"]],
     "strand must be"),
]


@pytest.mark.parametrize("case", CUSTOM_ERRORS, ids=[c[0] for c in CUSTOM_ERRORS])
def test_process_custom_validation_errors(case, inputs, monkeypatch):
    _, regions, ref_regions, message = case
    errors = []
    for pkg, pipe in (("jax", jpipe), ("torch", tpipe)):
        rec = Recorder(port=pkg == "torch")
        monkeypatch.setattr(pipe, "genomepredict", rec.genomepredict)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        with pytest.raises(ValueError, match=message) as err:
            pipe.process_custom(regions, ref_regions, 100_000, inputs[pkg][0],
                                MODELS, window_radius=WR, **kw)
        errors.append((str(err.value), rec.calls))
    assert errors[0] == errors[1]


def test_process_anno_equal():
    annos = [[1_000, 90_000, "black"], [45_000, "single"], [7, 8, "gray"]]
    for base, wr in ((0, WR), (12_345, 16_000_000)):
        assert_same(tpipe.process_anno(annos, base, wr),
                    jpipe.process_anno(annos, base, wr), "anno", ANNO_TOL)
    for pipe in (jpipe, tpipe):
        with pytest.raises(ValueError, match="2 or 3"):
            pipe.process_anno([[1]])
