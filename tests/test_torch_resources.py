"""The port's resource loading (orca_tpu_torch/predict/resources.py and the
bundle pickles of models/zoo.py) against the JAX package's.

Random folded bundles, drawn with numpy in the JAX package's classes (32 Mb at
nbins=256, crop=8; 256 Mb at full width), are pickled by the JAX package's
`zoo.save_bundle` and loaded by both packages' `load_resources` in float32
and bfloat16: every parameter equal (rounded once to bf16 for 'bfloat16'),
and the backgrounds (`normmats`/`epss`, `background_cis`/`background_trans`)
equal in value and dtype. The port's own pickles round-trip and load equal to
the JAX package's; an unfolded pickle comes out folded. The genome and
micro-C target handles are compared on a small FASTA and a cooler written by
the port's `write_cooler`.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import decoders as jdec
from orca_tpu.nn import encoders as jenc
from orca_tpu.nn.core import fold_params as jfold
from orca_tpu.predict import resources as jres
from orca_tpu_torch.data import mcool as tmcool
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.predict import resources as tres
from test_torch_convert import (bundles_equal, write_model_files,
                                write_resource_files)
from test_torch_encoders import numpy_tree

GRCH38 = "Homo_sapiens.GRCh38.dna.primary_assembly"


def _strip_bn(tree):
    """A folded-form tree: the BatchNorm entries dropped (any conv weights
    and biases are a valid folded parameter set)."""
    if isinstance(tree, dict):
        return {k: _strip_bn(v) for k, v in tree.items() if k != "bn"}
    if isinstance(tree, list):
        return [_strip_bn(v) for v in tree]
    return tree


def jax_32m_bundle(seed, folded=True):
    """A JAX-package ModelBundle drawn with numpy (BatchNorm kept when
    `folded` is False) with float64 backgrounds at nbins=256, crop=8."""
    rng = np.random.RandomState(seed)

    def tree(spec):
        t = numpy_tree(spec, rng)
        return _strip_bn(t) if folded else t

    normmats, epss = jzoo._random_normmats(nbins=256, crop=8)
    return jzoo.ModelBundle(
        name=f"numpy32_{seed}",
        encoder=tree(jenc.encoder_tower_spec()),
        pyramid=tree(jenc.pyramid_spec(5, True)),
        decoders={lv: tree(jdec.decoder_spec(1)) for lv in jzoo.LEVELS_32M},
        decoder_1pt=tree(jdec.decoder1m_spec(1)),
        normmats=normmats,
        epss=epss,
    )


def jax_256m_bundle(seed):
    rng = np.random.RandomState(seed)
    d = np.arange(8000, dtype=np.float64)
    return jzoo.Model256MBundle(
        name=f"numpy256_{seed}",
        encoder=_strip_bn(numpy_tree(jenc.encoder_tower_spec(), rng)),
        pyramid1=_strip_bn(numpy_tree(jenc.pyramid_spec(5, True), rng)),
        pyramid=_strip_bn(numpy_tree(jenc.pyramid_spec(3, True), rng)),
        decoders={lv: _strip_bn(numpy_tree(jdec.decoder_spec(1), rng))
                  for lv in jzoo.LEVELS_256M},
        background_cis=np.hstack([np.exp(-1.2 * np.log1p(d) - 3.0),
                                  np.repeat(np.nan, 2000)]),
        background_trans=float(np.exp(-9.0)),
    )


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model dir of JAX-package pickles: h1esc/hff (32 Mb, seeds 0/1) and
    h1esc_256m/hff_256m (256 Mb, seeds 2/3)."""
    d = tmp_path_factory.mktemp("models")
    for name, bundle in (("h1esc", jax_32m_bundle(0)), ("hff", jax_32m_bundle(1)),
                         ("h1esc_256m", jax_256m_bundle(2)),
                         ("hff_256m", jax_256m_bundle(3))):
        jzoo.save_bundle(bundle, str(d / f"orca_{name}.bundle"))
    return str(d)


PARAM_FIELDS = {"ModelBundle": ("encoder", "pyramid", "decoders", "decoder_1pt"),
                "Model256MBundle": ("encoder", "pyramid1", "pyramid", "decoders")}


def assert_params_equal(got, want, dtype):
    """Every parameter of the port's bundle equal to the JAX bundle's, as
    `dtype` (the JAX leaves rounded to bf16 by torch for 'bfloat16')."""
    for field in PARAM_FIELDS[type(want).__name__]:
        w = jax.tree.leaves(getattr(want, field))
        g = jax.tree.leaves(getattr(got, field))
        assert len(g) == len(w) > 0, field
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert a.dtype == getattr(torch, dtype), (field, a.dtype)
            assert str(np.asarray(b).dtype) == dtype, (field, b.dtype)
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b).astype(np.float32))


def assert_backgrounds_equal(got, want):
    """Backgrounds equal in value and dtype (numpy's dtype of each, so a
    0-d float64 array and a Python float agree)."""
    if isinstance(want, jzoo.ModelBundle):
        pairs = [(got.normmats[lv], want.normmats[lv]) for lv in want.normmats]
        pairs += [(got.epss[lv], want.epss[lv]) for lv in want.epss]
        assert sorted(got.normmats) == sorted(want.normmats)
        assert sorted(got.epss) == sorted(want.epss)
    else:
        pairs = [(got.background_cis, want.background_cis),
                 (got.background_trans, want.background_trans)]
    for g, w in pairs:
        assert np.asarray(g).dtype == np.asarray(w).dtype == np.float64
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_resources_equal(model_dir, tmp_path, dtype):
    """Both families through both packages' load_resources: the same models,
    parameters equal as `dtype`, backgrounds equal in value and dtype. For
    'bfloat16' this pins what the JAX package's cast_bundle does to the
    backgrounds load_resources produces: they are float64 and stay so,
    as the port's cast leaves them."""
    want = jres.load_resources(models=("32M", "256M"), model_dir=model_dir,
                               resource_dir=str(tmp_path), dtype=dtype)
    got = tres.load_resources(models=("32M", "256M"), model_dir=model_dir,
                              resource_dir=str(tmp_path), dtype=dtype,
                              device="cpu")
    assert list(got.models) == list(want.models) == [
        "h1esc", "hff", "h1esc_256m", "hff_256m"]
    for name, w in want.models.items():
        g = got.models[name]
        assert type(g).__name__ == type(w).__name__
        assert g.name == w.name and g.upsample_mode == w.upsample_mode
        assert_params_equal(g, w, dtype)
        assert_backgrounds_equal(g, w)
    assert got.genome is None and want.genome is None
    assert got.genome_hg19 is None
    assert got.targets == want.targets == {}
    assert got.target_available is want.target_available is False


def test_load_resources_default_dtype_from_config(model_dir, tmp_path,
                                                  monkeypatch):
    from orca_tpu_torch.utils import config

    monkeypatch.setattr(config.get_config(), "param_dtype", "bfloat16")
    res = tres.load_resources(models=("32M",), model_dir=model_dir,
                              resource_dir=str(tmp_path), device="cpu")
    assert res.models["hff"].encoder["conv"][0][0]["w"].dtype == torch.bfloat16
    assert res.bundles(["hff", "h1esc"]) == [res.models["hff"],
                                             res.models["h1esc"]]


@pytest.mark.parametrize("family", ["32M", "256M"])
def test_port_pickle_round_trips_and_equals_jax_pickle(tmp_path, family):
    """A bundle pickled by the port's save_bundle loads back equal in the
    port, and equal to the same parameters pickled by the JAX package."""
    jbundle = jax_32m_bundle(4) if family == "32M" else jax_256m_bundle(5)
    jpath, tpath = str(tmp_path / "jax.bundle"), str(tmp_path / "port.bundle")
    jzoo.save_bundle(jbundle, jpath)
    from_jax = tzoo.load_bundle(jpath, device="cpu", dtype="float32")
    tzoo.save_bundle(from_jax, tpath)
    again = tzoo.load_bundle(tpath, device="cpu", dtype="float32")
    assert type(again) is type(from_jax) and again.name == jbundle.name
    assert_params_equal(again, jbundle, "float32")
    assert_backgrounds_equal(again, jbundle)
    # a bf16 bundle pickles as float32 arrays holding the bf16 values
    tzoo.save_bundle(tzoo.cast_bundle(from_jax, "bfloat16"), tpath)
    cast = tzoo.load_bundle(tpath, device="cpu", dtype="bfloat16")
    assert_params_equal(cast, jzoo.cast_bundle(jbundle, "bfloat16"),
                        "bfloat16")


def test_unfolded_pickle_loads_folded(tmp_path):
    """load_resources folds each bundle: an unfolded pickle comes out equal
    to fold_bundle of its parameters, with no BatchNorm left."""
    d = tmp_path / "models"
    d.mkdir()
    for name, seed in (("h1esc", 6), ("hff", 7)):
        jzoo.save_bundle(jax_32m_bundle(seed, folded=False),
                         str(d / f"orca_{name}.bundle"))
    res = tres.load_resources(models=("32M",), model_dir=str(d),
                              resource_dir=str(tmp_path), dtype="float32",
                              device="cpu")
    for name in ("h1esc", "hff"):
        raw = tzoo.load_bundle(str(d / f"orca_{name}.bundle"), device="cpu",
                               dtype="float32")
        assert "bn" in raw.encoder["lconv"][0][0]
        want = tzoo.fold_bundle(raw)
        got = res.models[name]
        assert "bn" not in got.encoder["lconv"][0][0]
        for field in PARAM_FIELDS["ModelBundle"]:
            g = jax.tree.leaves(getattr(got, field))
            w = jax.tree.leaves(getattr(want, field))
            assert len(g) == len(w) > 0
            for a, b in zip(g, w):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def _write_fasta(path, rng):
    letters = np.array(list("ACGTacgtN"))
    with open(path, "w") as f:
        for name, n in (("chr1", 70_001), ("chrX", 33_333)):
            seq = "".join(letters[rng.randint(0, 9, n)])
            f.write(f">{name} test\n")
            f.writelines(seq[i : i + 60] + "\n" for i in range(0, n, 60))


@pytest.mark.parametrize("use_memmap", [True, False])
def test_load_genome_equal(tmp_path, use_memmap):
    """_load_genome on Homo_sapiens.GRCh38.dna.primary_assembly.fa (each
    package building its own code memmap when asked): the same codes."""
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
        _write_fasta(str(d / f"{GRCH38}.fa"), np.random.RandomState(8))
    want = jres._load_genome(str(dirs[0]), use_memmap, GRCH38)
    got = tres._load_genome(str(dirs[1]), use_memmap, GRCH38)
    assert type(got).__name__ == type(want).__name__
    assert got.get_chr_lens() == want.get_chr_lens() == [("chr1", 70_001),
                                                         ("chrX", 33_333)]
    for chrom, n in want.get_chr_lens():
        np.testing.assert_array_equal(got.get_codes(chrom, -5, n + 5),
                                      want.get_codes(chrom, -5, n + 5))
    assert os.path.exists(dirs[1] / f"{GRCH38}.codes.mmap") == use_memmap
    # the memmap, once built, is what a second load opens
    if use_memmap:
        again = tres._load_genome(str(dirs[1]), True, GRCH38)
        np.testing.assert_array_equal(again.get_codes("chrX", 0, 33_333),
                                      want.get_codes("chrX", 0, 33_333))
    assert tres._load_genome(str(tmp_path), use_memmap, GRCH38) is None


def _write_mcool(path):
    """A cooler at 1, 4 and 32 kb over two small chromosomes, with NaN
    balancing weights on some bins, written by the port's write_cooler."""
    rng = np.random.RandomState(9)
    chroms = {"chr1": 256_000, "chr2": 160_000}
    for res in (1000, 4000, 32000):
        nbins = sum(-(-n // res) for n in chroms.values())
        i, j = np.triu_indices(nbins)
        keep = rng.rand(i.size) < 0.4
        counts = rng.randint(1, 30, keep.sum()).astype(np.int32)
        weights = rng.uniform(0.5, 1.5, nbins)
        weights[rng.randint(0, nbins, 3)] = np.nan
        tmcool.write_cooler(path, chroms, res, (i[keep], j[keep], counts),
                            weights=weights, group=f"/resolutions/{res}")


def test_load_targets_equal(tmp_path):
    """No mcool: no targets, target_available False. With the h1esc mcool
    (and not the hff one): its three target handles, fetching what the JAX
    package's fetch; available stays False, as in JAX."""
    assert tres._load_targets(str(tmp_path)) == ({}, False)
    _write_mcool(str(tmp_path / "4DNFI9GMP2J8.rebinned.mcool"))
    want, want_ok = jres._load_targets(str(tmp_path))
    got, got_ok = tres._load_targets(str(tmp_path))
    assert got_ok is want_ok is False
    assert list(got) == list(want) == ["h1esc", "h1esc_256m", "h1esc_1m"]
    queries = {
        "h1esc": [("chr1", 0, 128_000), ("chr2", 40_000, 160_000)],
        "h1esc_256m": [("chr1", 0, 256_000),
                       ("chr1", 0, 128_000, "chr2", 0, 160_000)],
        "h1esc_1m": [("chr2", 20_000, 60_000)],
    }
    for name, qs in queries.items():
        assert got[name].shape == want[name].shape
        assert got[name].cg is want[name].cg is True
        for q in qs:
            kw = dict(zip(("chrom2", "start2", "end2"), q[3:]))
            g = got[name].get_feature_data(*q[:3], **kw)
            w = want[name].get_feature_data(*q[:3], **kw)
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.isfinite(w).any()
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def statedict_dirs(tmp_path_factory):
    """(model dir, resource dir) of reference-format statedicts for the
    h1esc and hff 32 Mb and 256 Mb models, and the expectation files."""
    root = tmp_path_factory.mktemp("statedicts")
    dirs = str(root / "models"), str(root / "resources")
    write_model_files(dirs[0], ["h1esc", "hff", "h1esc_256m", "hff_256m"])
    write_resource_files(dirs[1])
    return dirs


def jax_1m_folded(bundle):
    """A JAX-package Model1MBundle with its Net folded by the JAX package's
    fold_params (its load_resources keeps the 1 Mb family unfolded)."""
    spec = {"encoder": jenc.encoder_tower_spec(),
            "decoder": jdec.decoder1m_spec(1),
            "final_1d": jdec.final1d_spec(bundle.num_1d)}
    return dataclasses.replace(bundle, net=jfold(bundle.net, spec))


def test_missing_models_raise(tmp_path, statedict_dirs):
    """Leukemia without statedicts raises FileNotFoundError in both
    packages. A model dir without bundle pickles takes the statedict
    loaders: the 1 Mb and 256 Mb families load from the reference's
    statedicts equal to the JAX package's load_resources on the same
    directory (the 1 Mb Net folded in both), and a missing statedict raises
    FileNotFoundError in both."""
    empty = str(tmp_path)
    for mod, kw in ((jres, {}), (tres, {"device": "cpu"})):
        with pytest.raises(FileNotFoundError, match="leukemia"):
            mod.load_resources(models=["leukemia"], model_dir=empty,
                               resource_dir=empty, **kw)
        with pytest.raises(FileNotFoundError, match="statedict"):
            mod.load_resources(models=["256M"], model_dir=empty,
                               resource_dir=empty, **kw)
    model_dir, resource_dir = statedict_dirs
    want = jres.load_resources(models=["1M", "256M"], model_dir=model_dir,
                               resource_dir=resource_dir, dtype="float32")
    got = tres.load_resources(models=["1M", "256M"], model_dir=model_dir,
                              resource_dir=resource_dir, dtype="float32",
                              device="cpu")
    assert list(got.models) == list(want.models) == [
        "h1esc_1m", "hff_1m", "h1esc_256m", "hff_256m"]
    for name, w in want.models.items():
        if name.endswith("_1m"):
            w = jax_1m_folded(w)
        bundles_equal(got.models[name], w)


@pytest.mark.slow
def test_load_resources_statedicts_32m_and_leukemia(tmp_path):
    """The 32 Mb (h1esc, hff, hctnoc) and leukemia (A and B) families from
    statedicts through both packages' load_resources, at their full 8000-bin
    backgrounds (leukemiaB takes about 3.5 GB of host memory while they are
    built)."""
    model_dir, resource_dir = str(tmp_path / "models"), str(tmp_path / "res")
    write_model_files(model_dir, ["h1esc", "hff", "hctnoc", "leukemiaA",
                                  "leukemiaB"], seed=2)
    write_resource_files(resource_dir)
    for models, names in ((["32M"], ["h1esc", "hff", "hctnoc"]),
                          (["leukemia"], ["leukemiaA", "leukemiaB"])):
        want = jres.load_resources(models=models, model_dir=model_dir,
                                   resource_dir=resource_dir,
                                   dtype="float32")
        got = tres.load_resources(models=models, model_dir=model_dir,
                                  resource_dir=resource_dir, dtype="float32",
                                  device="cpu")
        assert list(got.models) == list(want.models) == names
        for name, w in want.models.items():
            bundles_equal(got.models[name], w)
        del want, got
