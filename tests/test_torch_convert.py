"""The port's statedict converter and loaders (orca_tpu_torch/models/
convert.py and the `load_*_bundle` loaders of models/zoo.py) against the JAX
package's, on the CPU.

Reference-format statedicts are built with numpy from the JAX specs (torch's
conv init law, non-trivial BatchNorm statistics), written under the
reference's keys by the port's `*_statedict` writers with DataParallel's
'module.' prefix and `num_batches_tracked` buffers, and saved with
`torch.save`. Both packages' `load_statedict` + `convert_*` read them back:
every leaf equal, and equal to the tree that was written. The loaders are
held to the JAX package's on one directory of such files and synthetic
expectation files: parameters equal leaf for leaf, backgrounds equal in value
and dtype.

Host memory: an 8000-bin background takes num_2d x 512 MB while it is
built, so the fast gate builds the 32 Mb backgrounds at nbins=256, crop=8
(the loaders' own override) and the leukemia ones through both packages'
`multi_normmats_from_expectations` at that size; the full-size leukemia
loads are under `-m slow`.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from orca_tpu.models import convert as jconv
from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import decoders as jdec
from orca_tpu.nn import encoders as jenc
from orca_tpu_torch.models import convert as tconv
from orca_tpu_torch.models import zoo as tzoo
from test_torch_encoders import numpy_tree

NUM_1D = {"h1esc": 32, "hff": 22, "hctnoc": None}
NUM_2D = {"leukemiaA": 2, "leukemiaB": 6}
EXPECTATION_LEN = 8000


def save_statedict(sd, path):
    """A statedict as the reference's DataParallel training wrote it."""
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)


def tree_equal(got, want, path="root"):
    """Equal nesting, and every leaf a float32 CPU tensor equal to the
    numpy array at the same place."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            tree_equal(g, w, f"{path}[{i}]")
    else:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.float32 and got.device.type == "cpu", path
        w = np.asarray(want)
        assert w.dtype == np.float32, (path, w.dtype)
        np.testing.assert_array_equal(got.numpy(), w, err_msg=path)


# --------------------------------------------------------------------------
# The converters, one module at a time
# --------------------------------------------------------------------------

# (id, JAX spec, port writer, JAX converter, port converter)
MODULES = [
    ("tower", jenc.encoder_tower_spec(),
     tconv.encoder_tower_statedict, jconv.convert_encoder_tower,
     tconv.convert_encoder_tower),
]
for _levels, _up in ((5, True), (5, False), (3, True)):
    MODULES.append((
        f"pyramid{_levels}{'-up' if _up else ''}",
        jenc.pyramid_spec(_levels, _up),
        functools.partial(tconv.pyramid_statedict, levels=_levels,
                          up_pass=_up),
        functools.partial(jconv.convert_pyramid, levels=_levels, up_pass=_up),
        functools.partial(tconv.convert_pyramid, levels=_levels, up_pass=_up),
    ))
for _n in (1, 2, 6):
    MODULES.append((
        f"decoder-{_n}", jdec.decoder_spec(_n),
        functools.partial(tconv.decoder_statedict, num_2d=_n),
        functools.partial(jconv.convert_decoder, num_2d=_n),
        functools.partial(tconv.convert_decoder, num_2d=_n),
    ))
for _n in (1, 6):
    MODULES.append((
        f"decoder1m-{_n}", jdec.decoder1m_spec(_n),
        functools.partial(tconv.decoder1m_statedict, num_2d=_n),
        functools.partial(jconv.convert_decoder1m, num_2d=_n),
        functools.partial(tconv.convert_decoder1m, num_2d=_n),
    ))
for _n in (None, 22, 32):
    _spec = {"encoder": jenc.encoder_tower_spec(),
             "decoder": jdec.decoder1m_spec(1)}
    if _n:
        _spec["final_1d"] = jdec.final1d_spec(_n)
    MODULES.append((
        f"net-{_n}", _spec,
        functools.partial(tconv.net_statedict, num_1d=_n),
        functools.partial(jconv.convert_net, num_1d=_n),
        functools.partial(tconv.convert_net, num_1d=_n),
    ))


@pytest.mark.parametrize("case", MODULES, ids=[m[0] for m in MODULES])
def test_converter_equals_jax(case, tmp_path):
    """One module's statedict through both packages' load_statedict and
    converter: every leaf equal, and equal to the tree that was written."""
    name, spec, write, jconvert, tconvert = case
    tree = numpy_tree(spec, np.random.RandomState(len(name)))
    path = str(tmp_path / f"{name}.statedict")
    save_statedict(write(tree), path)
    raw = torch.load(path, weights_only=True)
    assert all(k.startswith("module.") for k in raw)
    want = jconvert(jconv.load_statedict(path))
    got = tconvert(tconv.load_statedict(path), device="cpu")
    tree_equal(got, want)
    tree_equal(got, tree)


def test_statedict_keys_follow_the_reference_layout():
    """The writers' torch child indices: a pool or an upsample is child 0, a
    Dropout takes an index, and so do a ReLU and a sigmoid; BatchNorms carry
    `num_batches_tracked`."""
    rng = np.random.RandomState(0)
    tower = tconv.encoder_tower_statedict(
        numpy_tree(jenc.encoder_tower_spec(), rng))
    shapes = {k: tuple(v.shape) for k, v in tower.items()}
    assert shapes["lconv1.0.weight"] == (64, 4, 9)  # no pool: conv first
    assert shapes["lconv1.2.weight"] == (64, 64, 9)
    assert shapes["lconv2.1.weight"] == (96, 64, 9)  # MaxPool1d at 0
    assert shapes["lconv2.3.weight"] == (96, 96, 9)
    assert shapes["conv1.3.weight"] == (64, 64, 9)  # conv, BN, ReLU, conv
    assert shapes["conv1.4.running_var"] == (64,)
    assert tower["conv1.1.num_batches_tracked"].dtype == torch.int64
    assert "conv1.2.weight" not in tower  # the ReLU holds nothing

    pyr = tconv.pyramid_statedict(numpy_tree(jenc.pyramid_spec(5, True), rng),
                                  5, True)
    assert "lblocks.4.1.weight" in pyr  # pool at 0
    assert "downlblocks.0.1.weight" in pyr  # upsample at 0
    # the up-pass active block: conv, BN, ReLU, conv (no BN), ReLU
    assert "downblocks.0.3.weight" in pyr
    assert "downblocks.0.4.weight" not in pyr

    dec = tconv.decoder_statedict(numpy_tree(jdec.decoder_spec(6), rng), 6)
    shapes = {k: tuple(v.shape) for k, v in dec.items()}
    assert shapes["lcombinerD.0.weight"] == (64, 134, 3, 3)
    assert shapes["lcombiner.1.weight"] == (64, 70, 3, 3)  # Dropout at 0
    assert shapes["lconvtwos.0.1.weight"] == (32, 64, 3, 3)  # Dropout at 0
    assert shapes["lconvtwos.1.0.weight"] == (32, 64, 3, 3)
    assert shapes["final.3.weight"] == (6, 6, 1, 1)  # conv, BN, ReLU, conv
    net = tconv.net_statedict(
        {"encoder": numpy_tree(jenc.encoder_tower_spec(), rng),
         "decoder": numpy_tree(jdec.decoder1m_spec(1), rng),
         "final_1d": numpy_tree(jdec.final1d_spec(22), rng)}, num_1d=22)
    assert tuple(net["final_1d.3.weight"].shape) == (22, 128, 1)
    assert tuple(net["lconvtwos.0.1.weight"].shape) == (32, 128, 3, 3)


# --------------------------------------------------------------------------
# A directory of reference-format files
# --------------------------------------------------------------------------


def _expected_log(k):
    d = np.arange(EXPECTATION_LEN, dtype=np.float64)
    return -1.5 * np.log1p(d) - 2.0 - 0.05 * k


def write_resource_files(resource_dir):
    """Smooth synthetic expectation files under every name the loaders
    read."""
    os.makedirs(resource_dir, exist_ok=True)
    names = list(jzoo._EXPECTED_FILES.values())
    for stem in ("4DNFI9GMP2J8", "4DNFI643OYP9"):
        names.append(f"{stem}.rebinned.mcool.expected.res1000.npy")
        names.append(f"{stem}.rebinned.mcool.expected.res32000.mono.npy")
    for files in jzoo._LEUKEMIA_NORMMAT_FILES.values():
        names += files
    for k, name in enumerate(names):
        np.save(os.path.join(resource_dir, name), _expected_log(k))
    for k, stem in enumerate(("4DNFI9GMP2J8", "4DNFI643OYP9")):
        np.save(os.path.join(
            resource_dir, f"{stem}.rebinned.mcool.expected.res32000.trans.npy"),
            np.array(-9.0 - k))


def write_model_files(model_dir, names, seed=0):
    """Reference-format statedicts of the named models: a 32 Mb-layout model
    ('h1esc', 'hff', 'hctnoc', 'leukemiaA', 'leukemiaB') writes orca_<name>
    .net (pyramid), .net0 (the whole stage-a Net, with the 1D track head for
    h1esc/hff) and .d1-.d32; '<cell>_256m' writes the 256 Mb model's .net
    and .d32-.d256."""
    os.makedirs(model_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    def save(sd, stem):
        save_statedict(sd, os.path.join(model_dir, f"orca_{stem}.statedict"))

    for name in names:
        if name.endswith("_256m"):
            save(tconv.pyramid_statedict(
                numpy_tree(jenc.pyramid_spec(3, True), rng), 3, True),
                f"{name}.net")
            for lv in jzoo.LEVELS_256M:
                save(tconv.decoder_statedict(
                    numpy_tree(jdec.decoder_spec(1), rng)), f"{name}.d{lv}")
            continue
        num_2d = NUM_2D.get(name, 1)
        num_1d = NUM_1D.get(name)
        up_pass = name in ("h1esc", "hff")
        save(tconv.pyramid_statedict(
            numpy_tree(jenc.pyramid_spec(5, up_pass), rng), 5, up_pass),
            f"{name}.net")
        net = {"encoder": numpy_tree(jenc.encoder_tower_spec(), rng),
               "decoder": numpy_tree(jdec.decoder1m_spec(num_2d), rng)}
        if num_1d:
            net["final_1d"] = numpy_tree(jdec.final1d_spec(num_1d), rng)
        save(tconv.net_statedict(net, num_1d, num_2d), f"{name}.net0")
        for lv in jzoo.LEVELS_32M:
            save(tconv.decoder_statedict(
                numpy_tree(jdec.decoder_spec(num_2d), rng), num_2d),
                f"{name}.d{lv}")


@pytest.fixture(scope="module")
def ref_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    model_dir, resource_dir = str(root / "models"), str(root / "resources")
    write_model_files(model_dir, ["h1esc", "hff", "hctnoc", "h1esc_256m",
                                  "leukemiaA", "leukemiaB"])
    write_resource_files(resource_dir)
    return model_dir, resource_dir


PARAM_FIELDS = {
    "ModelBundle": ("encoder", "pyramid", "decoders", "decoder_1pt"),
    "Model256MBundle": ("encoder", "pyramid1", "pyramid", "decoders"),
    "Model1MBundle": ("net",),
}


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def bundles_equal(got, want):
    """The port's bundle equal to the JAX package's: class, metadata,
    every parameter leaf and every background (value and dtype)."""
    assert type(got).__name__ == type(want).__name__
    for f in ("name", "upsample_mode", "pyramid_up_pass", "num_2d", "num_1d"):
        assert getattr(got, f, None) == getattr(want, f, None), f
    for field in PARAM_FIELDS[type(want).__name__]:
        w = getattr(want, field)
        if w is None:
            assert getattr(got, field) is None, field
            continue
        tree_equal(getattr(got, field), as_numpy(w), field)
    if hasattr(want, "normmats"):
        assert sorted(got.normmats) == sorted(want.normmats)
        for lv in want.normmats:
            g, w = got.normmats[lv], np.asarray(want.normmats[lv])
            assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got.epss == want.epss
    else:
        assert got.background_cis.dtype == np.float64
        np.testing.assert_array_equal(got.background_cis, want.background_cis)
        assert got.background_trans == want.background_trans


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("name", ["h1esc", "hctnoc"])
def test_load_32m_bundle_equal(ref_dirs, name, fold):
    want = jzoo.load_32m_bundle(*ref_dirs, name, fold=fold, nbins=256, crop=8)
    got = tzoo.load_32m_bundle(*ref_dirs, name, fold=fold, nbins=256, crop=8,
                               device="cpu")
    bundles_equal(got, want)
    assert ("bn" in got.encoder["lconv"][0][0]) is not fold
    if name == "hctnoc":
        assert got.decoder_1pt is None and not got.pyramid_up_pass
        assert got.upsample_mode == "nearest" and "downl" not in got.pyramid


def test_load_256m_bundle_equal(ref_dirs):
    want = jzoo.load_256m_bundle(*ref_dirs, "h1esc")
    got = tzoo.load_256m_bundle(*ref_dirs, "h1esc", device="cpu")
    bundles_equal(got, want)
    assert got.name == "h1esc_256m"
    # the tower and 5-level pyramid are the 32 Mb model's
    ref32 = tzoo.load_32m_bundle(*ref_dirs, "h1esc", nbins=256, crop=8,
                                 device="cpu")
    tree_equal(got.encoder, jax.tree.map(lambda t: t.numpy(), ref32.encoder))


@pytest.mark.parametrize("name", ["h1esc", "hff"])
def test_load_1m_bundle_equal(ref_dirs, name):
    want = jzoo.load_1m_bundle(*ref_dirs, name)
    got = tzoo.load_1m_bundle(*ref_dirs, name, device="cpu")
    bundles_equal(got, want)
    assert got.num_1d == {"h1esc": 32, "hff": 22}[name]
    assert "bn" in got.net["encoder"]["lconv"][0][0]  # unfolded, as in JAX


@pytest.mark.parametrize("num_2d", [1, 2, 6])
def test_multi_normmats_equal(num_2d):
    logs = [_expected_log(k)[:300] for k in range(num_2d)]
    want = jzoo.multi_normmats_from_expectations(logs, nbins=256, crop=8)
    got = tzoo.multi_normmats_from_expectations(logs, nbins=256, crop=8)
    assert got[1] == want[1]
    for lv in jzoo.LEVELS_32M:
        assert got[0][lv].shape == (num_2d, 8, 8)
        np.testing.assert_array_equal(got[0][lv], want[0][lv])


def _small_backgrounds(fn):
    """A package's multi_normmats_from_expectations at nbins=256, crop=8."""
    return lambda logs: fn(logs, nbins=256, crop=8)


@pytest.mark.parametrize("name", ["leukemiaA", "leukemiaB"])
def test_load_leukemia_bundle_equal(ref_dirs, name, monkeypatch):
    """Both packages' leukemia loaders on the same files, each package's
    backgrounds built at nbins=256 (the full size is the slow test
    below)."""
    for mod in (jzoo, tzoo):
        monkeypatch.setattr(
            mod, "multi_normmats_from_expectations",
            _small_backgrounds(mod.multi_normmats_from_expectations))
    want = jzoo.load_leukemia_bundle(*ref_dirs, name)
    got = tzoo.load_leukemia_bundle(*ref_dirs, name, device="cpu")
    bundles_equal(got, want)
    assert got.num_2d == NUM_2D[name] and got.upsample_mode == "nearest"
    assert got.normmats[32].shape == (NUM_2D[name], 8, 8)
    assert "bn" not in got.decoders[1]["final"][0]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["leukemiaA", "leukemiaB"])
def test_load_leukemia_bundle_full_backgrounds_equal(ref_dirs, name):
    """The leukemia loaders at their full 8000-bin backgrounds (leukemiaB
    takes about 3.5 GB of host memory in each package)."""
    want = jzoo.load_leukemia_bundle(*ref_dirs, name, fold=False)
    got = tzoo.load_leukemia_bundle(*ref_dirs, name, fold=False,
                                    device="cpu")
    bundles_equal(got, want)
    assert got.normmats[1].shape == (NUM_2D[name], 250, 250)
