"""The variant families in the port's 32 Mb cascade against the JAX
package's `genomepredict`, on the CPU at CascadeGeometry(1_024_000, 4000, 8):

  * HCTnoc: a pyramid without the upward pass, nearest upsampling of the
    coarse prediction, no `Decoder_1m` head (JAX `random_32m_bundle` with
    upsample_mode="nearest", up_pass=False);
  * leukemia at 2 and 6 heads (JAX `random_leukemia_bundle`): num_2d
    distance-encoding channels and output channels, one background per head.

The JAX bundles are folded and carried across by `bundle_from_numpy`. Zoom
starts, coordinates, annotations and experiments are equal; fp32 maps agree
to max|d| <= 2.0e-6 (the bf16 leukemia cascade is checked in
test_torch_cascade_bf16.py). The variants also round-trip through a
JAX-package pickle and warm up through `warmup_cascade_32m`, and the port's
`random_leukemia_bundle` has the JAX package's backgrounds.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from orca_tpu.models import zoo as jzoo
from orca_tpu.predict import multiscale as jms
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.predict import multiscale as tms
from test_torch_cascade import sequence
from test_torch_convert import bundles_equal

GEOM_J = jms.CascadeGeometry(1_024_000, 4000, 8)
GEOM_T = tms.CascadeGeometry(1_024_000, 4000, 8)
WPOS = GEOM_J.window_bp // 2
VARIANTS = ("hctnoc", "leukemia2", "leukemia6")
NUM_2D = {"hctnoc": 1, "leukemia2": 2, "leukemia6": 6}


def jax_variant(variant, seed=0, geom=GEOM_J):
    """The JAX package's random bundle of a variant at `geom`'s background
    size, BatchNorm folded."""
    kw = dict(nbins=geom.bins, crop=geom.crop)
    if variant == "hctnoc":
        b = jzoo.random_32m_bundle(seed, name="hctnoc", upsample_mode="nearest",
                                   up_pass=False, **kw)
    else:
        b = jzoo.random_leukemia_bundle(seed, NUM_2D[variant],
                                        name=variant, **kw)
    return jzoo.fold_bundle(b)


@pytest.fixture(scope="module")
def bundles():
    """{variant: (JAX bundle, port bundle)}, the JAX programs of each
    compiled concurrently first."""
    jbs = {v: jax_variant(v, seed=i) for i, v in enumerate(VARIANTS)}
    with ThreadPoolExecutor(len(jbs)) as ex:
        for f in [ex.submit(jms.warmup_cascade_32m, b, GEOM_J)
                  for b in jbs.values()]:
            f.result()
    return {v: (jb, bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu"))
            for v, jb in jbs.items()}


def targets_and_annotation(num_2d):
    """An observed map per head with NaN bins, and a window annotation."""
    rng = np.random.RandomState(3)
    target = rng.rand(num_2d, GEOM_J.bins, GEOM_J.bins)
    target[rng.rand(*target.shape) < 0.2] = np.nan
    annotation = [(0.1, 0.3, "a"), (0.45, 0.52, "b"), (0.5, "p"), (0.9, "q")]
    return [target], annotation


@pytest.mark.parametrize("mpos_frac", [0.5, 0.13, 0.97])
@pytest.mark.parametrize("variant", VARIANTS)
def test_genomepredict_variant_matches_jax(bundles, variant, mpos_frac):
    jb, tb = bundles[variant]
    num_2d = NUM_2D[variant]
    seq = sequence()
    mpos = int(GEOM_J.window_bp * mpos_frac)
    targets, annotation = targets_and_annotation(num_2d)
    kw = dict(targets=targets, annotation=annotation, nan_thresh=0.5)
    want = jms.genomepredict(seq, "chr1", mpos, WPOS, [jb], geometry=GEOM_J,
                             **kw)
    got = tms.genomepredict(seq, "chr1", mpos, WPOS, [tb], geometry=GEOM_T,
                            device="cpu", **kw)
    assert got["start_coords"] == want["start_coords"]
    assert got["end_coords"] == want["end_coords"]
    assert got["annos"] == want["annos"]
    shape = ((GEOM_J.crop,) * 2 if num_2d == 1
             else (num_2d,) + (GEOM_J.crop,) * 2)
    for g, w in zip(got["experiments"][0], want["experiments"][0]):
        assert g.shape == shape
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["normmats"][0], want["normmats"][0]):
        np.testing.assert_array_equal(g, w)
    assert len(got["predictions"][0]) == 6
    for j, (g, w) in enumerate(zip(got["predictions"][0],
                                   want["predictions"][0])):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0e-6,
                                   err_msg=f"level index {j}")


@pytest.mark.parametrize("variant", ["hctnoc", "leukemia6"])
def test_variant_pickle_round_trip(bundles, variant, tmp_path):
    """A JAX-package pickle of the variant loads into the port's class equal
    to the bundle carried across by bundle_from_numpy (HCTnoc's missing
    `Decoder_1m` head stays None, the leukemia backgrounds stay (num_2d,
    crop, crop) float64)."""
    jb, _ = bundles[variant]
    path = str(tmp_path / f"orca_{variant}.bundle")
    jzoo.save_bundle(jb, path)
    got = tzoo.load_bundle(path, device="cpu", dtype="float32")
    bundles_equal(got, jb)
    if variant == "hctnoc":
        assert got.decoder_1pt is None and got.pyramid_up_pass is False
    else:
        assert got.normmats[1].shape == (6, GEOM_J.crop, GEOM_J.crop)


@pytest.mark.parametrize("variant", ["hctnoc", "leukemia6"])
def test_warmup_accepts_variant(bundles, variant):
    _, tb = bundles[variant]
    assert tms.warmup_cascade_32m(tb, GEOM_T, device="cpu") > 0


@pytest.mark.parametrize("num_2d", [2, 6])
def test_random_leukemia_bundle_backgrounds_equal(num_2d):
    want = jzoo.random_leukemia_bundle(3, num_2d, nbins=256, crop=8)
    got = tzoo.random_leukemia_bundle(3, num_2d, nbins=256, crop=8,
                                      device="cpu")
    assert got.num_2d == want.num_2d and got.upsample_mode == "nearest"
    assert got.pyramid_up_pass is False and "downl" not in got.pyramid
    assert got.decoders[1]["final"][1]["w"].shape[-1] == num_2d
    assert got.epss == want.epss
    for lv in jzoo.LEVELS_32M:
        assert got.normmats[lv].dtype == np.float64
        np.testing.assert_array_equal(got.normmats[lv], want.normmats[lv])
