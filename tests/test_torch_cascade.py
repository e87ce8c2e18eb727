"""The port's 32 Mb cascade (orca_tpu_torch/predict/multiscale.py) against
the JAX package's `genomepredict` at the scaled test geometry
CascadeGeometry(1_024_000, 4000, 8), on one bundle built with numpy from the
JAX specs and folded; and the bundle pickle round trip from the JAX
package's `zoo.save_bundle` into the port's `load_bundle`.

Zoom starts must be equal; fp32 maps agree to max|d| <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import decoders as jdec
from orca_tpu.nn import encoders as jenc
from orca_tpu.predict import multiscale as jms
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.predict import multiscale as tms
from test_torch_encoders import numpy_tree

GEOM_J = jms.CascadeGeometry(1_024_000, 4000, 8)
GEOM_T = tms.CascadeGeometry(1_024_000, 4000, 8)
WPOS = GEOM_J.window_bp // 2


def jax_bundle(seed=0, geom=GEOM_J):
    """A folded JAX-package ModelBundle with numpy-drawn parameters."""
    rng = np.random.RandomState(seed)

    def tree(spec):
        return jax.tree.map(jnp.asarray, numpy_tree(spec, rng))

    normmats, epss = jzoo._random_normmats(nbins=geom.bins, crop=geom.crop)
    bundle = jzoo.ModelBundle(
        name="numpy",
        encoder=tree(jenc.encoder_tower_spec()),
        pyramid=tree(jenc.pyramid_spec(5, True)),
        decoders={lv: tree(jdec.decoder_spec(1)) for lv in jzoo.LEVELS_32M},
        decoder_1pt=tree(jdec.decoder1m_spec(1)),
        normmats=normmats,
        epss=epss,
    )
    return jzoo.fold_bundle(bundle)


@pytest.fixture(scope="module")
def bundles():
    jb = jax_bundle()
    return jb, bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")


def sequence(seed=42, geom=GEOM_J):
    rng = np.random.RandomState(seed)
    return np.eye(4, dtype=np.float32)[rng.randint(0, 4, (1, geom.window_bp))]


def targets_and_annotation():
    """An observed map with NaN bins and a window annotation (intervals and
    points, in window fractions)."""
    rng = np.random.RandomState(3)
    target = rng.rand(GEOM_J.bins, GEOM_J.bins)
    target[rng.rand(*target.shape) < 0.2] = np.nan
    annotation = [(0.1, 0.3, "a"), (0.45, 0.52, "b"), (0.5, "p"), (0.9, "q")]
    return [target], annotation


@pytest.mark.parametrize("mpos_frac", [0.5, 0.13, 0.97])
def test_genomepredict_matches_jax(bundles, mpos_frac):
    jb, tb = bundles
    seq = sequence()
    mpos = int(GEOM_J.window_bp * mpos_frac)
    targets, annotation = targets_and_annotation()
    kw = dict(targets=targets, annotation=annotation, nan_thresh=0.5)
    want = jms.genomepredict(seq, "chr1", mpos, WPOS, [jb], geometry=GEOM_J,
                             **kw)
    got = tms.genomepredict(seq, "chr1", mpos, WPOS, [tb], geometry=GEOM_T,
                            device="cpu", **kw)
    assert got["start_coords"] == want["start_coords"]
    assert got["end_coords"] == want["end_coords"]
    assert got["annos"] == want["annos"]
    for g, w in zip(got["experiments"][0], want["experiments"][0]):
        np.testing.assert_array_equal(g, w)
    for j, (g, w) in enumerate(zip(got["predictions"][0],
                                   want["predictions"][0])):
        assert g.shape == (GEOM_J.crop, GEOM_J.crop)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=f"level index {j}")


def test_load_bundle_round_trip(bundles, tmp_path):
    jb, tb = bundles
    path = str(tmp_path / "orca_test.bundle")
    jzoo.save_bundle(jb, path)
    loaded = tzoo.load_bundle(path, device="cpu", dtype="float32")
    assert isinstance(loaded, tzoo.ModelBundle)
    assert loaded.levels == tb.levels and loaded.name == "numpy"
    want = jax.tree.leaves(jax.tree.map(np.asarray, jb.decoders))
    got = [t.numpy() for t in jax.tree.leaves(loaded.decoders)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(loaded.log_normmats(), jb.log_normmats())
    assert loaded.epss == tb.epss
    half = tzoo.load_bundle(path, device="cpu", dtype="bfloat16")
    assert half.encoder["lconv"][0][0]["w"].dtype == torch.bfloat16
    # a pickle of a bf16-cast bundle holds ml_dtypes arrays: refused clearly
    jzoo.save_bundle(jzoo.cast_bundle(jb, "bfloat16"), path)
    with pytest.raises(ValueError, match="bfloat16"):
        tzoo.load_bundle(path, device="cpu")
