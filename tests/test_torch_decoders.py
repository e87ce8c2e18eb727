"""The port's 2D decoders (orca_tpu_torch/nn/decoders.py) against
orca_tpu.nn.decoders at crop 8, on parameter trees built with numpy from the
JAX package's specs. fp32: max|d| <= 1e-4; bf16: within twice the JAX
decoder's own bf16-vs-fp32 difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.nn import decoders as jdec
from orca_tpu.nn.core import fold_params
from orca_tpu_torch.models.from_jax import params_from_numpy
from orca_tpu_torch.nn import decoders as tdec
from test_torch_encoders import numpy_tree

CROP = 8


def _inputs(seed, with_coarse):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, CROP, 128).astype(np.float32)
    distenc = np.broadcast_to(
        rng.randn(CROP, CROP, 1).astype(np.float32), (2, CROP, CROP, 1))
    y = (rng.randn(2, CROP // 2, CROP // 2, 1).astype(np.float32)
         if with_coarse else None)
    return x, np.ascontiguousarray(distenc), y


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_coarse,mode,fold", [
    (False, "bilinear", True),
    (True, "bilinear", True),
    (True, "nearest", False),
])
def test_apply_decoder(with_coarse, mode, fold):
    spec = jdec.decoder_spec(1)
    tree = numpy_tree(spec, np.random.RandomState(0))
    if fold:
        tree = jax.tree.map(np.asarray,
                            fold_params(jax.tree.map(jnp.asarray, tree), spec))
    x, distenc, y = _inputs(1, with_coarse)
    want = jdec.apply_decoder(jax.tree.map(jnp.asarray, tree), _j(x),
                              _j(distenc), _j(y), upsample_mode=mode)
    got = tdec.apply_decoder(params_from_numpy(tree, "cpu"), _t(x),
                             _t(distenc), _t(y), upsample_mode=mode)
    assert got.shape == (2, CROP, CROP, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_apply_decoder_bf16_within_bf16_noise():
    spec = jdec.decoder_spec(1)
    tree = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)),
        fold_params(jax.tree.map(jnp.asarray,
                                 numpy_tree(spec, np.random.RandomState(2))),
                    spec))
    x, distenc, y = _inputs(3, True)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    # eager JAX compiles each bf16 op on its own: jit the bf16 reference
    jb = jax.jit(jdec.apply_decoder)(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree),
        jnp.asarray(x, jnp.bfloat16), _j(distenc), _j(y))
    jf = jdec.apply_decoder(jax.tree.map(jnp.asarray, tree), _j(x),
                            _j(distenc), _j(y))
    got = tdec.apply_decoder(params_from_numpy(tree, "cpu", torch.bfloat16),
                             _t(x).to(torch.bfloat16), _t(distenc), _t(y))
    assert got.dtype == torch.bfloat16
    noise = np.abs(np.asarray(jb, np.float32) - np.asarray(jf)).max()
    d = np.abs(got.float().numpy() - np.asarray(jb, np.float32)).max()
    assert d <= 2 * noise, (d, noise)


def test_apply_decoder1m():
    spec = jdec.decoder1m_spec(1)
    tree = numpy_tree(spec, np.random.RandomState(4))
    x = np.random.RandomState(5).randn(2, CROP, 128).astype(np.float32)
    want = jdec.apply_decoder1m(jax.tree.map(jnp.asarray, tree), _j(x))
    got = tdec.apply_decoder1m(params_from_numpy(tree, "cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_symmetrize_and_pairwise():
    x = np.random.RandomState(6).randn(2, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(tdec.pairwise(_t(x)).numpy(),
                                  np.asarray(jdec.pairwise(_j(x))))
    m = np.random.RandomState(7).randn(2, 5, 5, 2).astype(np.float32)
    got = tdec.symmetrize(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdec.symmetrize(_j(m))))
    np.testing.assert_array_equal(got, got.transpose(0, 2, 1, 3))
