"""The port's primitive ops (orca_tpu_torch/ops/nn_ops.py) against
orca_tpu.ops.nn_ops on the same numpy inputs.

fp32: max|d| <= 1e-4 (summation order differs). bf16: max|port - jax_bf16|
<= 2 * max|jax_bf16 - jax_fp32| on the same bf16-rounded inputs, i.e. the
port's bf16 error stays within bf16's own noise (exact ops match exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.ops import nn_ops as jops
from orca_tpu_torch.ops import nn_ops as tops


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bf16(a):
    """numpy fp32 array of the bf16-rounded values."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def check_fp32(port_fn, jax_fn, *arrays, atol=1e-4):
    got = port_fn(*[torch.from_numpy(a) for a in arrays])
    want = jax_fn(*[jnp.asarray(a) for a in arrays])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def check_bf16(port_fn, jax_fn, *arrays):
    arrays = [_bf16(a) for a in arrays]
    jb = np.asarray(jax_fn(*[jnp.asarray(a, jnp.bfloat16) for a in arrays]),
                    np.float32)
    jf = np.asarray(jax_fn(*[jnp.asarray(a) for a in arrays]))
    got = port_fn(*[torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    assert got.dtype == torch.bfloat16
    noise = np.abs(jb - jf).max()
    d = np.abs(got.float().numpy() - jb).max()
    assert d <= 2 * noise, (d, noise)


def _both(port_fn, jax_fn, *arrays):
    check_fp32(port_fn, jax_fn, *arrays)
    check_bf16(port_fn, jax_fn, *arrays)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16, 32, 64])
def test_conv1d(dilation):
    x, w, b = _rand(0, 2, 150, 8), _rand(1, 9, 8, 12) * 0.2, _rand(2, 12)
    _both(lambda x, w, b: tops.conv1d(x, w, b, dilation=dilation),
          lambda x, w, b: jops.conv1d(x, w, b, dilation=dilation), x, w, b)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16, 32, 64])
def test_conv2d(dilation):
    x, w, b = _rand(3, 2, 20, 20, 8), _rand(4, 3, 3, 8, 6) * 0.2, _rand(5, 6)
    _both(lambda x, w, b: tops.conv2d(x, w, b, dilation=dilation),
          lambda x, w, b: jops.conv2d(x, w, b, dilation=dilation), x, w, b)


def test_conv_k1_and_no_bias():
    x, w = _rand(6, 2, 9, 9, 8), _rand(7, 1, 1, 8, 5)
    _both(tops.conv2d, jops.conv2d, x, w)
    x1, w1 = _rand(8, 2, 30, 8), _rand(9, 1, 8, 5)
    _both(tops.conv1d, jops.conv1d, x1, w1)


@pytest.mark.parametrize("k", [2, 4, 5])
def test_maxpool1d_floor(k):
    x = _rand(10, 2, 23, 6)
    got = tops.maxpool1d(torch.from_numpy(x), k)
    assert got.shape == (2, 23 // k, 6)
    _both(lambda x: tops.maxpool1d(x, k), lambda x: jops.maxpool1d(x, k), x)


def test_batchnorm_relu_sigmoid():
    x = _rand(11, 2, 7, 5)
    scale, bias, mean = _rand(12, 5), _rand(13, 5), _rand(14, 5)
    var = np.abs(_rand(15, 5)) + 0.5
    _both(tops.batchnorm, jops.batchnorm, x, scale, bias, mean, var)
    _both(tops.relu, jops.relu, x)
    _both(tops.sigmoid, jops.sigmoid, x)


def test_upsample_nearest():
    _both(lambda x: tops.upsample1d_nearest(x, 2),
          lambda x: jops.upsample1d_nearest(x, 2), _rand(16, 2, 7, 3))
    _both(lambda x: tops.upsample2d_nearest(x, 2),
          lambda x: jops.upsample2d_nearest(x, 2), _rand(17, 2, 5, 6, 3))


def test_upsample2d_bilinear():
    x = _rand(18, 2, 5, 7, 3)
    _both(lambda x: tops.upsample2d_bilinear(x, 2),
          lambda x: jops.upsample2d_bilinear(x, 2), x)
    # other scales take the general resize on both sides
    check_fp32(lambda x: tops.upsample2d_bilinear(x, 3),
               lambda x: jops.upsample2d_bilinear(x, 3), x)
    # torch's own align_corners=False bilinear is the same function
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=False,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(
        tops.upsample2d_bilinear(torch.from_numpy(x)).numpy(), ref.numpy(),
        rtol=0, atol=1e-6)


def test_fold_bn_into_conv():
    w, b = _rand(19, 9, 4, 6), _rand(20, 6)
    bn = {"scale": _rand(21, 6), "bias": _rand(22, 6), "mean": _rand(23, 6),
          "var": np.abs(_rand(24, 6)) + 0.5}
    tw, tb = tops.fold_bn_into_conv(
        torch.from_numpy(w), torch.from_numpy(b),
        {k: torch.from_numpy(v) for k, v in bn.items()})
    jw, jb = jops.fold_bn_into_conv(
        jnp.asarray(w), jnp.asarray(b),
        {k: jnp.asarray(v) for k, v in bn.items()})
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_full_fp32_restores_tf32_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.deterministic)
    with tops.full_fp32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.deterministic
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic) == before


@pytest.mark.parametrize("k,stride", [(4, 2), (5, 3), (2, 3), (4, 4)])
def test_maxpool1d_stride(k, stride):
    """maxpool1d(x, k, stride), the JAX package's third positional
    argument, overlapping, gapped and equal to k."""
    x = _rand(19, 2, 23, 6)
    got = tops.maxpool1d(torch.from_numpy(x), k, stride)
    assert got.shape == (2, (23 - k) // stride + 1, 6)
    _both(lambda x: tops.maxpool1d(x, k, stride),
          lambda x: jops.maxpool1d(x, k, stride), x)


def test_conv_precision():
    """precision= None, 'highest' or lax.Precision.HIGHEST runs the convs at
    full float32 as before; a precision that would let lower passes in
    raises instead of being ignored."""
    from jax import lax

    x, w, b = _rand(20, 2, 30, 8), _rand(21, 9, 8, 5) * 0.2, _rand(22, 5)
    x2, w2 = _rand(23, 2, 9, 9, 8), _rand(24, 3, 3, 8, 5) * 0.2
    args1 = [torch.from_numpy(a) for a in (x, w, b)]
    args2 = [torch.from_numpy(a) for a in (x2, w2, b)]
    want1, want2 = tops.conv1d(*args1), tops.conv2d(*args2)
    for precision in (None, "highest", lax.Precision.HIGHEST,
                      (lax.Precision.HIGHEST, lax.Precision.HIGHEST)):
        assert torch.equal(tops.conv1d(*args1, precision=precision), want1)
        assert torch.equal(tops.conv2d(*args2, precision=precision), want2)
        check_fp32(lambda x, w, b: tops.conv1d(x, w, b, precision=precision),
                   lambda x, w, b: jops.conv1d(x, w, b, precision=precision),
                   x, w, b)
    for precision in ("default", "high", "tensorfloat32",
                      lax.Precision.DEFAULT,
                      (lax.Precision.HIGHEST, lax.Precision.DEFAULT)):
        with pytest.raises(ValueError, match="precision"):
            tops.conv1d(*args1, precision=precision)
        with pytest.raises(ValueError, match="precision"):
            tops.conv2d(*args2, precision=precision)
