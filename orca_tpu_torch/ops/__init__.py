"""Primitive ops and the hand-written kernels."""

from orca_tpu_torch.ops.nn_ops import (  # noqa: F401
    conv1d,
    conv2d,
    maxpool1d,
    batchnorm,
    relu,
    sigmoid,
    upsample1d_nearest,
    upsample2d_nearest,
    upsample2d_bilinear,
    fold_bn_into_conv,
)
