"""Primitive NN ops of the port (counterpart of orca_tpu/ops/nn_ops.py).

Layouts are the JAX package's, channels last: 1D tensors are (N, L, C), 2D
tensors (N, H, W, C); 1D conv weights (K, Cin, Cout), 2D (Kh, Kw, Cin, Cout).
The convs permute to the NCL/NCHW views `F.conv1d`/`F.conv2d` take (for 2D a
channels-last NCHW view, no copy) and back.

Numerics follow torch, as the JAX package does: convs are cross-correlations
zero-padded by dilation*(k-1)//2, BatchNorm eval uses eps=1e-5, max-pool
floors the length, bilinear upsampling uses half-pixel centres
(align_corners=False). float32 convs run without TF32, the counterpart of the
JAX package's Precision.HIGHEST.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch BatchNorm default


@contextlib.contextmanager
def full_fp32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block, and select cuDNN's deterministic algorithms, restoring the
    caller's settings after it. A training step runs its forward and its
    backward inside one such block, so the backward's convolutions run
    without TF32 too, and a resumed run replays an unkilled one's losses on
    the card as on the CPU (cuDNN's default backward algorithms are not
    bitwise deterministic)."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic = True
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cudnn.deterministic) = saved


def _result_dtype(*ts) -> torch.dtype:
    dtype = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _check_precision(precision) -> None:
    """The JAX package's `precision=` of a conv, read without jax: None, a
    name, a `lax.Precision` member (read by its name) or a pair of them. The
    port's float32 convs always run at full float32 (HIGHEST); a precision
    that would let TF32 or bf16 passes in raises rather than be ignored."""
    pair = precision if isinstance(precision, (tuple, list)) else (precision,)
    for p in pair:
        if p is None:
            continue
        if str(getattr(p, "name", p)).lower() != "highest":
            raise ValueError(
                f"precision={precision!r}: the port's convs run at full "
                "float32 only (None or 'highest')")


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, dilation: int = 1, precision=None) -> torch.Tensor:
    """torch Conv1d with 'same' padding for odd k. x (N, L, Cin), w (K, Cin,
    Cout), b (Cout,) -> (N, L, Cout). precision: None or 'highest' (see
    `_check_precision`)."""
    _check_precision(precision)
    dtype = _result_dtype(x, w, b)
    pad = dilation * (w.shape[0] - 1) // 2
    wt = w.to(dtype).permute(2, 1, 0)
    bt = None if b is None else b.to(dtype)
    with full_fp32():
        out = F.conv1d(x.to(dtype).transpose(1, 2), wt, bt, padding=pad,
                       dilation=dilation)
    return out.transpose(1, 2)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, dilation: int = 1, precision=None) -> torch.Tensor:
    """torch Conv2d with 'same' padding for odd k. x (N, H, W, Cin), w (Kh,
    Kw, Cin, Cout), b (Cout,) -> (N, H, W, Cout). precision: as `conv1d`."""
    _check_precision(precision)
    dtype = _result_dtype(x, w, b)
    ph = dilation * (w.shape[0] - 1) // 2
    pw = dilation * (w.shape[1] - 1) // 2
    wt = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last
    )
    bt = None if b is None else b.to(dtype)
    xt = x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )
    with full_fp32():
        out = F.conv2d(xt, wt, bt, padding=(ph, pw), dilation=dilation)
    return out.permute(0, 2, 3, 1)


def maxpool1d(x: torch.Tensor, k: int,
              stride: Optional[int] = None) -> torch.Tensor:
    """Max pooling over the length axis of (N, L, C) with stride `stride`
    (None = k); torch MaxPool1d defaults (no padding, floor length)."""
    stride = stride or k
    n, length, c = x.shape
    if stride != k:
        return x.unfold(1, k, stride).amax(dim=3)
    m = length // k
    return x[:, : m * k].reshape(n, m, k, c).amax(dim=2)


def batchnorm(x, scale, bias, mean, var, eps: float = BN_EPS):
    """BatchNorm inference transform over the trailing channel axis."""
    inv = torch.rsqrt(var + eps) * scale
    return x * inv + (bias - mean * inv)


def batchnorm_train(x: torch.Tensor, scale, bias, eps: float = BN_EPS, *,
                    group=None):
    """Training-mode BatchNorm over all axes but the last.

    Returns (y, batch_mean, batch_var_biased, batch_var_unbiased): y is
    normalised with the biased variance (torch semantics), the caller updates
    the running statistics with the unbiased one. The variance takes two
    passes, E[(x - mean)^2], as the JAX package does: E[x^2] - E[x]^2 cancels
    catastrophically where |mean| >> std.

    group: a parallel.multihost.DataGroup whose ranks hold equal shares of
    the batch; the statistics are then the global batch's, each pass's sum
    all-reduced by a differentiable collective (so the gradient is the
    one-process step's). Under torch.utils.checkpoint the recompute in the
    backward calls these collectives again; every rank recomputes the same
    units in the same order, so they pair up."""
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    if group is None:
        mean = x.mean(dim=dims)
        var = (x - mean).square().mean(dim=dims)
    else:
        n *= group.world
        mean = group.sum(x.sum(dim=dims)) / n
        var = group.sum((x - mean).square().sum(dim=dims)) / n
    var_unbiased = var * (n / max(n - 1, 1))
    inv = torch.rsqrt(var + eps) * scale
    y = x * inv + (bias - mean * inv)
    return y, mean, var, var_unbiased


def dropout(x: torch.Tensor, rate: float,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverted dropout with a drawn keep mask (utils.rng.bernoulli of
    1 - rate); identity when mask is None (inference)."""
    if mask is None or rate == 0.0:
        return x
    return torch.where(mask, x / (1.0 - rate), 0.0)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def upsample1d_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(N, L, C) -> (N, L*scale, C), duplicating (torch Upsample 'nearest').
    A broadcast, whose backward is a sum (deterministic on the card)."""
    n, length, c = x.shape
    return x[:, :, None].expand(n, length, scale, c).reshape(
        n, length * scale, c)


def upsample2d_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H*s, W*s, C), duplicating (a broadcast)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None].expand(n, h, scale, w, scale, c).reshape(
        n, h * scale, w * scale, c)


def upsample2d_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear upsampling with half-pixel centres, torch
    Upsample(mode='bilinear', align_corners=False). At scale 2 the weights
    are the fixed stencil (0.75, 0.25) with edge clamping, computed in the
    input dtype as the JAX package does."""
    if scale != 2:
        out = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                            mode="bilinear", align_corners=False)
        return out.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    xe = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    up = 0.75 * xe[:, 1:-1] + 0.25 * xe[:, :-2]  # offset -0.25
    dn = 0.75 * xe[:, 1:-1] + 0.25 * xe[:, 2:]  # offset +0.25
    xh = torch.stack([up, dn], dim=2).reshape(n, 2 * h, w, c)
    xe = torch.cat([xh[:, :, :1], xh, xh[:, :, -1:]], dim=2)
    lf = 0.75 * xe[:, :, 1:-1] + 0.25 * xe[:, :, :-2]
    rt = 0.75 * xe[:, :, 1:-1] + 0.25 * xe[:, :, 2:]
    return torch.stack([lf, rt], dim=3).reshape(n, 2 * h, 2 * w, c)


def fold_bn_into_conv(w, b, bn: dict, eps: float = BN_EPS):
    """Fold an inference BatchNorm into the preceding conv:
    w' = w * g, b' = (b - mean) * g + beta, g = scale / sqrt(var + eps).

    The square root is taken in float64 and rounded back, which is the
    correctly rounded result: torch's float32 sqrt on the CPU is not in
    about 0.4% of cases, and the folded weights would then differ from the
    JAX package's in the last bit."""
    var = bn["var"] + eps
    g = bn["scale"] / torch.sqrt(var.double()).to(var.dtype)
    return w * g, (b - bn["mean"]) * g + bn["bias"]
