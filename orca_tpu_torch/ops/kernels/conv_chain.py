"""The encoder tower's fused conv-chain kernels (counterpart of
orca_tpu/ops/pallas/conv1d.py).

Two functions, each with a hand-written CUDA kernel (csrc/conv_chain.cu) and
a plain PyTorch version of the same function:

  * `fused_first_stage`: encoder stage 0 from the one-hot input, replacing
    `fused_first_stage_packed`;
  * `fused_conv_chain`: encoder stages 1-6, replacing
    `fused_conv_chain_packed`.

Both read and write plain channels-last (R, L, C) tensors. Every conv adds
its bias to an fp32 sum, applies its ReLU, zeroes the positions outside the
row's [vs, ve) and rounds to the I/O dtype; the output is the last conv plus
the residual conv, max-pooled by `out_pool` (floor length).

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor takes
the plain version. The kernels have no backward: a tensor that requires grad
is refused on the card. Each public function counts its kernel launches in its
`launches` attribute. bf16 runs on the tensor cores (wgmma) and takes 64, 96
or 128 channels. fp32 runs on the CUDA cores, by output width: at 64 and 96
channels (stages 0-1, nearly all the fp32 FLOPs) each conv is one pass of
the block's 256 threads, a micro-tile of PT positions x C / 8 channels each,
with the weights streamed through shared memory; every other width takes
the general template, which hands out small work items in rounds and
reads its weights through L1/L2.

Tiles: one CUDA block computes T output positions of one row. `plan_tile`
picks T per launch from (rows, length, pool) and the channel widths: the
largest multiple of 8 and of the pool, within the design's largest tile and
the shared memory a block may hold, that still launches a full wave of
blocks, and never below 16 positions. Each conv runs over tile + 24
positions at most. In bf16 the largest tile is what the two warpgroups can
hold in fp32 accumulators (m64 tiles of rows: 512 rows at 64 channels, 256
at 96-128). In fp32 at 64 and 96 channels it is what one pass covers, 32 PT
- 24 (232 at 64 channels, PT = 8; 168 at 96, PT = 6); at other widths 160.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from orca_tpu_torch.ops import nn_ops

_FP32_TILE = 160  # largest tile of the fp32 template at other widths
# fp32 at 64 and 96 output channels: positions per thread (PT) of the FFMA
# template, whose 256 threads cover 32 PT positions in one pass
_FFMA_PT = {64: 8, 96: 6}
_FFMA_RING = 2 * 9 * 4  # its weight ring: 2 slots of 9 taps x 4 input channels
_MIN_TILE = 16
_SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on sm_90
_HALO = 16  # 4 convs x 4 positions per side
_IM2COL_K = 48  # stage 0's 9 taps x 4 channels, padded to 3 k16 steps
_MMA_WIDTHS = (64, 96, 128)  # channel widths of the bf16 tensor-core kernel
_IO_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_U8 = 2
_lib = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C functions of a library built from csrc/conv_chain.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p] * 8 + [p, p, p] + [i] * 8 + [ctypes.c_longlong, p]
    lib.orca_fused_conv_chain.argtypes = [i, i, p] + common
    lib.orca_fused_first_stage.argtypes = [i, i, i, p] + common
    lib.orca_fused_conv_chain.restype = i
    lib.orca_fused_first_stage.restype = i
    lib.orca_cuda_error_string.argtypes = [i]
    lib.orca_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from orca_tpu_torch.ops.kernels import build

        _lib = declare(build.load("conv_chain"))
    return _lib


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _valid(vs: torch.Tensor, ve: torch.Tensor, length: int, device):
    pos = torch.arange(length, device=device)
    return ((pos[None, :] >= vs[:, None].to(device))
            & (pos[None, :] < ve[:, None].to(device)))[:, :, None]


def fused_conv_chain_plain(x, weights, vs, ve, *, relus, residual_idx=-1,
                           out_pool=1):
    """The chain as separate PyTorch ops: mask the input, then per conv
    `F.conv1d` + bias, ReLU, mask (each rounded to x's dtype); add the
    residual conv's output; max-pool."""
    valid = _valid(vs, ve, x.shape[1], x.device)
    h = torch.where(valid, x, 0)
    lout = None
    for i, ((w, b), relu) in enumerate(zip(weights, relus)):
        h = nn_ops.conv1d(h, w.to(x.dtype), b.to(x.dtype))
        if relu:
            h = nn_ops.relu(h)
        h = torch.where(valid, h, 0)
        if i == residual_idx:
            lout = h
    if lout is not None:
        h = h + lout
    if out_pool > 1:
        h = nn_ops.maxpool1d(h, out_pool)
    return h.contiguous()


def _first_conv_plain(x, conv0, vs, ve):
    w0, b0 = conv0
    dtype = w0.dtype
    h = x.to(dtype) * 0.25 if x.dtype == torch.uint8 else x.to(dtype)
    h = nn_ops.conv1d(h, w0, b0)
    return torch.where(_valid(vs, ve, x.shape[1], x.device), h, 0)


def fused_first_stage_plain(x, conv0, weights, vs, ve, *, relus,
                            residual_idx=-1, out_pool=1):
    """Stage 0 as separate PyTorch ops: the one-hot (uint8 quarter-scale or
    float) 4->C conv `conv0` (input not masked), mask, then the chain."""
    h = _first_conv_plain(x, conv0, vs, ve)
    return fused_conv_chain_plain(h, weights, vs, ve, relus=relus,
                                  residual_idx=residual_idx, out_pool=out_pool)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------


def _max_tile(c: int, dtype: torch.dtype) -> int:
    if dtype == torch.bfloat16:
        # 2 warpgroups x 4 m64 tiles of rows at 64 channels, x 2 at
        # 96-128; conv 0 covers tile + 24 rows
        return (512 if c == 64 else 256) - 24
    if c in _FFMA_PT:
        # one pass of 32 PT positions covers conv 0's tile + 24
        return 32 * _FFMA_PT[c] - 24
    return _FP32_TILE


def smem_bytes(cin: int, c: int, tile: int, dtype: torch.dtype,
               first: bool = False) -> int:
    """Dynamic shared memory of one block (the kernel checks it equals its
    own count). bf16: two activation buffers of tile + 33 rows, and a
    two-slot ring of one tap's weights; fp32: two activation buffers of
    tile + 32 and tile + 24 positions, and at 64 and 96 channels a two-slot
    ring of 4 input channels' weights (9 taps x 4 x C floats a slot)."""
    cmax = max(cin, c)
    if dtype == torch.bfloat16:
        k0 = _IM2COL_K if first else cin
        return 2 * (tile + 2 * _HALO + 1) * cmax * 2 + 2 * max(k0, c) * c * 2
    a = -(-(tile + 2 * _HALO) * cmax // 8) * 8
    ring = _FFMA_RING * c if c in _FFMA_PT else 0
    return (a + (tile + 2 * _HALO - 8) * c + ring) * 4


def plan_tile(rows: int, length: int, pool: int, cin: int, c: int,
              dtype: torch.dtype, first: bool = False, sms: int = 132) -> int:
    """Output positions per block: the largest multiple of lcm(8, pool)
    within the design's largest tile and the shared-memory limit that gives
    at least `sms` blocks; else the smallest candidate (at least 16)."""
    base = math.lcm(8, pool)
    smallest = base * -(-_MIN_TILE // base)
    top = max(smallest, _max_tile(c, dtype) // base * base)
    cands = [t for t in range(top, smallest - 1, -base)
             if smem_bytes(cin, c, t, dtype, first) <= _SMEM_LIMIT]
    if not cands:
        raise ValueError(f"no tile fits shared memory for {cin=} {c=} {pool=}")
    for t in cands:
        if rows * -(-length // t) >= sms:
            return t
    return cands[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_chain(x, convs, vs, ve, relus, io_dtype, cin,
                 first) -> Tuple[int, int]:
    """Validate a 4-conv chain for the kernel; returns (relu_mask, C)."""
    if len(convs) != 4 or len(relus) != 4:
        raise ValueError("the CUDA kernel runs chains of exactly 4 convs")
    if any(t.requires_grad for t in (x, *(t for wb in convs for t in wb))):
        raise ValueError("the CUDA kernel has no backward: pass tensors that "
                         "do not require grad (frozen weights, under "
                         "torch.no_grad())")
    c = convs[0][0].shape[-1]
    for k, (w, b) in enumerate(convs):
        want = (9, cin if k == 0 else c, c)
        if tuple(w.shape) != want or tuple(b.shape) != (c,):
            raise ValueError(f"conv {k}: weight {tuple(w.shape)} bias "
                             f"{tuple(b.shape)}, want {want} and ({c},)")
        for t in (w, b):
            if t.dtype != io_dtype or t.device != x.device:
                raise ValueError("weights must share the I/O dtype and device")
            if not t.is_contiguous():
                raise ValueError("weights must be contiguous")
    if cin % 4 or c % 4:
        raise ValueError("channel counts must be multiples of 4")
    if io_dtype == torch.bfloat16:
        # the wgmma shapes (N = C) and the k steps over Cin it is built for
        if c not in _MMA_WIDTHS:
            raise ValueError(f"the bf16 kernel takes {_MMA_WIDTHS} output "
                             f"channels, got {c}")
        if (cin != 4) if first else cin not in _MMA_WIDTHS:
            want = "4" if first else str(_MMA_WIDTHS)
            raise ValueError(f"the bf16 kernel takes {want} input channels, "
                             f"got {cin}")
    r = x.shape[0]
    for t in (vs, ve):
        if t.dtype != torch.int32 or t.device != x.device or tuple(t.shape) != (r,):
            raise ValueError("vs/ve must be (R,) int32 tensors on x's device")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (R, L, C) tensor")
    # the kernels read 4 channels per load (float4 / 2x bfloat162 / uchar4);
    # the bf16 kernel copies weights and chain inputs 16 bytes at a time
    for t in (x, *(t for wb in convs for t in wb)):
        align = 4 * t.element_size()
        if io_dtype == torch.bfloat16 and (t is not x or not first):
            align = 16
        if t.data_ptr() % align:
            raise ValueError(f"x and the weights must be aligned to {align} "
                             "bytes")
    return sum(1 << k for k, relu in enumerate(relus) if relu), c


def _launch(counted, fn, lead, x, convs, vs, ve, relu_mask, residual,
            out_pool, c, io_dtype, first):
    """Launch `fn` and add one to `counted.launches` (no launch, no count,
    for an empty output)."""
    r, length, cin = x.shape
    y = torch.empty((r, length // out_pool, c), dtype=io_dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    ptrs = []
    for w, b in convs:
        ptrs += [w.data_ptr(), b.data_ptr()]
    index = x.device.index
    if index is None:
        index = torch.cuda.current_device()
    tile = plan_tile(r, length, out_pool, cin, c, io_dtype, first,
                     _sm_count(index))
    err = fn(
        index, *lead, x.data_ptr(), *ptrs, vs.data_ptr(), ve.data_ptr(),
        y.data_ptr(), r, length, cin, c, tile, out_pool, relu_mask, residual,
        smem_bytes(cin, c, tile, io_dtype, first),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        msg = _kernels().orca_cuda_error_string(err).decode()
        raise RuntimeError(f"conv chain kernel launch failed: {msg}")
    counted.launches += 1
    return y


def fused_conv_chain(x: torch.Tensor, weights: Sequence, vs: torch.Tensor,
                     ve: torch.Tensor, *, relus: Sequence[bool],
                     residual_idx: int = -1, out_pool: int = 1):
    """Chain of k=9 'same' convs with per-conv bias, ReLU and [vs, ve)
    masking, optional residual and fused max-pool.

    x: (R, L, Cin) bf16/fp32; weights: ((w (9, Cin_k, C), b (C,)), ...) in
    chain order; vs, ve: (R,) int32 valid range at this resolution. Returns
    (R, L // out_pool, C) in x's dtype. The CUDA kernel takes 4 convs with
    residual_idx -1 or 1 (the encoder's chain stages)."""
    if not x.is_cuda:
        return fused_conv_chain_plain(x, weights, vs, ve, relus=relus,
                                      residual_idx=residual_idx,
                                      out_pool=out_pool)
    io_dtype = x.dtype
    if io_dtype not in _IO_KINDS:
        raise ValueError(f"unsupported dtype {io_dtype}")
    if residual_idx not in (-1, 1):
        raise ValueError("the CUDA kernel takes residual_idx -1 or 1")
    relu_mask, c = _check_chain(x, list(weights), vs, ve, relus, io_dtype,
                                x.shape[2], False)
    return _launch(fused_conv_chain, _kernels().orca_fused_conv_chain,
                   (_IO_KINDS[io_dtype],), x, list(weights), vs, ve,
                   relu_mask, int(residual_idx == 1), out_pool, c, io_dtype,
                   False)


fused_conv_chain.launches = 0


def fused_first_stage(x: torch.Tensor, conv0, weights: Sequence,
                      vs: torch.Tensor, ve: torch.Tensor, *,
                      relus: Sequence[bool], residual_idx: int = -1,
                      out_pool: int = 1):
    """Encoder stage 0: the one-hot's 4->C k=9 conv `conv0` (no ReLU, input
    not masked), masked, then the chain `weights` as in fused_conv_chain
    (`relus` and `residual_idx` index the chain after conv0).

    x: (R, L, 4) uint8 quarter-scale one-hot (x 0.25) or float in the
    parameter dtype. Returns (R, L // out_pool, C) in the parameter dtype. The
    CUDA kernel takes 3 chain convs with residual_idx -1 or 0."""
    if not x.is_cuda:
        return fused_first_stage_plain(x, conv0, weights, vs, ve, relus=relus,
                                       residual_idx=residual_idx,
                                       out_pool=out_pool)
    io_dtype = conv0[0].dtype
    if io_dtype not in _IO_KINDS:
        raise ValueError(f"unsupported dtype {io_dtype}")
    if x.dtype == torch.uint8:
        in_kind = _U8
    elif x.dtype == io_dtype:
        in_kind = 0
    else:
        raise ValueError(f"input dtype {x.dtype} must be uint8 or {io_dtype}")
    if residual_idx not in (-1, 0):
        raise ValueError("the CUDA kernel takes residual_idx -1 or 0")
    convs = [conv0, *weights]
    relu_mask, c = _check_chain(x, convs, vs, ve, (False, *relus), io_dtype,
                                x.shape[2], True)
    return _launch(fused_first_stage, _kernels().orca_fused_first_stage,
                   (in_kind, _IO_KINDS[io_dtype]), x, convs, vs, ve,
                   relu_mask, int(residual_idx == 0), out_pool, c, io_dtype,
                   True)


fused_first_stage.launches = 0
