"""The plain reference: Orca's 32 Mb and 256 Mb models and their zoom
cascades in plain PyTorch.

The modules are Orca's own (jzhoulab/orca `orca_models.py`: the bp -> 4 kb
encoder of `Net`, `Decoder_1m`, `Encoder2`/`Encoder3` pyramids, `Decoder`),
written here as `torch.nn` containers so that `load_state_dict` holds a
statedict to the released key layout. The forward is written out below in
plain torch functional calls, channels first, so that every convolution can
run in a stated precision:

  * "fp32": float32 with TF32 off (the reference);
  * "tf32": float32 convolutions with TF32 on (the control of a float32 cell);
  * "fp8":  every convolution's input and weight rounded to float8 e4m3 with
    a per-tensor scale, computed in float32 (the control of a bfloat16 cell);
  * "bf16": every convolution's input and weight rounded to bfloat16,
    computed in float32: how far bfloat16 rounding alone moves this model's
    maps, the scale a bfloat16 cell's gap is read against.

The 256 Mb backgrounds' block averages take float64 in the reference and
under "bf16", and one step below the program's float32 in a control:
float32 under "tf32", bfloat16 under "fp8".

BatchNorm is folded into the convolution before it, in float64. The encoder
tower runs in blocks with a halo wider than its receptive field; a block at
the window's edge simply ends there, so each convolution's zero padding is
the monolithic model's. This file imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (cin, cout, pool before the stage) of the encoder tower's seven stages
TOWER = ((4, 64, 0), (64, 96, 4), (96, 128, 4), (128, 128, 5), (128, 128, 5),
         (128, 128, 5), (128, 128, 2))
BIN_BP = 4000
DILATIONS = (1, 2, 4, 8, 16, 32, 64) * 4
DILATIONS_1M = (1, 2, 4, 8, 16, 32, 64) + (2, 4, 8, 16, 32, 64) * 2
TOWER_BLOCK_BP = 4_000_000
TOWER_HALO_BP = 128_000  # > the tower's receptive field, 104,016 bp a side
PRECISIONS = ("fp32", "tf32", "fp8", "bf16")
BACKGROUND_DTYPE = {"fp32": torch.float64, "tf32": torch.float32,
                    "fp8": torch.bfloat16, "bf16": torch.float64}
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _pair1d(cin, cout, relu, pool=0, upsample=0, second_bn=True):
    mods = []
    if pool:
        mods.append(nn.MaxPool1d(pool, pool))
    if upsample:
        mods.append(nn.Upsample(scale_factor=upsample))
    mods += [nn.Conv1d(cin, cout, 9, padding=4), nn.BatchNorm1d(cout)]
    if relu:
        mods.append(nn.ReLU())
    mods.append(nn.Conv1d(cout, cout, 9, padding=4))
    if second_bn:
        mods.append(nn.BatchNorm1d(cout))
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def _pair2d(cin, cmid, cout, d, relu, dropout=False):
    mods = [nn.Dropout(0.1)] if dropout else []
    mods += [nn.Conv2d(cin, cmid, 3, padding=d, dilation=d),
             nn.BatchNorm2d(cmid)]
    if relu:
        mods.append(nn.ReLU())
    mods += [nn.Conv2d(cmid, cout, 3, padding=d, dilation=d),
             nn.BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def _plain2d(cin, cout, relu, dropout=False):
    """Orca's combiner motif: two 3x3 convs, each with BatchNorm."""
    mods = [nn.Dropout(0.1)] if dropout else []
    mods += [nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    mods += [nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def _head():
    return nn.Sequential(nn.Conv2d(64, 5, 1), nn.BatchNorm2d(5), nn.ReLU(),
                         nn.Conv2d(5, 1, 1))


class Net0(nn.Module):
    """The stage-a `Net` file (`orca_<name>.net0`): the bp -> 4 kb encoder
    tower (lconv1-7, conv1-7) and `Decoder_1m` (lconvtwos, convtwos,
    final)."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout, pool) in enumerate(TOWER):
            setattr(self, f"lconv{i + 1}", _pair1d(cin, cout, False, pool))
            setattr(self, f"conv{i + 1}", _pair1d(cout, cout, True))
        self.lconvtwos = nn.ModuleList(
            _pair2d(128 if i == 0 else 64, 32, 64, d, False, dropout=i == 0)
            for i, d in enumerate(DILATIONS_1M))
        self.convtwos = nn.ModuleList(_pair2d(64, 32, 64, d, True)
                                      for d in DILATIONS_1M)
        self.final = _head()


class Pyramid(nn.Module):
    """`Encoder2` (5 levels, 4 kb -> 128 kb) or `Encoder3` (3 levels,
    128 kb -> 1024 kb), with the upward pass."""

    def __init__(self, levels: int):
        super().__init__()
        self.lblocks = nn.ModuleList(_pair1d(128, 128, False, pool=2)
                                     for _ in range(levels))
        self.blocks = nn.ModuleList(_pair1d(128, 128, True)
                                    for _ in range(levels))
        self.downlblocks = nn.ModuleList(_pair1d(128, 128, False, upsample=2)
                                         for _ in range(levels))
        self.downblocks = nn.ModuleList(_pair1d(128, 128, True,
                                                second_bn=False)
                                        for _ in range(levels))


class Decoder(nn.Module):
    """One level's `Decoder` (`orca_<name>.d<level>`)."""

    def __init__(self):
        super().__init__()
        self.lconvtwos = nn.ModuleList(_pair2d(64, 32, 64, d, False,
                                               dropout=i == 0)
                                       for i, d in enumerate(DILATIONS))
        self.convtwos = nn.ModuleList(_pair2d(64, 32, 64, d, True)
                                      for d in DILATIONS)
        self.final = _head()
        self.lcombiner = _plain2d(65, 64, False, dropout=True)
        self.combiner = _plain2d(64, 64, True)
        self.lcombinerD = _plain2d(129, 64, False)
        self.combinerD = _plain2d(64, 64, True)


def model_files(family: str, levels) -> Dict[str, nn.Module]:
    """The statedict files of one model, by their name in Orca's release,
    as empty modules on the meta device: '32m' -> net0, net, d<level>;
    '256m' -> net0, net (the 32 Mb model's), 256m.net, 256m.d<level>."""
    with torch.device("meta"):
        files = {"net0": Net0(), "net": Pyramid(5)}
        if family == "32m":
            files.update({f"d{lv}": Decoder() for lv in levels})
        elif family == "256m":
            files["256m.net"] = Pyramid(3)
            files.update({f"256m.d{lv}": Decoder() for lv in levels})
        else:
            raise ValueError(f"no Orca model family {family!r}")
    return files


def statedict_shapes(family: str, levels) -> Dict[str, Dict[str, tuple]]:
    """file -> key -> shape of a model's statedicts (keys without the
    'module.' prefix)."""
    return {name: {k: tuple(v.shape) for k, v in m.state_dict().items()}
            for name, m in model_files(family, levels).items()}


# --------------------------------------------------------------------------
# Loading and BatchNorm folding
# --------------------------------------------------------------------------


def _fold(seq: nn.Sequential) -> List[nn.Module]:
    """The Sequential's layers with every BatchNorm folded into the conv
    before it (float64 arithmetic, rounded to float32)."""
    out = []
    for m in seq:
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            conv = out[-1]
            g = (m.weight.double()
                 / torch.sqrt(m.running_var.double() + m.eps))
            shape = (-1,) + (1,) * (conv.weight.dim() - 1)
            w = conv.weight.double() * g.reshape(shape)
            b = (conv.bias.double() - m.running_mean.double()) * g \
                + m.bias.double()
            conv.weight.data = w.float()
            conv.bias.data = b.float()
            continue
        out.append(m)
    return out


def load(family: str, levels, statedicts: Dict[str, dict], device):
    """The model's modules on `device`, loaded (strictly) from `statedicts`
    (file name -> statedict, keys with or without 'module.') and folded:
    file name -> {attribute path -> folded layer list}."""
    loaded = {}
    for name, module in model_files(family, levels).items():
        sd = {k[7:] if k.startswith("module.") else k: v
              for k, v in statedicts[name].items()}
        module = module.to_empty(device=device)
        module.load_state_dict(sd, strict=True)
        folded = {}
        for path, sub in module.named_modules():
            if isinstance(sub, nn.Sequential):
                folded[path] = _fold(sub)
        loaded[name] = folded
    return loaded


# --------------------------------------------------------------------------
# Precision
# --------------------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def _tf32(on: bool):
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


class Forward:
    """Runs folded layer lists in one precision (PRECISIONS)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def conv(self, x, m):
        w = m.weight
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        elif self.precision == "bf16":
            x, w = x.bfloat16().float(), w.bfloat16().float()
        with _tf32(self.precision == "tf32"):
            if isinstance(m, nn.Conv1d):
                return F.conv1d(x, w, m.bias, padding=m.padding,
                                dilation=m.dilation)
            return F.conv2d(x, w, m.bias, padding=m.padding,
                            dilation=m.dilation)

    def seq(self, layers, x):
        for m in layers:
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                x = self.conv(x, m)
            elif isinstance(m, nn.MaxPool1d):
                x = F.max_pool1d(x, m.kernel_size, m.stride)
            elif isinstance(m, nn.Upsample):
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif isinstance(m, nn.ReLU):
                x = F.relu(x)
            elif not isinstance(m, nn.Dropout):  # eval: dropout is identity
                raise TypeError(f"unexpected layer {m}")
        return x

    # ---- encoders (N, C, L) -------------------------------------------

    def tower(self, net0, x):
        """Orca's encoder on a one-hot (N, 4, L) float32: each stage adds
        its conv pair's output to its lconv pair's; the tower returns the
        last conv pair's output alone."""
        out = x
        for i in range(len(TOWER)):
            lout = self.seq(net0[f"lconv{i + 1}"], out)
            cout = self.seq(net0[f"conv{i + 1}"], lout)
            out = cout + lout
        return cout

    def tower_blocked(self, net0, packed: torch.Tensor,
                      block_bp: int = TOWER_BLOCK_BP,
                      halo_bp: int = TOWER_HALO_BP) -> torch.Tensor:
        """The tower over (N, L, 4) packed quarter-scale uint8 rows, in
        blocks of `block_bp` with `halo_bp` each side (clipped at the
        window's edges) -> (N, 128, L / 4000)."""
        length = packed.shape[1]
        outs = []
        for s in range(0, length, block_bp):
            e = min(length, s + block_bp)
            a, b = max(0, s - halo_bp), min(length, e + halo_bp)
            x = packed[:, a:b].float().mul_(0.25).transpose(1, 2)
            y = self.tower(net0, x.contiguous())
            outs.append(y[:, :, (s - a) // BIN_BP:(e - a) // BIN_BP])
        return torch.cat(outs, dim=2)

    def pyramid(self, p, x, levels: int):
        """`levels + 1` encodings, finest first: the down pass halves the
        resolution a level, the up pass doubles it back and adds the down
        pass's encoding of that resolution."""
        out = x
        downs = [out]
        for i in range(levels):
            lout = self.seq(p[f"lblocks.{i}"], out)
            out = self.seq(p[f"blocks.{i}"], lout) + lout
            downs.append(out)
        ups = [out]
        for i in range(levels):
            lout = self.seq(p[f"downlblocks.{i}"], out)
            out = self.seq(p[f"downblocks.{i}"], lout) + lout
            out = downs[levels - 1 - i] + out
            ups.append(out)
        return ups[::-1]

    # ---- decoders (N, C, H, W) ----------------------------------------

    @staticmethod
    def _pairwise(x):
        return x[:, :, :, None] + x[:, :, None, :]

    @staticmethod
    def _symmetric(m):
        return 0.5 * m + 0.5 * m.transpose(2, 3)

    def decoder(self, d, x, distenc, coarse=None):
        """Orca's `Decoder`: x (N, 128, crop), distenc (N, 1, crop, crop),
        coarse (N, 1, crop/2, crop/2) or None -> (N, 1, crop, crop)."""
        mat = torch.cat([self._pairwise(x), distenc], dim=1)
        mat = self.seq(d["lcombinerD"], mat)
        mat = self.seq(d["combinerD"], mat) + mat
        if coarse is not None:
            up = F.interpolate(coarse, scale_factor=2, mode="bilinear",
                               align_corners=False)
            mat = torch.cat([mat, up], dim=1)
        cur = mat
        for i in range(len(DILATIONS)):
            if i == 0 and coarse is not None:
                cur = self.seq(d["lcombiner"], cur)
                cur = self.seq(d["combiner"], cur) + cur
                continue
            lout = self.seq(d[f"lconvtwos.{i}"], cur)
            cur = lout if i == 0 else lout + cur
            cur = self.seq(d[f"convtwos.{i}"], cur) + cur
        return self._symmetric(self.seq(d["final"], cur))

    def decoder1m(self, net0, x):
        """`Decoder_1m` on x (N, 128, crop) -> (N, 1, crop, crop)."""
        cur = self._pairwise(x)
        for i in range(len(DILATIONS_1M)):
            lout = self.seq(net0[f"lconvtwos.{i}"], cur)
            cur = lout if i == 0 else lout + cur
            cur = self.seq(net0[f"convtwos.{i}"], cur) + cur
        return self._symmetric(self.seq(net0["final"], cur))


# --------------------------------------------------------------------------
# Backgrounds
# --------------------------------------------------------------------------


def normmats_32m(expected_log: np.ndarray, levels, nbins: int, crop: int):
    """Per level, the (crop, crop) block average of the distance background
    exp(expected_log[|i - j|]) over the window's top-left crop * level
    finest bins (float64)."""
    out = {}
    for level in levels:
        n = crop * level
        d = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        mat = np.exp(expected_log[d])
        out[level] = mat.reshape(crop, level, crop, level).mean(axis=(1, 3))
    return out


def filled_background(normmat: np.ndarray) -> np.ndarray:
    """The mosaic background as float32 with NaNs set to its least value."""
    m = np.array(normmat, dtype=np.float32)
    nan = np.isnan(m)
    if nan.any():
        m[nan] = m[~nan].min() if (~nan).any() else 1.0
    return m


# --------------------------------------------------------------------------
# Zoom arithmetic: float32 tensor arithmetic on the reference's device, in
# the order of the JAX package's cascades (whose floor and ceil the port
# keeps), so that a start lands on the same bin where an exact computation
# would sit on a bin edge.
# --------------------------------------------------------------------------


def zoom_index_32m(level, mpos, wpos, start_bins, window_bp, bin_bp, crop):
    """(forward, reverse-complement) zoom indices in [0, crop/2]."""
    span4 = crop * bin_bp * level / 4.0
    halfwin = window_bp / 2.0
    binw = float(bin_bp)
    fwd = torch.floor(((mpos - span4)
                       - (wpos - halfwin + start_bins[:1] * binw))
                      / (binw * level))
    rc = torch.ceil(((wpos + halfwin - start_bins[1:] * binw)
                     - (mpos + span4)) / (binw * level))
    return torch.clamp(torch.cat([fwd, rc]), 0, crop // 2).to(torch.int32)


def zoom_index_256m(factor, mpos, wpos, chrlen, start_bins, window_bp,
                    bin_bp, crop):
    """(forward, reverse-complement) zoom indices, proposals clamped to the
    first chromosome, the reverse complement's mirrored."""
    halfwin = window_bp / 2.0
    binw = float(bin_bp)
    fac = torch.tensor(factor, dtype=torch.float32, device=start_bins.device)
    span = crop * bin_bp * fac
    prop_f = (mpos - span / 4) - (wpos - halfwin + start_bins[:1] * binw)
    prop_r = (mpos - span / 4) - (wpos + halfwin - start_bins[1:] * binw
                                  - span)
    lo = 0.0 - (wpos - halfwin)
    hi = chrlen - span / 2 - (wpos - halfwin)

    def index(prop):
        prop = torch.where(lo < hi, torch.minimum(torch.maximum(prop, lo), hi),
                           lo)
        return torch.clamp(torch.floor(prop / (binw * fac)), 0,
                           crop // 2).to(torch.int32)

    return torch.cat([index(prop_f), crop - (index(prop_r) + crop // 2)])


# --------------------------------------------------------------------------
# Cascades
# --------------------------------------------------------------------------


def _scalars(device, *values):
    return [torch.tensor(v, dtype=torch.float32, device=device)
            for v in values]


def _crop_enc(enc, starts, crop):
    return torch.stack([enc[r, :, s:s + crop] for r, s in enumerate(starts)])


def _crop_sq(pred, starts, size):
    return torch.stack([pred[r, :, s:s + size, s:s + size]
                        for r, s in enumerate(starts)])


def _combine(pred):
    return (0.5 * pred[0, 0] + 0.5 * torch.flip(pred[1, 0], dims=(0, 1)))


@torch.no_grad()
def cascade_32m(model, packed: torch.Tensor, mpos: int, wpos: int,
                expected_log: np.ndarray, geom: dict, fwd: Forward):
    """One model's 32 Mb request: `packed` (1, L, 4) uint8 on the device.
    Returns (maps coarsest first, each (crop, crop) float32 numpy; start
    coordinates; end coordinates), as `genomepredict` reports them."""
    window, bin_bp, crop = geom["window_bp"], geom["bin_bp"], geom["crop"]
    levels = sorted(geom["levels"], reverse=True)
    device = packed.device
    net0, pyr = model["net0"], model["net"]
    rows = torch.cat([packed, torch.flip(packed, dims=(1, 2))])
    feats = fwd.tower_blocked(net0, rows)
    encs = dict(zip(sorted(levels), fwd.pyramid(pyr, feats, 5)))
    nms = normmats_32m(expected_log, levels, window // bin_bp, crop)
    mpos_t, wpos_t = _scalars(device, mpos, wpos)
    start_bins = torch.zeros(2, dtype=torch.int32, device=device)
    coarse, maps, starts = None, [], []
    for level in levels:
        sb = start_bins.tolist()
        starts.append(sb[0])
        x = _crop_enc(encs[level], [s // level for s in sb], crop)
        distenc = torch.log(torch.as_tensor(nms[level], device=device)
                            ).float()[None, None].expand(2, 1, crop, crop)
        pred = fwd.decoder(model[f"d{level}"], x, distenc, coarse)
        if level == 1:
            pred = pred + fwd.decoder1m(net0, x)
        idx = zoom_index_32m(level, mpos_t, wpos_t, start_bins, window,
                             bin_bp, crop)
        start_bins = start_bins + idx * level
        coarse = _crop_sq(pred, idx.tolist(), crop // 2)
        maps.append(_combine(pred).float().cpu().numpy())
    start_coords = [int(wpos - window // 2 + s * bin_bp) for s in starts]
    end_coords = [int(start_coords[j] + window / 2 ** j)
                  for j in range(len(levels))]
    return maps, start_coords, end_coords


def _block_average(normmat, s, factor, crop):
    n = crop * factor
    return normmat[s:s + n, s:s + n].reshape(crop, factor, crop,
                                             factor).mean(dim=(1, 3))


@torch.no_grad()
def cascade_256m(model, packed: torch.Tensor, mpos: int, wpos: int,
                 chrlen: int, normmat: np.ndarray, geom: dict, fwd: Forward):
    """One model's 256 Mb request. Returns (maps coarsest first; the
    forward row's background of each level; start coordinates; end
    coordinates), as `genomepredict_256mb` reports them."""
    window, bin_bp, crop = geom["window_bp"], geom["bin_bp"], geom["crop"]
    levels = sorted(geom["levels"], reverse=True)
    device = packed.device
    bins = window // bin_bp
    net0 = model["net0"]
    rows = torch.cat([packed, torch.flip(packed, dims=(1, 2))])
    feats = fwd.tower_blocked(net0, rows)
    enc128k = fwd.pyramid(model["net"], feats, 5)[-1]
    encs = dict(zip(sorted(levels), fwd.pyramid(model["256m.net"], enc128k,
                                                3)))
    nm = torch.as_tensor(filled_background(normmat), device=device).to(
        BACKGROUND_DTYPE[fwd.precision])
    mpos_t, wpos_t, chrlen_t = _scalars(device, mpos, wpos, chrlen)
    start_bins = torch.zeros(2, dtype=torch.int32, device=device)
    coarse, maps, backgrounds, starts = None, [], [], []
    for j, level in enumerate(levels):
        factor = bins // (crop * 2 ** j)
        sb = start_bins.tolist()
        starts.append(sb[0])
        nm_r = torch.stack([_block_average(nm, s, factor, crop) for s in sb])
        backgrounds.append(nm_r[0].float().cpu().numpy())
        x = _crop_enc(encs[level], [s // factor for s in sb], crop)
        distenc = torch.log(nm_r.double()).float()
        distenc = torch.stack([distenc[0], torch.flip(distenc[1], (0, 1))])
        pred = fwd.decoder(model[f"256m.d{level}"], x, distenc[:, None],
                           coarse)
        idx = zoom_index_256m(factor, mpos_t, wpos_t, chrlen_t, start_bins,
                              window, bin_bp, crop)
        start_bins = start_bins + idx * factor
        coarse = _crop_sq(pred, idx.tolist(), crop // 2)
        maps.append(_combine(pred).float().cpu().numpy())
    start_coords = [int(wpos - window // 2 + s * bin_bp) for s in starts]
    end_coords = [int(min(start_coords[j] + window / 2 ** j, chrlen))
                  for j in range(len(levels))]
    return maps, backgrounds, start_coords, end_coords
