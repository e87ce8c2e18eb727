"""The multiscale zoom-in cascades (counterpart of
orca_tpu/predict/multiscale.py): `genomepredict` (32 Mb) and
`genomepredict_256mb` (256 Mb).

One window runs forward and reverse-complement as one batch: the encoder
tower and pyramid once, then one decoder level per resolution from the
coarsest down, each on a crop of the encodings chosen by the zoom target and
refining the crop of its parent's prediction. The 32 Mb cascade has six
levels (32 down to 1, the Decoder_1m head added at level 1) and one shared
background per level; the 256 Mb cascade has four (256 down to 32), a
background block-averaged per row from the region mosaic's matrix, and zoom
proposals clamped to the first chromosome. The two orientations are averaged
at the end.

The cascades carry the program's spans (`utils.profiling`, off unless
enabled): `orca.input_copy` and `orca.background_copy` (with the counter
`h2d_bytes`), `orca.background_fill`, `orca.tower`, `orca.pyramid`,
`orca.decode.<level>` (one level of the loop, per model) and `orca.sync`
(each host wait on the card: a fetch, or a copy of host values to the card,
which waits for the work queued before it).

On a CUDA card under inference mode each decoder level replays a CUDA graph
(`_LevelGraphs`): captured on the first call with its key, replayed on every
later one, counted by `decode_graph_captures` and `decode_graph_replays`.
Training, autograd and CPU tensors run the same code eagerly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from orca_tpu_torch.models.zoo import LEVELS_256M, Model256MBundle, ModelBundle
from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.parallel.mesh import Mesh, get_inference_mesh
from orca_tpu_torch.parallel.sequence import sharded_encoder_tower
from orca_tpu_torch.utils import profiling
from orca_tpu_torch.utils.config import get_config, resolve_device

BINS = 8000  # 4 kb bins in a 32 Mb window
CROP = 250
HALF = 125
LEVEL_ORDER = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class CascadeGeometry:
    """Static shape parameters of a zoom cascade: the production values are
    a 32 Mb window at 4 kb bins with 250-bin decoder crops; smaller ones run
    the same cascade in tests."""

    window_bp: int = 32_000_000
    bin_bp: int = 4000  # finest-level bin size in bp
    crop: int = 250  # decoder input size in bins

    @property
    def bins(self) -> int:
        return self.window_bp // self.bin_bp

    @property
    def half(self) -> int:
        return self.crop // 2

    def span_bp(self, m: int) -> int:
        """Window span of a level whose bins are `m` finest bins wide."""
        return self.crop * self.bin_bp * m


GEOM_32M = CascadeGeometry(32_000_000, 4000, 250)
GEOM_256M = CascadeGeometry(256_000_000, 32000, 250)


def _device_sequence(sequence, device) -> torch.Tensor:
    """The one-hot on `device`, packed as quarter-scale uint8 when exactly
    representable ({0, 0.25, 1} values): 16x less host-to-device traffic.
    Other float inputs pass through unchanged."""
    arr = np.asarray(sequence)
    if arr.dtype != np.uint8:
        q = arr * 4
        if (q.size and q.min() >= 0 and q.max() <= 255
                and np.all(q == np.round(q))):
            arr = q.astype(np.uint8)
        else:
            arr = np.ascontiguousarray(arr)
    with profiling.span("orca.input_copy"):
        profiling.count("h2d_bytes", arr.nbytes)
        return torch.from_numpy(arr).to(device)


def _tower(params: dict, seq: torch.Tensor,
           mesh: Optional[Mesh]) -> torch.Tensor:
    """The bp -> 4 kb encoder tower on the sequence's device, or with a mesh
    sequence-sharded over its 'seq' axis (the encodings gathered back on the
    sequence's device)."""
    halo = get_config().encoder_halo_bp
    with profiling.span("orca.tower"):
        if mesh is None:
            return encoders.apply_encoder_tower(params, seq, halo_bp=halo)
        return sharded_encoder_tower(params, seq, mesh, halo_bp=halo)


def _encode_32mb(bundle: ModelBundle, seq: torch.Tensor,
                 mesh: Optional[Mesh] = None) -> Dict[int, torch.Tensor]:
    """One-hot (N, L, 4) -> encodings at levels 1..32 (finest L/4000 bins);
    with a mesh the tower runs sequence-sharded over it, and the pyramid on
    the bundle's device."""
    feats = _tower(bundle.encoder, seq, mesh)
    with profiling.span("orca.pyramid"):
        encs = encoders.apply_pyramid(bundle.pyramid, feats, levels=5,
                                      up_pass=bundle.pyramid_up_pass)
    return dict(zip(LEVEL_ORDER, encs))


def _zoom_start_index(geom: CascadeGeometry, m: int, mpos: torch.Tensor,
                      wpos: torch.Tensor, start_bins: torch.Tensor,
                      rc: bool) -> torch.Tensor:
    """Zoom-window start in [0, half]; `m` is the level's bin size in finest
    bins. float32 arithmetic on tensors, in the JAX package's order, so the
    floor/ceil lands where it does there."""
    span4 = geom.span_bp(m) / 4.0
    halfwin = geom.window_bp / 2.0
    binw = float(geom.bin_bp)
    if not rc:
        raw = torch.floor(
            ((mpos - span4) - (wpos - halfwin + start_bins * binw)) / (binw * m)
        )
    else:
        raw = torch.ceil(
            ((wpos + halfwin - start_bins * binw) - (mpos + span4)) / (binw * m)
        )
    return torch.clamp(raw, 0, geom.half).to(torch.int32)


def _crop_rows(enc: torch.Tensor, starts: Sequence[int], size: int):
    """Per-row crop along axis 1: (B, L, C) -> (B, size, C)."""
    return torch.stack([e[s : s + size] for e, s in zip(enc, starts)])


def _crop_squares(pred: torch.Tensor, starts: Sequence[int], size: int):
    """Per-row square crop: (B, H, W, C) -> (B, size, size, C)."""
    return torch.stack(
        [p[s : s + size, s : s + size] for p, s in zip(pred, starts)]
    )


def _graph_path(*inputs) -> bool:
    """Whether a decoder level replays its CUDA graph: under inference mode
    (never in training, which records autograd) with every tensor input on
    a CUDA card."""
    return torch.is_inference_mode_enabled() and all(
        x.is_cuda for x in inputs if isinstance(x, torch.Tensor))


def _graph_key(bundle, level: int, *inputs) -> tuple:
    """A level graph's key: the bundle (by identity), the level, and each
    input's device, dtype and shape (a host array's dtype and shape; None
    where no coarse map enters)."""
    def sig(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            return ("host", x.dtype.str, x.shape)
        return (x.device, x.dtype, tuple(x.shape))

    return (id(bundle), level) + tuple(sig(x) for x in inputs)


@dataclasses.dataclass
class _LevelGraph:
    graph: torch.cuda.CUDAGraph
    pool: tuple  # the memory pool it was captured into
    out: torch.Tensor  # the device's static output buffer it writes
    params: tuple  # the parameter trees it reads, kept alive with it
    held: dict  # input index -> (host array, its copy on the card)


class _DeviceGraphs:
    """What a device's level graphs share: one memory pool, a side stream
    to capture on, static buffers by (role, dtype, shape), and the event of
    the last replay."""

    def __init__(self, device: torch.device):
        self.pool = None
        self.side = torch.cuda.Stream(device)
        self.done = torch.cuda.Event()
        self.buffers: Dict[tuple, torch.Tensor] = {}

    def buffer(self, role, like: torch.Tensor) -> torch.Tensor:
        key = (role, like.dtype, tuple(like.shape))
        if key not in self.buffers:
            self.buffers[key] = torch.empty_like(
                like, memory_format=torch.contiguous_format)
        return self.buffers[key]


class _LevelGraphs:
    """The decoder levels' CUDA graphs, one a `_graph_key`, captured on the
    first call that meets the key and replayed on every later one. A
    device's graphs share a memory pool and static buffers, so they never
    run at once: a lock orders copy-in, replay and clone on the host, and
    each replay waits on its stream for the device's previous one."""

    def __init__(self):
        self._lock = threading.RLock()
        self._graphs: Dict[tuple, _LevelGraph] = {}
        self._devices: Dict[torch.device, _DeviceGraphs] = {}

    def run(self, bundle, level: int, fn, params: tuple, *inputs):
        """fn(*inputs) from the level's graph. Tensors are copied into the
        static buffers; a host array (a 32 Mb level's background) is copied
        to the card at capture and again only when it changes. Returns a
        copy of the output that no later replay overwrites."""
        key = _graph_key(bundle, level, *inputs)
        device = next(x.device for x in inputs if isinstance(x, torch.Tensor))
        with self._lock, torch.cuda.device(device):
            dev = self._devices.get(device)
            if dev is None:
                dev = self._devices[device] = _DeviceGraphs(device)
            stream = torch.cuda.current_stream()
            stream.wait_event(dev.done)
            entry = self._graphs.get(key)
            if entry is not None and any(
                    a is not b for a, b in zip(entry.params, params)):
                entry = None
            held = {} if entry is None else entry.held
            static = []
            for i, x in enumerate(inputs):
                if isinstance(x, np.ndarray):
                    if i not in held:
                        held[i] = (x.copy(), torch.as_tensor(x, device=device))
                    elif not np.array_equal(held[i][0], x, equal_nan=True):
                        held[i][1].copy_(torch.from_numpy(x))
                        held[i] = (x.copy(), held[i][1])
                    x = held[i][1]
                elif x is not None:
                    x = dev.buffer(("in", i), x).copy_(x)
                static.append(x)
            if entry is None:
                if all(k[0] != key[0] for k in self._graphs):
                    weakref.finalize(bundle, self._drop,
                                     key[0]).atexit = False
                entry = self._graphs[key] = self._capture(dev, fn, static,
                                                          params, held)
            entry.graph.replay()
            out = entry.out.clone()
            dev.done.record(stream)
        profiling.count("decode_graph_replays", 1)
        return out

    def _capture(self, dev: _DeviceGraphs, fn, static, params,
                 held) -> _LevelGraph:
        """Two eager runs on the side stream (cuDNN's plans and workspaces
        are made outside the graph), then the capture into the device's
        pool: a new one where no live graph holds the last (a pool whose
        graphs are all freed cannot take another)."""
        profiling.count("decode_graph_captures", 1)
        current = torch.cuda.current_stream()
        dev.side.wait_stream(current)
        with torch.cuda.stream(dev.side):
            for _ in range(2):
                out = fn(*static)
            buf = dev.buffer("out", out)
            graph = torch.cuda.CUDAGraph()
            if all(g.pool != dev.pool for g in self._graphs.values()):
                dev.pool = torch.cuda.graph_pool_handle()
            graph.capture_begin(dev.pool, capture_error_mode="thread_local")
            try:
                buf.copy_(fn(*static))
            finally:
                graph.capture_end()
        current.wait_stream(dev.side)
        return _LevelGraph(graph, dev.pool, buf, tuple(params), held)

    def _drop(self, owner: int) -> None:
        """Forget a collected bundle's graphs (an id can be reused)."""
        with self._lock:
            for key in [k for k in self._graphs if k[0] == owner]:
                del self._graphs[key]


_LEVEL_GRAPHS = _LevelGraphs()


def _decode_level(bundle: ModelBundle, geom: CascadeGeometry, level: int,
                  enc_crop, log_nm: np.ndarray, start_bins: torch.Tensor,
                  mpos: torch.Tensor, wpos: torch.Tensor, coarse):
    """One decoder level of the orientation-batched cascade; rows [0, B/2)
    are forward, [B/2, B) reverse complement. Returns (pred, next
    start_bins, next coarse)."""
    b = enc_crop.shape[0]
    n = b // 2
    head = bundle.decoder_1pt if level == 1 else None

    def decode(enc_crop, nm, coarse):
        nm = nm[:, :, None] if nm.dim() == 2 else nm.permute(1, 2, 0)
        distenc = nm[None].expand(b, geom.crop, geom.crop, bundle.num_2d)
        pred = decoders.apply_decoder(
            bundle.decoders[level], enc_crop, distenc, coarse,
            num_2d=bundle.num_2d, upsample_mode=bundle.upsample_mode,
        )
        if head is not None:
            pred = pred + decoders.apply_decoder1m(
                head, enc_crop, num_2d=bundle.num_2d
            )
        return pred

    if _graph_path(enc_crop, coarse):
        pred = _LEVEL_GRAPHS.run(bundle, level, decode,
                                 (bundle.decoders[level], head),
                                 enc_crop, log_nm, coarse)
    else:
        with profiling.span("orca.sync"):
            nm = torch.as_tensor(log_nm, device=enc_crop.device)
        pred = decode(enc_crop, nm, coarse)
    start_index = torch.cat([
        _zoom_start_index(geom, level, mpos, wpos, start_bins[:n], rc=False),
        _zoom_start_index(geom, level, mpos, wpos, start_bins[n:], rc=True),
    ])
    next_start = start_bins + start_index * level
    with profiling.span("orca.sync"):
        rows = start_index.tolist()
    coarse_next = _crop_squares(pred, rows, geom.half)
    return pred, next_start, coarse_next


def _combine_orientations(pred: torch.Tensor) -> torch.Tensor:
    n = pred.shape[0] // 2
    return (0.5 * pred[:n] + 0.5 * torch.flip(pred[n:], dims=(1, 2))).float()


def _cascade_32mb(bundle: ModelBundle, geom: CascadeGeometry, seq, mpos, wpos,
                  log_normmats: np.ndarray, mesh: Optional[Mesh] = None):
    """Full fwd+RC cascade; returns (stacked (6, N, crop, crop, C) float32,
    starts (6,) int32) on the sequence's device. With a mesh the encoder
    tower runs sequence-sharded over it."""
    n = seq.shape[0]
    seq2 = torch.cat([seq, torch.flip(seq, dims=(1, 2))])
    encs = _encode_32mb(bundle, seq2, mesh)
    device = seq.device
    start_bins = torch.zeros(2 * n, dtype=torch.int32, device=device)
    with profiling.span("orca.sync"):
        mpos = torch.tensor(mpos, dtype=torch.float32, device=device)
        wpos = torch.tensor(wpos, dtype=torch.float32, device=device)
    coarse = None
    preds, starts = [], []
    for j, level in enumerate(sorted(bundle.decoders, reverse=True)):
        with profiling.span("orca.decode", level):
            starts.append(start_bins[:n])
            with profiling.span("orca.sync"):
                rows = (start_bins // level).tolist()
            enc_crop = _crop_rows(encs[level], rows, geom.crop)
            pred, start_bins, coarse = _decode_level(
                bundle, geom, level, enc_crop, log_normmats[j], start_bins,
                mpos, wpos, coarse,
            )
            preds.append(_combine_orientations(pred))
    return torch.stack(preds), torch.stack([s[0] for s in starts])


def _warmup_dtype(seq_dtype) -> torch.dtype:
    """A warm-up's `seq_dtype` as a torch dtype: a torch dtype, or anything
    numpy reads as one (np.uint8, "float32", a JAX scalar type); uint8 is
    the packed quarter-scale one-hot, a float dtype the one-hot itself."""
    if isinstance(seq_dtype, torch.dtype):
        dtype = seq_dtype
    else:
        try:
            name = np.dtype(seq_dtype).name
        except TypeError:
            name = str(seq_dtype)
        dtype = getattr(torch, name, None)
    if dtype != torch.uint8 and not (isinstance(dtype, torch.dtype)
                                     and dtype.is_floating_point):
        raise ValueError(f"seq_dtype={seq_dtype!r}: a window is uint8 "
                         "(packed) or a float one-hot")
    return dtype


def _zero_window(geometry: CascadeGeometry, device, n: int,
                 seq_dtype) -> torch.Tensor:
    """`n` all-zero windows, (n, window_bp, 4), on `device`."""
    return torch.zeros((n, geometry.window_bp, 4),
                       dtype=_warmup_dtype(seq_dtype), device=device)


def warmup_cascade_32m(bundle: ModelBundle,
                       geom: CascadeGeometry = GEOM_32M,
                       n: int = 1, mesh: Optional[Mesh] = None,
                       seq_dtype=np.uint8, *, device=None) -> float:
    """Counterpart of the JAX package's program warm-up: torch compiles
    nothing, so this runs one request on `n` all-zero windows at `geom`
    (production by default), that is on 2n rows (forward and reverse
    complement), as the JAX package warms its programs for a batch of 2n.
    It pays a process's first-request set-up (cuDNN plans for that batch,
    allocator pools) before a client's first request. `seq_dtype` is the
    windows' dtype: uint8 (packed quarter-scale, the default) or a float
    one-hot; numpy and JAX dtypes are read by name. The bundle's parameters
    live on `device` (None = CUDA). `mesh` (None = the inference mesh,
    `parallel.mesh.get_inference_mesh()`) is the mesh the requests will
    shard over. Returns the seconds taken."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else get_inference_mesh()
    t0 = time.perf_counter()
    with torch.inference_mode():
        preds, _ = _cascade_32mb(bundle, geom,
                                 _zero_window(geom, device, n, seq_dtype),
                                 geom.window_bp // 2, geom.window_bp // 2,
                                 bundle.log_normmats(), mesh)
        preds.cpu()
    return time.perf_counter() - t0


def warmup_cascade_256m(bundle: Model256MBundle,
                        geom: CascadeGeometry = GEOM_256M,
                        n: int = 1, mesh: Optional[Mesh] = None,
                        seq_dtype=np.uint8, *, device=None) -> float:
    """The 256 Mb counterpart of `warmup_cascade_32m`: one request on `n`
    all-zero windows (2n rows) with a flat background. Returns the seconds
    taken."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else get_inference_mesh()
    t0 = time.perf_counter()
    with torch.inference_mode():
        preds, _, _ = _cascade_256mb(
            bundle, geom, _zero_window(geom, device, n, seq_dtype),
            geom.window_bp // 2, geom.window_bp // 2, geom.window_bp,
            np.ones((geom.bins, geom.bins), np.float32), mesh)
        preds.cpu()
    return time.perf_counter() - t0


def _downsample_target(target: np.ndarray, start: int, factor: int,
                       nan_thresh: float, crop_bins: int = CROP):
    """NaN-aware block average of an observed matrix crop to crop_bins^2,
    over an optional leading feature axis."""
    n = crop_bins * factor
    squeeze = target.ndim == 2
    if squeeze:
        target = target[None]
    crop = target[:, start : start + n, start : start + n]
    r = crop.reshape(target.shape[0], crop_bins, factor, crop_bins, factor)
    with np.errstate(invalid="ignore"):
        avg = np.nanmean(np.nanmean(r, axis=4), axis=2)
    nanfrac = np.isnan(r).mean(axis=(2, 4))
    avg[nanfrac > nan_thresh] = np.nan
    return avg[0] if squeeze else avg


def genomepredict(
    sequence: np.ndarray,
    mchr: str,
    mpos: int = -1,
    wpos: int = -1,
    models: Sequence[ModelBundle] = (),
    targets: Optional[List[np.ndarray]] = None,
    annotation=None,
    nan_thresh: float = 1.0,
    geometry: CascadeGeometry = GEOM_32M,
    mesh: Optional[Mesh] = None,
    *,
    device=None,
) -> dict:
    """Multiscale 32 Mb prediction: returns a dict with keys
    predictions/experiments/normmats/start_coords/end_coords/chr/annos.

    sequence: (1, window_bp, 4) one-hot (float, or uint8 quarter-scale).
    models: ModelBundles whose parameters live on `device` (None = CUDA).
    mesh: a `parallel.mesh.Mesh` with a 'seq' axis (None = the inference
        mesh, `parallel.mesh.get_inference_mesh()`): the encoder tower runs
        sequence-sharded across it (`parallel.sequence`), and the encodings
        are gathered on `device` for the pyramid and decoders.
    """
    device = resolve_device(device)
    mesh = mesh if mesh is not None else get_inference_mesh()
    seq = _device_sequence(sequence, device)
    allpreds, allstarts = [], []
    with torch.inference_mode():
        for bundle in models:
            preds, starts = _cascade_32mb(
                bundle, geometry, seq, mpos, wpos, bundle.log_normmats(), mesh
            )
            with profiling.span("orca.sync"):
                allpreds.append(preds.cpu().numpy())
                allstarts.append(starts.cpu().numpy())

    lvl_list = sorted(models[0].decoders, reverse=True)
    output = {}
    # (crop, crop) maps for single-head models; (num_2d, crop, crop) for
    # multi-head ones
    output["predictions"] = [
        [
            p[j][0, :, :, 0] if p[j].shape[-1] == 1
            else np.moveaxis(p[j][0], -1, 0)
            for j in range(len(lvl_list))
        ]
        for p in allpreds
    ]
    if targets is not None:
        alltargets = []
        for i, bundle in enumerate(models):
            ts = []
            for j, level in enumerate(lvl_list):
                t = np.asarray(targets[i])
                if t.ndim == 3 and t.shape[0] == 1:
                    t = t[0]
                target_r = _downsample_target(
                    t, int(allstarts[i][j]), level, nan_thresh,
                    crop_bins=geometry.crop,
                )
                eps = bundle.epss[level]
                with np.errstate(invalid="ignore", divide="ignore"):
                    ts.append(
                        np.log((target_r + eps) / (bundle.normmats[level] + eps))
                    )
            alltargets.append(ts)
        output["experiments"] = alltargets
    else:
        output["experiments"] = None
    starts0 = allstarts[0]
    halfwin = geometry.window_bp // 2
    output["start_coords"] = [
        int(wpos - halfwin + s * geometry.bin_bp) for s in starts0
    ]
    output["end_coords"] = [
        int(output["start_coords"][j] + geometry.window_bp / 2**j)
        for j in range(len(lvl_list))
    ]
    output["chr"] = mchr
    output["annos"] = _process_annotation(
        annotation, starts0, [geometry.crop * lv for lv in lvl_list],
        geometry.bins,
    )
    output["normmats"] = [[m.normmats[lv] for lv in lvl_list] for m in models]
    return output


def _process_annotation(annotation, starts, window_bins, total_bins=BINS):
    """Window-relative annotation rescaling per level: `starts` and
    `window_bins` are in finest-bin units."""
    if annotation is None:
        return None
    annos = []
    for j, nbins in enumerate(window_bins):
        newstart = starts[j] / float(total_bins)
        newend = (starts[j] + nbins) / float(total_bins)
        anno_r = []
        for r in annotation:
            if len(r) == 3:
                if not (r[0] >= newend or r[1] <= newstart):
                    anno_r.append(
                        (
                            np.fmax((r[0] - newstart) / (newend - newstart), 0),
                            np.fmin((r[1] - newstart) / (newend - newstart), 1),
                            r[2],
                        )
                    )
            else:
                if newstart <= r[0] < newend:
                    anno_r.append(((r[0] - newstart) / (newend - newstart), r[1]))
        annos.append(anno_r)
    return annos


# --------------------------------------------------------------------------
# 256 Mb cascade
# --------------------------------------------------------------------------


def _encode_256mb(bundle: Model256MBundle, seq: torch.Tensor,
                  mesh: Optional[Mesh] = None) -> Dict[int, torch.Tensor]:
    """One-hot (N, L, 4) -> encodings at levels 32..256 (finest L/128000
    bins): the tower (sequence-sharded over `mesh` when given), the 32 Mb
    pyramid's last output, then the 3-level pyramid."""
    feats = _tower(bundle.encoder, seq, mesh)
    with profiling.span("orca.pyramid"):
        enc128k = encoders.apply_pyramid(bundle.pyramid1, feats, levels=5,
                                         up_pass=True)[-1]
        encs = encoders.apply_pyramid(bundle.pyramid, enc128k, levels=3,
                                      up_pass=True)
    return dict(zip(LEVELS_256M, encs))


def _encode_256mb_fwd_rc(bundle: Model256MBundle, seq: torch.Tensor,
                         mesh: Optional[Mesh] = None
                         ) -> Dict[int, torch.Tensor]:
    """The encodings of the orientation-batched input: forward rows, then
    their reverse complements."""
    seq2 = torch.cat([seq, torch.flip(seq, dims=(1, 2))])
    return _encode_256mb(bundle, seq2, mesh)


def _block_average_rows(normmat: torch.Tensor, starts: Sequence[int],
                        factor: int, crop: int) -> torch.Tensor:
    """Per-row background crops: the (crop*factor)^2 square of `normmat` at
    (s, s), block-averaged to (crop, crop), for each start s -> (B, crop,
    crop)."""
    n = crop * factor
    # zoom starts stay inside the window by construction (Python slicing
    # would not clamp them as a dynamic slice does)
    assert all(0 <= s <= normmat.shape[0] - n for s in starts), starts
    return torch.stack([
        normmat[s : s + n, s : s + n]
        .reshape(crop, factor, crop, factor).mean(dim=(1, 3))
        for s in starts
    ])


def _zoom_start_index_256(geom: CascadeGeometry, factor: int, mpos, wpos,
                          chrlen, start_bins: torch.Tensor) -> torch.Tensor:
    """Zoom-window starts in [0, half] of the orientation-batched rows:
    proposals clamped to the first chromosome's bounds [0, chrlen - span/2]
    in window coordinates, the reverse-complement rows' start mirrored.
    float32 arithmetic on tensors, in the JAX package's order."""
    n = start_bins.shape[0] // 2
    halfwin = geom.window_bp / 2.0
    binw = float(geom.bin_bp)
    with profiling.span("orca.sync"):
        fac = torch.tensor(factor, dtype=torch.float32,
                           device=start_bins.device)
    span = geom.crop * geom.bin_bp * fac
    prop_fwd = (mpos - span / 4) - (wpos - halfwin + start_bins[:n] * binw)
    prop_rc = (mpos - span / 4) - (
        wpos + halfwin - start_bins[n:] * binw - span
    )
    b0 = 0.0 - (wpos - halfwin)
    b1 = chrlen - span / 2 - (wpos - halfwin)

    def index(prop):
        prop = torch.where(b0 < b1,
                           torch.minimum(torch.maximum(prop, b0), b1), b0)
        return torch.clamp(torch.floor(prop / (binw * fac)), 0,
                           geom.half).to(torch.int32)

    return torch.cat([index(prop_fwd),
                      geom.crop - (index(prop_rc) + geom.half)])


def _decode_level_256(bundle: Model256MBundle, geom: CascadeGeometry,
                      level: int, factor: int, enc_crop: torch.Tensor,
                      normmat_r: torch.Tensor, start_bins: torch.Tensor,
                      mpos, wpos, chrlen, coarse):
    """One 256 Mb decoder level, orientation-batched with per-row
    backgrounds: the reverse-complement rows use the spatially flipped
    distance encoding. Returns (pred, next start_bins, next coarse)."""
    n = enc_crop.shape[0] // 2

    def decode(enc_crop, normmat_r, coarse):
        distenc = torch.log(normmat_r)
        distenc = torch.cat([distenc[:n],
                             torch.flip(distenc[n:], dims=(1, 2))])
        return decoders.apply_decoder(
            bundle.decoders[level], enc_crop, distenc[..., None], coarse,
            upsample_mode=bundle.upsample_mode,
        )

    if _graph_path(enc_crop, normmat_r, coarse):
        pred = _LEVEL_GRAPHS.run(bundle, level, decode,
                                 (bundle.decoders[level],),
                                 enc_crop, normmat_r, coarse)
    else:
        pred = decode(enc_crop, normmat_r, coarse)
    start_index = _zoom_start_index_256(geom, factor, mpos, wpos, chrlen,
                                        start_bins)
    next_start = start_bins + start_index * factor
    with profiling.span("orca.sync"):
        rows = start_index.tolist()
    coarse_next = _crop_squares(pred, rows, geom.half)
    return pred, next_start, coarse_next


def _cascade_256mb(bundle: Model256MBundle, geom: CascadeGeometry, seq, mpos,
                   wpos, chrlen, normmat, mesh: Optional[Mesh] = None):
    """Full fwd+RC 4-level cascade with per-row backgrounds; returns
    (stacked (4, N, crop, crop) float32 maps, starts (4,) int32, forward
    backgrounds (4, crop, crop)) on the sequence's device. With a mesh the
    encoder tower runs sequence-sharded over it."""
    n = seq.shape[0]
    device = seq.device
    encs = _encode_256mb_fwd_rc(bundle, seq, mesh)
    start_bins = torch.zeros(2 * n, dtype=torch.int32, device=device)
    with profiling.span("orca.sync"):
        mpos, wpos, chrlen = (
            torch.tensor(v, dtype=torch.float32, device=device)
            for v in (mpos, wpos, chrlen))
    with profiling.span("orca.background_copy"):
        if isinstance(normmat, np.ndarray):
            profiling.count("h2d_bytes", normmat.nbytes)
        normmat = torch.as_tensor(normmat, device=device)
    coarse = None
    preds, starts, norms = [], [], []
    for j, level in enumerate(sorted(bundle.decoders, reverse=True)):
        factor = geom.bins // (geom.crop * 2**j)  # == level // 8 in production
        with profiling.span("orca.decode", level):
            with profiling.span("orca.sync"):
                rows = start_bins.tolist()
            normmat_r = _block_average_rows(normmat, rows, factor, geom.crop)
            enc_starts = [s // factor for s in rows]
            assert (max(enc_starts) + geom.crop
                    <= encs[level].shape[1]), enc_starts
            enc_crop = _crop_rows(encs[level], enc_starts, geom.crop)
            starts.append(start_bins[:n])
            norms.append(normmat_r[0])
            pred, start_bins, coarse = _decode_level_256(
                bundle, geom, level, factor, enc_crop, normmat_r, start_bins,
                mpos, wpos, chrlen, coarse,
            )
            preds.append(_combine_orientations(pred)[..., 0])
    return (torch.stack(preds), torch.stack([s[0] for s in starts]),
            torch.stack(norms))


def _filled_background(normmat: np.ndarray) -> np.ndarray:
    """A float32 copy of a region mosaic's background with its NaNs (cis
    distances past the expectation's end) set to its least value."""
    with profiling.span("orca.background_fill"):
        normmat = np.array(normmat, dtype=np.float32)
        mask = np.isnan(normmat)
        if mask.any():
            normmat[mask] = np.nanmin(normmat[~mask]) if (~mask).any() else 1.0
        return normmat


def genomepredict_256mb(
    sequence: np.ndarray,
    mchr: str,
    normmats: List[np.ndarray],
    chrlen: int,
    mpos: int = -1,
    wpos: int = -1,
    models: Sequence[Model256MBundle] = (),
    targets: Optional[List[np.ndarray]] = None,
    annotation=None,
    padding_chr: Optional[str] = None,
    nan_thresh: float = 1.0,
    geometry: CascadeGeometry = GEOM_256M,
    mesh: Optional[Mesh] = None,
    *,
    device=None,
) -> dict:
    """Multiscale 256 Mb prediction: returns a dict with keys
    predictions/experiments/normmats/start_coords/end_coords/chr/
    padding_chr/annos; `normmats` is one dict per model from level to its
    (crop, crop) background.

    sequence: (1, window_bp, 4) one-hot (float, or uint8 quarter-scale).
    normmats: one (bins, bins) background per model over the region mosaic
        (retrieval.assemble_normmat); NaNs are filled with the least value.
    chrlen: length of the first chromosome; zoom windows stay inside it.
    models: Model256MBundles whose parameters live on `device` (None = CUDA).
    mesh: as in `genomepredict` (None = the inference mesh): the encoder
        tower tiles the window across the mesh's 'seq' axis.
    """
    device = resolve_device(device)
    mesh = mesh if mesh is not None else get_inference_mesh()
    seq = _device_sequence(sequence, device)
    allpreds, allstarts, allnormmats = [], [], []
    with torch.inference_mode():
        for ii, bundle in enumerate(models):
            preds, starts, norms = _cascade_256mb(
                bundle, geometry, seq, mpos, wpos, chrlen,
                _filled_background(normmats[ii]), mesh,
            )
            with profiling.span("orca.sync"):
                allpreds.append(preds.cpu().numpy())
                allstarts.append(starts.cpu().numpy())
                allnormmats.append(norms.cpu().numpy())

    lvl_list = sorted(models[0].decoders, reverse=True)
    factors = [geometry.bins // (geometry.crop * 2**j)
               for j in range(len(lvl_list))]
    output = {}
    output["predictions"] = [
        [p[j][0] for j in range(len(lvl_list))] for p in allpreds
    ]
    if targets is not None:
        alltargets = []
        for i in range(len(models)):
            ts = []
            for j in range(len(lvl_list)):
                t = np.asarray(targets[i])
                if t.ndim == 3 and t.shape[0] == 1:
                    t = t[0]
                target_r = _downsample_target(
                    t, int(allstarts[i][j]), factors[j], nan_thresh,
                    crop_bins=geometry.crop,
                )
                normmat_r = allnormmats[i][j]
                eps = float(np.nanmin(normmat_r))
                with np.errstate(invalid="ignore", divide="ignore"):
                    ts.append(np.log((target_r + eps) / (normmat_r + eps)))
            alltargets.append(ts)
        output["experiments"] = alltargets
    else:
        output["experiments"] = None
    starts0 = allstarts[0]
    halfwin = geometry.window_bp // 2
    output["start_coords"] = [
        int(wpos - halfwin + s * geometry.bin_bp) for s in starts0
    ]
    output["end_coords"] = [
        int(min(output["start_coords"][j] + geometry.window_bp / 2**j, chrlen))
        for j in range(len(lvl_list))
    ]
    output["chr"] = mchr
    output["padding_chr"] = padding_chr
    output["annos"] = _process_annotation(
        annotation, starts0, [geometry.crop * f for f in factors],
        geometry.bins,
    )
    output["normmats"] = [
        {lv: nm[j] for j, lv in enumerate(lvl_list)} for nm in allnormmats
    ]
    return output
