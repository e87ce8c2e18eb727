"""The port's certificate against orca_tpu at full geometry, on any device.

A reference file (``tests/data/certify_card_ref.npz``) holds orca_tpu's
outputs, computed on the CPU by ``tests/test_torch_certify_card.py`` under
``pytest -m slow``, for three families on seeded random weights:

- 1m: ``predict_1m`` with the 1D head on one 1,000,000 bp window: the 2D map
  and the tracks;
- 32m: ``genomepredict`` at GEOM_32M on a random 32 Mb window with one
  500 kb run of N (all-zero rows) across the first 4 Mb block boundary,
  zoomed at window fractions 0.5 and 0.13 with wpos at the window's middle:
  every level's map and the start coordinates;
- 256m: ``genomepredict_256mb`` at GEOM_256M with a first chromosome of
  145,120,000 bp (chr8's length in whole 32 kb bins) and its padding, the
  background from ``assemble_normmat``, zoomed at chromosome fractions 0.44
  and 0.995 (the clamp at the chromosome's end).

This module rebuilds the same weights and inputs with torch and numpy alone
(the weights drawn from torch's CPU generator and folded on the CPU, the
inputs from numpy's legacy RandomState), checks their SHA-256 digests
against the reference's, runs the port's entry points on the device asked
for and holds each output to the reference: float32 to BAR_FP32, bfloat16
to twice orca_tpu's own bf16-vs-fp32 max|d| at the same level. A float32
figure over LIMIT_REL * max(1, max|ref|), a bfloat16 figure over LIMIT_BF16
times its bar, different starts, a non-finite or misshapen map, or a digest
that differs raises CertifyError; a figure over its bar but under that
limit is reported with ``pass: false``. Each family is a class of its own
(Net1M, Cascade32M, Cascade256M) that draws its weights and inputs and runs
the port's entry point. ``chip_smoke.py`` runs it on the card; the tests
run it on the CPU at small geometries against a reference the same
generator writes.

The file is an ``np.savez_compressed`` archive: ``header`` is a JSON string
(seeds, geometries, zooms, levels, digests, starts, orca_tpu's own bf16 vs
fp32 figures, its seconds, versions), and each map is an array named
``family:dtype:zoom:level``, its upper triangle (row-major) where the map is
exactly symmetric, else the whole map flattened (``header["arrays"]`` says
which, with the shape).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from orca_tpu_torch.models import zoo
from orca_tpu_torch.predict import multiscale as ms
from orca_tpu_torch.predict import onemb
from orca_tpu_torch.predict.retrieval import assemble_normmat
from orca_tpu_torch.utils.tree import tree_map

SEED = 0  # the weights' torch generator seed
INPUT_SEED = 1  # numpy RandomState of the sequences
NUM_1D = 32  # the 1 Mb Net's tracks
# the port's float32 bar against orca_tpu (ROADMAP's North star)
BAR_FP32 = 2.0e-6
# a float32 figure over LIMIT_REL * max(1, max|ref|) fails outright
LIMIT_REL = 1e-4
# a bfloat16 figure over LIMIT_BF16 times its bar fails outright
LIMIT_BF16 = 2.0
# chr8's length over a 256 Mb window, as the JAX package's certificate has
CHR8_FRACTION = 145_138_636 / 256_000_000


class CertifyError(RuntimeError):
    pass


@dataclasses.dataclass
class Output:
    """One request's outputs: level (or "2d"/"1d") -> float32 map, and the
    start coordinates (None for 1m)."""

    maps: Dict[str, np.ndarray]
    starts: Optional[List[int]] = None


def cascade_output(levels: List[str], out: dict) -> Output:
    """A `genomepredict*` result (either package's) as an Output."""
    return Output({lv: np.asarray(p, np.float32)
                   for lv, p in zip(levels, out["predictions"][0])},
                  [int(s) for s in out["start_coords"]])


def onehot(window_bp: int) -> np.ndarray:
    """(1, window_bp, 4) uint8 one-hot at quarter scale (4 = 1.0) of codes
    from RandomState(INPUT_SEED)."""
    codes = np.random.RandomState(INPUT_SEED).randint(0, 4, window_bp)
    return (np.eye(4, dtype=np.uint8) * 4)[codes][None]


@dataclasses.dataclass(frozen=True)
class Net1M:
    """The 1 Mb Net: `predict_1m` with its 1D head on one window; its
    outputs are the 2D map and the tracks."""

    name: str
    window_bp: int
    num_1d: int = NUM_1D

    def zooms(self) -> Dict[str, dict]:
        return {"window": {}}

    def describe(self) -> dict:
        """The geometry as the reference's header records it."""
        return {"window_bp": self.window_bp, "num_1d": self.num_1d}

    def weights(self):
        """The seeded random bundle, drawn and folded on the CPU in float32
        (the port's init: torch's CPU generator from SEED)."""
        return zoo.fold_1m_bundle(zoo.random_1m_bundle(
            SEED, num_1d=self.num_1d, device="cpu"))

    def inputs(self, bundle) -> dict:
        return {"sequence": onehot(self.window_bp)}

    def levels(self, bundle) -> List[str]:
        return ["2d", "1d"]

    def run(self, bundle, inp: dict, zoom: str, device) -> Output:
        """One call of the port's entry point on `device`, with `bundle`'s
        parameters already there."""
        pred, tracks = onemb.predict_1m(bundle, inp["sequence"],
                                        with_1d=True, device=device)
        return Output({"2d": np.asarray(pred[0, :, :, 0], np.float32),
                       "1d": np.asarray(tracks[0], np.float32)})


@dataclasses.dataclass(frozen=True)
class Cascade32M:
    """`genomepredict` on one window, zoomed at `fracs` of the window with
    wpos at its middle; `n_run` is a [start, end) bp run of the window set
    to N (all-zero rows). Its outputs are every level's map and the
    starts."""

    name: str
    window_bp: int
    bin_bp: int = 4000
    crop: int = 250
    fracs: Tuple[float, ...] = ()
    n_run: Optional[Tuple[int, int]] = None

    @property
    def geometry(self) -> ms.CascadeGeometry:
        return ms.CascadeGeometry(self.window_bp, self.bin_bp, self.crop)

    @property
    def span(self) -> int:
        """The length the zoom fractions are of."""
        return self.window_bp

    def zooms(self) -> Dict[str, dict]:
        """Zoom name -> the request's mpos and wpos."""
        return {f"mpos_frac_{f}": {"mpos": int(self.span * f),
                                   "wpos": self.window_bp // 2}
                for f in self.fracs}

    def describe(self) -> dict:
        out = {"window_bp": self.window_bp, "bin_bp": self.bin_bp,
               "crop": self.crop}
        if self.n_run:
            out["n_run"] = list(self.n_run)
        return out

    def weights(self):
        return zoo.fold_bundle(zoo.random_32m_bundle(
            SEED, nbins=self.geometry.bins, crop=self.crop, device="cpu"))

    def inputs(self, bundle) -> dict:
        seq = onehot(self.window_bp)
        if self.n_run:
            seq[0, self.n_run[0]:self.n_run[1]] = 0
        return {"sequence": seq}

    def levels(self, bundle) -> List[str]:
        return [str(lv) for lv in sorted(bundle.decoders, reverse=True)]

    def run(self, bundle, inp: dict, zoom: str, device) -> Output:
        z = self.zooms()[zoom]
        out = ms.genomepredict(inp["sequence"], "chrSynthetic", z["mpos"],
                               z["wpos"], [bundle], geometry=self.geometry,
                               device=device)
        return cascade_output(self.levels(bundle), out)


@dataclasses.dataclass(frozen=True)
class Cascade256M(Cascade32M):
    """`genomepredict_256mb` on a first chromosome of CHR8_FRACTION of the
    window, in whole bins, and its padding chromosome, with the background
    from `assemble_normmat`; zoomed at `fracs` of the first chromosome."""

    bin_bp: int = 32_000

    @property
    def chrlen(self) -> int:
        n = int(self.window_bp * CHR8_FRACTION)
        return n - n % self.bin_bp

    @property
    def span(self) -> int:
        return self.chrlen

    def regions(self) -> List[list]:
        return [["chrM", 0, self.chrlen, "+"],
                ["chrP", 0, self.window_bp - self.chrlen, "+"]]

    def describe(self) -> dict:
        return dict(super().describe(), chrlen=self.chrlen)

    def weights(self):
        return zoo.fold_256m_bundle(zoo.random_256m_bundle(SEED,
                                                           device="cpu"))

    def inputs(self, bundle) -> dict:
        """The sequence, and the region mosaic's background from `bundle`'s
        expectation (either package's bundle)."""
        return dict(super().inputs(bundle), normmat=assemble_normmat(
            self.regions(), bundle.background_cis, bundle.background_trans,
            binsize=self.bin_bp))

    def run(self, bundle, inp: dict, zoom: str, device) -> Output:
        z = self.zooms()[zoom]
        out = ms.genomepredict_256mb(
            inp["sequence"], "chrM", [inp["normmat"]], self.chrlen,
            z["mpos"], z["wpos"], [bundle], padding_chr="chrP",
            geometry=self.geometry, device=device)
        return cascade_output(self.levels(bundle), out)


Family = Union[Net1M, Cascade32M, Cascade256M]

# CERTIFY_SYNTH.json's geometries and zooms; the N run crosses the boundary
# of the first two 4 Mb blocks, inside the 0.13 zoom's finest levels
FULL = {
    "1m": Net1M("1m", 1_000_000),
    "32m": Cascade32M("32m", 32_000_000, fracs=(0.5, 0.13),
                      n_run=(3_800_000, 4_300_000)),
    "256m": Cascade256M("256m", 256_000_000, fracs=(0.44, 0.995)),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def tree_digest(tree) -> str:
    """SHA-256 over a tree's array leaves in sorted-path order: each leaf's
    path, dtype, shape and bytes (tensors as numpy on the host)."""
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(tree), key=lambda kv: kv[0]):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{path}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# a bundle's parameter trees and its backgrounds, by field (any class)
PARAM_FIELDS = ("encoder", "pyramid1", "pyramid", "decoders", "decoder_1pt",
                "net")
BACKGROUND_FIELDS = ("normmats", "epss", "background_cis",
                     "background_trans")


def digests(bundle, inp: dict) -> dict:
    """The weights' digest (every parameter of the folded float32 bundle),
    the backgrounds' (the bundle's numpy arrays and scalars as float64 or
    their own dtype), and one per input array."""
    fields = {f.name: getattr(bundle, f.name)
              for f in dataclasses.fields(bundle)}
    out = {
        "weights": tree_digest({k: fields[k] for k in PARAM_FIELDS
                                if k in fields}),
        "backgrounds": tree_digest({k: tree_map(np.asarray, fields[k])
                                    for k in BACKGROUND_FIELDS
                                    if k in fields}),
    }
    for name, arr in inp.items():
        out[name] = tree_digest(arr)
    return out


def key(family: str, dtype: str, zoom: str) -> str:
    return f"{family}:{dtype}:{zoom}"


# ---------------------------------------------------------------------------
# the reference file
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Reference:
    header: dict
    outputs: Dict[str, Output]  # key(family, dtype, zoom) -> Output

    def bars(self, family: str, dtype: str, zoom: str) -> Dict[str, float]:
        """Each level's bar: BAR_FP32, or twice orca_tpu's own bf16 vs fp32
        max|d| at the level."""
        names = self.header["families"][family]["levels"]
        if dtype == "float32":
            return {lv: BAR_FP32 for lv in names}
        own = self.header["families"][family]["bf16_vs_fp32"][zoom]
        return {lv: 2.0 * own[lv] for lv in names}


def _pack(a: np.ndarray) -> Tuple[np.ndarray, str]:
    if a.ndim == 2 and a.shape[0] == a.shape[1] and np.array_equal(a, a.T):
        return a[np.triu_indices(a.shape[0])], "triu"
    return a.ravel(), "full"


def _unpack(flat: np.ndarray, shape, how: str) -> np.ndarray:
    if how == "full":
        return flat.reshape(shape)
    a = np.zeros(shape, flat.dtype)
    a[np.triu_indices(shape[0])] = flat
    return np.triu(a, 1).T + a


def save_reference(path, header: dict, outputs: Dict[str, Output]) -> None:
    """Write `outputs` (key -> Output) and `header` to `path` as described
    in the module's docstring; the starts go into the header."""
    arrays, index = {}, {}
    starts = {}
    for k in sorted(outputs):
        out = outputs[k]
        if out.starts is not None:
            starts[k] = out.starts
        for lv, a in out.maps.items():
            flat, how = _pack(np.asarray(a, np.float32))
            arrays[f"{k}:{lv}"] = flat
            index[f"{k}:{lv}"] = {"shape": list(a.shape), "packed": how}
    header = dict(header, arrays=index, starts=starts)
    with open(path, "wb") as f:
        np.savez_compressed(
            f, header=np.array(json.dumps(header, sort_keys=True)), **arrays)


def load_reference(path) -> Reference:
    """Read a file `save_reference` wrote; each output's maps in its
    family's level order."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["header"]))
        outputs: Dict[str, Output] = {}
        for name, info in header["arrays"].items():
            k, lv = name.rsplit(":", 1)
            out = outputs.setdefault(k, Output({}, header["starts"].get(k)))
            out.maps[lv] = _unpack(z[name], info["shape"], info["packed"])
    for k, out in outputs.items():
        order = header["families"][k.split(":")[0]]["levels"]
        out.maps = {lv: out.maps[lv] for lv in order}
    return Reference(header, outputs)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def check_digests(reference: Reference, family: str, got: dict) -> None:
    """Every digest equal to the reference's, or CertifyError naming both
    sides' torch and numpy versions."""
    entry = reference.header["families"][family]
    want = entry["digests"]
    bad = sorted(k for k in want if got.get(k) != want[k])
    if bad or set(got) != set(want):
        v = entry["versions"]
        raise CertifyError(
            f"{family}: the {', '.join(bad) or 'set of'} digests differ from "
            f"the reference's (here torch {torch.__version__} numpy "
            f"{np.__version__}; the reference's weights and inputs were made "
            f"with torch {v['torch']} numpy {v['numpy']})")


def max_abs_diffs(want: Output, got: Output) -> Dict[str, float]:
    """Each of `want`'s levels: max|got - want| in float64. A missing or
    misshapen map raises CertifyError."""
    out = {}
    for lv, ref in want.maps.items():
        g = got.maps.get(lv)
        if g is None or g.shape != ref.shape:
            raise CertifyError(
                f"level {lv}: shape {None if g is None else g.shape} != "
                f"reference {ref.shape}")
        out[lv] = float(np.abs(g.astype(np.float64) - ref).max())
    return out


def compare(want: Output, got: Output, bars: Dict[str, float],
            dtype: str) -> dict:
    """Each level's max|d| against its bar. Different starts, a missing,
    misshapen or non-finite map, a float32 max|d| over LIMIT_REL *
    max(1, max|ref|) or a bfloat16 max|d| over LIMIT_BF16 times its bar
    raises CertifyError; a figure over its bar but under that limit only
    reads pass: false."""
    if got.starts != want.starts:
        raise CertifyError(f"starts {got.starts} != reference {want.starts}")
    figures = {}
    for lv, d in max_abs_diffs(want, got).items():
        if not np.isfinite(got.maps[lv]).all():
            raise CertifyError(f"level {lv}: non-finite values")
        m = float(np.abs(want.maps[lv]).max())
        limit = (LIMIT_REL * max(1.0, m) if dtype == "float32"
                 else LIMIT_BF16 * bars[lv])
        if d > limit:
            raise CertifyError(
                f"level {lv}: {dtype} max|d| {d:.3e} over the limit "
                f"{limit:.3e} (max|ref| {m:.3e}, bar {bars[lv]:.3e})")
        figures[lv] = {"max_abs_diff": d, "max_abs_ref": m, "bar": bars[lv],
                       "pass": d <= bars[lv]}
    return {"levels": figures, "starts_equal": True,
            "pass": all(f["pass"] for f in figures.values())}


def certify_family(reference: Reference, fam: Family, device,
                   bundle=None, request: Optional[Callable] = None,
                   log: Callable = print) -> dict:
    """Check the digests of `fam`'s float32 folded weights (`bundle`, on any
    device, or else drawn here) and inputs, then run every dtype and zoom
    the reference holds on `device` and compare. `request(family, dtype,
    zoom)` is a context manager entered around each request (the card's
    launch counters); `log` gets one line a request. Returns {dtype: {zoom:
    figures}} plus the reference's not_run notes."""
    if bundle is None:
        bundle = fam.weights()
    inp = fam.inputs(bundle)
    check_digests(reference, fam.name, digests(bundle, inp))
    device = torch.device(device)
    bundle = zoo._map_params(bundle, lambda t: t.to(device))
    entry = reference.header["families"][fam.name]
    report = {}
    for dtype in entry["dtypes"]:
        b = zoo.cast_bundle(bundle, dtype)
        report[dtype] = {}
        for zoom in fam.zooms():
            with (request(fam.name, dtype, zoom) if request
                  else contextlib.nullcontext()):
                got = fam.run(b, inp, zoom, device)
            fig = compare(reference.outputs[key(fam.name, dtype, zoom)], got,
                          reference.bars(fam.name, dtype, zoom), dtype)
            report[dtype][zoom] = fig
            log(f"certify_card {fam.name} {dtype} {zoom}: " + ", ".join(
                f"{lv} {f['max_abs_diff']:.3e}/{f['max_abs_ref']:.3e}"
                f"{'' if f['pass'] else ' OVER'}"
                for lv, f in fig["levels"].items())
                + " (max|d|/max|ref| by level); starts equal; bar "
                + ("%.1e" % BAR_FP32 if dtype == "float32" else
                   "2x orca_tpu's bf16-vs-fp32 "
                   + ", ".join(f"{lv} {f['bar']:.3e}"
                               for lv, f in fig["levels"].items()))
                + f"; pass {fig['pass']}")
    for dtype, note in entry.get("not_run", {}).items():
        report[dtype] = {"not_run": note}
    return report
