"""The program's spans and counters inside the cascades
(orca_tpu_torch/predict/multiscale.py), on the CPU at tiny geometries with
a cheap stand-in for the encoder tower: with the spans on, `genomepredict`
and `genomepredict_256mb` emit every span, one `orca.decode.<level>` per
level and model with an `orca.sync` inside each, count the bytes handed
to the device in `h2d_bytes`, land each span in a `torch.profiler` trace,
and answer bit for bit as with the spans off."""

import json

import numpy as np
import pytest
import torch

from orca_tpu_torch.models import zoo
from orca_tpu_torch.nn import encoders
from orca_tpu_torch.predict import multiscale as ms
from orca_tpu_torch.utils import profiling

GEOM_32 = ms.CascadeGeometry(512_000, 4000, 4)
GEOM_256 = ms.CascadeGeometry(4_096_000, 32000, 4)
MODELS = 2
CHRLEN = 3_008_000
SPANS_32 = {"orca.input_copy", "orca.tower", "orca.pyramid", "orca.sync"}
SPANS_256 = SPANS_32 | {"orca.background_fill", "orca.background_copy"}


def stand_in_tower(params, seq, halo_bp=None):
    """(N, L, 4) -> (N, L / 4000, 128): 4 kb means of the one-hot through a
    fixed map, in place of the tower the CPU takes seconds over."""
    x = seq.float() if seq.dtype != torch.uint8 else seq.float() * 0.25
    n, length, _ = x.shape
    means = x.reshape(n, length // 4000, 4000, 4).mean(dim=2)
    w = torch.linspace(-1.0, 1.0, 4 * 128, dtype=torch.float32).reshape(4, 128)
    return means @ w.to(x.device)


@pytest.fixture(autouse=True)
def cheap_tower(monkeypatch):
    monkeypatch.setattr(encoders, "apply_encoder_tower", stand_in_tower)


@pytest.fixture(scope="module")
def bundle_32():
    return zoo.fold_bundle(zoo.random_32m_bundle(
        nbins=GEOM_32.bins, crop=GEOM_32.crop, device="cpu"))


@pytest.fixture(scope="module")
def bundle_256():
    return zoo.fold_256m_bundle(zoo.random_256m_bundle(device="cpu"))


def one_hot(geom, seed):
    rng = np.random.default_rng(seed)
    return np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, (1, geom.window_bp))]


def mosaic(bins):
    d = np.abs(np.subtract.outer(np.arange(bins), np.arange(bins)))
    nm = np.exp(-d / 10.0).astype(np.float32)
    nm[d > 100] = np.nan  # cis distances past the expectation's end
    return nm


def call_32(bundle):
    return ms.genomepredict(one_hot(GEOM_32, 1), "c", 300_000,
                            GEOM_32.window_bp // 2, [bundle] * MODELS,
                            geometry=GEOM_32, device="cpu")


def call_256(bundle):
    nm = mosaic(GEOM_256.bins)
    return ms.genomepredict_256mb(one_hot(GEOM_256, 2), "c", [nm] * MODELS,
                                  CHRLEN, 1_500_000, GEOM_256.window_bp // 2,
                                  [bundle] * MODELS, padding_chr="p",
                                  geometry=GEOM_256, device="cpu")


def traced(call, bundle, tmp_path):
    """(output, take(), the trace's user annotations) of one call with the
    spans on, under the profiler."""
    previous = profiling.enable(True)
    profiling.take()
    try:
        with profiling.trace(str(tmp_path)) as path:
            out = call(bundle)
        took = profiling.take()
    finally:
        profiling.enable(previous)
    with open(path) as f:
        marks = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return out, took, marks


def assert_same_output(a, b):
    for key in ("predictions", "start_coords", "end_coords", "normmats"):
        got, want = a[key], b[key]
        assert (json.dumps(got, default=lambda x: np.asarray(x).tolist())
                == json.dumps(want, default=lambda x: np.asarray(x).tolist()))


@pytest.mark.parametrize("family", ["32m", "256m"])
def test_cascade_spans_and_bytes(family, bundle_32, bundle_256, tmp_path):
    if family == "32m":
        call, bundle, spans = call_32, bundle_32, SPANS_32
        levels = sorted(bundle.decoders)
        h2d = GEOM_32.window_bp * 4
    else:
        call, bundle, spans = call_256, bundle_256, SPANS_256
        levels = sorted(bundle.decoders)
        h2d = GEOM_256.window_bp * 4 + MODELS * GEOM_256.bins ** 2 * 4
    out, took, marks = traced(call, bundle, tmp_path)
    names = {f"orca.decode.{lv}" for lv in levels}
    assert set(took["spans"]) == spans | names
    for name in names:
        assert took["spans"][name]["calls"] == MODELS
    assert took["spans"]["orca.tower"]["calls"] == MODELS
    assert took["spans"]["orca.pyramid"]["calls"] == MODELS
    assert took["spans"]["orca.input_copy"]["calls"] == 1
    if family == "256m":
        for name in ("orca.background_fill", "orca.background_copy"):
            assert took["spans"][name]["calls"] == MODELS
    assert took["counters"] == {"h2d_bytes": h2d}
    for s in took["spans"].values():
        assert 0 <= s["self_s"] <= s["host_s"]

    # the trace holds each span as often as the host clock counted it, and
    # every decoder level waits on the card at least once
    for name, s in took["spans"].items():
        assert sum(m["name"] == name for m in marks) == s["calls"], name
    syncs = [m for m in marks if m["name"] == "orca.sync"]
    for level in (m for m in marks if m["name"] in names):
        a, b = level["ts"], level["ts"] + level["dur"]
        assert any(a <= m["ts"] and m["ts"] + m["dur"] <= b for m in syncs)

    # the spans change nothing the call answers
    assert_same_output(out, call(bundle))


def test_spans_off_gather_nothing(bundle_32):
    assert profiling.enable(False) is False
    profiling.take()
    call_32(bundle_32)
    assert profiling.take() == {"spans": {}, "counters": {}}


def test_device_sequence_counts_the_packed_bytes():
    """A float one-hot is packed to uint8 before the copy: the counter holds
    the packed bytes; a float input that cannot be packed counts whole."""
    previous = profiling.enable(True)
    profiling.take()
    try:
        packed = ms._device_sequence(one_hot(GEOM_32, 3), "cpu")
        plain = ms._device_sequence(np.full((1, 8, 4), 0.3, np.float32),
                                    "cpu")
        took = profiling.take()
    finally:
        profiling.enable(previous)
    assert packed.dtype == torch.uint8 and plain.dtype == torch.float32
    assert took["counters"]["h2d_bytes"] == GEOM_32.window_bp * 4 + 8 * 4 * 4
    assert took["spans"]["orca.input_copy"]["calls"] == 2
