"""The port's standalone 1 Mb forward as module-level steps
(orca_tpu_torch/predict/onemb.py) on the CPU, at the models' published
widths on a 128 kb window (32 bins), on seeded random weights drawn in the
released `Net` key layout (`portbench/weights1m.py`):

  * `predict_1m` against the benchmark's plain reference
    (`portbench/reference/orca1m.py`): maps and tracks, with and without
    the reverse-complement average; fp32 against the reference computed in
    float64, within 2.0e-6 of its largest value or within twice the float32
    reference's own gap from it where that is wider (float32 rounding in
    the 19-block residual stack grows with the stream's size over the
    output's, which a weight draw sets); bf16 against the reference computed
    in bfloat16, within twice that computation's own gap from the float32
    reference (the bar of test_torch_onemb.py);
  * the steps bit-equal to `decoders.apply_net`, the training path's
    forward, with the reverse-complement average as it was done on it;
  * the program's spans and counters, exact, with outputs unchanged.
"""

import numpy as np
import pytest
import torch

from orca_tpu_torch.models import convert, zoo
from orca_tpu_torch.nn import decoders
from orca_tpu_torch.predict import onemb
from orca_tpu_torch.utils import profiling
from portbench.reference import orca1m
from portbench.weights1m import draw_net_statedict
from test_torch_encoders import onehot

WINDOW = 128_000
BINS = WINDOW // 4000
N = 2
NUM_1D = 32
SEED = 2 ** 33 + 21
FP32_BAR = 2.0e-6


@pytest.fixture(scope="module")
def models():
    """The statedict, the port's folded bundles (fp32, bf16) and the
    reference's folded model."""
    sd = draw_net_statedict(NUM_1D, SEED, "cpu")
    d = np.arange(1000, dtype=np.float64)
    normmats, epss = zoo.normmat_1m_from_expectation(-np.log1p(d) - 2.0)
    bundle = zoo.fold_1m_bundle(zoo.Model1MBundle(
        name="h1esc_1m", net=convert.convert_net(sd, num_1d=NUM_1D,
                                                 device="cpu"),
        num_1d=NUM_1D, normmats=normmats, epss=epss))
    ref = orca1m.load(sd, NUM_1D, "cpu")
    return {"fp32": bundle, "bf16": zoo.cast_bundle(bundle, "bfloat16"),
            "ref": ref, "ref64": orca1m.cast(ref, torch.float64),
            "ref16": orca1m.cast(ref, torch.bfloat16)}


@pytest.fixture(scope="module")
def seq():
    return onehot(5, N, WINDOW, packed=True)


@pytest.fixture(scope="module")
def reference(models, seq):
    """dtype -> rc_average -> (maps, tracks) of the reference computed in
    it (TF32 off)."""
    packed = torch.from_numpy(seq)
    return {dtype: {rc: orca1m.predict(models[key], packed, "fp32", rc,
                                       dtype=dtype)
                    for rc in (True, False)}
            for key, dtype in (("ref", torch.float32),
                               ("ref64", torch.float64),
                               ("ref16", torch.bfloat16))}


@pytest.mark.parametrize("rc", [True, False], ids=["rc", "forward"])
def test_predict_1m_fp32_matches_the_plain_reference(models, seq, reference,
                                                     rc):
    pred, tracks = onemb.predict_1m(models["fp32"], seq, with_1d=True,
                                    rc_average=rc, device="cpu")
    assert pred.shape == (N, BINS, BINS, 1) and tracks.shape == (N, BINS,
                                                                 NUM_1D)
    for k, got in enumerate((pred[..., 0], tracks)):
        exact = reference[torch.float64][rc][k]
        ref32 = reference[torch.float32][rc][k]
        assert got.dtype == np.float32

        def gap(a):
            return np.abs(a - exact).max() / np.abs(exact).max()
        assert gap(got) <= max(FP32_BAR, 2 * gap(ref32)), (gap(got),
                                                           gap(ref32))


@pytest.mark.parametrize("rc", [True, False], ids=["rc", "forward"])
def test_predict_1m_bf16_within_bf16_noise(models, seq, reference, rc):
    pred, tracks = onemb.predict_1m(models["bf16"], seq, with_1d=True,
                                    rc_average=rc, device="cpu")
    for k, got in enumerate((pred[..., 0], tracks)):
        want16 = reference[torch.bfloat16][rc][k]
        want32 = reference[torch.float32][rc][k]
        noise = np.abs(want16 - want32).max()
        d = np.abs(got - want16).max()
        assert noise > 0
        assert d <= 2 * noise, (d, noise)


@pytest.mark.parametrize("rc", [True, False], ids=["rc", "forward"])
def test_steps_bit_equal_to_apply_net(models, seq, rc):
    bundle = models["fp32"]
    pred, tracks = onemb.predict_1m(bundle, seq, with_1d=True, rc_average=rc,
                                    device="cpu")
    x = torch.from_numpy(seq)
    if rc:
        x = torch.cat([x, torch.flip(x, dims=(1, 2))])
    with torch.inference_mode():
        want, want1d = decoders.apply_net(bundle.net, x, num_1d=NUM_1D)
    if rc:
        want = 0.5 * want[:N] + 0.5 * torch.flip(want[N:], dims=(1, 2))
        want1d = 0.5 * want1d[:N] + 0.5 * torch.flip(want1d[N:], dims=(1,))
    np.testing.assert_array_equal(pred, want.float().numpy())
    np.testing.assert_array_equal(tracks, want1d.float().numpy())
    alone = onemb.predict_1m(bundle, seq, rc_average=rc, device="cpu")
    np.testing.assert_array_equal(alone, pred)


@pytest.mark.parametrize("with_1d", [True, False], ids=["tracks", "map"])
def test_spans_and_counters(models, seq, with_1d):
    bundle = models["fp32"]
    want = onemb.predict_1m(bundle, seq, with_1d=with_1d, rc_average=True,
                            device="cpu")
    profiling.take()
    previous = profiling.enable(True)
    try:
        got = onemb.predict_1m(bundle, seq, with_1d=with_1d, rc_average=True,
                               device="cpu")
        gathered = profiling.take()
    finally:
        profiling.enable(previous)
    for g, w in zip(got if with_1d else [got], want if with_1d else [want]):
        np.testing.assert_array_equal(g, w)
    calls = {name: s["calls"] for name, s in gathered["spans"].items()}
    assert calls == {"orca.input_copy": 1, "orca.tower": 1,
                     "orca.onemb.decode": 1, "orca.sync": 1,
                     **({"orca.onemb.tracks": 1} if with_1d else {})}
    assert gathered["counters"] == {"h2d_bytes": N * WINDOW * 4,
                                    "onemb_windows": N,
                                    "onemb_rows": 2 * N}


def test_screen_windows_counts_every_chunk(models, seq):
    """Five windows in chunks of 2: three calls, the last chunk padded."""
    windows = np.concatenate([seq, seq, seq[:1]])
    profiling.take()
    previous = profiling.enable(True)
    try:
        onemb.screen_windows(models["fp32"], windows, batch_size=2,
                             device="cpu")
        gathered = profiling.take()
    finally:
        profiling.enable(previous)
    assert gathered["spans"]["orca.onemb.decode"]["calls"] == 3
    assert "orca.onemb.tracks" not in gathered["spans"]
    assert gathered["counters"] == {"h2d_bytes": 6 * WINDOW * 4,
                                    "onemb_windows": 6, "onemb_rows": 6}
