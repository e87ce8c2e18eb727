"""The port's probes (orca_tpu_torch/scripts/profile_cascade.py,
probe_two_model.py, probe_decoder.py) against the JAX package's scripts.

  * profile_cascade: at CascadeGeometry(512_000, 4000, 4) with a folded
    numpy-drawn bundle in fp32 (the port's tower computed once for the five
    calls on one sequence), each timed callable's output against the JAX
    function its script times (`_cascade_32mb`, `_encode_32mb_jit`, the
    tower, the pyramid, `_decode_level_jit` without and with the 1 Mb head)
    on the same inputs: zoom starts equal, values within
    2.0e-6 * max(1, max|ref|);
  * probe_two_model: the hand-stacked two-model decode against the JAX
    script's `jax.vmap` decode and against two single decodes;
  * probe_decoder: at S=16 in fp32, the whole level, the 28 blocks against
    `_scan_repeated_groups` with the decoder's schedule (group_len 7), each
    conv and both matmuls;
  * each probe's printed labels equal the labels of the JAX script (read
    from its source), in order, then the card's line; the encoder steps
    replaced there by seeded features, the timing alone being checked.
"""

import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.nn import decoders as jdec
from orca_tpu.nn import encoders as jenc
from orca_tpu.nn.core import fold_params as jfold
from orca_tpu.ops import nn_ops as jops
from orca_tpu.predict import multiscale as jms
from orca_tpu.utils.config import get_config as jget_config
from orca_tpu_torch.models.from_jax import bundle_from_numpy, params_from_numpy
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.predict import multiscale as tms
from orca_tpu_torch.scripts import probe_decoder, probe_two_model
from orca_tpu_torch.scripts import profile_cascade
from test_torch_cascade import jax_bundle
from test_torch_encoders import numpy_tree, share_cpu_with_other_workers

share_cpu_with_other_workers()

REPO = pathlib.Path(__file__).resolve().parent.parent
GEOM_J = jms.CascadeGeometry(512_000, 4000, 4)
GEOM_T = tms.CascadeGeometry(512_000, 4000, 4)
TOL = 2.0e-6


def assert_close(got, want, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got - want).max()
    assert d <= TOL * max(1.0, np.abs(want).max()), (what, d)


# --------------------------------------------------------------------------
# the JAX scripts' labels, read from their sources
# --------------------------------------------------------------------------


def _template(node):
    """A regex for the label of a literal or f-string: its text up to the
    first ': ', each formatted value standing for any text."""
    hole = "\x00"
    if isinstance(node, ast.Constant):
        text = node.value
    else:
        text = "".join(v.value if isinstance(v, ast.Constant) else hole
                       for v in node.values)
    label = text.split(": ")[0].lstrip("\n")
    return ".+".join(re.escape(part) for part in label.split(hole))


def jax_labels(script):
    """The labels a JAX script prints, in source order: the first argument
    of each `timeit(...)` call and of each `print(...)` whose text starts
    with literal text (not the timeit's own `{name}: ...` line)."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    found = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("timeit", "print") and node.args):
            continue
        arg = node.args[0]
        literal = (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                   or isinstance(arg, ast.JoinedStr)
                   and isinstance(arg.values[0], ast.Constant))
        if literal:
            found.append((node.lineno, node.col_offset, _template(arg)))
    return [t for _, _, t in sorted(found)]


def printed_labels(out):
    return [line.split(": ")[0] for line in out.splitlines() if line.strip()]


def match_labels(printed, templates):
    """Each printed label matches the templates in order, a template
    matching one label or several in a row (the JAX scripts loop over
    dilations and 1 Mb-head variants); returns the labels left over."""
    i = 0
    for t in templates:
        n = 0
        while i < len(printed) and re.fullmatch(t, printed[i]):
            i += 1
            n += 1
        assert n >= 1, (t, printed[i:])
    return printed[i:]


def _stand_in_tower(monkeypatch):
    """The tower replaced by seeded (N, L/4000, 128) features in the
    bundle's dtype: the label tests check the printing, not the numbers."""
    def tower(params, x, **kw):
        gen = torch.Generator().manual_seed(5)
        return torch.randn(x.shape[0], x.shape[1] // 4000, 128,
                           generator=gen).to(params["lconv"][0][0]["w"].dtype)

    monkeypatch.setattr(tenc, "apply_encoder_tower", tower)


# --------------------------------------------------------------------------
# profile_cascade
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cascade_case():
    """(JAX bundle, port bundle, packed uint8 (1, L, 4) sequence)."""
    jb = jax_bundle(geom=GEOM_J)
    tb = bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    codes = np.random.RandomState(0).randint(0, 4, GEOM_T.window_bp)
    seq = (np.eye(4, dtype=np.uint8) * 4)[codes][None]
    return jb, tb, seq


def _tower_once(monkeypatch):
    """The port's tower computed once per distinct input: the probe runs it
    five times on one sequence, each ~8 s of a test worker's CPU. Outputs
    are the real tower's."""
    real = tenc.apply_encoder_tower
    memo = []

    def tower(params, x, **kw):
        for p, seen, kwargs, out in memo:
            if p is params and kwargs == kw and torch.equal(seen, x):
                return out
        memo.append((params, x, kw, real(params, x, **kw)))
        return memo[-1][-1]

    monkeypatch.setattr(tenc, "apply_encoder_tower", tower)
    return memo


def test_profile_cascade_steps_match_jax(cascade_case, monkeypatch):
    jb, tb, seq = cascade_case
    memo = _tower_once(monkeypatch)
    with torch.inference_mode():
        steps = dict(profile_cascade.make_steps(tb, GEOM_T,
                                                torch.from_numpy(seq)))
        got = {label: f() for label, f in steps.items()}
    assert len(memo) == 1
    assert list(steps) == [
        "full cascade", "encode_32mb_jit (tower+pyramid, fwd+RC)",
        "tower only (fwd+RC)", "pyramid only",
        "one decoder level (B=2, coarse, no 1pt)",
        "one decoder level (B=2, coarse, with 1pt)",
    ]

    sj = jnp.asarray(seq)
    mid = jnp.float32(GEOM_J.window_bp / 2)
    log_nm = jnp.asarray(jb.log_normmats())
    preds, starts = jms._cascade_32mb(jb, GEOM_J, sj, mid, mid, log_nm)
    np.testing.assert_array_equal(got["full cascade"][1].numpy(),
                                  np.asarray(starts))
    assert_close(got["full cascade"][0], preds, "full cascade")

    encs = jms._encode_32mb_jit(jb, GEOM_J, sj)
    for g, w in zip(got["encode_32mb_jit (tower+pyramid, fwd+RC)"], encs,
                    strict=True):
        assert_close(g, w, "encode")

    seq2 = jnp.concatenate([sj, jnp.flip(sj, axis=(1, 2))], axis=0)
    feats = jenc.apply_encoder_tower(
        jb.encoder, seq2, halo_bp=jget_config().encoder_halo_bp)
    assert_close(got["tower only (fwd+RC)"], feats, "tower")
    pyr = jenc.apply_pyramid(jb.pyramid, feats, levels=5,
                             up_pass=jb.pyramid_up_pass)
    for g, w in zip(got["pyramid only"], pyr, strict=True):
        assert_close(g, w, "pyramid")

    zeros = jnp.zeros((2,), jnp.int32)
    enc1 = jms._crop_rows_jit(encs[0], zeros, GEOM_J.crop)
    coarse = jnp.zeros((2, GEOM_J.half, GEOM_J.half, 1), jnp.float32)
    for name, d1pt in (("no 1pt", None), ("with 1pt", jb.decoder_1pt)):
        want = jms._decode_level_jit(
            jb.decoders[1], d1pt, enc1, GEOM_J, jb.upsample_mode, jb.num_2d,
            jnp.int32(1), log_nm[5], zeros, mid, mid, coarse)
        label = f"one decoder level (B=2, coarse, {name})"
        pred, nxt, crs = got[label]
        assert_close(pred, want[0], label)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(want[1]))
        assert_close(crs, want[2], label)


def test_profile_cascade_prints_the_jax_labels(monkeypatch, capsys):
    _stand_in_tower(monkeypatch)
    from orca_tpu_torch.models import zoo

    bundle = zoo.fold_bundle(zoo.random_32m_bundle(
        0, nbins=GEOM_T.bins, crop=GEOM_T.crop, device="cpu"))
    out = profile_cascade.main(n=1, geometry=GEOM_T, device="cpu",
                               bundle=bundle)
    printed = printed_labels(capsys.readouterr().out)
    assert match_labels(printed, jax_labels("profile_cascade.py")) == [
        "device"]
    assert sum(x.startswith("one decoder level") for x in printed) == 2
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert all(v > 0 for k, v in out.items()
               if k not in ("device", "power_limit_w"))


# --------------------------------------------------------------------------
# probe_two_model
# --------------------------------------------------------------------------


def _jax_decode_one(dec, d1pt, ec, log_nm_j, co, crop):
    """The JAX script's `decode_single` body (probe_two_model.py)."""
    distenc = jnp.broadcast_to(log_nm_j[None, :, :, None],
                               (ec.shape[0], crop, crop, 1))
    out = jdec.apply_decoder(dec, ec, distenc, co, upsample_mode="bilinear")
    return out + jdec.apply_decoder1m(d1pt, ec)


def test_stacked_decode_matches_jax_vmap_and_two_singles():
    crop = 8
    rng = np.random.RandomState(4)
    decs = [numpy_tree(jdec.decoder_spec(1), rng) for _ in range(2)]
    d1pts = [numpy_tree(jdec.decoder1m_spec(1), rng) for _ in range(2)]
    decs = [jax.tree.map(np.asarray, jfold(jax.tree.map(jnp.asarray, d),
                                           jdec.decoder_spec(1)))
            for d in decs]
    d1pts = [jax.tree.map(np.asarray, jfold(jax.tree.map(jnp.asarray, d),
                                            jdec.decoder1m_spec(1)))
             for d in d1pts]
    enc = rng.randn(2, 2, crop, 128).astype(np.float32)
    coarse = rng.randn(2, 2, crop // 2, crop // 2, 1).astype(np.float32)
    log_nm = rng.randn(crop, crop).astype(np.float32)

    stack = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)
    want = jax.jit(jax.vmap(
        lambda p, p1, ec, co: _jax_decode_one(p, p1, ec, jnp.asarray(log_nm),
                                              co, crop)))(
        stack(decs), stack(d1pts), jnp.asarray(enc), jnp.asarray(coarse))

    tdecs = [params_from_numpy(d, "cpu") for d in decs]
    td1pts = [params_from_numpy(d, "cpu") for d in d1pts]
    with torch.inference_mode():
        got = probe_two_model.stacked_decode(
            probe_two_model.stack_params(*tdecs),
            probe_two_model.stack_params(*td1pts), torch.from_numpy(enc),
            torch.from_numpy(log_nm), torch.from_numpy(coarse))
        singles = [probe_two_model.decode_one(
            tdecs[m], td1pts[m], torch.from_numpy(enc[m]),
            torch.from_numpy(log_nm), torch.from_numpy(coarse[m]))
            for m in range(2)]
    assert got.shape == (2, 2, crop, crop, 1)
    assert_close(got, want, "stacked vs jax.vmap")
    for m in range(2):
        assert_close(got[m], singles[m].numpy(), f"stacked vs single {m}")


def test_probe_two_model_prints_the_jax_labels(monkeypatch, capsys):
    _stand_in_tower(monkeypatch)
    from orca_tpu_torch.models import zoo

    bundles = [zoo.fold_bundle(zoo.random_32m_bundle(
        s, nbins=GEOM_T.bins, crop=GEOM_T.crop, device="cpu"))
        for s in (0, 1)]
    out = probe_two_model.main(iters=1, geometry=GEOM_T, device="cpu",
                               bundles=bundles)
    printed = printed_labels(capsys.readouterr().out)
    assert match_labels(printed, jax_labels("probe_two_model.py")) == [
        "device"]
    assert len(out) == 8 and out["device"] == "cpu"


# --------------------------------------------------------------------------
# probe_decoder
# --------------------------------------------------------------------------


def test_probe_decoder_steps_match_jax():
    s = 16
    spec = jdec.decoder_spec(1)
    host = jax.tree.map(np.asarray, jfold(
        jax.tree.map(jnp.asarray, numpy_tree(spec, np.random.RandomState(6))),
        spec))
    jp = jax.tree.map(jnp.asarray, host)
    inputs = probe_decoder.make_inputs("cpu", s, dtype=torch.float32)
    h = {k: jnp.asarray(v) for k, v in inputs["host"].items()}
    with torch.inference_mode():
        steps = probe_decoder.make_steps(params_from_numpy(host, "cpu"),
                                         inputs["device"])
        got = [(label, f()) for label, f in steps]
    lb, cb = spec["lconvtwos"], spec["convtwos"]
    want = [
        jdec.apply_decoder(jp, h["x"], h["distenc"], h["coarse"], num_2d=1,
                           upsample_mode="bilinear"),
        jdec._scan_repeated_groups(h["cur0"], jp["lconvtwos"],
                                   jp["convtwos"], lb, cb, group_len=7),
    ] + [jops.conv2d(h["cur0"], h["w"], h["b"], dilation=d)
         for d in probe_decoder.DILATIONS] + [
        h["cur0"].reshape(-1, 64) @ h["wf"],
        h["cur0"].reshape(-1, 128) @ h["wp"],
    ]
    assert len(got) == len(want) == 8
    for (label, g), w in zip(got, want):
        assert_close(g, w, label)


def test_probe_decoder_prints_the_jax_labels(capsys):
    out = probe_decoder.main(n=1, device="cpu", s=8)
    printed = printed_labels(capsys.readouterr().out)
    assert match_labels(printed, jax_labels("probe_decoder.py")) == [
        "device"]
    assert sum("conv dilation=" in x for x in printed) == 4
    assert len(out) == 10

