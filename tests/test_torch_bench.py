"""The port's benchmark (orca_tpu_torch/bench.py, bench_training.py) on the
CPU, against the JAX package's `bench.py` and `scripts/bench_training.py`.

  * the 32 Mb run function on a numpy-built folded bundle and the
    benchmark's packed sequence, at CascadeGeometry(1_024_000, 4000, 8),
    against JAX's `_cascade_32mb`: zoom starts equal, the last level's map
    within 2.0e-6 (fp32), the checksums within 1e-6 relative;
  * the 256 Mb run function at CascadeGeometry(8_192_000, 32_000, 8) with
    the background built as `bench.py` builds it, against JAX's
    `_cascade_256mb`, the encoder step replaced in both packages by the same
    seeded encodings (the CPU tower at this window is too slow for the fast
    gate): starts equal, maps within 1e-4, the bar of
    test_torch_cascade_256m.py, and the checksums within 1e-6 relative;
  * the three training benchmarks at tiny configs return finite positive
    values under exactly the keys of `scripts/bench_training.py`'s functions
    (read from its source);
  * `bench.main()` at both scaled geometries prints one JSON line whose keys
    are `bench.py`'s `result` keys (read from its source) and
    `power_limit_w`.
"""

import ast
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.predict import multiscale as jms
from orca_tpu.predict.retrieval import assemble_normmat as jax_assemble_normmat
from orca_tpu_torch import bench, bench_training
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.predict import multiscale as tms
from orca_tpu_torch.training import stages
from orca_tpu_torch.training.stages import (
    StageAConfig,
    StageBConfig,
    StageCConfig,
)
from orca_tpu_torch.utils.tree import tree_leaves
from test_torch_cascade import jax_bundle
from test_torch_cascade_256m import (
    encodings,
    jax_256m_bundle,
    replace_encoders,
)
from test_torch_encoders import share_cpu_with_other_workers

share_cpu_with_other_workers()

REPO = pathlib.Path(__file__).resolve().parent.parent
GEOM32_J = jms.CascadeGeometry(1_024_000, 4000, 8)
GEOM32_T = tms.CascadeGeometry(1_024_000, 4000, 8)
GEOM256_J = jms.CascadeGeometry(8_192_000, 32_000, 8)
GEOM256_T = tms.CascadeGeometry(8_192_000, 32_000, 8)
ERROR_KEYS = {"bench_256m_error", "bench_train_error"}


def _returned_keys(path, function):
    """The keys of the dict literal `function` returns in `path`."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def _bench_result_keys():
    """Every key `bench.py`'s `main` puts in `result`: the dict literal's
    and each `result["..."] = ...`."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "result":
            keys.update(k.value for k in node.value.keys)
        elif (isinstance(target, ast.Subscript)
              and isinstance(target.value, ast.Name)
              and target.value.id == "result"):
            keys.add(target.slice.value)
    return keys


def _checksum_close(got, want):
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_run_32m_matches_jax_cascade():
    jb = jax_bundle(geom=GEOM32_J)
    tb = bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    seq = bench._packed_window(GEOM32_T.window_bp, "cpu")
    assert seq.shape == (1, GEOM32_T.window_bp, 4) and seq.dtype == torch.uint8
    pos = GEOM32_T.window_bp / 2
    preds_j, starts_j = jms._cascade_32mb(
        jb, GEOM32_J, jnp.asarray(seq.numpy()), jnp.float32(pos),
        jnp.float32(pos), jnp.asarray(jb.log_normmats()))
    want_sum = float(jnp.sum(preds_j[-1]))
    got_sum, (preds, starts) = bench._run_32m([tb], GEOM32_T, seq, pos, pos,
                                              tb.log_normmats())
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_j))
    assert preds.shape == preds_j.shape
    np.testing.assert_allclose(preds[-1].numpy(), np.asarray(preds_j[-1]),
                               rtol=0, atol=2.0e-6)
    _checksum_close(got_sum, want_sum)


def test_run_256m_matches_jax_cascade(monkeypatch):
    # a cis expectation NaN past 100 bins, so the background's NaN fill runs
    jb = jax_256m_bundle()
    jb = dataclasses.replace(jb, background_cis=np.hstack(
        [jb.background_cis[:100], np.repeat(np.nan, 200)]))
    tb = bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    replace_encoders(monkeypatch, encodings())
    # bench.py's first chromosome, 145.1 of 256 Mb, scaled with the window
    chrlen = GEOM256_J.window_bp * 145_100_000 // 256_000_000
    chrlen -= chrlen % GEOM256_J.bin_bp
    assert bench._chrlen(GEOM256_T) == chrlen
    assert bench._chrlen(tms.GEOM_256M) == 145_100_000 - 145_100_000 % 32000
    # the background as bench.py:221-227 builds it
    want_nm = jax_assemble_normmat(
        [["chrM", 0, chrlen, "+"],
         ["chrP", 0, GEOM256_J.window_bp - chrlen, "+"]],
        jb.background_cis, jb.background_trans, binsize=GEOM256_J.bin_bp,
    ).astype(np.float32)
    mask = np.isnan(want_nm)
    assert mask.any()
    want_nm[mask] = np.nanmin(want_nm[~mask])
    nm = bench._background_256m(tb, GEOM256_T)
    np.testing.assert_array_equal(nm, want_nm)

    seq = bench._packed_window(GEOM256_T.window_bp, "cpu")
    preds_j, starts_j, _ = jms._cascade_256mb(
        jb, GEOM256_J, jnp.asarray(seq.numpy()),
        jnp.float32(GEOM256_J.window_bp / 4),
        jnp.float32(GEOM256_J.window_bp / 2), jnp.float32(chrlen),
        jnp.asarray(want_nm))
    want_sum = float(jnp.sum(preds_j[-1].astype(jnp.float32)))
    got_sum, (preds, starts, _) = bench._run_256m(tb, GEOM256_T, seq,
                                                  torch.from_numpy(nm))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_j))
    for j in range(len(preds)):
        np.testing.assert_allclose(preds[j].numpy(), np.asarray(preds_j[j]),
                                   rtol=0, atol=1e-4,
                                   err_msg=f"level index {j}")
    _checksum_close(got_sum, want_sum)


def _stand_in_tower(p, s):
    """Seeded (N, L/4000, 128) features in place of the frozen tower, whose
    CPU run at stage c's least window (2.048 Mb) would take most of this
    file's time."""
    gen = torch.Generator().manual_seed(7)
    return torch.randn(s.shape[0], s.shape[1] // 4000, 128, generator=gen)


@pytest.mark.parametrize("stage", ["a", "b", "c"])
def test_training_benchmarks_return_the_jax_keys(stage, monkeypatch):
    if stage == "a":
        got = bench_training.bench_stage_a(
            batch=2, iters=1, cfg=StageAConfig(num_1d=4, crop=10,
                                               seq_len=40_000),
            device="cpu")
    elif stage == "b":
        got = bench_training.bench_stage_b(
            iters=1, cfg=StageBConfig(geometry=tms.CascadeGeometry(
                256_000, 4000, 2), encoder_block_bp=None, levels=(32, 1)),
            device="cpu")
    else:
        monkeypatch.setattr(stages, "_default_encoder_fn",
                            lambda block_bp: _stand_in_tower)
        got = bench_training.bench_stage_c(
            iters=1, cfg=StageCConfig(geometry=tms.CascadeGeometry(
                2_048_000, 32_000, 2), encoder_block_bp=None),
            device="cpu")
    want = _returned_keys(REPO / "scripts" / "bench_training.py",
                          f"bench_stage_{stage}")
    assert set(got) == want
    for key, value in got.items():
        if key == "stage_a_dtype":
            assert value == "float32"
        else:
            assert math.isfinite(value) and value > 0, (key, value)


def _stand_in_encodings(monkeypatch):
    """Both cascades' encoder steps return seeded encodings in the bundle's
    dtype (the plain CPU tower would take minutes over main's requests)."""
    def encs(bundle, seq, levels, bins):
        dtype = tree_leaves(bundle.decoders)[0].dtype
        gen = torch.Generator().manual_seed(11)
        return {lv: torch.randn(2 * seq.shape[0], bins // lv, 128,
                                generator=gen).to(dtype) for lv in levels}

    monkeypatch.setattr(
        tms, "_encode_32mb", lambda bundle, seq2, mesh=None: encs(
            bundle, seq2[: seq2.shape[0] // 2], tms.LEVEL_ORDER,
            seq2.shape[1] // 4000))
    monkeypatch.setattr(
        tms, "_encode_256mb_fwd_rc", lambda bundle, seq, mesh=None: encs(
            bundle, seq, (32, 64, 128, 256), seq.shape[1] // 4000))


def test_main_prints_the_jax_benchmark_line(monkeypatch, capsys):
    _stand_in_encodings(monkeypatch)
    for name in ("ORCA_BENCH_DTYPE", "ORCA_BENCH_SKIP_FP32",
                 "ORCA_BENCH_SKIP_256M"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ORCA_BENCH_ITERS", "1")
    monkeypatch.setenv("ORCA_BENCH_SKIP_TRAIN", "1")
    result = bench.main(GEOM32_T, GEOM256_T, device="cpu")
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == result
    assert set(line) == (_bench_result_keys() - ERROR_KEYS) | {"power_limit_w"}
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["dtype"] == "bfloat16"
    assert line["value"] == pytest.approx(
        GEOM32_T.window_bp / 1e6 / line["seconds_per_32Mb_window"])
    assert line["mb_per_s_256m"] == pytest.approx(
        GEOM256_T.window_bp / 1e6 / line["seconds_per_256Mb_window"])
    for key, value in line.items():
        if isinstance(value, float):
            assert math.isfinite(value) and value > 0, (key, value)
    assert "section 256Mb float32" in err


def test_bench_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench._measure_256m("bfloat16", 1)
    for fn in (bench_training.bench_stage_b, bench_training.bench_stage_c):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


# --------------------------------------------------------------------------
# bench_training enc (the JAX script's bench_encoder_paths)
# --------------------------------------------------------------------------


def _assigned_keys(path, function, name="out"):
    """The keys `function` in `path` assigns as `name["..."] = ...`."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    return {t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Name) and t.value.id == name}


def _encoder_case(seed, batch, length):
    """(unfolded numpy tower, folded numpy tower, packed uint8 sequence)."""
    from orca_tpu.nn import encoders as jenc
    from orca_tpu.nn.core import fold_params as jfold
    from test_torch_encoders import numpy_tree

    spec = jenc.encoder_tower_spec()
    raw = numpy_tree(spec, np.random.RandomState(seed))
    folded = jax.tree.map(np.asarray, jfold(jax.tree.map(jnp.asarray, raw),
                                            spec))
    codes = np.random.RandomState(seed + 1).randint(0, 4, (batch, length))
    return raw, folded, (np.eye(4, dtype=np.uint8) * 4)[codes]


def test_encoder_forward_paths_match_jax_tower():
    """Both forward paths the enc mode times (the kernels' plain versions on
    the CPU, and the plain stages) equal JAX's apply_encoder_tower on the
    same folded parameters within 2.0e-6 * max(1, max|ref|) in fp32."""
    from orca_tpu.nn import encoders as jenc
    from orca_tpu_torch.models.from_jax import params_from_numpy

    _, folded, seq = _encoder_case(8, 2, 40_000)
    want = np.asarray(jenc.apply_encoder_tower(
        jax.tree.map(jnp.asarray, folded), jnp.asarray(seq)))
    tf = params_from_numpy(folded, "cpu")
    with torch.inference_mode():
        for fn in (bench_training.encoder_forward,
                   bench_training.encoder_forward_stages):
            got = fn(tf, torch.from_numpy(seq)).numpy()
            assert got.shape == want.shape == (2, 10, 128)
            d = np.abs(got - want).max()
            assert d <= 2.0e-6 * max(1.0, np.abs(want).max()), (fn, d)


def _jax_encoder_train_step(p, s):
    """The JAX script's `train_step` (scripts/bench_training.py) with its
    two float32 casts made to the parameters' dtype, which is what they are
    in fp32: the input's (exact; JAX's conv refuses float32 input with
    float64 weights) and the loss's (a float32 loss would round the float64
    step's)."""
    from orca_tpu.nn import encoders as jenc
    from orca_tpu.nn.core import BNUpdates

    dtype = jax.tree.leaves(p)[0].dtype

    def loss(p):
        bn = BNUpdates()
        out = jenc.apply_encoder_stages(
            p, s.astype(dtype) * 0.25, train=True,
            rng=jax.random.PRNGKey(0), bn_updates=bn, path="encoder",
        )
        return jnp.mean(out.astype(dtype) ** 2)

    l, g = jax.value_and_grad(loss)(p)
    return l, jax.tree.map(lambda a: jnp.sum(a), g)


def test_encoder_train_step_matches_jax_float64():
    """The enc mode's training step (live BatchNorm, fwd + bwd) in float64:
    the loss and every leaf's gradient sum within 1e-9 * max(1, |ref|) of
    the JAX script's step. The tower draws nothing (no dropout)."""
    from orca_tpu_torch.models.from_jax import params_from_numpy

    raw, _, seq = _encoder_case(9, 2, 24_000)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), raw)
        wl, wg = jax.jit(_jax_encoder_train_step)(p64, jnp.asarray(seq))
        wl, wg = float(wl), [float(v) for v in jax.tree.leaves(wg)]
    finally:
        jax.config.update("jax_enable_x64", x64)
    gl, gg = bench_training.encoder_train_step(
        params_from_numpy(raw, "cpu", torch.float64), torch.from_numpy(seq))
    # jax.tree.leaves' order (dict keys sorted) on both trees
    gg = jax.tree.leaves(jax.tree.map(float, gg))
    assert abs(float(gl) - wl) <= 1e-9 * max(1.0, abs(wl)), (float(gl), wl)
    assert len(gg) == len(wg)
    for i, (g, w) in enumerate(zip(gg, wg)):
        assert abs(g - w) <= 1e-9 * max(1.0, abs(w)), (i, g, w)


def test_bench_encoder_paths_returns_the_jax_keys():
    got = bench_training.bench_encoder_paths(batch=1, seq_len=24_000,
                                             iters=1, device="cpu")
    want = _assigned_keys(REPO / "scripts" / "bench_training.py",
                          "bench_encoder_paths")
    assert set(got) == want
    for key, value in got.items():
        assert math.isfinite(value) and value > 0, (key, value)
    assert got["enc_pallas_vs_xla_fwd"] == pytest.approx(
        got["enc_fwd_xla_s"] / got["enc_fwd_pallas_s"])


def test_bench_training_main_takes_enc(monkeypatch, capsys):
    """`python -m orca_tpu_torch.bench_training enc` runs the enc mode (its
    function replaced: main resolves the card) and prints its line; an
    unknown mode still exits 2."""
    monkeypatch.setattr(bench_training, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(bench_training.torch.cuda, "get_device_name",
                        lambda d: "stand-in card")
    monkeypatch.setattr(bench_training, "bench_encoder_paths",
                        lambda: {"enc_fwd_pallas_s": 1.0})
    assert bench_training.main(["enc"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == {"device": "stand-in card", "enc_fwd_pallas_s": 1.0}
    assert bench_training.main(["enc,d"]) == 2


# --------------------------------------------------------------------------
# scripts/bench_256m.py
# --------------------------------------------------------------------------


def _bench_256m_source():
    tree = ast.parse((REPO / "scripts" / "bench_256m.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def test_bench_256m_times_the_bench_window():
    """The JAX script's window (its chromosome length, zoom and window
    positions, read from its source) is the one `bench._measure_256m` times
    at production geometry, which the port's bench_256m reuses."""
    values = {}
    for node in ast.walk(_bench_256m_source()):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                         ast.Name)
                and node.targets[0].id in ("chrlen", "mpos", "wpos")):
            expr = node.value
            if isinstance(expr, ast.Call):  # jnp.float32(...)
                expr = expr.args[0]
            values[node.targets[0].id] = eval(compile(ast.Expression(expr),
                                                      "bench_256m", "eval"))
    assert values["chrlen"] == bench._chrlen(tms.GEOM_256M)
    assert values["mpos"] == tms.GEOM_256M.window_bp / 4
    assert values["wpos"] == tms.GEOM_256M.window_bp / 2


def test_bench_256m_prints_the_jax_line(monkeypatch, capsys):
    from orca_tpu_torch.scripts import bench_256m

    _stand_in_encodings(monkeypatch)
    monkeypatch.setenv("ORCA_BENCH_ITERS", "1")
    monkeypatch.delenv("ORCA_BENCH_DTYPE", raising=False)
    calls = []
    real = bench_256m._measure_256m

    def measured(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(bench_256m, "_measure_256m", measured)
    line = bench_256m.main(GEOM256_T, device="cpu")
    assert calls == [("bfloat16", 1, GEOM256_T, torch.device("cpu"))]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line
    keys = next(n for n in ast.walk(_bench_256m_source())
                if isinstance(n, ast.Dict))
    assert set(line) == {k.value for k in keys.keys} | {"power_limit_w"}
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["dtype"] == "bfloat16"
    assert line["value"] == pytest.approx(
        GEOM256_T.window_bp / 1e6 / line["seconds_per_256Mb_window"])
    for key in ("value", "seconds_per_256Mb_window", "compile_s"):
        assert math.isfinite(line[key]) and line[key] > 0, key

