"""The port's encoder tower and pyramid (orca_tpu_torch/nn/encoders.py)
against orca_tpu.nn.encoders, on parameter trees built with numpy from the
JAX package's specs.

The tower runs monolithic and blocked with a partial last block, against the
JAX tower on its lax path and with its Pallas path forced on in interpret
mode. fp32: max|d| <= 1e-4; bf16: within twice the JAX tower's own
bf16-vs-fp32 difference.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.nn import encoders as jenc
from orca_tpu.nn.core import fold_params
from orca_tpu.utils import config as jcfg
from orca_tpu_torch.models.from_jax import params_from_numpy
from orca_tpu_torch.nn import encoders as tenc


def share_cpu_with_other_workers():
    """pytest-xdist runs several test processes at once, and torch's intra-op
    pool defaults to one thread per core in each: the surplus threads spin
    against each other. Give each process its share of the cores. The
    cascade and decoder tests take this through their import of this
    module."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, -(-cores // workers)))


share_cpu_with_other_workers()


def numpy_tree(spec, rng):
    """A parameter tree for a JAX-package spec (Block/Unit nestings), drawn
    from numpy: torch's conv init law and non-trivial BatchNorm statistics."""
    if hasattr(spec, "units"):
        return [numpy_tree(u, rng) for u in spec.units]
    if hasattr(spec, "cin"):
        shape = (spec.k,) * spec.dim + (spec.cin, spec.cout)
        lim = 1.0 / np.sqrt(spec.cin * spec.k ** spec.dim)
        p = {"w": rng.uniform(-lim, lim, shape).astype(np.float32),
             "b": rng.uniform(-lim, lim, spec.cout).astype(np.float32)}
        if spec.bn:
            c = spec.cout
            p["bn"] = {
                "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
            }
        return p
    if isinstance(spec, dict):
        return {k: numpy_tree(v, rng) for k, v in spec.items()}
    return [numpy_tree(s, rng) for s in spec]


def folded_tower(seed):
    """(numpy tree, JAX tree) of a folded encoder tower."""
    spec = jenc.encoder_tower_spec()
    jtree = fold_params(
        jax.tree.map(jnp.asarray, numpy_tree(spec, np.random.RandomState(seed))),
        spec,
    )
    return jax.tree.map(np.asarray, jtree), jtree


def onehot(seed, n, length, packed=False):
    rng = np.random.RandomState(seed)
    x = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (n, length))]
    x[:, rng.randint(0, length, length // 50)] = 0.25  # unknown bases
    return (x * 4).astype(np.uint8) if packed else x


def max_rel(a, b):
    return np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max()


def test_tower_monolithic_matches_lax_and_pallas():
    host, jtree = folded_tower(0)
    x = onehot(1, 1, 24000)
    want = jenc.apply_encoder_tower(jtree, jnp.asarray(x))
    got = tenc.apply_encoder_tower(params_from_numpy(host, "cpu"),
                                   torch.from_numpy(x))
    assert got.shape == (1, 6, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    old = jcfg.get_config()
    try:
        jcfg.set_config(dataclasses.replace(
            old, use_pallas=True, interpret_pallas=True,
            pallas_block_bp=24000))
        pallas = jenc.apply_encoder_tower(jtree, jnp.asarray(x))
    finally:
        jcfg.set_config(old)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                               atol=1e-4)


def test_tower_blocked_partial_last_block():
    """40 kb in 16 kb blocks (the last half full) with an 8 kb halo: the
    halo is below the receptive field, so this checks the blocked semantics
    (padding, per-row masks, halo crop), not equality with monolithic."""
    host, jtree = folded_tower(2)
    x = onehot(3, 2, 40000, packed=True)
    kw = dict(block_bp=16000, halo_bp=8000, block_group=2)
    want = jenc.apply_encoder_tower(jtree, jnp.asarray(x), **kw)
    got = tenc.apply_encoder_tower(params_from_numpy(host, "cpu"),
                                   torch.from_numpy(x), **kw)
    assert got.shape == (2, 10, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_tower_blocked_matches_pallas_interpret():
    host, jtree = folded_tower(4)
    x = onehot(5, 1, 20000)
    kw = dict(block_bp=8000, halo_bp=4000, block_group=2)
    old = jcfg.get_config()
    try:
        jcfg.set_config(dataclasses.replace(
            old, use_pallas=True, interpret_pallas=True))
        want = jenc.apply_encoder_tower(jtree, jnp.asarray(x), **kw)
    finally:
        jcfg.set_config(old)
    got = tenc.apply_encoder_tower(params_from_numpy(host, "cpu"),
                                   torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("length,kw", [
    (12000, {}),  # one piece: the monolithic plain stages
    # two blocks, the last half full: the masked plain stages
    (24000, dict(block_bp=16000, halo_bp=8000, block_group=1)),
])
def test_tower_unfolded_takes_plain_stages_on_cpu(length, kw):
    """Unfolded (BatchNorm) parameters on a CPU tensor run the plain
    unfused stages, against the JAX tower's lax path on the same tree."""
    tree = numpy_tree(jenc.encoder_tower_spec(), np.random.RandomState(12))
    x = onehot(13, 1, length, packed=True)
    want = jenc.apply_encoder_tower(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x), **kw)
    got = tenc.apply_encoder_tower(params_from_numpy(tree, "cpu"),
                                   torch.from_numpy(x), **kw)
    assert got.shape == (1, length // 4000, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_masked_stages_unfolded_and_fused():
    """Per-row valid ranges: the masked path on unfolded (BatchNorm)
    parameters and the fused path on folded ones."""
    spec = jenc.encoder_tower_spec()
    tree = numpy_tree(spec, np.random.RandomState(6))
    x = onehot(7, 2, 16000)
    vs, ve = [4000, 0], [12000, 16000]
    want = jenc.apply_encoder_stages_masked(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(vs),
        jnp.asarray(ve))
    got = tenc.apply_encoder_stages_masked(params_from_numpy(tree, "cpu"),
                                           torch.from_numpy(x), vs, ve)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    folded = jax.tree.map(np.asarray,
                          fold_params(jax.tree.map(jnp.asarray, tree), spec))
    fused = tenc.apply_encoder_stages_fused(params_from_numpy(folded, "cpu"),
                                            torch.from_numpy(x), vs, ve)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="folded"):
        tenc.apply_encoder_stages_fused(params_from_numpy(tree, "cpu"),
                                        torch.from_numpy(x), vs, ve)


def test_tower_bf16_within_bf16_noise():
    host, jtree = folded_tower(8)
    x = onehot(9, 1, 12000, packed=True)
    tower = jax.jit(jenc.apply_encoder_tower)  # eager bf16 compiles per op
    jb = tower(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree), jnp.asarray(x))
    jf = tower(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32),
                     jtree),
        jnp.asarray(x))
    got = tenc.apply_encoder_tower(
        params_from_numpy(host, "cpu", torch.bfloat16), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    noise = max_rel(jb, jf)
    assert max_rel(got.float().numpy(), jb) <= 2 * noise


@pytest.mark.parametrize("up_pass", [True, False])
def test_pyramid(up_pass):
    spec = jenc.pyramid_spec(5, up_pass)
    tree = numpy_tree(spec, np.random.RandomState(10))
    x = np.random.RandomState(11).randn(2, 64, 128).astype(np.float32)
    want = jenc.apply_pyramid(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                              levels=5, up_pass=up_pass)
    got = tenc.apply_pyramid(params_from_numpy(tree, "cpu"),
                             torch.from_numpy(x), levels=5, up_pass=up_pass)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("n,length,groups", [
    (2, 16_000_000, 4),  # 4 Mb blocks, one block x 2 rows per group
    (2, 1_024_000, 1),  # fits two blocks: one piece
    (3, 4_000_000, 1),  # one block long: one piece
])
def test_fused_group_count_matches_blocking(monkeypatch, n, length, groups):
    """fused_group_count, which chip_smoke.py checks the launch counters
    against, equals the number of fused-stage runs the tower makes (each
    launches both kernels once); a 32 Mb fwd+RC window takes 8."""
    runs = []

    def fake_stages(params, seg, vs, ve):
        runs.append(seg.shape)
        return torch.zeros(seg.shape[0], seg.shape[1] // 4000, 128)

    monkeypatch.setattr(tenc, "apply_encoder_stages_fused", fake_stages)
    params = {"lconv": [[{"w": torch.zeros(1)}]]}  # folded: no "bn"
    out = tenc.apply_encoder_tower(
        params, torch.zeros((n, length, 4), dtype=torch.uint8))
    assert out.shape == (n, length // 4000, 128)
    assert len(runs) == tenc.fused_group_count(n, length) == groups
    assert tenc.fused_group_count(2, 32_000_000) == 8
