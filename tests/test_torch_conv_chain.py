"""The port's fused conv-chain functions (orca_tpu_torch/ops/kernels/
conv_chain.py) against the JAX package's Pallas kernels in interpret mode,
and the CUDA kernels against their plain versions on a card.

On the CPU the port's functions take their plain versions, which must match
`fused_conv_chain_packed` / `fused_first_stage_packed` to fp32 max|d| <= 1e-4
(summation order differs) and, in bf16, to within twice the Pallas kernel's
own bf16-vs-fp32 difference on the same inputs.

The CUDA tests (the kernels, and the dispatch to them of the encoder tower
and of the 1 Mb model) run where there is a card and no JAX:
    python -m pytest --noconftest -m gpu tests/test_torch_conv_chain.py
"""

import math

import numpy as np
import pytest
import torch

from orca_tpu_torch.ops.kernels import conv_chain as cc

try:  # the card's machine runs only the CUDA test, without JAX
    import jax.numpy as jnp

    from orca_tpu.ops.pallas.conv1d import (
        fused_conv_chain_packed,
        fused_first_stage_packed,
        pack2,
        unpack2,
    )
except ImportError:
    jnp = None


def _need_jax():
    if jnp is None:
        pytest.skip("the JAX package is not installed")


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _chain_weights(rng, cin, c, n):
    out = []
    for k in range(n):
        ci = cin if k == 0 else c
        lim = 1.0 / np.sqrt(9 * ci)
        out.append((rng.uniform(-lim, lim, (9, ci, c)).astype(np.float32),
                    rng.uniform(-lim, lim, (c,)).astype(np.float32)))
    return out


def _torch_w(weights, dtype=torch.float32):
    return [(torch.from_numpy(w).to(dtype), torch.from_numpy(b).to(dtype))
            for w, b in weights]


def _jax_w(weights, dtype=None):
    dtype = dtype or jnp.float32
    return tuple((jnp.asarray(w, dtype), jnp.asarray(b, dtype))
                 for w, b in weights)


def _bounds(vs, ve):
    return (torch.tensor(vs, dtype=torch.int32),
            torch.tensor(ve, dtype=torch.int32))


CHAIN_CASES = [
    # relus, residual_idx, out_pool, positions, per-row (vs, ve), JAX tile
    ((False, False, True, True), 1, 1, 160, ([0, 8], [160, 150]), 0),
    ((False, False, True, True), 1, 4, 160, ([0, 16], [160, 144]), 64),
    ((False, True, True), 0, 5, 320, ([20, 0], [300, 320]), 80),
    ((True, True, True, True), -1, 2, 160, ([0, 0], [160, 96]), 32),
]


@pytest.mark.parametrize("relus,res_idx,pool,length,bounds,tile", CHAIN_CASES)
def test_chain_plain_matches_pallas(relus, res_idx, pool, length, bounds,
                                    tile):
    _need_jax()
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, length, 16)
    weights = _chain_weights(rng, 16, 24, len(relus))
    vs, ve = bounds
    want = unpack2(fused_conv_chain_packed(
        pack2(jnp.asarray(x)), _jax_w(weights), jnp.asarray(vs),
        jnp.asarray(ve), relus=relus, residual_idx=res_idx, tile=tile,
        out_pool=pool, interpret=True,
    ))
    got = cc.fused_conv_chain(
        torch.from_numpy(x), _torch_w(weights), *_bounds(vs, ve),
        relus=relus, residual_idx=res_idx, out_pool=pool,
    )
    assert got.shape == (2, length // pool, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_chain_plain_bf16_within_bf16_noise():
    _need_jax()
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 160, 16)
    weights = _chain_weights(rng, 16, 24, 4)
    vs, ve = [0, 8], [160, 144]
    kw = dict(relus=(False, False, True, True), residual_idx=1, out_pool=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = _jax_w(weights, jnp.bfloat16)
    jb = unpack2(fused_conv_chain_packed(
        pack2(xb), wb, jnp.asarray(vs), jnp.asarray(ve), interpret=True, **kw))
    # fp32 on the bf16-rounded values: the kernel's own rounding noise
    jf = unpack2(fused_conv_chain_packed(
        pack2(xb.astype(jnp.float32)),
        tuple((w.astype(jnp.float32), b.astype(jnp.float32)) for w, b in wb),
        jnp.asarray(vs), jnp.asarray(ve), interpret=True, **kw))
    got = cc.fused_conv_chain(
        torch.from_numpy(x).to(torch.bfloat16),
        _torch_w(weights, torch.bfloat16), *_bounds(vs, ve), **kw)
    assert got.dtype == torch.bfloat16
    noise = np.abs(np.asarray(jb, np.float32) - np.asarray(jf)).max()
    d = np.abs(got.float().numpy() - np.asarray(jb, np.float32)).max()
    assert noise > 0
    assert d <= 2 * noise, (d, noise)


@pytest.mark.parametrize("as_uint8,pool,tile", [(True, 4, 0), (False, 1, 320)])
def test_first_stage_plain_matches_pallas(as_uint8, pool, tile):
    _need_jax()
    rng = np.random.RandomState(3)
    length = 1280
    onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, length))]
    onehot[:, ::7] = 0.25  # unknown bases
    x = (onehot * 4).astype(np.uint8) if as_uint8 else onehot
    conv0, *chain = _chain_weights(rng, 4, 32, 4)
    vs, ve = [0, 16], [length, length - 32]
    kw = dict(relus=(False, True, True), residual_idx=0, out_pool=pool)
    want = unpack2(fused_first_stage_packed(
        jnp.asarray(x).reshape(2, length // 16, 64), _jax_w([conv0])[0],
        _jax_w(chain), jnp.asarray(vs), jnp.asarray(ve), tile=tile,
        interpret=True, **kw,
    ))
    got = cc.fused_first_stage(
        torch.from_numpy(x), _torch_w([conv0])[0], _torch_w(chain),
        *_bounds(vs, ve), **kw,
    )
    assert got.shape == (2, length // pool, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_cpu_tensors_never_launch():
    rng = np.random.RandomState(4)
    before = (cc.fused_conv_chain.launches, cc.fused_first_stage.launches)
    x = torch.from_numpy(_rand(rng, 1, 40, 8))
    cc.fused_conv_chain(x, _torch_w(_chain_weights(rng, 8, 8, 4)),
                        *_bounds([0], [40]), relus=(False,) * 4)
    assert (cc.fused_conv_chain.launches,
            cc.fused_first_stage.launches) == before


# --------------------------------------------------------------------------
# On a card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

GPU_CASES = [
    # stage 0: uint8 and float one-hot input
    ("first", 4, 64, 4, 5000, ([0, 400], [5000, 4600]), "u8"),
    ("first", 4, 64, 1, 1203, ([0, 0], [1203, 1000]), "float"),
    # chain stages: encoder widths, every pool, ragged last tiles
    ("chain", 64, 96, 4, 2500, ([0, 100], [2500, 2400]), 1),
    ("chain", 96, 128, 5, 1000, ([0, 25], [1000, 975]), 1),
    ("chain", 128, 128, 5, 333, ([3, 0], [330, 333]), 1),
    ("chain", 128, 128, 2, 210, ([0, 10], [210, 200]), 1),
    ("chain", 128, 128, 1, 100, ([0, 0], [100, 60]), -1),
    # the largest tiles (bf16: 488 positions at 64 channels, 232 at 96,
    # 200 at 128 with pool 5; fp32: 232 at 64, 168 at 96), each with a
    # ragged last tile
    ("first", 4, 64, 4, 40_000, ([0, 1000], [40_000, 38_500]), "u8"),
    ("first", 4, 64, 1, 33_001, ([0, 7], [33_001, 32_990]), "float"),
    ("chain", 64, 64, 4, 40_000, ([0, 123], [40_000, 39_877]), 1),
    ("chain", 64, 96, 4, 20_000, ([0, 5], [19_993, 20_000]), 1),
    ("chain", 96, 128, 5, 15_100, ([0, 0], [15_100, 15_000]), 1),
    # a valid range that starts and ends inside one warp's 16 rows of an
    # m64 MMA tile
    ("chain", 128, 128, 1, 3000, ([19, 0], [28, 3000]), -1),
    ("first", 4, 64, 2, 3000, ([19, 0], [28, 3000]), "u8"),
    # fp32 at 96 channels: a valid range inside one thread's 6 positions
    ("chain", 64, 96, 4, 3000, ([13, 0], [17, 3000]), 1),
    # rows shorter than one tile: most threads of a level have no position
    ("chain", 64, 64, 4, 12, ([0, 2], [12, 9]), 1),
    ("first", 4, 64, 2, 10, ([0, 1], [10, 8]), "u8"),
    # the standalone 1 Mb model: one piece of a 1 Mb window per row, valid
    # everywhere (zero padding at the window's edges), stages 0-6
    ("first", 4, 64, 4, 1_000_000, ([0, 0], [1_000_000] * 2), "u8"),
    ("chain", 64, 96, 4, 250_000, ([0, 0], [250_000] * 2), 1),
    ("chain", 96, 128, 5, 62_500, ([0, 0], [62_500] * 2), 1),
    ("chain", 128, 128, 5, 12_500, ([0, 0], [12_500] * 2), 1),
    ("chain", 128, 128, 5, 2_500, ([0, 0], [2_500] * 2), 1),
    ("chain", 128, 128, 2, 500, ([0, 0], [500] * 2), 1),
    ("chain", 128, 128, 1, 250, ([0, 0], [250] * 2), -1),
    # the training steps' frozen tower: one 1.024 Mb piece (an 800 kb block
    # and its 112 kb halos) per row, row 0 the window's first block, whose
    # leading halo lies outside the sequence; stages 0-6
    ("first", 4, 64, 4, 1_024_000, ([112_000, 0], [1_024_000] * 2), "u8"),
    ("chain", 64, 96, 4, 256_000, ([28_000, 0], [256_000] * 2), 1),
    ("chain", 96, 128, 5, 64_000, ([7_000, 0], [64_000] * 2), 1),
    ("chain", 128, 128, 5, 12_800, ([1_400, 0], [12_800] * 2), 1),
    ("chain", 128, 128, 5, 2_560, ([280, 0], [2_560] * 2), 1),
    ("chain", 128, 128, 2, 512, ([56, 0], [512] * 2), 1),
    ("chain", 128, 128, 1, 256, ([28, 0], [256] * 2), -1),
]


def _stage_shapes():
    import chip_smoke

    return chip_smoke.stage_shapes()


# production stages (2 rows each) and the GPU cases' shapes
PLAN_SHAPES = [(2, length, pool, cin, c, i == 0)
               for i, (length, cin, c, pool, _) in enumerate(_stage_shapes())]
PLAN_SHAPES += [(2, length, pool, cin, c, kind == "first")
                for kind, cin, c, pool, length, _, _ in GPU_CASES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,length,pool,cin,c,first", PLAN_SHAPES)
def test_tile_plan(dtype, rows, length, pool, cin, c, first):
    """Tiles are multiples of the pool and of 8 and at least 16, and their
    shared memory fits a block; a length with enough work for the smallest
    such tile fills 132 SMs."""
    dtype = getattr(torch, dtype)
    tile = cc.plan_tile(rows, length, pool, cin, c, dtype, first, sms=132)
    assert tile % pool == 0 and tile % 8 == 0 and tile >= 16
    assert cc.smem_bytes(cin, c, tile, dtype, first) <= 227 * 1024
    base = math.lcm(8, pool)
    if rows * -(-length // (base * -(-16 // base))) >= 132:
        assert rows * -(-length // tile) >= 132
    if dtype == torch.bfloat16:  # conv 0's tile + 24 rows fit the m64 tiles
        assert -(-(tile + 24) // 64) * 64 <= (512 if c == 64 else 256)


def test_tile_plan_fills_the_card_at_the_small_stages():
    """Production stages 4-6 launch at least one full wave of 132 blocks;
    stages 0-3 take the largest tile of their width and pool."""
    want = {torch.bfloat16: [488, 232, 200, 200],
            torch.float32: [232, 168, 160, 160]}
    for dtype in (torch.bfloat16, torch.float32):
        tiles = []
        for i, (length, cin, c, pool, _) in enumerate(_stage_shapes()):
            tile = cc.plan_tile(2, length, pool, cin, c, dtype, i == 0,
                                sms=132)
            tiles.append(tile)
            if i >= 4:
                assert 2 * -(-length // tile) >= 132, (i, tile)
        assert tiles[:4] == want[dtype]
        assert tiles[4:] == [160, 32, 16]


@pytest.mark.parametrize("cin,c,tile,first,want", [
    (4, 64, 232, True, 151_552),    # stage 0
    (64, 96, 168, False, 178_176),  # stage 1
])
def test_fp32_smem_count_at_production_widths(cin, c, tile, first, want):
    """The fp32 kernel at 64 and 96 channels: two activation buffers of
    tile + 32 and tile + 24 positions and a weight ring of 2 x 36 x C
    floats."""
    assert cc.smem_bytes(cin, c, tile, torch.float32, first) == want


FFMA_PT = {64: 8, 96: 6}  # positions per thread of the fp32 kernel


@pytest.mark.parametrize(
    "rows,length,pool,cin,c,first",
    [s for s in PLAN_SHAPES if s[4] in FFMA_PT])
def test_fp32_tile_fits_one_pass(rows, length, pool, cin, c, first):
    """At 64 and 96 channels every fp32 conv is one pass of 256 threads x PT
    positions: conv 0's tile + 24 positions fit 32 PT."""
    tile = cc.plan_tile(rows, length, pool, cin, c, torch.float32, first,
                        sms=132)
    assert tile + 24 <= 32 * FFMA_PT[c]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,cin,c,pool,length,bounds,extra", GPU_CASES)
def test_cuda_kernel_matches_plain(dtype, kind, cin, c, pool, length, bounds,
                                   extra):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dtype = getattr(torch, dtype)
    rng = np.random.RandomState(5)
    vs, ve = (t.cuda() for t in _bounds(*bounds))
    if kind == "first":
        weights = _torch_w(_chain_weights(rng, cin, c, 4), dtype)
        onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, length))]
        x = (torch.from_numpy((onehot * 4).astype(np.uint8)) if extra == "u8"
             else torch.from_numpy(onehot).to(dtype))
        args = (x.cuda(), *[(w.cuda(), b.cuda()) for w, b in weights[:1]],
                [(w.cuda(), b.cuda()) for w, b in weights[1:]], vs, ve)
        kw = dict(relus=(False, True, True), residual_idx=0, out_pool=pool)
        kern, plain = cc.fused_first_stage, cc.fused_first_stage_plain
    else:
        weights = _torch_w(_chain_weights(rng, cin, c, 4), dtype)
        x = torch.from_numpy(_rand(rng, 2, length, cin)).to(dtype).cuda()
        args = (x, [(w.cuda(), b.cuda()) for w, b in weights], vs, ve)
        kw = dict(relus=(False, False, True, True), residual_idx=extra,
                  out_pool=pool)
        kern, plain = cc.fused_conv_chain, cc.fused_conv_chain_plain
    before = kern.launches
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = plain(*args, **kw)
    assert got.shape == ref.shape == (2, length // pool, c)
    assert got.dtype == ref.dtype == dtype
    d = (got.float() - ref.float()).abs().max().item()
    m = ref.float().abs().max().item()
    tol = 1e-4 * max(1.0, m) if dtype == torch.float32 else 2e-2 * m
    assert d <= tol, (d, m)


@pytest.mark.gpu
def test_cuda_tower_runs_kernels_or_refuses():
    """On a CUDA tensor the encoder tower always launches the fused kernels:
    unfolded (BatchNorm) parameters and a length that is not a multiple of
    4000 are refused before any launch; folded parameters launch each
    kernel once for a one-piece input and match the CPU plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from orca_tpu_torch.models.zoo import _map_tensors
    from orca_tpu_torch.nn import encoders
    from orca_tpu_torch.nn.core import fold_params

    raw = encoders.init_encoder_tower(torch.Generator().manual_seed(0))
    folded = fold_params(raw, encoders.encoder_tower_spec())
    rng = np.random.RandomState(6)
    onehot = np.eye(4, dtype=np.uint8)[rng.randint(0, 4, (2, 24000))] * 4
    x = torch.from_numpy(onehot)

    def counts():
        return cc.fused_first_stage.launches, cc.fused_conv_chain.launches

    def cuda(tree):
        return _map_tensors(tree, lambda t: t.cuda())

    before = counts()
    with pytest.raises(ValueError, match="folded"):
        encoders.apply_encoder_tower(cuda(raw), x.cuda())
    with pytest.raises(ValueError, match="multiple of 4000"):
        encoders.apply_encoder_tower(cuda(folded), x[:, :22000].cuda())
    assert counts() == before
    got = encoders.apply_encoder_tower(cuda(folded), x.cuda())
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 6)
    want = encoders.apply_encoder_tower(folded, x)
    d = (got.cpu() - want).abs().max().item()
    assert d <= 1e-4 * max(1.0, want.abs().max().item()), d


@pytest.mark.gpu
def test_cuda_1m_net_runs_kernels_or_refuses():
    """The standalone 1 Mb model on the card: an unfolded net is refused
    before any launch; a folded one launches each fused kernel once a call
    (the window is one piece whatever the batch) and matches the CPU plain
    path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from orca_tpu_torch.models import zoo
    from orca_tpu_torch.predict import onemb

    raw = zoo.random_1m_bundle(0, num_1d=8, device="cpu")
    folded = zoo.fold_1m_bundle(raw)
    rng = np.random.RandomState(11)
    seq = np.eye(4, dtype=np.uint8)[rng.randint(0, 4, (3, 40_000))] * 4

    def counts():
        return cc.fused_first_stage.launches, cc.fused_conv_chain.launches

    before = counts()
    with pytest.raises(ValueError, match="folded"):
        onemb.predict_1m(zoo._map_params(raw, lambda t: t.cuda()), seq)
    assert counts() == before
    got = onemb.predict_1m(zoo._map_params(folded, lambda t: t.cuda()), seq,
                           with_1d=True, rc_average=True)
    assert counts() == (before[0] + 1, before[1] + 6)
    want = onemb.predict_1m(folded, seq, with_1d=True, rc_average=True,
                            device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


@pytest.mark.gpu
def test_cuda_launch_on_another_card_keeps_the_current_device():
    """With two cards: a kernel launched on cuda:1 matches its plain version
    and leaves the thread's current device at cuda:0, and the encoder tower
    sharded over (cuda:0, cuda:1) equals the one-card tower with cuda:0
    still current, so a later unindexed "cuda" still means cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from orca_tpu_torch.models.zoo import _map_tensors
    from orca_tpu_torch.nn import encoders
    from orca_tpu_torch.nn.core import fold_params
    from orca_tpu_torch.parallel import make_mesh, sharded_encoder_tower

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    torch.cuda.set_device(0)
    rng = np.random.RandomState(12)
    weights = [(w.to(cards[1]), b.to(cards[1]))
               for w, b in _torch_w(_chain_weights(rng, 64, 64, 4))]
    x = torch.from_numpy(_rand(rng, 2, 4000, 64)).to(cards[1])
    vs, ve = (t.to(cards[1]) for t in _bounds([0, 100], [4000, 3900]))
    kw = dict(relus=(False, False, True, True), residual_idx=1, out_pool=4)
    got = cc.fused_conv_chain(x, weights, vs, ve, **kw)
    assert torch.cuda.current_device() == 0
    want = cc.fused_conv_chain_plain(x, weights, vs, ve, **kw)
    d = (got - want).abs().max().item()
    print(f"kernel on cuda:1: max|d| vs plain {d:.3e}")
    assert d <= 1e-4 * max(1.0, want.abs().max().item()), d

    raw = encoders.init_encoder_tower(torch.Generator().manual_seed(0))
    folded = _map_tensors(fold_params(raw, encoders.encoder_tower_spec()),
                          lambda t: t.to(cards[0]))
    onehot = np.eye(4, dtype=np.uint8)[rng.randint(0, 4, (1, 448_000))] * 4
    seq = torch.from_numpy(onehot).to(cards[0])
    want = encoders.apply_encoder_tower(folded, seq)
    before = cc.fused_conv_chain.launches
    got = sharded_encoder_tower(folded, seq, make_mesh((1, 2), devices=cards))
    assert torch.cuda.current_device() == 0
    assert cc.fused_conv_chain.launches > before
    assert got.device == cards[0]
    torch.cuda.synchronize(cards[1])
    d = (got - want).abs().max().item()
    print(f"tower over (cuda:0, cuda:1): max|d| vs one card {d:.3e}")
    assert d <= 2.0e-6 * max(1.0, want.abs().max().item()), d
