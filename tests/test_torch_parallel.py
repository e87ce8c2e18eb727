"""The port's device meshes and sequence-sharded inference
(orca_tpu_torch/parallel, the `mesh` arguments of predict/multiscale.py and
`--seq-shards` on the command line) against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's meshes name the one CPU device several times
(`[torch.device("cpu")] * k`), which computes what k devices would.

  * `make_mesh` and `inference_mesh_from_seq_shards`: shapes, axis names and
    error texts equal to JAX's;
  * `sharded_encoder_tower` at L = 448 kb on meshes (1, 2) and (1, 4) with
    one row and (2, 2) with two: within 1e-4 of JAX's sharded tower on the
    same folded parameters (carried across with models/from_jax.py), and
    within 2.0e-6 of the port's one-device tower;
  * `genomepredict` with a (1, 2) mesh, passed as `mesh=` and set with
    `set_inference_mesh`, at CascadeGeometry(1_024_000, 4000, 8): starts
    equal to JAX's `genomepredict` with a (1, 2) mesh, fp32 maps within
    2.0e-6;
  * `genomepredict_256mb` with a (1, 2) mesh at CascadeGeometry(8_192_000,
    32_000, 8): starts equal to the port's unsharded call, maps within
    2.0e-6. The real tower at this window takes minutes of CPU a call, so
    here both calls run a cheap local stand-in for it (a masked k=9 conv,
    max-pooled to 4 kb bins) through the same shards, halos, bounds and
    gather; the real tower's shards are held above at 448 kb, and at
    256 Mb on the card by chip_smoke.py;
  * `--seq-shards` on a prediction command sets the inference mesh; a count
    that does not divide the devices fails with JAX's message.
"""

import jax
import numpy as np
import pytest
import torch

from orca_tpu.parallel import mesh as jmesh
from orca_tpu.parallel import sequence as jseq
from orca_tpu.predict import multiscale as jms
from orca_tpu_torch import cli as tcli
from orca_tpu_torch import parallel as tpar
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.models.from_jax import params_from_numpy
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.parallel import mesh as tmesh
from orca_tpu_torch.parallel import sequence as tseq
from orca_tpu_torch.predict import multiscale as tms
from test_torch_cascade import GEOM_J, GEOM_T, WPOS, bundles  # noqa: F401
from test_torch_cascade import sequence
from test_torch_encoders import folded_tower, onehot

CPU = torch.device("cpu")
TOWER_BP = 448_000
FP32_BAR = 2.0e-6


@pytest.fixture(autouse=True)
def no_inference_mesh(monkeypatch):
    """Each test starts with no inference mesh in either package and leaves
    none behind."""
    monkeypatch.setattr(tmesh, "_INFERENCE_MESH", None)
    monkeypatch.setattr(jmesh, "_INFERENCE_MESH", None)


def cpu_mesh(shape):
    return tpar.make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


def error_text(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("axis_sizes", [None, (1, 2), (2, 2), (1, 4), (4, 2),
                                        (1, 8), (2, 1)])
def test_make_mesh_shapes_equal_jax(axis_sizes):
    want = jmesh.make_mesh(axis_sizes)
    got = tpar.make_mesh(axis_sizes, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert sum(map(len, got.devices)) == want.devices.size
    assert all(d == CPU for row in got.devices for d in row)


def test_make_mesh_errors_equal_jax(monkeypatch):
    assert (error_text(tpar.make_mesh, (3, 3), [CPU] * 8)
            == error_text(jmesh.make_mesh, (3, 3)))
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device_type="cuda": [CPU] * 8)
    for shards in (3, 5, 16):
        assert (error_text(tmesh.inference_mesh_from_seq_shards, shards)
                == error_text(jmesh.inference_mesh_from_seq_shards, shards))
    for shards in (1, 2, 4, 8):
        want = jmesh.inference_mesh_from_seq_shards(shards)
        got = tmesh.inference_mesh_from_seq_shards(shards)
        assert got.shape == dict(want.shape)


def test_mesh_defaults_need_cuda():
    """With no devices named, a mesh is built over the CUDA cards; without
    CUDA it raises and never falls back to the CPU. The CPU mesh of
    --seq-shards under --cpu has the one CPU device."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.inference_mesh_from_seq_shards(1)
    assert tmesh.local_devices("cpu") == [CPU]
    assert tmesh.inference_mesh_from_seq_shards(
        1, device_type="cpu").shape == {"data": 1, "seq": 1}
    with pytest.raises(ValueError, match="does not divide 1 devices"):
        tmesh.inference_mesh_from_seq_shards(2, device_type="cpu")


def test_inference_mesh_set_and_cleared():
    mesh = cpu_mesh((1, 2))
    assert tmesh.get_inference_mesh() is None
    tmesh.set_inference_mesh(mesh)
    assert tmesh.get_inference_mesh() is mesh
    tmesh.set_inference_mesh(None)
    assert tmesh.get_inference_mesh() is None


def test_mesh_device_lookup():
    devices = [torch.device("meta"), CPU, CPU, torch.device("meta")]
    mesh = tpar.make_mesh((2, 2), devices=devices)
    assert mesh.devices == ((devices[0], CPU), (CPU, devices[3]))
    assert mesh.device(data=1, seq=0) == CPU
    assert mesh.device(seq=1) == CPU
    assert mesh.device(data=1, seq=1).type == "meta"


# --------------------------------------------------------------------------
# the sharded tower
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tower():
    """(port params, JAX params) of one folded tower, a packed input of two
    rows at 448 kb, and the port's one-device tower on it."""
    host, jtree = folded_tower(11)
    params = params_from_numpy(host, "cpu")
    x = onehot(12, 2, TOWER_BP, packed=True)
    with torch.inference_mode():
        one = tenc.apply_encoder_tower(params, torch.from_numpy(x))
    return params, jtree, x, one.numpy()


@pytest.mark.parametrize("shape,rows", [((1, 2), 1), ((1, 4), 1),
                                        ((2, 2), 2)])
def test_sharded_tower_matches_jax_and_one_device(tower, shape, rows):
    params, jtree, x, one = tower
    x, one = x[:rows], one[:rows]
    jax_mesh = jmesh.make_mesh(shape)
    want = np.asarray(jax.jit(
        lambda p, xx: jseq.sharded_encoder_tower(p, xx, jax_mesh))(jtree, x))
    with torch.inference_mode():
        got = tpar.sharded_encoder_tower(params, torch.from_numpy(x),
                                         cpu_mesh(shape)).numpy()
    assert got.shape == one.shape == want.shape == (rows, TOWER_BP // 4000,
                                                    128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, one, rtol=0, atol=FP32_BAR)


def test_sharded_tower_runs_each_shard_with_its_bounds(tower, monkeypatch):
    """Each shard reaches the one-device tower padded with its neighbours'
    edges (zeros at the ends), with [halo, ...) on the first shard and
    [..., halo + local) on the last; one row on a (2, 4) mesh runs on its
    first row of devices, four shards."""
    params, _, x, _ = tower
    seen = []

    def spy(p, xs, **kw):
        seen.append((xs.clone(), kw["valid_start_bp"], kw["valid_end_bp"],
                     kw["halo_bp"]))
        return xs.new_zeros((xs.shape[0], xs.shape[1] // 4000, 128))

    monkeypatch.setattr(tenc, "apply_encoder_tower", spy)
    xs = torch.from_numpy(x[:1])
    with torch.inference_mode():
        tpar.sharded_encoder_tower(params, xs, cpu_mesh((2, 4)))
    local, halo = TOWER_BP // 4, 112_000
    padded = torch.cat([xs.new_zeros(1, halo, 4), xs,
                        xs.new_zeros(1, halo, 4)], dim=1)
    assert [s[1:] for s in seen] == [(halo, local + 2 * halo, halo),
                                     (0, local + 2 * halo, halo),
                                     (0, local + 2 * halo, halo),
                                     (0, halo + local, halo)]
    for i, (seg, *_) in enumerate(seen):
        assert torch.equal(seg, padded[:, i * local : (i + 1) * local
                                       + 2 * halo])


def test_sharded_tower_refuses_bad_inputs(tower):
    params, _, x, _ = tower
    xs = torch.from_numpy(x[:1])
    with pytest.raises(ValueError, match="not a multiple"):
        tpar.sharded_encoder_tower(params, xs[:, :444_000], cpu_mesh((1, 2)))
    with pytest.raises(ValueError, match="shorter than the 112000 bp halo"):
        tpar.sharded_encoder_tower(params, xs, cpu_mesh((1, 8)))
    meta = tpar.make_mesh((1, 2), devices=[torch.device("meta")] * 2)
    with pytest.raises(ValueError, match="the input is on cpu"):
        tpar.sharded_encoder_tower(params, xs, meta)


def test_params_copied_once_per_device(tower):
    """A tree is used where it lives, and copied to another device of the
    mesh once."""
    params = tower[0]
    meta = torch.device("meta")
    mesh = tpar.make_mesh((1, 2), devices=[CPU, meta])
    assert tseq._params_on(params, CPU, mesh) is params
    first = tseq._params_on(params, meta, mesh)
    assert first["lconv"][0][0]["w"].device == meta
    assert tseq._params_on(params, meta, mesh) is first
    assert list(mesh.param_copies) == [(id(params), meta)]


# --------------------------------------------------------------------------
# the cascades with a mesh
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sharded_32m(bundles):  # noqa: F811
    """JAX's `genomepredict` with a (1, 2) mesh at the 1.024 Mb geometry."""
    mpos = int(GEOM_J.window_bp * 0.3)
    out = jms.genomepredict(sequence(), "chr1", mpos, WPOS, [bundles[0]],
                            geometry=GEOM_J, mesh=jmesh.make_mesh((1, 2)))
    return mpos, out


@pytest.mark.parametrize("how", ["mesh", "set_inference_mesh"])
def test_genomepredict_with_mesh_matches_jax(bundles, jax_sharded_32m,  # noqa: F811
                                             how):
    mpos, want = jax_sharded_32m
    mesh = cpu_mesh((1, 2))
    kw = {"mesh": mesh} if how == "mesh" else {}
    if how == "set_inference_mesh":
        tmesh.set_inference_mesh(mesh)
    got = tms.genomepredict(sequence(), "chr1", mpos, WPOS, [bundles[1]],
                            geometry=GEOM_T, device="cpu", **kw)
    tmesh.set_inference_mesh(None)
    assert got["start_coords"] == want["start_coords"]
    assert got["end_coords"] == want["end_coords"]
    for j, (g, w) in enumerate(zip(got["predictions"][0],
                                   want["predictions"][0])):
        np.testing.assert_allclose(g, w, rtol=0, atol=FP32_BAR,
                                   err_msg=f"level index {j}")


def local_tower(params, x, *, halo_bp, block_bp=None, valid_start_bp=None,
                valid_end_bp=None):
    """A stand-in for the encoder tower that is local as the tower is (its
    receptive field is 4 bp) and as cheap as one small conv: a 4 -> 8 k=9
    conv of the one-hot with a bias, zeroed outside [valid_start_bp,
    valid_end_bp), max-pooled to 4 kb bins and widened to 128 channels."""
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(8, 4, 9, generator=gen)
    b = torch.randn(8, generator=gen)
    widen = torch.randn(8, 128, generator=gen)
    n, length, _ = x.shape
    h = torch.nn.functional.conv1d(x.permute(0, 2, 1).float() * 0.25, w, b,
                                   padding=4)
    pos = torch.arange(length)
    vs = 0 if valid_start_bp is None else valid_start_bp
    ve = length if valid_end_bp is None else valid_end_bp
    h = h * ((pos >= vs) & (pos < ve)).float()
    pooled = h.view(n, 8, length // 4000, 4000).amax(-1)
    return torch.einsum("ncl,cd->nld", pooled, widen)


def test_genomepredict_mesh_reaches_the_sharded_tower(bundles, monkeypatch):  # noqa: F811
    """The global mesh reaches the tower through `genomepredict` and the
    warm-up; an explicit mesh= wins over it."""
    seen = []

    def tower(params, seq, mesh, **kw):
        seen.append(mesh)
        return torch.zeros(seq.shape[0], seq.shape[1] // 4000, 128)

    monkeypatch.setattr(tms, "sharded_encoder_tower", tower)
    small = tms.CascadeGeometry(512_000, 4000, 4)
    bundle = tzoo.fold_bundle(tzoo.random_32m_bundle(0, nbins=128, crop=4,
                                                     device="cpu"))
    glob, mine = cpu_mesh((1, 2)), cpu_mesh((1, 4))
    tmesh.set_inference_mesh(glob)
    tms.warmup_cascade_32m(bundle, small, device="cpu")
    seq = np.zeros((1, small.window_bp, 4), np.float32)
    tms.genomepredict(seq, "c", 256_000, 256_000, [bundle], geometry=small,
                      device="cpu")
    tms.genomepredict(seq, "c", 256_000, 256_000, [bundle], geometry=small,
                      device="cpu", mesh=mine)
    assert seen == [glob, glob, mine]


def test_genomepredict_256mb_with_mesh_matches_one_device(monkeypatch):
    monkeypatch.setattr(tenc, "apply_encoder_tower", local_tower)
    geom = tms.CascadeGeometry(8_192_000, 32_000, 8)
    bundle = tzoo.fold_256m_bundle(tzoo.random_256m_bundle(3, device="cpu"))
    chrlen = int(geom.window_bp * 0.75) // geom.bin_bp * geom.bin_bp
    rng = np.random.RandomState(4)
    normmat = np.exp(-rng.rand(geom.bins, geom.bins)).astype(np.float32)
    seq = (np.eye(4, dtype=np.uint8)[rng.randint(0, 4, (1, geom.window_bp))]
           * 4)
    args = (seq, "chrM", [normmat], chrlen, int(geom.window_bp * 0.7),
            geom.window_bp // 2, [bundle])
    want = tms.genomepredict_256mb(*args, geometry=geom, device="cpu")
    got = tms.genomepredict_256mb(*args, geometry=geom, device="cpu",
                                  mesh=cpu_mesh((1, 2)))
    assert got["start_coords"] == want["start_coords"]
    assert got["end_coords"] == want["end_coords"]
    assert len(got["predictions"][0]) == len(tzoo.LEVELS_256M)
    for j, (g, w) in enumerate(zip(got["predictions"][0],
                                   want["predictions"][0])):
        assert g.shape == (geom.crop, geom.crop)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=FP32_BAR,
                                   err_msg=f"level index {j}")


def test_local_tower_shards_like_the_tower(tower, monkeypatch):
    """The stand-in above shards as the tower does (its sharded run on a
    (1, 4) mesh equals its one-device run), and its bounds matter: the
    bias makes a padded zero region nonzero unless it is masked."""
    params, _, x, _ = tower
    xs = torch.from_numpy(x)
    one = local_tower(params, xs, halo_bp=112_000)
    monkeypatch.setattr(tenc, "apply_encoder_tower", local_tower)
    got = tpar.sharded_encoder_tower(params, xs, cpu_mesh((1, 4)))
    assert torch.equal(got, one)
    padded = torch.cat([xs.new_zeros(2, 112_000, 4), xs], dim=1)
    masked = local_tower(params, padded, halo_bp=112_000,
                         valid_start_bp=112_000)
    assert not torch.equal(masked, local_tower(params, padded,
                                               halo_bp=112_000))
    assert torch.equal(masked[:, 28:], one)


# --------------------------------------------------------------------------
# --seq-shards
# --------------------------------------------------------------------------


def test_seq_shards_sets_the_inference_mesh(monkeypatch, capsys):
    """`--seq-shards 2` over two devices sets a (1, 2) inference mesh before
    the prediction runs; 3 fails with JAX's message, before any model
    loads."""
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device_type="cuda": [CPU] * 2)
    seen = []
    monkeypatch.setattr(tcli, "_run_prediction",
                        lambda args, parser, res=None: seen.append(
                            tmesh.get_inference_mesh()))
    tcli.main(["region", "chr1:1-2", "out", "--cpu", "--seq-shards", "2"])
    assert len(seen) == 1 and seen[0].shape == {"data": 1, "seq": 2}
    assert seen[0].devices == ((CPU, CPU),)
    tmesh.set_inference_mesh(None)
    with pytest.raises(SystemExit) as e:
        tcli.main(["region", "chr1:1-2", "out", "--cpu", "--seq-shards", "3"])
    assert e.value.code == 2 and len(seen) == 1
    err = capsys.readouterr().err
    assert "seq_shards=3 does not divide 2 devices" in err
    assert tmesh.get_inference_mesh() is None
