"""The two cells after the first benchmark's queue, on the CPU: the 1 Mb
window batches (`orca1m.bf16.windows`) at a 128 kb window, one window a
request, and the 32 Mb zoom scan (`orca32m.bf16.zoomscan`) at the tiny 32 Mb
geometry; the 1 Mb cell's control, runs with its timed path broken
underneath (each has to come out not correct), the zoom scan's shared
windows, the 1 Mb reference's imports, the 2-D stack's counts and its
roofline reader."""

import copy

import pytest

from portbench import control, flops, flops1m, harness
from portbench.drivers import predict1m, zoomscan32m
from portbench.metrics import decoder1m_roofline
from portbench_tiny import SEED, run_tiny, tiny_spec
from test_portbench_nojax import _loaded

WINDOWS = "orca1m.bf16.windows"
ZOOM = "orca32m.bf16.zoomscan"


def tiny_1m_spec(**traffic_changes) -> dict:
    """The 1 Mb cell at a 128 kb window (32 bins; narrower windows leave the
    pooled RMS to the tracks), one window a request."""
    spec = copy.deepcopy(harness.cell_spec(harness.load_manifest(), WINDOWS))
    spec["config"]["geometry"]["window_bp"] = 128_000
    spec["traffic"].update(pool_bp=512_000, n_run_bp=[4000, 40000],
                           windows_per_request=1, check_requests=1)
    spec["traffic"].update(traffic_changes)
    return spec


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_1m_cell_correct_on_cpu(traced):
    result = run_tiny(tiny_1m_spec(), traced=traced)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    m = result["metrics"]
    if traced:
        # no device operation on the CPU: the rooflines are left out
        assert {"input_ms", "mfu", "device_idle_share"} <= set(m)
        assert "decoder1m_roofline" not in m and "tower_roofline" not in m
    else:
        assert set(m) == {"mb_per_s", "request_s_p90", "peak_device_gib",
                          "setup_s"}


def test_zoomscan_cell_correct_on_cpu():
    result = run_tiny(tiny_spec(ZOOM))
    assert result["correct"], result["checks"]
    assert result["checks"]["coord_mismatch"]["value"] == 0


def test_1m_fp8_control_fails_the_limits():
    line = control.calibrate(tiny_1m_spec(), SEED, "cpu")
    assert line["program_correct"], line["program"]
    assert not line["control_correct"], line["control"]


def _tracks_forward_half(real):
    def run(pred, tracks, n):  # the tracks' reverse-complement half left out
        pred, _ = real(pred, tracks, n)
        return pred, tracks[:n]
    return run


def _one_track_altered(real):
    def run(net, feats, num_1d):
        out = real(net, feats, num_1d).clone().contiguous()
        out.view(-1)[out.numel() // 3] += 0.5
        return out
    return run


def _one_map_altered(real):
    def run(pred, tracks, n):
        pred, tracks = real(pred, tracks, n)
        pred = pred.clone()
        pred[-1].view(-1)[pred[-1].numel() // 3] += 0.5 * pred.abs().max()
        return pred, tracks
    return run


FAULTS = [("_combine_rc", _tracks_forward_half),
          ("_tracks_1m", _one_track_altered),
          ("_combine_rc", _one_map_altered)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__ for _, f in FAULTS])
def test_broken_1m_program_is_not_correct(monkeypatch, name, fault):
    from orca_tpu_torch.predict import onemb

    monkeypatch.setattr(onemb, name, fault(getattr(onemb, name)))
    result = run_tiny(tiny_1m_spec(precision="float32",
                                   windows_per_request=2))
    assert not result["correct"], result["checks"]


def test_zoomscan_requests_share_windows_in_groups_of_8():
    spec = tiny_spec(ZOOM)
    driver = object.__new__(zoomscan32m.Driver)
    driver.seed, driver.traffic = SEED, spec["traffic"]
    driver.geom = spec["config"]["geometry"]
    reqs = [driver.request(i) for i in range(-8, 24)]
    groups = [reqs[k:k + 8] for k in range(0, len(reqs), 8)]
    assert len({g[0]["offset"] for g in groups}) == len(groups)
    zoom = spec["traffic"]["zoom_bp"]
    for g in groups:
        assert {r["offset"] for r in g} == {g[0]["offset"]}
        assert len({r["mpos"] for r in g}) > 1
        assert all(abs(r["mpos"] - r["wpos"]) <= zoom for r in g)
    assert driver.request(3) == reqs[8 + 3]


def test_1m_reference_loads_nothing_of_the_program():
    found, port = _loaded("import portbench.reference.orca1m, "
                          "portbench.weights1m, portbench.flops1m")
    assert not port and found == []


def test_1m_driver_refuses_a_program_without_its_steps():
    predict1m._check_steps(["orca_tpu_torch.predict.onemb._decode_1m"])
    with pytest.raises(RuntimeError, match="onemb._absent"):
        predict1m._check_steps(["orca_tpu_torch.predict.onemb._absent"])


def test_2d_stack_counts():
    rows, crop = 3, 7
    layers = flops1m.decoder1m_layers(rows, crop, "bfloat16")
    assert len(layers) == 1 + 2 * 2 * 19 + 2
    assert sum(x["flops"] for x in layers) == flops.decoder1m_flops(rows,
                                                                    crop)
    # the pairwise map: the (3, 7, 128) encoding read, the map written
    assert layers[0] == {"flops": 0,
                         "bytes": 2 * (3 * 7 * 128 + 3 * 49 * 128)}
    # the first conv, 128 -> 32, 3x3: its input, output, weights and bias
    assert layers[1] == {"flops": 2 * 3 * 49 * 9 * 128 * 32,
                         "bytes": 2 * (3 * 49 * (128 + 32) + 9 * 128 * 32
                                       + 32)}
    assert flops1m.final1d_flops(2, 5, 22) == 2 * 2 * 5 * 128 * (128 + 22)
    least = flops1m.decoder1m_least_seconds(rows, crop, "bfloat16", 1e12,
                                            1e11)
    assert least == sum(max(x["flops"] / 1e12, x["bytes"] / 1e11)
                        for x in layers)


def test_2d_stack_geometry_and_roofline_reader():
    driver = object.__new__(predict1m.Driver)
    driver.windows, driver.window_bp, driver.models = 32, 1_000_000, 2
    driver.num_1d = [32, 22]
    counts = driver.request_flops()
    assert flops1m.decoder1m_geometry(counts) == (128, 250)
    least = flops1m.decoder1m_least_seconds(64, 250, "bfloat16", 989e12)
    run = {"request_flops": counts, "precision": "bfloat16",
           "peak_flops": 989e12,
           "requests": [{"trace": {"spans": {"onemb._decode_1m": {
               "calls": 2, "device_s": 4 * least}}}}] * 3}
    # two calls of 64 rows a request, each in twice its least time
    assert decoder1m_roofline.read(run) == pytest.approx(50.0)
    run["requests"] = [{"trace": {"spans": {}}}] * 3
    assert decoder1m_roofline.read(run) is None
