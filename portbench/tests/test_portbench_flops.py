"""The operation and byte counts against counts made by hand."""

from types import SimpleNamespace

import pytest

from portbench import flops
from portbench.drivers import predict32m, predict256m
from portbench.drivers._cascade import CascadeDriver


def test_tower_stage0_by_hand():
    # stage 0 over 2 rows of 32 Mb: a 4->64 conv and three 64->64 convs,
    # k=9, at every bp; bf16 reads the packed one-hot (4 B a bp) and
    # writes 64 channels at 1/4 of the positions (stage 1's pool)
    s0 = flops.tower_stages(2, 32_000_000, "bfloat16")[0]
    positions = 2 * 32_000_000
    assert s0["flops"] == 2 * positions * 9 * (4 * 64 + 3 * 64 * 64)
    w = 9 * (4 * 64 + 3 * 64 * 64) * 2
    assert s0["bytes"] == positions * 4 + (positions // 4) * 64 * 2 + w


def test_tower_stage1_fp32_by_hand():
    s1 = flops.tower_stages(2, 32_000_000, "float32")[1]
    positions = 2 * 32_000_000 // 4
    assert s1["flops"] == 2 * positions * 9 * (64 * 96 + 3 * 96 * 96)
    w = 9 * (64 * 96 + 3 * 96 * 96) * 4
    assert s1["bytes"] == (positions * 64 * 4 + (positions // 4) * 96 * 4
                           + w)


def test_decoder_block_by_hand():
    # one dilated block: 3x3 convs 64->32 and 32->64 on a 250x250 map
    block = 2 * 250 * 250 * 9 * (64 * 32 + 32 * 64)
    head = 2 * 250 * 250 * (64 * 5 + 5 * 1)
    combiners = 2 * 250 * 250 * 9 * (129 * 64 + 3 * 64 * 64)
    assert flops.decoder_flops(1, 250, coarse=False) == (
        combiners + 56 * block + head)
    refine = 2 * 250 * 250 * 9 * (65 * 64 + 3 * 64 * 64)
    assert flops.decoder_flops(2, 250, coarse=True) == 2 * (
        combiners + refine + 55 * block + head)


def test_pyramid_by_hand():
    # 2 levels over 16 bins: down 4 convs at 8 and at 4 bins; up 4 at 8
    # and 4 at 16
    conv = 2 * 9 * 128 * 128
    assert flops.pyramid_flops(1, 16, 2) == conv * 4 * (8 + 4 + 8 + 16)


def _counts(driver, family: str, models: int):
    """A driver's counts, without building its models."""
    geom = {"32m": {"window_bp": 32_000_000, "bin_bp": 4000, "crop": 250,
                    "levels": [1, 2, 4, 8, 16, 32]},
            "256m": {"window_bp": 256_000_000, "bin_bp": 32000, "crop": 250,
                     "levels": [32, 64, 128, 256]}}[family]
    stub = SimpleNamespace(geom=geom, levels=tuple(geom["levels"]),
                           models=models, traffic={"precision": "bfloat16"})
    return driver.request_flops(stub)


def test_request_flops_by_driver():
    one = _counts(predict32m.Driver, "32m", 1)
    two = _counts(predict32m.Driver, "32m", 2)
    assert {k: 2 * v for k, v in one.items()} == two
    # the tower holds most of the work
    assert one["tower"] > one["pyramid"] + one["decoders"]
    assert one["tower"] == flops.tower_flops(2, 32_000_000)
    # at 256 Mb: the 5-level pyramid over 64,000 bins of 4 kb and the
    # 3-level one over 2,000 bins of 128 kb; four decoders and no 1 Mb head
    big = _counts(predict256m.Driver, "256m", 1)
    assert big["pyramid"] == (flops.pyramid_flops(2, 64_000, 5)
                              + flops.pyramid_flops(2, 2_000, 3))
    assert big["decoders"] == sum(flops.decoder_flops(2, 250, j > 0)
                                  for j in range(4))
    assert big["tower"] == 8 * one["tower"]


def test_a_driver_without_counts_raises():
    stub = SimpleNamespace()
    with pytest.raises(NotImplementedError):
        CascadeDriver.request_flops(stub)


def test_peaks_by_card_name():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert flops.peaks("NVIDIA H100 PCIe")[2] == 2.0e12
