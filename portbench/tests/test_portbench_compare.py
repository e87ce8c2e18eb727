"""The numbers that decide `correct`, on answers made by hand."""

import numpy as np

from portbench import compare


def _answer(maps, starts=(0, 5), ends=(10, 15), backgrounds=None):
    out = {"maps": maps, "starts": list(starts), "ends": list(ends)}
    if backgrounds is not None:
        out["backgrounds"] = backgrounds
    return out


def test_gaps_by_hand():
    want = _answer([[np.full((4, 4), 2.0), np.full((4, 4), -1.0)]])
    got_maps = [[np.full((4, 4), 2.0), np.full((4, 4), -1.0)]]
    got_maps[0][1] = got_maps[0][1].copy()
    got_maps[0][1][0, 0] += 0.4  # one value of the second map
    n = compare.numbers(_answer(got_maps), want)
    assert np.isclose(n["map_err"], 0.4)  # 0.4 over max|ref| 1
    assert n["coord_mismatch"] == 0


def test_coordinates_compare_exactly():
    want = _answer([[np.ones((2, 2))]])
    got = _answer([[np.ones((2, 2))]], starts=(0, 6), ends=(10, 16))
    assert compare.numbers(got, want)["coord_mismatch"] == 2


def test_unreadable_answers_are_worst():
    want = _answer([[np.ones((2, 2))]], backgrounds=[[np.ones((2, 2))]])
    nan = _answer([[np.full((2, 2), np.nan)]],
                  backgrounds=[[np.ones((2, 2))]])
    short = _answer([], backgrounds=[])
    for got in (nan, short):
        n = compare.numbers(got, want)
        assert n["map_err"] == compare.WORST
    assert compare.numbers(short, want)["background_err"] == compare.WORST
