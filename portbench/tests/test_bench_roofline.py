"""The work counts of the rooflines, checked by hand on small cases."""

import pytest

from portbench import roofline


def test_code_bits():
    assert [roofline.code_bits(n) for n in (1, 2, 3, 4, 5, 27, 461)] == \
        [1, 1, 2, 2, 3, 5, 9]


def test_scan_work_by_hand():
    # 8192 bytes, 4 classes (2-bit codes): 2048 bytes of codes; 11 states
    # (4-bit entries) x 4 classes: 22 bytes of table; 4 chunks of 2048,
    # each a 4-bit state and a 32-bit word: 4 x 36 / 8 = 18 bytes
    moved, ops = roofline.scan_work(8192, 11, 4, 2048)
    assert moved == 2048 + 22 + 18
    assert ops == 8192
    # 27 classes: 5-bit codes; 461 states: 9-bit entries; a ragged last
    # chunk counts as a chunk
    moved, ops = roofline.scan_work(5000, 461, 27, 2048)
    assert moved == 5000 * 5 / 8 + 461 * 27 * 9 / 8 + 3 * (9 + 32) / 8
    assert ops == 5000


def test_bound_picks_the_larger_peak():
    t, what = roofline.bound_seconds(1 << 30, 11, 4, 2048)
    moved, _ = roofline.scan_work(1 << 30, 11, 4, 2048)
    assert what == "bytes"
    assert t == pytest.approx(moved / roofline.HBM_BYTES_PER_S)
    # one class: 1-bit codes, 1 state: the bytes bound 1/8 byte a byte,
    # 3.35e12 * 8 bytes a second against 67e12 steps: still bytes
    t, what = roofline.bound_seconds(1 << 30, 1, 1, 1 << 30)
    assert what == "bytes"


def test_the_cells_bounds():
    # the cell's shards: 1920 MiB, 983,040 chunks of 2048 bytes
    n = 1920 << 20
    wide, _ = roofline.bound_seconds(n, 147, 5, 2048)
    assert wide == pytest.approx((n * 3 / 8 + 147 * 5 * 8 / 8
                                  + 983040 * 40 / 8) / 3.35e12)
    assert 0.226e-3 < wide < 0.227e-3
