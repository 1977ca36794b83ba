"""The frozen yardstick: the flagship book's count as recorded (B = 500
American calls with the golden dividends, 50 x 25 x 20: 0.853 GFLOP and
8.5 MB, bound by operations at 0.0127 ms)."""

import pytest

from perfbench import roofline

GOLDEN = ((0.2, 0.5, 0.02), (0.4, 0.3, 0.02), (0.6, 0.2, 0.02),
          (0.8, 0.1, 0.02))


def test_flagship_count():
    ev = roofline.dividend_steps(GOLDEN, 1.0 / 20, 20)
    assert len(ev) == 4
    ms, by, flops, nbytes = roofline.kernel_bound(
        [20] * 500, roofline.lane_events(ev, [20] * 500), 51, 26, len(ev),
        4, True)
    assert (flops, nbytes, by) == (853_240_000, 8_530_000, "operations")
    assert ms == pytest.approx(0.0127349, rel=1e-5)


def test_lane_events_and_extras():
    ev = roofline.dividend_steps(GOLDEN, 1.0 / 20, 20)
    assert roofline.lane_events(ev, [2, 4, 10, 20]) == [0, 1, 2, 4]
    base = roofline.kernel_bound([4, 8], [1, 2], 51, 26, 2, 4, True)
    tan = roofline.kernel_bound([4, 8], [0, 0], 51, 26, 0, 4, False,
                                n_tangents=4, per_lane=True)
    assert tan[2] > base[2]
