"""K1's work count against a count made by hand."""
import pytest

from benchmark.metrics import k1_work, peaks


def test_bytes_by_hand():
    # one f64 system of 2 block rows of 9 x 9: D 2 blocks, U 1, b and x
    # 2 x 9 each
    assert k1_work.bytes_moved(1, 2, "float64") == 8 * (2 * 81 + 81 + 36)
    assert k1_work.bytes_moved(3, 2, "float32") == 3 * 4 * (3 * 81 + 36)


def test_flops_by_hand():
    k = 9
    schur = 2 * k**3 + k**2
    rhs = 2 * k**2 + k
    lu = 2 * k**3 / 3
    solve = 2 * k**2 * (k + 1)
    back = 2 * k**2 + k
    assert k1_work.flops(1, 1) == pytest.approx(schur + rhs + lu + solve
                                                + back)
    assert k1_work.flops(9, 448) == pytest.approx(9 * 448 * 3987.0)


def test_stream_shape_is_bytes_bound():
    assert k1_work.bound_by(9, 448, "float64") == "bytes"
    t = k1_work.min_seconds(9, 448, "float64")
    assert t == pytest.approx(k1_work.bytes_moved(9, 448, "float64")
                              / peaks.BYTES_PER_S)
    assert 1.7e-6 < t < 1.8e-6
