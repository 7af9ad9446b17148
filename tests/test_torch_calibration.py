"""PyTorch port vs JAX: the NEES calibration functions (evalx/calibration)
and the stream driver's NEES tracking, on the same inputs (f64, CPU).

Bounds: every calibration function within 1e-12 relative of JAX's on
states and information matrices drawn from a numpy seed.  The NEES streams
run test_torch_stream.py's gapped 3600 s arc at the fixed 20-iteration budget
(max_iters=0) against JAX with its Thomas solve: the same recorded times,
each window's terminal marginal within 1e-6 relative (Frobenius) of
JAX's, its estimate within 1e-6 km and its GT equal to 1e-12.  The
auto-calibrated bounded stream runs in tests/test_torch_checkpoint.py."""
import numpy as np
import pytest

from torch_parity import random_states, torch_one_thread  # noqa: F401
from vinsat_tpu import pipeline as jpipeline
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import window as jwindow
from vinsat_tpu.evalx import calibration as jcal
from vinsat_tpu_torch.estimation import window
from vinsat_tpu_torch.evalx import calibration

TOL = 1e-12
SIM_KW = dict(duration_s=3600, frame_stride=10, along_track=True,
              pass_every_s=1200, pass_len_s=240)


def _samples(seed=0, n=5):
    """n (H9, est, gt) triples: SPD information of a wide dynamic range,
    estimates a few km / mrad / m/s off the GT states."""
    rng = np.random.default_rng(seed)
    gts = random_states(rng, n)
    ests = gts.copy()
    ests[:, :3] += rng.normal(size=(n, 3)) * 2.0
    dq = np.concatenate([rng.normal(size=(n, 3)) * 5e-3, np.ones((n, 1))],
                        axis=1)
    dq /= np.linalg.norm(dq, axis=1, keepdims=True)
    # est quaternion = gt ⊗ dq (x, y, z, w)
    x1, y1, z1, w1 = gts[:, 3:7].T
    x2, y2, z2, w2 = dq.T
    ests[:, 3:7] = np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                             w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                             w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                             w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=1)
    ests[:, 7:10] += rng.normal(size=(n, 3)) * 1e-3
    A = rng.normal(size=(n, 9, 9))
    scale = np.concatenate([np.full(3, 1e2), np.full(3, 1e6),
                            np.full(3, 1e8)])
    H = (A @ np.swapaxes(A, 1, 2) + 9 * np.eye(9)) * np.sqrt(
        scale[:, None] * scale[None, :])
    return list(H), list(ests), list(gts)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _dict_rel(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(_rel(got[k], want[k]) for k in want)


@pytest.mark.parametrize("fn", ["pose_error_tangent", "nees", "block_nees"])
def test_per_sample_functions_match_jax(fn):
    H, ests, gts = _samples()
    for h, e, g in zip(H, ests, gts):
        args = (e, g) if fn == "pose_error_tangent" else (e, g, h)
        got = getattr(calibration, fn)(*args)
        want = getattr(jcal, fn)(*args)
        err = (_dict_rel(got, want) if isinstance(want, dict)
               else _rel(got, want))
        assert err < TOL, (fn, err)


def test_calibrate_and_apply_inflation_match_jax():
    H, ests, gts = _samples(1)
    c = calibration.calibrate_inflation(H, ests, gts)
    cj = jcal.calibrate_inflation(H, ests, gts)
    assert _dict_rel(c, cj) < TOL
    assert max(c.values()) > 1.0  # an overconfident block to calibrate
    for h in H:
        assert _rel(calibration.apply_inflation(h, c),
                    jcal.apply_inflation(h, cj)) < TOL


def test_floors_from_inflation_matches_jax():
    H, ests, gts = _samples(2)
    c = jcal.calibrate_inflation(H, ests, gts)
    c["rot"] = 0.5  # an inflation below 1 maps to floor 0
    got = calibration.floors_from_inflation(H, c)
    want = jcal.floors_from_inflation(H, c)
    assert got[1] == want[1] == 0.0
    assert _rel(got, want) < TOL


def test_track_nees_stream_matches_jax():
    seq = jpipeline.simulate_sequence(1, **SIM_KW)
    kw = dict(max_iters=0, track_nees=True)
    want = jwindow.stream_orbit(
        seq.det_rows, seq.orbit_pos_eci_km, seed=1,
        cfg=jwindow.StreamingConfig(**kw),
        solver=jba.SolverParams(tridiag_variant="thomas"))
    got = window.stream_orbit(seq.det_rows, seq.orbit_pos_eci_km, seed=1,
                              cfg=window.StreamingConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.times, want.times)
    n = len(want.window_infos)
    assert n >= 3 and got.window_infos.shape == (n, 9, 9)
    for Hg, Hw in zip(got.window_infos, want.window_infos):
        assert np.linalg.norm(Hg - Hw) / np.linalg.norm(Hw) < 1e-6
    assert np.abs(got.window_est[:, :3] - want.window_est[:, :3]).max() < 1e-6
    np.testing.assert_allclose(got.window_gt, want.window_gt, rtol=TOL,
                               atol=0)
    for i in range(n):
        assert _dict_rel(
            calibration.block_nees(got.window_est[i], got.window_gt[i],
                                   got.window_infos[i]),
            jcal.block_nees(want.window_est[i], want.window_gt[i],
                            want.window_infos[i])) < 1e-5
