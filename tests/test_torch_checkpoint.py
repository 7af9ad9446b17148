"""PyTorch port vs JAX: stream checkpoints (utils/checkpoint's npz) and the
resume from one, within the port and across the two packages (f64, CPU).

The streams run test_torch_stream.py's gapped 3600 s arc (3 windows) in the
bounded mode with NEES tracking and the anchor prior auto-calibrated from
the second window on (auto_calibrate_min_windows=1), so that a checkpoint
carries every extra field (marg_info, i_prev, nees_*) and a resume needs
them, at the fixed 20-iteration budget (max_iters=0); JAX solves with its
Thomas scan.  Bounds: the uninterrupted runs agree (the same recorded
times, errors within 1e-3 km, as test_torch_stream.py's; each window's
terminal marginal within 1e-6 relative, Frobenius); a run resumed from
the port's own checkpoint of any window equals the uninterrupted one
(times equal, errors and final states within 1e-12 relative, JAX's bar in
tests/test_streaming.py); a run resumed from the other package's
checkpoint gives that package's uninterrupted times, and errors within
1e-3 km of them."""
import os

import numpy as np
import pytest

from torch_parity import jax_runs_arc, torch_one_thread  # noqa: F401
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import window as jwindow
from vinsat_tpu.utils import checkpoint as jckpt
from vinsat_tpu_torch.estimation import window
from vinsat_tpu_torch.utils import checkpoint

SIM_KW = dict(duration_s=3600, frame_stride=10, along_track=True,
              pass_every_s=1200, pass_len_s=240)
CFG = dict(max_iters=0, marginalize=True, track_nees=True,
           auto_calibrate=True, auto_calibrate_min_windows=1)


def _fields(rng):
    return dict(states=rng.normal(size=(12, 10)),
                last_hessian=rng.normal(size=(9, 9)), window_idx=3,
                lamda=1e-3, knot_times=np.arange(12) * 5,
                errors=rng.random(7), times=np.arange(7) * 5,
                extra=dict(marg_info=rng.normal(size=(9, 9)),
                           i_prev=np.array(40),
                           nees_infos=rng.normal(size=(2, 9, 9))))


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("writer, reader", [(checkpoint, jckpt),
                                            (jckpt, checkpoint)])
@pytest.mark.parametrize("hessian", [True, False])
def test_checkpoint_file_crosses_packages(tmp_path, writer, reader, hessian):
    """A file written by either package loads the same in both."""
    f = _fields(np.random.default_rng(0))
    if not hessian:
        f["last_hessian"] = None
    writer.save(str(tmp_path / "ck.w3.npz"), **f)
    got = reader.load(str(tmp_path / "ck.w3"))
    other = (jckpt if reader is checkpoint else checkpoint).load(
        str(tmp_path / "ck.w3.npz"))
    _same(got, other)
    assert got["window_idx"] == 3 and got["lamda"] == 1e-3
    assert (got["last_hessian"] is None) == (not hessian)


def _seq():
    # JAX's simulation of the SIM_KW arc, committed (tests/data/
    # make_torch_jax_runs_fixture.py)
    return jax_runs_arc()


def _port(ck=None, resume=None):
    seq = _seq()
    return window.stream_orbit(seq.det_rows, seq.orbit_pos_eci_km, seed=1,
                               cfg=window.StreamingConfig(**CFG),
                               device="cpu", checkpoint_path=ck,
                               resume_from=resume)


def _jax(ck=None, resume=None):
    seq = _seq()
    return jwindow.stream_orbit(
        seq.det_rows, seq.orbit_pos_eci_km, seed=1,
        cfg=jwindow.StreamingConfig(**CFG),
        solver=jba.SolverParams(tridiag_variant="thomas"),
        checkpoint_path=ck, resume_from=resume)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    port_ck, jax_ck = str(d / "port"), str(d / "jax")
    return dict(port=_port(ck=port_ck), jax=_jax(ck=jax_ck), port_ck=port_ck,
                jax_ck=jax_ck)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_uninterrupted_runs_match_jax(runs):
    got, want = runs["port"], runs["jax"]
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-3)
    assert len(got.window_infos) == len(want.window_infos) >= 3
    for Hg, Hw in zip(got.window_infos, want.window_infos):
        assert np.linalg.norm(Hg - Hw) / np.linalg.norm(Hw) < 1e-6


def test_checkpoints_written_every_window(runs):
    n = len(runs["port"].window_infos)
    assert n >= 3
    for w in range(n):
        ck = checkpoint.load(f"{runs['port_ck']}.w{w}")
        assert ck["window_idx"] == w
        assert {"marg_info", "i_prev", "nees_infos", "nees_est",
                "nees_gt"} <= set(ck)
        assert len(ck["nees_infos"]) == w + 1
        assert set(ck) == set(jckpt.load(f"{runs['jax_ck']}.w{w}"))


@pytest.mark.parametrize("w", [0, 1])
def test_resume_within_port_is_identical(runs, w):
    ref = runs["port"]
    got = _port(resume=f"{runs['port_ck']}.w{w}.npz")
    np.testing.assert_array_equal(got.times, ref.times)
    assert _rel(got.errors, ref.errors) < 1e-12
    assert _rel(got.final_states, ref.final_states) < 1e-12
    assert _rel(got.window_infos, ref.window_infos) < 1e-12


def test_port_resumes_from_jax_checkpoint(runs):
    ref = runs["jax"]
    got = _port(resume=f"{runs['jax_ck']}.w0.npz")
    np.testing.assert_array_equal(got.times, ref.times)
    np.testing.assert_allclose(got.errors, ref.errors, rtol=0, atol=1e-3)


def test_jax_resumes_from_port_checkpoint(runs):
    ref = runs["port"]
    path = f"{runs['port_ck']}.w0.npz"
    assert os.path.exists(path)
    got = _jax(resume=path)
    np.testing.assert_array_equal(got.times, ref.times)
    np.testing.assert_allclose(got.errors, ref.errors, rtol=0, atol=1e-3)
