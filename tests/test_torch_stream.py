"""The slice end to end: JAX `stream_orbit` against the port's on the CPU
(f64) on a short gapped along-track arc (JAX's simulation, windows and
stream of it committed in tests/data/torch_jax_runs_seed1.npz), the
port's JAX-free import, and the committed fixture the card's smoke run is
held to.

Bound: the same windows and recorded-error count, and every recorded
error within 1e-3 km of JAX's (the two solve the damped systems with
different block-tridiagonal algorithms; on the 10800 s fixture the
measured deviation is 8.0e-4 km)."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import (jax_runs, jax_runs_arc,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu.evalx import ate as jate
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ingest, window
from vinsat_tpu_torch.evalx import ate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_stream_seed1.npz")
SIM_KW = dict(duration_s=3600, frame_stride=10, along_track=True,
              pass_every_s=1200, pass_len_s=240)


@functools.lru_cache(maxsize=1)
def _runs():
    # JAX's simulation and stream of the arc (SIM_KW, seed 1, f64,
    # max_iters 30) are committed (tests/data/
    # make_torch_jax_runs_fixture.py)
    seq = jax_runs_arc()
    want = jax_runs("plain30")
    got = pipeline.run_streaming(
        seq, seed=1, cfg=window.StreamingConfig(dtype="float64",
                                                max_iters=30),
        device="cpu")
    return seq, want, got


def test_stream_matches_jax():
    seq, want, got = _runs()
    assert len(got.errors) == len(want.errors) > 0
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-3)
    assert got.first_detection == want.first_detection
    assert (ate.time_to_threshold(got.errors, got.times)
            == jate.time_to_threshold(want.errors, want.times))


def test_stream_windows_match_jax():
    seq = _runs()[0]
    cfg = window.StreamingConfig(dtype="float64")
    mine = window.prepare_stream(seq.det_rows, seq.orbit_pos_eci_km, 1, cfg,
                                 device="cpu")
    ref = jax_runs("prep")  # JAX's prepare_stream, f64, seed 1
    w_mine = ingest.split_windows(mine.graph.ii, mine.knot_t)
    w_ref = [tuple(int(v) for v in w[:2]) + (bool(w[2]),)
             for w in ref.windows]
    assert w_mine == w_ref and len(w_mine) >= 2
    np.testing.assert_array_equal(mine.knot_t, ref.knot_t)
    np.testing.assert_allclose(mine.states0, ref.states0, rtol=1e-12)
    np.testing.assert_allclose(mine.cum_rot, ref.cum_rot, rtol=0,
                               atol=1e-12)


def test_ate_matches_jax():
    rng = np.random.default_rng(0)
    errs = [rng.uniform(0, 10, 30) for _ in range(4)] + [np.full(5, 9.0)]
    times = [np.arange(len(e)) * 10.0 for e in errs]
    assert ate.summarize(errs, times) == pytest.approx(
        jate.summarize(errs, times), nan_ok=True)


def test_unported_modes_raise():
    """Every stream mode of the JAX package's StreamingConfig is ported
    (NEES tracking, auto-calibration, checkpoints and the early stop ran
    NotImplementedError before; tests/test_torch_calibration.py,
    test_torch_checkpoint.py and test_torch_early_stop.py hold them to
    JAX), and the constellation solves in f32; what stays refused is a
    dtype neither package solves in."""
    seq = _runs()[0]
    for kw in (dict(track_nees=True), dict(auto_calibrate=True),
               dict(marginalize=True, use_prior=True), dict(dtype="float32")):
        window._check_supported(window.StreamingConfig(**kw))
    bad = window.StreamingConfig(dtype="float16")
    with pytest.raises(ValueError):
        window.stream_orbit(seq.det_rows, seq.orbit_pos_eci_km, cfg=bad,
                            device="cpu")
    with pytest.raises(ValueError):
        pipeline.constellation_from_sequences([1], [seq], 3600, cfg=bad,
                                              device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, vinsat_tpu_torch.pipeline, "
            "vinsat_tpu_torch.kernels.tridiag_pcr, "
            "vinsat_tpu_torch.kernels.matching, "
            "vinsat_tpu_torch.run_configs, "
            "vinsat_tpu_torch.estimation.ekf, "
            "vinsat_tpu_torch.estimation.hybrid, "
            "vinsat_tpu_torch.dist.stream, "
            "vinsat_tpu_torch.evalx.calibration, "
            "vinsat_tpu_torch.utils.checkpoint, "
            "vinsat_tpu_torch.evalx.px_err, "
            "vinsat_tpu_torch.sim.landmarks, "
            "vinsat_tpu_torch.sim.imagery, "
            "vinsat_tpu_torch.sim.detector, "
            "vinsat_tpu_torch.sim.learned_detector, "
            "vinsat_tpu_torch.tools.raster, "
            "vinsat_tpu_torch.tools.labeling, "
            "vinsat_tpu_torch.cli, "
            "vinsat_tpu_torch.native, "
            "vinsat_tpu_torch.utils.metrics, "
            "vinsat_tpu_torch.utils.profiling, "
            "vinsat_tpu_torch.utils.stream_profile, "
            "vinsat_tpu_torch.utils.mfu, "
            "vinsat_tpu_torch.utils.plot, "
            "vinsat_tpu_torch.evalx.ate; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', "
            "'vinsat_tpu.')) or m == 'vinsat_tpu' for m in sys.modules)))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=ROOT).returncode == 0


def test_fixture_is_complete():
    fx = np.load(FIXTURE)
    assert set(fx.files) >= {
        "det_rows", "orbit_pos_eci_km", "seed", "sim_kwargs", "errors",
        "times", "final_states", "knot_times", "num_windows",
        "time_to_5km_s", "final_error_km", "refined_states"}
    assert int(fx["num_windows"]) == 7
    assert float(fx["time_to_5km_s"]) == 275.0
    assert len(fx["errors"]) == len(fx["times"])
    assert fx["final_states"].shape == (len(fx["knot_times"]), 10)
    assert fx["refined_states"].shape == fx["final_states"].shape
    assert float(fx["final_error_km"]) == float(fx["errors"][-1])


@pytest.mark.parametrize("length", [50, 80])
def test_propagate_segment_matches_jax(length):
    """The JAX package's public `propagate_segment` (a jit of its
    `_propagate_impl`) and the port's, with JAX's signature: 64 steps
    padded, `length` of them run (80: clipped at max_len)."""
    import jax.numpy as jnp
    import torch

    from torch_parity import random_states
    from vinsat_tpu.estimation import window as jwindow

    rng = np.random.default_rng(5)
    state = random_states(rng, 1)[0]
    omega = rng.normal(size=(64, 3)) * 1e-3
    want = np.asarray(jwindow.propagate_segment(
        jnp.asarray(state), jnp.asarray(omega), length, max_len=64))
    got = window.propagate_segment(torch.as_tensor(state),
                                   torch.as_tensor(omega), length, 64)
    assert got.shape == want.shape == (65, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
