"""PyTorch port vs JAX: the full batch, the bounded-window modes and
BASELINE configs 1-3 (f64, CPU).

* `run_full_batch` on a 600 s along-track arc (12 iterations, 4
  vision-only) against JAX's with its Thomas solve (the arc and JAX's run
  committed in tests/data/torch_jax_runs_seed1.npz): per-knot errors within
  1e-6 km (the port's "auto" solve at 64 rows is K1's PCR, whose plain
  twin agrees with Thomas; JAX's f64 "auto" is bcr16, which does not).
* `stream_orbit` with `marginalize` and with `use_ekf_hybrid` on
  test_torch_stream.py's gapped arc (JAX's runs committed in
  tests/data/torch_jax_runs_seed1.npz): the same recorded times and every
  error within 1e-6 km (measured ~5e-11: bounded windows are below 64
  rows, so both sides solve by Thomas).
* Configs 1-3 from JAX's rows in tests/data/torch_modes_seed1.npz against
  the JAX runners' unrounded results there, knot by knot from the passes
  the port's runners make: config 1's errors within 1e-6 km (measured
  ~6e-9); config 2's within 1e-6 km of JAX's Thomas-solve run; config 3's
  matcher indices equal, the BA-only and hybrid streams' recorded times
  (so their windows) and time to 5 km equal and their errors within 1e-4
  km (measured 4.3e-6 and 1.3e-6: BA-only windows grow past 64 rows,
  where JAX's f64 "auto" is bcr16 and the port's is PCR), the two EKF-only
  passes' errors within 1e-6 km."""
import functools
import os

import numpy as np
import pytest
import torch

from torch_parity import (jax_runs, jax_runs_arc,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu_torch import pipeline, run_configs
from vinsat_tpu_torch.estimation import window
from vinsat_tpu_torch.evalx import ate
from vinsat_tpu_torch.kernels import matching

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_modes_seed1.npz")
SIM_KW = dict(duration_s=3600, frame_stride=10, along_track=True,
              pass_every_s=1200, pass_len_s=240)


@functools.lru_cache(maxsize=1)
def _fx():
    return dict(np.load(FIXTURE))


def _seq(tag):
    fx = _fx()
    d = {"det_rows": fx[f"det_rows_{tag}"],
         "orbit_pos_eci_km": fx[f"orbit_pos_eci_km_{tag}"]}
    if tag == "3":
        d.update(db_lon=fx["db_lon_3"], db_lat=fx["db_lat_3"])
    return d


def test_modes_fixture_is_complete():
    fx = _fx()
    for tag in ("12", "3", "gap"):
        assert fx[f"det_rows_{tag}"].shape[1] == 6
        assert fx[f"orbit_pos_eci_km_{tag}"].shape == (3601, 3)
    assert len(fx["c1_errors"]) == len(fx["c2_errors"]) == int(
        fx["c2_knots"]) == len(fx["c2_errors_thomas"])
    assert fx["c3_matcher_idx"].shape == fx["c3_matcher_d2"].shape == (
        len(fx["det_rows_3"]),)
    for tag in ("c3_ba_only", "c3_hybrid", "f32"):
        assert len(fx[f"{tag}_errors"]) == len(fx[f"{tag}_times"]) > 0
        assert float(fx[f"{tag}_final_error_km"]) == fx[f"{tag}_errors"][-1]
        for k in ("windows", "time_to_5km_s", "recovery_trips"):
            assert fx[f"{tag}_{k}"].shape == ()
    assert int(fx["f32_windows"]) == 7
    assert float(fx["f32_time_to_5km_s"]) == 275.0
    assert len(fx["c3_ekf_only_errors"]) > 0
    assert len(fx["c3_ekf_only_long_gap_errors"]) > 0


def test_run_full_batch_matches_jax():
    # JAX's arc and its run_full_batch with the Thomas solve, committed
    # (tests/data/make_torch_jax_runs_fixture.py, "fullbatch")
    j = jax_runs("fullbatch")
    seq = (j.det_rows, j.orbit_pos_eci_km)
    want, kt_w, gt_w = (getattr(j, str(i)) for i in range(3))
    got, kt, gt = pipeline.run_full_batch(seq, seed=1, num_iters=12,
                                          init_iters=4, device="cpu")
    np.testing.assert_array_equal(kt, kt_w)
    assert len(kt) >= 64
    e_w = np.linalg.norm(want[:, :3] - gt_w[:, :3], axis=-1)
    e = np.linalg.norm(got[:, :3] - gt[:, :3], axis=-1)
    np.testing.assert_allclose(e, e_w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["marginalize", "use_ekf_hybrid"])
def test_bounded_stream_matches_jax(mode):
    # JAX's simulation of the SIM_KW arc, its windows and its stream in
    # this mode are committed (tests/data/make_torch_jax_runs_fixture.py)
    seq = jax_runs_arc()
    kw = {mode: True, "max_iters": 30}
    want = jax_runs(mode)
    got = pipeline.run_streaming(seq, seed=1,
                                 cfg=window.StreamingConfig(**kw),
                                 device="cpu")
    assert len(jax_runs("prep").windows) >= 2
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-6)
    assert got.recovery_trips == want.recovery_trips


def _record_runs(monkeypatch):
    """The stream results and the EKF passes' per-knot errors that the
    port's runners make, recorded as they make them: (streams, errors)."""
    streams, ekf_errs = [], []
    run_stream, run_ekf = pipeline.run_streaming, run_configs.ekf_errors

    def record_stream(*a, **kw):
        streams.append(run_stream(*a, **kw))
        return streams[-1]

    def record_ekf(*a):
        out = run_ekf(*a)
        ekf_errs.append(out[0])
        return out

    monkeypatch.setattr(pipeline, "run_streaming", record_stream)
    monkeypatch.setattr(run_configs, "ekf_errors", record_ekf)
    return streams, ekf_errs


def test_config1_matches_jax(monkeypatch):
    want = _fx()["c1_errors"]
    _, errs = _record_runs(monkeypatch)
    got = run_configs.run_ekf(3600, _seq("12"), device="cpu")
    assert got["knots"] == len(want) == len(errs[0])
    np.testing.assert_allclose(errs[0], want, rtol=0, atol=1e-6)
    assert got["final_error_km"] == errs[0][-1]
    assert got["median_error_km"] == float(np.median(errs[0]))


def test_config2_matches_jax():
    fx = _fx()
    got, knot_t, gt = pipeline.run_full_batch(_seq("12"), seed=1,
                                              num_iters=40, device="cpu")
    e = np.linalg.norm(got[:, :3] - gt[:, :3], axis=-1)
    np.testing.assert_allclose(e, fx["c2_errors_thomas"], rtol=0, atol=1e-6)
    out = run_configs.run_fullbatch(3600, _seq("12"), device="cpu")
    assert out["median_error_km"] == float(np.median(e))
    assert out["knots"] == len(knot_t) == int(fx["c2_knots"])


def test_config3_matches_jax(monkeypatch):
    fx = _fx()
    seq3 = _seq("3")
    idx, d2 = matching.nearest_landmark(
        *(torch.as_tensor(a) for a in (
            seq3["det_rows"][:, 1:3], seq3["db_lon"], seq3["db_lat"])))
    np.testing.assert_array_equal(idx.numpy(), fx["c3_matcher_idx"])
    np.testing.assert_allclose(d2.numpy(), fx["c3_matcher_d2"], rtol=0,
                               atol=1e-15)
    streams, errs = _record_runs(monkeypatch)
    out = run_configs.run_streaming(3600, seq3, _seq("gap"), device="cpu")
    assert len(streams) == 2 and len(errs) == 2
    for tag, res in zip(("ba_only", "hybrid"), streams):
        np.testing.assert_array_equal(res.times, fx[f"c3_{tag}_times"])
        np.testing.assert_allclose(res.errors, fx[f"c3_{tag}_errors"],
                                   rtol=0, atol=1e-4)
        assert out[tag]["final_error_km"] == res.errors[-1]
        assert out[tag]["time_to_5km_s"] == float(
            fx[f"c3_{tag}_time_to_5km_s"])
    for tag, e in zip(("ekf_only", "ekf_only_long_gap"), errs):
        np.testing.assert_allclose(e, fx[f"c3_{tag}_errors"], rtol=0,
                                   atol=1e-6)
        assert out[tag]["final_error_km"] == e[-1]
    assert out["matcher_max_d2"] == float(fx["c3_matcher_d2"].max())
    assert ate.time_to_threshold(fx["c3_hybrid_errors"],
                                 fx["c3_hybrid_times"]) is not None


def test_main_picks_the_solve_dtype_from_the_device(monkeypatch, capsys):
    # as the JAX runner's x64 rule: configs 2, 4 and 5 take f64 on the CPU
    # (f32 on the card); configs 1 and 3 take no dtype
    calls = {}

    def runner(k):
        def run(duration, device=None, **kw):
            calls[k] = (duration, str(device), kw)
            return {"config": k}
        return run

    monkeypatch.setattr(run_configs, "RUNNERS",
                        {k: runner(k) for k in run_configs.RUNNERS})
    run_configs.main(["all", "--duration", "600", "--device", "cpu"])
    assert calls == {k: (600, "cpu", {"dtype": "float64"}
                         if k in ("2", "4", "5") else {})
                     for k in ("1", "2", "3", "4", "5")}
    assert capsys.readouterr().out.splitlines() == [
        f'{{"config": "{k}"}}' for k in ("1", "2", "3", "4", "5")]
