"""The orbit-by-orbit evaluation of the port against the JAX package on
the CPU, f64: the terminal information bound (`evalx.crlb`) on a short
gapped JAX arc, its no-observation case and `efficiency`; the port's
`run_batch_eval` against its own per-orbit streams; and the committed
fixture the card's smoke run holds the evaluation orbit to.

Bound: 1e-9 relative on the bounds (the two chain the same RK4
sensitivities and invert the same Jacobi-scaled 6x6 and 9x9 information
matrices, summing in other orders)."""
import functools
import math
import os

import numpy as np
import pytest

from vinsat_tpu import pipeline as jpipeline
from vinsat_tpu.evalx import crlb as jcrlb
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation.window import StreamingConfig
from vinsat_tpu_torch.evalx import ate, crlb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_eval_seed1.npz")
BOUNDS = ("crlb_final_km", "crlb_last_knot_km", "crlb_att_final_km")


@functools.lru_cache(maxsize=1)
def _arc():
    # two region passes in 1200 s (the graph's filler knots run on to the
    # arc end)
    return jpipeline.simulate_sequence(1, 1200, along_track=True,
                                       frame_stride=5, pass_every_s=600,
                                       pass_len_s=200)


def test_terminal_crlb_matches_jax():
    seq = _arc()
    want = jcrlb.terminal_crlb_km(seq.orbit_pos_eci_km, seq.det_rows)
    got = crlb.terminal_crlb_km(seq.orbit_pos_eci_km, seq.det_rows,
                                device="cpu")
    assert set(got) == set(want)
    assert got["n_obs"] == want["n_obs"] > 0
    assert got["obs_span_s"] == want["obs_span_s"]
    for k in BOUNDS:
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 1e-9 * abs(want[k]), k


def test_terminal_crlb_without_observations():
    seq = _arc()
    rows = np.array(seq.det_rows, copy=True)
    rows[:, 5] = 0.5  # below the gate's confidence floor: nothing survives
    want = jcrlb.terminal_crlb_km(seq.orbit_pos_eci_km, rows)
    got = crlb.terminal_crlb_km(seq.orbit_pos_eci_km, rows, device="cpu")
    assert set(got) == set(want)
    for k in BOUNDS:
        assert math.isnan(got[k]) and math.isnan(want[k])
    assert got["n_obs"] == want["n_obs"] == 0
    assert got["obs_span_s"] == want["obs_span_s"] == 0.0


@pytest.mark.parametrize("crlb_km,actual_km", [
    (0.1, 0.4), (0.5, 0.2), (0.3, 0.0), (0.3, -1.0), (math.nan, 1.0),
    (0.2, math.inf), (0.2, math.nan)])
def test_efficiency_matches_jax(crlb_km, actual_km):
    got = crlb.efficiency(crlb_km, actual_km)
    want = jcrlb.efficiency(crlb_km, actual_km)
    assert got == want or (math.isnan(got) and math.isnan(want))


def test_run_batch_eval_summarizes_its_streams():
    # port seeds 0 and 6 image the synthesized DB within 600 s, seed 1 not
    # (a short LM budget: what is held here is the loop and its summary)
    seeds = [0, 1, 6]
    cfg = StreamingConfig(num_iters=6, init_iters=3, max_iters=6)
    got = pipeline.run_batch_eval(seeds, 600, cfg=cfg, device="cpu")
    errors, times, rows = [], [], []
    for s in seeds:
        seq = pipeline.simulate_sequence(s, 600, device="cpu")
        if len(seq.det_rows) == 0:
            continue
        res = pipeline.run_streaming(seq, seed=s, cfg=cfg, device="cpu")
        errors.append(res.errors)
        times.append(res.times)
        rows.append(pipeline.eval_row(seq, res, s, device="cpu"))
    assert len(errors) == 2
    assert got == pytest.approx(ate.summarize(errors, times), nan_ok=True)
    assert [r["seed"] for r in rows] == [0, 6]
    for r, e in zip(rows, errors):
        assert r["final_err_km"] == float(e[-1])
        assert r["efficiency"] == crlb.efficiency(r["crlb_final_km"],
                                                  r["final_err_km"])
        assert set(r) >= {"crlb_att_final_km", "efficiency_att",
                          "obs_span_s", "recovery_trips", "min_err_km"}


def test_eval_fixture_is_complete():
    fx = np.load(FIXTURE)
    assert set(fx.files) >= {
        "seed", "errors", "times", "num_windows", "time_to_5km_s",
        "final_error_km", "recovery_trips", *BOUNDS, "n_obs", "obs_span_s"}
    assert int(fx["seed"]) == 1
    assert len(fx["errors"]) == len(fx["times"]) > 0
    assert float(fx["final_error_km"]) == float(fx["errors"][-1])
    assert int(fx["num_windows"]) >= 2 and int(fx["n_obs"]) > 0
    t5 = ate.time_to_threshold(fx["errors"], fx["times"], 5.0)
    assert t5 == float(fx["time_to_5km_s"])
    for k in BOUNDS:
        assert 0.0 < float(fx[k]) < float("inf")
