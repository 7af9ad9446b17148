"""PyTorch port vs JAX: f32 streams with their f64 escapes (CPU).  JAX's
simulation of test_torch_stream.py's gapped arc, its window 0 and its
streams there are committed (tests/data/torch_jax_runs_seed1.npz).

* `_window0_init_f64` against JAX's `_window0_init_f64_cpu` from the same
  f32 window 0 of test_torch_stream.py's gapped arc, and
  `_solve_window_f64` with a prior against JAX's `_solve_window_f64_cpu`:
  relative 1e-9 (JAX's Thomas solve; both windows are below 64 rows, where
  the port's "auto" is Thomas too).
* `stream_orbit(dtype="float32")` with the default escapes on that arc
  against JAX's f32 stream: the same recorded times (hence windows), time
  to 5 km equal, final error within 0.01 km (f32 roundoff differs between
  the two, so only outcomes are compared).
* A forced escalation (recover_rms_px=1e-3, no window can pass): the
  default stream's fast path measures every window's RMS above the gate
  and runs the stream again in sync mode (`sync_rerun`), where every
  window trips and is solved a third time in f64; each window keeps the
  candidate of least reprojection RMS among the first solve, the damped
  retry and the f64 solve cast to f32, as in JAX (on this arc the f64 one
  wins three windows of four, the damped retry one); finite, min error
  < 2 km (the JAX package's test_rms_gate_f64_escalation bound).
* `marginalize` in f32: finite, JAX's recorded times."""
import numpy as np
import torch

from test_torch_prior import _case, _prior
from torch_parity import (jax_runs, jax_runs_arc, rel_err,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu.evalx import ate as jate
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ba, ingest, window
from vinsat_tpu_torch.evalx import ate

SIM_KW = dict(duration_s=3600, frame_stride=10, along_track=True,
              pass_every_s=1200, pass_len_s=240)
F32 = torch.float32


def _seq():
    # JAX's simulation of the SIM_KW arc, committed with its streams
    # (tests/data/make_torch_jax_runs_fixture.py)
    return jax_runs_arc()


def _f32(fields):
    return ba.problem_from_numpy(fields, "cpu", F32)


def test_window0_init_f64_matches_jax():
    # window 0 of the arc's f32 stream as JAX pads it, and JAX's init phase
    # of it (Thomas solve), committed ("w0")
    w0 = jax_runs("w0")
    st0, hops, want = w0.st0, int(w0.hops), w0.want
    prob = {k[len("prob_"):]: v for k, v in vars(w0).items()
            if k.startswith("prob_")}
    got = window._window0_init_f64(
        torch.as_tensor(np.array(st0)), _f32(prob), 1e-4, 10,
        ba.SolverParams(num_hops=hops))
    assert np.asarray(st0).dtype == np.float32 and got.dtype == torch.float64
    assert got.shape[0] < 64
    assert rel_err(got, want) < 1e-9


def test_solve_window_f64_with_prior_matches_jax():
    st0, fields, pri = _case()
    f32 = {k: (v if k == "ii" else np.asarray(v, np.float32))
           for k, v in fields.items()}
    pri32 = tuple(np.asarray(a, np.float32) for a in pri)
    # JAX's _solve_window_f64_cpu of this window (Thomas solve), committed
    j = vars(jax_runs("f64prior"))
    want = [j[str(i)] for i in range(4)]
    got = window._solve_window_f64(
        torch.as_tensor(np.array(st0), dtype=F32), _f32(fields), 1e-4, 0, 10,
        ba.SolverParams(num_hops=4), prior=_prior(pri32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert rel_err(g, w) < 1e-9
    assert window._solve_window_f64(
        torch.tensor(st0), ba.problem_from_numpy(fields, "cpu"), 1e-4, 0,
        10, ba.SolverParams(num_hops=4)) is None


def test_f32_stream_matches_jax():
    seq = _seq()
    kw = dict(dtype="float32", max_iters=30)
    want = jax_runs("f32")
    got = pipeline.run_streaming(seq, seed=1,
                                 cfg=window.StreamingConfig(**kw),
                                 device="cpu")
    assert got.final_states.dtype == np.float32
    np.testing.assert_array_equal(got.times, want.times)
    assert (ate.time_to_threshold(got.errors, got.times)
            == jate.time_to_threshold(want.errors, want.times) is not None)
    assert abs(got.errors[-1] - want.errors[-1]) <= 0.01


def test_forced_escalation_f32(monkeypatch):
    seq = _seq()
    cfg = window.StreamingConfig(dtype="float32", max_iters=30,
                                 recover_rms_px=1e-3)
    escapes, cands = [], []
    solve64, rms = window._solve_window_f64, window._reproj_rms_impl

    def recording_solve(st0, prob, lamda0, init_iters, num_iters, params,
                        prior=None):
        out = solve64(st0, prob, lamda0, init_iters, num_iters, params,
                      prior=prior)
        if params.max_iters > 0:  # the ladder's rung, not window 0's init
            escapes.append(out[0].to(F32))
        return out

    def recording_rms(states, prob):
        r = rms(states, prob)
        cands.append((int(prob.knot_valid.sum()), float(r), states))
        return r

    monkeypatch.setattr(window, "_solve_window_f64", recording_solve)
    monkeypatch.setattr(window, "_reproj_rms_impl", recording_rms)
    res = pipeline.run_streaming(seq, seed=1, cfg=cfg, device="cpu")
    prep = window.prepare_stream(seq.det_rows, seq.orbit_pos_eci_km, 1, cfg,
                                 device="cpu")
    wins = ingest.split_windows(prep.graph.ii, prep.knot_t)
    # the default stream takes the fast path, whose one RMS a window fails
    # the gate, and runs again in sync mode: then each window's first
    # solve, the damped retry, the f64 solve
    assert res.sync_rerun
    assert len(cands) == 4 * len(wins)
    assert [c[0] for c in cands[:len(wins)]] == [w[0] for w in wins]
    cands = cands[len(wins):]
    assert res.recovery_trips == len(wins) == len(escapes) >= 2
    for w, (t_final, _, _) in enumerate(wins):
        three = cands[3 * w:3 * w + 3]
        assert [c[0] for c in three] == [t_final] * 3
        assert torch.equal(three[2][2], escapes[w])
        best = min(three, key=lambda c: c[1])[2]
        want = np.linalg.norm(best[t_final - 1, :3].numpy()
                              - prep.gt.states[t_final - 1, :3])
        j = np.nonzero(res.times == prep.knot_t[t_final - 1])[0]
        assert len(j) == 1 and res.errors[j[0]] == want
    assert np.isfinite(res.errors).all()
    assert res.errors.min() < 2.0


def test_marginalize_f32_finite_with_jax_windows():
    seq = _seq()
    want = jax_runs("marginalize")  # max_iters 30, f64
    got = pipeline.run_streaming(
        seq, seed=1, cfg=window.StreamingConfig(
            dtype="float32", marginalize=True, max_iters=30), device="cpu")
    np.testing.assert_array_equal(got.times, want.times)
    assert np.isfinite(got.errors).all()
    assert np.isfinite(got.final_states).all()
