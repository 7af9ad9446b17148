"""The constellation path (BASELINE config 4) of the port against the JAX
package on the CPU, f64: `ba_iteration` over an orbit axis against each
orbit's own call and against `jax.vmap` of JAX's, the per-orbit λ search,
the batched LM loop, `solve_window_batch`, and `run_constellation`'s
preparation and solve fed JAX-simulated sequences (JAX's sequences and
runs of them committed in tests/data/torch_jax_runs_seed1.npz); and the
committed fixture the card's smoke run holds config 4 to.

Bounds: a batch against each orbit's own call 1e-12 relative (the same
arithmetic; the block products may sum in another order); against JAX
1e-9 relative for one iteration and 1e-6 over a run.  The JAX reference
solves with its Thomas scan (`tridiag_variant="thomas"`) wherever the
dynamics factor is on: in f64 at 64 <= N < 1024 JAX's "auto" takes its
block cyclic reduction `bcr16`, and on these first dynamics systems
`bcr16` departs from JAX's own Thomas solve (1.3e-4 relative in the
states of one iteration at N=64; 0.1-0.5 km after four at 600 s) while
the port's PCR and JAX's Thomas agree to ~1e-8 km."""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_runs, orbit_problem, perturb, rel_err
from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import window as jwindow
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ba, window
from vinsat_tpu_torch.sim import detections, orbits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_constellation.npz")
SIM_KW = dict(along_track=True, frame_stride=5)


def _orbit(seed, n_knots, pos_km, rot_rad, obs_per_knot=6):
    """One orbit's perturbed states and problem fields (numpy)."""
    rng = np.random.default_rng(seed)
    gt, f = orbit_problem(rng, n_knots=n_knots, obs_per_knot=obs_per_knot,
                          gap=120.0 if n_knots <= 24 else 50.0)
    return perturb(rng, gt, pos_km, rot_rad), f


def _padded(orbits, n_pad, m_pad):
    """Each orbit padded to (n_pad, m_pad), for the port and for JAX:
    ([(states, BAProblem)], [(states, jax BAProblem)])."""
    mine, ref = [], []
    for st, f in orbits:
        args = (st, f["gaps"], f["cum_rot"], f["landmarks_xyz"],
                f["landmarks_uv"], f["conf"], f["ii"], n_pad, m_pad)
        mine.append(window._pad_problem(*args, "cpu"))
        ref.append(jwindow._pad_problem(*args, "float64"))
    return mine, ref


def _stack_jax(probs):
    return jba.BAProblem(*[
        (jnp.stack([getattr(p, f) for p in probs]) if f != "intrinsics"
         else probs[0].intrinsics) for f in jba.BAProblem._fields])


# (n_knots, n_pad): a Thomas-size window, and one at N >= 64 that takes
# the "pcr" branch (K1's twin on the CPU)
SIZES = [(14, 16), (60, 64)]
LAMS = (1e-4, 1e-2, 1.0)


@functools.lru_cache(maxsize=None)
def _batch(n_knots, n_pad):
    # orbits of different observation counts: per-orbit padding and counts
    orbits = [_orbit(10 + i, n_knots, 5.0 * (i + 1), 0.01, 6 - i)
              for i in range(3)]
    return _padded(orbits, n_pad, 6 * n_knots)


@pytest.mark.parametrize("initialize", [True, False])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("n_knots,n_pad", SIZES)
def test_batched_iteration_equals_each_orbit(n_knots, n_pad, K, initialize):
    mine, _ = _batch(n_knots, n_pad)
    states = torch.stack([m[0] for m in mine])
    prob_b = ba.stack_problems([m[1] for m in mine])
    params = ba.SolverParams(num_hops=2, batched_lambda=K)
    got = ba.ba_iteration(7, states, prob_b, torch.tensor(LAMS,
                                                          dtype=torch.float64),
                          params=params, initialize=initialize)
    for i, (st, prob) in enumerate(mine):
        want = ba.ba_iteration(7, st, prob, LAMS[i], params=params,
                               initialize=initialize)
        for name, g, w in zip(ba.BAStep._fields, got, want):
            tol = 1e-12
            if name == "mean_residual" and n_pad < ba.PCR_MIN_N:
                # the unbatched Thomas solve forms its 9x9 products as 2-D
                # matmuls, the batch as batched ones, which round apart
                # (states ~1e-13); the residual, a sum of near-cancelling
                # terms, carries that at 5e-13 to 2.4e-11 by run
                tol = 1e-10
            assert rel_err(g[i], w) <= tol, (i, name)


@functools.partial(jax.jit, static_argnums=(0, 4))
def _jax_vmapped_iteration(sched_iter, states_b, prob_b, lamda_b,
                           initialize):
    """jax.vmap of JAX's ba_iteration over the orbit axis (intrinsics
    shared), as solve_window_batch vmaps it, with the Thomas solve."""
    in_prob = jba.BAProblem(*[None if f == "intrinsics" else 0
                              for f in jba.BAProblem._fields])
    return jax.vmap(
        lambda s, p, lam: jba.ba_iteration(
            sched_iter, s, p, lam,
            params=jba.SolverParams(num_hops=2, tridiag_variant="thomas"),
            initialize=initialize),
        in_axes=(0, in_prob, 0))(states_b, prob_b, lamda_b)


@pytest.mark.parametrize("initialize", [True, False])
def test_batched_iteration_matches_jax_vmap(initialize):
    mine, ref = _batch(*SIZES[1])
    got = ba.ba_iteration(
        7, torch.stack([m[0] for m in mine]),
        ba.stack_problems([m[1] for m in mine]),
        torch.tensor(LAMS, dtype=torch.float64),
        params=ba.SolverParams(num_hops=2), initialize=initialize)
    want = _jax_vmapped_iteration(
        7, jnp.stack([r[0] for r in ref]), _stack_jax([r[1] for r in ref]),
        jnp.asarray(LAMS), initialize)
    for name, g, w in zip(ba.BAStep._fields, got, want):
        # the accepted trial's residual sums near-cancelling terms: the
        # solves' ~1e-12 differences reach it at ~1e-9
        tol = 1e-8 if name == "mean_residual" else 1e-9
        assert rel_err(g, np.asarray(w)) <= tol, name


def test_factors_with_an_orbit_axis():
    # each orbit gathers its own knots: the batch equals each orbit's call
    from vinsat_tpu_torch.estimation import factors

    mine, _ = _batch(*SIZES[0])
    states = torch.stack([m[0] for m in mine])
    prob_b = ba.stack_problems([m[1] for m in mine])
    rp = factors.reprojection_factor(states, prob_b.landmarks_xyz,
                                     prob_b.ii, prob_b.intrinsics)
    rng = np.random.default_rng(3)
    omega = torch.as_tensor(rng.normal(size=(3, 400, 3)) * 1e-3)
    knots = torch.as_tensor(np.sort(rng.choice(400, size=(3, 12)), axis=-1))
    cum = factors.cumulative_rotations(omega, 1.0, knots)
    for i, (st, prob) in enumerate(mine):
        one = factors.reprojection_factor(st, prob.landmarks_xyz, prob.ii,
                                          prob.intrinsics)
        assert torch.equal(rp.uv[i], one.uv) and torch.equal(rp.J[i], one.J)
        assert torch.equal(cum[i], factors.cumulative_rotations(
            omega[i], 1.0, knots[i]))


def _count_trials(monkeypatch):
    """Counts the λ search's trial solves (one solve per trial)."""
    calls = []
    real = ba.jacobi_scaled_tridiag_solve

    def counting(D, U, b, variant="auto"):
        calls.append(D.shape)
        return real(D, U, b, variant=variant)

    monkeypatch.setattr(ba, "jacobi_scaled_tridiag_solve", counting)
    return calls


def test_lambda_search_stops_per_orbit(monkeypatch):
    # a near-converged orbit that accepts its first λ beside a poorly
    # linearized one searched from two λ0: 1, 3 and 6 trials
    far = _orbit(21, 14, 300.0, 0.3)
    orbits = [_orbit(20, 14, 1.0, 0.001), far, far]
    lams = (1e-4, 1e-1, 1e-4)
    mine, ref = _padded(orbits, 16, 96)
    params = ba.SolverParams(num_hops=2)
    calls = _count_trials(monkeypatch)
    trials, singles = [], []
    for i, (st, prob) in enumerate(mine):
        n0 = len(calls)
        singles.append(ba.ba_iteration(0, st, prob, lams[i], params=params))
        trials.append(len(calls) - n0)
    assert len(set(trials)) == 3, trials
    n0 = len(calls)
    got = ba.ba_iteration(0, torch.stack([m[0] for m in mine]),
                          ba.stack_problems([m[1] for m in mine]),
                          torch.tensor(lams, dtype=torch.float64),
                          params=params)
    # the batch runs while any orbit searches, every orbit in every trial
    assert len(calls) - n0 == max(trials)
    assert all(shape[0] == 3 for shape in calls[n0:])
    for i, want in enumerate(singles):
        # λ exactly; the rest as in test_batched_iteration_equals_each_orbit
        assert torch.equal(got.lamda_init[i], want.lamda_init), i
        assert rel_err(got.states[i], want.states) <= 1e-12, i
        assert rel_err(got.last_hessian[i], want.last_hessian) <= 1e-12, i
        assert rel_err(got.mean_residual[i], want.mean_residual) <= 1e-10, i
    # each orbit's λ and state are those of JAX's vmapped while_loop
    want = _jax_vmapped_iteration(
        0, jnp.stack([r[0] for r in ref]), _stack_jax([r[1] for r in ref]),
        jnp.asarray(lams), False)
    np.testing.assert_array_equal(got.lamda_init.numpy(),
                                  np.asarray(want.lamda_init))
    assert rel_err(got.states, np.asarray(want.states)) <= 1e-9


def test_best_iterate_identical_orbits_bit_equal():
    # mirrors tests/test_adaptive_iters.py::test_adaptive_under_vmap: two
    # copies of one problem in one batch, best-iterate mode
    (st, prob), = _batch(*SIZES[1])[0][:1]
    params = ba.SolverParams(num_hops=2, max_iters=16)
    single = window._solve_window(st, prob, 1e-4, 0, 8, params)
    out = window.solve_window_batch(
        torch.stack([st, st]), ba.stack_problems([prob, prob]),
        torch.tensor([1e-4, 1e-4], dtype=torch.float64), 0, 8, params)
    for g in out:
        assert torch.equal(g[0], g[1])
    for g, w in zip(out, single):
        assert rel_err(g[0], w) <= 1e-12


def test_best_iterate_tracks_each_orbit():
    # orbits whose residual chains differ: each keeps its own best iterate
    mine, _ = _batch(*SIZES[1])
    params = ba.SolverParams(num_hops=2, max_iters=9)
    out = window.solve_window_batch(
        torch.stack([m[0] for m in mine]),
        ba.stack_problems([m[1] for m in mine]),
        torch.tensor(LAMS, dtype=torch.float64), 2, 6, params,
        sched_offset=-2)
    for i, (st, prob) in enumerate(mine):
        want = window._solve_window(st, prob, LAMS[i], 2, 6, params, -2)
        for g, w in zip(out, want):
            assert rel_err(g[i], w) <= 1e-12, i


# JAX's sequences, run_constellation results and solve_window_batch runs
# of the two tests below are committed (tests/data/
# make_torch_jax_runs_fixture.py, "const"): compiling them took the most
# of this module's time
def _jax_sequences(seeds, along_track=True):
    mode = "track" if along_track else "region"
    return [types.SimpleNamespace(**{
        k: v for k, v in vars(jax_runs(f"const_{mode}_seq{s}")).items()})
        for s in seeds]


def _jax_constellation(seeds, along_track):
    """JAX's run_constellation at 600 s (4 iterations, 2 vision-only) with
    the Thomas solve: the fixture's record of it."""
    return jax_runs("const_track" if along_track else "const_region")


def test_solve_window_batch_matches_jax():
    seeds = (0, 1, 2)
    j = vars(jax_runs("const"))
    batch = pipeline._prepare_constellation(
        seeds, _jax_sequences(seeds), 600, window.StreamingConfig(), None,
        None, "cpu")
    states_b = j["states_b"]
    assert rel_err(batch.states0, states_b) <= 1e-12
    for f in ba.BAProblem._fields:
        np.testing.assert_allclose(getattr(batch.prob, f).numpy(),
                                   j[f"prob_{f}"], rtol=1e-12, atol=1e-9)
    params = json.loads(str(j["params"]))
    assert params["tridiag_variant"] == "thomas"
    assert batch.params == ba.SolverParams(**dict(params,
                                                  tridiag_variant="auto"))
    for n, tol in ((1, 1e-9), (4, 1e-6)):
        got = window.solve_window_batch(batch.states0, batch.prob,
                                        batch.lamda, 2, n, batch.params,
                                        sched_offset=-2)
        for name, g in zip(("states", "lamda", "last_hessian",
                            "mean_residual"), got):
            assert rel_err(g, j[f"solve{n}_{name}"]) <= tol, (n, name)


@pytest.mark.parametrize("along_track,seeds", [
    (True, (0, 1, 2)),
    # region DB: seeds 0 and 2 image nothing in 600 s and are skipped,
    # drawing no initial noise
    (False, (0, 1, 2, 3))])
def test_constellation_matches_jax(along_track, seeds):
    want = _jax_constellation(seeds, along_track)
    got = pipeline.constellation_from_sequences(
        seeds, _jax_sequences(seeds, along_track), 600, num_iters=4,
        init_iters=2, device="cpu")
    assert set(got) == set(want.keys.tolist())
    assert got["num_orbits"] == int(want.num_orbits) >= 2
    assert got["orbit_seeds"] == want.orbit_seeds.tolist()
    if not along_track:
        assert len(got["orbit_seeds"]) < len(seeds)
    np.testing.assert_allclose(got["median_errors_km"],
                               want.median_errors_km, rtol=0, atol=1e-6)
    assert got["orbit_frames_per_s"] == pytest.approx(
        got["num_orbits"] * 600 / got["wall_s"])


def test_run_constellation_own_generator():
    res = pipeline.run_constellation([0, 1], duration_s=300, num_iters=2,
                                     init_iters=1, device="cpu")
    assert res["num_orbits"] == 2 and res["orbit_seeds"] == [0, 1]
    assert np.isfinite(res["median_errors_km"]).all()
    assert res["wall_s"] > 0


def test_constellation_refuses_float32():
    # f32 is accepted since the constellation solves in the stream's dtype
    # (tests/test_torch_dist_stream.py holds it to JAX's f32); a dtype
    # neither package solves in is refused
    seq = (np.zeros((0, 6)), np.zeros((601, 3)))
    assert pipeline.constellation_from_sequences(
        [5], [seq], 600, cfg=window.StreamingConfig(dtype="float32"),
        device="cpu") == {"num_orbits": 0}
    with pytest.raises(ValueError):
        pipeline.constellation_from_sequences(
            [5], [seq], 600, cfg=window.StreamingConfig(dtype="float16"),
            device="cpu")


def test_constellation_without_orbits():
    empty = (np.zeros((0, 6)), np.zeros((601, 3)))
    assert pipeline.constellation_from_sequences(
        [5], [empty], 600, device="cpu") == {"num_orbits": 0}


def test_constellation_fixture_is_complete():
    fx = np.load(FIXTURE)
    seeds = [int(s) for s in fx["seeds"]]
    assert seeds == list(range(8))
    assert json.loads(str(fx["sim_kwargs"])) == dict(duration_s=3600,
                                                     **SIM_KW)
    assert int(fx["num_iters"]) == 20 and int(fx["init_iters"]) == 10
    for s in seeds:
        assert set(fx.files) >= {
            f"{k}_{s}" for k in ("oe", "q0", "w0", "db_seed", "score_frame",
                                 "score_landmark", "score", "noise", "conf",
                                 "det_rows")}
        assert len(fx[f"noise_{s}"]) == len(fx[f"conf_{s}"])
    valid = fx["valid_seeds"].tolist()
    B, n_pad = len(valid), int(fx["n_pad"])
    assert B == 8 and n_pad == window.bucket(n_pad)
    for k in ("out_b", "states_iter1"):
        assert fx[k].shape == (B, n_pad, 10) and np.isfinite(fx[k]).all()
    for k in ("median_errors_km", "median_errors_km_thomas"):
        assert fx[k].shape == (B,) and (fx[k] < 5.0).all()
    assert int(fx["m_pad"]) > 0
    assert os.path.getsize(FIXTURE) < 4 << 20


def test_constellation_fixture_sequence_replays_on_cpu():
    # the card replays all 8 sequences from the fixture's draws; here one
    fx = np.load(FIXTURE)
    g = lambda k: fx[f"{k}_3"]  # noqa: E731
    draws = pipeline.SimDraws(
        orbits.OrbitalElements(*(float(v) for v in g("oe"))), g("q0"),
        g("w0"), int(g("db_seed")),
        detections.RecordedDraws(g("score_frame"), g("score_landmark"),
                                 g("score"), g("noise"), g("conf")))
    seq = pipeline.simulate_from_draws(
        draws, device="cpu", **json.loads(str(fx["sim_kwargs"])))
    want = fx["det_rows_3"]
    assert seq.det_rows.shape == want.shape
    np.testing.assert_array_equal(seq.det_rows[:, 0], want[:, 0])
    np.testing.assert_allclose(seq.det_rows[:, 1:3], want[:, 1:3], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(seq.det_rows[:, 3:5], want[:, 3:5], rtol=0,
                               atol=1e-6)
