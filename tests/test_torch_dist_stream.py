"""PyTorch port vs JAX: the sharded stream (BASELINE config 5(b)) and its
pieces, and configs 2, 4 and 5(a) in f32, on the CPU.

  * the sharded LM step with a prior (`ShardedPrior`) against one
    iteration of JAX's window solver with a prior: 1e-9 relative;
  * `make_sharded_window_solver` against JAX's in both budgets (the last
    iterate of a fixed count, the best of a run to max_iters), with and
    without a prior, on one shard and on eight (JAX: 8 virtual CPU
    devices; each budget, prior and layout twice among four cases), and
    with a prior at the prior coefficients (0.5, 2.0) on four shards
    (tests/data/torch_prior_coeffs.npz): states 1e-8 relative, λ and the
    residual 1e-8;
  * `_build_window_problem` against JAX's: the same slots;
  * `stream_orbit_sharded` on the committed fixture's config-5(b) rows
    (tests/data/torch_dist_stream_seed1.npz) in f64 forced onto the arc
    shards, and bounded (the default dispatch's one-shard route is held
    by the window solver's P = 1 cases here and by chip_smoke.py phase
    18): JAX's recorded times, every error within 1e-6 km (read 7e-9
    km); in f32, JAX's
    times and every error within 0.05 km of JAX's f32 run (the last
    window's best iterate is a near tie in f32: its residual is 4e-4 apart
    from the next iterate's, whose final knot lies 0.044 km away; a 1e-6 px
    change of the rows moves either package between the two);
  * `_prepare_constellation`, `run_full_batch` and the long arc's
    `build_sharded_problem` in f32 against JAX's on short arcs: the
    problems equal JAX's f32 arrays (conditioning in f64 in both, then
    rounded); the full batch after 40 iterations (config 2's count):
    every knot within 0.02 km and the median within 0.01 km of JAX's f32
    solve; the constellation after 20: each orbit's median within 0.01 km
    (JAX's own f32 run lies up to 0.012 km from its f64 one there; after
    4 iterations, 0.34 km).

JAX's window-solver runs, short arcs and f32 runs (its Thomas solve for
the full batch and the constellation) are committed in
tests/data/torch_jax_runs_seed1.npz (tests/data/
make_torch_jax_runs_fixture.py): their compiles took the most of this
module's time."""
import functools
import json
import os

import numpy as np
import pytest
import torch

from test_sharded_ba import INTR, _build_problem
from torch_parity import jax_runs, rel_err, torch_one_thread  # noqa: F401
from vinsat_tpu.dist import stream as jds
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.dist import long_arc, mesh, sharded_ba
from vinsat_tpu_torch.dist import stream as ds
from vinsat_tpu_torch.estimation import ba, window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_dist_stream_seed1.npz")
COEFFS_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_prior_coeffs.npz")
PARAMS = dict(num_hops=3, max_substep=100.0)
N_KNOTS, D = 16, 4


@functools.lru_cache(maxsize=1)
def _case():
    """A 16-knot window (the last two knots padding: knot_valid 0, no
    dynamics pair) and a prior on knots 0-5 and on padding knot 15 (which
    knot_valid switches off): numpy (fields, prior)."""
    rng = np.random.default_rng(3)
    st, gaps, cum, lm, uv, conf, _, _ = _build_problem(rng, N_KNOTS, D)
    kv = np.ones(N_KNOTS)
    kv[-2:] = 0.0
    pv = np.ones(N_KNOTS)
    pv[-3:] = 0.0
    fields = dict(states=np.asarray(st), gaps=np.asarray(gaps),
                  cum_rot=np.asarray(cum), lm_xyz=lm,
                  uv=np.asarray(uv).reshape(N_KNOTS, D, 2),
                  conf=np.asarray(conf).reshape(N_KNOTS, D),
                  obs_valid=np.ones((N_KNOTS, D)), pair_valid=pv,
                  knot_valid=kv)
    prop = np.asarray(st).copy()
    prop[:, :3] += rng.normal(size=(N_KNOTS, 3)) * 2.0
    A = rng.normal(size=(N_KNOTS, 6, 6))
    Hs = A @ np.swapaxes(A, 1, 2) + 6 * np.eye(6)
    B = rng.normal(size=(N_KNOTS, 3, 3))
    Hr = (B @ np.swapaxes(B, 1, 2) + 3 * np.eye(3)) * 100.0
    val = np.zeros(N_KNOTS)
    val[:6] = 1.0
    val[-1] = 1.0
    return fields, (prop, Hs, Hr, val)


def _port_inputs(fields, prior, P):
    f = {k: v[None] for k, v in fields.items()}
    f["intrinsics"] = np.asarray(INTR)
    prob = sharded_ba.sharded_problem_from_numpy(f, P, "cpu")
    Nl = N_KNOTS // P
    pri = sharded_ba.ShardedPrior(*(
        torch.as_tensor(a).reshape((1, P, Nl) + a.shape[1:]) for a in prior))
    return prob, pri


def _jax_solve(P, num_iters, max_iters, init_iters, with_prior,
               coeffs=(1.0, 1.0)):
    """JAX's sharded window solver on the case, committed (tests/data/
    make_torch_jax_runs_fixture.py: a compile a configuration; at other
    prior coefficients tests/data/make_torch_prior_coeffs_fixture.py)."""
    if coeffs != (1.0, 1.0):
        fx = np.load(COEFFS_FIXTURE)
        assert (tuple(fx["coeffs"]) == coeffs and with_prior
                and tuple(fx["solve_args"]) == (P, num_iters, max_iters,
                                                init_iters))
        fields, prior = _case()
        for k, v in fields.items():
            np.testing.assert_array_equal(fx[f"solve_prob_{k}"][0], v)
        return tuple(fx[f"solve_out_{i}"] for i in range(3))
    key = "_".join(str(int(a)) for a in (P, num_iters, max_iters,
                                         init_iters, with_prior))
    j = vars(jax_runs(f"dstream_solve_{key}"))
    return tuple(j[str(i)] for i in range(3))


def _port_solve(P, num_iters, max_iters, init_iters, with_prior,
                coeffs=(1.0, 1.0)):
    fields, prior = _case()
    prob, pri = _port_inputs(fields, prior, P)
    solve = sharded_ba.make_sharded_window_solver(
        mesh.make_mesh(1, P, device="cpu"),
        ba.SolverParams(max_iters=max_iters, **PARAMS),
        num_iters=num_iters, init_iters=init_iters, with_prior=with_prior,
        quat_coeff_prior=coeffs[0], vel_coeff_prior=coeffs[1])
    return solve(torch.full((1,), 1e-4, dtype=torch.float64), prob,
                 pri if with_prior else None)


def test_sharded_prior_step_matches_jax():
    """One LM iteration with the prior (the dynamics factor on)."""
    want = _jax_solve(4, 1, 0, 0, True)
    st, lam, res = _port_solve(4, 1, 0, 0, True)
    assert rel_err(st.reshape(1, N_KNOTS, 10), want[0]) < 1e-9
    assert rel_err(lam, want[1]) < 1e-12
    assert rel_err(res, want[2]) < 1e-9
    # the prior moved the step
    no_prior = _port_solve(4, 1, 0, 0, False)[0]
    assert rel_err(no_prior, st) > 1e-6


@pytest.mark.parametrize("budget,with_prior,P,coeffs", [
    pytest.param("fixed", False, 8, (1.0, 1.0), id="fixed-False-8"),
    pytest.param("fixed", True, 1, (1.0, 1.0), id="fixed-True-1"),
    pytest.param("best", True, 8, (1.0, 1.0), id="best-True-8"),
    pytest.param("best", False, 1, (1.0, 1.0), id="best-False-1"),
    pytest.param("fixed", True, 4, (0.5, 2.0), id="fixed-True-4-q0.5-v2")])
def test_window_solver_matches_jax(budget, with_prior, P, coeffs):
    """coeffs: (quat_coeff_prior, vel_coeff_prior)."""
    # fixed: 3 iterations, the last returned; best: 2 + 2 more, the best
    # from the init phase's end (iteration 1) on
    args = (3, 0, 1) if budget == "fixed" else (2, 4, 1)
    want = _jax_solve(P, *args, with_prior, coeffs)
    st, lam, res = _port_solve(P, *args, with_prior, coeffs)
    assert st.shape == (1, P, N_KNOTS // P, 10)
    assert rel_err(st.reshape(1, N_KNOTS, 10), want[0]) < 1e-8
    assert rel_err(lam, want[1]) < 1e-8
    assert rel_err(res, want[2]) < 1e-8
    if coeffs != (1.0, 1.0):
        # the coefficients reach the prior factor
        assert rel_err(_port_solve(P, *args, with_prior)[0], st) > 1e-6


def test_build_window_problem_matches_jax():
    rng = np.random.default_rng(5)
    n, m = 11, 40
    ii = np.sort(rng.integers(0, n, m))
    rng.shuffle(ii[:10])  # observations need not come sorted by knot
    args = (rng.normal(size=(n, 10)), rng.random(n), rng.normal(size=(n, 4)),
            rng.normal(size=(m, 3)), rng.normal(size=(m, 2)), rng.random(m),
            ii, 16, ds._pow2(int(np.bincount(ii).max())),
            np.asarray(INTR), "float64")
    want = jds._build_window_problem(*args)
    got = ds._build_window_problem(*args[:-1], torch.float64, n_arc=4)
    for name in ds.sharded_ba.ShardedProblem._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if name != "intrinsics":
            g = g.reshape(w.shape)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@functools.lru_cache(maxsize=None)
def _stream(tag):
    fx = np.load(FIXTURE)
    kw = {"policy": ({}, {}), "forced": (dict(shard_min_knots=0), {}),
          "marg": (dict(shard_min_knots=0), dict(marginalize=True)),
          "f32": (dict(shard_min_knots=0), dict(dtype="float32"))}[tag]
    res = ds.stream_orbit_sharded(
        fx["det_rows_5b"], fx["orbit_pos_eci_km_5b"],
        mesh.make_mesh(1, int(fx["n_arc"]), device="cpu"),
        seed=int(fx["seed"]),
        cfg=window.StreamingConfig(max_iters=30, **kw[1]), **kw[0])
    return res, fx


@pytest.mark.parametrize("tag", ["forced", "marg"])
def test_stream_orbit_sharded_matches_fixture(tag):
    res, fx = _stream(tag)
    np.testing.assert_array_equal(res.times, fx[f"b5_{tag}_times"])
    d = np.abs(res.errors - fx[f"b5_{tag}_errors"]).max()
    assert d < 1e-6, d
    assert res.final_states.shape == fx[f"b5_{tag}_final_states"].shape


def test_stream_orbit_sharded_f32_matches_fixture():
    res, fx = _stream("f32")
    np.testing.assert_array_equal(res.times, fx["b5_f32_times"])
    assert np.isfinite(res.errors).all()
    # every knot (the CPU reads 0.0436 km, at the final knot: the near tie)
    assert np.abs(res.errors - fx["b5_f32_errors"]).max() < 0.05
    assert abs(res.errors[-1] - fx["b5_f32_errors"][-1]) < 0.05
    assert abs(res.errors[-1] - fx["b5_forced_errors"][-1]) < 0.05


def test_dispatch_routes(monkeypatch):
    """The default dispatch keeps config 5(b)'s small windows on one
    shard; shard_min_knots=0 puts every window on the arc shards."""
    fx = np.load(FIXTURE)
    routes = []
    real = sharded_ba.make_sharded_window_solver

    def record(m, *a, **k):
        routes.append(m.n_arc)
        return real(m, *a, **k)

    monkeypatch.setattr(sharded_ba, "make_sharded_window_solver", record)
    cfg = window.StreamingConfig(max_iters=0, num_iters=1, init_iters=1,
                                 window0_init_f64=False, tail_refine=False)
    for kw, want in ((dict(), 1), (dict(shard_min_knots=0), 8)):
        routes.clear()
        ds.stream_orbit_sharded(fx["det_rows_5b"], fx["orbit_pos_eci_km_5b"],
                                mesh.make_mesh(1, 8, device="cpu"), seed=1,
                                cfg=cfg, **kw)
        assert routes == [want] * len(fx["b5_forced_shapes"])


F32 = dict(dtype="float32")


def _f32_close(got, want):
    """f32 solves of the same problem: every knot within 0.02 km, the
    medians within 0.01 km (the full batch reads 0.0118 and 0.0086 km on
    errors of ~1.7 km; on these arcs JAX's own f32 run lies up to 0.012 km
    from its f64 one at each knot after 20 iterations)."""
    assert np.abs(got - want).max() < 0.02
    assert abs(np.median(got) - np.median(want)) < 0.01


def _seq600():
    """JAX's 600 s along-track arc (frame_stride 10), committed with its
    runs (tests/data/make_torch_jax_runs_fixture.py, "dstream")."""
    return (jax_runs("dstream_seq600").det_rows,
            jax_runs("dstream_seq600").orbit_pos_eci_km)


def test_run_full_batch_f32_matches_jax():
    seq = _seq600()
    kw = dict(seed=1, num_iters=40, init_iters=10)  # config 2's count
    # JAX's f32 run_full_batch with its Thomas solve (the fixture's)
    j = vars(jax_runs("dstream_fullbatch"))
    want = tuple(j[str(i)] for i in range(3))
    got = pipeline.run_full_batch(seq, cfg=window.StreamingConfig(**F32),
                                  device="cpu", **kw)
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    _f32_close(np.linalg.norm(got[0][:, :3] - got[2][:, :3], axis=-1),
               np.linalg.norm(want[0][:, :3] - want[2][:, :3], axis=-1))


def test_prepare_constellation_f32_matches_jax():
    # JAX's 300 s arcs of seeds 0 and 1, its f32 run_constellation of them
    # (Thomas solve) and the arguments of its solve_window_batch call, from
    # the fixture
    j = vars(jax_runs("dstream_const"))
    inputs = [(q.det_rows, q.orbit_pos_eci_km)
              for q in (jax_runs(f"dstream_const{s}") for s in (0, 1))]
    kw = dict(num_iters=20, init_iters=10)
    batch = pipeline._prepare_constellation(
        [0, 1], inputs, 300, window.StreamingConfig(**F32), None, None, "cpu")
    assert batch.states0.dtype == torch.float32
    # the same f64 conditioning rounded to f32 (one cum_rot entry of
    # ~1e-18 rounds apart)
    np.testing.assert_array_equal(batch.states0.numpy(), j["states"])
    np.testing.assert_array_equal(batch.lamda.numpy(), j["lamda"])
    for name in ba.BAProblem._fields:
        w = j[f"prob_{name}"]
        np.testing.assert_allclose(
            getattr(batch.prob, name).numpy().astype(w.dtype), w, rtol=1e-6,
            atol=1e-12, err_msg=name)
    got = pipeline.constellation_from_sequences(
        [0, 1], inputs, 300, cfg=window.StreamingConfig(**F32),
        device="cpu", **kw)
    np.testing.assert_allclose(got["median_errors_km"],
                               j["median_errors_km"], rtol=0, atol=0.01)


def test_long_arc_f32_problem_matches_jax():
    """The f32 build; its 20-iteration solve is held to JAX's f32 one on
    the card (chip_smoke.py phase 19, config 5(a)'s full arc)."""
    seq = _seq600()
    kw = dict(noise_pos_km=20.0)
    jprob = jax_runs("dstream_longarc32")  # JAX's f32 build, committed
    prob, gt, kt, n = long_arc.build_sharded_problem(
        seq, n_arc=4, dtype=torch.float32, device="cpu", **kw)
    assert prob.states.dtype == torch.float32
    for name in ("states", "gaps", "cum_rot", "lm_xyz", "uv", "conf",
                 "obs_valid", "pair_valid"):
        w = getattr(jprob, name)
        np.testing.assert_allclose(
            getattr(prob, name).reshape(w.shape).numpy(), w, rtol=1e-6,
            atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(kt, jprob.knot_t)
    assert n == int(jprob.n_real)


def test_fixture_is_complete():
    fx = np.load(FIXTURE)
    assert json.loads(str(fx["sim_kwargs_5b"]))["pass_every_s"] == 1800
    for tag in ("policy", "forced", "marg", "f32"):
        assert len(fx[f"b5_{tag}_errors"]) == len(fx[f"b5_{tag}_times"])
        # every window's observation budget is a power of two
        d = fx[f"b5_{tag}_shapes"][:, 1]
        assert ((d & (d - 1)) == 0).all()
    assert fx["nees_window_infos"].shape == (7, 9, 9)
    assert fx["nees_block"].shape == (7, 3)
    assert int(fx["ckpt_w0_window_idx"]) == 0
    assert len(fx["early_iters"]) == 7
    assert len(fx["c4_f32_median_errors_km"]) == 8
