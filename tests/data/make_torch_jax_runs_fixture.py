"""Regenerate tests/data/torch_jax_runs_seed1.npz: JAX package runs that
the port's CPU tests compare against, committed so that the tests do not
compile JAX for them.

Runs the JAX package on the CPU as the tests configure it (x64 on, 8
virtual CPU devices; tests/conftest.py) and stores:

  * the arc, `simulate_sequence(1, duration_s=3600, frame_stride=10,
    along_track=True, pass_every_s=1200, pass_len_s=240)`: rows and 1 Hz
    orbit (prefix seq_);
  * `prepare_stream` of it (seed 1, f64): knots, initial states,
    cumulative rotations, and `split_windows` (prefix prep_);
  * stream_orbit (seed 1) in each configuration a port test holds to it:
    f64 with max_iters 30 (plain30_, tests/test_torch_stream.py);
    track_nees at the fixed budget (max_iters 0) with the Thomas solve
    (nees_, tests/test_torch_calibration.py); use_prior at the fixed
    budget with the Thomas solve (prior_, tests/test_torch_prior.py);
    marginalize and use_ekf_hybrid with max_iters 30 (marginalize_,
    use_ekf_hybrid_, tests/test_torch_modes.py and test_torch_f32.py);
    f32 with max_iters 30 (f32_, tests/test_torch_f32.py): times, errors,
    recovery trips, first detection and, with NEES tracking, the window
    marginals, estimates and GT;
  * window 0 of the f32 stream as the stream pads it, and JAX's f64 init
    phase of it (`_window0_init_f64_cpu`, Thomas solve; prefix w0_,
    tests/test_torch_f32.py);
  * tests/test_torch_long_arc.py's run (prefix longarc_): the 900 s
    along-track arc (`simulate_sequence(1, duration_s=900,
    frame_stride=10, along_track=True)`), `build_sharded_problem` on 4 arc
    shards in f64 and at its default dtype (f32), and `solve_long_arc`
    (6 iterations, 3 vision-only) on a 4-device mesh;
  * tests/test_torch_dist.py's sharded LM steps (prefix dist_): each of
    its STEP_CASES' problem fields and JAX's step (states, λ) on a
    4-device mesh, and JAX's sharded SPIKE solve of its 20-row system;
  * tests/test_torch_constellation.py's runs (prefix const_): the 600 s
    sequences of seeds 0-2 along track and 0-3 over the region DB
    (frame_stride 5), `run_constellation` of each set (4 iterations, 2
    vision-only, the Thomas solve) with the arguments of its
    `solve_window_batch` call, and that call at 1 and 4 iterations;
  * tests/test_torch_dist_stream.py's runs (prefix dstream_): the sharded
    window solver on its 16-knot case at each (shards, iterations,
    budget, init iterations, prior) it tests; the 600 s along-track arc
    (frame_stride 10) with `run_full_batch` in f32 (40 iterations, 10
    vision-only, the Thomas solve) and `build_sharded_problem` in f32 on
    4 shards; the 300 s arcs of seeds 0 and 1 (frame_stride 5) with
    `run_constellation` in f32 (20 iterations, 10 vision-only, the Thomas
    solve) and the arguments of its `solve_window_batch` call;
  * `_solve_window_f64_cpu` with a prior on tests/test_torch_prior.py's
    window cast to f32 (10 iterations, the Thomas solve; prefix
    f64prior_, tests/test_torch_f32.py), and `run_full_batch` of the
    600 s along-track arc at frame_stride 5 (12 iterations, 4
    vision-only, the Thomas solve; prefix fullbatch_,
    tests/test_torch_modes.py).

    JAX_PLATFORMS=cpu python tests/data/make_torch_jax_runs_fixture.py [--check]

(~10 min.)  --check recomputes and compares with the committed file instead
of overwriting it.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax.numpy as jnp  # noqa: E402

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.dist import long_arc, mesh, sharded_ba, tridiag  # noqa: E402
from vinsat_tpu.estimation import ba, ingest, window  # noqa: E402

SEED = 1
SIM_KW = dict(duration_s=3600, frame_stride=10, along_track=True,
              pass_every_s=1200, pass_len_s=240)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_jax_runs_seed1.npz")
THOMAS = ba.SolverParams(tridiag_variant="thomas")
# (prefix, StreamingConfig kwargs, solver)
STREAMS = [
    ("plain30", dict(dtype="float64", max_iters=30), ba.SolverParams()),
    ("nees", dict(max_iters=0, track_nees=True), THOMAS),
    ("prior", dict(use_prior=True, max_iters=0), THOMAS),
    ("marginalize", dict(marginalize=True, max_iters=30), ba.SolverParams()),
    ("use_ekf_hybrid", dict(use_ekf_hybrid=True, max_iters=30),
     ba.SolverParams()),
    ("f32", dict(dtype="float32", max_iters=30), ba.SolverParams()),
]
PROB_FIELDS = ("gaps", "cum_rot", "landmarks_xyz", "landmarks_uv", "conf",
               "ii", "obs_valid", "knot_valid", "pair_valid", "intrinsics")


def make() -> dict:
    seq = pipeline.simulate_sequence(SEED, **SIM_KW)
    rows, orbit = seq.det_rows, seq.orbit_pos_eci_km
    out = {"sim_kwargs": np.array(json.dumps(SIM_KW)),
           "seq_det_rows": np.asarray(rows),
           "seq_orbit_pos_eci_km": np.asarray(orbit)}
    prep = window.prepare_stream(rows, orbit, SEED,
                                 window.StreamingConfig(dtype="float64"))
    out.update(prep_knot_t=np.asarray(prep.knot_t),
               prep_states0=np.asarray(prep.states0),
               prep_cum_rot=np.asarray(prep.cum_rot),
               prep_windows=np.array(ingest.split_windows(prep.graph.ii,
                                                          prep.knot_t)))
    for tag, kw, solver in STREAMS:
        res = window.stream_orbit(rows, orbit, seed=SEED,
                                  cfg=window.StreamingConfig(**kw),
                                  solver=solver)
        out[f"{tag}_times"] = np.asarray(res.times)
        out[f"{tag}_errors"] = np.asarray(res.errors)
        out[f"{tag}_recovery_trips"] = np.array(res.recovery_trips)
        out[f"{tag}_first_detection"] = np.array(res.first_detection)
        if res.window_infos is not None:
            out[f"{tag}_window_infos"] = np.asarray(res.window_infos)
            out[f"{tag}_window_est"] = np.asarray(res.window_est)
            out[f"{tag}_window_gt"] = np.asarray(res.window_gt)

    # window 0 of the f32 stream, padded as the stream pads it, and JAX's
    # f64 init phase of it
    prep32 = window.prepare_stream(rows, orbit, SEED,
                                   window.StreamingConfig(dtype="float32"))
    t_final, i_final, _ = ingest.split_windows(prep32.graph.ii,
                                               prep32.knot_t)[0]
    g = prep32.graph
    st0, prob = window._pad_problem(
        prep32.states0[:t_final], prep32.gaps[:t_final],
        prep32.cum_rot[:t_final], prep32.gt.landmarks_xyz[:i_final],
        g.uv[:i_final], g.conf[:i_final], g.ii[:i_final],
        window.bucket(t_final), window.bucket(i_final, 64, 64), "float32")
    hops = int(np.ceil(prep32.gaps.max() / 100.0)) + 1
    want = window._window0_init_f64_cpu(
        st0, prob, 1e-4, 10,
        ba.SolverParams(num_hops=hops, tridiag_variant="thomas"))
    out["w0_st0"] = np.asarray(st0)
    out["w0_hops"] = np.array(hops)
    out["w0_want"] = np.asarray(want)
    for name in PROB_FIELDS:
        out[f"w0_prob_{name}"] = np.asarray(getattr(prob, name))
    out.update(_long_arc())
    out.update(_dist())
    out.update(_constellation())
    out.update(_dist_stream())
    out.update(_f64_prior())
    out.update(_full_batch())
    return out


def _f64_prior() -> dict:
    import test_torch_prior as t
    from torch_parity import jax_problem

    st0, fields, pri = t._case()
    f32 = {k: (v if k == "ii" else np.asarray(v, np.float32))
           for k, v in fields.items()}
    pri32 = tuple(np.asarray(a, np.float32) for a in pri)
    got = window._solve_window_f64_cpu(
        jnp.asarray(st0, jnp.float32), jax_problem(f32), 1e-4, 0, 10,
        ba.SolverParams(num_hops=4, tridiag_variant="thomas"),
        prior=t._jprior(pri32))
    return {f"f64prior_{i}": np.asarray(v) for i, v in enumerate(got)}


def _full_batch() -> dict:
    seq = pipeline.simulate_sequence(1, duration_s=600, frame_stride=5,
                                     along_track=True)
    orig = _thomas_params()
    try:
        want = pipeline.run_full_batch(seq, seed=1, num_iters=12,
                                       init_iters=4)
    finally:
        ba.SolverParams = orig
    out = {"fullbatch_det_rows": np.asarray(seq.det_rows),
           "fullbatch_orbit_pos_eci_km": np.asarray(seq.orbit_pos_eci_km)}
    for i, v in enumerate(want):
        out[f"fullbatch_{i}"] = np.asarray(v)
    return out


def _thomas_params():
    """ba.SolverParams with the Thomas solve, whatever the caller asks
    (what the tests' `jax_thomas` fixture patches in)."""
    orig = ba.SolverParams
    ba.SolverParams = lambda **kw: orig(**dict(kw,
                                               tridiag_variant="thomas"))
    return orig


def _window_solve(P, num_iters, max_iters, init_iters, with_prior):
    """JAX's sharded window solver on tests/test_torch_dist_stream.py's
    16-knot case (its fields and prior, one orbit)."""
    import test_torch_dist_stream as t

    fields, prior = t._case()
    prob = sharded_ba.ShardedProblem(
        **{k: jnp.asarray(v)[None] for k, v in fields.items()},
        intrinsics=t.INTR)
    pri = sharded_ba.ShardedPrior(*(jnp.asarray(a)[None] for a in prior))
    solve = sharded_ba.make_sharded_window_solver(
        mesh.make_mesh(n_orbit=1, n_arc=P),
        ba.SolverParams(max_iters=max_iters, **t.PARAMS),
        num_iters=num_iters, init_iters=init_iters, with_prior=with_prior)
    out = solve(jnp.full((1,), 1e-4), prob, pri if with_prior else None)
    return tuple(np.asarray(o) for o in out)


def _dist_stream() -> dict:
    out = {}
    for P, args, prior in ((4, (1, 0, 0), True), (8, (3, 0, 1), False),
                           (1, (3, 0, 1), True), (8, (2, 4, 1), True),
                           (1, (2, 4, 1), False)):
        for i, v in enumerate(_window_solve(P, *args, prior)):
            key = "_".join(str(int(a)) for a in (P, *args, prior))
            out[f"dstream_solve_{key}_{i}"] = np.asarray(v)
    f32 = window.StreamingConfig(dtype="float32")
    seq = pipeline.simulate_sequence(1, duration_s=600, frame_stride=10,
                                     along_track=True)
    out.update(dstream_seq600_det_rows=np.asarray(seq.det_rows),
               dstream_seq600_orbit_pos_eci_km=np.asarray(
                   seq.orbit_pos_eci_km))
    orig = _thomas_params()
    try:
        fb = pipeline.run_full_batch(seq, cfg=f32, seed=1, num_iters=40,
                                     init_iters=10)
    finally:
        ba.SolverParams = orig
    for i, v in enumerate(fb):
        out[f"dstream_fullbatch_{i}"] = np.asarray(v)
    prob, _, kt, n = long_arc.build_sharded_problem(
        seq, n_arc=4, dtype=jnp.float32, noise_pos_km=20.0)
    for name in ("states", "gaps", "cum_rot", "lm_xyz", "uv", "conf",
                 "obs_valid", "pair_valid"):
        out[f"dstream_longarc32_{name}"] = np.asarray(getattr(prob, name))
    out.update(dstream_longarc32_knot_t=np.asarray(kt),
               dstream_longarc32_n_real=np.array(n))
    seqs = [pipeline.simulate_sequence(s, 300, along_track=True,
                                       frame_stride=5) for s in (0, 1)]
    for s, q in zip((0, 1), seqs):
        out[f"dstream_const{s}_det_rows"] = np.asarray(q.det_rows)
        out[f"dstream_const{s}_orbit_pos_eci_km"] = np.asarray(
            q.orbit_pos_eci_km)
    rec, real_batch = {}, window.solve_window_batch
    real_sim = pipeline.simulate_sequence

    def capture(states_b, prob_b, lamda_b, *a, **k):
        rec.update(states=np.asarray(states_b), prob=prob_b,
                   lamda=np.asarray(lamda_b))
        return real_batch(states_b, prob_b, lamda_b, *a, **k)

    window.solve_window_batch = capture
    pipeline.simulate_sequence = lambda s, *a, **k: seqs[s]
    orig = _thomas_params()
    try:
        want = pipeline.run_constellation([0, 1], 300, cfg=f32,
                                          num_iters=20, init_iters=10)
    finally:
        ba.SolverParams = orig
        window.solve_window_batch = real_batch
        pipeline.simulate_sequence = real_sim
    out.update(dstream_const_states=rec["states"],
               dstream_const_lamda=rec["lamda"],
               dstream_const_median_errors_km=np.asarray(
                   want["median_errors_km"]))
    for name in PROB_FIELDS:
        out[f"dstream_const_prob_{name}"] = np.asarray(
            getattr(rec["prob"], name))
    return out


def _constellation() -> dict:
    out = {}
    for mode, along, seeds in (("track", True, (0, 1, 2)),
                               ("region", False, (0, 1, 2, 3))):
        for s in seeds:
            seq = pipeline.simulate_sequence(s, 600, along_track=along,
                                             frame_stride=5)
            out[f"const_{mode}_seq{s}_det_rows"] = np.asarray(seq.det_rows)
            out[f"const_{mode}_seq{s}_orbit_pos_eci_km"] = np.asarray(
                seq.orbit_pos_eci_km)
        real, rec = window.solve_window_batch, {}

        def thomas(states_b, prob_b, lamda_b, init_iters, n, params,
                   sched_offset=0):
            params = params._replace(tridiag_variant="thomas")
            rec.update(args=(states_b, prob_b, lamda_b), params=params)
            return real(states_b, prob_b, lamda_b, init_iters, n, params,
                        sched_offset=sched_offset)

        window.solve_window_batch = thomas
        try:
            res = pipeline.run_constellation(list(seeds), 600, num_iters=4,
                                             init_iters=2, along_track=along)
        finally:
            window.solve_window_batch = real
        out[f"const_{mode}_keys"] = np.array(sorted(res))
        out[f"const_{mode}_num_orbits"] = np.array(res["num_orbits"])
        out[f"const_{mode}_orbit_seeds"] = np.asarray(res["orbit_seeds"])
        out[f"const_{mode}_median_errors_km"] = np.asarray(
            res["median_errors_km"])
        if mode != "track":
            continue
        states_b, prob_b, lamda_b = rec["args"]
        out["const_states_b"] = np.asarray(states_b)
        out["const_lamda_b"] = np.asarray(lamda_b)
        out["const_params"] = np.array(json.dumps(rec["params"]._asdict()))
        for name in PROB_FIELDS:
            out[f"const_prob_{name}"] = np.asarray(getattr(prob_b, name))
        for n in (1, 4):
            got = real(states_b, prob_b, lamda_b, jnp.asarray(2), n,
                       rec["params"], sched_offset=jnp.asarray(-2))
            for name, v in zip(("states", "lamda", "last_hessian",
                                "mean_residual"), got):
                out[f"const_solve{n}_{name}"] = np.asarray(v)
    return out


def _long_arc() -> dict:
    import test_torch_long_arc as t

    seq = pipeline.simulate_sequence(1, duration_s=900, frame_stride=10,
                                     along_track=True)
    out = {"longarc_det_rows": np.asarray(seq.det_rows),
           "longarc_orbit_pos_eci_km": np.asarray(seq.orbit_pos_eci_km)}
    prob, gt, kt, n = long_arc.build_sharded_problem(
        seq, n_arc=t.N_ARC, dtype=jnp.float64, **t.PROBLEM_KW)
    res = long_arc.solve_long_arc(mesh.make_mesh(n_orbit=1, n_arc=t.N_ARC),
                                  prob, gt, kt, n, **t.SOLVE_KW)
    prob32 = long_arc.build_sharded_problem(seq, n_arc=t.N_ARC,
                                            **t.PROBLEM_KW)[0]
    out.update(longarc_gt=np.asarray(gt), longarc_knot_t=np.asarray(kt),
               longarc_n_real=np.array(n),
               longarc_res_states=np.asarray(res.states),
               longarc_res_knot_times=np.asarray(res.knot_times),
               longarc_res_errors_km=np.asarray(res.errors_km))
    for name in sharded_ba.ShardedProblem._fields:
        if getattr(prob, name) is not None:
            out[f"longarc_prob_{name}"] = np.asarray(getattr(prob, name))
    for name in ("states", "gaps", "cum_rot", "lm_xyz", "uv", "conf"):
        out[f"longarc_prob32_{name}"] = np.asarray(getattr(prob32, name))
    return out


def _dist() -> dict:
    import test_torch_dist as t

    jmesh = mesh.make_mesh(n_orbit=1, n_arc=t.N_ARC)
    step = sharded_ba.make_sharded_ba_step(jmesh,
                                           ba.SolverParams(**t.PARAMS))
    out = {}
    for c, (it, init, n_real) in enumerate(t.STEP_CASES):
        fields = t._problem_fields(np.random.default_rng(0), n_real)
        prob = sharded_ba.ShardedProblem(**{k: jnp.asarray(v)
                                            for k, v in fields.items()})
        st, lam = step(jnp.asarray(it), jnp.full((1,), 1e-4), prob,
                       initialize=init)
        out[f"dist_step{c}_case"] = np.array([it, init, n_real])
        out[f"dist_step{c}_st"] = np.asarray(st)
        out[f"dist_step{c}_lam"] = np.asarray(lam)
        for k, v in fields.items():
            out[f"dist_step{c}_field_{k}"] = np.asarray(v)
    D, U, b = t._tridiag_system(np.random.default_rng(2), 20)
    out["dist_tridiag_want"] = np.asarray(tridiag.sharded_block_tridiag_solve(
        jmesh, jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)))
    return out


def main() -> None:
    ref = make()
    if "--check" in sys.argv[1:]:
        old = np.load(PATH)
        for k, v in ref.items():
            o = old[k]
            same = (np.array_equal(o, v) if o.dtype.kind in "iuUSb"
                    else np.allclose(o, v, rtol=0, atol=1e-9, equal_nan=True))
            print(f"{k}: {'ok' if same else 'DIFFERS'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH}: {os.path.getsize(PATH) / 1e6:.2f} MB")
    for k in sorted(ref):
        v = ref[k]
        print(f"  {k} = {v}" if v.ndim == 0 else f"  {k}: {v.shape} {v.dtype}")


if __name__ == "__main__":
    main()
