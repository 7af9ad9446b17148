"""Regenerate tests/data/torch_dist_stream_seed1.npz: the JAX package's inputs
and results for the port's sharded stream (BASELINE config 5(b)), the stream
driver's NEES tracking, auto-calibration, checkpoints and early stop, and
configs 2, 4 and 5(a) solved in f32.

Runs the JAX package on the CPU (x64 on, so that conditioning runs in f64
whatever the solve's dtype, as it does beside an accelerator) on a virtual
mesh of 8 CPU devices, and stores:

  * config 5(b)'s sequence, `simulate_sequence(1, 3600, frame_stride=5,
    along_track=True, pass_every_s=1800, pass_len_s=240)` (what
    configs/run_configs.py's run_longarc streams at --duration 3600): rows
    and 1 Hz orbit (suffix _5b);
  * `stream_orbit_sharded` of it on a 1 x 8 mesh with
    StreamingConfig(max_iters=30), seed 1, in four runs: `policy` (the
    default dispatch), `forced` (shard_min_knots=0), `marg` (marginalize,
    shard_min_knots=0) and `f32` (dtype float32, shard_min_knots=0):
    errors, times, final states, and the (n_pad, d_pad) of every window
    problem built (`_build_window_problem`'s calls, in order);
  * over the bench rows of tests/data/torch_stream_seed1.npz: a
    `track_nees` stream checkpointed at every window (errors, times, final
    states, window_infos / est / gt, each window's block NEES, and the w0
    checkpoint file's arrays under ckpt_w0_*), a bounded stream with
    `auto_calibrate` (errors, times, final states), and an early-stop
    stream (SolverParams(conv_patience=5), max_iters 60: errors, times and
    the LM iterations of every window solve);
  * configs 2, 4 and 5(a) in f32 (StreamingConfig(dtype="float32") /
    build_sharded_problem(dtype=float32)): config 2's per-knot errors on
    tests/data/torch_modes_seed1.npz's rows, config 4's orbits and medians
    (run_constellation(range(8), 3600, num_iters=20), simulating its
    sequences), config 5(a)'s per-knot errors on
    tests/data/torch_longarc_seed1.npz's rows.

About 12 minutes on the CPU; the file is ~0.3 MB.

    python tests/data/make_torch_dist_stream_fixture.py [--check]

--check recomputes and compares with the committed file instead of
overwriting it.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
import types

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.dist import long_arc, mesh as mesh_mod  # noqa: E402
from vinsat_tpu.dist import stream as dist_stream  # noqa: E402
from vinsat_tpu.estimation import ba, window  # noqa: E402
from vinsat_tpu.evalx import calibration  # noqa: E402
from vinsat_tpu.utils import checkpoint  # noqa: E402

SEED = 1
N_ARC = 8
SIM_5B = dict(duration_s=3600, frame_stride=5, along_track=True,
              pass_every_s=1800, pass_len_s=240)
RUNS_5B = {
    "policy": (dict(), dict()),
    "forced": (dict(shard_min_knots=0), dict()),
    "marg": (dict(shard_min_knots=0), dict(marginalize=True)),
    "f32": (dict(shard_min_knots=0), dict(dtype="float32")),
}
EARLY_STOP = dict(conv_patience=5)
PATH = os.path.join(HERE, "torch_dist_stream_seed1.npz")
STREAM_FIXTURE = os.path.join(HERE, "torch_stream_seed1.npz")
MODES_FIXTURE = os.path.join(HERE, "torch_modes_seed1.npz")
LONGARC_FIXTURE = os.path.join(HERE, "torch_longarc_seed1.npz")


@contextlib.contextmanager
def _patched(module, name, make_hook):
    """module.name replaced by make_hook(original) for the block."""
    orig = getattr(module, name)
    setattr(module, name, make_hook(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _sharded_runs(out: dict) -> None:
    seq = pipeline.simulate_sequence(SEED, **SIM_5B)
    out["det_rows_5b"] = np.asarray(seq.det_rows, np.float64)
    out["orbit_pos_eci_km_5b"] = np.asarray(seq.orbit_pos_eci_km, np.float64)
    mesh = mesh_mod.make_mesh(n_orbit=1, n_arc=N_ARC)
    for tag, (kw, cfg_kw) in RUNS_5B.items():
        shapes = []

        def record(build):
            def hook(*a, **k):
                shapes.append(a[7:9])  # (n_pad, d_pad)
                return build(*a, **k)
            return hook

        cfg = window.StreamingConfig(max_iters=30, **cfg_kw)
        t0 = time.time()
        with _patched(dist_stream, "_build_window_problem", record):
            res = dist_stream.stream_orbit_sharded(
                seq.det_rows, seq.orbit_pos_eci_km, mesh, seed=SEED, cfg=cfg,
                **kw)
        print(f"5(b) {tag}: {time.time() - t0:.1f} s, final "
              f"{res.errors[-1]:.6f} km, windows (n_pad, d_pad) {shapes}")
        out.update({
            f"b5_{tag}_errors": np.asarray(res.errors, np.float64),
            f"b5_{tag}_times": np.asarray(res.times),
            f"b5_{tag}_final_states": np.asarray(res.final_states,
                                                 np.float64),
            f"b5_{tag}_shapes": np.asarray(shapes, np.int64),
        })


def _bench_runs(out: dict) -> None:
    fx = np.load(STREAM_FIXTURE)
    rows, orbit, seed = fx["det_rows"], fx["orbit_pos_eci_km"], int(fx["seed"])

    # NEES tracking, checkpointed at every window
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck")
        res = window.stream_orbit(rows, orbit, seed=seed,
                                  cfg=window.StreamingConfig(track_nees=True),
                                  checkpoint_path=ck)
        with np.load(f"{ck}.w0.npz") as z:
            for k in z.files:
                out[f"ckpt_w0_{k}"] = z[k]
        # the JAX loader's view of it (has_hessian folded in)
        assert checkpoint.load(f"{ck}.w0")["window_idx"] == 0
    bn = [calibration.block_nees(e, g, h) for h, e, g in zip(
        res.window_infos, res.window_est, res.window_gt)]
    out.update(
        nees_errors=np.asarray(res.errors, np.float64),
        nees_times=np.asarray(res.times),
        nees_final_states=np.asarray(res.final_states, np.float64),
        nees_window_infos=np.asarray(res.window_infos, np.float64),
        nees_window_est=np.asarray(res.window_est, np.float64),
        nees_window_gt=np.asarray(res.window_gt, np.float64),
        nees_block=np.array([[b[k] for k in ("pos", "rot", "vel")]
                             for b in bn]))
    print(f"nees: {len(bn)} windows, final {res.errors[-1]:.6f} km")

    # bounded windows with the anchor prior auto-calibrated
    res = window.stream_orbit(
        rows, orbit, seed=seed,
        cfg=window.StreamingConfig(marginalize=True, auto_calibrate=True))
    out.update(autocal_errors=np.asarray(res.errors, np.float64),
               autocal_times=np.asarray(res.times),
               autocal_final_states=np.asarray(res.final_states, np.float64))
    print(f"autocal: final {res.errors[-1]:.6f} km")

    # the residual-gated early stop; each window solve's iterations counted
    # by a host callback in ba_iteration (fresh traces: the params differ)
    count, iters = [0], []

    def counted_iteration(it):
        def hook(*a, **k):
            step = it(*a, **k)
            jax.debug.callback(lambda: count.__setitem__(0, count[0] + 1))
            return step
        return hook

    def counted_solve(solve):
        def hook(*a, **k):
            count[0] = 0
            r = jax.block_until_ready(solve(*a, **k))
            jax.effects_barrier()
            iters.append(count[0])
            return r
        return hook

    with _patched(ba, "ba_iteration", counted_iteration), \
            _patched(window, "solve_window", counted_solve):
        res = window.stream_orbit(rows, orbit, seed=seed,
                                  solver=ba.SolverParams(**EARLY_STOP),
                                  fast=False)
    out.update(early_errors=np.asarray(res.errors, np.float64),
               early_times=np.asarray(res.times),
               early_iters=np.asarray(iters, np.int64),
               early_solver_kwargs=np.array(json.dumps(EARLY_STOP)))
    print(f"early stop: iterations {iters}, final {res.errors[-1]:.6f} km")


def _f32_configs(out: dict) -> None:
    f32 = window.StreamingConfig(dtype="float32")
    md = np.load(MODES_FIXTURE)
    seq12 = types.SimpleNamespace(det_rows=md["det_rows_12"],
                                  orbit_pos_eci_km=md["orbit_pos_eci_km_12"])
    states, knot_t, gt_states = pipeline.run_full_batch(
        seq12, seed=SEED, num_iters=40, cfg=f32)
    out["c2_f32_errors"] = np.linalg.norm(states[:, :3] - gt_states[:, :3],
                                          axis=-1)
    print(f"config 2 f32: median {np.median(out['c2_f32_errors']):.6f} km")

    t0 = time.time()
    res = pipeline.run_constellation(list(range(8)), 3600, num_iters=20,
                                     cfg=f32)
    out["c4_f32_seeds"] = np.array(res["orbit_seeds"])
    out["c4_f32_median_errors_km"] = np.array(res["median_errors_km"])
    print(f"config 4 f32 ({time.time() - t0:.1f} s): medians "
          f"{res['median_errors_km']}")

    la = np.load(LONGARC_FIXTURE)
    seq5 = types.SimpleNamespace(det_rows=la["det_rows"],
                                 orbit_pos_eci_km=la["orbit_pos_eci_km"])
    mesh = mesh_mod.make_mesh(n_orbit=1, n_arc=int(la["n_arc"]))
    prob, gt, kt, n_real = long_arc.build_sharded_problem(
        seq5, n_arc=int(la["n_arc"]), dtype=jnp.float32,
        **json.loads(str(la["problem_kwargs"])))
    res5 = long_arc.solve_long_arc(mesh, prob, gt, kt, n_real,
                                   **json.loads(str(la["solve_kwargs"])))
    out["c5a_f32_errors_km"] = np.asarray(res5.errors_km, np.float64)
    print(f"config 5(a) f32: median {np.median(res5.errors_km):.6f} km")


def make() -> dict:
    out = {"seed": np.array(SEED), "n_arc": np.array(N_ARC),
           "sim_kwargs_5b": np.array(json.dumps(SIM_5B))}
    _sharded_runs(out)
    _bench_runs(out)
    _f32_configs(out)
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
