"""Regenerate tests/data/torch_modes_seed1.npz: the JAX package's inputs and
results for the port's f32 stream and BASELINE configs 1-3.

Runs the JAX package on the CPU (x64 on, so that an f32 stream's escapes
run in f64, as they do beside a TPU) and stores:

  * config 1/2's sequence, `simulate_sequence(1, 3600, frame_stride=5,
    along_track=True)`: rows and 1 Hz orbit (suffix _12);
  * config 3's gapped sequence (passes every 1800 s, 240 s long): rows,
    orbit and the landmark DB's lon / lat (suffix _3);
  * the 1500 s-gap sequence of config 3's EKF column (passes every 1800 s,
    300 s long: the first 3600 s of the bench arc; suffix _gap);
  * what configs/run_configs.py's runners 1-3 compute at 3600 s, unrounded
    (the runners print them rounded to 3 decimals): config 1's per-knot
    EKF errors; config 2's per-knot errors with JAX's "auto" solve and with
    its Thomas solve; config 3's matcher indices and distances, the
    BA-only and hybrid streams (errors, times, windows, time to 5 km) and
    the two EKF-only columns;
  * JAX's f32 stream of the bench rows (tests/data/torch_stream_seed1.npz):
    errors, times, windows, time to 5 km, recovery trips.

    JAX_PLATFORMS=cpu python tests/data/make_torch_modes_fixture.py [--check]

--check recomputes and compares with the committed file instead of
overwriting it.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.estimation import ba, ekf, factors, ingest  # noqa: E402
from vinsat_tpu.estimation import window  # noqa: E402
from vinsat_tpu.estimation.hybrid import build_knot_obs_buffers  # noqa: E402
from vinsat_tpu.evalx import ate  # noqa: E402
from vinsat_tpu.kernels.matching import nearest_landmark  # noqa: E402

DURATION = 3600
SEED = 1
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_modes_seed1.npz")
STREAM_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "torch_stream_seed1.npz")
SIM_12 = dict(duration_s=DURATION, frame_stride=5, along_track=True)
SIM_3 = dict(SIM_12, pass_every_s=max(900, DURATION // 2), pass_len_s=240)
SIM_GAP = dict(SIM_12, pass_every_s=1800, pass_len_s=300)
EKF_INTR = [3547.8512126219637, 3547.8512126219637, 2304.0, 1296.0]


def _ekf_errors(det_rows, orbit, orbit_len):
    """run_configs.py's run_ekf / _ekf_only_errors filter, unrounded."""
    graph = ingest.build_graph(det_rows, orbit_len)
    gt = ingest.process_ground_truths(orbit, graph)
    N = len(graph.time_idx)
    lm, uv, ov = build_knot_obs_buffers(graph, gt, 0, N, max_obs=8)
    gaps = np.concatenate([[0.0], np.diff(graph.time_idx)]).astype(float)
    cum = np.asarray(factors.cumulative_rotations(
        jnp.asarray(gt.omega_full), 1.0, jnp.asarray(graph.time_idx)))
    cum_before = np.concatenate([[[0, 0, 0, 1.0]], cum[:-1]], axis=0)
    x0 = gt.states[0].copy()
    x0[:3] += np.array([30.0, -20.0, 10.0])
    cov0 = jnp.diag(jnp.array([1e3] * 3 + [1e-2] * 3 + [1e-1] * 3))
    states, _ = ekf.run_filter(
        jnp.asarray(x0), cov0, jnp.asarray(gaps), jnp.asarray(cum_before),
        jnp.asarray(lm), jnp.asarray(uv), jnp.asarray(ov),
        jnp.asarray(EKF_INTR),
        ekf.EKFConfig(num_hops=int(np.ceil(max(gaps.max(), 1) / 100)) + 1))
    return np.linalg.norm(np.asarray(states)[:, :3] - gt.states[:, :3],
                          axis=-1)


@contextlib.contextmanager
def _tridiag_variant(variant):
    """run_full_batch with SolverParams(tridiag_variant=variant): the
    runner builds its own SolverParams, so its default is swapped."""
    orig = ba.SolverParams

    def params(**kw):
        return orig(**dict(kw, tridiag_variant=variant))

    ba.SolverParams = params
    try:
        yield
    finally:
        ba.SolverParams = orig


def _windows(rows, orbit, seed, cfg):
    prep = window.prepare_stream(rows, orbit, seed, cfg)
    return len(ingest.split_windows(prep.graph.ii, prep.knot_t))


def _stream(rows, orbit, seed, cfg, tag, out):
    res = window.stream_orbit(rows, orbit, seed=seed, cfg=cfg)
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    out.update({
        f"{tag}_errors": np.asarray(res.errors, np.float64),
        f"{tag}_times": np.asarray(res.times),
        f"{tag}_windows": np.array(_windows(rows, orbit, seed, cfg)),
        f"{tag}_time_to_5km_s": np.array(np.nan if t5 is None else t5),
        f"{tag}_final_error_km": np.array(float(res.errors[-1])),
        f"{tag}_recovery_trips": np.array(int(res.recovery_trips)),
    })


def make() -> dict:
    out = {"seed": np.array(SEED), "duration_s": np.array(DURATION),
           "sim_kwargs_12": np.array(json.dumps(SIM_12)),
           "sim_kwargs_3": np.array(json.dumps(SIM_3)),
           "sim_kwargs_gap": np.array(json.dumps(SIM_GAP))}
    seqs = {tag: pipeline.simulate_sequence(SEED, **kw)
            for tag, kw in (("12", SIM_12), ("3", SIM_3), ("gap", SIM_GAP))}
    for tag, seq in seqs.items():
        out[f"det_rows_{tag}"] = np.asarray(seq.det_rows, np.float64)
        out[f"orbit_pos_eci_km_{tag}"] = np.asarray(seq.orbit_pos_eci_km,
                                                    np.float64)
    out["db_lon_3"] = np.asarray(seqs["3"].db.lon, np.float64)
    out["db_lat_3"] = np.asarray(seqs["3"].db.lat, np.float64)

    # config 1
    s12 = seqs["12"]
    out["c1_errors"] = _ekf_errors(s12.det_rows, s12.orbit_pos_eci_km,
                                   DURATION)
    # config 2, with JAX's "auto" solve (bcr16 at this N in f64) and Thomas
    for tag, variant in (("", "auto"), ("_thomas", "thomas")):
        with _tridiag_variant(variant):
            states, knot_t, gt_states = pipeline.run_full_batch(
                s12, seed=SEED, num_iters=40)
        out[f"c2_errors{tag}"] = np.linalg.norm(
            states[:, :3] - gt_states[:, :3], axis=-1)
    out["c2_knots"] = np.array(len(knot_t))

    # config 3
    s3 = seqs["3"]
    idx, d2 = nearest_landmark(jnp.asarray(s3.det_rows[:, 1:3]), s3.db.lon,
                               s3.db.lat)
    rows = s3.det_rows.copy()
    rows[:, 1] = np.asarray(s3.db.lon)[np.asarray(idx)]
    rows[:, 2] = np.asarray(s3.db.lat)[np.asarray(idx)]
    out["c3_matcher_idx"] = np.asarray(idx, np.int64)
    out["c3_matcher_d2"] = np.asarray(d2, np.float64)
    for tag, cfg in (("c3_ba_only", window.StreamingConfig()),
                     ("c3_hybrid",
                      window.StreamingConfig(use_ekf_hybrid=True))):
        _stream(rows, s3.orbit_pos_eci_km, SEED, cfg, tag, out)
    out["c3_ekf_only_errors"] = _ekf_errors(
        rows, s3.orbit_pos_eci_km, s3.orbit_pos_eci_km.shape[0] - 1)
    sg = seqs["gap"]
    out["c3_ekf_only_long_gap_errors"] = _ekf_errors(
        sg.det_rows, sg.orbit_pos_eci_km, sg.orbit_pos_eci_km.shape[0] - 1)

    # the f32 stream of the bench rows
    fx = np.load(STREAM_FIXTURE)
    _stream(fx["det_rows"], fx["orbit_pos_eci_km"], int(fx["seed"]),
            window.StreamingConfig(dtype="float32"), "f32", out)
    return out


def main() -> None:
    ref = make()
    if "--check" in sys.argv[1:]:
        old = np.load(PATH)
        for k, v in ref.items():
            o = old[k]
            same = (np.array_equal(o, v) if o.dtype.kind in "iuUS"
                    else np.allclose(o, v, rtol=0, atol=1e-9, equal_nan=True))
            print(f"{k}: {'ok' if same else 'DIFFERS'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH}: {os.path.getsize(PATH) / 1e6:.2f} MB")
    for k in sorted(ref):
        v = ref[k]
        if v.ndim == 0:
            print(f"  {k} = {v}")
        else:
            print(f"  {k}: {v.shape} {v.dtype}")


if __name__ == "__main__":
    main()
