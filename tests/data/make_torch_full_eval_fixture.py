"""Regenerate tests/data/torch_full_eval.npz: the JAX package's synthetic
full evaluation (bench.py's BENCH_FULL_EVAL=synthetic loop: 16 orbits,
seeds 0-15, 10800 s each), for the PyTorch port to be held to on the card
orbit by orbit.

For each seed the JAX package simulates `simulate_sequence(seed, 10800)`
with its defaults (mode b: frame_stride 1, the 7920-landmark synthesized
DB over the 16 detector-active regions) on the CPU in float64; stored
under the suffix `_<seed>`:

  draws  — `oe`, `q0`, `w0`, `db_seed`, the selection score of every
           in-view pair of a gated frame (`score_frame` int32,
           `score_landmark` int16, `score`), the pixel noise and
           confidence draws of the valid slots (`noise`, `conf`), as
           tests/data/make_torch_sim_fixture.py stores them
           (tests/torch_parity.py:jax_simulation);
  rows   — `n_rows` and the rows' frame column `frames` (int32);
  stream — JAX's f64 stream (`run_streaming`, the default StreamingConfig
           in float64): `errors`, `times`, `num_windows`,
           `time_to_5km_s`, `final_error_km`, `recovery_trips`;
  bound  — `terminal_crlb_km`'s `crlb_final_km`, `crlb_last_knot_km`,
           `crlb_att_final_km`, `n_obs`, `obs_span_s`;
  margin — `margin_km` (3,): the smallest distance of any of the orbit's
           JAX errors from 1, 2 and 5 km (inf without a stream).

An orbit without a stream (no rows, or none surviving the stream's
gating) has empty errors and times, `has_stream` False and NaN bounds; it
leaves the summary as bench.py's loop leaves it.  Beside the orbits:
`seeds`, `duration_s`, and JAX's `ate.summarize` over the orbits
(`summary_keys`, `summary`).  Not stored: the rows themselves (the draws
reproduce them) and the trajectory (rolled out again from oe / q0 / w0).

Seed 1's orbit is the one of tests/data/torch_eval_seed1.npz; the script
checks its draws against tests/data/torch_sim_seed1.npz's mode b and its
stream and bound against tests/data/torch_eval_seed1.npz (1e-9).

Each orbit takes 85-200 s in one process on the CPU at a peak of ~7.7 GB
(JAX projects the 7920 landmarks into all 10801 frames): ~30 min in one
process, 917 s with `--jobs 2` (two worker processes); the file is
3.3 MB.

    python tests/data/make_torch_full_eval_fixture.py [--check] [--jobs N]

--check recomputes everything and compares it with the committed file
instead of overwriting it.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "torch_full_eval.npz")
SIM_FIXTURE = os.path.join(HERE, "torch_sim_seed1.npz")
EVAL_FIXTURE = os.path.join(HERE, "torch_eval_seed1.npz")
SEEDS = tuple(range(16))
DURATION_S = 10800
THRESHOLDS_KM = (1.0, 2.0, 5.0)
CRLB_KEYS = ("crlb_final_km", "crlb_last_knot_km", "crlb_att_final_km",
             "n_obs", "obs_span_s")
DRAW_KEYS = ("oe", "q0", "w0", "db_seed", "score_frame", "score_landmark",
             "score", "noise", "conf")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    sys.path.insert(0, os.path.join(HERE, ".."))


def orbit(seed: int) -> dict:
    """One orbit of the evaluation, its entries without the suffix."""
    _jax()
    from torch_parity import jax_simulation
    from vinsat_tpu.estimation import ingest
    from vinsat_tpu.estimation.window import (StreamingConfig,
                                              prepare_stream, stream_orbit)
    from vinsat_tpu.evalx import ate, crlb

    t0 = time.time()
    J = jax_simulation(seed, duration_s=DURATION_S)
    det_rows, pos = J["det_rows"], J["pos_eci"]
    out = dict(
        oe=J["oe"], q0=J["q0"], w0=J["w0"], db_seed=np.array(J["db_seed"]),
        score_frame=J["score_frame"].astype(np.int32),
        score_landmark=J["score_landmark"].astype(np.int16),
        score=J["score"], noise=J["noise"], conf=J["conf"],
        n_rows=np.array(len(det_rows)),
        frames=det_rows[:, 0].astype(np.int32))
    errors, times = np.zeros(0), np.zeros(0, np.int64)
    nw, t5, trips = 0, np.nan, 0
    cb = {k: np.nan for k in CRLB_KEYS}
    if len(det_rows):
        cfg = StreamingConfig(dtype="float64")
        res = stream_orbit(det_rows, pos, seed=seed, cfg=cfg)
        if len(res.errors):
            errors = np.asarray(res.errors, np.float64)
            times = np.asarray(res.times)
            prep = prepare_stream(det_rows, pos, seed, cfg)
            nw = len(ingest.split_windows(prep.graph.ii, prep.knot_t))
            t = ate.time_to_threshold(errors, times, 5.0)
            t5 = np.nan if t is None else t
            trips = int(res.recovery_trips)
            cb = crlb.terminal_crlb_km(pos, det_rows)
    margin = np.array([np.abs(errors - thr).min() if len(errors) else np.inf
                       for thr in THRESHOLDS_KM])
    out.update(
        has_stream=np.array(len(errors) > 0), errors=errors, times=times,
        num_windows=np.array(nw), time_to_5km_s=np.array(float(t5)),
        final_error_km=np.array(float(errors[-1]) if len(errors)
                                else np.nan),
        recovery_trips=np.array(trips), margin_km=margin,
        **{k: np.array(cb[k]) for k in CRLB_KEYS})
    print(f"seed {seed}: {len(det_rows)} rows, {nw} windows, "
          f"time_to_5km_s {float(t5)}, final "
          f"{float(out['final_error_km']):.6f} km, margins "
          f"{np.round(margin, 4).tolist()} km ({time.time() - t0:.0f} s)",
          flush=True)
    return out


def _same(o: np.ndarray, v: np.ndarray) -> bool:
    if o.dtype.kind in "biuUSb":
        return np.array_equal(o, v)
    return o.shape == v.shape and np.allclose(o, v, rtol=0, atol=1e-9,
                                              equal_nan=True)


def _check_seed1(out: dict) -> None:
    """Seed 1 is the orbit of the sim and eval fixtures."""
    sim, ev = np.load(SIM_FIXTURE), np.load(EVAL_FIXTURE)
    bad = [k for k in DRAW_KEYS if not _same(sim[f"{k}_b"], out[f"{k}_1"])]
    bad += [k for k in ("errors", "times", "num_windows", "time_to_5km_s",
                        "final_error_km", "recovery_trips", *CRLB_KEYS)
            if not _same(ev[k], out[f"{k}_1"])]
    if bad or out["n_rows_1"] != len(sim["det_rows_b"]):
        raise RuntimeError(f"seed 1 is not the fixtures' orbit: {bad}")


def make(jobs: int = 1) -> dict:
    _jax()
    from vinsat_tpu.evalx import ate

    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
            orbits = list(pool.map(orbit, SEEDS))
    else:
        orbits = [orbit(s) for s in SEEDS]
    out = {"seeds": np.array(SEEDS), "duration_s": np.array(DURATION_S)}
    for s, o in zip(SEEDS, orbits):
        out.update({f"{k}_{s}": v for k, v in o.items()})
    streamed = [o for o in orbits if o["has_stream"]]
    summary = ate.summarize([o["errors"] for o in streamed],
                            [o["times"] for o in streamed])
    out["summary_keys"] = np.array(list(summary))
    out["summary"] = np.array(list(summary.values()), np.float64)
    _check_seed1(out)
    return out


def main() -> None:
    args = sys.argv[1:]
    jobs = int(args[args.index("--jobs") + 1]) if "--jobs" in args else 1
    t0 = time.time()
    ref = make(jobs)
    if "--check" in args:
        old = np.load(PATH)
        for k, v in ref.items():
            print(f"{k}: {'ok' if _same(old[k], v) else 'DIFFERS'}")
        missing = sorted(set(old.files) - set(ref))
        if missing:
            print(f"not made again: {missing}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes) in "
          f"{time.time() - t0:.0f} s; summary "
          + json.dumps(dict(zip(ref["summary_keys"].tolist(),
                                ref["summary"].tolist()))))


if __name__ == "__main__":
    main()
