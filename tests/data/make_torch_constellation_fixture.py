"""Regenerate tests/data/torch_constellation.npz: BASELINE config 4 (the
8-orbit constellation solve) as the JAX package computes it, for the
PyTorch port to be held to on the card.

Runs the JAX package on the CPU in float64 and stores:

  * per orbit seed s in 0-7 (suffix _s), the draws of
    `simulate_sequence(s, 3600, along_track=True, frame_stride=5)` (the
    sequences `run_constellation` solves): `oe`, `q0`, `w0`, the track
    DB's int seed `db_seed`, the selection score of every in-view pair of
    a gated frame with its frame and landmark, the pixel noise and
    confidence draws of the valid slots (laid out as in
    torch_sim_seed1.npz), and its `det_rows`;
  * `run_constellation(list(range(8)), 3600, num_iters=20)` (10
    vision-only iterations): the orbits kept (`valid_seeds`), the common
    padding `n_pad` / `m_pad`, `median_errors_km`, and the batched solve's
    final states `out_b` (B, n_pad, 10);
  * `states_iter1` (B, n_pad, 10): the same padded problems solved with
    `num_iters=1`;
  * `median_errors_km_thomas`: the same run with the plain Thomas
    block-tridiagonal solve in place of "auto" (in f64 at 64 <= N < 1024
    the JAX package's "auto" takes its block cyclic reduction `bcr16`, the
    port K1's PCR): how far the choice of exact elimination moves the
    result.

The scores are stored in float32, which keeps their order within every
frame (checked here), and the order alone chooses the detections.

The machine that runs the port on a GPU has no JAX, so this file is how
the port meets JAX's sequences and results there.  About 95 s on the CPU
with a peak of 2.5 GB resident; the file is 3.9 MB.

    python tests/data/make_torch_constellation_fixture.py [--check]

--check recomputes everything and compares it with the committed file
instead of overwriting it.
"""
from __future__ import annotations

import json
import os
import resource
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, os.path.join(HERE, ".."))

from torch_parity import jax_simulation  # noqa: E402

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.estimation import window  # noqa: E402

SEEDS = list(range(8))
SIM_KW = dict(duration_s=3600, along_track=True, frame_stride=5)
NUM_ITERS, INIT_ITERS = 20, 10
PATH = os.path.join(HERE, "torch_constellation.npz")


def _score_f32(score, frame):
    """The selection scores in float32 (half the file): only their order
    within a frame chooses the detections, and this checks that rounding
    keeps every frame's order."""
    s32 = score.astype(np.float32)
    for f in np.unique(frame):
        m = frame == f
        if not np.array_equal(np.argsort(-score[m], kind="stable"),
                              np.argsort(-s32[m], kind="stable")):
            raise RuntimeError(f"float32 scores reorder frame {f}")
    return s32


def _run_constellation(variant=None):
    """JAX's run_constellation(SEEDS, 3600, num_iters=20), with its
    solve_window_batch call recorded (the batch stays inside it) and, with
    `variant`, run with that block-tridiagonal solve in place of "auto":
    (its result, {"args", "params", "sched_offset", "out"})."""
    real = window.solve_window_batch
    rec = {}

    def recording(states_b, prob_b, lamda_b, init_iters, num_iters,
                  params=None, sched_offset=0):
        if variant is not None:
            params = params._replace(tridiag_variant=variant)
        got = real(states_b, prob_b, lamda_b, init_iters, num_iters, params,
                   sched_offset=sched_offset)
        rec.update(args=(states_b, prob_b, lamda_b, init_iters), params=params,
                   sched_offset=sched_offset, out=got)
        return got

    window.solve_window_batch = recording
    try:
        res = pipeline.run_constellation(SEEDS, SIM_KW["duration_s"],
                                         num_iters=NUM_ITERS,
                                         init_iters=INIT_ITERS)
    finally:
        window.solve_window_batch = real
    return res, rec


def make() -> dict:
    out = dict(seeds=np.array(SEEDS), sim_kwargs=np.array(json.dumps(SIM_KW)),
               num_iters=np.array(NUM_ITERS), init_iters=np.array(INIT_ITERS))
    for s in SEEDS:
        J = jax_simulation(s, **SIM_KW)
        out.update({f"{k}_{s}": v for k, v in dict(
            oe=J["oe"], q0=J["q0"], w0=J["w0"],
            db_seed=np.array(J["db_seed"]),
            score_frame=J["score_frame"].astype(np.int32),
            score_landmark=J["score_landmark"].astype(np.int16),
            score=_score_f32(J["score"], J["score_frame"]),
            noise=J["noise"], conf=J["conf"],
            det_rows=J["det_rows"]).items()})

    res, rec = _run_constellation()
    it1 = window.solve_window_batch(*rec["args"], 1, rec["params"],
                                    sched_offset=rec["sched_offset"])
    res_t, _ = _run_constellation("thomas")
    states_b = rec["args"][0]
    out.update(
        valid_seeds=np.array(res["orbit_seeds"]),
        n_pad=np.array(states_b.shape[1]),
        m_pad=np.array(rec["args"][1].ii.shape[1]),
        median_errors_km=np.array(res["median_errors_km"]),
        out_b=np.asarray(rec["out"][0], np.float64),
        states_iter1=np.asarray(it1[0], np.float64),
        median_errors_km_thomas=np.array(res_t["median_errors_km"]))
    return out


def main() -> None:
    t0 = time.time()
    ref = make()
    if "--check" in sys.argv[1:]:
        old = np.load(PATH)
        for k, v in ref.items():
            o = old[k]
            same = (np.array_equal(o, v) if o.dtype.kind in "biuUS"
                    else np.allclose(o, v, rtol=0, atol=1e-9))
            print(f"{k}: {'ok' if same else 'DIFFERS'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes) in "
          f"{time.time() - t0:.0f} s, peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10} MiB: "
          f"orbits {ref['valid_seeds'].tolist()}, n_pad {int(ref['n_pad'])}, "
          f"m_pad {int(ref['m_pad'])}, rows "
          + ", ".join(str(len(ref[f"det_rows_{s}"])) for s in SEEDS)
          + "; median errors "
          + ", ".join(f"{e:.6f}" for e in ref["median_errors_km"])
          + " km (Thomas: "
          + ", ".join(f"{e:.6f}" for e in ref["median_errors_km_thomas"])
          + " km)")

if __name__ == "__main__":
    main()
