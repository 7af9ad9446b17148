"""Regenerate tests/data/torch_eval_seed1.npz: the JAX package's result on
one orbit of the synthetic evaluation, for the PyTorch port to be held to
on the card.

The orbit is the mode-b sequence of tests/data/torch_sim_seed1.npz (seed 1,
10800 s, frame_stride 1, the 7920-landmark synthesized DB): its committed
`det_rows_b` and the JAX trajectory of seed 1, which this script rolls out
again (the trajectory's key split of `simulate_sequence`; checked against
the fixture's `pos_eci_b`).  The JAX package streams it on the CPU in
float64 (`run_streaming`, default StreamingConfig) and computes its
terminal information bound (`evalx.crlb.terminal_crlb_km`); stored are
the stream's `errors`, `times`, window count, `time_to_5km_s`,
`final_error_km` and `recovery_trips`, and the bound's fields
(`crlb_final_km`, `crlb_last_knot_km`, `crlb_att_final_km`, `n_obs`,
`obs_span_s`).  About 50 s on the CPU; the file is 8 kB.

    python tests/data/make_torch_eval_fixture.py [--check]

--check recomputes everything and compares it with the committed file
instead of overwriting it.
"""
from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.estimation import ingest  # noqa: E402
from vinsat_tpu.estimation.window import (StreamingConfig,  # noqa: E402
                                          prepare_stream)
from vinsat_tpu.evalx import ate, crlb  # noqa: E402
from vinsat_tpu.sim import orbits  # noqa: E402

SIM_FIXTURE = os.path.join(HERE, "torch_sim_seed1.npz")
PATH = os.path.join(HERE, "torch_eval_seed1.npz")
CRLB_KEYS = ("crlb_final_km", "crlb_last_knot_km", "crlb_att_final_km",
             "n_obs", "obs_span_s")


def make() -> dict:
    sim = np.load(SIM_FIXTURE)
    seed = int(sim["seed"])
    kw = json.loads(str(sim["sim_kwargs_b"]))
    k_traj = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    traj = orbits.generate_trajectory(k_traj, duration_s=kw["duration_s"])
    orbit = np.asarray(traj.pos_eci, np.float64)
    if not np.allclose(orbit[::100], sim["pos_eci_b"], rtol=0, atol=1e-9):
        raise RuntimeError("the rolled-out orbit is not the fixture's")
    det_rows = np.asarray(sim["det_rows_b"], np.float64)
    cfg = StreamingConfig(dtype="float64")
    res = pipeline.run_streaming(
        pipeline.SimulatedSequence(det_rows, orbit, traj, None), seed=seed,
        cfg=cfg)
    prep = prepare_stream(det_rows, orbit, seed, cfg)
    windows = ingest.split_windows(prep.graph.ii, prep.knot_t)
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    cb = crlb.terminal_crlb_km(orbit, det_rows)
    return dict(
        seed=np.array(seed),
        errors=np.asarray(res.errors, np.float64),
        times=np.asarray(res.times),
        num_windows=np.array(len(windows)),
        time_to_5km_s=np.array(np.nan if t5 is None else t5),
        final_error_km=np.array(float(res.errors[-1])),
        recovery_trips=np.array(int(res.recovery_trips)),
        **{k: np.array(cb[k]) for k in CRLB_KEYS})


def main() -> None:
    t0 = time.time()
    ref = make()
    if "--check" in sys.argv[1:]:
        old = np.load(PATH)
        for k, v in ref.items():
            o = old[k]
            same = (np.array_equal(o, v) if o.dtype.kind in "biuUS"
                    else np.allclose(o, v, rtol=0, atol=1e-9,
                                     equal_nan=True))
            print(f"{k}: {'ok' if same else 'DIFFERS'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes) in "
          f"{time.time() - t0:.0f} s: {int(ref['num_windows'])} windows, "
          f"time_to_5km_s {float(ref['time_to_5km_s'])}, final_error_km "
          f"{float(ref['final_error_km']):.6f}, crlb_final_km "
          f"{float(ref['crlb_final_km']):.6f}, crlb_att_final_km "
          f"{float(ref['crlb_att_final_km']):.6f}")


if __name__ == "__main__":
    main()
