"""Regenerate tests/data/torch_stream_seed1.npz: the PyTorch port's
end-to-end fixture.

Runs the JAX package on the CPU in float64 over bench.py's headline
sequence (seed 1, one gapped 10800 s along-track arc) and stores the
inputs the port consumes (detection rows + 1 Hz ground-truth orbit) beside
the JAX result the port is held against, plus the JAX tail refinement
(`refine_terminal`, rigid chain) of the stream's final states over the
whole arc — the bench arc ends on a detection knot, so the stream itself
never runs it.  The machine that runs the port on a GPU has no JAX, so the
fixture is the only way the port sees these inputs and this reference
there.

    python tests/data/make_torch_stream_fixture.py [--check]

--check recomputes the reference and compares it with the committed file
instead of overwriting it.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.estimation import ingest, refine  # noqa: E402
from vinsat_tpu.estimation.window import (StreamingConfig,  # noqa: E402
                                          prepare_stream)
from vinsat_tpu.evalx import ate  # noqa: E402

SEED = 1
SIM_KW = dict(duration_s=10800, along_track=True, frame_stride=5,
              pass_every_s=1800, pass_len_s=300)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_stream_seed1.npz")


def make() -> dict:
    seq = pipeline.simulate_sequence(SEED, **SIM_KW)
    res = pipeline.run_streaming(seq, seed=SEED,
                                 cfg=StreamingConfig(dtype="float64"))
    # the windows the stream solves: split on the GATED graph
    cfg = StreamingConfig(dtype="float64")
    prep = prepare_stream(seq.det_rows, seq.orbit_pos_eci_km, SEED, cfg)
    windows = ingest.split_windows(prep.graph.ii, prep.knot_t)
    N = len(res.final_states)
    refined = refine.refine_terminal(
        res.final_states, prep.gaps[:N], prep.gt.landmarks_xyz,
        prep.graph.uv, prep.graph.conf, prep.graph.ii, prep.intr_np,
        "float64", cum_rot=prep.cum_rot[:N])
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    return dict(
        det_rows=np.asarray(seq.det_rows, np.float64),
        orbit_pos_eci_km=np.asarray(seq.orbit_pos_eci_km, np.float64),
        seed=np.array(SEED),
        sim_kwargs=np.array(json.dumps(SIM_KW)),
        errors=np.asarray(res.errors, np.float64),
        times=np.asarray(res.times),
        final_states=np.asarray(res.final_states, np.float64),
        knot_times=np.asarray(res.knot_times),
        num_windows=np.array(len(windows)),
        time_to_5km_s=np.array(np.nan if t5 is None else t5),
        final_error_km=np.array(float(res.errors[-1])),
        refined_states=np.asarray(refined, np.float64),
    )


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
    print(f"wrote {PATH}: {len(ref['det_rows'])} rows, "
          f"{int(ref['num_windows'])} windows, "
          f"time_to_5km_s={float(ref['time_to_5km_s'])}, "
          f"final_error_km={float(ref['final_error_km']):.4f}")


if __name__ == "__main__":
    main()
