"""Regenerate tests/data/torch_sim_seed1.npz: the draws and outputs of the
JAX detection simulator that the PyTorch port is held to on the card.

Runs the JAX package's `simulate_sequence` on the CPU in float64 at full
size, in its two modes, and stores what the port needs to replay it:

  mode a — bench.py's arc: seed 1, 10800 s along-track, frame_stride 5,
           a 300 s region pass every 1800 s (124 track landmarks);
  mode b — an orbit of the synthetic full eval: seed 1, 10800 s,
           frame_stride 1, the 7920-landmark synthesized DB.

Per mode (suffix _a / _b): JAX's draws (`oe`, `q0`, `w0`, the DB's int
seed `db_seed`, the selection score of every in-view pair of a gated frame
with its frame and landmark, the pixel noise and confidence draws of the
valid slots), and its outputs (`frame_visible`, the per-frame visibility
count `count`, `det_rows`, and `pos_eci` every POS_STRIDE seconds).  The
machine that runs the port on a GPU has no JAX, so this file is how the
port meets JAX's draws and results there.

    python tests/data/make_torch_sim_fixture.py [--check]

--check recomputes everything and compares it with the committed file
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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, os.path.join(HERE, ".."))

from torch_parity import jax_simulation  # noqa: E402

SEED = 1
MODES = {
    "a": dict(duration_s=10800, along_track=True, frame_stride=5,
              pass_every_s=1800, pass_len_s=300),
    "b": dict(duration_s=10800),
}
POS_STRIDE = 100
PATH = os.path.join(HERE, "torch_sim_seed1.npz")


def make() -> dict:
    out = {"seed": np.array(SEED)}
    for mode, kw in MODES.items():
        J = jax_simulation(SEED, **kw)
        out.update({f"{k}_{mode}": v for k, v in dict(
            sim_kwargs=np.array(json.dumps(kw)),
            oe=J["oe"], q0=J["q0"], w0=J["w0"],
            db_seed=np.array(J["db_seed"]),
            score_frame=J["score_frame"].astype(np.int32),
            score_landmark=J["score_landmark"].astype(np.int16),
            score=J["score"], noise=J["noise"], conf=J["conf"],
            frame_visible=J["frame_visible"],
            count=J["count"].astype(np.int16),
            det_rows=J["det_rows"],
            pos_eci=J["pos_eci"][::POS_STRIDE]).items()})
    return out


def main() -> None:
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
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes): "
          + ", ".join(f"mode {m}: {len(ref[f'det_rows_{m}'])} rows, "
                      f"{int(ref[f'frame_visible_{m}'].sum())} visible "
                      f"frames, {len(ref[f'score_{m}'])} scored pairs"
                      for m in MODES))


if __name__ == "__main__":
    main()
