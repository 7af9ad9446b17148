"""Regenerate tests/data/torch_longarc_seed1.npz: the PyTorch port's
fixture of the arc-sharded long-arc solve (BASELINE config 5(a)).

Runs the JAX package on the CPU in float64, on a virtual mesh of 8 CPU
devices, over configs/run_configs.py's config 5(a) at --duration 10800:
`simulate_sequence(1, duration_s=10800, frame_stride=5, along_track=True)`,
`build_sharded_problem(n_arc=8, noise_pos_km=50.0)` and `solve_long_arc`
with 20 iterations (8 vision-only).  It stores the sequence the port
consumes (detection rows + 1 Hz ground-truth orbit) beside JAX's initial
noised states, its states after the first iteration and after the
twentieth, and its per-knot errors.  The machine that runs the port on a
GPU has no JAX, so the fixture is how the port is held to JAX there.

    python tests/data/make_torch_longarc_fixture.py [--check]

--check recomputes the reference and compares it with the committed file
instead of overwriting it.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from vinsat_tpu import pipeline  # noqa: E402
from vinsat_tpu.dist import long_arc, mesh as mesh_mod  # noqa: E402

SEED = 1
N_ARC = 8
SIM_KW = dict(duration_s=10800, frame_stride=5, along_track=True)
PROBLEM_KW = dict(noise_pos_km=50.0)
SOLVE_KW = dict(num_iters=20, init_iters=8)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_longarc_seed1.npz")


def make() -> dict:
    seq = pipeline.simulate_sequence(SEED, **SIM_KW)
    mesh = mesh_mod.make_mesh(n_orbit=1, n_arc=N_ARC)
    prob, gt_states, knot_t, n_real = long_arc.build_sharded_problem(
        seq, n_arc=N_ARC, dtype=jnp.float64, **PROBLEM_KW)
    res1 = long_arc.solve_long_arc(mesh, prob, gt_states, knot_t, n_real,
                                   num_iters=1,
                                   init_iters=SOLVE_KW["init_iters"])
    res = long_arc.solve_long_arc(mesh, prob, gt_states, knot_t, n_real,
                                  **SOLVE_KW)
    return dict(
        det_rows=np.asarray(seq.det_rows, np.float64),
        orbit_pos_eci_km=np.asarray(seq.orbit_pos_eci_km, np.float64),
        seed=np.array(SEED),
        n_arc=np.array(N_ARC),
        sim_kwargs=np.array(json.dumps(SIM_KW)),
        problem_kwargs=np.array(json.dumps(PROBLEM_KW)),
        solve_kwargs=np.array(json.dumps(SOLVE_KW)),
        n_real=np.array(n_real),
        knot_times=np.asarray(knot_t),
        states0=np.asarray(prob.states[0], np.float64),
        states_iter1=np.asarray(res1.states, np.float64),
        states_final=np.asarray(res.states, np.float64),
        errors_km=np.asarray(res.errors_km, np.float64),
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
    e = ref["errors_km"]
    print(f"wrote {PATH}: {len(ref['det_rows'])} rows, "
          f"{len(ref['states0'])} knots ({int(ref['n_real'])} real), "
          f"median error {np.median(e):.4f} km, max {e.max():.4f} km")


if __name__ == "__main__":
    main()
