"""The port's long-arc arc-sharded solve (BASELINE config 5(a)) against the
JAX package's on the same simulated sequence, at a small size: a 900 s
along-track arc (91 frames at stride 10), 4 arc shards, 6 LM iterations of
which 3 are vision-only, f64 on the CPU.

The initial states are equal to 1e-12 relative (the same numpy draws; quat
log / exp of another library).  The final per-knot errors agree within
1e-6 km: six iterations of the same arithmetic, roundoff apart.  The JAX
run is made once per module (its shard_map compiles take seconds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import rel_err
from vinsat_tpu import pipeline as jpipeline
from vinsat_tpu.dist import long_arc as jla
from vinsat_tpu.dist import mesh as jmesh
from vinsat_tpu_torch.dist import long_arc, mesh
from vinsat_tpu_torch.kernels import normal_eq

N_ARC = 4
PROBLEM_KW = dict(noise_pos_km=20.0)
SOLVE_KW = dict(num_iters=6, init_iters=3)


@pytest.fixture(scope="module")
def runs():
    seq = jpipeline.simulate_sequence(1, duration_s=900, frame_stride=10,
                                      along_track=True)
    jprob, jgt, jkt, jn = jla.build_sharded_problem(
        seq, n_arc=N_ARC, dtype=jnp.float64, **PROBLEM_KW)
    jres = jla.solve_long_arc(jmesh.make_mesh(n_orbit=1, n_arc=N_ARC), jprob,
                              jgt, jkt, jn, **SOLVE_KW)
    inputs = (np.asarray(seq.det_rows), np.asarray(seq.orbit_pos_eci_km))
    prob, gt, kt, n = long_arc.build_sharded_problem(
        inputs, n_arc=N_ARC, device="cpu", **PROBLEM_KW)
    before = normal_eq.assemble_normal_eq.launches
    res = long_arc.solve_long_arc(mesh.make_mesh(1, N_ARC, device="cpu"),
                                  prob, gt, kt, n, **SOLVE_KW)
    launches = normal_eq.assemble_normal_eq.launches - before
    return dict(jprob=jprob, jgt=jgt, jkt=jkt, jn=jn, jres=jres, prob=prob,
                gt=gt, kt=kt, n=n, res=res, launches=launches)


def test_problem_matches_jax(runs):
    jprob, prob = runs["jprob"], runs["prob"]
    assert runs["n"] == runs["jn"] > 16
    np.testing.assert_array_equal(runs["kt"], runs["jkt"])
    np.testing.assert_allclose(runs["gt"], runs["jgt"], rtol=1e-12, atol=0)
    B, N = jprob.gaps.shape
    assert prob.states.shape == (B, N_ARC, N // N_ARC, 10)
    assert rel_err(prob.states.reshape(B, N, 10), jprob.states) < 1e-12
    for name in ("gaps", "cum_rot", "lm_xyz", "uv", "conf", "obs_valid",
                 "pair_valid"):
        got = getattr(prob, name)
        want = np.asarray(getattr(jprob, name))
        assert rel_err(got.reshape(want.shape), want) < 1e-12, name


def test_final_errors_match_jax(runs):
    res, jres = runs["res"], runs["jres"]
    assert res.states.shape == jres.states.shape
    assert np.isfinite(res.states).all()
    np.testing.assert_array_equal(res.knot_times, jres.knot_times)
    assert np.abs(res.errors_km - jres.errors_km).max() < 1e-6
    assert np.median(res.errors_km) < 5.0


def test_cpu_run_uses_k2_twin(runs):
    """On the CPU the sharded step assembles through K2's plain twin: no
    kernel launch."""
    assert runs["launches"] == 0
    assert runs["prob"].states.device == torch.device("cpu")
