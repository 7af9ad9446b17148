"""The port's long-arc arc-sharded solve (BASELINE config 5(a)) against the
JAX package's on the same simulated sequence, at a small size: a 900 s
along-track arc (91 frames at stride 10), 4 arc shards, 6 LM iterations of
which 3 are vision-only, f64 on the CPU.

The initial states are equal to 1e-12 relative (the same numpy draws; quat
log / exp of another library).  The final per-knot errors agree within
1e-6 km: six iterations of the same arithmetic, roundoff apart.  JAX's
simulation, problems and solve are committed
(tests/data/torch_jax_runs_seed1.npz; its shard_map compiles took the
most of this module's time).
"""
import types

import numpy as np
import pytest
import torch

from torch_parity import jax_runs, rel_err, torch_one_thread  # noqa: F401
from vinsat_tpu_torch.dist import long_arc, mesh
from vinsat_tpu_torch.kernels import normal_eq

N_ARC = 4
PROBLEM_KW = dict(noise_pos_km=20.0)
SOLVE_KW = dict(num_iters=6, init_iters=3)


def _fields(j, prefix):
    return types.SimpleNamespace(**{
        k[len(prefix):]: v for k, v in vars(j).items()
        if k.startswith(prefix)})


@pytest.fixture(scope="module")
def runs():
    # JAX's arc, its problems (f64 and the default f32) and its solve are
    # committed (tests/data/make_torch_jax_runs_fixture.py, "longarc")
    j = jax_runs("longarc")
    jprob, jprob32 = _fields(j, "prob_"), _fields(j, "prob32_")
    jgt, jkt, jn = j.gt, j.knot_t, int(j.n_real)
    jres = _fields(j, "res_")
    inputs = (j.det_rows, j.orbit_pos_eci_km)
    prob, gt, kt, n = long_arc.build_sharded_problem(
        inputs, n_arc=N_ARC, dtype=torch.float64, device="cpu",
        **PROBLEM_KW)
    before = normal_eq.assemble_normal_eq.launches
    res = long_arc.solve_long_arc(mesh.make_mesh(1, N_ARC, device="cpu"),
                                  prob, gt, kt, n, **SOLVE_KW)
    launches = normal_eq.assemble_normal_eq.launches - before
    return dict(jprob=jprob, jgt=jgt, jkt=jkt, jn=jn, jres=jres, prob=prob,
                gt=gt, kt=kt, n=n, res=res, launches=launches, jprob32=jprob32,
                inputs=inputs)


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


def test_default_dtype_is_jax(runs):
    """Without `dtype` both packages build the problem in float32 (the
    JAX package's default) from float64 conditioning; the states carry
    the same initial noise."""
    jprob = runs["jprob32"]
    prob = long_arc.build_sharded_problem(runs["inputs"], n_arc=N_ARC,
                                          device="cpu", **PROBLEM_KW)[0]
    for name in ("states", "gaps", "cum_rot", "lm_xyz", "uv", "conf"):
        got, want = getattr(prob, name), getattr(jprob, name)
        assert str(got.dtype) == f"torch.{want.dtype}" == "torch.float32", \
            name
    B, N = jprob.gaps.shape
    assert rel_err(prob.states.reshape(B, N, 10).double(),
                   np.asarray(jprob.states, np.float64)) < 1e-6
