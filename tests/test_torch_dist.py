"""The port's arc-sharded solve (vinsat_tpu_torch/dist) against the JAX
package's shard_map program on a 4-device virtual CPU mesh (f64).

The port lays the ("orbit", "arc") mesh out on one device, the arc shards
as a tensor dimension; the JAX program runs each shard on its own virtual
device.  Both perform the same per-shard arithmetic, so the bounds are
roundoff: the collectives are exact (they move or add values), the
distributed median 1e-12 relative (the same counts, log/exp of another
library), the SPIKE solve 1e-10 relative, one LM step 1e-9 relative in the
states (as the single-chip step in tests/test_torch_ba.py) and the λ
equal.  With use_pallas_assembly both assemble in f32 (the Pallas kernel in
interpret mode, the port's K2 twin), at tests/test_kernels.py's tolerance
for that path.  Each JAX result is computed once per module: a shard_map
compile costs seconds; JAX's steps of the four step cases and its SPIKE
solve are committed (tests/data/torch_jax_runs_seed1.npz).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_sharded_ba import INTR, _build_problem
from torch_parity import (jax_runs, random_states, rel_err,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu.dist import mesh as jmesh
from vinsat_tpu.dist import sharded_ba as jsba
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.kernels import normal_eq as jne
from vinsat_tpu_torch.dist import mesh, sharded_ba, tridiag
from vinsat_tpu_torch.estimation import ba, factors

N_ARC = 4
PARAMS = dict(num_hops=3, max_substep=100.0)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(n_orbit=1, n_arc=N_ARC)


def _jax_collective(jax_mesh, name, x):
    """The JAX primitive of `name` on x (P, ...) sharded over the arc axis,
    one shard per virtual device; returns the stacked per-shard results."""
    def body(xl):
        xs = xl[0]
        if name == "halo_from_right":
            out = jsba._halo_from_right(xs, "arc", N_ARC)
        elif name == "push_right":
            out = jsba._push_right(xs, "arc", N_ARC)
        elif name == "psum":
            out = jax.lax.psum(xs, "arc")
        elif name == "pmax":
            out = jax.lax.pmax(xs, "arc")
        else:
            out = jax.lax.all_gather(xs, "arc").reshape(-1)
        return out[None]

    fn = jax.shard_map(body, mesh=jax_mesh, in_specs=P("arc"),
                       out_specs=P("arc"), check_vma=False)
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["halo_from_right", "push_right", "psum",
                                  "pmax", "all_gather"])
def test_collectives_match_jax(jax_mesh, name):
    x = np.random.default_rng(0).normal(size=(N_ARC, 3))
    want = _jax_collective(jax_mesh, name, x)
    xt = torch.as_tensor(x)
    got = getattr(mesh, name)(xt, dim=0)
    if name == "all_gather":
        got = got.reshape(1, -1).expand(N_ARC, -1)
    got = got.expand(want.shape)  # psum / pmax keep a size-1 shard dim
    # exact but for psum, whose four terms may add in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    # the arc dimension elsewhere than first: (2, P, 3) along dim=-2
    x2 = torch.stack([xt, 2.0 * xt])
    got2 = getattr(mesh, name)(x2, dim=-2)
    np.testing.assert_array_equal(got2[0].numpy(),
                                  getattr(mesh, name)(xt, dim=0).numpy())


def test_shift_semantics():
    x = torch.arange(1.0, 5.0)  # shard i holds i + 1
    assert mesh.halo_from_right(x, dim=0).tolist() == [2.0, 3.0, 4.0, 0.0]
    assert mesh.push_right(x, dim=0).tolist() == [0.0, 1.0, 2.0, 3.0]
    assert mesh.halo_from_right(x[:1], dim=0).tolist() == [0.0]


def test_distributed_median_matches_jax(jax_mesh):
    rng = np.random.default_rng(1)
    Nl, D = 5, 4
    x = rng.normal(size=(N_ARC, Nl, D, 2)) * 3.0
    x[0, 0, 0] = 400.0  # a gross outlier
    ov = (rng.random((N_ARC, Nl, D)) < 0.8).astype(np.float64)

    def body(xl, ovl):
        return jsba._distributed_median_abs(xl[0], ovl[0][..., None] > 0,
                                            "arc")[None]

    fn = jax.shard_map(body, mesh=jax_mesh, in_specs=(P("arc"), P("arc")),
                       out_specs=P("arc"), check_vma=False)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(ov)))
    assert np.all(want == want[0])
    got = sharded_ba._distributed_median_abs(
        torch.as_tensor(x)[None], torch.as_tensor(ov)[None, ..., None] > 0)
    assert got.shape == (1,)
    assert abs(float(got[0]) - want[0]) <= 1e-12 * want[0]


def _tridiag_system(rng, N, k=9):
    A = rng.normal(size=(N, k, k)) * 0.1
    D = np.einsum("tij,tkj->tik", A, A) + np.eye(k) * 3.0
    U = rng.normal(size=(N, k, k)) * 0.3
    U[-1] = 0.0
    return D, U, rng.normal(size=(N, k))


def test_sharded_tridiag_matches_jax():
    D, U, b = _tridiag_system(np.random.default_rng(2), 20)
    # JAX's solve of this system on the 4-device mesh, committed
    # (tests/data/make_torch_jax_runs_fixture.py)
    want = jax_runs("dist").tridiag_want
    m = mesh.make_mesh(1, N_ARC, device="cpu")
    Dt, Ut, bt = (torch.as_tensor(a) for a in (D, U, b))
    got = tridiag.sharded_block_tridiag_solve(m, Dt, Ut, bt)
    assert got.shape == (20, 9)
    assert rel_err(got, want) < 1e-10
    # and the one-shard Thomas solve of the same system
    assert rel_err(got, ba.block_tridiag_solve(Dt, Ut[:-1], bt)) < 1e-10


def test_sharded_tridiag_batched_and_one_shard():
    rng = np.random.default_rng(3)
    systems = [_tridiag_system(rng, 12) for _ in range(3)]
    D, U, b = (torch.as_tensor(np.stack(s)) for s in zip(*systems))
    m4 = mesh.make_mesh(1, 4, device="cpu")
    got = tridiag.sharded_block_tridiag_solve(m4, D, U, b)
    one = tridiag.sharded_block_tridiag_solve(
        mesh.make_mesh(1, 1, device="cpu"), D, U, b)
    for i in range(3):
        want = ba.block_tridiag_solve(D[i], U[i, :-1], b[i])
        assert rel_err(got[i], want) < 1e-10
        assert rel_err(one[i], want) < 1e-10
    with pytest.raises(ValueError):
        tridiag.sharded_block_tridiag_solve(
            mesh.make_mesh(1, 5, device="cpu"), D, U, b)


def test_general_tridiag_solves_nonsymmetric():
    """_tridiag_general against a dense solve of the assembled system."""
    rng = np.random.default_rng(4)
    C, k = 5, 6
    Dr = rng.normal(size=(2, C, k, k)) + 4.0 * np.eye(k)
    Lr = rng.normal(size=(2, C, k, k))
    Ur = rng.normal(size=(2, C - 1, k, k))
    br = rng.normal(size=(2, C, k))
    dense = np.zeros((2, C * k, C * k))
    for c in range(C):
        dense[:, c * k:(c + 1) * k, c * k:(c + 1) * k] = Dr[:, c]
        if c > 0:
            dense[:, c * k:(c + 1) * k, (c - 1) * k:c * k] = Lr[:, c]
        if c < C - 1:
            dense[:, c * k:(c + 1) * k, (c + 1) * k:(c + 2) * k] = Ur[:, c]
    want = np.linalg.solve(dense, br.reshape(2, -1, 1))[..., 0]
    got = ba._tridiag_general(*(torch.as_tensor(a)
                                for a in (Dr, Ur, Lr, br)))
    assert rel_err(got.reshape(2, -1), want) < 1e-10


def _problem_fields(rng, n_real=16, n_knots=16, D=4, batch=1):
    """tests/test_sharded_ba.py's problem (n_real knots along an orbit,
    D observations each), padded to n_knots the way
    long_arc.build_sharded_problem pads, as the JAX ShardedProblem's
    numpy fields (B=batch copies)."""
    st, gaps, cum, lm, uv, conf, _, _ = _build_problem(rng, n_real, D)
    pad = n_knots - n_real
    fields = dict(
        states=np.concatenate([np.asarray(st), np.tile(
            [0, 0, 0, 0, 0, 0, 1.0, 0, 0, 0], (pad, 1))]),
        gaps=np.concatenate([np.asarray(gaps), np.zeros(pad)]),
        cum_rot=np.concatenate([np.asarray(cum),
                                np.tile([0, 0, 0, 1.0], (pad, 1))]),
        lm_xyz=np.concatenate([lm, np.zeros((pad, D, 3))]),
        uv=np.concatenate([np.asarray(uv).reshape(n_real, D, 2),
                           np.zeros((pad, D, 2))]),
        conf=np.concatenate([np.asarray(conf).reshape(n_real, D),
                             np.zeros((pad, D))]),
        obs_valid=np.concatenate([np.ones((n_real, D)), np.zeros((pad, D))]),
        pair_valid=np.concatenate([np.ones(n_real - 1), np.zeros(pad + 1)]),
    )
    fields = {k: np.stack([v] * batch) for k, v in fields.items()}
    fields["intrinsics"] = np.asarray(INTR)
    return fields


# (sched_iter, initialize, real knots of the 16): the α = 2 first step,
# the Barron weights at α = 1.4 with the median scale, the vision-only
# init, and a padded problem whose last shard ends in two padding knots
STEP_CASES = [(0, 0.0, 16), (3, 0.0, 16), (0, 1.0, 16), (3, 0.0, 14)]


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's sharded step on each case's problem, committed with the
    problem's fields (tests/data/make_torch_jax_runs_fixture.py: a
    shard_map compile costs a minute)."""
    j = vars(jax_runs("dist"))
    out = {}
    for c, case in enumerate(STEP_CASES):
        assert list(j[f"step{c}_case"]) == list(case)
        head = f"step{c}_field_"
        fields = {k[len(head):]: v for k, v in j.items()
                  if k.startswith(head)}
        out[case] = (fields, j[f"step{c}_st"], j[f"step{c}_lam"])
    return out


def _port_step(fields, it, init, n_arc=N_ARC, **kw):
    m = mesh.make_mesh(1, n_arc, device="cpu")
    prob = sharded_ba.sharded_problem_from_numpy(fields, n_arc, "cpu")
    step = sharded_ba.make_sharded_ba_step(m, ba.SolverParams(**PARAMS),
                                           **kw)
    B = prob.states.shape[0]
    st, lam = step(it, torch.full((B,), 1e-4, dtype=torch.float64), prob,
                   initialize=init)
    return st.reshape(B, -1, 10), lam


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_jax(jax_steps, case):
    fields, want_st, want_lam = jax_steps[case]
    st, lam = _port_step(fields, case[0], case[1])
    assert st.shape == want_st.shape
    assert np.isfinite(st.numpy()).all()
    assert rel_err(st, want_st) < 1e-9
    assert float(lam[0]) == float(want_lam[0])


def test_sharded_step_pallas_assembly_matches_jax(jax_mesh):
    """use_pallas_assembly: the JAX kernel in interpret mode and K2's twin
    both assemble in f32."""
    fields = _problem_fields(np.random.default_rng(0))
    prob = jsba.ShardedProblem(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    orig = jne.assemble_normal_eq
    jne.assemble_normal_eq = functools.partial(orig, interpret=True)
    try:
        step = jsba.make_sharded_ba_step(
            jax_mesh, jba.SolverParams(**PARAMS), use_pallas_assembly=True)
        want, _ = step(jnp.asarray(0), jnp.full((1,), 1e-4), prob)
    finally:
        jne.assemble_normal_eq = orig
    got, _ = _port_step(fields, 0, 0.0, use_pallas_assembly=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=5e-4)
    exact, _ = _port_step(fields, 0, 0.0)
    assert not torch.equal(got, exact)  # the f32 sums did run


def test_sharded_step_batch_independent():
    """Two identical orbits in the batch get identical updates, equal to
    the one-orbit step's."""
    fields = _problem_fields(np.random.default_rng(5), batch=2)
    st, lam = _port_step(fields, 3, 0.0)
    assert torch.equal(st[0], st[1]) and float(lam[0]) == float(lam[1])
    one = {k: (v if k == "intrinsics" else v[:1]) for k, v in fields.items()}
    st1, lam1 = _port_step(one, 3, 0.0)
    assert rel_err(st[:1], st1) < 1e-12


def test_sharded_step_one_shard_matches_single_chip():
    """At α = 2 the robust scale cancels, so one arc shard reproduces the
    single-chip ba_iteration (batched λ, Thomas solve)."""
    fields = _problem_fields(np.random.default_rng(6))
    st, lam = _port_step(fields, 0, 0.0, n_arc=1)
    D = 4
    prob = ba.problem_from_numpy(dict(
        gaps=fields["gaps"][0], cum_rot=fields["cum_rot"][0],
        landmarks_xyz=fields["lm_xyz"][0].reshape(-1, 3),
        landmarks_uv=fields["uv"][0].reshape(-1, 2),
        conf=fields["conf"][0].reshape(-1),
        ii=np.repeat(np.arange(16), D),
        obs_valid=fields["obs_valid"][0].reshape(-1),
        knot_valid=np.ones(16), pair_valid=fields["pair_valid"][0][:-1],
        intrinsics=fields["intrinsics"]), "cpu")
    ref = ba.ba_iteration(0, torch.as_tensor(fields["states"][0]), prob,
                          1e-4, params=ba.SolverParams(
                              batched_lambda=9, tridiag_variant="thomas",
                              **PARAMS))
    assert rel_err(st[0], ref.states) < 1e-9
    assert float(lam[0]) == float(ref.lamda_init)


def test_sharded_step_rejects_prior_and_wrong_mesh():
    # the prior is ported (tests/test_torch_dist_stream.py holds it to
    # JAX); one laid out over another number of shards is refused
    fields = _problem_fields(np.random.default_rng(7))
    prob = sharded_ba.sharded_problem_from_numpy(fields, N_ARC, "cpu")
    B, P, Nl = prob.gaps.shape
    z = torch.zeros
    with pytest.raises(ValueError):
        sharded_ba._one_orbit_iteration(
            0, torch.full((1,), 1e-4, dtype=torch.float64), prob,
            ba.SolverParams(**PARAMS), prior=sharded_ba.ShardedPrior(
                z(B, 1, P * Nl, 10), z(B, 1, P * Nl, 6, 6),
                z(B, 1, P * Nl, 3, 3), z(B, 1, P * Nl)))
    step = sharded_ba.make_sharded_ba_step(mesh.make_mesh(1, 2, "cpu"))
    with pytest.raises(ValueError):
        step(0, torch.full((1,), 1e-4, dtype=torch.float64), prob)


def test_dynamics_factor_batched_matches_unbatched():
    """The Jacobian path over leading (B, P) dims equals one call per
    item."""
    rng = np.random.default_rng(8)
    N = 6
    states = torch.as_tensor(np.stack([random_states(rng, N)
                                       for _ in range(6)]).reshape(2, 3, N, 10))
    gaps = torch.as_tensor(rng.uniform(20.0, 250.0, size=(2, 3, N)))
    cum = torch.as_tensor(np.stack([random_states(rng, N)[:, 3:7]
                                    for _ in range(6)]).reshape(2, 3, N, 4))
    pv = torch.as_tensor((rng.random((2, 3, N - 1)) < 0.8).astype(float))
    got = factors.dynamics_factor(states, gaps, cum, 100.0, 100.0,
                                  valid_pair=pv, num_hops=3)
    for b in range(2):
        for p in range(3):
            want = factors.dynamics_factor(
                states[b, p], gaps[b, p], cum[b, p], 100.0, 100.0,
                valid_pair=pv[b, p], num_hops=3)
            for name, g, w in zip(want._fields, got, want):
                assert rel_err(g[b, p], w) < 1e-13, name


def test_sharded_problem_from_numpy_layout():
    fields = _problem_fields(np.random.default_rng(9), batch=2)
    fields["knot_valid"] = None
    prob = sharded_ba.sharded_problem_from_numpy(fields, N_ARC, "cpu")
    assert prob.states.shape == (2, N_ARC, 4, 10)
    assert prob.lm_xyz.shape == (2, N_ARC, 4, 4, 3)
    assert prob.intrinsics.shape == (4,) and prob.knot_valid is None
    np.testing.assert_array_equal(prob.uv[1, 2, 3].numpy(),
                                  fields["uv"][1, 11])
    with pytest.raises(ValueError):
        sharded_ba.sharded_problem_from_numpy(fields, 3, "cpu")
