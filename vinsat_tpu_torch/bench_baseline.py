"""Pure-numpy baseline of one BA LM iteration, mirroring the reference's
computational pattern (port of vinsat_tpu/bench_baseline.py, copied: the
JAX module cannot be imported without JAX).

Replicates the cost structure of BA_filtering.BA (BA_filtering.py:4-98) as
the reference executes it on CPU: per-step 1 Hz RK4 propagation loops over
the max knot gap (BA_utils.py:73-87), numerical Jacobians of the rollout via
column-wise redifferencing (standing in for torch's vectorized autograd of
the whole rollout, BA_utils.py:506), dense (9N)x(9N) assembly and
numpy.linalg.solve (BA_filtering.py:54-55).

It stays numpy on the host on purpose: it is the yardstick a benchmark's
`vs_baseline` divides by (the reference's per-iteration CPU cost at the
same problem size), so moving it to the card would change what is
measured.  Nothing of the port calls it.
"""
from __future__ import annotations

import numpy as np

MU = 398600.4418
J2C = 1.75553e10
RMAT = np.array([[6.0, -1.5, -1.5], [6.0, -1.5, -1.5], [3.0, -4.5, -4.5]])


def _dyn(x):
    r, v = x[..., :3], x[..., 3:6]
    rn = np.linalg.norm(r, axis=-1, keepdims=True)
    j2 = (RMAT * (r[..., None, :] ** 2)).sum(-1)
    a = -(MU / rn**3) * r + (J2C / rn**7) * j2 * r
    return np.concatenate([v, a], axis=-1)


def _rk4(x, h):
    f1 = _dyn(x)
    f2 = _dyn(x + 0.5 * h * f1)
    f3 = _dyn(x + 0.5 * h * f2)
    f4 = _dyn(x + h * f3)
    return x + (h / 6.0) * (f1 + 2 * f2 + 2 * f3 + f4)


def propagate_all(x, max_gap):
    """1 Hz RK4 over the max gap for all knots (BA_utils.py:73-87 pattern)."""
    for _ in range(max_gap):
        x = _rk4(x, 1.0)
    return x


def baseline_ba_iteration(states9, ii, uv, lm, max_gap=250):
    """One LM-iteration-shaped workload: rollout + FD Jacobian of the rollout
    + dense normal equations + dense solve.  states9 (N, 9) [pos, phi, vel]
    packed; returns the solved update (value unused by callers)."""
    N = states9.shape[0]
    M = uv.shape[0]
    x = np.concatenate([states9[:, :3], states9[:, 6:9]], axis=-1)

    # residual rollout
    x_pred = propagate_all(x, max_gap)

    # numerical Jacobian of the rollout wrt each of the 6 state dims
    eps = 1e-6
    Jf = np.zeros((N, 6, 6))
    for d in range(6):
        xp = x.copy()
        xp[:, d] += eps
        Jf[:, :, d] = (propagate_all(xp, max_gap) - x_pred) / eps

    # reprojection jacobians (cheap analytic stand-in) + scatter into dense H
    H = np.zeros((N * 9, N * 9))
    g = np.zeros(N * 9)
    rng = np.random.default_rng(0)
    Jg = rng.standard_normal((M, 2, 9))
    r = rng.standard_normal((M, 2))
    for m in range(M):
        i = ii[m]
        H[i * 9:(i + 1) * 9, i * 9:(i + 1) * 9] += Jg[m].T @ Jg[m]
        g[i * 9:(i + 1) * 9] += Jg[m].T @ r[m]
    for t in range(N - 1):
        A = np.zeros((6, 9))
        A[:, 0:3] = Jf[t, :, 0:3]
        A[:, 6:9] = Jf[t, :, 3:6]
        B = np.zeros((6, 9))
        B[0:3, 0:3] = -np.eye(3)
        B[3:6, 6:9] = -np.eye(3)
        H[t * 9:(t + 1) * 9, t * 9:(t + 1) * 9] += A.T @ A
        H[(t + 1) * 9:(t + 2) * 9, (t + 1) * 9:(t + 2) * 9] += B.T @ B
        H[t * 9:(t + 1) * 9, (t + 1) * 9:(t + 2) * 9] += A.T @ B
        H[(t + 1) * 9:(t + 2) * 9, t * 9:(t + 1) * 9] += B.T @ A
    H += np.eye(N * 9) * 1e-2
    return np.linalg.solve(H, g)


def bench_problem(N: int = 32, M: int = 256, seed: int = 0) -> dict:
    """The per-iteration problem bench.py times the window solve and
    `baseline_ba_iteration` on (bench.py:146-162 of the JAX package's
    benchmark, the same numpy draws in the same order): `states` (N, 10)
    [pos, unit quat, vel] near a 6900 km orbit, `gaps` (350 s, the last
    0), `cum_rot` (identity), `lm` (M, 3), `uv` (M, 2), `conf` (M,), `ii`
    (M,) sorted, and `states9` (N, 9) [pos, zeros, vel], the baseline's
    input."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(N, 3)) * 30 + np.array([6900.0, 0, 0])
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.normal(size=(N, 3)) * 0.1 + np.array([0, 7.5, 0])
    states = np.concatenate([pos, q, vel], axis=1)
    gaps = np.full(N, 350.0)
    gaps[-1] = 0
    cum = np.zeros((N, 4))
    cum[:, 3] = 1
    lm = pos[rng.integers(0, N, M)] * 0.92
    uv = rng.uniform(0, 2000, size=(M, 2))
    conf = rng.uniform(0.8, 1.0, M)
    ii = np.sort(rng.integers(0, N, M)).astype(np.int64)
    states9 = np.concatenate([pos, np.zeros((N, 3)), vel], axis=1)
    return dict(states=states, gaps=gaps, cum_rot=cum, lm=lm, uv=uv,
                conf=conf, ii=ii, states9=states9)
