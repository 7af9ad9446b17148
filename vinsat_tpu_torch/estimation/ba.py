"""Robust Levenberg–Marquardt bundle adjustment, single-chip part (port of
vinsat_tpu/estimation/ba.py).

One `ba_iteration` builds the reprojection and dynamics factors, the
robust weights and the block-tridiagonal normal equations, then runs the
λ search over `jacobi_scaled_tridiag_solve` and retracts.  The normal
matrix is never dense: per-knot blocks come from `index_add_` over the
observations (the JAX `segment_sum`; on CUDA it sums with atomics, so runs
differ at roundoff) and the damped system is solved blockwise.

Solve dispatch: a CUDA tensor goes to kernel K1 (kernels/tridiag_pcr), a
CPU tensor to K1's plain PyTorch twin; "thomas" forces the Thomas oracle.
The JAX package's XLA workaround variants (bcr*, chunked*) exist for a
TPU compiler pathology and are not ported.

Schedules, masks and the λ acceptance rule are the JAX package's; the
schedule index is a host int, so α and Σ are Python floats here.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch

from vinsat_tpu_torch.core import quat
from vinsat_tpu_torch.estimation import factors


class BAProblem(NamedTuple):
    """Static-shape (padded) window problem; field names as in the JAX
    BAProblem.  Padded observations have obs_valid=0 and ii=0, padded knots
    knot_valid=0 and gaps=0; pair_valid masks dynamics pairs."""

    gaps: torch.Tensor  # (N,) seconds to next knot
    cum_rot: torch.Tensor  # (N, 4)
    landmarks_xyz: torch.Tensor  # (M, 3) km ECI
    landmarks_uv: torch.Tensor  # (M, 2) px
    conf: torch.Tensor  # (M,)
    ii: torch.Tensor  # (M,) int64 obs -> knot
    obs_valid: torch.Tensor  # (M,) 0/1
    knot_valid: torch.Tensor  # (N,) 0/1
    pair_valid: torch.Tensor  # (N-1,) 0/1
    intrinsics: torch.Tensor  # (4,)


def problem_from_numpy(fields: Mapping[str, np.ndarray], device,
                       dtype=torch.float64) -> BAProblem:
    """BAProblem from the JAX BAProblem's fields as numpy arrays (e.g.
    `{k: np.asarray(v) for k, v in jax_prob._asdict().items()}`)."""
    out = {}
    for name in BAProblem._fields:
        a = np.array(fields[name])  # a copy: the source may be read-only
        out[name] = torch.as_tensor(
            a, dtype=torch.int64 if name == "ii" else dtype, device=device)
    return BAProblem(**out)


class SolverParams(NamedTuple):
    """The JAX SolverParams, field for field (build one from the JAX tuple
    with `SolverParams(**jax_params._asdict())`)."""

    quat_coeff: float = 100.0
    vel_coeff: float = 100.0
    sigma_scale: float = 10000.0
    sigma_max: float = 1.0e6
    lambda_max: float = 1.0e4
    lambda_growth: float = 10.0
    num_hops: int = 16
    max_substep: float = 100.0
    # 0 = sequential λ escalation; K > 0 = K candidates in one batched solve
    batched_lambda: int = 0
    max_iters: int = 0
    conv_rtol: float = 0.01
    conv_patience: int = 10_000
    # "auto" / "pcr" (kernel K1 or its twin by device) or "thomas"
    tridiag_variant: str = "auto"


def _masked_median(x, valid):
    """Median of |x| over valid entries."""
    flat = x.abs().reshape(-1)
    vmask = valid[..., None].expand(x.shape).reshape(-1) > 0
    big = torch.where(vmask, flat, torch.full_like(flat, math.inf))
    order = torch.sort(big).values
    n = vmask.sum()
    last = flat.shape[0] - 1
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)
    # gather with tensor indices: indexing with a 0-d tensor would sync
    return 0.5 * (order.gather(0, lo.view(1)) + order.gather(0, hi.view(1)))[0]


def robust_weights(r_obs, conf, obs_valid, sched_iter: int):
    """Adaptive Barron-style robust weights: α anneals 2 -> 1 over the
    first iterations; weights normalized by their max, scaled by conf."""
    it = float(sched_iter)
    alpha = min(max(1.0 - (2.0 * (it / 5.0) - 1.0), 1.0), 2.0)
    c = torch.clamp(_masked_median(r_obs, obs_valid), min=1e-12)
    if alpha >= 2.0 - 1e-9:
        w_elem = torch.ones_like(r_obs) / (c * c)
    else:
        x2 = (r_obs / c) ** 2
        denom = max(abs(alpha - 2.0), 1e-12)
        w_elem = ((x2 / denom + 1.0) ** (alpha / 2.0 - 1.0)) / (c * c)
    w = w_elem.mean(-1) * obs_valid
    w = w / torch.clamp(w.max(), min=1e-30)
    return w * conf * obs_valid


def gj_solve_small(A, B, pivot: bool = False):
    """Batched small-block solve A x = B by unrolled Gauss-Jordan, in the
    JAX package's elimination order.  A (..., k, k), B (..., k, r)."""
    k = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    rows = torch.arange(k, device=A.device)
    for i in range(k):
        if pivot:
            col = M[..., :, i].abs()
            col = torch.where(rows < i, torch.full_like(col, -math.inf), col)
            p = torch.argmax(col, dim=-1)[..., None]
            perm = torch.where(rows == i, p,
                               torch.where(rows == p, torch.full_like(p, i),
                                           rows))
            M = torch.gather(M, -2, perm[..., :, None].expand(M.shape))
        piv = M[..., i, i][..., None]
        row_i = M[..., i, :] / piv
        M = M - M[..., :, i][..., None] * row_i[..., None, :]
        M[..., i, :] = row_i
    return M[..., k:]


def block_tridiag_solve_blockrhs(D, U, B):
    """Thomas solve with a block RHS: D (..., N, k, k), U (..., N-1, k, k),
    B (..., N, k, R) -> X (..., N, k, R).  The oracle for kernel K1."""
    N, k = D.shape[-3], D.shape[-1]
    C_prev = torch.zeros_like(D[..., 0, :, :])
    d_prev = torch.zeros_like(B[..., 0, :, :])
    Cs, ds = [], []
    for t in range(N):
        Dt = D[..., t, :, :]
        Ut = U[..., t, :, :] if t < N - 1 else torch.zeros_like(Dt)
        if t > 0:
            LtT = U[..., t - 1, :, :].transpose(-1, -2)
            denom = Dt - LtT @ C_prev
            rhs = torch.cat([Ut, B[..., t, :, :] - LtT @ d_prev], dim=-1)
        else:
            denom = Dt
            rhs = torch.cat([Ut, B[..., t, :, :]], dim=-1)
        sol = gj_solve_small(denom, rhs)
        C_prev, d_prev = sol[..., :k], sol[..., k:]
        Cs.append(C_prev)
        ds.append(d_prev)
    xs = [None] * N
    x_next = torch.zeros_like(d_prev)
    for t in reversed(range(N)):
        x_next = ds[t] - Cs[t] @ x_next
        xs[t] = x_next
    return torch.stack(xs, dim=-3)


def block_tridiag_solve(D, U, b):
    """Thomas solve of the symmetric block-tridiagonal system
    (D (..., N, k, k), U (..., N-1, k, k), b (..., N, k) -> x)."""
    return block_tridiag_solve_blockrhs(D, U, b[..., None])[..., 0]


def jacobi_scaled_tridiag_solve(D, U, b, variant: str = "auto"):
    """Block-tridiagonal solve with symmetric Jacobi preconditioning
    s = diag(D)^{-1/2}: solve (SHS)(S⁻¹x) = Sb.  Leading batch dims are
    allowed (the batched λ candidates); U may lack them."""
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    Ds = D * s[..., :, :, None] * s[..., :, None, :]
    Us = U * s[..., :-1, :, None] * s[..., 1:, None, :]
    bs = b * s
    if variant in ("auto", "pcr"):
        from vinsat_tpu_torch.kernels.tridiag_pcr import (
            block_tridiag_solve_pcr)

        xs = block_tridiag_solve_pcr(Ds, Us, bs)
    elif variant == "thomas":
        xs = block_tridiag_solve(Ds, Us, bs)
    else:
        raise ValueError(f"unknown tridiag variant {variant!r}")
    return xs * s


class BAStep(NamedTuple):
    states: torch.Tensor  # (N, 10) updated states
    lamda_init: torch.Tensor  # scalar, carried to the next iteration
    last_hessian: torch.Tensor  # (9, 9) trailing diagonal block of JTwJ
    mean_residual: torch.Tensor  # diagnostic


def _lambda_search(solve_with, trial_residual, init_residual, lamda0,
                   params: SolverParams):
    """The LM damping search: try λ, accept iff the trial residual drops
    below the linearization-point residual, else λ ×= growth while
    λ <= λ_max; the first trial always runs.  Returns (states_new,
    lamda_used, lamda_exit, trial_res).

    batched_lambda == 0: the sequential loop (one host sync per trial).
    batched_lambda == K: K candidates λ0·gᵏ solved and evaluated at once;
    the first accepted (else the last <= λ_max) wins — the same selection.
    """
    K = params.batched_lambda
    if K <= 0:
        def body(lamda):
            states_new = solve_with(lamda)
            trial = trial_residual(states_new)
            return (lamda * params.lambda_growth, bool(trial < init_residual),
                    states_new, lamda, trial)

        lamda_f, done, states_new, lamda_used, trial_res = body(lamda0)
        while not done and bool(lamda_f <= params.lambda_max):
            lamda_f, done, states_new, lamda_used, trial_res = body(lamda_f)
        return states_new, lamda_used, lamda_f, trial_res

    # λ0·gᵏ by repeated products, bit for bit the sequential loop's values
    lamdas = torch.cumprod(torch.cat(
        [lamda0.reshape(1), lamda0.new_full((K - 1,), params.lambda_growth)]),
        dim=0)
    states_c = solve_with(lamdas)  # (K, N, 10)
    trials = trial_residual(states_c)  # (K,)
    ks = torch.arange(K, device=lamdas.device)
    valid = (ks == 0) | (lamdas <= params.lambda_max)
    accepted = valid & (trials < init_residual)
    first_acc = torch.argmax(accepted.to(lamdas.dtype))
    last_valid = K - 1 - torch.argmax(valid.flip(0).to(lamdas.dtype))
    j = torch.where(accepted.any(), first_acc, last_valid).view(1)
    lam_j = lamdas.index_select(0, j)[0]
    return (states_c.index_select(0, j)[0], lam_j,
            lam_j * params.lambda_growth, trials.index_select(0, j)[0])


def _residual_means(r_obs_w, r_pred_flat, obs_valid, pair_valid, sigma: float,
                    pred_dim: float):
    """mean |[r_obs ; r_pred*sqrt(Sigma)]| with padding-aware counts; leading
    batch dims of the residuals are kept."""
    s_obs = (r_obs_w.abs() * obs_valid[:, None]).sum((-2, -1))
    n_obs = 2.0 * obs_valid.sum()
    s_pred = (r_pred_flat.abs() * math.sqrt(sigma)).sum((-2, -1))
    n_pred = pred_dim * pair_valid.sum()
    return (s_obs + s_pred) / torch.clamp(n_obs + n_pred, min=1.0)


def ba_iteration(sched_iter: int, states, prob: BAProblem, lamda_init,
                 params: SolverParams = SolverParams(),
                 initialize: bool = False) -> BAStep:
    """One robust-LM iteration.  sched_iter (host int, may be negative)
    feeds the α/Σ schedules; `initialize` zeroes the dynamics factor (the
    vision-only warm start)."""
    dtype, dev = states.dtype, states.device
    N = states.shape[0]

    reproj = factors.reprojection_factor(
        states, prob.landmarks_xyz, prob.ii, prob.intrinsics)
    dyn = factors.dynamics_factor(
        states, prob.gaps, prob.cum_rot, params.quat_coeff, params.vel_coeff,
        valid_pair=prob.pair_valid, num_hops=params.num_hops,
        max_substep=params.max_substep, with_jacobian=True)

    r_obs = (prob.landmarks_uv - reproj.uv) * prob.obs_valid[:, None]
    w = robust_weights(r_obs, prob.conf, prob.obs_valid, sched_iter)

    sigma = min(params.sigma_scale * (float(sched_iter) + 1.0) ** 2,
                params.sigma_max)

    res_pv, res_q, A, B = dyn.res_pv, dyn.res_q, dyn.A, dyn.B
    qgrad, Hq_diag, Hq_off = dyn.qgrad, dyn.Hq_diag, dyn.Hq_off
    if initialize:
        # multiply (not drop) like the JAX package: NaN stays NaN
        res_pv, res_q, A, B, qgrad, Hq_diag, Hq_off = (
            t * 0.0 for t in (res_pv, res_q, A, B, qgrad, Hq_diag, Hq_off))

    # --- normal-equation blocks ------------------------------------------
    Jg = reproj.J  # (M, 2, 9)
    JgW = Jg * w[:, None, None]
    G_obs = JgW.transpose(-1, -2) @ Jg  # (M, 9, 9)
    D = torch.zeros((N, 9, 9), dtype=dtype, device=dev).index_add_(
        0, prob.ii, G_obs)
    D = D + sigma * Hq_diag
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    D[:-1] += sigma * (At @ A)
    D[1:] += sigma * (Bt @ B)
    U = sigma * (At @ B + Hq_off)

    # --- gradient ---------------------------------------------------------
    JgT_robs = torch.zeros((N, 9), dtype=dtype, device=dev).index_add_(
        0, prob.ii, (JgW.transpose(-1, -2) @ r_obs[..., None])[..., 0])
    JfT_r = torch.zeros((N, 9), dtype=dtype, device=dev)
    JfT_r[:-1] += (At @ res_pv[..., None])[..., 0]
    JfT_r[1:] += (Bt @ res_pv[..., None])[..., 0]
    JTr = JgT_robs - sigma * JfT_r - sigma * qgrad

    # --- initial residual (acceptance reference) --------------------------
    pred_dim = 6.0 if initialize else 7.0
    if initialize:
        r_pred_for_mean = torch.zeros_like(res_pv[:, :1]).expand(-1, 7)
    else:
        r_pred_for_mean = torch.cat([res_pv, res_q[:, None]], dim=-1)
    init_residual = _residual_means(
        r_obs, r_pred_for_mean * prob.pair_valid[:, None], prob.obs_valid,
        prob.pair_valid, sigma, pred_dim)

    eye = torch.eye(9, dtype=dtype, device=dev)

    def trial_residual(states_new):
        uv_new = factors.project_landmarks(
            states_new, prob.landmarks_xyz, prob.ii, prob.intrinsics)
        r_obs1 = (prob.landmarks_uv - uv_new) * prob.obs_valid[:, None]
        r_obs1 = r_obs1 * w[:, None]
        if initialize:
            r_pred1 = torch.zeros(states_new.shape[:-2] + (N - 1, 7),
                                  dtype=dtype, device=dev)
        else:
            dyn1 = factors.dynamics_factor(
                states_new, prob.gaps, prob.cum_rot, params.quat_coeff,
                params.vel_coeff, valid_pair=prob.pair_valid,
                num_hops=params.num_hops, max_substep=params.max_substep,
                with_jacobian=False)
            r_pred1 = torch.cat([dyn1.res_pv, dyn1.res_q[..., None]],
                                dim=-1) * prob.pair_valid[:, None]
        return _residual_means(r_obs1, r_pred1, prob.obs_valid,
                               prob.pair_valid, sigma, pred_dim)

    def retract(dpose):
        position = states[:, :3] + dpose[..., 0:3]
        rotation = quat.box_plus(states[:, 3:7], dpose[..., 3:6])
        vels = states[:, 7:10] + dpose[..., 6:9]
        return torch.cat([position, rotation, vels], dim=-1)

    def solve_with(lamda):
        Dl = D + lamda[..., None, None, None] * eye
        return retract(jacobi_scaled_tridiag_solve(
            Dl, U, JTr, variant=params.tridiag_variant))

    if isinstance(lamda_init, torch.Tensor):
        lamda0 = lamda_init.to(dtype)
    else:
        lamda0 = torch.full((), float(lamda_init), dtype=dtype, device=dev)
    states_new, lamda_used, lamda_f, trial_res = _lambda_search(
        solve_with, trial_residual, init_residual, lamda0, params)

    lamda_init_new = torch.clamp(torch.clamp(lamda_f * 0.01, max=1e-1),
                                 min=1e-4)
    # trailing diagonal block of the last VALID knot
    idx_last = torch.clamp(prob.knot_valid.sum().to(torch.int64) - 1, min=0)
    last_hessian = D.index_select(0, idx_last.view(1))[0] + lamda_used * eye
    return BAStep(states_new, lamda_init_new, last_hessian, trial_res)
