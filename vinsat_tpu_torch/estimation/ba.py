"""Robust Levenberg–Marquardt bundle adjustment, single-chip part (port of
vinsat_tpu/estimation/ba.py).

One `ba_iteration` builds the reprojection and dynamics factors, the
robust weights and the block-tridiagonal normal equations, then runs the
λ search over `jacobi_scaled_tridiag_solve` and retracts.  The normal
matrix is never dense: per-knot blocks come from `index_add_` over the
observations (the JAX `segment_sum`; on CUDA it sums with atomics, so runs
differ at roundoff) and the damped system is solved blockwise.

Solve dispatch ("auto"): as in the JAX package, a system of N < 64 block
rows takes the plain Thomas scan; from N = 64 a CUDA tensor goes to kernel
K1 (kernels/tridiag_pcr), a CPU tensor to K1's plain PyTorch twin.
"pcr" and "thomas" force one of the two; "chunked", "chunked_bcr", "bcr1"
and "bcr16" force the JAX package's other algorithms (chunked SPIKE with
a Thomas or cyclic-reduction reduced solve, block cyclic reduction to a
base of 1 or 16 rows), which are plain PyTorch ops in JAX's operation
order, on either device.

Schedules, masks and the λ acceptance rule are the JAX package's; the
schedule index is a host int, so α and Σ are Python floats here
(`robust_alpha`, `dynamics_sigma`): a captured iteration holds them as
constants, and the stream's fast path captures one graph per distinct
pair (estimation/graphs.py).

`ba_reg_iteration` is `ba_iteration` with the window-marginal prior
factor (the two share `_iteration`); `terminal_marginal_info`,
`inflate_info` and `propagate_prior` build the priors that the stream's
prior and bounded-window modes hand from one window to the next.

Orbit axis: `ba_iteration` also takes B orbits at once (states (B, N, 10),
every BAProblem field but `intrinsics` with a leading B), which is what
the JAX package's `vmap` over `ba_iteration` computes (the constellation
solve, window.solve_window_batch): one robust scale per orbit, per-orbit
sums, and a λ search whose orbits each stop on their own while the batch
runs on (`_lambda_search`).  The unbatched call is the same arithmetic
without that axis.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.config import to_device
from vinsat_tpu_torch.core import quat
from vinsat_tpu_torch.estimation import factors


class BAProblem(NamedTuple):
    """Static-shape (padded) window problem; field names as in the JAX
    BAProblem.  Padded observations have obs_valid=0 and ii=0, padded knots
    knot_valid=0 and gaps=0; pair_valid masks dynamics pairs.  A batch of
    orbits (`stack_problems`) carries a leading B on every field but
    intrinsics."""

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


def stack_problems(probs) -> BAProblem:
    """B problems of one padded shape as one batch: every field stacked on
    a leading orbit axis except `intrinsics`, which the orbits share (the
    first problem's)."""
    return BAProblem(**{
        name: (probs[0].intrinsics if name == "intrinsics" else
               torch.stack([getattr(p, name) for p in probs]))
        for name in BAProblem._fields})


def problem_from_numpy(fields: Mapping[str, np.ndarray], device,
                       dtype=torch.float64) -> BAProblem:
    """BAProblem from the JAX BAProblem's fields as numpy arrays (e.g.
    `{k: np.asarray(v) for k, v in jax_prob._asdict().items()}`)."""
    return BAProblem(**{
        name: to_device(fields[name], torch.int64 if name == "ii" else dtype,
                        device)
        for name in BAProblem._fields})


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
    # "auto" (Thomas below PCR_MIN_N block rows, else "pcr"), "pcr" (kernel
    # K1 or its twin by device), or one of the JAX package's algorithms:
    # "thomas", "chunked", "chunked_bcr", "bcr1", "bcr16"
    tridiag_variant: str = "auto"


def _masked_median(x, valid):
    """Median of |x| over valid entries: x (..., M, k), valid (..., M) ->
    one median per leading index (per orbit), each from a sort of its own
    M·k values."""
    flat = x.abs().flatten(-2)
    vmask = valid[..., None].expand(x.shape).flatten(-2) > 0
    big = torch.where(vmask, flat, torch.full_like(flat, math.inf))
    order = torch.sort(big, dim=-1).values
    n = vmask.sum(-1)
    last = flat.shape[-1] - 1
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)
    # gather with tensor indices: indexing with a 0-d tensor would sync
    return 0.5 * (order.gather(-1, lo[..., None])
                  + order.gather(-1, hi[..., None]))[..., 0]


def robust_alpha(sched_iter: int) -> float:
    """The robust weights' shape α at a schedule index: 2 -> 1 over the
    first iterations."""
    it = float(sched_iter)
    return min(max(1.0 - (2.0 * (it / 5.0) - 1.0), 1.0), 2.0)


def dynamics_sigma(sched_iter: int, params: SolverParams) -> float:
    """The dynamics factor's weight Σ at a schedule index."""
    return min(params.sigma_scale * (float(sched_iter) + 1.0) ** 2,
               params.sigma_max)


def robust_weights(r_obs, conf, obs_valid, sched_iter: int):
    """Adaptive Barron-style robust weights: α anneals 2 -> 1 over the
    first iterations; weights normalized by their max, scaled by conf.
    r_obs (..., M, 2): the scale and the max are per leading index."""
    alpha = robust_alpha(sched_iter)
    c = torch.clamp(_masked_median(r_obs, obs_valid), min=1e-12)[..., None,
                                                                  None]
    if alpha >= 2.0 - 1e-9:
        w_elem = torch.ones_like(r_obs) / (c * c)
    else:
        x2 = (r_obs / c) ** 2
        denom = max(abs(alpha - 2.0), 1e-12)
        w_elem = ((x2 / denom + 1.0) ** (alpha / 2.0 - 1.0)) / (c * c)
    w = w_elem.mean(-1) * obs_valid
    w = w / torch.clamp(w.amax(-1, keepdim=True), min=1e-30)
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


def block_tridiag_solve_multi(D, U, B):
    """block_tridiag_solve with a matrix RHS: B (..., N, k, r) -> X."""
    return block_tridiag_solve_blockrhs(D, U, B)


def _tridiag_general(Dr, Ur, Lr, br):
    """General (nonsymmetric) block-tridiagonal Thomas with partial
    pivoting in each row's block solve: Lr[c] couples row c to row c-1
    (Lr[..., 0] ignored), Ur[c] couples row c to c+1.  Dr, Lr
    (..., C, k, k); Ur (..., C-1, k, k); br (..., C, k) -> (..., C, k)."""
    C, k = Dr.shape[-3], Dr.shape[-1]
    C_prev = torch.zeros_like(Lr[..., 0, :, :])
    d_prev = torch.zeros_like(br[..., 0, :])
    Cs, ds = [], []
    for c in range(C):
        Lt = Lr[..., c, :, :]
        Ut = Ur[..., c, :, :] if c < C - 1 else torch.zeros_like(Lt)
        denom = Dr[..., c, :, :] - Lt @ C_prev
        rhs = torch.cat(
            [Ut, (br[..., c, :] - (Lt @ d_prev[..., None])[..., 0])[..., None]],
            dim=-1)
        sol = gj_solve_small(denom, rhs, pivot=True)
        C_prev, d_prev = sol[..., :k], sol[..., k]
        Cs.append(C_prev)
        ds.append(d_prev)
    xs = [None] * C
    x_next = torch.zeros_like(d_prev)
    for c in reversed(range(C)):
        x_next = ds[c] - (Cs[c] @ x_next[..., None])[..., 0]
        xs[c] = x_next
    return torch.stack(xs, dim=-2)


def _mv(A, x):
    """Batched matrix-vector product: A (..., m, n), x (..., n)."""
    return (A @ x[..., None])[..., 0]


def _identity_padded(D, b, n: int):
    """D (..., N, k, k) and b (..., N, k) padded to n rows with identity
    diagonal blocks and zero right-hand sides."""
    N, k = D.shape[-3], D.shape[-1]
    lead = D.shape[:-3]
    eye = torch.eye(k, dtype=D.dtype, device=D.device)
    return (torch.cat([D, eye.expand(*lead, n - N, k, k)], dim=-3),
            torch.cat([b, b.new_zeros(*lead, n - N, k)], dim=-2))


def _pad_rows(X, before: int, after: int):
    """X (..., n, k, k) with `before` zero blocks ahead and `after` behind."""
    lead, k = X.shape[:-3], X.shape[-1]
    return torch.cat([X.new_zeros(*lead, before, k, k), X,
                      X.new_zeros(*lead, after, k, k)], dim=-3)


def _shift_down(X, dim: int):
    """X moved one row down along `dim` (-3 for blocks, -2 for vectors), a
    zero first row: the JAX package's concatenate([zeros(1), X[:-1]])."""
    n = X.shape[dim]
    return torch.cat([torch.zeros_like(X.narrow(dim, 0, 1)),
                      X.narrow(dim, 0, n - 1)], dim=dim)


def _tridiag_general_bcr(Dr, Ur, Lr, br, base: int = 4):
    """General (nonsymmetric) block cyclic reduction of
        L_t y_{t-1} + D_t y_t + U_t y_{t+1} = b_t
    (Lr[..., 0] and Ur[..., -1] ignored): log-depth, 2 log2(C/base) + base
    levels of batched ops, the reduced solve of the chunked SPIKE.  Dr, Ur,
    Lr (..., C, k, k); br (..., C, k) -> (..., C, k).  Each level
    eliminates the odd rows with one pivoted Gauss-Jordan of D_o against
    [L_o | U_o | b_o]; C is padded to a power of two with identity
    diagonal blocks.  The JAX package's operation order."""
    C, k = Dr.shape[-3], Dr.shape[-1]
    lead = Dr.shape[:-3]
    n = 1 << (max(C, 2) - 1).bit_length()
    Dp, bp = _identity_padded(Dr, br, n)
    Up = _pad_rows(Ur[..., :C - 1, :, :], 0, n - C + 1)
    Lp = _pad_rows(Lr[..., 1:C, :, :], 1, n - C)

    stack = []
    while n > max(base, 1):
        D2 = Dp.reshape(*lead, n // 2, 2, k, k)
        U2 = Up.reshape(*lead, n // 2, 2, k, k)
        L2 = Lp.reshape(*lead, n // 2, 2, k, k)
        b2 = bp.reshape(*lead, n // 2, 2, k)
        D_e, D_o = D2[..., 0, :, :], D2[..., 1, :, :]
        # U_e: even -> odd of the same t; U_o: odd -> even t + 1
        U_e, U_o = U2[..., 0, :, :], U2[..., 1, :, :]
        # L_o: odd -> even of the same t; L_e: even -> odd t - 1
        L_e, L_o = L2[..., 0, :, :], L2[..., 1, :, :]
        b_e, b_o = b2[..., 0, :], b2[..., 1, :]

        sol = gj_solve_small(
            D_o, torch.cat([L_o, U_o, b_o[..., None]], dim=-1), pivot=True)
        Dinv_L, Dinv_U = sol[..., :k], sol[..., k:2 * k]
        Dinv_b = sol[..., 2 * k]
        stack.append((Dinv_L, Dinv_U, Dinv_b))

        # the odd row of the same t (through U_e), then the one of t - 1
        # (through L_e)
        D_new = D_e - U_e @ Dinv_L
        U_new = -(U_e @ Dinv_U)
        b_new = b_e - _mv(U_e, Dinv_b)
        D_new = D_new - L_e @ _shift_down(Dinv_U, -3)
        L_new = -(L_e @ _shift_down(Dinv_L, -3))
        b_new = b_new - _mv(L_e, _shift_down(Dinv_b, -2))

        Dp, Up, Lp, bp = D_new, U_new, L_new, b_new
        n //= 2

    if n == 1:
        y = gj_solve_small(Dp[..., 0, :, :], bp[..., 0, :, None],
                           pivot=True)[..., 0][..., None, :]
    else:
        y = _tridiag_general(Dp, Up[..., :-1, :, :], Lp, bp)

    for Dinv_L, Dinv_U, Dinv_b in reversed(stack):
        m = Dinv_b.shape[-2]
        y_next = torch.cat([y[..., 1:, :], torch.zeros_like(y[..., :1, :])],
                           dim=-2)
        y_o = Dinv_b - _mv(Dinv_L, y) - _mv(Dinv_U, y_next)
        y = torch.stack([y, y_o], dim=-2).reshape(*lead, 2 * m, k)
    return y[..., :C, :]


def block_tridiag_solve_chunked(D, U, b, num_chunks: int,
                                reduced: str = "thomas"):
    """Chunked SPIKE solve of the symmetric block-tridiagonal system: the N
    rows split into `num_chunks` chunks of m, each Thomas-eliminated with
    the block right-hand side [b | L_first | U_last] (all chunks at once,
    a batch axis), the reduced system of the chunks' boundary unknowns
    (block tridiagonal, 2k x 2k blocks) solved by a pivoted Thomas
    recursion ("thomas") or cyclic reduction ("bcr"), then every chunk
    back-substituted at once.  Sequential depth m + 2·num_chunks instead
    of N.  D (..., N, k, k), U (..., N-1, k, k) or (N-1, k, k), b (...,
    N, k); N must be a multiple of num_chunks; num_chunks <= 1 is the
    plain Thomas scan."""
    N, k = D.shape[-3], D.shape[-1]
    if num_chunks <= 1:
        return block_tridiag_solve(D, U, b)
    if N % num_chunks:
        raise ValueError(f"N={N} is not a multiple of num_chunks="
                         f"{num_chunks}")
    lead = D.shape[:-3]
    C, m = num_chunks, N // num_chunks
    U_pad = _pad_rows(U.expand(*lead, N - 1, k, k), 0, 1)
    Dc = D.reshape(*lead, C, m, k, k)
    Uc = U_pad.reshape(*lead, C, m, k, k)  # Uc[c, -1] couples to chunk c+1
    bc = b.reshape(*lead, C, m, k)
    # each chunk's left coupling: the previous chunk's last U, transposed
    L_first = _shift_down(Uc[..., -1, :, :], -3).transpose(-1, -2)
    zeros = Dc.new_zeros(*lead, C, m - 1, k, k)
    rhs = torch.cat([bc[..., None],
                     torch.cat([L_first[..., None, :, :], zeros], dim=-3),
                     torch.cat([zeros, Uc[..., -1:, :, :]], dim=-3)], dim=-1)
    sol = block_tridiag_solve_blockrhs(Dc, Uc[..., :-1, :, :], rhs)
    g, V, W = sol[..., 0], sol[..., 1:1 + k], sol[..., 1 + k:]

    # the reduced system in y_c = [x_first_c, x_last_c]: chunk c couples to
    # c - 1 through V and to c + 1 through W
    k2 = 2 * k
    Dr = torch.eye(k2, dtype=D.dtype, device=D.device).expand(
        *lead, C, k2, k2)
    Lr = torch.cat([Dc.new_zeros(*lead, C, k2, k),
                    torch.cat([V[..., 0, :, :], V[..., -1, :, :]], dim=-2)],
                   dim=-1)
    Ur = torch.cat([torch.cat([W[..., 0, :, :], W[..., -1, :, :]], dim=-2),
                    Dc.new_zeros(*lead, C, k2, k)], dim=-1)
    br = torch.cat([g[..., 0, :], g[..., -1, :]], dim=-1)
    if reduced == "bcr":
        y2 = _tridiag_general_bcr(Dr, Ur, Lr, br)
    else:
        y2 = _tridiag_general(Dr, Ur[..., :-1, :, :], Lr, br)

    # the last boundary of chunk c - 1 and the first of chunk c + 1
    x_left = _shift_down(y2[..., k:], -2)
    x_right = torch.cat([y2[..., 1:, :k], torch.zeros_like(y2[..., :1, :k])],
                        dim=-2)
    x = g - _mv(V, x_left[..., None, :]) - _mv(W, x_right[..., None, :])
    return x.reshape(*lead, N, k)


def block_tridiag_solve_bcr(D, U, b, base: int = 16):
    """Block cyclic reduction of the symmetric block-tridiagonal system:
    sequential depth 2·log2(N/base) + base of batched 9x9 ops.  Each level
    eliminates the odd block rows with one Gauss-Jordan of D_o against
    [U_oe | U_eoᵀ | b_o]:
        D'_t = D_e[t] - U_oe[t-1]ᵀ D_o[t-1]⁻¹ U_oe[t-1]
                      - U_eo[t] D_o[t]⁻¹ U_eo[t]ᵀ
        U'_t = -U_eo[t] D_o[t]⁻¹ U_oe[t]
        b'_t = b_e[t] - U_oe[t-1]ᵀ D_o[t-1]⁻¹ b_o[t-1]
                      - U_eo[t] D_o[t]⁻¹ b_o[t]
    until `base` rows are left, which a Thomas scan solves; then the odd
    unknowns are back-substituted level by level.  N is padded to a power
    of two with identity diagonal blocks; the even/odd split is a reshape,
    as in the JAX package, whose operation order this keeps.  D (..., N,
    k, k), U (..., N-1, k, k) or (N-1, k, k), b (..., N, k)."""
    N, k = D.shape[-3], D.shape[-1]
    lead = D.shape[:-3]
    n = 1 << (max(N, 2) - 1).bit_length()
    Dp, bp = _identity_padded(D, b, n)
    Up = _pad_rows(U.expand(*lead, N - 1, k, k), 0, n - N + 1)

    stack = []
    while n > max(base, 1):
        D2 = Dp.reshape(*lead, n // 2, 2, k, k)
        U2 = Up.reshape(*lead, n // 2, 2, k, k)
        b2 = bp.reshape(*lead, n // 2, 2, k)
        D_e, D_o = D2[..., 0, :, :], D2[..., 1, :, :]
        U_eo = U2[..., 0, :, :]  # even i -> odd i+1
        U_oe = U2[..., 1, :, :]  # odd o -> even o+1 (the last one padding)
        b_e, b_o = b2[..., 0, :], b2[..., 1, :]

        sol = gj_solve_small(D_o, torch.cat(
            [U_oe, U_eo.transpose(-1, -2), b_o[..., None]], dim=-1))
        Dinv_Uoe = sol[..., :k]
        Dinv_UeoT = sol[..., k:2 * k]
        Dinv_b = sol[..., 2 * k]
        stack.append((Dinv_Uoe, Dinv_UeoT, Dinv_b))

        # the right neighbour (odd 2t+1), then the left one (odd 2t-1): the
        # JAX package's .at[1:].add(-term[:-1]), out of place
        D_new = D_e - U_eo @ Dinv_UeoT
        b_new = b_e - _mv(U_eo, Dinv_b)
        U_new = -(U_eo @ Dinv_Uoe)
        UoeT = U_oe.transpose(-1, -2)
        L_term = UoeT @ Dinv_Uoe
        bL_term = _mv(UoeT, Dinv_b)
        D_new = torch.cat([D_new[..., :1, :, :],
                           D_new[..., 1:, :, :] + -L_term[..., :-1, :, :]],
                          dim=-3)
        b_new = torch.cat([b_new[..., :1, :],
                           b_new[..., 1:, :] + -bL_term[..., :-1, :]],
                          dim=-2)

        Dp, Up, bp = D_new, U_new, b_new
        n //= 2

    if n == 1:
        x = gj_solve_small(Dp[..., 0, :, :],
                           bp[..., 0, :, None])[..., 0][..., None, :]
    else:
        x = block_tridiag_solve(Dp, Up[..., :-1, :, :], bp)

    for Dinv_Uoe, Dinv_UeoT, Dinv_b in reversed(stack):
        m = Dinv_b.shape[-2]
        x_next = torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])],
                           dim=-2)
        x_o = Dinv_b - _mv(Dinv_UeoT, x) - _mv(Dinv_Uoe, x_next)
        x = torch.stack([x, x_o], dim=-2).reshape(*lead, 2 * m, k)
    return x[..., :N, :]


def dense_from_blocks(D, U):
    """The dense symmetric matrix (Nk, Nk) of the block-tridiagonal system
    D (N, k, k), U (N-1, k, k): a validation helper."""
    N, k = D.shape[0], D.shape[-1]
    H = D.new_zeros(N * k, N * k)
    for t in range(N):
        H[t * k:(t + 1) * k, t * k:(t + 1) * k] = D[t]
    for t in range(N - 1):
        H[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = U[t]
        H[(t + 1) * k:(t + 2) * k, t * k:(t + 1) * k] = U[t].T
    return H


def _bcr_chunks(N: int) -> int:
    """Chunks of the cyclic-reduction-reduced chunked SPIKE: the largest
    power-of-two divisor of N that keeps chunks of m >= 32 rows (the JAX
    package's choice)."""
    c = 1
    while N % (2 * c) == 0 and N // (2 * c) >= 32:
        c *= 2
    return c


def _auto_chunks(N: int) -> int:
    """Chunks of the chunked SPIKE: the largest power-of-two divisor of N
    that is <= sqrt(N), 1 (the plain scan) below 128 rows (the JAX
    package's choice: it minimizes the sequential depth m + 2C)."""
    if N < 128:
        return 1
    c = 1
    while (2 * c) * (2 * c) <= N and N % (2 * c) == 0:
        c *= 2
    return c


# The JAX package's f64 "auto" solve takes the plain scan below 64 rows
# (vinsat_tpu/estimation/ba.py:258-266, _auto_chunks: 1 chunk below 128).
PCR_MIN_N = 64


def jacobi_scaled_tridiag_solve(D, U, b, variant: str = "auto"):
    """Block-tridiagonal solve with symmetric Jacobi preconditioning
    s = diag(D)^{-1/2}: solve (SHS)(S⁻¹x) = Sb.  Leading batch dims are
    allowed (λ candidates, orbits); U may lack them.  K1 takes one batch
    axis, so several are flattened into it: K candidates of B orbits go to
    the kernel as K·B systems, each with its own (scaled) U."""
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    Ds = D * s[..., :, :, None] * s[..., :, None, :]
    Us = U * s[..., :-1, :, None] * s[..., 1:, None, :]
    bs = b * s
    N = D.shape[-3]
    if variant == "auto":
        variant = "pcr" if N >= PCR_MIN_N else "thomas"
    if variant == "pcr":
        from vinsat_tpu_torch.kernels.tridiag_pcr import (
            block_tridiag_solve_pcr)

        lead = Ds.shape[:-3]
        xs = block_tridiag_solve_pcr(
            Ds.reshape(-1, N, 9, 9), Us.reshape(-1, N - 1, 9, 9),
            bs.reshape(-1, N, 9)).reshape(*lead, N, 9)
    elif variant == "thomas":
        xs = block_tridiag_solve(Ds, Us, bs)
    elif variant == "chunked":
        xs = block_tridiag_solve_chunked(Ds, Us, bs, _auto_chunks(N))
    elif variant == "chunked_bcr":
        xs = block_tridiag_solve_chunked(Ds, Us, bs, _bcr_chunks(N),
                                         reduced="bcr")
    elif variant == "bcr1":
        xs = block_tridiag_solve_bcr(Ds, Us, bs, base=1)
    elif variant == "bcr16":
        xs = block_tridiag_solve_bcr(Ds, Us, bs, base=16)
    else:
        raise ValueError(f"unknown tridiag variant {variant!r}")
    return xs * s


class BAStep(NamedTuple):
    """One iteration's output; with an orbit axis each field leads with B."""

    states: torch.Tensor  # (N, 10) updated states
    lamda_init: torch.Tensor  # scalar, carried to the next iteration
    last_hessian: torch.Tensor  # (9, 9) trailing diagonal block of JTwJ
    mean_residual: torch.Tensor  # diagnostic


def _along(mask, t):
    """mask (...) shaped to broadcast against t (..., *rest)."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def _take(t, j):
    """t[j[b], b, ...] for each leading index b of j: the first axis of t
    indexed per batch entry (t (K, *j.shape, ...))."""
    idx = _along(j[None], t).expand((1,) + t.shape[1:])
    return t.gather(0, idx)[0]


def _lambda_search(solve_with, trial_residual, init_residual, lamda0,
                   params: SolverParams):
    """The LM damping search: try λ, accept iff the trial residual drops
    below the linearization-point residual, else λ ×= growth while
    λ <= λ_max; the first trial always runs.  Returns (states_new,
    lamda_used, lamda_exit, trial_res).  lamda0 is a scalar, or (B,) for B
    orbits searched at once.

    batched_lambda == 0: the sequential loop (one host sync per trial).
    With orbits it is the JAX package's vmapped while_loop: trials run
    while any orbit is still searching, and an orbit that has stopped
    keeps its carry, so each orbit ends where its own search would.
    batched_lambda == K: K candidates λ0·gᵏ solved and evaluated at once;
    the first accepted (else the last <= λ_max) wins — the same selection,
    made per orbit.
    """
    K = params.batched_lambda
    if K <= 0:
        def body(lamda):
            states_new = solve_with(lamda)
            trial = trial_residual(states_new)
            return (lamda * params.lambda_growth, trial < init_residual,
                    states_new, lamda, trial)

        def searching(carry):
            return ~carry[1] & (carry[0] <= params.lambda_max)

        carry = body(lamda0)
        active = searching(carry)
        while bool(active.any()):
            carry = tuple(torch.where(_along(active, new), new, old)
                          for new, old in zip(body(carry[0]), carry))
            active = searching(carry)
        lamda_f, _, states_new, lamda_used, trial_res = carry
        return states_new, lamda_used, lamda_f, trial_res

    # λ0·gᵏ by repeated products, bit for bit the sequential loop's values
    lamdas = torch.cumprod(torch.cat(
        [lamda0[None],
         lamda0.new_full((K - 1,) + lamda0.shape, params.lambda_growth)]),
        dim=0)  # (K, *orbits)
    states_c = solve_with(lamdas)  # (K, *orbits, N, 10)
    trials = trial_residual(states_c)  # (K, *orbits)
    ks = _along(torch.arange(K, device=lamdas.device), lamdas)
    valid = (ks == 0) | (lamdas <= params.lambda_max)
    accepted = valid & (trials < init_residual)
    first_acc = torch.argmax(accepted.to(lamdas.dtype), dim=0)
    last_valid = K - 1 - torch.argmax(valid.flip(0).to(lamdas.dtype), dim=0)
    j = torch.where(accepted.any(0), first_acc, last_valid)
    lam_j = _take(lamdas, j)
    return (_take(states_c, j), lam_j, lam_j * params.lambda_growth,
            _take(trials, j))


def _residual_means(r_obs_w, r_pred_flat, obs_valid, pair_valid, sigma: float,
                    pred_dim: float, r_pri=None, knot_valid=None):
    """mean |[r_obs ; r_pred*sqrt(Sigma) ; r_pri]| with padding-aware
    counts; leading batch dims of the residuals (λ candidates, then
    orbits) are kept, and each orbit counts its own valid entries
    (obs_valid (..., M), pair_valid (..., N-1)).  The prior's residuals
    r_pri (..., N, 7) count where knot_valid."""
    s = ((r_obs_w.abs() * obs_valid[..., None]).sum((-2, -1))
         + (r_pred_flat.abs() * math.sqrt(sigma)).sum((-2, -1)))
    n = 2.0 * obs_valid.sum(-1) + pred_dim * pair_valid.sum(-1)
    if r_pri is not None:
        s = s + (r_pri.abs() * knot_valid[..., None]).sum((-2, -1))
        n = n + 7.0 * knot_valid.sum(-1)
    return s / torch.clamp(n, min=1.0)


def _segment_sum(vals, ii, N: int):
    """Per-knot sums of per-observation values (the JAX segment_sum):
    vals (M, ...) with ii (M,) -> (N, ...); with an orbit axis, vals
    (B, M, ...) with ii (B, M) -> (B, N, ...), each orbit into its own
    rows (one index_add_ over flattened offsets ii + b·N)."""
    if ii.dim() == 1:
        return vals.new_zeros((N,) + vals.shape[1:]).index_add_(0, ii, vals)
    Bn, tail = ii.shape[0], vals.shape[2:]
    rows = ii + N * torch.arange(Bn, device=ii.device)[:, None]
    out = vals.new_zeros((Bn * N,) + tail).index_add_(
        0, rows.reshape(-1), vals.reshape((-1,) + tail))
    return out.view((Bn, N) + tail)


def ba_iteration(sched_iter: int, states, prob: BAProblem, lamda_init,
                 params: SolverParams = SolverParams(),
                 initialize: bool = False) -> BAStep:
    """One robust-LM iteration.  sched_iter (host int, may be negative)
    feeds the α/Σ schedules; `initialize` zeroes the dynamics factor (the
    vision-only warm start).  states (N, 10), or (B, N, 10) with a batched
    `prob` (`stack_problems`) and lamda_init a float or (B,): B orbits in
    one iteration, the schedule and `initialize` shared."""
    return _iteration(sched_iter, states, prob, lamda_init, params,
                      initialize)


def ba_reg_iteration(sched_iter: int, states, prob: BAProblem,
                     prior: "PriorState", lamda_init,
                     params: SolverParams = SolverParams(),
                     quat_coeff_prior: float = 1.0,
                     vel_coeff_prior: float = 1.0,
                     initialize: bool = False) -> BAStep:
    """One regularized LM iteration with the window-marginal prior factor
    (the JAX package's BA_reg): ba_iteration plus JpᵀJp (block diagonal)
    and the prior's rotation Newton terms.  prior: a PriorState over all N
    knots (zero information on knots without one).  quat_coeff_prior /
    vel_coeff_prior weight the prior's rotation and velocity residuals
    (factors.prior_factor).  One orbit."""
    return _iteration(sched_iter, states, prob, lamda_init, params,
                      initialize, prior, quat_coeff_prior, vel_coeff_prior)


def _iteration(sched_iter: int, states, prob: BAProblem, lamda_init,
               params: SolverParams, initialize: bool, prior=None,
               quat_coeff_prior: float = 1.0,
               vel_coeff_prior: float = 1.0) -> BAStep:
    """ba_iteration, or with a PriorState ba_reg_iteration: the factors,
    the normal equations, the λ search and the retraction they share."""
    dtype, dev = states.dtype, states.device
    orbits, N = states.shape[:-2], states.shape[-2]

    def prior_at(st):
        return factors.prior_factor(st, prior.prop_states, prior.H_state,
                                    prior.H_rot, vel_coeff_prior,
                                    quat_coeff_prior,
                                    valid=prior.valid * prob.knot_valid)

    reproj = factors.reprojection_factor(
        states, prob.landmarks_xyz, prob.ii, prob.intrinsics)
    dyn = factors.dynamics_factor(
        states, prob.gaps, prob.cum_rot, params.quat_coeff, params.vel_coeff,
        valid_pair=prob.pair_valid, num_hops=params.num_hops,
        max_substep=params.max_substep, with_jacobian=True)

    r_obs = (prob.landmarks_uv - reproj.uv) * prob.obs_valid[..., None]
    w = robust_weights(r_obs, prob.conf, prob.obs_valid, sched_iter)

    sigma = dynamics_sigma(sched_iter, params)

    res_pv, res_q, A, B = dyn.res_pv, dyn.res_q, dyn.A, dyn.B
    qgrad, Hq_diag, Hq_off = dyn.qgrad, dyn.Hq_diag, dyn.Hq_off
    if initialize:
        # multiply (not drop) like the JAX package: NaN stays NaN
        res_pv, res_q, A, B, qgrad, Hq_diag, Hq_off = (
            t * 0.0 for t in (res_pv, res_q, A, B, qgrad, Hq_diag, Hq_off))

    # --- normal-equation blocks ------------------------------------------
    Jg = reproj.J  # (M, 2, 9)
    JgW = Jg * w[..., None, None]
    G_obs = JgW.transpose(-1, -2) @ Jg  # (M, 9, 9)
    D = _segment_sum(G_obs, prob.ii, N)
    D = D + sigma * Hq_diag
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    D[..., :-1, :, :] += sigma * (At @ A)
    D[..., 1:, :, :] += sigma * (Bt @ B)
    pf = None if prior is None else prior_at(states)
    if pf is not None:
        D = D + pf.Jp.transpose(-1, -2) @ pf.Jp + pf.Hq_diag
    U = sigma * (At @ B + Hq_off)

    # --- gradient ---------------------------------------------------------
    JgT_robs = _segment_sum(
        (JgW.transpose(-1, -2) @ r_obs[..., None])[..., 0], prob.ii, N)
    JfT_r = torch.zeros(orbits + (N, 9), dtype=dtype, device=dev)
    JfT_r[..., :-1, :] += (At @ res_pv[..., None])[..., 0]
    JfT_r[..., 1:, :] += (Bt @ res_pv[..., None])[..., 0]
    if pf is None:
        JTr = JgT_robs - sigma * JfT_r - sigma * qgrad
    else:
        JpT_r = (pf.Jp.transpose(-1, -2) @ pf.res[..., :6, None])[..., 0]
        JTr = JgT_robs - sigma * JfT_r - JpT_r - sigma * qgrad - pf.qgrad

    # --- initial residual (acceptance reference) --------------------------
    pred_dim = 6.0 if initialize else 7.0
    if initialize:
        r_pred_for_mean = torch.zeros_like(res_pv[..., :1]).expand(
            *res_pv.shape[:-1], 7)
    else:
        r_pred_for_mean = torch.cat([res_pv, res_q[..., None]], dim=-1)
    def prior_kw(pf_):
        return ({} if pf_ is None else
                dict(r_pri=pf_.res, knot_valid=prob.knot_valid))

    init_residual = _residual_means(
        r_obs, r_pred_for_mean * prob.pair_valid[..., None], prob.obs_valid,
        prob.pair_valid, sigma, pred_dim, **prior_kw(pf))

    eye = torch.eye(9, dtype=dtype, device=dev)

    def trial_residual(states_new):
        uv_new = factors.project_landmarks(
            states_new, prob.landmarks_xyz, prob.ii, prob.intrinsics)
        r_obs1 = (prob.landmarks_uv - uv_new) * prob.obs_valid[..., None]
        r_obs1 = r_obs1 * w[..., None]
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
                                dim=-1) * prob.pair_valid[..., None]
        pf1 = None if prior is None else prior_at(states_new)
        return _residual_means(r_obs1, r_pred1, prob.obs_valid,
                               prob.pair_valid, sigma, pred_dim,
                               **prior_kw(pf1))

    def retract(dpose):
        position = states[..., :3] + dpose[..., 0:3]
        rotation = quat.box_plus(states[..., 3:7], dpose[..., 3:6])
        vels = states[..., 7:10] + dpose[..., 6:9]
        return torch.cat([position, rotation, vels], dim=-1)

    def solve_with(lamda):
        Dl = D + lamda[..., None, None, None] * eye
        return retract(jacobi_scaled_tridiag_solve(
            Dl, U, JTr, variant=params.tridiag_variant))

    if isinstance(lamda_init, torch.Tensor):
        lamda0 = lamda_init.to(dtype)
    else:
        lamda0 = torch.full(orbits, float(lamda_init), dtype=dtype,
                            device=dev)
    states_new, lamda_used, lamda_f, trial_res = _lambda_search(
        solve_with, trial_residual, init_residual, lamda0, params)

    lamda_init_new = torch.clamp(torch.clamp(lamda_f * 0.01, max=1e-1),
                                 min=1e-4)
    # trailing diagonal block of the last VALID knot
    idx_last = torch.clamp(prob.knot_valid.sum(-1).to(torch.int64) - 1,
                           min=0)
    last_hessian = (
        D.gather(-3, idx_last[..., None, None, None].expand(
            orbits + (1, 9, 9)))[..., 0, :, :]
        + lamda_used[..., None, None] * eye)
    return BAStep(states_new, lamda_init_new, last_hessian, trial_res)


def terminal_marginal_info(states, prob: BAProblem,
                           params: SolverParams = SolverParams(),
                           sigma_obs_px: float = 4.0,
                           sigma_dyn: Optional[float] = None,
                           extra_diag=None):
    """The true marginal information (9, 9) of the last valid knot of one
    window: inv((H⁻¹)_NN) is the final Schur complement S_N of the forward
    (Thomas) elimination of the block-tridiagonal H, built with physical
    weights (observations at conf/σ_px², dynamics at σ_dyn, by default the
    solver's σ_max) and Jacobi scaling.  extra_diag (N, 9, 9) adds, e.g.,
    the anchor knot's prior information.  The forward sweep is a host loop
    of 9x9 LU solves up to the last valid knot (the JAX package scans all N
    and picks that one; the rows after it do not reach it)."""
    dtype, dev = states.dtype, states.device
    N = states.shape[0]
    sigma = float(params.sigma_max if sigma_dyn is None else sigma_dyn)
    reproj = factors.reprojection_factor(
        states, prob.landmarks_xyz, prob.ii, prob.intrinsics)
    dyn = factors.dynamics_factor(
        states, prob.gaps, prob.cum_rot, params.quat_coeff, params.vel_coeff,
        valid_pair=prob.pair_valid, num_hops=params.num_hops,
        max_substep=params.max_substep, with_jacobian=True)
    w = prob.conf * prob.obs_valid / (sigma_obs_px ** 2)
    JgW = reproj.J * w[:, None, None]
    D = _segment_sum(JgW.transpose(-1, -2) @ reproj.J, prob.ii, N)
    D = D + sigma * dyn.Hq_diag
    At, Bt = dyn.A.transpose(-1, -2), dyn.B.transpose(-1, -2)
    D[:-1] += sigma * (At @ dyn.A)
    D[1:] += sigma * (Bt @ dyn.B)
    U = sigma * (At @ dyn.B + dyn.Hq_off)
    if extra_diag is not None:
        D = D + extra_diag
    # small diagonal floor: padding and unobserved blocks stay invertible
    eye = torch.eye(9, dtype=dtype, device=dev)
    D = D + 1e-9 * eye
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    Ds = D * s[:, :, None] * s[:, None, :]
    Us = U * s[:-1, :, None] * s[1:, None, :]
    last = max(int(prob.knot_valid.sum()) - 1, 0)
    S = Ds[0]
    for t in range(1, last + 1):
        Ut = Us[t - 1]
        S = Ds[t] - Ut.transpose(-1, -2) @ torch.linalg.solve_ex(S, Ut)[0]
    # undo the Jacobi scaling
    return S / (s[last][:, None] * s[last][None, :])


def inflate_info(H9, pos_floor_km: float, rot_floor: float,
                 vel_floor: float) -> np.ndarray:
    """Covariance floors on a 9x9 information matrix (host numpy):
    inv(inv(H) + diag(floor²)), keeping the marginal's correlations while
    stopping an anchor from over-pinning the next window."""
    H9 = np.asarray(H9, dtype=np.float64)
    cov = np.linalg.inv(H9 + 1e-12 * np.eye(9))
    floors = np.concatenate([
        np.full(3, pos_floor_km ** 2),
        np.full(3, rot_floor ** 2),
        np.full(3, vel_floor ** 2),
    ])
    return np.linalg.inv(cov + np.diag(floors))


# [pos, vel] rows of a 9x9 [pos, phi, vel] information matrix
POS_VEL = [0, 1, 2, 6, 7, 8]


def split_info(H9):
    """The blocks of a [pos, phi, vel] information matrix (..., 9, 9),
    numpy or torch, that prior_factor reads: (H_state [pos, vel]
    (..., 6, 6), H_rot [phi] (..., 3, 3)); the pos/vel-phi cross terms
    are dropped."""
    return H9[..., POS_VEL, :][..., :, POS_VEL], H9[..., 3:6, 3:6]


class PriorState(NamedTuple):
    """Propagated window-marginal prior (the streaming handoff state)."""

    prop_states: torch.Tensor  # (N, 10)
    H_state: torch.Tensor  # (N, 6, 6) pos/vel information
    H_rot: torch.Tensor  # (N, 3, 3) rotation information
    valid: torch.Tensor  # (N,) 0/1: which knots carry a prior


def propagate_prior(end_state, last_hessian, gaps_to_knots, cum_rots,
                    num_hops: int = 16,
                    max_substep: float = 100.0) -> PriorState:
    """The previous window's terminal state and marginal covariance
    propagated to each new knot.  end_state (10,); last_hessian (9, 9) in
    [pos, phi, vel] order; gaps_to_knots (N,) seconds from the window end
    to each new knot; cum_rots (N, 4) IMU rotations over those spans.
    Inverses do not raise on a singular matrix (they give inf / NaN, as in
    the JAX package)."""
    from vinsat_tpu_torch.core import dynamics

    def inv(a):
        return torch.linalg.inv_ex(a)[0]

    N = gaps_to_knots.shape[0]
    Hs, Hr = split_info(last_hessian)
    cov_state, cov_rot = inv(Hs), inv(Hr)
    p, v, J = dynamics.propagate_gaps_with_jacobian(
        end_state[:3].expand(N, 3), end_state[7:10].expand(N, 3),
        gaps_to_knots, num_hops=num_hops, max_substep=max_substep)
    cov_s = J @ cov_state @ J.transpose(-1, -2)
    q = quat.normalize(quat.multiply(end_state[3:7].expand(N, 4), cum_rots))
    Rc = quat.to_matrix(cum_rots).transpose(-1, -2)
    cov_r = Rc @ cov_rot @ Rc.transpose(-1, -2)
    return PriorState(torch.cat([p, q, v], dim=-1), inv(cov_s), inv(cov_r),
                      torch.ones(N, dtype=end_state.dtype,
                                 device=end_state.device))
