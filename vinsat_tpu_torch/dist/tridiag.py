"""Arc-sharded symmetric block-tridiagonal solve (SPIKE / Schur reduction),
port of vinsat_tpu/dist/tridiag.py.

The block rows are split into P contiguous shards (the arc dimension of
dist/mesh.py).  Each shard Thomas-eliminates its chunk and forms its two
boundary spikes V and W; the boundary unknowns of all shards form a block
tridiagonal reduced system of 2k x 2k blocks over the P shards, solved by
`ba._tridiag_general` (partial pivoting); then each shard back-substitutes.
Every shard's work runs at once along the arc dimension, and the reduced
solve, replicated on every device in the JAX program, runs once.
"""
from __future__ import annotations

import torch

from vinsat_tpu_torch.dist import mesh as mesh_mod
from vinsat_tpu_torch.estimation.ba import (_tridiag_general,
                                            block_tridiag_solve_multi)


def _local_spike(D_l, U_l, b_l, U_prev_last):
    """Per-shard SPIKE factor: (g, V, W) with
    x_local = g - V @ x_leftboundary - W @ x_rightboundary.
    D_l, U_l (..., m, k, k); b_l (..., m, k); U_prev_last (..., k, k).

    g, V and W come from one Thomas sweep with the block right-hand side
    [b | rhsV | rhsW]: the sweep performs the same row operations on every
    column, so this is the JAX module's three solves in one."""
    m, k = D_l.shape[-3], D_l.shape[-1]
    batch = torch.broadcast_shapes(D_l.shape[:-3], U_l.shape[:-3],
                                   b_l.shape[:-2])
    rhsV = torch.zeros(batch + (m, k, k), dtype=D_l.dtype, device=D_l.device)
    rhsW = torch.zeros_like(rhsV)
    rhsV[..., 0, :, :] = U_prev_last.transpose(-1, -2)
    rhsW[..., -1, :, :] = U_l[..., -1, :, :]
    rhs = torch.cat([b_l[..., None].expand(batch + (m, k, 1)), rhsV, rhsW],
                    dim=-1)
    X = block_tridiag_solve_multi(D_l, U_l[..., :-1, :, :], rhs)
    return X[..., 0], X[..., 1:1 + k], X[..., 1 + k:]


def _shard_body(D_l, U_l, b_l):
    """The SPIKE solve over the arc dimension: D_l, U_l (..., P, Nl, k, k)
    — U_l[..., p, -1] couples shard p's last row to shard p+1's first, and
    is zero at the last shard — and b_l (..., P, Nl, k) -> x (..., P, Nl,
    k)."""
    k = D_l.shape[-1]
    # halo: the left neighbour's last coupling block (zeros for shard 0)
    U_prev_last = mesh_mod.push_right(U_l[..., -1, :, :], dim=-3)
    g, V, W = _local_spike(D_l, U_l, b_l, U_prev_last)

    Vf, Vl = (mesh_mod.all_gather(V[..., i, :, :], dim=-3) for i in (0, -1))
    Wf, Wl = (mesh_mod.all_gather(W[..., i, :, :], dim=-3) for i in (0, -1))
    gf, gl = (mesh_mod.all_gather(g[..., i, :], dim=-2) for i in (0, -1))

    # The reduced system in the boundary unknowns y_p = [x_first_p,
    # x_last_p] is block tridiagonal with 2k x 2k blocks over the shards
    # (shard p couples to p-1 through V and to p+1 through W).
    k2 = 2 * k
    opts = dict(dtype=D_l.dtype, device=D_l.device)
    Lr = torch.zeros(Vf.shape[:-2] + (k2, k2), **opts)
    Lr[..., 0:k, k:] = Vf
    Lr[..., k:, k:] = Vl
    Ur = torch.zeros_like(Lr)
    Ur[..., 0:k, 0:k] = Wf
    Ur[..., k:, 0:k] = Wl
    Dr = torch.eye(k2, **opts).expand(Lr.shape)
    br = torch.cat([gf, gl], dim=-1)
    y2 = _tridiag_general(Dr, Ur[..., :-1, :, :], Lr, br)  # (..., P, 2k)

    # x_left: the left neighbour's last boundary; x_right: the right
    # neighbour's first (zeros at the ends)
    x_left = mesh_mod.push_right(y2[..., k:], dim=-2)
    x_right = mesh_mod.halo_from_right(y2[..., :k], dim=-2)
    return (g - (V @ x_left[..., None, :, None])[..., 0]
            - (W @ x_right[..., None, :, None])[..., 0])


def sharded_block_tridiag_solve(mesh: mesh_mod.Mesh, D, U, b):
    """Solve the symmetric block-tridiagonal system with its block rows
    split over the mesh's arc shards.

    D (..., N, k, k), U (..., N, k, k) — U[i] couples row i to row i+1;
    U[N-1] MUST be zero — and b (..., N, k).  N must divide by the arc
    size.  Returns x (..., N, k)."""
    P = mesh.n_arc
    N, k = D.shape[-3], D.shape[-1]
    if N % P:
        raise ValueError(f"N={N} does not divide into {P} arc shards")
    lead = D.shape[:-3]
    x = _shard_body(D.reshape(lead + (P, N // P, k, k)),
                    U.reshape(U.shape[:-3] + (P, N // P, k, k)),
                    b.reshape(b.shape[:-2] + (P, N // P, k)))
    return x.reshape(x.shape[:-3] + (N, k))
