"""The ("orbit", "arc") layout of the sharded solve on one device, and the
collectives over its arc dimension (port of vinsat_tpu/dist/mesh.py and of
the collectives that vinsat_tpu/dist/sharded_ba.py and dist/tridiag.py run
inside shard_map).

The JAX package runs the sharded solve on a mesh of n_orbit x n_arc
devices.  Here the mesh is laid out on one card: a problem array is
(B, P, Nl, ...) — B orbits, the P = n_arc arc shards as a tensor dimension,
Nl knots per shard — and every collective is a tensor operation along the
P dimension.  That reproduces the JAX program at any n_arc on one device,
and runs the per-shard work of all shards at once.

Each collective is named after the JAX primitive it replaces and takes the
position of the arc dimension (`dim`) in its argument; what a shard
contributes sits along that dimension.  Only this module knows how a
collective is carried out, so that the arc dimension can later move to
`torch.distributed` ranks without touching the solver.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device


class Mesh(NamedTuple):
    """n_orbit x n_arc shards laid out on one device."""

    n_orbit: int
    n_arc: int
    device: torch.device


def make_mesh(n_orbit: int = 1, n_arc: int = 1,
              device=DEFAULT_DEVICE) -> Mesh:
    """The ("orbit", "arc") layout on `device` (default: the card)."""
    if n_orbit < 1 or n_arc < 1:
        raise ValueError(f"mesh axes must be >= 1, got {n_orbit} x {n_arc}")
    return Mesh(int(n_orbit), int(n_arc), resolve_device(device))


def _shift(x, dim: int, by: int):
    """x moved `by` shards along dim (+1: shard i+1 receives shard i's
    slice), zeros entering at the open end."""
    P = x.shape[dim]
    if P == 1:
        return torch.zeros_like(x)
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    if by > 0:
        return torch.cat([zero, x.narrow(dim, 0, P - 1)], dim=dim)
    return torch.cat([x.narrow(dim, 1, P - 1), zero], dim=dim)


def halo_from_right(x, dim: int):
    """ppermute [(i + 1, i)]: shard i receives shard i+1's x; the last shard
    receives zeros (sharded_ba._halo_from_right)."""
    return _shift(x, dim, -1)


def push_right(x, dim: int):
    """ppermute [(i, i + 1)]: shard i+1 receives shard i's x; shard 0
    receives zeros (sharded_ba._push_right, the halo of dist/tridiag)."""
    return _shift(x, dim, +1)


def psum(x, dim: int):
    """psum: the sum of every shard's x, held by every shard (kept as a
    size-1 dimension, so it broadcasts back over the shards)."""
    return x.sum(dim, keepdim=True)


def pmax(x, dim: int):
    """pmax: the largest of every shard's x, held by every shard."""
    return x.amax(dim, keepdim=True)


def all_gather(x, dim: int):
    """all_gather: every shard holds the stack of all shards' x along dim.
    On one device that stack is x itself; computations on it are
    replicated in the JAX program and done once here."""
    del dim
    return x
