"""Crossover bench of the port's kernels on the card (port of
vinsat_tpu/kernels/bench_kernels.py): each hand-written CUDA kernel
against its plain PyTorch twin, and the block-tridiagonal solve's
algorithms against each other, at a sweep of sizes.

  * visible_count (K3, kernels/visible_count.py) against
    `visible_count_plain`, the plain broadcast: the simulator's imaging
    gate, F frames x L landmarks; the counts must be equal;
  * assemble_normal_eq (K2, kernels/normal_eq.py) against
    `assemble_normal_eq_plain` and the two einsums of the JAX package's
    XLA path (weights applied beforehand): the per-knot assembly of the
    sharded path; the results must agree;
  * the block-tridiagonal solve's algorithms (estimation/ba.py): Thomas,
    the chunked SPIKE (`chunked_spike`, its reduced solve by cyclic
    reduction: `chunked_bcrred_m<chunk rows>`), block cyclic reduction to
    a base of 1 or 16 rows (`bcr_base1`, `bcr_base16`) and K1
    (kernels/tridiag_pcr.py; `cuda_pcr`, where the JAX module has
    `pallas_pcr`), each with its relative error against Thomas: the data
    of the "auto" dispatch.

Columns (the JAX module's xla_ms / pallas_ms become plain_ms /
library_ms and cuda_ms):
  cuda_ms, plain_ms, library_ms — the kernel's, its plain twin's and the
    library call's looped device time a call (utils.mfu.looped: R calls
    chained through a data-dependent carry, captured as one CUDA graph
    and replayed between CUDA events, differenced against one call);
    library_ms null where no PyTorch call computes the function;
  device_ms — the same for a solve algorithm;
  *eager_ms — CUDA events around back-to-back eager calls: the host's
    launch cost included;
  chain_ms — the looped time of the carry's fold alone, which every
    looped time above includes;
  loop_R — the R each looped time used (lowered where R calls would
    exceed utils.mfu.NODE_BUDGET graph nodes).
No L2 flush between calls: each input stays in L2, as the real caller
finds it after assembly.  Launches made here are not counted: the
kernels' launch counters are restored when a bench returns.

    python -m vinsat_tpu_torch.kernels.bench_kernels \\
        [visible_count] [assemble] [tridiag] [--dtype float32|float64] \\
        [--device cuda] [--sizes S,S,...] [--batch B] [--only A,A,...]

--sizes replaces each named bench's sweep (N for tridiag, FxL for
visible_count, NxD for assemble), --batch solves B systems at once and
--only keeps the named algorithms (tridiag).

The first line names the card (nvidia-smi's name and power limit); then
one JSON line a (kernel, size) or (algorithm, size).  It needs a card;
on the CPU (--device cpu) the kernels run as their plain twins and every
time is the host's, under cpu_-prefixed names.
"""
from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from vinsat_tpu_torch.config import resolve_device
from vinsat_tpu_torch.estimation import ba
from vinsat_tpu_torch.kernels import normal_eq, tridiag_pcr, visible_count
from vinsat_tpu_torch.utils import mfu

TINY = 1e-30


@contextlib.contextmanager
def _launches_kept():
    """The kernels' launch counters as they were before the block."""
    counters = (tridiag_pcr.block_tridiag_solve_pcr,
                normal_eq.assemble_normal_eq, visible_count.visible_count)
    before = [c.launches for c in counters]
    try:
        yield
    finally:
        for c, n in zip(counters, before):
            c.launches = n


def _timed(device, **times) -> dict:
    """Times under their names on a card; on the CPU under cpu_<name>
    (a host time is never a device metric)."""
    pre = "" if device.type == "cuda" else "cpu_"
    return {pre + k: v for k, v in times.items()}


def _looped_ms(step, chain, carry, *rest, R: int, repeats: int):
    lp = mfu.looped(step, chain, carry, *rest, R=R, repeats=repeats)
    return lp.seconds * 1e3, lp.R


def bench_visible_count(sizes=((1024, 2048), (4096, 8192), (16384, 16896)),
                        dtype=torch.float32, device="cuda", R: int = 32,
                        repeats: int = 20):
    """K3 against its plain twin at each (F, L): the JAX module's boxes
    (5 x 4 deg at random lon / lat) and landmarks (30% accepted)."""
    device = resolve_device(device)
    rows = []
    with _launches_kept():
        for F, L in sizes:
            rng = np.random.default_rng(0)
            bounds = np.stack([rng.uniform(-180, 175, F),
                               rng.uniform(-80, 75, F), np.zeros(F),
                               np.zeros(F)], axis=1)
            bounds[:, 2] = bounds[:, 0] + 5.0
            bounds[:, 3] = bounds[:, 1] + 4.0
            b = torch.as_tensor(bounds, dtype=dtype, device=device)
            lon = torch.as_tensor(rng.uniform(-180, 180, L), dtype=dtype,
                                  device=device)
            lat = torch.as_tensor(rng.uniform(-85, 85, L), dtype=dtype,
                                  device=device)
            best = torch.as_tensor(rng.random(L) < 0.3, device=device)
            got = visible_count.visible_count(b, lon, lat, best)
            want = visible_count.visible_count_plain(b, lon, lat, best)
            if not torch.equal(got, want):
                raise RuntimeError(f"visible_count disagrees with its plain "
                                   f"twin at F={F}, L={L}")

            def chain(bb, counts):
                return bb + TINY * counts[:, None]

            times, loop_r = {}, {}
            for tag, fn in (("cuda", visible_count.visible_count),
                            ("plain", visible_count.visible_count_plain)):
                times[f"{tag}_ms"], loop_r[tag] = _looped_ms(
                    fn, chain, b, lon, lat, best, R=R, repeats=repeats)
                times[f"{tag}_eager_ms"] = mfu._time_ms(
                    fn, (b, lon, lat, best), repeats, warmup=0)
            times["chain_ms"], _ = _looped_ms(
                lambda bb, *_: got, chain, b, R=R, repeats=repeats)
            rows.append({"kernel": "visible_count", "F": F, "L": L,
                         "dtype": str(dtype)[6:], "counts_equal": True,
                         **_timed(device, **times), "library_ms": None,
                         "loop_R": loop_r})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def bench_assemble(sizes=((256, 8), (1024, 8), (4096, 8), (4096, 16)),
                   dtype=torch.float32, device="cuda", R: int = 32,
                   repeats: int = 20):
    """K2 against its plain twin and the two einsums at each (N, D):
    random J, r, w (the JAX module's)."""
    device = resolve_device(device)
    rows = []
    with _launches_kept():
        for N, D in sizes:
            rng = np.random.default_rng(0)
            J = torch.as_tensor(rng.normal(size=(N, D, 2, 9)), dtype=dtype,
                                device=device)
            r = torch.as_tensor(rng.normal(size=(N, D, 2)), dtype=dtype,
                                device=device)
            w = torch.as_tensor(rng.random((N, D)), dtype=dtype,
                                device=device)
            G, g = normal_eq.assemble_normal_eq(J, r, w)
            Gp, gp = normal_eq.assemble_normal_eq_plain(J, r, w)
            err = max(float((G - Gp).abs().max() / Gp.abs().max()),
                      float((g - gp).abs().max() / gp.abs().max()))
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            if not err <= tol:
                raise RuntimeError(f"assemble_normal_eq disagrees with its "
                                   f"plain twin at N={N}, D={D}: {err}")
            JW = J * w[..., None, None]

            def einsums(J, r, JW):
                return (torch.einsum("ndki,ndkj->nij", JW, J),
                        torch.einsum("ndki,ndk->ni", JW, r))

            def chain(c, out):
                g0 = out[1][:, :1]  # (N, 1): g's first entries
                return c + TINY * g0.reshape(N, *[1] * (c.dim() - 1))

            times, loop_r = {}, {}
            for tag, fn, args in (
                    ("cuda", normal_eq.assemble_normal_eq, (J, r, w)),
                    ("plain", normal_eq.assemble_normal_eq_plain, (J, r, w)),
                    ("library", einsums, (J, r, JW))):
                # the carry is the weights (the einsums': JW, as weighted)
                def step(c, *rest, fn=fn, args=args):
                    return fn(*args[:2], c)

                times[f"{tag}_ms"], loop_r[tag] = _looped_ms(
                    step, chain, args[2], R=R, repeats=repeats)
                times[f"{tag}_eager_ms"] = mfu._time_ms(fn, args, repeats,
                                                        warmup=0)
            times["chain_ms"], _ = _looped_ms(
                lambda c, *_: (G, g), chain, w, R=R, repeats=repeats)
            rows.append({"kernel": "assemble_normal_eq", "N": N, "D": D,
                         "dtype": str(dtype)[6:], "max_rel_err": err,
                         **_timed(device, **times), "loop_R": loop_r})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def tridiag_variants(N: int, device):
    """{name: solve(D, U, b)} of the algorithms timed at N rows: the JAX
    module's, with K1 as `cuda_pcr` (its plain twin `pcr_plain` on the
    CPU)."""
    variants = {
        "thomas": ba.block_tridiag_solve,
        "chunked_spike": lambda D, U, b: ba.block_tridiag_solve_chunked(
            D, U, b, ba._auto_chunks(D.shape[-3])),
        "bcr_base1": lambda D, U, b: ba.block_tridiag_solve_bcr(
            D, U, b, base=1),
        "bcr_base16": lambda D, U, b: ba.block_tridiag_solve_bcr(
            D, U, b, base=16),
    }
    for m in (8, 16, 32):
        if N % m == 0 and N // m >= 4:
            variants[f"chunked_bcrred_m{m}"] = (
                lambda D, U, b, m=m: ba.block_tridiag_solve_chunked(
                    D, U, b, D.shape[-3] // m, reduced="bcr"))
    pcr = "cuda_pcr" if torch.device(device).type == "cuda" else "pcr_plain"
    variants[pcr] = tridiag_pcr.block_tridiag_solve_pcr
    return variants


def bench_tridiag(sizes=(256, 1024, 4096), k: int = 9, R: int = 32,
                  repeats: int = 3, dtype=torch.float32, device="cuda",
                  batch=None, only=None):
    """The solve's algorithms at each N (`tridiag_variants`; `only`: a
    subset of their names), on the JAX module's systems: D = AAᵀ + 10 I,
    U ~ 0.3 N(0, 1), b ~ N(0, 1), one system or `batch` systems at once.
    Each is timed looped with the D-chained carry (the solution folded
    into D and b, so no stage that reads only D and U can be hoisted) and
    eagerly, with its relative error against Thomas (Frobenius norms)."""
    device = resolve_device(device)
    if k != tridiag_pcr.K:
        raise ValueError(f"K1 solves {tridiag_pcr.K}x{tridiag_pcr.K} "
                         f"blocks, not {k}x{k}")
    lead = () if batch is None else (batch,)
    rows = []
    with _launches_kept():
        for N in sizes:
            rng = np.random.default_rng(0)
            A = rng.normal(size=lead + (N, k, k))
            D, U, b = (torch.as_tensor(a, dtype=dtype, device=device) for a
                       in (np.einsum("...tij,...tkj->...tik", A, A)
                           + 10.0 * np.eye(k),
                           rng.normal(size=lead + (N - 1, k, k)) * 0.3,
                           rng.normal(size=lead + (N, k))))
            x_ref = ba.block_tridiag_solve(D, U, b)
            ref_norm = float(torch.linalg.vector_norm(x_ref))

            def chain(carry, x):
                DD, bb = carry
                return (DD + TINY * x[..., :, :, None] * x[..., :, None, :],
                        bb + TINY * x)

            chain_ms, _ = _looped_ms(lambda c, U: x_ref, chain, (D, b), U,
                                     R=R, repeats=repeats)
            for name, fn in tridiag_variants(N, device).items():
                if only is not None and name not in only:
                    continue
                x = x_ref if name == "thomas" else fn(D, U, b)
                rel = float(torch.linalg.vector_norm(x - x_ref)) / ref_norm
                lp = mfu.looped(lambda c, U, fn=fn: fn(c[0], U, c[1]),
                                chain, (D, b), U, R=R, repeats=repeats)
                eager_ms = mfu._time_ms(fn, (D, U, b), repeats, warmup=0)
                rows.append({
                    "kernel": "block_tridiag", "variant": name, "N": N,
                    "B": batch, "dtype": str(dtype)[6:],
                    **_timed(device, device_ms=lp.seconds * 1e3,
                             eager_ms=eager_ms, chain_ms=chain_ms),
                    "loop_R": lp.R, "graph_nodes": lp.nodes,
                    "rel_err_vs_thomas": rel})
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="vinsat_tpu_torch.kernels."
                                      "bench_kernels")
    ap.add_argument("benches", nargs="*",
                    choices=["visible_count", "assemble", "tridiag"],
                    help="which benchmarks to run (default: visible_count "
                         "and assemble, the kernels against their twins; "
                         "'tridiag' sweeps the block-tridiagonal solve's "
                         "algorithms)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated sizes in place of each bench's "
                         "sweep: N (tridiag), FxL (visible_count), NxD "
                         "(assemble)")
    ap.add_argument("--batch", type=int, default=None,
                    help="tridiag: B systems solved at once")
    ap.add_argument("--only", default=None,
                    help="tridiag: comma-separated algorithm names "
                         "(tridiag_variants)")
    args = ap.parse_args(argv)
    benches = args.benches or ["visible_count", "assemble"]
    sizes = (None if args.sizes is None else
             [tuple(int(x) for x in s.split("x"))
              for s in args.sizes.split(",")])
    only = None if args.only is None else args.only.split(",")
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"device": name, "nvidia_smi": mfu._smi(),
                      "dtype": args.dtype}), flush=True)
    rows = []
    kw = {} if sizes is None else {"sizes": sizes}
    if "visible_count" in benches:
        rows += bench_visible_count(dtype=dtype, device=device, **kw)
    if "assemble" in benches:
        rows += bench_assemble(dtype=dtype, device=device, **kw)
    if "tridiag" in benches:
        if sizes is not None:
            kw["sizes"] = [n for n, in sizes]
        rows += bench_tridiag(dtype=dtype, device=device, batch=args.batch,
                              only=only, **kw)
    return rows


if __name__ == "__main__":
    main()
