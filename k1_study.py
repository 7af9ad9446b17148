#!/usr/bin/env python3
"""Kernel K1 (vinsat_tpu_torch/kernels/csrc/tridiag_pcr.cu) on one NVIDIA
GPU: where its time goes, and this checkout held against another one.

    python3 k1_study.py                # ablation of this checkout's K1
    python3 k1_study.py --against DIR  # then DIR's and this checkout's K1
                                       # and stream, in turns
    python3 k1_study.py --k2k3 DIR     # only DIR's and this checkout's K2
                                       # and K3, in turns

Ablation.  The kernel is rebuilt with parts of its work cut out of the
source (text edits below, each of which must match), and every build is
timed at chip_smoke.py phase 3's shapes (B=9; N 64-1024 in f64, 448 in
f32): CUDA events over 20 calls and the device time of one call under
torch.profiler.  Only the times of the cut builds mean anything: their
answers are wrong.
  full     the kernel as it is;
  barrier  no row's work at all: the launch and the grid barriers;
  no_gj    no Gauss-Jordan pass: the update and the P traffic stay;
  no_nbr   no read of the neighbours' P through L2 (zeros instead).

Against DIR, a checkout of another commit (e.g. the parent, unpacked with
`git archive` into build/archive/parent, which git ignores): each checkout
runs in a process of its own, in the order DIR, this, this, DIR.  Each
prints K1's times as chip_smoke.py phase 3 does and its wrapper's host
time a call (1000 calls enqueued back to back at B=1, N=5, where the
device is faster than the host, and at B=9, N=64), then streams the
committed fixture (tests/data/torch_stream_seed1.npz) through its own
run_streaming on cuda in f64, once to warm up and twice timed (host
wall), with K1's launches and the result.

With --k2k3 DIR, kernels K2 (normal_eq) and K3 (visible_count) instead:
DIR's sources built under other names and launched through DIR's
wrappers, against this checkout's, in one process at the main paths'
shapes (K2: 2168 knots, D=4, f64, with and without f32=True; K3: the
synthetic-eval orbit's 10801 footprints simulated from
tests/data/torch_sim_seed1.npz's draws, 7920 landmarks region by region
and shuffled, f64 and f32), in the order DIR, this, this, DIR: CUDA
events over 20 back-to-back calls, the device kernels and device µs a
call under torch.profiler (chip_smoke._per_call), and the host time a
call while 1000 calls are enqueued back to back.
Then where K2's time goes in this checkout: the device µs of builds with
a part cut out (launch only: every warp returns at once; loads only: no
sums, no stores; no loads: sums of whatever the shared slots hold), and
its host µs a call split into the output allocation, the two views, the
ctypes entry with no launch (N = 0) and with the launch, and the rest
(checks, pointers, counter).

Needs a card, nvcc and torch; imports no JAX.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "vinsat_tpu_torch" / "kernels" / "csrc" / "tridiag_pcr.cu"
# build name: [(text of the source, its replacement, occurrences)]
VARIANTS = {
    "full": [],
    "barrier": [("for (int g = warp; g < R; g += nwarps)",
                 "for (int g = warp; g < 0; g += nwarps)", 2)],
    "no_gj": [("gauss_jordan(a);", "", 2)],
    "no_nbr": [("vm_off >= 0 && i >= s", "false", 1),
               ("vp_off >= 0 && i + s < n", "false", 1)],
}
# K2 build: [(text of its source, the replacement, occurrences)], each
# timed on the device (the cut builds' answers are wrong)
K2_VARIANTS = {
    "full": [],
    "launch_only": [("if (n >= N) return;", "if (n >= 0) return;", 1)],
    "loads_only": [("  __syncwarp();\n",
                    "  __syncwarp();\n  if (N > 0) return;\n", 1)],
    "no_loads": [("stage_all<In, Acc, DT>(J, r, w, Js, n, lane);", "", 1)],
}
STREAM_RUNS = 2  # timed streams per process
HOST_CALLS = 1000  # calls enqueued back to back for a host time a call
# runs one checkout in a process whose working directory is that checkout,
# so that `import vinsat_tpu_torch` finds the checkout's package
WORKER = ("import importlib.util, sys; "
          "spec = importlib.util.spec_from_file_location('k1_study', "
          "sys.argv[1]); m = importlib.util.module_from_spec(spec); "
          "spec.loader.exec_module(m); m.run_checkout(sys.argv[2])")


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded from its file (its helpers time
    K1 in every checkout alike)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ablate() -> None:
    """Every build of VARIANTS, built at once, then timed in turn."""
    import torch

    from vinsat_tpu_torch.kernels import _build, tridiag_pcr

    cs = _chip_smoke()
    smi = cs._smi()
    dev = torch.device("cuda")
    text = SOURCE.read_text()
    out = _build.BUILD_DIR / "k1_study"
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        src = text
        for old, new, n in VARIANTS[name]:
            if src.count(old) != n:
                raise RuntimeError(f"{name}: {old!r} found {src.count(old)} "
                                   f"times in {SOURCE}, not {n}")
            src = src.replace(old, new)
        path = out / f"tridiag_pcr_{name}.cu"
        path.write_text(src)
        return _build.load(f"tridiag_pcr_{name}", path)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    full = _build._loaded.get("tridiag_pcr")

    def rebind():
        # the wrapper binds its entry and sizes its scratch once: forget
        # both, so that the next call takes the swapped build's
        tridiag_pcr._SOLVE._fn = None
        tridiag_pcr._work_elems.clear()

    try:
        for name, lib in libs.items():
            # the wrapper launches this build
            _build._loaded["tridiag_pcr"] = lib
            rebind()
            regs = [ln.strip() for ln in _build.build_logs.get(
                f"tridiag_pcr_{name}", "").splitlines() if "registers" in ln]
            print(f"== K1 build {name}: resident warps "
                  f"{tridiag_pcr.resident_warps(torch.float64)} in f64, "
                  f"{tridiag_pcr.resident_warps(torch.float32)} in f32; "
                  f"{' | '.join(regs)}")
            cs._k1_times(tridiag_pcr.block_tridiag_solve_pcr,
                         tridiag_pcr.block_tridiag_solve_pcr_plain, dev, smi)
    finally:
        if full is None:
            _build._loaded.pop("tridiag_pcr", None)
        else:
            _build._loaded["tridiag_pcr"] = full
        rebind()


def _host_us(fn) -> float:
    """Host µs a call of fn while HOST_CALLS calls are enqueued back to
    back (where the device is faster than the host, the host's time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return dt


def run_checkout(root: str) -> None:
    """K1's times and timed streams of the checkout whose package this
    process imports (the working directory's)."""
    import numpy as np
    import torch

    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.estimation import window
    from vinsat_tpu_torch.evalx import ate
    from vinsat_tpu_torch.kernels import tridiag_pcr

    cs = _chip_smoke()
    smi = cs._smi()
    dev = torch.device("cuda")
    solve = tridiag_pcr.block_tridiag_solve_pcr
    print(f"== checkout {root}: K1 of {Path(tridiag_pcr.__file__).parent}")
    cs._k1_times(solve, tridiag_pcr.block_tridiag_solve_pcr_plain, dev, smi)
    rng = np.random.default_rng(5)
    for Bn, N in ((1, 5), (9, 64)):
        D, U, b = (torch.as_tensor(a, device=dev)
                   for a in cs._problem(rng, Bn, N))
        _, dev_us, _ = cs._per_call(solve, (D, U, b))
        print(f"K1 host µs a call B={Bn} N={N} f64: "
              f"{_host_us(lambda: solve(D, U, b)):.1f} ({HOST_CALLS} calls "
              f"enqueued back to back), {cs._us(dev_us)} µs of device time "
              f"a call  [{smi}]", flush=True)
    fx = np.load(Path(root) / "tests" / "data" / "torch_stream_seed1.npz")
    seed = int(fx["seed"])
    cfg = window.StreamingConfig(dtype="float64")
    t0 = time.time()
    pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
    warm = time.time() - t0
    walls = []
    for _ in range(STREAM_RUNS):
        solve.launches = 0
        t0 = time.time()
        res = pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
        walls.append(time.time() - t0)
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    print(f"stream of {root}: walls {' / '.join(f'{w:.2f}' for w in walls)} "
          f"s (warm-up run {warm:.2f} s), K1 launches {solve.launches} a "
          f"run, time_to_5km_s {t5}, final_error_km "
          f"{float(res.errors[-1]):.6f}  [{smi}]", flush=True)


def k2k3_against(other: Path) -> None:
    """K2 and K3 of `other` (its sources and wrappers) against this
    checkout's, in turns: see the module's docstring."""
    import types

    import numpy as np
    import torch

    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.kernels import _build, normal_eq, visible_count
    from vinsat_tpu_torch.sim import camera, mgrs

    cs = _chip_smoke()
    smi = cs._smi()
    dev = torch.device("cuda")
    kdir = Path("vinsat_tpu_torch") / "kernels"

    def theirs(name):
        """`other`'s wrapper module `name`, launching `other`'s build."""
        spec = importlib.util.spec_from_file_location(
            f"{name}_other", other / kdir / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = _build.load(f"{name}_other", other / kdir / "csrc"
                          / f"{name}.cu")
        # wrappers that load by name, and those holding _build.Entry's
        mod._build = types.SimpleNamespace(load=lambda _: lib)
        for v in vars(mod).values():
            if isinstance(v, _build.Entry):
                v.lib, v._fn = f"{name}_other", None
        return mod

    ne_o, vc_o = theirs("normal_eq"), theirs("visible_count")
    rng = np.random.default_rng(10)
    w = rng.random((2168, 4))
    w[::5, -1] = 0.0
    k2_args = [torch.as_tensor(a, device=dev) for a in (
        rng.normal(size=(2168, 4, 2, 9)) * 50.0,
        rng.normal(size=(2168, 4, 2)), w)]
    sim_fx = np.load(cs.SIM_FIXTURE)
    seq_b = pipeline.simulate_from_draws(
        cs._fixture_draws(sim_fx, "b"), device=dev,
        **json.loads(str(sim_fx["sim_kwargs_b"])))
    bounds, _ = camera.footprint_bounds(
        camera.CameraModel.from_hfov(),
        camera.CameraPose.nadir(seq_b.traj.pos_ecef * 1000.0))
    db = seq_b.db
    lm = (db.lon, db.lat, db.best & mgrs.active_region_mask(dev)[db.region])
    perm = torch.as_tensor(np.random.default_rng(8).permutation(len(lm[0])),
                           device=dev)
    cases = []
    for f32 in (False, True):
        cases.append((f"K2 N=2168 D=4 f64{' f32=True' if f32 else ''}",
                      [(m.assemble_normal_eq, k2_args, {"f32": f32})
                       for m in (ne_o, normal_eq)]))
    for order in ("regions", "shuffled"):
        for dtype in (torch.float64, torch.float32):
            ls = lm if order == "regions" else tuple(a[perm] for a in lm)
            args = [bounds.to(dtype).contiguous(), ls[0].to(dtype),
                    ls[1].to(dtype), ls[2]]
            cases.append((f"K3 F={len(bounds)} L={len(ls[0])} "
                          f"{str(dtype)[6:]} {order}",
                          [(m.visible_count, args, {})
                           for m in (vc_o, visible_count)]))
    for tag, sides in cases:
        (f_o, a_o, kw_o), (f_t, a_t, kw_t) = sides
        want, got = f_o(*a_o, **kw_o), f_t(*a_t, **kw_t)
        if tag.startswith("K3"):
            same = torch.equal(want, got)
        else:
            same = all(float((x - y).abs().max() / y.abs().max()) < 1e-5
                       for x, y in zip(got, want))
        if not same:
            raise RuntimeError(f"{tag}: the two checkouts disagree")
        rows = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            fn, a, kw = sides[side == "this"]
            call = lambda: fn(*a, **kw)  # noqa: E731
            rows[side].append((cs._time_ms(call),
                               *cs._per_call(call, ())[:2]))
        host = {}
        for side in ("other", "this"):
            fn, a, kw = sides[side == "this"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(*a, **kw)
            host[side] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
        print(f"{tag}: host µs a call (enqueue, {HOST_CALLS} calls): "
              + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
        print(f"{tag}: " + "; ".join(
            f"{side} " + ", ".join(f"{ms:.4f} ms a call ({n:g} device "
                                   f"kernels, {cs._us(us)} µs)"
                                   for ms, n, us in r)
            for side, r in rows.items()) + f"  [{smi}]", flush=True)
    k2_where(cs, k2_args, smi)


def k2_where(cs, args, smi) -> None:
    """Where this checkout's K2 call spends its time (module docstring)."""
    import torch

    from vinsat_tpu_torch.kernels import _build, normal_eq

    src = (ROOT / "vinsat_tpu_torch" / "kernels" / "csrc"
           / "normal_eq.cu").read_text()
    out = _build.BUILD_DIR / "k2_study"
    out.mkdir(parents=True, exist_ok=True)
    entry = normal_eq._ENTRY
    lib0 = entry.lib
    try:
        for name, edits in K2_VARIANTS.items():
            text = src
            for old, new, n in edits:
                if text.count(old) != n:
                    raise RuntimeError(f"K2 {name}: {old!r} found "
                                       f"{text.count(old)} times, not {n}")
                text = text.replace(old, new)
            path = out / f"normal_eq_{name}.cu"
            path.write_text(text)
            _build.load(f"normal_eq_{name}", path)
            entry.lib, entry._fn = f"normal_eq_{name}", None
            n_dev, us, _ = cs._per_call(normal_eq.assemble_normal_eq, args)
            print(f"K2 build {name}: {n_dev} device kernels, {cs._us(us)} µs "
                  f"of device time a call  [{smi}]", flush=True)
    finally:
        entry.lib, entry._fn = lib0, None
    J, r, w = args
    N, D = J.shape[0], J.shape[1]
    dev = J.device
    buf = J.new_empty(N * 90)
    ptr = buf.data_ptr()

    host_us = _host_us

    def launch(n):
        return lambda: entry(dev, J.data_ptr(), r.data_ptr(), w.data_ptr(),
                             ptr, ptr + N * 81 * 8, n, D, True, False)

    parts = {
        "whole call": host_us(lambda: normal_eq.assemble_normal_eq(*args)),
        "new_empty": host_us(lambda: J.new_empty(N * 90)),
        "two as_strided": host_us(lambda: (
            buf.as_strided((N, 9, 9), (81, 9, 1)),
            buf.as_strided((N, 9), (9, 1), N * 81))),
        "entry, no launch": host_us(launch(0)),
        "entry with the launch": host_us(launch(N)),
    }
    rest = parts["whole call"] - sum(
        parts[k] for k in ("new_empty", "two as_strided",
                           "entry with the launch"))
    print("K2 host µs a call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items())
        + f", the rest {rest:.1f}  [{smi}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_study: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] not in ("--against", "--k2k3")):
        print(__doc__, file=sys.stderr)
        return 2
    if args and args[0] == "--k2k3":
        k2k3_against(Path(args[1]).resolve())
        return 0
    ablate()
    if args:
        other = Path(args[1]).resolve()
        for root in (other, ROOT, ROOT, other):
            sys.stdout.flush()
            subprocess.run([sys.executable, "-c", WORKER, __file__,
                            str(root)], cwd=root, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
