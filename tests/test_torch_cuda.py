"""The port's CUDA kernels on the card (marker `cuda`; they skip without
one).  No JAX here, so on a machine with a GPU and no JAX this file runs
alone:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

K1 against its plain PyTorch twin on the same tensors: relative 1e-9 in
f64, 1e-4 in f32 (pivot-free elimination on Jacobi-scaled blocks; f32
roundoff over ~9 levels), from one block row per warp up to N=4097 (more
rows than resident warps), with U batched or shared; one K1 call captured
in a CUDA graph and replayed on new inputs equals the eager call; K1 at
config 4's shape (B=8 orbits of per-orbit U, N=736 and 768: grid-stride).
One BA iteration, and a 3-orbit solve_window_batch with dynamics
iterations (on a synthetic batch, and on the constellation's batch of
three simulated 600 s arcs), on the card (kernel path) against the CPU
(plain path): states relative 1e-9 (the two differ in summation order,
and index_add_ sums with atomics on the card); the trial residual mean
1e-8, since it weighs differences of ~7000 km positions by sqrt(Σ)
(tests/test_torch_ba.py).  The two batch cases are first held, on the
CPU, to move by < 1e-10 under a 1e-15 perturbation of their initial
states, so that the 1e-9 measures the port and not the problem: the
only tests here that run without a card.

The f32 stream on the card: K1 in f32 on the stream's first system
(window 0 of the committed bench arc from its f64 warm start, B=9 λ
candidates, N=64), recorded there, against its twin: relative 1e-4
(measured 1.0e-5); four f32 LM iterations of that window on the card
against the CPU: states relative 1e-5 (measured 9.7e-8).

K3 against its plain twin at the simulator's full size (F=10801 frames,
L=7920 landmarks) in f64 and f32, on a globally uniform DB, on the
region-ordered synthetic DB (where the tile cull skips ~98% of the work)
and on that DB shuffled, and on small adversarial cases (wrapped, NaN and
inf boxes, landmarks at +-180 and on box and tile-box edges, a tile with
no accepted landmark, ragged F and L): counts equal exactly, the tile
boxes equal their twin's bit for bit.  K2 and K3 are one and two device
kernels a call (torch.profiler), replay in a CUDA graph on new inputs and
count one launch a call.

K2 against its plain twin at the long arc's shape (2168 knots, D=4):
relative 1e-12 in f64 (the same products summed in another order), 1e-5
with f32=True or f32 inputs (f32 sums of 8 rows); the same at D from 1 to
256 (its rows staged 64 slots at a time past 64).  One arc-sharded LM step
on the card (K2, Thomas and the SPIKE reduction) against the CPU: states
relative 1e-9, as the single-chip step above; the sharded window solver
with a prior (8 shards) run to max_iters on a projected problem likewise
(the problem checked well conditioned on the CPU).  The early stop's
host loop on CUDA tensors stops each orbit of a scripted batch where the
CPU's does.
"""
import functools

import numpy as np
import pytest
import torch

from vinsat_tpu_torch.dist import mesh, sharded_ba
from vinsat_tpu_torch.estimation import ba
from vinsat_tpu_torch.kernels import normal_eq, tridiag_pcr, visible_count
from vinsat_tpu_torch.sim import landmarks, mgrs


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(rng, B, N, k=9):
    A = rng.normal(size=(B, N, k, k)) * 0.1
    D = np.einsum("btij,btkj->btik", A, A) + np.eye(k) * 3.0
    U = rng.normal(size=(B, N - 1, k, k)) * 0.05
    b = rng.normal(size=(B, N, k))
    return D, U, b


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _device_kernels(fn, tries: int = 5) -> int:
    """Device kernels and copies of one call of fn under torch.profiler:
    the most that any of `tries` traces saw (the profiler has been seen to
    drop the events of short kernels, never to add one); a ~1 ms spin
    kernel before and after the call keeps them off the trace's edges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    most = 0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            fn()
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
        most = max(most, sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.key))
    return most


def _replays(fn, inputs, fresh):
    """fn(*inputs) captured in a CUDA graph, the inputs overwritten with
    `fresh` and the graph replayed: (the graph's outputs, fn(*inputs) run
    eagerly on the fresh inputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (build)
        fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*inputs)
    for a, new in zip(inputs, fresh):
        a.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    return out, fn(*inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("shared_u", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,N", [(9, 1), (9, 5), (1, 64), (9, 64), (9, 257),
                                 (9, 448), (9, 1024), (9, 4097)])
def test_kernel_matches_plain(B, N, dtype, tol, shared_u):
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, dtype=dtype, device=dev)
               for a in _problem(np.random.default_rng(N), B, N))
    if shared_u:
        U = U[0].contiguous()
    if N >= 1024:  # more rows than resident warps: the grid-stride path
        assert B * N > tridiag_pcr.resident_warps(dtype, dev)
    before = tridiag_pcr.block_tridiag_solve_pcr.launches
    got = tridiag_pcr.block_tridiag_solve_pcr(D, U, b)
    torch.cuda.synchronize()
    assert tridiag_pcr.block_tridiag_solve_pcr.launches == before + 1
    assert _rel(got, tridiag_pcr.block_tridiag_solve_pcr_plain(D, U, b)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("N", [736, 768])
def test_kernel_at_constellation_shape(N):
    # config 4: B = 8 orbits of per-orbit U, past the resident warps
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(np.random.default_rng(N + 8), 8, N))
    assert 8 * N > tridiag_pcr.resident_warps(torch.float64, dev)
    before = tridiag_pcr.block_tridiag_solve_pcr.launches
    got = tridiag_pcr.block_tridiag_solve_pcr(D, U, b)
    torch.cuda.synchronize()
    assert tridiag_pcr.block_tridiag_solve_pcr.launches == before + 1
    assert _rel(got, tridiag_pcr.block_tridiag_solve_pcr_plain(D, U, b)) \
        < 1e-9


@pytest.mark.cuda
def test_kernel_counts_one_launch_per_call():
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(np.random.default_rng(1), 9, 448))
    solve = tridiag_pcr.block_tridiag_solve_pcr
    for n in range(1, 4):
        before = solve.launches
        solve(D, U, b)
        assert solve.launches == before + 1, n
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_replays_in_cuda_graph():
    dev = _cuda()
    rng = np.random.default_rng(2)
    D, U, b = (torch.as_tensor(a, device=dev) for a in _problem(rng, 9, 448))
    solve = tridiag_pcr.block_tridiag_solve_pcr
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (build, occupancy query)
        solve(D, U, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = solve(D, U, b)
    for a, new in zip((D, U, b), _problem(rng, 9, 448)):
        a.copy_(torch.as_tensor(new, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    want = tridiag_pcr.block_tridiag_solve_pcr_plain(D, U, b)
    assert _rel(x, want) < 1e-9
    assert _rel(x, solve(D, U, b)) == 0.0


@pytest.mark.cuda
def test_kernel_shared_u_matches_batched_u():
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(np.random.default_rng(3), 4, 100))
    shared = tridiag_pcr.block_tridiag_solve_pcr(D, U[0].contiguous(), b)
    batched = tridiag_pcr.block_tridiag_solve_pcr(
        D, U[0].expand(4, -1, -1, -1).contiguous(), b)
    assert _rel(shared, batched) == 0.0


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous():
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(np.random.default_rng(4), 2, 8))
    with pytest.raises(ValueError):
        tridiag_pcr.block_tridiag_solve_pcr(D.transpose(-1, -2), U, b)


@pytest.mark.cuda
def test_ba_iteration_on_card_matches_cpu():
    dev = _cuda()
    rng = np.random.default_rng(5)
    N, M = 64, 448
    pos = rng.normal(size=(N, 3)) * 30 + np.array([6900.0, 0, 0])
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.normal(size=(N, 3)) * 0.1 + np.array([0, 7.5, 0])
    states = np.concatenate([pos, q, vel], axis=1)
    gaps = np.full(N, 120.0)
    gaps[-1] = 0.0
    cum = np.zeros((N, 4))
    cum[:, 3] = 1.0
    fields = dict(
        gaps=gaps, cum_rot=cum,
        landmarks_xyz=pos[rng.integers(0, N, M)] * 0.92,
        landmarks_uv=rng.uniform(0, 2000, size=(M, 2)),
        conf=rng.uniform(0.8, 1.0, M),
        ii=np.sort(rng.integers(0, N, M)), obs_valid=np.ones(M),
        knot_valid=np.ones(N), pair_valid=np.ones(N - 1),
        intrinsics=np.array([3547.85, 3547.85, 2304.0, 1296.0]))
    params = ba.SolverParams(batched_lambda=9, num_hops=2)
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = ba.ba_iteration(
            3, torch.as_tensor(states, device=d),
            ba.problem_from_numpy(fields, d), 1e-4, params=params)
    cpu, gpu = out["cpu"], out[str(dev)]
    assert float(cpu.lamda_init) == float(gpu.lamda_init)
    assert _rel(gpu.states.cpu(), cpu.states) < 1e-9
    assert _rel(gpu.mean_residual.cpu(), cpu.mean_residual) < 1e-8


def _projected_batch(d):
    """3 orbits of N=64 on one padded shape: nadir attitudes, landmarks
    below the track, pixels projected from the true states plus 0.5 px
    noise, the states 2 km off; the knots are random, so the dynamics
    factor fights the vision one."""
    from vinsat_tpu_torch.core import frames
    from vinsat_tpu_torch.estimation import factors

    rng = np.random.default_rng(6)
    N, M = 64, 448
    intr = np.array([3547.85, 3547.85, 2304.0, 1296.0])
    fields, states = [], []
    for _ in range(3):
        pos = rng.normal(size=(N, 3)) * 30 + np.array([6900.0, 0, 0])
        q = frames.nadir_quaternion(torch.as_tensor(pos)).numpy()
        vel = rng.normal(size=(N, 3)) * 0.1 + np.array([0, 7.5, 0])
        gt = np.concatenate([pos, q, vel], axis=1)
        ii = np.sort(rng.integers(0, N, M))
        lm = pos[ii] * (6378.0 / 6900.0) + rng.normal(size=(M, 3)) * 30
        uv = factors.project_landmarks(
            torch.as_tensor(gt), torch.as_tensor(lm), torch.as_tensor(ii),
            torch.as_tensor(intr)).numpy() + rng.normal(size=(M, 2)) * 0.5
        st = gt.copy()
        st[:, :3] += rng.normal(size=(N, 3)) * 2.0
        states.append(st)
        gaps = np.full(N, 120.0)
        gaps[-1] = 0.0
        cum = np.zeros((N, 4))
        cum[:, 3] = 1.0
        fields.append(dict(
            gaps=gaps, cum_rot=cum, landmarks_xyz=lm, landmarks_uv=uv,
            conf=rng.uniform(0.8, 1.0, M), ii=ii, obs_valid=np.ones(M),
            knot_valid=np.ones(N), pair_valid=np.ones(N - 1),
            intrinsics=intr))
    return (torch.as_tensor(np.stack(states), device=d),
            ba.stack_problems([ba.problem_from_numpy(f, d) for f in fields]),
            torch.full((3,), 1e-4, dtype=torch.float64, device=d),
            ba.SolverParams(num_hops=2))


@functools.lru_cache(maxsize=1)
def _simulated_seqs():
    from vinsat_tpu_torch import pipeline

    return [pipeline.simulate_sequence(s, 600, along_track=True,
                                       frame_stride=5, device="cpu")
            for s in range(3)]


def _simulated_batch(d):
    """The constellation's own batch of port seeds 0-2, 600 s along track
    (simulated on the CPU): states that follow the dynamics, 50 km of
    initial noise, N=128 knots (K1's path on the card)."""
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.estimation import window

    b = pipeline._prepare_constellation(range(3), _simulated_seqs(), 600,
                                        window.StreamingConfig(), None, None,
                                        d)
    return b.states0, b.prob, b.lamda, b.params


_BATCH_CASES = [
    # 2 vision-only iterations, then 2 with dynamics
    (_projected_batch, 2, 4),
    # dynamics from the first iteration: the vision-only iterations of a
    # noised arc move its knots hundreds of km along the lines of sight,
    # and the first dynamics iteration after them parts by ~1e-8 between
    # any two roundings
    (_simulated_batch, 0, 3)]


@pytest.mark.parametrize("make,init_iters,num_iters", _BATCH_CASES)
def test_batch_cases_are_well_conditioned(make, init_iters, num_iters):
    # on the CPU: the card test below holds the card to the CPU at 1e-9,
    # which measures the port only where the problem itself does not
    # amplify roundoff; a 1e-15 relative perturbation of the initial
    # states must move the result by far less
    from vinsat_tpu_torch.estimation import window

    states0, prob, lamda, params = make("cpu")
    noise = torch.as_tensor(
        np.random.default_rng(1).standard_normal(states0.shape))
    a, b = (window.solve_window_batch(s0, prob, lamda, init_iters,
                                      num_iters, params,
                                      sched_offset=-init_iters)
            for s0 in (states0, states0 * (1 + 1e-15 * noise)))
    assert torch.equal(a[1], b[1])
    assert _rel(b[0], a[0]) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("make,init_iters,num_iters", _BATCH_CASES)
def test_solve_window_batch_on_card_matches_cpu(make, init_iters, num_iters):
    # the sequential λ search over 3 orbits: K1 at B=3 on the card, its
    # twin on the CPU
    from vinsat_tpu_torch.estimation import window

    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        states0, prob, lamda, params = make(d)
        out[str(d)] = window.solve_window_batch(
            states0, prob, lamda, init_iters, num_iters, params,
            sched_offset=-init_iters)
    cpu, gpu = out["cpu"], out[str(dev)]
    assert torch.equal(cpu[1], gpu[1].cpu())
    assert _rel(gpu[0].cpu(), cpu[0]) < 1e-9
    assert _rel(gpu[3].cpu(), cpu[3]) < 1e-8


def _bench_window0(d, dtype):
    """Window 0 of the committed bench arc (tests/data/
    torch_stream_seed1.npz) as the f32 stream solves it: conditioned in
    f64 on the CPU, padded in `dtype` on d, warm-started from its f64 init
    phase (computed once, on the CPU).  (states0, prob, params)."""
    import os

    from vinsat_tpu_torch.estimation import ingest, window

    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_stream_seed1.npz"))
    cfg = window.StreamingConfig(dtype="float32")
    prep = window.prepare_stream(fx["det_rows"], fx["orbit_pos_eci_km"],
                                 int(fx["seed"]), cfg, device="cpu")
    t, i, _ = ingest.split_windows(prep.graph.ii, prep.knot_t)[0]
    g = prep.graph

    def pad(dev, dt):
        return window._pad_problem(
            prep.states0[:t], prep.gaps[:t], prep.cum_rot[:t],
            prep.gt.landmarks_xyz[:i], g.uv[:i], g.conf[:i], g.ii[:i],
            window.bucket(t), window.bucket(i, 64, 64), dev, dt)

    params = ba.SolverParams(num_hops=int(np.ceil(prep.gaps.max() / 100))
                             + 1, batched_lambda=9)
    st32, prob32 = pad("cpu", torch.float32)
    warm = window._window0_init_f64(st32, prob32, 1e-4, 10, params)
    return warm.to(device=d, dtype=dtype), pad(d, dtype)[1], params


@pytest.mark.cuda
def test_kernel_f32_on_stream_system():
    # the f32 stream's first K1 system (window 0 after its f64 init, B=9
    # λ candidates, N=64), recorded on the card, against the twin there
    dev = _cuda()
    states0, prob, params = _bench_window0(dev, torch.float32)
    seen = []
    launch = tridiag_pcr._launch

    def recording(D, U, b):
        seen.append([a.clone() for a in (D, U, b)])
        return launch(D, U, b)

    tridiag_pcr._launch = recording
    try:
        ba.ba_iteration(0, states0, prob, 1e-4, params=params)
    finally:
        tridiag_pcr._launch = launch
    assert len(seen) == 1 and seen[0][0].dtype == torch.float32
    D, U, b = seen[0]
    assert tuple(D.shape[:2]) == (9, 64)
    x = tridiag_pcr.block_tridiag_solve_pcr(D, U, b)
    xp = tridiag_pcr.block_tridiag_solve_pcr_plain(D, U, b)
    err = _rel(x, xp)
    print(f"K1 f32 on the stream's first system: rel err vs plain {err:.3e}")
    assert err < 1e-4


@pytest.mark.cuda
def test_f32_window_solve_on_card_matches_cpu():
    # 4 LM iterations of the f32 stream's window 0 from its f64 warm
    # start, batched λ search (K1 in f32 on the card, its twin on the CPU)
    from vinsat_tpu_torch.estimation import window

    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        states0, prob, params = _bench_window0(d, torch.float32)
        out[str(d)] = window._solve_window(
            states0, prob, 1e-4, 0, 4, params._replace(max_iters=0))
    cpu, gpu = out["cpu"], out[str(dev)]
    err = _rel(gpu[0].cpu(), cpu[0])
    print(f"f32 window 0, 4 iterations: card vs CPU rel err {err:.3e}, "
          f"λ {float(cpu[1])} / {float(gpu[1])}")
    assert err < 1e-5


def _k3_case(rng, F, L):
    """Boxes the size of a footprint (~4 x 2 deg) over landmark-dense
    boxes, some wrapped across the antimeridian, some empty or NaN."""
    lon = rng.uniform(-180.0, 180.0, L)
    lat = rng.uniform(-60.0, 60.0, L)
    c = np.stack([rng.choice(lon, F), rng.choice(lat, F)], axis=1)
    h = rng.uniform([1.5, 0.8], [2.5, 1.4], size=(F, 2))
    bounds = np.concatenate([c - h, c + h], axis=1)
    bounds[:64, 0] = rng.uniform(177.0, 179.5, 64)
    bounds[:64, 2] = bounds[:64, 0] + 4.0
    bounds[64] = [np.inf, np.inf, -np.inf, -np.inf]
    bounds[65, 1] = np.nan
    return bounds, lon, lat, rng.uniform(size=L) < 0.25


def _k3_regions(rng, F, shuffled):
    """The region-ordered synthetic DB (16 regions x 495 landmarks, the
    accepted ones as the simulator gates on), or the same DB in a seeded
    random order; F footprint-sized boxes (~8 x 4 deg) around landmarks."""
    db = landmarks.synthesize(1, device="cpu")
    lon, lat = db.lon.numpy(), db.lat.numpy()
    best = (db.best & mgrs.active_region_mask("cpu")[db.region]).numpy()
    if shuffled:
        p = rng.permutation(lon.size)
        lon, lat, best = lon[p], lat[p], best[p]
    c = rng.integers(0, lon.size, F)
    h = rng.uniform([3.5, 1.5], [4.5, 2.3], size=(F, 2))
    ctr = np.stack([lon[c], lat[c]], axis=1) + rng.normal(size=(F, 2))
    return np.concatenate([ctr - h, ctr + h], axis=1), lon, lat, best


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("db", ["uniform", "regions", "shuffled"])
def test_visible_count_matches_plain_full_size(db, dtype):
    dev = _cuda()
    rng = np.random.default_rng(7)
    if db == "uniform":
        bounds, lon, lat, best = _k3_case(rng, 10801, 7920)
    else:
        bounds, lon, lat, best = _k3_regions(rng, 10801, db == "shuffled")
    args = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (bounds, lon, lat)]
    args.append(torch.as_tensor(best, device=dev))
    before = visible_count.visible_count.launches
    got = visible_count.visible_count(*args)
    torch.cuda.synchronize()
    assert visible_count.visible_count.launches == before + 1
    want = visible_count.visible_count_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int((want > 0).sum()) > 1000
    if db == "uniform":
        assert int(want[64]) == int(want[65]) == 0
    assert torch.equal(visible_count.tile_boxes(*args[1:]),
                       visible_count.tile_boxes_plain(*args[1:]))


def _cull_case(order, seed=5):
    """L = 509 landmarks (the last of 4 tiles partial) region by region,
    one region across the antimeridian, landmarks at +-180, a whole tile
    with no accepted landmark; or the same DB shuffled.  F = 61 boxes the
    size of a footprint near the landmarks, some wrapped (lon_max > 180),
    some with a landmark on an edge, NaN and +-inf ones.  numpy f64."""
    rng = np.random.default_rng(seed)
    regions = [(-10.0, 40.0, -2.0, 44.0), (176.0, -20.0, 184.0, -16.0),
               (30.0, -5.0, 38.0, -1.0), (100.0, 60.0, 108.0, 64.0),
               (-75.0, 10.0, -67.0, 14.0)]
    per = [102, 102, 102, 102, 101]
    lon = np.concatenate([rng.uniform(r[0], r[2], n)
                          for r, n in zip(regions, per)])
    lat = np.concatenate([rng.uniform(r[1], r[3], n)
                          for r, n in zip(regions, per)])
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon[102], lon[103] = 180.0, -180.0
    best = rng.uniform(size=lon.size) < 0.6
    if order == "shuffled":
        p = rng.permutation(lon.size)
        lon, lat, best = lon[p], lat[p], best[p]
    best[256:384] = False  # a tile with no accepted landmark
    F = 61
    c = rng.integers(0, lon.size, F)
    w, h = rng.uniform(3.0, 5.0, F), rng.uniform(1.5, 2.5, F)
    bounds = np.stack([lon[c] - w, lat[c] - h, lon[c] + w, lat[c] + h], 1)
    bounds[:8, 0] = rng.uniform(174.0, 179.5, 8)  # wrapped boxes
    bounds[:8, 2] = bounds[:8, 0] + 8.0
    bounds[8] = [np.inf, np.inf, -np.inf, -np.inf]
    bounds[9] = [-np.inf, -np.inf, np.inf, np.inf]
    bounds[10, 2] = np.nan
    bounds[11] = [np.nan] * 4
    for k, j in ((12, 0), (13, 200), (14, 102), (15, 103)):
        bounds[k, 0], bounds[k, 1] = lon[j], lat[j]  # on the west / south
        bounds[k, 2], bounds[k, 3] = lon[j] + 6.0, lat[j] + 3.0
    bounds[16, 2], bounds[16, 3] = lon[300], lat[300]  # on east / north
    bounds[16, 0], bounds[16, 1] = lon[300] - 6.0, lat[300] - 3.0
    return bounds, lon, lat, best


def _onto_tile_box_edges(bounds, boxes):
    """bounds with frames 17-22 moved onto edges of the tile boxes
    (lon_min, lon_max, lonw_min, lonw_max, lat_min, lat_max) given."""
    bounds = bounds.clone()
    for k, (col, t, e) in enumerate(((2, 0, 0), (0, 1, 1), (3, 2, 4),
                                     (1, 3, 5), (2, 3, 2), (0, 0, 3))):
        if torch.isfinite(boxes[t, e]):
            bounds[17 + k, col] = boxes[t, e]
    return bounds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", ["regions", "shuffled"])
def test_visible_count_adversarial_small(order, dtype):
    dev = _cuda()
    bounds, lon, lat, best = _cull_case(order)
    args = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (bounds, lon, lat)]
    args.append(torch.as_tensor(best, device=dev))
    boxes = visible_count.tile_boxes(*args[1:])
    assert torch.equal(boxes, visible_count.tile_boxes_plain(*args[1:]))
    args[0] = _onto_tile_box_edges(args[0], boxes)
    for F in (61, 1, 33):  # F not a multiple of a warp or of a block
        sub = [args[0][:F].contiguous(), *args[1:]]
        got = visible_count.visible_count(*sub)
        assert torch.equal(got, visible_count.visible_count_plain(*sub))
    assert int(got[8]) == 0 and int(got[9]) == int(best.sum())


@pytest.mark.cuda
def test_visible_count_kernels_per_call_and_graph():
    dev = _cuda()
    rng = np.random.default_rng(12)
    cases = [_k3_regions(rng, 2000, False), _k3_regions(rng, 2000, True)]
    inputs = [torch.as_tensor(a, device=dev) for a in cases[0]]
    fresh = [torch.as_tensor(a, device=dev) for a in cases[1]]
    assert _device_kernels(
        lambda: visible_count.visible_count(*inputs)) == 2
    out, eager = _replays(visible_count.visible_count, inputs, fresh)
    assert torch.equal(out, eager)
    assert torch.equal(out, visible_count.visible_count_plain(*fresh))


@pytest.mark.cuda
def test_visible_count_rejects_non_contiguous():
    dev = _cuda()
    bounds, lon, lat, best = _k3_case(np.random.default_rng(8), 100, 300)
    b = torch.as_tensor(bounds, device=dev)
    with pytest.raises(ValueError):
        visible_count.visible_count(
            b.t().contiguous().t(), torch.as_tensor(lon, device=dev),
            torch.as_tensor(lat, device=dev),
            torch.as_tensor(best, device=dev))


def _k2_case(rng, N, D=4):
    w = rng.random((N, D))
    w[::5, -1] = 0.0
    return rng.normal(size=(N, D, 2, 9)) * 50.0, rng.normal(size=(N, D, 2)), w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f32,tol", [(torch.float64, False, 1e-12),
                                           (torch.float64, True, 1e-5),
                                           (torch.float32, False, 1e-5)])
def test_normal_eq_matches_plain(dtype, f32, tol):
    dev = _cuda()
    args = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in _k2_case(np.random.default_rng(9), 2168)]
    before = normal_eq.assemble_normal_eq.launches
    G, g = normal_eq.assemble_normal_eq(*args, f32=f32)
    torch.cuda.synchronize()
    assert normal_eq.assemble_normal_eq.launches == before + 1
    assert G.dtype == g.dtype == dtype
    G_p, g_p = normal_eq.assemble_normal_eq_plain(*args, f32=f32)
    assert _rel(G, G_p) < tol and _rel(g, g_p) < tol
    # the kernel against the f64 sums of the same inputs
    G64, _ = normal_eq.assemble_normal_eq_plain(*(a.double() for a in args))
    assert _rel(G.double(), G64) < (1e-12 if tol < 1e-6 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(1, 4), (5, 1), (13, 12), (2169, 4),
                                 (7, 7), (3, 13), (2, 2)])
def test_normal_eq_ragged_shapes(N, D):
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev)
            for a in _k2_case(np.random.default_rng(N), N, D)]
    G, g = normal_eq.assemble_normal_eq(*args)
    G_p, g_p = normal_eq.assemble_normal_eq_plain(*args)
    torch.cuda.synchronize()
    assert G.is_contiguous() and g.is_contiguous()
    assert _rel(G, G_p) < 1e-12 and _rel(g, g_p) < 1e-12
    G32, g32 = normal_eq.assemble_normal_eq(*args, f32=True)
    G32_p, g32_p = normal_eq.assemble_normal_eq_plain(*args, f32=True)
    assert _rel(G32, G32_p) < 1e-5 and _rel(g32, g32_p) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f32,tol", [(torch.float64, False, 1e-12),
                                           (torch.float64, True, 1e-5),
                                           (torch.float32, False, 1e-5)])
@pytest.mark.parametrize("D", [1, 3, 8, 64, 65, 128, 201, 256])
def test_normal_eq_any_d(D, dtype, f32, tol):
    """Budgets past one staged chunk of 64 slots (the sharded stream's
    d_pad is a power of two of the busiest knot): 65 and 201 leave a
    ragged last chunk at an odd offset; an odd N misaligns every other
    knot's rows."""
    dev = _cuda()
    args = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in _k2_case(np.random.default_rng(D), 301, D)]
    G, g = normal_eq.assemble_normal_eq(*args, f32=f32)
    G_p, g_p = normal_eq.assemble_normal_eq_plain(*args, f32=f32)
    torch.cuda.synchronize()
    assert _rel(G, G_p) < tol and _rel(g, g_p) < tol, (D, dtype, f32)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
def test_normal_eq_one_kernel_per_call_and_graph(f32):
    dev = _cuda()
    rng = np.random.default_rng(13)
    inputs = [torch.as_tensor(a, device=dev) for a in _k2_case(rng, 2168)]
    fresh = [torch.as_tensor(a, device=dev) for a in _k2_case(rng, 2168)]
    call = lambda J, r, w: normal_eq.assemble_normal_eq(  # noqa: E731
        J, r, w, f32=f32)
    assert _device_kernels(lambda: call(*inputs)) == 1
    (G, g), (G_e, g_e) = _replays(call, inputs, fresh)
    assert torch.equal(G, G_e) and torch.equal(g, g_e)
    G_p, _ = normal_eq.assemble_normal_eq_plain(*fresh, f32=f32)
    assert _rel(G, G_p) < (1e-5 if f32 else 1e-12)


@pytest.mark.cuda
def test_normal_eq_rejects_non_contiguous():
    dev = _cuda()
    J, r, w = (torch.as_tensor(a, device=dev)
               for a in _k2_case(np.random.default_rng(10), 8))
    with pytest.raises(ValueError):
        normal_eq.assemble_normal_eq(J.transpose(0, 1).contiguous()
                                     .transpose(0, 1), r, w)


@pytest.mark.cuda
def test_sharded_step_on_card_matches_cpu():
    dev = _cuda()
    rng = np.random.default_rng(11)
    B, P, Nl, D = 2, 4, 6, 4
    N = P * Nl
    states = np.zeros((B, N, 10))
    states[..., :3] = rng.normal(size=(B, N, 3)) * 30 + [6900.0, 0, 0]
    q = rng.normal(size=(B, N, 4))
    states[..., 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    states[..., 7:] = rng.normal(size=(B, N, 3)) * 0.1 + [0, 7.5, 0]
    cum = np.zeros((B, N, 4))
    cum[..., 3] = 1.0
    pv = np.ones((B, N))
    pv[:, -1] = 0.0
    ground = states[..., None, :3] * 0.92
    fields = dict(
        states=states, gaps=np.full((B, N), 60.0), cum_rot=cum,
        lm_xyz=ground + rng.normal(size=(B, N, D, 3)) * 30.0,
        uv=rng.uniform(0, 2000, size=(B, N, D, 2)),
        conf=rng.uniform(0.8, 1.0, size=(B, N, D)),
        obs_valid=np.ones((B, N, D)), pair_valid=pv,
        intrinsics=np.array([3547.85, 3547.85, 2304.0, 1296.0]))
    params = ba.SolverParams(num_hops=2)
    out = {}
    for d in ("cpu", dev):
        prob = sharded_ba.sharded_problem_from_numpy(fields, P, d)
        step = sharded_ba.make_sharded_ba_step(mesh.make_mesh(1, P, d),
                                               params)
        out[str(d)] = step(3, torch.full((B,), 1e-4, dtype=torch.float64,
                                         device=d), prob)
    (st_c, lam_c), (st_g, lam_g) = out["cpu"], out[str(dev)]
    assert torch.equal(lam_c, lam_g.cpu())
    assert _rel(st_g.cpu(), st_c) < 1e-9


def _projected_sharded(d):
    """One orbit of N = 8 x 8 knots over P = 8 arc shards, D = 8 slots a
    knot: knots 10 s apart on a circular orbit, nadir attitudes, landmarks
    below each knot, pixels projected from the true states plus 0.5 px
    noise, the states 2 km off, a prior on the first 3 knots 0.01 km off
    the truth (random SPD information)."""
    from vinsat_tpu_torch.core import frames
    from vinsat_tpu_torch.estimation import factors

    rng = np.random.default_rng(12)
    P, Nl, D = 8, 8, 8
    N = P * Nl
    intr = np.array([3547.85, 3547.85, 2304.0, 1296.0])
    r, w = 6900.0, np.sqrt(398600.4418 / 6900.0 ** 3)
    c, s = np.cos(w * 10.0 * np.arange(N)), np.sin(w * 10.0 * np.arange(N))
    pos = r * np.stack([c, s, np.zeros(N)], axis=1)
    vel = r * w * np.stack([-s, c, np.zeros(N)], axis=1)
    q = frames.nadir_quaternion(torch.as_tensor(pos)).numpy()
    gt = np.concatenate([pos, q, vel], axis=1)
    lm = (pos[:, None] * (6378.0 / 6900.0)
          + rng.normal(size=(N, D, 3)) * 30).reshape(N * D, 3)
    ii = np.repeat(np.arange(N), D)
    uv = factors.project_landmarks(
        torch.as_tensor(gt), torch.as_tensor(lm), torch.as_tensor(ii),
        torch.as_tensor(intr)).numpy() + rng.normal(size=(N * D, 2)) * 0.5
    states = gt.copy()
    states[:, :3] += rng.normal(size=(N, 3)) * 2.0
    cum = np.zeros((N, 4))
    cum[:, 3] = 1.0
    pv = np.ones(N)
    pv[-1] = 0.0
    fields = {k: v[None] for k, v in dict(
        states=states, gaps=np.full(N, 10.0), cum_rot=cum,
        lm_xyz=lm.reshape(N, D, 3), uv=uv.reshape(N, D, 2),
        conf=rng.uniform(0.8, 1.0, (N, D)), obs_valid=np.ones((N, D)),
        pair_valid=pv, knot_valid=np.ones(N)).items()}
    fields["intrinsics"] = intr
    val = np.zeros((1, N))
    val[:, :3] = 1.0
    A = rng.normal(size=(1, N, 6, 6))
    prop = gt[None].copy()
    prop[..., :3] += 0.01
    prior = (prop, A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6),
             np.tile(np.eye(3) * 100.0, (1, N, 1, 1)), val)
    prob = sharded_ba.sharded_problem_from_numpy(fields, P, d)
    pri = sharded_ba.ShardedPrior(*(
        torch.as_tensor(a, device=d).reshape((1, P, Nl) + a.shape[2:])
        for a in prior))
    # 2 vision-only iterations, then 2 with dynamics; run to max_iters 4,
    # the best iterate from the init phase's end (iteration 2) on
    solve = sharded_ba.make_sharded_window_solver(
        mesh.make_mesh(1, P, d), ba.SolverParams(num_hops=2, max_iters=4),
        num_iters=2, init_iters=2, with_prior=True)
    return solve, prob, pri, torch.full((1,), 1e-4, dtype=torch.float64,
                                        device=d)


def test_sharded_solver_case_is_well_conditioned():
    # on the CPU, as test_batch_cases_are_well_conditioned: a 1e-15
    # relative perturbation of the initial states must move the result far
    # less than the card test's 1e-9
    solve, prob, pri, lam = _projected_sharded("cpu")
    noise = torch.as_tensor(
        np.random.default_rng(1).standard_normal(prob.states.shape))
    a, b = (solve(lam, prob._replace(states=s0), pri)
            for s0 in (prob.states, prob.states * (1 + 1e-15 * noise)))
    assert torch.equal(a[1], b[1])
    assert _rel(b[0], a[0]) < 1e-10


@pytest.mark.cuda
def test_sharded_window_solver_with_prior_on_card_matches_cpu():
    """The sharded window solver with a prior, run to max_iters with the
    best-iterate tracker, on the card against the CPU: states and the
    residual 1e-9 relative, λ equal."""
    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        solve, prob, pri, lam = _projected_sharded(d)
        out[str(d)] = solve(lam, prob, pri)
    (st_c, lam_c, res_c), (st_g, lam_g, res_g) = out["cpu"], out[str(dev)]
    assert torch.equal(lam_c, lam_g.cpu())
    assert _rel(st_g.cpu(), st_c) < 1e-9
    assert _rel(res_g.cpu(), res_c) < 1e-9


@pytest.mark.cuda
def test_early_stop_loop_on_card_matches_cpu():
    """The early stop's host loop on CUDA tensors (one sync a step) stops
    each orbit where it does on the CPU: a scripted step whose λ counts
    the iterations."""
    dev = _cuda()
    from vinsat_tpu_torch.estimation import window

    rng = np.random.default_rng(13)
    r = 10.0 * 0.95 ** np.arange(40)[None] * np.ones((4, 1))
    for b in range(4):
        flat = int(rng.integers(6, 30))
        r[b, flat:] = r[b, flat] * (1.0 + 0.004 * rng.random(40 - flat))
    params = ba.SolverParams(max_iters=40, conv_patience=3, conv_rtol=0.01)
    out = {}
    for d in ("cpu", dev):
        t = torch.as_tensor(r, device=d)

        def step_i(i, states, lam, t=t):
            return ba.BAStep(states + 1.0, lam + 1.0,
                             torch.zeros((4, 9, 9), dtype=t.dtype,
                                         device=t.device), t[:, i])

        out[str(d)] = window._lm_loop(
            step_i, torch.zeros((4, 3, 10), dtype=torch.float64, device=d),
            0.0, 2, 5, params)
    for c, g in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(g.cpu(), c)
    assert len(set(out["cpu"][1].tolist())) >= 2  # orbits stopped apart
