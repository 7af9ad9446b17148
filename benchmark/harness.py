"""The benchmark's core, shared by every cell: it finds the cell's
configuration, traffic mix, task and metrics by their names in
BENCHMARK.json, runs the closed loop of requests for the window, reduces
the profiler's trace, computes the metrics, decides `correct` and prints
the result line.  Nothing here knows a cell, a configuration or a
metric by name; each lives in a file of its own (README.md)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vinsat_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: List[dict]  # the manifest's metrics this cell reports
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration file,
    its traffic file (benchmark/traffic/<traffic>.json) and the metrics
    it reports."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    if (traffic.get("loop"), traffic.get("clients")) != ("closed", 1):
        raise ValueError(f"traffic {w['traffic']!r}: the generator runs a "
                         "closed loop of one client")
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def load_metric(name: str):
    """benchmark/metrics/<name>.py as a module (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._m_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_task(name: str):
    """benchmark/tasks/<name>.py: the adapter between the loop and the
    program's entry point."""
    return importlib.import_module(f"benchmark.tasks.{name}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (compared whole: vinsat_tpu_torch is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Request(NamedTuple):
    index: int
    start: float  # host clock, s
    end: float
    frames: int
    ok: bool
    info: dict


class Run:
    """What the metrics read: the window's requests, its counters, the
    reduced trace (traced runs) and the set-up time."""

    def __init__(self, task_name: str, setup_s: float, window_start: float,
                 requests: List[Request], counters: Dict[str, float],
                 trace=None):
        self.task = task_name
        self.setup_s = setup_s
        self.window_start = window_start
        self.requests = requests
        self.counters = counters
        self.trace = trace

    @property
    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.ok]

    def frames_per_s(self) -> Optional[float]:
        """Frames of the completed requests over the wall from the
        window's start to the last completion."""
        done = self.completed
        if not done:
            return None
        wall = max(r.end for r in done) - self.window_start
        return sum(r.frames for r in done) / wall


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class Trace(NamedTuple):
    window_s: float  # the traced window, host clock
    busy_s: float  # union of device activity inside it
    kernel_s: float  # sum of kernel durations inside it
    requests: int  # requests the window holds
    kernels: Dict[str, List[float]]  # kernel name -> [seconds, count]
    host_calls: Dict[str, int]  # CUDA runtime calls of the main thread
    device_ops: List[list]  # [name, seconds], the ten longest in total
    idle_gaps: List[list]  # [host activity, seconds], the ten longest
    k1_shapes: List[tuple]  # (B, N, dtype name) of each K1 launch


# device activity: kernels, copies, fills ("" where torch does not say)
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset", "")
# host spans the profiler mirrors on the device's timeline
_ANNOTATIONS = ("bench.", "ProfilerStep")


def _kind(e) -> str:
    try:
        return str(e.activity_type()).split(".")[-1].lower()
    except (AttributeError, RuntimeError):
        return ""


class Profiler:
    """torch's kineto profiler of device activity (kernels, copies, fills),
    the CUDA runtime calls that launch it, and the benchmark's own
    record_function spans, started at construction.  It records no
    operator of the program on the host (only the user scope), which
    would stretch a traced request.  stop() returns the raw events
    without the per-event Python objects torch.profiler builds (a traced
    stream holds about half a million kernels)."""

    def __init__(self):
        import torch
        from torch._C._profiler import RecordScope

        cuda = torch.cuda.is_available()
        p = torch.autograd.profiler.profile(
            use_kineto=True, use_cpu=True,
            use_device="cuda" if cuda else None)
        p._prepare_trace()
        torch.autograd._enable_profiler(p.config(), p.kineto_activities,
                                        {RecordScope.USER_SCOPE})

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return torch.autograd._disable_profiler().events()


def reduce_trace(events, span: str, requests: int, k1_shapes) -> Trace:
    """Busy and idle time of the device inside the host span named `span`
    (a record_function of the benchmark's), kernel time and launches by
    name, the CUDA runtime calls of the span's thread by name, and each
    idle gap named by what that thread was doing at its middle: the
    innermost benchmark span and the innermost runtime call in it."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    cpu, dev = [], []
    window = None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            # the device's copies of host spans are no device activity
            if not name.startswith(_ANNOTATIONS) and _kind(e) in _DEVICE_KINDS:
                dev.append((e.start_ns(), e.end_ns(), name))
        else:
            if name == span:
                window = (e.start_ns(), e.end_ns(), e.start_thread_id())
            cpu.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no span {span!r}")
    w0, w1, tid = window
    busy_iv, kernel_ns, kernels = [], 0, {}
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy_iv.append((s, e))
        if not name.startswith(("Memcpy", "Memset")):
            kernel_ns += e - s
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (e - s) * 1e-9
            k[1] += 1
    busy_iv.sort()
    busy_ns, gaps, cur_s, cur_e = 0, [], w0, w0
    for s, e in busy_iv:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ns += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    host = sorted((s, -e, name) for s, e, name, t in cpu
                  if t == tid and e > w0 and s < w1)
    calls: Dict[str, int] = {}
    for s, e, name, t in cpu:
        if t == tid and s >= w0 and e <= w1 and name.startswith("cuda"):
            calls[name] = calls.get(name, 0) + 1
    named: Dict[str, float] = {}
    stack: List[tuple] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            stack.append((host[i][0], -host[i][1], host[i][2]))
            i += 1
        stack = [h for h in stack if h[1] >= mid]
        outer = next((h[2] for h in reversed(stack)
                      if h[2].startswith("bench.")), "outside")
        inner = stack[-1][2] if stack else "nothing"
        key = outer if inner == outer else f"{outer} / {inner}"
        named[key] = named.get(key, 0.0) + (g1 - g0) * 1e-9
    ops = sorted(([n, v[0]] for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    idle = sorted(([n, v] for n, v in named.items()), key=lambda x: -x[1])
    return Trace((w1 - w0) * 1e-9, busy_ns * 1e-9, kernel_ns * 1e-9,
                 requests, kernels, calls, [[n[:160], s] for n, s in ops],
                 [[n[:160], s] for n, s in idle[:10]], list(k1_shapes))


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float):
    """Set up the cell's task, warm it with one request, run the window
    (with --trace 1 its first request traced), check the sampled requests
    against the reference and reduce the metrics.  Returns the result
    line's object and the lines of checks."""
    import torch

    t0 = time.perf_counter()
    task = load_task(cell.config["task"]).Task(cell.config, cell.traffic,
                                               seed, device)
    task.setup()
    t1 = time.perf_counter()
    task.warm()
    before = task.counters()
    requests: List[Request] = []
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    print(f"setup: {setup_s:.4f} s: process start to the harness "
          f"{t0 - t_process:.4f} s, task set-up {t1 - t0:.4f} s, warm-up "
          f"request {t_start - t1:.4f} s", file=sys.stderr)
    traced = None
    k = 0
    while time.perf_counter() - t_start < seconds or k == 0:
        if trace and k == 0:
            prof = Profiler()
            span = torch.profiler.record_function("bench.traced")
            span.__enter__()
            task.trace_begin()
        ev0 = _event(device)
        c0, t0 = time.process_time(), time.perf_counter()
        try:
            with torch.profiler.record_function("bench.request"):
                frames, info = task.request(k)
            ok = True
        except Exception as err:  # a failed request counts as failed
            print(f"request {k} failed: {err!r}", file=sys.stderr)
            frames, info, ok = 0, {}, False
        t1, c1 = time.perf_counter(), time.process_time()
        ev1 = _event(device)
        requests.append(Request(k, t0, t1, frames, ok, info))
        dev_s = (ev0.elapsed_time(ev1) * 1e-3 if ev0 is not None
                 else float("nan"))
        print(f"request {k}: {t1 - t0:.4f} s wall, {c1 - c0:.4f} s host "
              f"CPU, {dev_s:.4f} s between its device events",
              file=sys.stderr)
        if trace and k == 0:
            task.sync()
            k1 = task.trace_end()
            span.__exit__(None, None, None)
            t_stop = time.perf_counter()
            events = prof.stop()
            t_red = time.perf_counter()
            traced = reduce_trace(events, "bench.traced", 1, k1)
            print(f"trace: {len(events)} events, stop {t_red - t_stop:.1f} s,"
                  f" reduction {time.perf_counter() - t_red:.1f} s; "
                  f"{sum(v[1] for v in traced.kernels.values())} kernels, "
                  f"runtime calls {traced.host_calls}", file=sys.stderr)
            prof = events = None
            for name, (sec, n) in sorted(traced.kernels.items(),
                                         key=lambda x: -x[1][0])[:30]:
                print(f"kernel: {sec:.6f} s, {n} launches, {name[:120]}",
                      file=sys.stderr)
        k += 1
    task.sync()
    after = task.counters()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    counters = {n: after[n] - before[n] for n in after}
    run = Run(cell.config["task"], setup_s, t_start, requests, counters,
              traced)
    task.window_closed([r.index for r in requests if r.ok])
    rng = random.Random(seed)
    done = [r.index for r in requests if r.ok]
    n_check = min(int(cell.traffic.get("check_requests", 1)), len(done))
    sample = sorted(rng.sample(done, n_check)) if done else []
    checks = task.check(sample) if sample else [("checked_requests", 0, 1)]
    failed = sum(not r.ok for r in requests)
    correct = (failed == 0 and bool(sample)
               and all(v <= lim for _, v, lim in checks))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = load_metric(m["name"])
        if mod.UNIT != m["unit"]:
            raise RuntimeError(f"metric {m['name']}: unit {mod.UNIT!r} in "
                               f"its file, {m['unit']!r} in BENCHMARK.json")
        v = mod.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(requests), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced is not None:
        out["device"]["busy_s"] = traced.busy_s
        out["device"]["window_s"] = traced.window_s
        out["breakdown"] = {"device_ops": traced.device_ops,
                            "idle_gaps": traced.idle_gaps}
    out["checks"] = {n: {"value": finite(v), "limit": lim}
                     for n, v, lim in checks}
    return out, checks


def _event(device):
    """A CUDA event recorded now on the device's stream (None off a
    card)."""
    import torch

    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def format_check(name: str, value: float, limit: float) -> str:
    ok = "ok" if value <= limit else "FAILED"
    return f"check {name} = {value!r} (limit {limit!r}) {ok}"


def finite(v: float) -> float:
    """A JSON-safe number: inf and NaN become 1e308."""
    return v if math.isfinite(v) else 1e308
