"""kernels_per_arc.stream: device kernels launched in the traced
request, per arc (the LM iterations' graphs, the propagation's RK4
steps, the tail's refinement).  A count from the profiler's trace,
which the profiler's own cost does not change; at about 1.6 us a
kernel, the arc's device time follows it."""
UNIT = "count"
LAYER = "LM iterations on the device (estimation/ba, factors, refine)"
MOVES = "stream_frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t.requests or not t.kernels:
        return None
    return sum(v[1] for v in t.kernels.values()) / t.requests
