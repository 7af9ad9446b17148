"""kernels_per_arc.sim: device kernels launched in the traced request,
per arc (the rollouts' RK4 steps, the detections, kernel K3).  A count
from the profiler's trace, which the profiler's own cost does not
change; at about 1.2 us a kernel, the arc's device time follows it."""
UNIT = "count"
LAYER = "simulator on the device (pipeline.simulate_from_draws)"
MOVES = "sim_frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t.requests or not t.kernels:
        return None
    return sum(v[1] for v in t.kernels.values()) / t.requests
