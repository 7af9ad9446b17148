"""graph_launches_per_arc.sim: cudaGraphLaunch calls of the main thread
in the traced request, per arc: how often the host hands the device a
captured graph.  A count from the profiler's trace, which the profiler's
own cost does not change."""
UNIT = "count"
LAYER = "graph launches from the host (CUDA runtime)"
MOVES = "sim_frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t.requests or not t.host_calls:
        return None
    return t.host_calls.get("cudaGraphLaunch", 0) / t.requests
