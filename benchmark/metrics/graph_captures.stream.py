"""graph_captures.stream: CUDA graphs the program captured during the
window (estimation/graphs.stats["captures"]).  0 while every window
program of the arc stays cached; a change that breaks the cache shows
here before it shows in stream_frames_per_s."""
UNIT = "count"
LAYER = "program cache (estimation/graphs)"
MOVES = "stream_frames_per_s"


def read(run):
    return run.counters.get("graph_captures")
