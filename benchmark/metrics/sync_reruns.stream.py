"""sync_reruns.stream: streams of the window whose fast path found a
window non-finite or above the RMS gate and ran again on the sync path
(StreamingResult.sync_rerun)."""
UNIT = "count"
LAYER = "stream loop (estimation/window)"
MOVES = "stream_frames_per_s"


def read(run):
    if run.task != "stream":
        return None
    return sum(bool(r.info.get("sync_rerun")) for r in run.completed)
