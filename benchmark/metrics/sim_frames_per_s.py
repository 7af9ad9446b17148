"""sim_frames_per_s: simulated arc seconds at 1 Hz per wall second: the
frames of every arc simulated in the window over the wall from the
window's start to the last completion."""
UNIT = "frames/s"


def read(run):
    return run.frames_per_s() if run.task == "simulate" else None
