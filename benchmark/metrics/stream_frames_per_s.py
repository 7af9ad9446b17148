"""stream_frames_per_s: arc seconds at 1 Hz solved per wall second:
the frames of every stream completed in the window over the wall from
the window's start to the last completion.  A stream that the fast path
handed to the sync path counts with its whole time."""
UNIT = "frames/s"


def read(run):
    return run.frames_per_s() if run.task == "stream" else None
