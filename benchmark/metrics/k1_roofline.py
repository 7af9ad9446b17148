"""k1_roofline: kernel K1's share of its roofline in the
traced window, %: the least time for the work of every K1 launch the
program reported (tridiag_pcr.launched, by (B, N, dtype)), counted by
k1_work.py and summed, over the profiler's time of K1's kernel
(pcr_solve).  Bytes bound every launch of the stream."""
from benchmark.metrics import k1_work

UNIT = "%"
LAYER = "kernel K1 (kernels/tridiag_pcr)"
MOVES = "stream_frames_per_s"
KERNEL = "pcr_solve"


def read(run):
    t = run.trace
    if t is None or not t.k1_shapes:
        return None
    busy = sum(v[0] for n, v in t.kernels.items() if KERNEL in n)
    if busy <= 0:
        return None
    least = sum(k1_work.min_seconds(b, n, d) for b, n, d in t.k1_shapes)
    return 100.0 * least / busy
