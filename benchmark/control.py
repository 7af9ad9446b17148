"""The readings a cell's limits are set from (the benchmark's own runs do
not run this):

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 3]

For each seed, in one process, the cell's task is set up as a run sets
it up (without the warm-up) and request 0 is made: the numbers that
decide `correct` are printed for the program against the reference (the
lower reading's runs) and, for the first --control-seeds seeds, for the
control against the same reference (the upper reading's): the program's
float32 stream for a stream cell, the reference computed in float32 for
a simulator cell.  One JSON line a seed."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, control: bool, device):
    from benchmark import harness

    mod = harness.load_task(cell.config["task"])
    task = mod.Task(cell.config, cell.traffic, seed, device)
    t0 = time.perf_counter()
    task.setup()
    t1 = time.perf_counter()
    task.request(0)
    task.sync()
    t2 = time.perf_counter()
    got = task.results[0]
    task.window_closed([0])
    want = task.reference(0)
    t3 = time.perf_counter()
    line = {"seed": seed, "setup_s": t1 - t0, "request_s": t2 - t1,
            "reference_s": t3 - t2,
            "program": dict(mod.compare(task.results[0], want))}
    if hasattr(got, "sync_rerun"):
        line["sync_rerun"] = bool(got.sync_rerun)
    if control:
        line["control"] = dict(mod.compare(task.control(0), want))
        line["control_s"] = time.perf_counter() - t3
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    torch.set_num_threads(2)
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda")
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        line = readings(cell, s, i < args.control_seeds, device)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
