"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It needs a CUDA card: without one, or with
fewer than the cell asks for, it exits with code 2 and prints no result.
The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers that decided `correct`, each with
its limit."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark import harness

    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    print(f"start: torch imported and the card found "
          f"{time.perf_counter() - T_PROCESS:.4f} s after the process started",
          file=sys.stderr)
    out, checks = harness.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0),
                                   T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(harness.format_check(name, value, limit), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
