"""The control of each cell fails the cell's limits, at a size a test run
holds: the program's float32 stream for the stream cell, the reference
computed in float32 for the simulator cell.  The same readings at the
cells' own sizes, on the card, set the limits (PERF.md)."""
import numpy as np
import torch

from benchmark import harness
from benchmark.tests.small import small_cell


def _fails(cell, gaps):
    limits = cell.config["limits"]
    return [n for n, v in gaps if v > limits[n]]


def test_stream_control_fails_and_program_passes():
    cell = small_cell("bench_arc_f64.montecarlo")
    mod = harness.load_task("stream")
    task = mod.Task(cell.config, cell.traffic, 2**34 + 3,
                    torch.device("cpu"))
    task.setup()
    task.request(0)
    want = task.reference(0)
    assert _fails(cell, mod.compare(task.results[0], want)) == []
    assert _fails(cell, mod.compare(task.control(0), want))


def test_simulator_control_fails_and_program_passes():
    cell = small_cell("bench_arc_sim.dataset")
    mod = harness.load_task("simulate")
    task = mod.Task(cell.config, cell.traffic, 2**34 + 3,
                    torch.device("cpu"))
    task.setup()
    task.request(0)
    task.window_closed([0])
    want = task.reference(0)
    assert _fails(cell, mod.compare(task.results[0], want)) == []
    control = task.control(0)
    assert control["pos_eci"].dtype == np.float64
    assert _fails(cell, mod.compare(control, want))
