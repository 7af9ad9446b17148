"""A run of each cell with the chip's look skipped (on the CPU, at a
test's size) and the timed path broken underneath comes out not
correct; unbroken it comes out correct.  The faults a one-chip cell can
have: a step that returns its state unchanged, and an answer altered
where it is produced.  (No cell exchanges between chips.)"""
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import small_cell


def _run(name):
    cell = small_cell(name)
    out, checks = harness.run_cell(cell, 2**33 + 7, 0.0, False,
                                   torch.device("cpu"), time.perf_counter())
    return out


def _unchanged_lm_step(monkeypatch):
    from vinsat_tpu_torch.estimation import ba

    def step(sched_iter, states, prob, lamda_init, params=None,
             initialize=False):
        lam = torch.as_tensor(lamda_init, dtype=states.dtype)
        return ba.BAStep(states, lam, torch.zeros(9, 9, dtype=states.dtype),
                         torch.zeros((), dtype=states.dtype))

    monkeypatch.setattr(ba, "ba_iteration", step)


def _altered_propagation(monkeypatch):
    from vinsat_tpu_torch.estimation import window

    orig = window._propagate_impl

    def prop(state10, omega_seq, length):
        out = orig(state10, omega_seq, length).clone()
        out[-1, 0] += 1e-3  # one knot's position moved by a metre
        return out

    monkeypatch.setattr(window, "_propagate_impl", prop)


def _unchanged_rk4_step(monkeypatch):
    from vinsat_tpu_torch.core import dynamics

    monkeypatch.setattr(dynamics, "rk4_step", lambda x, h, tb=False: x)


def _altered_row(monkeypatch):
    from vinsat_tpu_torch.sim import detections

    orig = detections.to_rows

    def to_rows(dets, db, frame_stride=1):
        rows = orig(dets, db, frame_stride)
        rows[len(rows) // 2, 3] += 0.25  # one pixel a quarter off
        return rows

    monkeypatch.setattr(detections, "to_rows", to_rows)


@pytest.mark.parametrize("cell, fault", [
    ("bench_arc_f64.montecarlo", None),
    ("bench_arc_f64.montecarlo", _unchanged_lm_step),
    ("bench_arc_f64.montecarlo", _altered_propagation),
    ("bench_arc_sim.dataset", None),
    ("bench_arc_sim.dataset", _unchanged_rk4_step),
    ("bench_arc_sim.dataset", _altered_row),
])
def test_fault_makes_the_run_not_correct(monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    out = _run(cell)
    assert out["correct"] is (fault is None), out["checks"]
