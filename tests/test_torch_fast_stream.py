"""The stream's async fast dispatch (`window.stream_orbit(fast=None)`, the
default in the plain growing-prefix mode) on the CPU: the fast path equals
`fast=False` bit for bit.

On a short gapped arc from the port's generator (3 windows and a tail
knot, so the tail refinement runs), at a few LM iterations: final states,
times, errors and knot times equal in f64, with the reduced later-window
budget, the card's batched λ search and the early stop (which the fast
path runs frozen to max_iters), and in f32.  The forced sync re-run and
the port's default against JAX's are in test_torch_fast_stream_rerun.py,
the `fast_ok` rule in test_torch_fast_stream_rule.py: each file that
streams holds at most three tests, because xdist's loadfile queues files
by test count and those of three or fewer start after the suite's longest
file (tests/test_learned_detector.py).  The card's side (captured LM
iterations and K1 against their eager runs, K1's launches counted through
replays) is in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ba, window

# passes of 120 s every 400 s: windows at 0, 400 and 800 s, and a filler
# knot at 1000 s after the last detection (the tail)
SIM_KW = dict(duration_s=1100, frame_stride=30, along_track=True,
              pass_every_s=400, pass_len_s=120)
# few iterations keep the streams ~1 s; every window still fits its
# observations within recover_rms_px (no trip), so the fast path's own
# result is compared
CFG = window.StreamingConfig(num_iters=6, init_iters=3, max_iters=8,
                             max_iters_later=0)
# the tail refinement runs in the f64 and f32 cases (it has no budget or
# early stop of the stream's)
CASES = {
    "f64": (CFG, {}),
    "later_budget_early_stop": (
        CFG._replace(max_iters=12, max_iters_later=10, budget_span_min_s=600,
                     batched_lambda=9, tail_refine=False),
        dict(solver=ba.SolverParams(conv_patience=1))),
    "f32": (CFG._replace(dtype="float32"), {}),
}


@pytest.fixture(scope="module")
def arc():
    seq = pipeline.simulate_sequence(1, device="cpu", **SIM_KW)
    return seq.det_rows, seq.orbit_pos_eci_km


def _stream(arc, cfg, **kw):
    return window.stream_orbit(*arc, seed=1, cfg=cfg, device="cpu", **kw)


def _assert_same(got, want):
    assert got.final_states.dtype == want.final_states.dtype
    for name in ("final_states", "times", "errors", "knot_times"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.first_detection == want.first_detection
    assert got.recovery_trips == want.recovery_trips


@pytest.fixture
def fast_calls(monkeypatch):
    """The number of times stream_orbit took the fast path."""
    calls = []
    orig = window._stream_fast

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(window, "_stream_fast", spy)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_equals_sync_bit_for_bit(arc, case, fast_calls):
    cfg, kw = CASES[case]
    fast = _stream(arc, cfg, **kw)
    assert fast_calls == [1] and not fast.sync_rerun
    assert fast.recovery_trips == 0
    sync = _stream(arc, cfg, fast=False, **kw)
    assert fast_calls == [1]
    _assert_same(fast, sync)
    assert np.isfinite(fast.errors).all() and len(fast.errors) > 3
