"""The fast dispatch's sync re-run and its default against the JAX
package's (CPU; tests/test_torch_fast_stream.py says why the fast path's
tests are three files).

A recover_rms_px no window can meet makes the fast stream run again in
sync mode, equal to `fast=False` with its recovery_trips and flagged
`sync_rerun`.  The port's default stream (fast) against the JAX package's
default stream (fast there too) on config 3's rows, the JAX run committed
in tests/data/torch_modes_seed1.npz, at tests/test_torch_stream.py's
1e-3 km.
"""
import os

import numpy as np

from test_torch_fast_stream import (CFG, _assert_same, _stream,  # noqa: F401
                                    arc, fast_calls)
from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu_torch.estimation import window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_modes_seed1.npz")


def test_forced_rerun_equals_sync(arc, fast_calls):
    cfg = CFG._replace(recover_rms_px=1e-3, tail_refine=False)
    fast = _stream(arc, cfg)
    assert fast_calls == [1] and fast.sync_rerun
    sync = _stream(arc, cfg, fast=False)
    assert not sync.sync_rerun
    _assert_same(fast, sync)
    assert fast.recovery_trips == 3  # every window trips


def test_default_stream_matches_jax_default():
    """The JAX package's default stream (fast) of config 3's rows, each
    detection re-associated with its nearest DB landmark (run_configs'
    BA-only stream, committed in the modes fixture), against the port's
    default stream of the same rows."""
    md = np.load(MODES_FIXTURE)
    rows = md["det_rows_3"].copy()
    idx = md["c3_matcher_idx"]
    rows[:, 1] = md["db_lon_3"][idx]
    rows[:, 2] = md["db_lat_3"][idx]
    got = window.stream_orbit(rows, md["orbit_pos_eci_km_3"], seed=1,
                              device="cpu")
    assert not got.sync_rerun
    np.testing.assert_array_equal(got.times, md["c3_ba_only_times"])
    np.testing.assert_allclose(got.errors, md["c3_ba_only_errors"], rtol=0,
                               atol=1e-3)
    assert got.recovery_trips == int(md["c3_ba_only_recovery_trips"])
