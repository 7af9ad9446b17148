"""The fast dispatch's rule (CPU; tests/test_torch_fast_stream.py says
why the fast path's tests are three files): the shared arc reaches every
path the fast-path tests need (3 windows, a tail, the reduced later
budget), and fast=True outside the JAX package's `fast_ok` rule takes the
sync path.
"""
import pytest

from test_torch_fast_stream import CASES, CFG, arc  # noqa: F401
from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu_torch.estimation import ingest, window
from vinsat_tpu_torch.utils.metrics import MetricsLogger
from vinsat_tpu_torch.utils.profiling import StageTimer


def test_arc_reaches_every_path(arc):
    cfg = CASES["later_budget_early_stop"][0]
    prep = window.prepare_stream(*arc, 1, cfg, device="cpu")
    wins = ingest.split_windows(prep.graph.ii, prep.knot_t)
    assert len(wins) == 3
    assert wins[-1][0] < len(prep.knot_t)  # a tail after the last window
    # the reduced budget applies to a later window
    assert window._multi_pass_window(
        prep.knot_t[prep.graph.ii[:wins[-1][1]]], cfg)


class _Fast(Exception):
    pass


class _Sync(Exception):
    pass


@pytest.mark.parametrize("mode", ["default", "fast_false", "use_prior",
                                  "marginalize", "track_nees",
                                  "checkpoint", "metrics", "timer"])
def test_fast_only_inside_the_rule(arc, mode, monkeypatch, tmp_path):
    """fast=True outside fast_ok runs the sync path (the first window's
    padded problem is the sync path's first step after the choice)."""

    def fast_path(*a, **kw):
        raise _Fast

    def sync_path(*a, **kw):
        raise _Sync

    monkeypatch.setattr(window, "_stream_fast", fast_path)
    monkeypatch.setattr(window, "_pad_problem", sync_path)
    kw = {"default": {}, "fast_false": dict(fast=False),
          "use_prior": dict(cfg=CFG._replace(use_prior=True)),
          "marginalize": dict(cfg=CFG._replace(marginalize=True)),
          "track_nees": dict(cfg=CFG._replace(track_nees=True)),
          "checkpoint": dict(checkpoint_path=str(tmp_path / "ck")),
          "metrics": dict(metrics=MetricsLogger()),
          "timer": dict(timer=StageTimer())}[mode]
    if mode != "fast_false":
        kw.setdefault("fast", True)
    kw.setdefault("cfg", CFG)
    with pytest.raises(_Fast if mode == "default" else _Sync):
        window.stream_orbit(*arc, seed=1, device="cpu", **kw)
