"""PyTorch port vs JAX package: utils/metrics (MetricsLogger), utils/
profiling (StageTimer, trace), the stream's metrics and timer arguments,
utils/stream_profile, utils/mfu's operation and byte counts, and
evalx/ate's ground track, on the CPU.

Bounds: the logger's records and summary have JAX's keys and values;
a stream given a logger and a timer records exactly the errors of the
stream without them (neither changes a computation); the ground track
within 1e-9 deg and 1e-9 km of JAX's (the same float64 fixed-point
iteration in another library).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu.evalx import ate as jate
from vinsat_tpu.utils import metrics as jmetrics
from vinsat_tpu.utils import profiling as jprofiling
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ba, window
from vinsat_tpu_torch.evalx import ate
from vinsat_tpu_torch.utils import (metrics, mfu, plot, profiling,
                                    stream_profile)

SIM_KW = dict(duration_s=1800, frame_stride=10, along_track=True,
              pass_every_s=600, pass_len_s=240)


def _log_some(m):
    m.log("start", note="x")
    m.log_window(0, 10, 40, 1.5, 1e-3, 0.25, end_error_km=3.0)
    m.log_window(1, 20, 90, 0.5, 1e-4, 0.5)
    return m.summary()


def test_metrics_logger_matches_jax(tmp_path):
    p, jp = str(tmp_path / "m.jsonl"), str(tmp_path / "jm.jsonl")
    m, jm = metrics.MetricsLogger(p, "r"), jmetrics.MetricsLogger(jp, "r")
    assert _log_some(m) == _log_some(jm) == {
        "num_windows": 2, "total_wall_s": 0.75, "mean_residual_last": 0.5}
    m.close()
    jm.close()
    with open(p) as f, open(jp) as jf:
        got = [json.loads(line) for line in f]
        want = [json.loads(line) for line in jf]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        a.pop("ts"), b.pop("ts")
        assert a == b
    assert metrics.MetricsLogger().summary() == {"num_windows": 0}


def test_stage_timer_matches_jax():
    t, jt = profiling.StageTimer(), jprofiling.StageTimer()
    for timer, sync in ((t, torch.zeros(3)), (jt, jnp.zeros(3))):
        for _ in range(3):
            with timer.stage("a", sync=sync):
                pass
        with timer.stage("b"):
            pass
    rep, jrep = t.report(), jt.report()
    assert set(rep) == set(jrep) == {"a", "b"}
    for k in rep:
        assert set(rep[k]) == set(jrep[k]) == {"total_s", "count", "mean_ms"}
        assert rep[k]["count"] == jrep[k]["count"]
        assert rep[k]["total_s"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    d = str(tmp_path / "tr")
    with profiling.trace(d):
        torch.ones(4).sum()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_stream_with_metrics_and_timer_equals_without(tmp_path):
    """A gapped 1800 s arc (3 windows) with NEES tracking: a logger and a
    timer record every window and stage and leave the errors as they
    are."""
    seq = pipeline.simulate_sequence(1, device="cpu", **SIM_KW)
    cfg = window.StreamingConfig(track_nees=True, max_iters=30)

    def run(**kw):
        return window.stream_orbit(seq.det_rows, seq.orbit_pos_eci_km,
                                   seed=1, cfg=cfg, device="cpu", **kw)

    plain = run()
    m = metrics.MetricsLogger(str(tmp_path / "s.jsonl"))
    timer = profiling.StageTimer()
    got = run(metrics=m, timer=timer)
    np.testing.assert_array_equal(got.errors, plain.errors)
    np.testing.assert_array_equal(got.times, plain.times)
    nw = len(got.window_infos)
    assert nw >= 2
    wins = [r for r in m.records if r["kind"] == "window"]
    assert [r["window"] for r in wins] == list(range(nw))
    assert set(wins[0]) == {"ts", "run", "kind", "window", "knots", "obs",
                            "mean_residual", "lamda", "wall_s",
                            "end_error_km"}
    assert all(np.isfinite(r["mean_residual"]) and r["wall_s"] >= 0
               for r in wins)
    ends = {int(t): e for t, e in zip(got.times, got.errors)}
    kt = got.knot_times
    assert [r["end_error_km"] for r in wins][-1] == pytest.approx(
        ends[int(kt[wins[-1]["knots"] - 1])], rel=0, abs=0)
    assert len([r for r in m.records if r["kind"] == "nees"]) == nw
    assert m.summary()["num_windows"] == nw
    rep = timer.report()
    assert {"prep", "propagate", "pad_transfer", "solve",
            "marginal"} <= set(rep)
    assert rep["solve"]["count"] == rep["marginal"]["count"] == nw
    assert rep["prep"]["count"] == 1
    m.close()


def test_stream_profile_runs_on_the_cpu(capsys):
    rep = stream_profile.main(["--duration", "600", "--trials", "1",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu, float64" in out and "run 0: total" in out
    assert {"prep", "pad_transfer", "solve"} <= set(rep)


def test_mfu_counts_each_stage():
    """The dispatch-mode counts on the CPU (the card's timing path raises
    here): every stage counts operations and bytes, the iteration more of
    both than any other stage, matrix products in all but none."""
    params = ba.SolverParams(num_hops=5, max_substep=100.0)
    fns = mfu.stage_programs(params)
    inp = mfu.example_problem(32, 8, 350.0, torch.float64, "cpu")
    args = (*inp, *mfu._solve_inputs(*inp, fns))
    c = {k: mfu.count(f, *args) for k, f in fns.items()}
    for k, v in c.items():
        assert v["matmul_flops"] > 0 and v["other_ops"] > 0, k
        assert v["bytes"] > 8 * 32 * 9, k
    for k in ("factors", "assemble", "solve"):
        assert c["iteration"]["bytes"] > c[k]["bytes"]
    # the assembly's products: JᵀWJ and JᵀWr of 256 observations
    assert c["assemble"]["matmul_flops"] >= 2 * 256 * 9 * 9 * 2
    assert mfu.card_peaks("NVIDIA H100 80GB HBM3") == (67e12, 67e12,
                                                       3.35e12)
    assert mfu.card_peaks("cpu") is None
    with pytest.raises(RuntimeError):
        mfu.measure(16, device="cpu")


def test_ground_track_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(50, 3))
    pos = 6900.0 * pos / np.linalg.norm(pos, axis=1, keepdims=True)
    got = ate.ground_track(pos, device="cpu")
    want = jate.ground_track(pos)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-9)
    path = str(tmp_path / "track.png")
    ate.plot_ground_track(got[0], got[1], path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("kind", ["step", "scatter"])
def test_plot_without_matplotlib(tmp_path, monkeypatch, kind):
    """Where matplotlib is missing (the machine with the card) the figure
    is rasterized and written as a valid PNG: its size, the frame and the
    data's pixels."""
    import sys
    import zlib

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = str(tmp_path / f"{kind}.png")
    plot.save_plot(path, [0.0, 100.0, 300.0], [0.2, 0.5, 1.0], kind=kind,
                   ylim=(0, 1), figsize=(4, 3), dpi=50)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    W, H = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                             "big")
    assert (W, H) == (200, 150)
    start = data.index(b"IDAT") + 4
    raw = zlib.decompress(data[start:start + int.from_bytes(
        data[start - 8:start - 4], "big")])
    img = np.frombuffer(raw, np.uint8).reshape(H, 1 + 3 * W)[:, 1:]
    img = img.reshape(H, W, 3)
    assert (img == 0).all(axis=2).any()  # the frame
    assert (img == plot._BLUE).all(axis=2).sum() > 3  # the data
    with pytest.raises(ValueError):
        plot.save_plot(path, [0], [0], kind="line")
