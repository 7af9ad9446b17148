"""PyTorch port vs JAX package: the imagery path
(`pipeline.simulate_sequence_imagery` and its deterministic core
`simulate_imagery_from_draws`) on the CPU, held to the two JAX runs of
tests/data/torch_imagery_seed1.npz (tests/data/make_torch_imagery_fixture.py):

  a. `simulate_sequence_imagery(1, 600, frame_stride=60)`, the NCC
     detector at 60 classes: the whole core from JAX's draws and noise;
  b. the same seed with the committed PatchCNN at 10 classes: stages 0-2
     (render, footprints, crops) and 4-5 (threshold, reprojection) on JAX's
     per-crop detections, then the stream.  Its stage 3, the CNN over six
     384 x 960 crops (~1.8 TFLOP), takes ~60 s on one CPU thread, so it
     runs on the card (chip_smoke.py phase 22, tests/test_torch_cuda.py);
     here the CNN is held to JAX on small scenes
     (tests/test_torch_learned_detector.py).

Tolerances (read on the CPU: scores 3.6e-7, positions 9.5e-7 px in a, 3e-5
px in b; rows' pixels 1.1e-11 / 2.2e-4 px; streams 1.8e-8 / 5.7e-9 km):
the crops from JAX's noise as the render's bound allows (case a: bit for
bit), from JAX's rasters bit for bit, their windows' origins within 1e-9
deg (they follow the class landmarks); per-crop scores 1e-5 and positions
1e-3 px where JAX's score is above 0.3 (float32 correlations summed in
another order); the rows' frames equal, their class lon / lat within
1e-9 deg (the track DB follows the f64 trajectory, which differs in the
last bits), pixels within 1e-3 px and confidences within 1e-5 (no JAX
candidate lies within 1e-4 of the gate, checked); from JAX's own
detections (case b) every column within 1e-9; the stream's errors within
1e-6 km.
"""
import os

import numpy as np
import pytest
import torch

from torch_parity import (IMAGERY_FIXTURE, imagery_case,  # noqa: F401
                          jax_region_noise, torch_one_thread)
from vinsat_tpu_torch import pipeline

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                  IMAGERY_FIXTURE)
CPU = torch.device("cpu")


def _scene(draws, kw, rasters=None):
    return pipeline._imagery_scene(
        draws, kw["duration_s"], kw["frame_stride"],
        kw.get("num_landmarks", 60), 0.01, 1.5, 12.0, rasters, CPU, {})


def _check_scene(fx, case, draws, rasters, kw):
    """Stages 0-2 from JAX's noise against those from JAX's rasters (the
    crops within one grey level at <= 1e-5 of their pixels: the render's
    bound, tests/test_torch_imagery.py), the crops' windows JAX's; returns
    the scene cut from JAX's rasters."""
    scene = _scene(draws._replace(region_noise=jax_region_noise(
        int(fx["seed"]))), kw)
    ref = _scene(draws, kw, rasters)
    win = fx[f"win_{case}"]
    assert len(scene.crops) == len(ref.crops) == len(win)
    d = np.concatenate([np.abs(a.astype(int) - b).ravel()
                        for a, b in zip(scene.crops, ref.crops)])
    assert d.max() <= 1 and (d > 0).sum() <= 1e-5 * d.size
    for s in (scene, ref):
        np.testing.assert_allclose([[w.c, w.f] for w in s.windows],
                                   win[:, 1:3], rtol=0, atol=1e-9)
        np.testing.assert_array_equal([c.shape for c in s.crops],
                                      win[:, 3:5])
    return ref


def _check_rows(got, want, scores, gate):
    assert np.abs(scores - gate).min() > 1e-4
    assert got.shape == want.shape and len(got) > 20
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=1e-5)


def _check_stream(fx, case, rows, orbit):
    res = pipeline.run_streaming({"det_rows": rows,
                                  "orbit_pos_eci_km": orbit},
                                 seed=int(fx["seed"]), device="cpu")
    np.testing.assert_array_equal(res.times, fx[f"times_{case}"])
    np.testing.assert_allclose(res.errors, fx[f"errors_{case}"], rtol=0,
                               atol=1e-6)
    return res


def test_case_a_ncc_through_the_core():
    fx = np.load(FX)
    draws, rasters, kw = imagery_case(fx, "a")
    _check_scene(fx, "a", draws, rasters, kw)
    seq = pipeline.simulate_imagery_from_draws(
        draws._replace(region_noise=jax_region_noise(int(fx["seed"]))),
        device="cpu", **kw)
    c = seq.crops
    assert c.crop_hw == tuple(fx["crop_hw_a"])
    want = fx["scores_a"]
    np.testing.assert_allclose(c.scores, want, rtol=0, atol=1e-5)
    match = want > 0.3
    for got, key in ((c.rows, "rows_a"), (c.cols, "cols_a")):
        np.testing.assert_allclose(got[match], fx[key][match], rtol=0,
                                   atol=1e-3)
    _check_rows(seq.det_rows, fx["det_rows_a"], want[match], 0.55)
    assert set(seq.stage_s) >= {"trajectory", "render", "footprints",
                                "crops", "detection", "reprojection"}
    _check_stream(fx, "a", seq.det_rows, seq.orbit_pos_eci_km)


def test_case_b_patchcnn_stages_around_the_detector():
    fx = np.load(FX)
    draws, rasters, kw = imagery_case(fx, "b")
    scene = _check_scene(fx, "b", draws, rasters, kw)
    scores = fx["scores_b"]
    rows = pipeline._rows_from_detections(scene, scores, fx["rows_b"],
                                          fx["cols_b"], kw["conf_threshold"],
                                          False, {})
    want = fx["det_rows_b"]
    assert rows.shape == want.shape
    np.testing.assert_array_equal(rows[:, 0], want[:, 0])
    np.testing.assert_allclose(rows[:, 1:], want[:, 1:], rtol=0, atol=1e-9)
    _check_stream(fx, "b", rows, scene.traj.pos_eci.cpu().numpy())


def test_own_generator_sequence_streams_under_5km():
    seq = pipeline.simulate_sequence_imagery(1, duration_s=600,
                                             frame_stride=60, device="cpu")
    assert len(seq.det_rows) > 20, len(seq.det_rows)
    assert (seq.det_rows[:, 5] > 0.8).any()
    res = pipeline.run_streaming(seq, seed=1, device="cpu")
    assert len(res.errors) and res.errors.min() < 5.0, res.errors
    a, b = pipeline.draw_imagery(1), pipeline.draw_imagery(1)
    assert torch.equal(a.templates, b.templates) and a.db_seed == b.db_seed
    assert torch.equal(a.region_noise(0, 8, 8), b.region_noise(0, 8, 8))


def test_entry_point_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        pipeline.simulate_sequence_imagery(1)
    fx = np.load(FX)
    draws, rasters, kw = imagery_case(fx, "a")
    with pytest.raises(ValueError):
        pipeline.simulate_imagery_from_draws(
            draws, rasters=[r[:-1] for r in rasters], device="cpu", **kw)
