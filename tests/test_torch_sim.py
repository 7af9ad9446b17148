"""PyTorch port vs JAX: the detection simulator end to end (f64, CPU).

The JAX `simulate_sequence` runs over 600 s of seed 1 in both modes — the
bench arc's along-track shape (track DB, frame_stride 5, a 300 s pass) and
the synthetic full eval's (the 7920-landmark synthesized DB) — and the
port replays its draws (`torch_parity.jax_simulation`): the same rows
(count and frames equal, lon / lat equal, pixels within 1e-6 px, confidence
within 1e-12), the same gate at every frame and the same visibility count.
The port's own generator is checked for determinism; every entry point
for refusing to run on the CPU by default; the package for importing no
JAX."""
import ast
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import T, jax_simulation, rel_err
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ingest, refine, window
from vinsat_tpu_torch.sim import camera, detections, landmarks, mgrs, orbits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "a": dict(duration_s=600, along_track=True, frame_stride=5,
              pass_every_s=1800, pass_len_s=300),
    "b": dict(duration_s=600),
}


@functools.lru_cache(maxsize=None)
def _jax(mode):
    return jax_simulation(1, **MODES[mode])


def _recorded(J):
    return detections.RecordedDraws(J["score_frame"], J["score_landmark"],
                                    J["score"], J["noise"], J["conf"])


def _assert_rows_match(got, want):
    assert got.shape == want.shape and len(want) > 0
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["a", "b"])
def test_simulate_from_draws_matches_jax(mode):
    J = _jax(mode)
    draws = pipeline.SimDraws(orbits.OrbitalElements(*J["oe"]), J["q0"],
                              J["w0"], J["db_seed"], _recorded(J))
    seq = pipeline.simulate_from_draws(draws, device="cpu", **MODES[mode])
    _assert_rows_match(seq.det_rows, J["det_rows"])
    np.testing.assert_array_equal(seq.dets.frame_visible.numpy(),
                                  J["frame_visible"])
    assert rel_err(seq.orbit_pos_eci_km, J["pos_eci"]) < 1e-12
    assert int(seq.dets.frame_visible.sum()) > 0


@pytest.mark.parametrize("mode", ["a", "b"])
def test_generate_detections_matches_jax(mode):
    J = _jax(mode)
    kw = MODES[mode]
    traj = orbits.Trajectory(**{k: T(v) for k, v in J["traj"].items()})
    db = landmarks.db_from_numpy(J["db"], "cpu")
    region_mask = (torch.ones(len(mgrs.ZONE_LABELS), dtype=torch.bool)
                   if kw.get("along_track") else None)
    dets = detections.generate_detections(
        _recorded(J), traj, db, noise_px=4.0, conf_low=0.82,
        frame_stride=kw.get("frame_stride", 1), region_mask=region_mask)
    want = J["dets"]
    valid = dets.valid.numpy()
    np.testing.assert_array_equal(valid, want["valid"])
    np.testing.assert_array_equal(dets.frame_visible.numpy(),
                                  want["frame_visible"])
    np.testing.assert_array_equal(dets.landmark_idx.numpy()[valid],
                                  want["landmark_idx"][valid])
    for name, atol in (("uv_true", 1e-6), ("uv", 1e-6), ("conf", 1e-12)):
        np.testing.assert_allclose(getattr(dets, name).numpy()[valid],
                                   want[name][valid], rtol=0, atol=atol)
    active = (region_mask if region_mask is not None
              else mgrs.active_region_mask("cpu"))
    pos = (traj.pos_ecef * 1000.0)[::kw.get("frame_stride", 1)]
    gate, count = detections._frame_gate(
        camera.CameraModel.from_hfov(), db, pos,
        db.best & active[db.region], 3)
    np.testing.assert_array_equal(count.numpy(), J["count"])
    np.testing.assert_array_equal(gate.numpy(), J["frame_visible"])
    stats = detections.px_error_stats(dets)
    assert stats["n"] == len(J["det_rows"]) and 2.0 < stats["mean_x"] < 4.5


def test_track_landmark_db_matches_jax():
    J = _jax("a")
    traj = orbits.Trajectory(**{k: T(v) for k, v in J["traj"].items()})
    db = pipeline.track_landmark_db(traj, J["db_seed"], pass_every_s=1800,
                                    pass_len_s=300)
    for name in landmarks.LandmarkDB._fields:
        np.testing.assert_array_equal(getattr(db, name).numpy(),
                                      J["db"][name], name)


def test_detector_fn_replaces_the_noise_model():
    J = _jax("a")
    traj = orbits.Trajectory(**{k: T(v) for k, v in J["traj"].items()})
    db = landmarks.db_from_numpy(J["db"], "cpu")
    seen = []

    def detector(uv_true, generator):
        seen.append(generator)
        return uv_true + 1.0, torch.full(uv_true.shape[:-1], 0.9,
                                         dtype=torch.float64)

    dets = detections.generate_detections(
        torch.Generator().manual_seed(0), traj, db, frame_stride=5,
        region_mask=torch.ones(len(mgrs.ZONE_LABELS), dtype=torch.bool),
        detector_fn=detector)
    v = dets.valid
    assert int(v.sum()) > 0 and isinstance(seen[0], torch.Generator)
    assert torch.equal(dets.uv[v], dets.uv_true[v] + 1.0)
    assert (dets.conf[v] == 0.9).all()


def test_recorded_draws_refuse_pairs_they_lack():
    d = detections.RecordedDraws([0, 0, 2], [1, 5, 0], [0.1, 0.2, 0.3],
                                 np.zeros((1, 2)), np.zeros(1))
    got = d.score(torch.tensor([0, 2]), torch.tensor([5, 0]))
    assert got.tolist() == [0.2, 0.3]
    with pytest.raises(KeyError):
        d.score(torch.tensor([1]), torch.tensor([0]))
    with pytest.raises(ValueError):
        d.noise_conf(torch.ones((2, 2), dtype=torch.bool))


def test_simulate_sequence_is_seeded():
    kw = dict(MODES["a"], device="cpu")
    a = pipeline.simulate_sequence(3, **kw)
    b = pipeline.simulate_sequence(3, **kw)
    c = pipeline.simulate_sequence(4, **kw)
    assert len(a.det_rows) > 0 and np.isfinite(a.det_rows).all()
    np.testing.assert_array_equal(a.det_rows, b.det_rows)
    assert not np.array_equal(a.orbit_pos_eci_km, c.orbit_pos_eci_km)
    assert a.orbit_pos_eci_km.shape == (601, 3)


def _empty_rows():
    return np.zeros((0, 6)), np.tile([6900.0, 0.0, 0.0], (20, 1))


ENTRY_POINTS = {
    "simulate_sequence": lambda: pipeline.simulate_sequence(1, duration_s=5),
    "simulate_from_draws": lambda: pipeline.simulate_from_draws(
        pipeline.draw_sim(1), duration_s=5),
    "generate_trajectory": lambda: orbits.generate_trajectory(
        torch.Generator().manual_seed(0), duration_s=5),
    "trajectory_from_draws": lambda: orbits.trajectory_from_draws(
        orbits.OrbitalElements(6900.0, 0.0, 1.0, 0.0, 0.0, 0.0),
        np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3), duration_s=5),
    "synthesize": lambda: landmarks.synthesize(0, per_region=4),
    "db_from_numpy": lambda: landmarks.db_from_numpy(
        {k: np.zeros(2) for k in landmarks.LandmarkDB._fields}),
    "active_region_mask": lambda: mgrs.active_region_mask(),
    "run_streaming": lambda: pipeline.run_streaming(_empty_rows()),
    "stream_orbit": lambda: window.stream_orbit(*_empty_rows()),
    "prepare_stream": lambda: window.prepare_stream(
        *_empty_rows(), 0, window.StreamingConfig()),
    "process_ground_truths": lambda: ingest.process_ground_truths(
        _empty_rows()[1], ingest.build_graph(
            np.array([[3.0, 10.0, 20.0, 100.0, 200.0, 0.9]]), 20)),
    "refine_terminal": lambda: refine.refine_terminal(
        np.zeros((2, 10)), np.array([10.0, 0.0]), np.zeros((1, 3)),
        np.zeros((1, 2)), np.ones(1), np.zeros(1, int),
        np.array([3500.0, 3500.0, 2304.0, 1296.0])),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def _imported_modules(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "k1_study.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vinsat_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "vinsat_tpu", "flax"), (
                path, mod)
    code = ("import sys, vinsat_tpu_torch.pipeline, "
            "vinsat_tpu_torch.kernels.tridiag_pcr, "
            "vinsat_tpu_torch.kernels.visible_count, "
            "vinsat_tpu_torch.sim.detections; "
            "sys.exit(int(any(m.split('.')[0] in ('jax', 'vinsat_tpu') "
            "for m in sys.modules)))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=ROOT).returncode == 0
