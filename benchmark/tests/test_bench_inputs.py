"""The benchmark's input generator against the program's simulator, and
the reference stream against the program's CPU stream, on short arcs."""
import numpy as np
import pytest
import torch

from benchmark.inputs import sim
from benchmark.reference import stream as ref
from benchmark.tasks import simulate as sim_task
from benchmark.tasks import stream as stream_task


def _program_sim(gen_seed, duration):
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.sim import detections, orbits

    d = sim.draw(gen_seed)
    draws = pipeline.SimDraws(orbits.OrbitalElements(*d.oe), d.q0, d.w0,
                              d.db_seed, detections.DetectionDraws(
                                  d.generator))
    return pipeline.simulate_from_draws(
        draws, duration, frame_stride=5, along_track=True, pass_every_s=1800,
        pass_len_s=300, device="cpu")


def test_generator_seed_is_stable_and_spread():
    a = sim.generator_seed(2**33 + 5, 0)
    assert a == sim.generator_seed(2**33 + 5, 0)
    assert a != sim.generator_seed(2**33 + 5, 1)
    assert 0 <= a < 2**64


@pytest.mark.parametrize("seed", [3, 2**35 + 17])
def test_generator_matches_program_simulator(seed):
    gs = sim.generator_seed(seed, 0)
    arc = sim.simulate(gs, 2400)
    seq = _program_sim(gs, 2400)
    got = {"pos_eci": seq.orbit_pos_eci_km,
           "quat_body": seq.traj.quat_body_eci.numpy(),
           "db_lon": seq.db.lon.numpy(), "db_lat": seq.db.lat.numpy(),
           "gate": seq.dets.frame_visible.numpy(), "rows": seq.det_rows}
    gaps = dict(sim_task.compare(got, arc))
    assert len(arc.dets.rows) > 100
    assert gaps["gates_differing"] == 0 and gaps["rows_differing"] == 0
    assert gaps["trajectory_gap_km"] < 1e-9
    assert gaps["attitude_gap"] < 1e-11
    assert gaps["pixel_gap_px"] < 1e-8
    assert gaps["database_gap_deg"] < 1e-11


def test_reference_stream_matches_program_cpu_stream():
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.estimation import window

    arc = sim.simulate(sim.generator_seed(99, 0), 3000)
    cfg = window.StreamingConfig(batched_lambda=9)
    got = pipeline.run_streaming((arc.dets.rows, arc.traj.pos_eci), seed=5,
                                 cfg=cfg, device="cpu")
    want = ref.stream(arc.dets.rows, arc.traj.pos_eci, 5, device="cpu")
    gaps = dict(stream_task.compare(got, want))
    assert len(want.times) > 20
    assert gaps["times_differing"] == 0
    # roundoff of another summation order, grown by the LM iterations
    assert gaps["error_gap_km"] < 1e-6
    assert gaps["final_position_gap_km"] < 1e-6
    assert want.errors[-1] < 5.0


def test_reference_solves_and_pcr_agree():
    g = torch.Generator().manual_seed(0)
    K, N = 2, 70
    A = torch.randn((K, N, 9, 9), generator=g, dtype=torch.float64)
    D = A @ A.transpose(-1, -2) + 10 * torch.eye(9, dtype=torch.float64)
    U = 0.3 * torch.randn((K, N - 1, 9, 9), generator=g, dtype=torch.float64)
    b = torch.randn((K, N, 9), generator=g, dtype=torch.float64)
    x1 = ref.thomas(D, U, b)
    x2 = ref.pcr(D, U, b)
    assert float((x1 - x2).abs().max()) < 1e-10
