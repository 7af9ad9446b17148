"""The simulate task: each request simulates a new arc through the
program's `vinsat_tpu_torch.pipeline.simulate_from_draws`, from draws
that benchmark/inputs/sim.py makes from the run's seed and the request's
index.  The reference is the same module's host simulation of the same
draws."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.inputs import sim

WARM_SPACE = 1 << 41


def compare(got: dict, arc: sim.Arc) -> List[tuple]:
    """The numbers that decide `correct` for one simulated arc: the widest
    gap of the truth's position (km) and body attitude, of the database's
    lon / lat (deg), the imaging gates and rows that differ (exact), and
    the widest gap of a row's lon / lat (deg), pixels (px) and
    confidence."""
    inf = float("inf")
    pos = got["pos_eci"]
    traj = (float(np.abs(pos - arc.traj.pos_eci).max())
            if pos.shape == arc.traj.pos_eci.shape else inf)
    quat = (float(np.abs(got["quat_body"] - arc.traj.quat_body).max())
            if got["quat_body"].shape == arc.traj.quat_body.shape else inf)
    if got["db_lon"].shape == arc.db.lon.shape:
        db = float(max(np.abs(got["db_lon"] - arc.db.lon).max(),
                       np.abs(got["db_lat"] - arc.db.lat).max()))
    else:
        db = inf
    g, gw = got["gate"], arc.dets.gate
    gate = (int((g != gw).sum()) if g.shape == gw.shape
            else max(len(g), len(gw)))
    r, rw = got["rows"], arc.dets.rows
    if r.shape == rw.shape and len(r):
        rows_off = int((r[:, 0] != rw[:, 0]).sum())
        d = np.abs(r - rw).max(0)
        lonlat, px, conf = float(d[1:3].max()), float(d[3:5].max()), float(
            d[5])
    else:
        rows_off = max(len(r), len(rw)) if r.shape != rw.shape else 0
        lonlat = px = conf = inf if r.shape != rw.shape else 0.0
    return [("trajectory_gap_km", traj), ("attitude_gap", quat),
            ("database_gap_deg", db), ("gates_differing", gate),
            ("rows_differing", rows_off), ("row_lonlat_gap_deg", lonlat),
            ("pixel_gap_px", px), ("confidence_gap", conf)]


class Task:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.arc_kw = dict(config["arc"])
        if traffic["arcs"] != "per_request":
            raise ValueError("the simulate task makes a new arc a request "
                             "(traffic 'arcs': 'per_request')")
        self.results: Dict[int, object] = {}

    def setup(self) -> None:
        from vinsat_tpu_torch import pipeline
        from vinsat_tpu_torch.sim import detections, orbits

        self.pipeline, self.orbits, self.det = pipeline, orbits, detections

    def warm(self) -> None:
        """One simulation, which loads K3 and warms the rollouts."""
        self._simulate(sim.generator_seed(self.seed, WARM_SPACE))
        self.sync()

    def _simulate(self, gen_seed: int):
        d = sim.draw(gen_seed)
        draws = self.pipeline.SimDraws(
            self.orbits.OrbitalElements(*d.oe), d.q0, d.w0, d.db_seed,
            self.det.DetectionDraws(d.generator))
        kw = self.arc_kw
        with torch.profiler.record_function("bench.simulate_from_draws"):
            return self.pipeline.simulate_from_draws(
                draws, kw["duration_s"], noise_px=kw["noise_px"],
                frame_stride=kw["frame_stride"], max_dets=kw["max_dets"],
                along_track=True, pass_every_s=kw["pass_every_s"],
                pass_len_s=kw["pass_len_s"], device=self.device)

    def request(self, k: int):
        self.results[k] = self._simulate(sim.generator_seed(self.seed, k))
        return self.arc_kw["duration_s"], {}

    def counters(self) -> Dict[str, float]:
        return {}

    def trace_begin(self) -> None:
        pass

    def trace_end(self) -> List[tuple]:
        return []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_closed(self, done: List[int]) -> None:
        """Keep on the host what the checks read of each simulated arc and
        free the program's device state."""
        for k, seq in list(self.results.items()):
            self.results[k] = {
                "pos_eci": np.asarray(seq.orbit_pos_eci_km),
                "quat_body": seq.traj.quat_body_eci.cpu().numpy(),
                "db_lon": seq.db.lon.cpu().numpy(),
                "db_lat": seq.db.lat.cpu().numpy(),
                "gate": seq.dets.frame_visible.cpu().numpy(),
                "rows": np.asarray(seq.det_rows)}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, k: int, dtype=np.float64) -> sim.Arc:
        kw = {n: self.arc_kw[n] for n in ("duration_s", "frame_stride",
                                         "pass_every_s", "pass_len_s",
                                         "noise_px", "max_dets")}
        return sim.simulate(sim.generator_seed(self.seed, k), dtype=dtype,
                            **kw)

    def check(self, sample: List[int]) -> List[tuple]:
        limits = self.config["limits"]
        worst: Dict[str, float] = {}
        for k in sample:
            for name, v in compare(self.results[k], self.reference(k)):
                worst[name] = max(worst.get(name, 0.0), v)
        return [(n, v, limits[n]) for n, v in worst.items()]

    def control(self, k: int) -> dict:
        """The control: the reference itself computed in float32, in the
        program's place."""
        arc = self.reference(k, np.float32)
        return {"pos_eci": arc.traj.pos_eci.astype(np.float64),
                "quat_body": arc.traj.quat_body.astype(np.float64),
                "db_lon": arc.db.lon.astype(np.float64),
                "db_lat": arc.db.lat.astype(np.float64),
                "gate": arc.dets.gate, "rows": arc.dets.rows}
