"""The stream task: each request solves an arc made at set-up by the
benchmark's generator through the program's
`vinsat_tpu_torch.pipeline.run_streaming`, with one of the campaign's
initial-error draws.  The arcs and the draws are the configuration's
(from its `arc_seed`), the same for every run; the run's seed draws only
the order in which the requests cycle through the draws, so that every
run does the same work.  The reference (benchmark/reference/stream.py)
solves a sampled request again once the window has closed."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.inputs import sim
from benchmark.reference import stream as ref

# index spaces of generator_seed: arcs, warm-up draws, the campaign's
# draws, their order
ARC_SPACE = 1 << 40
WARM_SPACE = 1 << 41
DRAW_SPACE = 1 << 42
ORDER_SPACE = 1 << 43


def compare(res, want) -> List[tuple]:
    """The numbers that decide `correct` for one stream: recorded times
    that differ (exact), the widest gap of a recorded error (km), and of
    the final knots' positions (km), velocities (km/s) and attitudes (a
    quaternion component, sign-free)."""
    same_len = len(res.times) == len(want.times)
    times_off = (int((np.asarray(res.times) != want.times).sum()) if same_len
                 else max(len(res.times), len(want.times)))
    if same_len and len(res.errors):
        err = float(np.abs(np.asarray(res.errors, np.float64)
                           - want.errors).max())
    else:
        err = float("inf")
    fs = np.asarray(res.final_states, np.float64)
    ws = want.final_states
    if fs.shape == ws.shape:
        pos = float(np.abs(fs[:, :3] - ws[:, :3]).max())
        vel = float(np.abs(fs[:, 7:10] - ws[:, 7:10]).max())
        q, r = fs[:, 3:7], ws[:, 3:7]
        att = float(np.minimum(np.abs(q - r).max(1),
                               np.abs(q + r).max(1)).max())
    else:
        pos = vel = att = float("inf")
    return [("times_differing", times_off), ("error_gap_km", err),
            ("final_position_gap_km", pos),
            ("final_velocity_gap_km_s", vel), ("final_attitude_gap", att)]


class Task:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.arc_kw = dict(config["arc"])
        n = traffic["arcs"]
        if not isinstance(n, int) or n < 1:
            raise ValueError("the stream task takes a whole number of arcs "
                             "made at set-up (traffic 'arcs')")
        self.n_arcs = n
        d = traffic["draws"]
        if not isinstance(d, int) or d < 1:
            raise ValueError("the stream task takes a whole number of "
                             "initial-error draws (traffic 'draws')")
        self.draws = [sim.generator_seed(config["arc_seed"], DRAW_SPACE + i)
                      for i in range(d)]
        self.order = np.random.default_rng(
            sim.generator_seed(seed, ORDER_SPACE)).permutation(d)
        self.results: Dict[int, object] = {}
        self.k1: List[tuple] = []

    def noise_seed(self, k: int) -> int:
        """Request k's initial-error draw: the campaign's draws in the
        run's order, cycled."""
        return self.draws[self.order[k % len(self.draws)]]

    def setup(self) -> None:
        from vinsat_tpu_torch import pipeline
        from vinsat_tpu_torch.estimation import graphs, window
        from vinsat_tpu_torch.kernels import tridiag_pcr

        self.pipeline, self.graphs, self.k1_mod = pipeline, graphs, tridiag_pcr
        self.cfg = window.StreamingConfig(**self.config["stream"])
        self.arcs = [sim.simulate(sim.generator_seed(self.config["arc_seed"],
                                                     ARC_SPACE + a),
                                  **self.arc_kw)
                     for a in range(self.n_arcs)]

    def warm(self) -> None:
        """One stream of each arc, which captures its window programs,
        with a draw of the configuration's: the same work every run."""
        for a in range(self.n_arcs):
            self._solve(a, sim.generator_seed(self.config["arc_seed"],
                                              WARM_SPACE + a))
        self.sync()

    def _solve(self, a: int, noise_seed: int, cfg=None):
        arc = self.arcs[a]
        with torch.profiler.record_function("bench.run_streaming"):
            return self.pipeline.run_streaming(
                (arc.dets.rows, arc.traj.pos_eci), seed=noise_seed,
                cfg=self.cfg if cfg is None else cfg, device=self.device)

    def request(self, k: int):
        res = self._solve(k % self.n_arcs, self.noise_seed(k))
        self.results[k] = res
        return self.arc_kw["duration_s"], {"sync_rerun": bool(res.sync_rerun)}

    def counters(self) -> Dict[str, float]:
        return {"graph_captures": self.graphs.stats["captures"]}

    def trace_begin(self) -> None:
        """Record the (B, N, dtype) of every K1 launch until trace_end."""
        self.k1 = []
        orig = self.k1_mod.launched

        def launched(shapes):
            self.k1.extend((b, n, str(d).split(".")[-1]) for b, n, d in shapes)
            orig(shapes)

        self._orig_launched = orig
        self.k1_mod.launched = launched

    def trace_end(self) -> List[tuple]:
        self.k1_mod.launched = self._orig_launched
        return self.k1

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_closed(self, done: List[int]) -> None:
        """Free the program's device state before the reference runs."""
        self.graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, k: int, dtype=torch.float64):
        arc = self.arcs[k % self.n_arcs]
        return ref.stream(arc.dets.rows, arc.traj.pos_eci, self.noise_seed(k),
                          cfg=ref.Config(**{
                              n: v for n, v in self.config["stream"].items()
                              if n in ref.Config._fields}),
                          device=self.device, dtype=dtype)

    def check(self, sample: List[int]) -> List[tuple]:
        limits = self.config["limits"]
        worst: Dict[str, float] = {}
        for k in sample:
            for name, v in compare(self.results[k], self.reference(k)):
                worst[name] = max(worst.get(name, 0.0), v)
        return [(n, v, limits[n]) for n, v in worst.items()]

    def control(self, k: int):
        """The control: the program's own float32 path on request k."""
        cfg = self.cfg._replace(dtype="float32")
        return self._solve(k % self.n_arcs, self.noise_seed(k), cfg)
