"""bench.py's synthetic full evaluation (16 orbits x 10800 s) as the JAX
package ran it, committed in tests/data/torch_full_eval.npz (tests/data/
make_torch_full_eval_fixture.py): its draws load as the port's SimDraws,
the port's ate.summarize reproduces JAX's summary from JAX's errors, and
its orbit 1 is the orbit of tests/data/torch_eval_seed1.npz.  The card
runs the 16 orbits from these draws (chip_smoke.py phase 14); no orbit is
simulated or streamed here (a 10800 s mode-b orbit takes minutes on the
CPU).

Bounds: the summary exactly (the same numpy on the same errors); seed 1
within 1e-9 of the evaluation fixture."""
import os

import numpy as np
import pytest

from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.evalx import ate
from vinsat_tpu_torch.sim import detections, orbits

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(DATA, "torch_full_eval.npz"))


def _draws(fx, s) -> pipeline.SimDraws:
    g = lambda k: fx[f"{k}_{s}"]  # noqa: E731
    return pipeline.SimDraws(
        orbits.OrbitalElements(*(float(v) for v in g("oe"))),
        np.asarray(g("q0")), np.asarray(g("w0")), int(g("db_seed")),
        detections.RecordedDraws(g("score_frame"), g("score_landmark"),
                                 g("score"), g("noise"), g("conf")))


def test_orbits_load_as_sim_draws(fx):
    assert fx["seeds"].tolist() == list(range(16))
    assert int(fx["duration_s"]) == 10800
    for s in fx["seeds"].tolist():
        d = _draws(fx, s)
        assert len(d.oe) == 6 and d.q0.shape == (4,) and d.w0.shape == (3,)
        assert abs(float(np.linalg.norm(d.q0)) - 1.0) < 1e-12
        # RecordedDraws takes the scores only in the row-major order the
        # port reads them (it raises otherwise)
        assert isinstance(d.detection, detections.RecordedDraws)
        n = int(fx[f"n_rows_{s}"])
        assert len(fx[f"noise_{s}"]) == len(fx[f"conf_{s}"]) == n
        assert len(fx[f"frames_{s}"]) == n
        assert (len(fx[f"score_{s}"]) == len(fx[f"score_frame_{s}"])
                == len(fx[f"score_landmark_{s}"]))
        streamed = bool(fx[f"has_stream_{s}"])
        assert streamed == (len(fx[f"errors_{s}"]) > 0)
        assert np.isfinite(fx[f"errors_{s}"]).all()


def test_summary_reproduces_jax(fx):
    seeds = [s for s in fx["seeds"].tolist() if fx[f"has_stream_{s}"]]
    got = ate.summarize([fx[f"errors_{s}"] for s in seeds],
                        [fx[f"times_{s}"] for s in seeds])
    want = dict(zip(fx["summary_keys"].tolist(), fx["summary"].tolist()))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k
    for s in seeds:
        e = fx[f"errors_{s}"]
        margins = [np.abs(e - t).min() for t in (1.0, 2.0, 5.0)]
        np.testing.assert_array_equal(margins, fx[f"margin_km_{s}"])
        t5 = ate.time_to_threshold(e, fx[f"times_{s}"], 5.0)
        assert (t5 is None and np.isnan(fx[f"time_to_5km_s_{s}"])) \
            or t5 == float(fx[f"time_to_5km_s_{s}"])


def test_seed1_is_the_eval_orbit(fx):
    ev = np.load(os.path.join(DATA, "torch_eval_seed1.npz"))
    sim = np.load(os.path.join(DATA, "torch_sim_seed1.npz"))
    for k in ("errors", "final_error_km", "time_to_5km_s", "crlb_final_km",
              "crlb_last_knot_km", "crlb_att_final_km", "obs_span_s"):
        np.testing.assert_allclose(fx[f"{k}_1"], ev[k], rtol=0, atol=1e-9)
    for k in ("times", "num_windows", "recovery_trips", "n_obs"):
        np.testing.assert_array_equal(fx[f"{k}_1"], ev[k])
    for k in ("oe", "q0", "w0", "score", "noise", "conf"):
        np.testing.assert_allclose(fx[f"{k}_1"], sim[f"{k}_b"], rtol=0,
                                   atol=1e-9)
    for k in ("db_seed", "score_frame", "score_landmark"):
        np.testing.assert_array_equal(fx[f"{k}_1"], sim[f"{k}_b"])
    np.testing.assert_array_equal(fx["frames_1"], sim["det_rows_b"][:, 0])
