"""Regenerate tests/data/torch_imagery_seed1.npz: two runs of the JAX
package's imagery path (`pipeline.simulate_sequence_imagery`), which the
PyTorch port replays from JAX's draws and rasters on the CPU and the card.

Case a: `simulate_sequence_imagery(1, duration_s=600, frame_stride=60)`,
the NCC template detector at 60 classes.  Case b: the same seed with the
committed PatchCNN (tests/data/detector_full_snr1.npz) and its training
templates `make_landmark_templates(PRNGKey(0), 10, 12)`,
`num_landmarks=10`, `conf_threshold=0.5`.

Runs on the CPU in float64 (as the tests do) and stores under the suffix
_a / _b:
  oe, q0, w0, db_seed    the trajectory's draws and the DB's int seed;
  templates              (K, 12, 12) float32, as rendered and detected;
  class_lonlat           (K, 2) the classes' landmarks (lon, lat);
  raster{i}, affine      each region raster (uint8, H x W) as the path
                         reads it (the pixels outside every crop window
                         zeroed: they do not compress, and no stage
                         reads them) and its transform (a, b, c, d, e, f);
  win                    (F, 5) each crop: region, window origin x0 / y0
                         (the window transform's c, f), height, width;
  crop_hw                the (Hc, Wc) every crop is padded to;
  scores, rows, cols     (F, K) float32, the detector's per-crop output;
  det_rows               the sequence's rows;
  errors, times,         `run_streaming(seq, seed=1)`'s recorded errors,
  final_states           their times and the final knot states.
The region noise is not stored (it does not compress): the CPU tests draw
it from JAX's key, the card replays the rasters.

    python tests/data/make_torch_imagery_fixture.py [--check]

--check recomputes everything and compares it with the committed file
instead of overwriting it.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, os.path.join(HERE, ".."))

from torch_parity import jax_trajectory_draws  # noqa: E402
from vinsat_tpu import pipeline as jpipeline  # noqa: E402
from vinsat_tpu.sim import imagery as jimagery  # noqa: E402
from vinsat_tpu.sim import learned_detector as jld  # noqa: E402
from vinsat_tpu.tools import raster as jraster  # noqa: E402

SEED = 1
DETECTOR = os.path.join(HERE, "detector_full_snr1.npz")
KWARGS = {"a": dict(duration_s=600, frame_stride=60),
          "b": dict(duration_s=600, frame_stride=60, num_landmarks=10,
                    conf_threshold=0.5)}
PATH = os.path.join(HERE, "torch_imagery_seed1.npz")


def run_case(case: str) -> dict:
    """One simulate_sequence_imagery run with its rasters, crop windows
    and per-crop detections recorded on the way."""
    kw = dict(KWARGS[case])
    if case == "b":
        det = jld.load_detector(DETECTOR)
        kw["detector"] = det
        kw["templates"] = jimagery.make_landmark_templates(
            jax.random.PRNGKey(0), det.num_classes, det.patch_size)
    rec = {"templates": [], "rasters": [], "windows": [], "det": []}
    render = jimagery.render_region_u8
    register = jraster.RasterImageServer.register
    get_window = jraster.RasterImageServer.get_window
    mod, name = ((jimagery, "correlate_peaks_batch") if case == "a"
                 else (jld, "detect_peaks_batch"))
    detect = getattr(mod, name)

    def render_hook(key, H, W, templates, px, **k):
        rec["templates"].append(np.asarray(templates))
        return render(key, H, W, templates, px, **k)

    def register_hook(self, region, image, transform):
        rec["rasters"].append((np.asarray(image)[..., 0], tuple(transform)))
        return register(self, region, image, transform)

    def window_hook(self, region, *box):
        img, wt = get_window(self, region, *box)
        if img is not None and min(img.shape[:2]) >= 16:
            t = self._images[region][1]
            rec["windows"].append((int(region[1:]), wt.c, wt.f,
                                   img.shape[0], img.shape[1],
                                   round((wt.f - t.f) / t.e),
                                   round((wt.c - t.c) / t.a)))
        return img, wt

    def detect_hook(a, b):
        out = detect(a, b)
        crops = b if case == "b" else a
        rec["det"].append((np.shape(crops), [np.asarray(o) for o in out]))
        return out

    jimagery.render_region_u8 = render_hook
    jraster.RasterImageServer.register = register_hook
    jraster.RasterImageServer.get_window = window_hook
    setattr(mod, name, detect_hook)
    try:
        seq = jpipeline.simulate_sequence_imagery(SEED, **kw)
    finally:
        jimagery.render_region_u8 = render
        jraster.RasterImageServer.register = register
        jraster.RasterImageServer.get_window = get_window
        setattr(mod, name, detect)
    res = jpipeline.run_streaming(seq, seed=SEED)

    k_traj, k_lm, _, _ = jax.random.split(jax.random.PRNGKey(SEED), 4)
    oe, q0, w0 = jax_trajectory_draws(k_traj)
    F = len(rec["windows"])
    K = rec["templates"][0].shape[0]
    scores, rows, cols = (
        np.concatenate([d[1][i] for d in rec["det"]])[:F, :K]
        .astype(np.float32) for i in range(3))
    out = dict(
        kwargs=np.array(json.dumps(KWARGS[case])), oe=oe, q0=q0, w0=w0,
        db_seed=np.array(int(jax.random.randint(k_lm, (), 0, 2**31 - 1))),
        templates=rec["templates"][0].astype(np.float32),
        class_lonlat=np.stack([np.asarray(seq.db.lon)[:K],
                               np.asarray(seq.db.lat)[:K]], 1),
        affine=np.array([t for _, t in rec["rasters"]]),
        win=np.array([w[:5] for w in rec["windows"]], np.float64),
        crop_hw=np.array(rec["det"][0][0][-2:]),
        scores=scores, rows=rows, cols=cols,
        det_rows=np.asarray(seq.det_rows), errors=np.asarray(res.errors),
        times=np.asarray(res.times),
        final_states=np.asarray(res.final_states))
    for i, (img, _) in enumerate(rec["rasters"]):
        read = np.zeros(img.shape, bool)
        for reg, _, _, h, w, r0, c0 in rec["windows"]:
            if reg == i:
                read[max(r0, 0):max(r0 + h, 0),
                     max(c0, 0):max(c0 + w, 0)] = True
        out[f"raster{i}"] = np.where(read, img, 0).astype(np.uint8)
    return {f"{k}_{case}": v for k, v in out.items()}


def make() -> dict:
    return {"seed": np.array(SEED), **run_case("a"), **run_case("b")}


def differences(ref: dict, old) -> dict:
    """{key: True if it differs} between a fresh `make()` and a file."""
    out = {}
    for k, v in ref.items():
        o = old[k]
        same = (np.array_equal(o, v) if o.dtype.kind in "biuUS"
                else o.shape == v.shape
                and np.allclose(o, v, rtol=0, atol=1e-9))
        out[k] = not same
    return out


def main() -> None:
    ref = make()
    if "--check" in sys.argv[1:]:
        for k, bad in differences(ref, np.load(PATH)).items():
            print(f"{k}: {'DIFFERS' if bad else 'ok'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes): "
          + ", ".join(f"case {c}: {len(ref[f'det_rows_{c}'])} rows, "
                      f"{len(ref[f'win_{c}'])} crops, "
                      f"{len(ref[f'affine_{c}'])} rasters, final "
                      f"{ref[f'errors_{c}'][-1]:.6f} km" for c in "ab"))


if __name__ == "__main__":
    main()
