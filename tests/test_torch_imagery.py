"""PyTorch port vs JAX package: sim/imagery.py (templates, the raster
render, the NCC surface, its peaks and their sub-pixel refinement, the
template detector) and sim/detector.py, on the CPU.

Inputs come from numpy seeds or JAX's own draws.  Tolerances:
  * templates from JAX's normal draws: 1e-6 (float32 sums in another
    order);
  * the render: the float32 raster from JAX's eager noise bit for bit
    (each paste adds amplitude * template in one rounding, as XLA's fused
    multiply-add).  The uint8 rasters of the imagery fixture's six regions
    from the noise image JAX's jitted render computes (XLA folds
    0.15 * sqrt(2) into one constant, tests/torch_parity.py) within one
    grey level at <= 1e-5 of the pixels (measured: 0 in five regions, 16
    of 1,966,080 in case b's second, where XLA's fused program evaluates
    the noise another way than the same expression alone: its
    normalization of the port's float32 image is bit for bit), and from
    0.15 times the eager draws within one grey level at <= 1e-4 of the
    pixels (measured: 18, 1 and 0 in case a);
  * NCC surfaces and peak scores 1e-5 (float32 correlations of 144 taps
    summed in another order; the local norm is exact on integer images);
    sub-pixel positions 1e-4 px where the peak is a match (score > 0.3),
    vetoed candidates exactly -1 at their own position.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (IMAGERY_FIXTURE, jax_region_noise,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu.sim import detector as jdetector
from vinsat_tpu.sim import imagery as jim
from vinsat_tpu_torch.sim import detector, imagery
from vinsat_tpu_torch.tools.raster import Affine

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                  IMAGERY_FIXTURE)


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene(rng, K=8, H=96, W=128, sep=16.0):
    """JAX templates and an eager-rendered float32 scene: K landmarks at
    least `sep` px apart (a few overlapping pairs when sep is small)."""
    templates = jim.make_landmark_templates(jax.random.PRNGKey(4), K, 12)
    pts = []
    while len(pts) < K:
        p = rng.uniform(8, [W - 8, H - 8])
        if all(np.hypot(*(p - q)) >= sep for q in pts):
            pts.append(p)
    pos = np.array(pts)
    img = jim.render_region_image(jax.random.PRNGKey(5), H, W, templates,
                                  jnp.asarray(pos), noise_sigma=0.1,
                                  amplitude=1.5)
    return np.asarray(templates), pos, np.asarray(img)


def test_templates_from_jax_draws():
    key = jax.random.PRNGKey(0)
    z = jax.random.normal(key, (10, 12, 12), jnp.float32)
    want = np.asarray(jim.make_landmark_templates(key, 10, 12))
    got = imagery.normalize_templates(_t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    own = imagery.make_landmark_templates(torch.Generator().manual_seed(3),
                                          5, 12, device="cpu")
    again = imagery.make_landmark_templates(
        torch.Generator().manual_seed(3), 5, 12, device="cpu")
    assert torch.equal(own, again) and own.dtype == torch.float32
    assert float(own.sum(dim=(1, 2)).abs().max()) < 1e-5
    np.testing.assert_allclose(own.flatten(1).norm(dim=1).numpy(), 1.0,
                               atol=1e-6)


def test_render_from_jax_noise_bit_for_bit():
    rng = np.random.default_rng(0)
    K, H, W = 12, 64, 96
    templates = jim.make_landmark_templates(jax.random.PRNGKey(1), K, 12)
    # overlapping pastes, one on the border (not drawn), one outside
    pos = np.concatenate([rng.uniform(10, [W - 10, H - 10], (K - 2, 2)),
                          [[3.0, 30.0], [-40.0, 500.0]]])
    pos[1] = pos[0] + 3.5
    key = jax.random.PRNGKey(2)
    want = np.asarray(jim.render_region_image(
        key, H, W, templates, jnp.asarray(pos), noise_sigma=0.15,
        amplitude=1.5))
    noise = 0.15 * _t(jax.random.normal(key, (H, W), jnp.float32))
    got = imagery.render_from_draws(noise, _t(templates), pos, 1.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, noise)


@pytest.mark.parametrize("case", ["a", "b"])
def test_region_rasters_of_the_fixture(case):
    fx = np.load(FX)
    noise = jax_region_noise(int(fx["seed"]))
    k_img = jax.random.split(jax.random.PRNGKey(int(fx["seed"])), 4)[3]
    templates = fx[f"templates_{case}"]
    lon_lat = fx[f"class_lonlat_{case}"]
    for ci, aff in enumerate(fx[f"affine_{case}"]):
        want = fx[f"raster{ci}_{case}"]
        H, W = want.shape
        t = Affine(*aff)
        cols, rows = t.world_to_pixel(lon_lat[:, 0], lon_lat[:, 1])
        px = np.stack([cols, rows], 1)
        jax_u8 = np.asarray(jim.render_region_u8(
            jax.random.fold_in(k_img, ci), H, W, jnp.asarray(templates),
            jnp.asarray(px), amplitude=1.5))
        read = want > 0
        np.testing.assert_array_equal(jax_u8[read], want[read])
        got = imagery.to_u8(imagery.render_from_draws(
            noise(ci, H, W), _t(templates), px, 1.5)).numpy()
        d = np.abs(got.astype(int) - jax_u8)
        assert d.max() <= 1 and (d > 0).sum() <= 1e-5 * d.size, (
            ci, int((d > 0).sum()))
        eager = 0.15 * _t(jax.random.normal(jax.random.fold_in(k_img, ci),
                                            (H, W), jnp.float32))
        got_e = imagery.to_u8(imagery.render_from_draws(
            eager, _t(templates), px, 1.5)).numpy()
        d = np.abs(got_e.astype(int) - jax_u8)
        assert d.max() <= 1 and (d > 0).sum() <= 1e-4 * d.size, (
            ci, int((d > 0).sum()))


def test_ncc_surface_and_quad_offsets():
    rng = np.random.default_rng(1)
    templates, _, img = _scene(rng)
    u8 = np.clip((img - img.min()) / (img.max() - img.min()) * 255, 0,
                 255).astype(np.uint8).astype(np.float32)
    for x in (img, u8):
        want = np.asarray(jim._ncc_surface(jnp.asarray(x),
                                           jnp.asarray(templates)))
        got = imagery._ncc_surface(_t(x)[None], _t(templates))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # offsets on surfaces with peaks inside, on every border, on plateaus
    K, Hc, Wc = 9, 7, 8
    surf = rng.normal(size=(K, Hc, Wc)).astype(np.float32)
    r_i = np.array([3, 0, Hc - 1, 2, 4, 3, 1, 5, 2])
    c_i = np.array([3, 4, 2, 0, Wc - 1, 5, 1, 6, 2])
    surf[np.arange(K), r_i, c_i] += 4.0
    surf[5, 2:5, 4:7] = surf[5, 3, 5]  # a plateau: no concave fit
    want = jim._quad_offsets(jnp.asarray(surf), jnp.asarray(r_i),
                             jnp.asarray(c_i))
    got = imagery._quad_offsets(_t(surf), _t(r_i), _t(c_i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert float(got[0][5]) == 0.0 and float(got[1][5]) == 0.0


def test_correlate_peaks_and_template_detector():
    rng = np.random.default_rng(2)
    templates, pos, img = _scene(rng, K=8, H=112, W=144, sep=20.0)
    imgs = np.stack([img, img[::-1, ::-1].copy()])
    want = [np.asarray(a) for a in jim.correlate_peaks_batch(
        jnp.asarray(imgs), jnp.asarray(templates))]
    got = [a.numpy() for a in imagery.correlate_peaks_batch(
        _t(imgs), _t(templates))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    match = want[0] > 0.3
    assert match[0].all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[match], w[match], rtol=0, atol=1e-4)
    rows = imagery.TemplateDetector(_t(templates)).predict(
        img, 0.5, np.arange(8))
    rows_j = jim.TemplateDetector(jnp.asarray(templates)).predict(
        img, 0.5, np.arange(8))
    assert rows.shape == rows_j.shape == (8, 4)
    np.testing.assert_allclose(rows, rows_j, rtol=0, atol=1e-4)
    assert (np.hypot(rows[:, 1] - pos[:, 0], rows[:, 2] - pos[:, 1])
            < 1.0).all()


def test_refine_peaks_ncc_with_vetoes():
    rng = np.random.default_rng(3)
    templates, pos, img = _scene(rng, K=8, H=112, W=144, sep=20.0)
    rows = (pos[:, 1] + rng.uniform(-3, 3, 8)).astype(np.float32)
    cols = (pos[:, 0] + rng.uniform(-3, 3, 8)).astype(np.float32)
    # beyond the 4 px search radius: the peak lands on the window's edge
    rows[2] += 8.0
    cols[5] -= 9.0
    rows[6] -= 10.0
    want = [np.asarray(a) for a in jim.refine_peaks_ncc(
        jnp.asarray(img), jnp.asarray(templates), jnp.asarray(rows),
        jnp.asarray(cols))]
    got = [a.numpy() for a in imagery.refine_peaks_ncc(
        _t(img), _t(templates), _t(rows), _t(cols))]
    veto = want[2] == -1.0
    assert veto[[2, 5, 6]].any() and veto.sum() <= 4
    np.testing.assert_array_equal(got[2] == -1.0, veto)
    np.testing.assert_array_equal(got[0][veto], rows[veto])
    np.testing.assert_array_equal(got[1][veto], cols[veto])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    ok = ~veto
    ok[[2, 5, 6]] = False
    assert (np.hypot(got[0][ok] - pos[ok, 1], got[1][ok] - pos[ok, 0])
            < 1.0).all()


def test_noise_model_and_run_image_detector():
    uv = torch.full((4000, 2), 100.0, dtype=torch.float64)
    nm = detector.NoiseModelDetector()
    a, ca = nm(uv, torch.Generator().manual_seed(0))
    b, cb = nm(uv, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert abs(float((a - uv).std()) - 4.0) < 0.2
    assert 0.5 <= float(ca.min()) and float(ca.max()) <= 1.0
    rng = np.random.default_rng(4)
    templates, pos, img = _scene(rng, K=6, H=100, W=100, sep=24.0)
    t = Affine(0.01, 0.0, 10.0, 0.0, -0.01, 52.0)
    det = imagery.TemplateDetector(_t(templates))
    cls_ll = {k: t.pixel_to_world(pos[k, 0], pos[k, 1]) for k in range(6)}
    args = (img, t, lambda lo, la: t.world_to_pixel(lo, la),
            lambda k: cls_ll[k], 0.3, np.arange(6))
    got = detector.run_image_detector(det, *args)
    np.testing.assert_array_equal(got, jdetector.run_image_detector(det,
                                                                    *args))
    assert got.shape == (6, 5)
    assert (np.hypot(*(np.array(t.world_to_pixel(got[:, 0], got[:, 1]))
                       - got[:, 2:4].T)) < 1.0).all()


def test_detection_restores_tf32_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with imagery.exact_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            imagery.make_landmark_templates(torch.Generator(), 2)
