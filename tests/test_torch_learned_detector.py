"""PyTorch port vs JAX package: sim/learned_detector.py's inference path
(the PatchCNN, its grid detection with and without the matched-filter
stage, the weight carry-over) on the CPU, with the committed full-
difficulty detector tests/data/detector_full_snr1.npz (10 classes, 12 px
patches, stride 2).

Tolerances: logits 1e-4 relative to their largest (float32 convolution
and dense sums in another order); gated probabilities 1e-5; detection
scores 1e-5 and sub-pixel positions 1e-3 px where the score is above 0
(a class that owns no patch, or whose candidates are all vetoed, scores
exactly 0 at a position its ties leave arbitrary); grid positions
exactly.  The flax layout's round trip is bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu.evalx import px_err as jpx
from vinsat_tpu.sim import imagery as jim
from vinsat_tpu.sim import learned_detector as jld
from vinsat_tpu_torch.evalx import px_err
from vinsat_tpu_torch.sim import imagery
from vinsat_tpu_torch.sim import learned_detector as ld

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "detector_full_snr1.npz")


def _t(a):
    return torch.as_tensor(np.array(a))


def _separated(rng, K, H, W, min_d=18.0):
    pts = []
    while len(pts) < K:
        p = rng.uniform(20, W - 20, 2)
        if all(np.hypot(*(p - q)) >= min_d for q in pts):
            pts.append(p)
    return np.array(pts)


def _jax_scenes(n, seed=0, H=192, W=192):
    """n JAX-rendered 192 x 192 float32 scenes of the 10 fixture classes
    (tests/test_learned_detector_full.py's recipe) and their positions."""
    rng = np.random.default_rng(seed)
    templates = jim.make_landmark_templates(jax.random.PRNGKey(0), 10, 12)
    imgs, poss = [], []
    for trial in range(n):
        pos = _separated(rng, 10, H, W)
        imgs.append(np.asarray(jim.render_region_image(
            jax.random.fold_in(jax.random.PRNGKey(2), trial), H, W,
            templates, jnp.asarray(pos), noise_sigma=0.15, amplitude=1.5)))
        poss.append(pos)
    return np.asarray(templates), np.stack(imgs), np.stack(poss)


def test_patchcnn_logits_against_flax():
    jdet = jld.load_detector(FIXTURE)
    rng = np.random.default_rng(0)
    patches = rng.normal(size=(300, 12, 12)).astype(np.float32)
    x = np.asarray(jld._normalize_patches(jnp.asarray(patches)))
    np.testing.assert_allclose(
        ld._normalize_patches(_t(patches)).numpy(), x, rtol=0, atol=1e-6)
    random_params = jld.PatchCNN(num_classes=6).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 12, 12, 1)))["params"]
    for params, K in ((jdet.params, 10), (random_params, 6)):
        want = np.asarray(jld.PatchCNN(num_classes=K).apply(
            {"params": params}, jnp.asarray(x)[..., None]))
        model = ld.params_from_flax(params, 12, device="cpu")
        with torch.no_grad():
            got = model(_t(x)[:, None]).numpy()
        assert got.shape == (300, K + 1)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        back = ld.params_to_flax(model, 12)
        for layer, d in params.items():
            for leaf, v in d.items():
                np.testing.assert_array_equal(back[layer][leaf],
                                              np.asarray(v))
    gated_j = np.asarray(jld._gated_map(jdet.params, jnp.asarray(patches),
                                        10))
    model = ld.params_from_flax(jdet.params, 12, device="cpu")
    with torch.no_grad():
        gated = ld._gated_map(model, _t(patches), 10).numpy()
    np.testing.assert_allclose(gated, gated_j, rtol=0, atol=1e-5)
    # top-k of a map with ties: equal values keep the lower patch first
    tied = np.zeros((40, 3), np.float32)
    tied[[5, 9, 17, 30], 0] = 1.0
    tied[[2, 3], 1] = 0.5
    want = jld._topk_from_gated(jnp.asarray(tied), 7, 12, 2, 3)
    got = ld._topk_from_gated(_t(tied), 7, 12, 2, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_templates", [False, True])
def test_detect_peaks_batch_on_jax_scenes(with_templates):
    templates, imgs, pos = _jax_scenes(2)
    jdet = jld.load_detector(FIXTURE)
    det = ld.load_detector(FIXTURE, device="cpu")
    if with_templates:
        jdet = jdet._replace(templates=jnp.asarray(templates))
        det = det._replace(templates=_t(templates))
    want = [np.asarray(a) for a in jld.detect_peaks_batch(jdet, imgs)]
    got = [a.numpy() for a in ld.detect_peaks_batch(det, _t(imgs))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    on = want[0] > 0
    assert on.sum() >= 18
    tol = 1e-3 if with_templates else 0.0
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[on], w[on], rtol=0, atol=tol)
    if with_templates:
        err = np.hypot(got[2] - pos[..., 0], got[1] - pos[..., 1])
        assert (err[got[0] > 0.8] < 2.0).all()


def test_single_image_grid_detection():
    templates, imgs, _ = _jax_scenes(1, seed=2, H=96, W=96)
    jdet = jld.load_detector(FIXTURE)
    model = ld.load_detector(FIXTURE, device="cpu").model
    img = _t(imgs[0])
    with torch.no_grad():
        got = ld._detect_grid(model, img, 10, 12, 2)
        got_k = ld._detect_grid_topk(model, img, 10, 12, 2, 3)
    want = jld._detect_grid(jdet.params, jnp.asarray(imgs[0]), 10, 12, 2)
    want_k = jld._detect_grid_topk(jdet.params, jnp.asarray(imgs[0]), 10,
                                   12, 2, 3)
    for g, w, tol in zip(got + got_k, tuple(want) + tuple(want_k),
                         (1e-5, 0, 0) * 2):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)


def test_save_load_both_ways(tmp_path):
    templates, imgs, _ = _jax_scenes(1, seed=1, H=96, W=96)
    det = ld.load_detector(FIXTURE, device="cpu")._replace(
        templates=_t(templates))
    path = str(tmp_path / "port.npz")
    ld.save_detector(path, det)
    jdet = jld.load_detector(path)
    jref = jld.load_detector(FIXTURE)
    assert (jdet.num_classes, jdet.patch_size, jdet.stride) == (10, 12, 2)
    np.testing.assert_array_equal(np.asarray(jdet.templates), templates)
    for layer, d in jref.params.items():
        for leaf, v in d.items():
            np.testing.assert_array_equal(np.asarray(jdet.params[layer][leaf]),
                                          np.asarray(v))
    rows_j = jdet.predict(imgs[0], 0.5, np.arange(10))
    rows = det.predict(imgs[0], 0.5, np.arange(10))
    assert rows.shape == rows_j.shape and len(rows) >= 5
    np.testing.assert_allclose(rows, rows_j, rtol=0, atol=1e-3)
    jpath = str(tmp_path / "jax.npz")
    jld.save_detector(jpath, jdet)
    back = ld.load_detector(jpath, device="cpu")
    torch.testing.assert_close(back.templates, det.templates, rtol=0, atol=0)
    for a, b in zip(back.model.state_dict().values(),
                    det.model.state_dict().values()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(back.predict(imgs[0], 0.5, np.arange(10)),
                                  rows)


def test_reference_px_acceptance_gate():
    """The reference's acceptance statistic (per-class mean pixel error <
    10 px at conf > 0.5, px_err.error_records + class_stats) for the port's
    detector with the matched-filter stage, on the scenes of the JAX
    package's own gate (tests/test_learned_detector_full.py: layouts from
    default_rng(0), noise from fold_in(PRNGKey(5), trial)), rendered by
    the port from JAX's noise: every class must pass."""
    det = ld.load_detector(FIXTURE, device="cpu")
    templates = _t(jim.make_landmark_templates(jax.random.PRNGKey(0), 10,
                                               12))
    det = det._replace(templates=templates)
    rng = np.random.default_rng(0)
    H = W = 192
    recs = []
    for trial in range(4):
        pos = _separated(rng, 10, H, W)
        noise = 0.15 * _t(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(5), trial), (H, W),
            jnp.float32))
        img = imagery.render_from_draws(noise, templates, pos, 1.5)
        rows = det.predict(img.numpy(), 0.5, np.arange(10))
        recs.append(px_err.error_records(
            np.arange(10), pos / [W, H], rows[:, 0].astype(int),
            rows[:, 1:3] / [W, H], rows[:, 3], W, H))
    err = np.concatenate(recs)
    means = [px_err.class_stats(err, c, conf_threshold=0.5)[1]
             for c in range(10)]
    assert all(np.isfinite(m) and m < 10.0 for m in means), means
    assert means == [jpx.class_stats(err, c, 0.5)[1] for c in range(10)]
