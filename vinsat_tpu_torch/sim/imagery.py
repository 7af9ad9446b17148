"""Synthetic raster imagery and the NCC template detector (port of
vinsat_tpu/sim/imagery.py).

  * `make_landmark_templates`: one zero-mean unit-norm texture patch a
    landmark class, from a CPU `torch.Generator`;
  * `render_region_image` / `render_region_u8`: a region raster, noise
    plus each class's template pasted at its pixel position, and its
    min-max uint8 form (`to_u8`).  The draw is split from a deterministic
    core (`render_from_draws`) that takes the noise image, so the JAX
    package's noise gives the JAX package's raster;
  * `TemplateDetector` / `correlate_peaks_batch`: the zero-mean normalized
    cross-correlation of each crop with every class template (three
    `F.conv2d` calls), the best peak a class refined to sub-pixel by a
    parabola through its neighbours;
  * `refine_peaks_ncc`: matched-filter re-localization of candidate
    positions in a small window around each (gathers and one einsum over
    every class and proposal at once).

Rendering and detection run in float32, as in the JAX package, and the
detection functions run with TF32 off (`exact_f32`): the card's default
cuDNN convolutions round their inputs to TF32, which moves the NCC
surfaces by ~1e-3 and with them argmax peaks and gates.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device


@contextlib.contextmanager
def exact_f32():
    """Convolutions (cuDNN) and matmuls (cuBLAS) in true float32 inside
    the block, the previous TF32 flags restored after."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def normalize_templates(z: torch.Tensor) -> torch.Tensor:
    """(K, S, S) raw patches -> zero-mean, unit-norm patches."""
    t = z - z.mean(dim=(1, 2), keepdim=True)
    return t / torch.linalg.vector_norm(t.reshape(t.shape[0], -1),
                                        dim=1)[:, None, None]


def make_landmark_templates(generator: torch.Generator, num_classes: int,
                            size: int = 12, device=DEFAULT_DEVICE):
    """(K, size, size) float32 zero-mean unit-norm texture patches, drawn
    from the CPU generator."""
    z = torch.randn((num_classes, size, size), generator=generator,
                    dtype=torch.float32)
    return normalize_templates(z).to(resolve_device(device))


def render_from_draws(noise: torch.Tensor, templates: torch.Tensor,
                      px_positions, amplitude: float = 1.0):
    """render_region_image's deterministic core: the (H, W) float32 noise
    image (noise_sigma times standard-normal draws, on the raster's
    device) with amplitude * templates[k] added, class after class, at
    the (S, S) window centred on round(px_positions[k]) (col, row),
    clipped into the image.  A class whose centre lies within S/2 of the
    border or outside is not drawn.  Each add rounds once to float32, as
    the JAX package's fused multiply-add does (the product amplitude *
    template is exact in float64)."""
    H, W = noise.shape
    K, S, _ = templates.shape
    img = noise.clone()
    half = S // 2
    pos = np.asarray(px_positions.cpu() if isinstance(px_positions,
                                                      torch.Tensor)
                     else px_positions, np.float64)
    c, r = pos[:K, 0], pos[:K, 1]
    # numpy rounds half to even, as jnp.round
    r0 = np.clip(np.round(r).astype(np.int64) - half, 0, H - S)
    c0 = np.clip(np.round(c).astype(np.int64) - half, 0, W - S)
    inside = (r >= half) & (r < H - half) & (c >= half) & (c < W - half)
    patches = amplitude * templates.to(img.device, torch.float64)
    for k in np.nonzero(inside)[0]:
        sl = img[r0[k]:r0[k] + S, c0[k]:c0[k] + S]
        sl.copy_(sl + patches[k])
    return img


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Min-max normalization to uint8: (img - lo) / (hi - lo) * 255,
    clipped, cast by truncation."""
    lo, hi = img.min(), img.max()
    return ((img - lo) / (hi - lo) * 255.0).clamp(0, 255).to(torch.uint8)


def render_region_image(generator: torch.Generator, H: int, W: int,
                        templates: torch.Tensor, px_positions,
                        noise_sigma: float = 0.15, amplitude: float = 1.0):
    """A synthetic single-channel (H, W) float32 region raster on the
    templates' device, its noise drawn from the CPU generator;
    px_positions (K, 2) (col, row) of each class's landmark."""
    noise = noise_sigma * torch.randn((H, W), generator=generator,
                                      dtype=torch.float32)
    return render_from_draws(noise.to(templates.device), templates,
                             px_positions, amplitude)


def render_region_u8(generator: torch.Generator, H: int, W: int,
                     templates: torch.Tensor, px_positions,
                     noise_sigma: float = 0.15, amplitude: float = 1.0):
    """render_region_image, min-max normalized to uint8."""
    return to_u8(render_region_image(generator, H, W, templates,
                                     px_positions, noise_sigma, amplitude))


def _ncc_surface(imgs: torch.Tensor, templates: torch.Tensor):
    """Zero-mean NCC surfaces (F, K, H-S+1, W-S+1) of each (zero-mean)
    template over each image of imgs (F, H, W): the correlation over the
    local patch's centred norm sqrt(max(sum x^2 - (sum x)^2 / S^2,
    1e-12)), three convolutions."""
    S = templates.shape[-1]
    x = imgs[:, None]
    corr = F.conv2d(x, templates[:, None])
    ones = torch.ones((1, 1, S, S), dtype=x.dtype, device=x.device)
    sq = F.conv2d(x * x, ones)
    sm = F.conv2d(x, ones)
    var = torch.clamp(sq - sm * sm / (S * S), min=1e-12)
    return corr.div_(torch.sqrt(var))


def _flat_gather(surface, idx):
    """surface (..., Hc, Wc) read at flat indices idx (...)."""
    return surface.flatten(-2).gather(-1, idx[..., None])[..., 0]


def _quad_offsets(surface, r_i, c_i):
    """Sub-pixel peak offsets (dr, dc) in [-1, 1] by a parabola through the
    peak and its two neighbours along each axis; 0 where the fit is
    degenerate (the peak on the map's border, or samples not concave).
    surface (..., Hc, Wc), r_i / c_i (...) integer peak coordinates."""
    Hc, Wc = surface.shape[-2:]

    def grab(dr, dc):
        return _flat_gather(surface, (r_i + dr).clamp(0, Hc - 1) * Wc
                            + (c_i + dc).clamp(0, Wc - 1))

    s0 = grab(0, 0)

    def axis_off(sm, sp, at_border):
        denom = sm - 2.0 * s0 + sp
        ok = (~at_border) & (denom < -1e-12)
        off = 0.5 * (sm - sp) / torch.where(ok, denom,
                                            torch.ones_like(denom))
        return torch.where(ok, off.clamp(-1.0, 1.0), torch.zeros_like(off))

    dr = axis_off(grab(-1, 0), grab(1, 0), (r_i <= 0) | (r_i >= Hc - 1))
    dc = axis_off(grab(0, -1), grab(0, 1), (c_i <= 0) | (c_i >= Wc - 1))
    return dr, dc


def _argmax_2d(surface):
    """First maximum of each (Hc, Wc) map: (value, row, col)."""
    Wc = surface.shape[-1]
    idx = surface.flatten(-2).argmax(dim=-1)
    return _flat_gather(surface, idx), idx // Wc, idx % Wc


def refine_batch(imgs, templates, rows, cols, radius: int = 4):
    """Matched-filter sub-pixel re-localization of candidates, all at once.

    imgs (F, H, W) float32; templates (K, S, S); rows / cols (F, K, k)
    float32 candidate centres (class k's candidates correlate with
    template k).  Each candidate's (S + 2 radius)^2 window (its origin
    clipped into the image) is correlated with its template; the NCC
    argmax, parabola-refined, gives the position.  A peak on the window's
    edge (the true peak likely outside it) keeps the candidate's own
    position and reports peak -1, so the calibrated confidence 0.5 + 0.5
    peak is 0.  Returns (rows, cols, peak), (F, K, k) float32."""
    S = templates.shape[-1]
    H, W = imgs.shape[-2:]
    win = S + 2 * radius
    Wc = win - S + 1
    r0 = (rows.to(torch.int64) - S // 2 - radius).clamp(0, H - win)
    c0 = (cols.to(torch.int64) - S // 2 - radius).clamp(0, W - win)
    ar = torch.arange(win, device=imgs.device)
    f = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None, None,
                                                        None]
    patch = imgs[f, (r0[..., None] + ar)[..., :, None],
                 (c0[..., None] + ar)[..., None, :]]  # (F, K, k, win, win)
    views = patch.unfold(-2, S, 1).unfold(-2, S, 1)  # (..., Wc, Wc, S, S)
    corr = torch.einsum("fkjabst,kst->fkjab", views, templates)
    sq = (views * views).sum(dim=(-2, -1))
    sm = views.sum(dim=(-2, -1))
    ncc = corr / torch.sqrt(torch.clamp(sq - sm * sm / (S * S), min=1e-12))
    peak, ri, ci = _argmax_2d(ncc)
    drf, dcf = _quad_offsets(ncc, ri, ci)
    rf = (r0 + ri).to(torch.float32) + drf + S // 2
    cf = (c0 + ci).to(torch.float32) + dcf + S // 2
    interior = (ri > 0) & (ri < Wc - 1) & (ci > 0) & (ci < Wc - 1)
    return (torch.where(interior, rf, rows.to(torch.float32)),
            torch.where(interior, cf, cols.to(torch.float32)),
            torch.where(interior, peak, torch.full_like(peak, -1.0)))


def refine_peaks_ncc(img, templates, rows, cols, radius: int = 4):
    """refine_batch for one image (H, W) and one candidate a class (K,):
    returns (rows, cols, ncc_peak), each (K,) float32."""
    with exact_f32():
        out = refine_batch(img.to(torch.float32)[None], templates,
                           rows[None, :, None], cols[None, :, None], radius)
    return tuple(o[0, :, 0] for o in out)


def correlate_peaks_batch(imgs: torch.Tensor, templates: torch.Tensor):
    """Per-class best NCC peak of each crop, sub-pixel refined: imgs
    (F, H, W) (uint8 crops are cast to float32 on their device) against
    templates (K, S, S).  Returns (F, K) scores in [-1, 1], rows and cols
    (float32)."""
    S = templates.shape[-1]
    with exact_f32():
        ncc = _ncc_surface(imgs.to(torch.float32), templates)
        scores, r_i, c_i = _argmax_2d(ncc)
        dr, dc = _quad_offsets(ncc, r_i, c_i)
    return (scores, r_i.to(torch.float32) + dr + S // 2,
            c_i.to(torch.float32) + dc + S // 2)


class TemplateDetector(NamedTuple):
    """Normalized cross-correlation detector over class templates, an
    ImageDetector (sim/detector.py): predict(image, conf_threshold,
    classes) -> (M, 4) rows [cls, xc, yc, conf]."""

    templates: torch.Tensor  # (K, S, S) float32, on the detection device

    def predict(self, image, conf_threshold: float,
                classes) -> np.ndarray:
        img = torch.tensor(np.asarray(image), dtype=torch.float32,
                           device=self.templates.device)
        if img.ndim == 3:
            img = img.mean(dim=-1)
        scores, rows_, cols_ = (a[0].cpu().numpy() for a in
                                correlate_peaks_batch(img[None],
                                                      self.templates))
        cls_set = set(int(c) for c in np.asarray(classes))
        # NCC in [-1, 1] calibrated to a detector-style confidence in
        # [0, 1]: true matches (ncc ~0.6-0.9) land above the estimator's
        # conf > 0.8 gate, noise peaks (ncc ~0.3-0.5) below it
        out = [[k, float(c), float(r), 0.5 + 0.5 * float(s)]
               for k, (s, r, c) in enumerate(zip(scores, rows_, cols_))
               if k in cls_set and s > conf_threshold]
        return np.array(out) if out else np.zeros((0, 4))
