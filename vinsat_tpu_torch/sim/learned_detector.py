"""The learned landmark detector, inference (port of
vinsat_tpu/sim/learned_detector.py without its training loop).

`PatchCNN` classifies S x S single-channel patches into K landmark
classes plus background; a detector slides it over a crop on a stride-2
patch grid.  A patch detects class k only if k is its own softmax argmax
(background competes).  With class templates, the classifier's top three
owning patches a class are re-localized by the matched filter
(imagery.refine_batch) and the best-correlating one wins with the
calibrated confidence 0.5 + 0.5 ncc; without, positions stay on the
patch grid.

Weights come from the JAX package's npz (`load_detector`, flax keys
Conv_0 / Conv_1 / Dense_0 / Dense_1 with their kernel and bias,
__meta__ = [K, S, stride], __templates__): flax convolutions are NHWC
with HWIO kernels and flatten in (h, w, c) order, so the kernels are
transposed and Dense_0's rows permuted to the (c, h, w) order of an NCHW
flatten once, at load; `save_detector` writes the flax layout back, so
either package reads the other's file.

Detection runs in float32 with TF32 off (imagery.exact_f32) and under
no_grad, one crop at a time, its patches classified 8192 at a time (a
chunk's second convolution alone is 8192 x 32 x 144 float32 values,
151 MB).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.sim import imagery

# proposals a class for the matched-filter selection: the classifier's top
# patch alone misses landmarks whose best owning patch sits on a
# neighbouring texture; three candidates recover them
_PROPOSAL_TOPK = 3
_CHUNK = 8192


class PatchCNN(nn.Module):
    """S x S patch -> (K + 1) logits (class K = background): two 3 x 3
    SAME convolutions of `features` channels with ReLU, a dense layer of
    2 features with ReLU, a dense classifier."""

    def __init__(self, num_classes: int, patch_size: int = 12,
                 features: int = 32):
        super().__init__()
        self.conv0 = nn.Conv2d(1, features, 3, padding=1)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.dense0 = nn.Linear(patch_size * patch_size * features,
                                2 * features)
        self.dense1 = nn.Linear(2 * features, num_classes + 1)

    def forward(self, x):  # x (B, 1, S, S)
        x = F.relu(self.conv1(F.relu(self.conv0(x))))
        # (c, h, w) order: dense0's rows were permuted from flax's (h, w, c)
        return self.dense1(F.relu(self.dense0(x.flatten(1))))


def params_from_flax(params, patch_size: int,
                     device=DEFAULT_DEVICE) -> PatchCNN:
    """A PatchCNN on `device` holding the flax parameter tree `params`
    ({"Conv_0": {"kernel", "bias"}, ..., "Dense_1": ...}, arrays)."""
    g = {k: {n: torch.tensor(np.asarray(v), dtype=torch.float32)
             for n, v in d.items()} for k, d in params.items()}
    feats = g["Conv_0"]["kernel"].shape[-1]
    num_classes = g["Dense_1"]["kernel"].shape[-1] - 1
    model = PatchCNN(num_classes, patch_size, feats)
    S = patch_size
    d0 = g["Dense_0"]["kernel"]  # (S * S * feats, 2 feats), rows (h, w, c)
    d0 = d0.reshape(S, S, feats, -1).permute(2, 0, 1, 3).reshape(d0.shape)
    with torch.no_grad():
        for conv, name in ((model.conv0, "Conv_0"), (model.conv1, "Conv_1")):
            conv.weight.copy_(g[name]["kernel"].permute(3, 2, 0, 1))
            conv.bias.copy_(g[name]["bias"])
        model.dense0.weight.copy_(d0.T)
        model.dense0.bias.copy_(g["Dense_0"]["bias"])
        model.dense1.weight.copy_(g["Dense_1"]["kernel"].T)
        model.dense1.bias.copy_(g["Dense_1"]["bias"])
    return model.requires_grad_(False).eval().to(resolve_device(device))


def params_to_flax(model: PatchCNN, patch_size: int) -> dict:
    """The flax parameter tree (float32 numpy) of a PatchCNN."""
    S = patch_size

    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    d0 = model.dense0.weight.detach().T  # rows (c, h, w)
    feats = model.conv0.weight.shape[0]
    d0 = d0.reshape(feats, S, S, -1).permute(1, 2, 0, 3).reshape(d0.shape)
    return {
        "Conv_0": {"kernel": a(model.conv0.weight.permute(2, 3, 1, 0)),
                   "bias": a(model.conv0.bias)},
        "Conv_1": {"kernel": a(model.conv1.weight.permute(2, 3, 1, 0)),
                   "bias": a(model.conv1.bias)},
        "Dense_0": {"kernel": a(d0), "bias": a(model.dense0.bias)},
        "Dense_1": {"kernel": a(model.dense1.weight.T),
                    "bias": a(model.dense1.bias)}}


def _normalize_patches(patches):
    """Zero-mean, unit-norm patches (norm floored at 1e-6): the classifier
    sees neither the raster's brightness nor its contrast."""
    p = patches - patches.mean(dim=(-2, -1), keepdim=True)
    n = torch.sqrt(torch.sum(p * p, dim=(-2, -1), keepdim=True))
    return p / torch.clamp(n, min=1e-6)


def _extract_patches(img, S: int, stride: int):
    """(nr * nc, S, S) patches of img (H, W) on the stride grid, row-major;
    and nr, nc."""
    p = img.unfold(0, S, stride).unfold(1, S, stride)
    nr, nc = p.shape[:2]
    return p.reshape(nr * nc, S, S), nr, nc


def _gated_map(model, patches, num_classes: int):
    """(P, K) class probabilities of the patches, zero where the class is
    not the patch's own argmax over K + 1."""
    logits = model(_normalize_patches(patches)[:, None])
    full = torch.softmax(logits, dim=-1)
    cls_hat = full.argmax(dim=-1)
    ks = torch.arange(num_classes, device=patches.device)
    return torch.where(cls_hat[:, None] == ks[None], full[:, :num_classes],
                       torch.zeros((), dtype=full.dtype,
                                   device=full.device))


def _classify_gated_chunked(model, patches, num_classes: int,
                            batch: int = _CHUNK):
    """_gated_map over the patches `batch` at a time (patches are
    independent: the live activations stay one chunk's)."""
    return torch.cat([_gated_map(model, patches[i:i + batch], num_classes)
                      for i in range(0, patches.shape[0], batch)])


def _grid_positions(idx, nc: int, S: int, stride: int):
    """Patch indices -> (row, col) centres, float32."""
    return (((idx // nc) * stride + S // 2).to(torch.float32),
            ((idx % nc) * stride + S // 2).to(torch.float32))


def _best_from_gated(gated, nc: int, S: int, stride: int):
    """Best owning patch a class of a (P, K) gated map (the first of equal
    ones): (K,) probability, row, col."""
    idx = gated.argmax(dim=0)
    return (gated.gather(0, idx[None])[0],) + _grid_positions(idx, nc, S,
                                                               stride)


def _classify_patches(model, patches, nr, nc, num_classes, S, stride):
    """Best owning patch a class: (K,) probability, row, col."""
    return _best_from_gated(_gated_map(model, patches, num_classes), nc, S,
                            stride)


def _topk_from_gated(gated, nc: int, S: int, stride: int, k: int):
    """The k highest-probability owning patches a class of a (P, K) gated
    map: (vals, rows, cols), each (K, k).  Equal values keep the lower
    patch index first (a stable sort, as the JAX package's top_k); vals
    are 0 where a class owns fewer than k patches."""
    vals, idx = torch.sort(gated.T, dim=-1, descending=True, stable=True)
    return (vals[:, :k],) + _grid_positions(idx[:, :k], nc, S, stride)


def _detect_grid(model, img, num_classes: int, S: int, stride: int):
    """Best softmax probability and grid location a class, one image."""
    patches, nr, nc = _extract_patches(img, S, stride)
    return _classify_patches(model, patches, nr, nc, num_classes, S, stride)


def _detect_grid_topk(model, img, num_classes: int, S: int, stride: int,
                      k: int):
    """Top-k candidate locations a class, one image: (K, k) each."""
    patches, nr, nc = _extract_patches(img, S, stride)
    gated = _gated_map(model, patches, num_classes)
    return _topk_from_gated(gated, nc, S, stride, min(k, nr * nc))


def _detect_grid_batch(model, imgs, num_classes: int, S: int, stride: int,
                       batch: int = _CHUNK):
    """_detect_grid over (F, H, W) crops, one crop at a time, its patches
    chunked: (F, K) each."""
    out = []
    for im in imgs.to(torch.float32):
        patches, nr, nc = _extract_patches(im, S, stride)
        out.append(_best_from_gated(
            _classify_gated_chunked(model, patches, num_classes, batch), nc,
            S, stride))
    return tuple(torch.stack(o) for o in zip(*out))


def _detect_grid_batch_topk(model, imgs, num_classes: int, S: int,
                            stride: int, k: int, batch: int = _CHUNK):
    """Top-k proposals over (F, H, W) crops: (F, K, k) vals, rows, cols."""
    out = []
    for im in imgs.to(torch.float32):
        patches, nr, nc = _extract_patches(im, S, stride)
        gated = _classify_gated_chunked(model, patches, num_classes, batch)
        out.append(_topk_from_gated(gated, nc, S, stride,
                                    min(k, patches.shape[0])))
    return tuple(torch.stack(o) for o in zip(*out))


def _select_refined(imgs, tmpl, vals, rows_k, cols_k):
    """Refine every proposal (F, K, k) and keep the best-correlating one a
    class: (F, K) score, rows, cols, the score the calibrated confidence
    max(0.5 + 0.5 ncc, 0) of the winner (0 when no candidate is owned or
    every one is vetoed)."""
    rf, cf, pk = imagery.refine_batch(imgs, tmpl, rows_k, cols_k)
    pk = torch.where(vals > 0, pk, torch.full_like(pk, -1.0))
    j = pk.argmax(dim=-1, keepdim=True)  # first maximum
    best, rows_, cols_ = (a.gather(-1, j)[..., 0] for a in (pk, rf, cf))
    return torch.clamp(0.5 + 0.5 * best, min=0.0), rows_, cols_


class TrainedDetector(NamedTuple):
    """An ImageDetector (sim/detector.py) around a PatchCNN.  `templates`
    (K, S, S), when set, turns on the matched-filter localization and
    verification; without, positions stay on the stride grid."""

    model: PatchCNN
    num_classes: int
    patch_size: int
    stride: int = 2
    templates: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.model.dense1.weight.device

    def predict(self, image, conf_threshold: float,
                classes) -> np.ndarray:
        img = torch.tensor(np.asarray(image), dtype=torch.float32,
                           device=self.device)
        if img.ndim == 3:
            img = img.mean(dim=-1)
        probs, rows_, cols_ = (a[0].cpu().numpy() for a in
                               detect_peaks_batch(self, img[None]))
        cls_set = set(int(c) for c in np.asarray(classes))
        out = [[k, float(cols_[k]), float(rows_[k]), float(probs[k])]
               for k in range(self.num_classes)
               if k in cls_set and probs[k] > conf_threshold]
        return np.array(out) if out else np.zeros((0, 4))


def detect_peaks_batch(det: TrainedDetector, imgs):
    """Grid detection over (F, H, W) crops (uint8 crops are cast to
    float32 on their device): (F, K) scores, rows, cols, as
    imagery.correlate_peaks_batch.  Without det.templates the scores are
    softmax probabilities and the positions the patch grid's; with them,
    the top-3 proposals a class are matched-filter refined and the winner
    carries the calibrated 0.5 + 0.5 ncc (vetoed or unproposed classes
    exactly 0)."""
    imgs = imgs.to(torch.float32)
    args = (det.model, imgs, det.num_classes, det.patch_size, det.stride)
    with torch.no_grad(), imagery.exact_f32():
        if det.templates is None:
            return _detect_grid_batch(*args)
        vals, rk, ck = _detect_grid_batch_topk(*args, _PROPOSAL_TOPK)
        return _select_refined(imgs, det.templates.to(torch.float32), vals,
                               rk, ck)


def load_detector(path: str, device=DEFAULT_DEVICE) -> TrainedDetector:
    """A TrainedDetector on `device` from a save_detector npz of either
    package."""
    z = np.load(path)
    K, S, stride = (int(v) for v in z["__meta__"])
    params: dict = {}
    for name in z.files:
        if not name.startswith("__"):
            layer, leaf = name.split("/")
            params.setdefault(layer, {})[leaf] = z[name]
    device = resolve_device(device)
    templates = (torch.tensor(z["__templates__"], device=device)
                 if "__templates__" in z.files else None)
    return TrainedDetector(params_from_flax(params, S, device), K, S, stride,
                           templates)


def save_detector(path: str, det: TrainedDetector) -> None:
    """Write det as the JAX package's save_detector does: flax keys
    "<layer>/<kernel|bias>", __meta__ = [K, S, stride], __templates__ when
    set."""
    flat = {f"{layer}/{leaf}": v for layer, d in
            params_to_flax(det.model, det.patch_size).items()
            for leaf, v in d.items()}
    if det.templates is not None:
        flat["__templates__"] = det.templates.cpu().numpy()
    np.savez(path, __meta__=np.array([det.num_classes, det.patch_size,
                                      det.stride]), **flat)
