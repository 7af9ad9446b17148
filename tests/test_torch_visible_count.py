"""Kernel K3's plain PyTorch twin against the JAX kernel (CPU).

Counts are integers, so every bound is exact: in f32 against the Pallas
kernel run in interpret mode (it casts its inputs to f32), in f64 against
`visible_count_reference`.  The boxes include ones that wrap the
antimeridian (lon_max > 180), empty ones (inf bounds, as a frame with no
corner hit gives), NaN ones, and landmarks on box edges (strict
comparisons).  The kernel itself runs only on the card
(tests/test_torch_cuda.py); here a plain model of its tiled count (the
tile boxes' twin, the rule by which a warp skips a tile, the per-pair
test) is held equal to the twin and to JAX's reference on that file's
adversarial cases, region-ordered and shuffled, in f64 and f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vinsat_tpu.kernels import matching
from vinsat_tpu_torch.kernels import visible_count as vc

from test_torch_cuda import _cull_case, _onto_tile_box_edges

F, L = 37, 301


def _case(seed=0):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-180.0, 180.0, L)
    lat = rng.uniform(-80.0, 80.0, L)
    best = rng.uniform(size=L) < 0.7
    c_lon = rng.uniform(-180.0, 180.0, F)
    c_lat = rng.uniform(-70.0, 70.0, F)
    w, h = rng.uniform(10.0, 60.0, F), rng.uniform(5.0, 30.0, F)
    bounds = np.stack([c_lon - w, c_lat - h, c_lon + w, c_lat + h], axis=1)
    bounds[:6, 0] = rng.uniform(150.0, 179.0, 6)  # wrapped boxes
    bounds[:6, 2] = rng.uniform(181.0, 220.0, 6)
    bounds[6] = [np.inf, np.inf, -np.inf, -np.inf]  # no corner hit
    bounds[7, 2] = np.nan
    bounds[8] = [-180.0, -80.0, 180.0, 80.0]
    lon[:3], lat[:3] = bounds[9, 0], bounds[9, 1]  # on the box's edges
    lon[3] = bounds[0, 2] - 360.0  # on a wrapped box's east edge
    return bounds, lon, lat, best


def test_plain_matches_pallas_interpret_f32():
    bounds, lon, lat, best = _case(1)
    want = np.asarray(matching.visible_count(
        jnp.asarray(bounds, jnp.float32), jnp.asarray(lon, jnp.float32),
        jnp.asarray(lat, jnp.float32), jnp.asarray(best, jnp.float32),
        interpret=True))
    got = vc.visible_count_plain(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (bounds, lon, lat)),
        torch.as_tensor(best))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:6].sum() > 0 and want[6] == want[7] == 0


@pytest.mark.parametrize("seed", [0, 2])
def test_plain_matches_reference_f64(seed):
    bounds, lon, lat, best = _case(seed)
    want = np.asarray(matching.visible_count_reference(
        jnp.asarray(bounds), jnp.asarray(lon), jnp.asarray(lat),
        jnp.asarray(best.astype(np.float64))))
    got = vc.visible_count_plain(
        *(torch.as_tensor(a) for a in (bounds, lon, lat, best)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_is_strict_and_wraps():
    """Landmarks on the edges of the box (0, 0, 10, 10) are outside; one at
    lon -355 is inside through its lon + 360 test."""
    lon = torch.tensor([0.0, 10.0, 5.0, 5.0, 5.0, -355.0, -350.0])
    lat = torch.tensor([5.0, 5.0, 0.0, 10.0, 5.0, 5.0, 5.0])
    bounds = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    best = torch.ones(7, dtype=torch.bool)
    for dt in (torch.float32, torch.float64):
        assert vc.visible_count_plain(bounds.to(dt), lon.to(dt), lat.to(dt),
                                      best).tolist() == [2]


def test_wrapper_runs_plain_on_cpu():
    bounds, lon, lat, best = (torch.as_tensor(a) for a in _case(3))
    before = vc.visible_count.launches
    got = vc.visible_count(bounds, lon, lat, best)
    assert vc.visible_count.launches == before
    assert torch.equal(got, vc.visible_count_plain(bounds, lon, lat, best))


@pytest.mark.parametrize("bad,err", [
    (lambda b, lo, la, be: (b[:, :3], lo, la, be), ValueError),
    (lambda b, lo, la, be: (b, lo[:-1], la, be), ValueError),
    (lambda b, lo, la, be: (b, lo.float(), la, be), TypeError),
    (lambda b, lo, la, be: (b.long(), lo.long(), la.long(), be), TypeError),
    (lambda b, lo, la, be: (b, lo, la, be.double()), TypeError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    args = bad(*(torch.as_tensor(a) for a in _case(4)))
    with pytest.raises(err):
        vc.visible_count(*args)


# --- the tiled count's cull rule (what the kernel skips), modelled in plain
# PyTorch: the wrapper's tile boxes, the skip rule, the per-pair test; on
# the cases that tests/test_torch_cuda.py runs through the kernel --------

def _tiled_count(bounds, lon, lat, best, group):
    """The kernel's count in plain PyTorch: frames in groups of `group`
    (32: a warp; 1: each frame alone) run the lon (lon + 360) test of a
    tile only where one of them meets the tile's lon (lon + 360) box, by
    the count's strict compares; the pairs run are tested as the twin does.
    The frames' boxes are first set onto tile-box edges (frames 17-22)."""
    boxes = vc.tile_boxes_plain(lon, lat, best)  # (n, 6)
    n = boxes.shape[0]
    bounds = _onto_tile_box_edges(bounds, boxes)
    a0, b0, a1, b1 = (bounds[:, i:i + 1] for i in range(4))
    lat_ok = (b0 < boxes[:, 5]) & (boxes[:, 4] < b1)  # (F, n)
    hit_lon = lat_ok & (a0 < boxes[:, 1]) & (boxes[:, 0] < a1)
    hit_w = lat_ok & (a0 < boxes[:, 3]) & (boxes[:, 2] < a1)
    F = bounds.shape[0]
    pad_f = -F % group

    def by_group(hit):
        h = torch.nn.functional.pad(hit, (0, 0, 0, pad_f))
        h = h.view(-1, group, n).any(1, keepdim=True).expand(-1, group, n)
        return h.reshape(-1, n)[:F]

    run_lon, run_w = by_group(hit_lon), by_group(hit_w)
    pad_l = n * vc.TILE - lon.shape[0]
    nan = float("nan")
    lo = torch.nn.functional.pad(lon, (0, pad_l), value=nan).view(n, -1)
    la = torch.nn.functional.pad(torch.where(best, lat, nan), (0, pad_l),
                                 value=nan).view(n, -1)
    lw = lo + 360.0
    e = (slice(None), slice(None), None)  # (F, n) -> (F, n, 1)
    a0, b0, a1, b1 = (x[..., None] for x in (a0, b0, a1, b1))
    in_lon = (lo > a0) & (lo < a1) & run_lon[e]
    in_w = (lw > a0) & (lw < a1) & run_w[e]
    inside = (in_lon | in_w) & (la > b0) & (la < b1)
    return inside.sum((1, 2), dtype=torch.int32), bounds


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", ["regions", "shuffled"])
def test_tiled_cull_matches_plain_and_jax(order, dtype, group):
    bounds, lon, lat, best = _cull_case(order)
    args = [torch.as_tensor(a, dtype=dtype) for a in (bounds, lon, lat)]
    best_t = torch.as_tensor(best)
    got, bounds_t = _tiled_count(*args, best_t, group)
    want = vc.visible_count_plain(bounds_t, args[1], args[2], best_t)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want_jax = np.asarray(matching.visible_count_reference(
        jnp.asarray(bounds_t.numpy(), jdt), jnp.asarray(lon, jdt),
        jnp.asarray(lat, jdt), jnp.asarray(best.astype(np.float64), jdt)))
    np.testing.assert_array_equal(want.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the case exercises what it claims: hits through lon + 360, the
    # empty tile's box, inf boxes that see every accepted landmark
    boxes = vc.tile_boxes_plain(args[1], args[2], best_t)
    assert torch.isinf(boxes[2]).all() and (boxes[2, 0::2] > 0).all()
    assert want[:8].sum() > 0 and want[8] == want[10] == want[11] == 0
    assert int(want[9]) == int(best.sum())
    assert (want > 0).sum() > 20
