"""Kernel K3's plain PyTorch twin against the JAX kernel (CPU).

Counts are integers, so every bound is exact: in f32 against the Pallas
kernel run in interpret mode (it casts its inputs to f32), in f64 against
`visible_count_reference`.  The boxes include ones that wrap the
antimeridian (lon_max > 180), empty ones (inf bounds, as a frame with no
corner hit gives), NaN ones, and landmarks on box edges (strict
comparisons).  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vinsat_tpu.kernels import matching
from vinsat_tpu_torch.kernels import visible_count as vc

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
