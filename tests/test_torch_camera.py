"""PyTorch port vs JAX: sim/camera (f64, CPU).

Pixels are held to 1e-6 px absolute; rays, ellipsoid hits and geodetic
corners to 1e-12 relative (both sides evaluate the same closed forms in
f64 and differ only in summation order).  The cases include rays that miss
the Earth (NaN points, false hit) and a footprint across ±180° (a wrapped
lon/lat box with lon_max > 180)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, rel_err
from vinsat_tpu.sim import camera as jcam
from vinsat_tpu_torch.sim import camera

CAM = camera.CameraModel.from_hfov()
JCAM = jcam.CameraModel.from_hfov()


def _positions(rng, n=12):
    """ECEF metres at ~550 km altitude; the last two over the antimeridian."""
    lon = np.deg2rad(rng.uniform(-180, 180, n))
    lon[-2:] = np.deg2rad([179.9, -179.95])
    lat = np.deg2rad(rng.uniform(-75, 75, n))
    r = 6928.0e3
    return np.stack([r * np.cos(lat) * np.cos(lon),
                     r * np.cos(lat) * np.sin(lon), r * np.sin(lat)], axis=1)


def _poses(rng):
    """Nadir poses, and tilted ones whose rays partly leave the Earth."""
    pos = _positions(rng)
    d = -pos / np.linalg.norm(pos, axis=1, keepdims=True)
    tilt = d + rng.normal(size=d.shape) * 0.6
    tilt /= np.linalg.norm(tilt, axis=1, keepdims=True)
    up = np.cross(tilt, rng.normal(size=d.shape))
    up /= np.linalg.norm(up, axis=1, keepdims=True)
    right = np.cross(up, tilt)
    return pos, (tilt, up, right)


def _pose_pair(pos, vecs=None):
    if vecs is None:
        return (camera.CameraPose.nadir(T(pos)),
                jcam.CameraPose.nadir(jnp.asarray(pos)))
    return (camera.CameraPose.from_vectors(T(pos), *(T(v) for v in vecs)),
            jcam.CameraPose.from_vectors(jnp.asarray(pos),
                                         *(jnp.asarray(v) for v in vecs)))


def test_camera_model_matches_jax():
    assert tuple(CAM) == tuple(JCAM)
    assert rel_err(CAM.K(), np.asarray(JCAM.K)) == 0.0


@pytest.mark.parametrize("tilted", [False, True])
def test_poses_and_projection_match_jax(tilted):
    rng = np.random.default_rng(1)
    pos, vecs = _poses(rng)
    pose, jpose = _pose_pair(pos, vecs if tilted else None)
    assert rel_err(pose.R_wc, jpose.R_wc) < 1e-12
    pts = pos[:, None, :] * 0.92 + rng.normal(size=(len(pos), 9, 3)) * 5e4
    uv, z = camera.world_to_pixel(CAM, pose, T(pts))
    juv, jz = jcam.world_to_pixel(JCAM, jpose, jnp.asarray(pts))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=0, atol=1e-6)
    assert rel_err(z, jz) < 1e-12
    pix = rng.uniform(0, 4608, size=(len(pos), 5, 2))
    assert rel_err(camera.pixel_to_ray(CAM, pose, T(pix)),
                   jcam.pixel_to_ray(JCAM, jpose, jnp.asarray(pix))) < 1e-12


def test_cast_ray_to_earth_matches_jax_with_misses():
    rng = np.random.default_rng(2)
    pos, vecs = _poses(rng)
    dirs = rng.normal(size=(len(pos), 16, 3))
    dirs[:, :8] -= 3.0 * pos[:, None, :] / np.linalg.norm(pos, axis=1)[
        :, None, None]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pt, hit = camera.cast_ray_to_earth(T(pos), T(dirs))
    jpt, jhit = jcam.cast_ray_to_earth(jnp.asarray(pos), jnp.asarray(dirs))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0 < int(hit.sum()) < hit.numel()
    assert torch.isnan(pt[~hit]).all()
    h = hit.numpy()
    assert rel_err(pt.numpy()[h], np.asarray(jpt)[h]) < 1e-12


@pytest.mark.parametrize("tilted", [False, True])
def test_footprint_matches_jax(tilted):
    rng = np.random.default_rng(3)
    pos, vecs = _poses(rng)
    pose, jpose = _pose_pair(pos, vecs if tilted else None)
    assert rel_err(camera.corner_rays(CAM, pose),
                   jcam.corner_rays(JCAM, jpose)) < 1e-12
    ll, hit = camera.footprint_lonlat(CAM, pose)
    jll, jhit = jcam.footprint_lonlat(JCAM, jpose)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-12,
                               atol=0, equal_nan=True)
    b, all_hit = camera.footprint_bounds(CAM, pose)
    jb, jall = jcam.footprint_bounds(JCAM, jpose)
    np.testing.assert_array_equal(all_hit.numpy(), np.asarray(jall))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-12,
                               atol=0)
    if tilted:
        assert not all_hit.all()
    else:
        assert all_hit.all()
        # the two frames over ±180° have wrapped boxes
        assert (b[-2:, 2] > 180.0).all() and (b[-2:, 0] < 180.0).all()
        assert (b[:, 2] - b[:, 0] < 90.0).all()  # contiguous boxes


def test_lonlat_to_pixel_matches_jax():
    rng = np.random.default_rng(4)
    pos = _positions(rng)
    pose, jpose = _pose_pair(pos)
    lon0 = np.rad2deg(np.arctan2(pos[:, 1], pos[:, 0]))
    lat0 = np.rad2deg(np.arcsin(pos[:, 2] / np.linalg.norm(pos, axis=1)))
    lon = lon0[:, None] + rng.normal(size=(len(pos), 20)) * 2.0
    lat = lat0[:, None] + rng.normal(size=(len(pos), 20)) * 2.0
    uv, z = camera.lonlat_to_pixel(CAM, pose, T(lon), T(lat))
    juv, jz = jcam.lonlat_to_pixel(JCAM, jpose, jnp.asarray(lon),
                                   jnp.asarray(lat))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=0, atol=1e-6)
    assert rel_err(z, jz) < 1e-12
