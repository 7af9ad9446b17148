"""The benchmark's own copy of the port's bench-arc simulation, frozen here
so that a change to the program cannot move the yardstick.

It makes the inputs of both cells from a seed and is the plain reference
of the simulator cell: every random number of one arc (`draw`), the
two-body + J2 RK4 truth at 1 Hz with the tumbling attitude
(`trajectory`), the landmark database along the ground track
(`track_db`), the imaging gate, the detection choice and the rows
[frame, lon, lat, u, v, conf] (`detections`), all on the host in numpy,
in float64 or, for the precision control, float32.  The draws come from
a CPU `torch.Generator`, the same stream the program's
`pipeline.draw_sim` and `sim.detections.DetectionDraws` read, so one
seed gives both sides the same numbers.

It imports nothing of the program.  The arithmetic follows
vinsat_tpu_torch/sim/{orbits,detections}.py, core/{dynamics,frames}.py,
sim/camera.py and pipeline.track_landmark_db as they stood when the
benchmark was written.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MU_EARTH = 398600.4418  # km^3/s^2
J2_COEFF = 1.75553e10  # km^5/s^2, the reference's r_mat J2 weight
RMAT = np.array([(6.0, -1.5, -1.5), (6.0, -1.5, -1.5), (3.0, -4.5, -4.5)])
R_EARTH_ALT_KM = 6378.0  # spherical radius of the altitude draw
_M_SAT = 4.0
INERTIA_3U = np.array([(_M_SAT / 12) * (0.1**2 + 0.34**2),
                       (_M_SAT / 12) * (0.1**2 + 0.34**2),
                       (_M_SAT / 12) * (0.1**2 + 0.1**2)])
THETA_G0_DEG = 280.16
OMEGA_EARTH_DEG_PER_S = 360.0 / 86164.100352
WGS84_A_KM = 6378.137
WGS84_B_KM = 6356.752
WGS84_E2 = 1.0 - (WGS84_B_KM**2 / WGS84_A_KM**2)
ELLIPSOID_A_M = 6378137.0
ELLIPSOID_C_M = 6356752.314245
WIDTH_PX, HEIGHT_PX, HFOV_DEG = 4608, 2592, 66.0
FOCAL_PX = (WIDTH_PX / 2) / math.tan(math.radians(HFOV_DEG) / 2)
CX, CY = WIDTH_PX / 2.0, HEIGHT_PX / 2.0


class Draws(NamedTuple):
    """Every random number of one arc but the detection stage's, which
    `generator` (positioned after these) still holds."""

    oe: tuple  # (a, e, i, Omega, omega, nu), km and rad
    q0: np.ndarray  # (4,) unit quaternion, scalar last
    w0: np.ndarray  # (3,) body rates, rad/s
    db_seed: int
    generator: torch.Generator


def generator_seed(seed: int, index: int) -> int:
    """A 64-bit generator seed from a run's seed and a request's index."""
    return int(np.random.SeedSequence([seed % 2**64, index % 2**64])
               .generate_state(1, np.uint64)[0])


def draw(gen_seed: int) -> Draws:
    """The draws of one arc from a CPU generator seeded with gen_seed:
    ISS-like or polar elements, the attitude, the database seed."""
    g = torch.Generator().manual_seed(gen_seed)

    def u() -> float:
        return float(torch.rand((), generator=g, dtype=torch.float64))

    if u() < 0.5:
        i0, jitter = 51.5 * math.pi / 180, 0.1
    else:
        i0, jitter = math.pi / 2, 0.2
    a = R_EARTH_ALT_KM + 525.0 + (575.0 - 525.0) * u()
    e = 0.01 * u()
    i = i0 + jitter * (u() - 0.5)
    ang = 2 * math.pi * u()
    q0 = torch.randn(4, generator=g, dtype=torch.float64)
    w0 = 2 * (math.pi / 180) * torch.randn(3, generator=g,
                                           dtype=torch.float64)
    q0 = q0 / torch.linalg.vector_norm(q0)
    db_seed = int(torch.randint(0, 2**31 - 1, (), generator=g))
    return Draws((a, e, i, ang, ang, ang), q0.numpy(), w0.numpy(), db_seed, g)


# ---------------------------------------------------------------------------
# truth: two-body + J2 orbit and rigid-body attitude, RK4 at 1 Hz
# ---------------------------------------------------------------------------


def _rot_z(g):
    c, s = math.cos(g), math.sin(g)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def oe_to_eci(oe) -> np.ndarray:
    """Keplerian elements -> ECI [r, v] (6,) in km, km/s (float64)."""
    a, e, i, Om, om, nu = oe
    n = math.sqrt(MU_EARTH / a**3)
    E = math.acos((e + math.cos(nu)) / (1 + e * math.cos(nu)))
    if nu > math.pi:
        E = 2 * math.pi - E
    b = math.sqrt(1 - e**2)
    r_peri = np.array([a * (math.cos(E) - e), a * b * math.sin(E), 0.0])
    v_peri = (a * n / (1 - e * math.cos(E))) * np.array(
        [-math.sin(E), b * math.cos(E), 0.0])
    R = _rot_z(Om) @ _rot_x(i) @ _rot_z(om)
    return np.concatenate([R @ r_peri, R @ v_peri])


def orbit_deriv(x, mu, j2, rmat):
    """[v, a(r)] with the reference's r_mat J2 acceleration."""
    r = x[:3]
    r2 = r * r
    rn = np.sqrt(r2.sum())
    acc = -(mu / rn**3) * r + (j2 / rn**7) * (rmat @ r2) * r
    return np.concatenate([x[3:], acc])


def rk4(f, x, h):
    """One classical RK4 step of x' = f(x)."""
    f1 = f(x)
    f2 = f(x + (0.5 * h) * f1)
    f3 = f(x + (0.5 * h) * f2)
    f4 = f(x + h * f3)
    return x + (h / 6) * ((f1 + 2 * f2) + 2 * f3 + f4)


def orbit_chain(x0, hs, dtype=np.float64) -> np.ndarray:
    """RK4 steps of sizes hs from the orbit state x0 (6,): (len(hs)+1, 6)."""
    mu, j2 = dtype(MU_EARTH), dtype(J2_COEFF)
    rmat = RMAT.astype(dtype)

    def f(x):
        return orbit_deriv(x, mu, j2, rmat)

    out = np.empty((len(hs) + 1, 6), dtype)
    x = np.asarray(x0, dtype)
    out[0] = x
    for k, h in enumerate(hs):
        x = rk4(f, x, dtype(h))
        out[k + 1] = x
    return out


def _qmul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def attitude_rollout(q0, w0, steps: int, dtype=np.float64) -> np.ndarray:
    """RK4 of [q (scalar last), w] under torque-free rigid-body motion of
    the 3U inertia, q renormalised each step: (steps+1, 7)."""
    J = INERTIA_3U.astype(dtype)
    half = dtype(0.5)
    zero = dtype(0.0)

    def f(x):
        q = x[:4] / np.sqrt((x[:4] * x[:4]).sum())
        w = x[4:]
        qd = half * _qmul(q, (w[0], w[1], w[2], zero))
        wd = -np.cross(w, J * w) / J
        return np.concatenate([qd, wd])

    out = np.empty((steps + 1, 7), dtype)
    x = np.concatenate([q0, w0]).astype(dtype)
    out[0] = x
    h = dtype(1.0)
    for k in range(steps):
        x = rk4(f, x, h)
        x = np.concatenate([x[:4] / np.sqrt((x[:4] * x[:4]).sum()), x[4:]])
        out[k + 1] = x
    return out


class Trajectory(NamedTuple):
    pos_eci: np.ndarray  # (T, 3) km
    vel_eci: np.ndarray  # (T, 3) km/s
    quat_body: np.ndarray  # (T, 4)
    pos_ecef: np.ndarray  # (T, 3) km


def eci_to_ecef(pos, times):
    th = np.deg2rad(THETA_G0_DEG + OMEGA_EARTH_DEG_PER_S * times)
    c, s = np.cos(th), np.sin(th)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    return np.stack([c * x + s * y, -s * x + c * y, z], axis=1)


def trajectory(d: Draws, duration_s: int, dtype=np.float64) -> Trajectory:
    """The truth of one arc at 1 Hz, in `dtype`."""
    orbit = orbit_chain(oe_to_eci(d.oe).astype(dtype), [1.0] * duration_s,
                        dtype)
    att = attitude_rollout(d.q0, d.w0, duration_s, dtype)
    times = np.arange(duration_s + 1, dtype=dtype)
    pos = orbit[:, :3]
    return Trajectory(pos, orbit[:, 3:], att[:, :4],
                      eci_to_ecef(pos, times).astype(dtype))


# ---------------------------------------------------------------------------
# landmarks along the track, the camera, the detections
# ---------------------------------------------------------------------------


class LandmarkDB(NamedTuple):
    lon: np.ndarray
    lat: np.ndarray


def track_db(traj: Trajectory, db_seed: int, every_s: int = 60,
             per_point: int = 4, spread_deg: float = 0.5,
             pass_every_s: int = 1800, pass_len_s: int = 300) -> LandmarkDB:
    """per_point landmarks within ~spread_deg of the sub-satellite point
    every every_s seconds of the passes [k pass_every_s, + pass_len_s),
    from numpy's default_rng(db_seed), every one accepted."""
    pos = traj.pos_ecef
    dtype = pos.dtype.type
    idx = np.arange(0, pos.shape[0], every_s)
    idx = idx[(idx % pass_every_s) < pass_len_s]
    x, y, z = pos[idx, 0], pos[idx, 1], pos[idx, 2]
    e2, a = dtype(WGS84_E2), dtype(WGS84_A_KM)
    lon = np.rad2deg(np.arctan2(y, x))
    p = np.sqrt(x**2 + y**2)
    lat_r = np.arctan2(z, p * (1 - e2))
    for _ in range(5):
        sl = np.sin(lat_r)
        N = a / np.sqrt(1 - e2 * sl**2)
        alt = p / np.cos(lat_r) - N
        lat_r = np.arctan2(z, p * (1 - e2 * N / (N + alt)))
    lat = np.rad2deg(lat_r)
    rng = np.random.default_rng(db_seed)
    lons = (lon[:, None] + rng.normal(size=(len(idx), per_point))
            * spread_deg).ravel()
    lats = (lat[:, None] + rng.normal(size=(len(idx), per_point))
            * spread_deg).ravel()
    return LandmarkDB(lons.astype(dtype), np.clip(lats, -79.0, 79.0)
                      .astype(dtype))


def nadir_rotation(pos):
    """Columns [x_c, y_c, z_c] of the nadir camera, boresight to the
    Earth's centre; pos (..., 3)."""
    zc = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    zhat = np.zeros_like(pos)
    zhat[..., 2] = 1
    rc = np.cross(zhat, zc)
    rc = rc / np.linalg.norm(rc, axis=-1, keepdims=True)
    yc = np.cross(rc, zc)
    return np.stack([-rc, yc, zc], axis=-1)


def ecef_to_geodetic(r):
    """ECEF km (..., 3) -> lat, lon degrees (5 fixed-point steps)."""
    dtype = r.dtype.type
    e2, a = dtype(WGS84_E2), dtype(WGS84_A_KM)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    lon = np.arctan2(y, x)
    p = np.sqrt(x**2 + y**2)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(5):
        N = a / np.sqrt(1 - e2 * np.sin(lat)**2)
        alt = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1 - e2 * N / (N + alt)))
    return np.rad2deg(lat), np.rad2deg(lon)


def footprint_bounds(pos_m, R):
    """The lon/lat box of the image's four corner rays on the ellipsoid
    (..., 4) and whether all four hit (...)."""
    dtype = pos_m.dtype.type
    corners = np.array([[0, 0], [WIDTH_PX, 0], [WIDTH_PX, HEIGHT_PX],
                        [0, HEIGHT_PX]], dtype)
    d_cam = np.stack([(corners[:, 0] - dtype(CX)) / dtype(FOCAL_PX),
                      (corners[:, 1] - dtype(CY)) / dtype(FOCAL_PX),
                      np.ones(4, dtype)], axis=-1)  # (4, 3)
    d = np.einsum("fij,cj->fci", R, d_cam)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    a = b = dtype(ELLIPSOID_A_M)
    c = dtype(ELLIPSOID_C_M)
    x, y, z = (pos_m[:, None, k] for k in range(3))
    u, v, w = d[..., 0], d[..., 1], d[..., 2]
    a2, b2, c2 = a * a, b * b, c * c
    value = -a2 * b2 * w * z - a2 * c2 * v * y - b2 * c2 * u * x
    radical = (a2 * b2 * w**2 + a2 * c2 * v**2 - a2 * v**2 * z**2
               + 2 * a2 * v * w * y * z - a2 * w**2 * y**2 + b2 * c2 * u**2
               - b2 * u**2 * z**2 + 2 * b2 * u * w * x * z - b2 * w**2 * x**2
               - c2 * u**2 * y**2 + 2 * c2 * u * v * x * y - c2 * v**2 * x**2)
    magnitude = a2 * b2 * w**2 + a2 * c2 * v**2 + b2 * c2 * u**2
    dist = (value - a * b * c * np.sqrt(np.clip(radical, 0, None))) / magnitude
    hit = (radical >= 0) & (dist >= 0)
    pts = pos_m[:, None, :] + dist[..., None] * d
    lat, lon = ecef_to_geodetic(pts / dtype(1000))
    lon = np.where(hit, lon, np.nan)
    lat = np.where(hit, lat, np.nan)

    def mn(t):
        return np.where(hit, t, np.inf).min(-1)

    def mx(t):
        return np.where(hit, t, -np.inf).max(-1)

    lo, hi = mn(lon), mx(lon)
    wrap = (hi - lo) > 180
    lon_w = np.where(lon < 0, lon + 360, lon)
    bounds = np.stack([np.where(wrap, mn(lon_w), lo), mn(lat),
                       np.where(wrap, mx(lon_w), hi), mx(lat)], axis=-1)
    return bounds, hit.all(-1)


def visible_count(bounds, lon, lat):
    """Landmarks strictly inside each box, each tested at lon and
    lon + 360."""
    lo, la0, hi, la1 = (bounds[:, k:k + 1] for k in range(4))
    lw = lon + 360
    in_lon = ((lon > lo) & (lon < hi)) | ((lw > lo) & (lw < hi))
    return (in_lon & (lat > la0) & (lat < la1)).sum(1)


def geodetic_to_ecef_km(lat_deg, lon_deg):
    dtype = lat_deg.dtype.type
    e2, a = dtype(WGS84_E2), dtype(WGS84_A_KM)
    phi, lam = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    N = a / np.sqrt(1 - e2 * np.sin(phi)**2)
    return np.stack([N * np.cos(phi) * np.cos(lam),
                     N * np.cos(phi) * np.sin(lam),
                     dtype(WGS84_B_KM**2 / WGS84_A_KM**2) * N * np.sin(phi)],
                    axis=-1)


class Detections(NamedTuple):
    gate: np.ndarray  # (Tf,) bool: the imaging gate of each strided frame
    rows: np.ndarray  # (M, 6) [frame, lon, lat, u, v, conf]


def detections(traj: Trajectory, db: LandmarkDB, generator: torch.Generator,
               frame_stride: int = 5, noise_px: float = 4.0,
               max_dets: int = 8, min_visible: int = 3,
               conf_low: float = 0.82, conf_high: float = 1.0) -> Detections:
    """The imaging gate (four corners on the Earth, >= min_visible
    landmarks in the footprint box), then in each gated frame up to
    max_dets in-view landmarks in decreasing order of a uniform score
    drawn for each in-view pair (row-major), Gaussian pixel noise and a
    uniform confidence for every slot: the rows of the valid slots."""
    dtype = traj.pos_ecef.dtype.type
    pos = traj.pos_ecef[::frame_stride] * dtype(1000)
    Tf, L = pos.shape[0], db.lon.shape[0]
    D = min(max_dets, L)
    R = nadir_rotation(pos)
    bounds, all_hit = footprint_bounds(pos, R)
    gate = all_hit & (visible_count(bounds, db.lon, db.lat) >= min_visible)
    lm = geodetic_to_ecef_km(db.lat, db.lon) * dtype(1000)
    gated = np.nonzero(gate)[0]
    rel = lm[None, :, :] - pos[gated, None, :]
    cam = np.einsum("fli,fij->flj", rel, R[gated])
    z = cam[..., 2]
    safe_z = np.where(np.abs(z) < 1e-9, dtype(1e-9), z)
    u = dtype(FOCAL_PX) * cam[..., 0] / safe_z + dtype(CX)
    v = dtype(FOCAL_PX) * cam[..., 1] / safe_z + dtype(CY)
    in_view = (z > 0) & (u >= 0) & (u < WIDTH_PX) & (v >= 0) & (v < HEIGHT_PX)
    score = np.full(in_view.shape, -1.0)
    n_pairs = int(in_view.sum())
    score[in_view] = torch.rand(n_pairs, generator=generator,
                                dtype=torch.float64).numpy()
    top = np.argsort(-score, axis=1, kind="stable")[:, :D]
    valid = np.zeros((Tf, D), bool)
    li = np.zeros((Tf, D), np.int64)
    uv = np.full((Tf, D, 2), np.nan, dtype)
    valid[gated] = np.take_along_axis(in_view, top, 1)
    li[gated] = top
    uv[gated, :, 0] = np.take_along_axis(u, top, 1)
    uv[gated, :, 1] = np.take_along_axis(v, top, 1)
    noise = torch.randn((Tf, D, 2), generator=generator,
                        dtype=torch.float64).numpy()
    conf_u = torch.rand((Tf, D), generator=generator,
                        dtype=torch.float64).numpy()
    uv = uv + dtype(noise_px) * noise.astype(dtype)
    conf = dtype(conf_low) + dtype(conf_high - conf_low) * conf_u.astype(dtype)
    t, d = np.nonzero(valid)
    k = li[t, d]
    rows = np.stack([t.astype(np.float64) * frame_stride, db.lon[k],
                     db.lat[k], uv[t, d, 0], uv[t, d, 1], conf[t, d]],
                    axis=1).astype(np.float64)
    return Detections(gate, rows)


class Arc(NamedTuple):
    draws: Draws
    traj: Trajectory
    db: LandmarkDB
    dets: Detections


def simulate(gen_seed: int, duration_s: int = 10800, frame_stride: int = 5,
             pass_every_s: int = 1800, pass_len_s: int = 300,
             noise_px: float = 4.0, max_dets: int = 8,
             dtype=np.float64) -> Arc:
    """One bench arc from its generator seed: truth, database along the
    track under the passes, detections."""
    d = draw(gen_seed)
    traj = trajectory(d, duration_s, dtype)
    db = track_db(traj, d.db_seed, pass_every_s=pass_every_s,
                  pass_len_s=pass_len_s)
    dets = detections(traj, db, d.generator, frame_stride, noise_px,
                      max_dets)
    return Arc(d, traj, db, dets)
