"""Training-label generation, geometry-only (the port's own numpy copy of
vinsat_tpu/tools/labeling.py; no device work).

Functional surface of labeling/label_ld.py:56-113: project landmark bbox
corners into an image grid and emit normalized YOLO label rows
[cls, xc_norm, yc_norm, w_norm, h_norm].  The reference's raster-specific
parts (rasterio CRS transform, PNG export) are replaced by an explicit
lon/lat window -> pixel grid mapping (equirectangular window), which is what
the projection reduces to for the label geometry.
"""
from __future__ import annotations

import numpy as np


def _rows_from_projected(landmarks, to_px, width: int, height: int
                         ) -> np.ndarray:
    """Shared label-row assembly: project the centroid + bbox corners
    through `to_px`, apply the reference's symmetric width/height
    doubling (labeling/label_ld.py:69-74) and all-corners-in-bounds gate
    (:75-79), and emit (K, 5) [cls_idx, xc_n, yc_n, w_n, h_n] rows."""
    lm = np.asarray(landmarks, dtype=np.float64)
    cu, cv = to_px(lm[:, 0], lm[:, 1])       # centroid
    tlu, tlv = to_px(lm[:, 2], lm[:, 5])     # (left_lon, top_lat)
    bru, brv = to_px(lm[:, 4], lm[:, 3])     # (right_lon, bot_lat)

    ws = np.maximum(cu - tlu, bru - cu) * 2
    hs = np.maximum(cv - tlv, brv - cv) * 2
    inb = (
        (tlu > 0) & (tlu < width) & (tlv > 0) & (tlv < height)
        & (bru > 0) & (bru < width) & (brv > 0) & (brv < height)
    )
    idx = np.where(inb)[0]
    return np.stack(
        [idx.astype(np.float64), cu[idx] / width, cv[idx] / height,
         ws[idx] / width, hs[idx] / height], axis=1
    )


def label_grid(landmarks: np.ndarray, lon_min: float, lat_min: float,
               lon_max: float, lat_max: float, width: int, height: int
               ) -> np.ndarray:
    """landmarks rows: [centroid_lon, centroid_lat, left_lon, bot_lat,
    right_lon, top_lat, ...] (the CSV column content of
    sim/landmark_csvs/*_top_salient.csv).

    Returns (K, 5) label rows for landmarks fully inside the window,
    replicating the symmetric width/height doubling of label_raster
    (labeling/label_ld.py:69-74) and the in-bounds gate (:75-79).
    """

    def to_px(lon, lat):
        u = (lon - lon_min) / (lon_max - lon_min) * width
        v = (lat_max - lat) / (lat_max - lat_min) * height
        return u, v

    return _rows_from_projected(landmarks, to_px, width, height)


# ---------------------------------------------------------------------------
# Raster-CRS labeling (label_ld.label_raster parity,
# labeling/label_ld.py:56-113)
# ---------------------------------------------------------------------------

WEB_MERCATOR_R = 6378137.0  # m, EPSG:3857 sphere radius


def lonlat_to_epsg3857(lon_deg, lat_deg):
    """Forward Web-Mercator projection (the pyproj lonlat->EPSG:3857
    transform of label_ld.py:63, implemented natively).  Latitude is clipped
    to the projection's +-85.051129 deg validity bound."""
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(np.clip(np.asarray(lat_deg, dtype=np.float64),
                             -85.051129, 85.051129))
    x = WEB_MERCATOR_R * lon
    y = WEB_MERCATOR_R * np.log(np.tan(np.pi / 4 + lat / 2))
    return x, y


def epsg3857_to_lonlat(x, y):
    """Inverse Web-Mercator (for round-trip validation)."""
    lon = np.degrees(np.asarray(x, dtype=np.float64) / WEB_MERCATOR_R)
    lat = np.degrees(
        2 * np.arctan(np.exp(np.asarray(y, dtype=np.float64)
                             / WEB_MERCATOR_R)) - np.pi / 2
    )
    return lon, lat


# --- native UTM / transverse Mercator (EPSG:326xx north / 327xx south) ----
#
# The reference projects landmark bboxes through ANY raster CRS via pyproj
# (labeling/label_ld.py:62-63).  The port does not depend on pyproj, so
# the CRS family that actually occurs for the MGRS-zone training rasters —
# UTM — is implemented natively: the Karney-Krueger series for the
# transverse Mercator (6th-order in the third flattening n), accurate to
# well under a millimeter inside a UTM zone.

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_UTM_K0 = 0.9996
_UTM_FE = 500000.0  # false easting, m
_UTM_FN_S = 10000000.0  # false northing (southern hemisphere), m

# third flattening and rectifying radius
_N3 = _WGS84_F / (2.0 - _WGS84_F)
_KK_A = _WGS84_A / (1.0 + _N3) * (1.0 + _N3 ** 2 / 4.0 + _N3 ** 4 / 64.0
                                  + _N3 ** 6 / 256.0)
# Krueger alpha (forward) / beta (inverse) series, 6th order in n
_KK_ALPHA = (
    _N3 / 2 - 2 * _N3 ** 2 / 3 + 5 * _N3 ** 3 / 16 + 41 * _N3 ** 4 / 180
    - 127 * _N3 ** 5 / 288 + 7891 * _N3 ** 6 / 37800,
    13 * _N3 ** 2 / 48 - 3 * _N3 ** 3 / 5 + 557 * _N3 ** 4 / 1440
    + 281 * _N3 ** 5 / 630 - 1983433 * _N3 ** 6 / 1935360,
    61 * _N3 ** 3 / 240 - 103 * _N3 ** 4 / 140 + 15061 * _N3 ** 5 / 26880
    + 167603 * _N3 ** 6 / 181440,
    49561 * _N3 ** 4 / 161280 - 179 * _N3 ** 5 / 168
    + 6601661 * _N3 ** 6 / 7257600,
    34729 * _N3 ** 5 / 80640 - 3418889 * _N3 ** 6 / 1995840,
    212378941 * _N3 ** 6 / 319334400,
)
_KK_BETA = (
    _N3 / 2 - 2 * _N3 ** 2 / 3 + 37 * _N3 ** 3 / 96 - _N3 ** 4 / 360
    - 81 * _N3 ** 5 / 512 + 96199 * _N3 ** 6 / 604800,
    _N3 ** 2 / 48 + _N3 ** 3 / 15 - 437 * _N3 ** 4 / 1440
    + 46 * _N3 ** 5 / 105 - 1118711 * _N3 ** 6 / 3870720,
    17 * _N3 ** 3 / 480 - 37 * _N3 ** 4 / 840 - 209 * _N3 ** 5 / 4480
    + 5569 * _N3 ** 6 / 90720,
    4397 * _N3 ** 4 / 161280 - 11 * _N3 ** 5 / 504
    - 830251 * _N3 ** 6 / 7257600,
    4583 * _N3 ** 5 / 161280 - 108847 * _N3 ** 6 / 3991680,
    20648693 * _N3 ** 6 / 638668800,
)
_E1 = np.sqrt(_WGS84_F * (2.0 - _WGS84_F))  # first eccentricity


def utm_central_meridian_deg(zone: int) -> float:
    """Central meridian of UTM zone 1..60 in degrees."""
    if not 1 <= zone <= 60:
        raise ValueError(f"UTM zone {zone} out of range 1..60")
    return zone * 6.0 - 183.0


def lonlat_to_utm(lon_deg, lat_deg, zone: int, north: bool = True):
    """Forward WGS84 lon/lat -> UTM easting/northing (m), Karney-Krueger
    transverse Mercator series (sub-mm inside the zone)."""
    lon = np.radians(np.asarray(lon_deg, np.float64))
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lam = lon - np.radians(utm_central_meridian_deg(zone))
    s = np.sin(lat)
    # conformal latitude via the Gauss-Schreiber tau
    t = np.sinh(np.arctanh(s) - _E1 * np.arctanh(_E1 * s))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
    xi = np.asarray(xi_p, np.float64).copy()
    eta = np.asarray(eta_p, np.float64).copy()
    for j, a_j in enumerate(_KK_ALPHA, start=1):
        xi = xi + a_j * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta = eta + a_j * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)
    E = _UTM_FE + _UTM_K0 * _KK_A * eta
    N = _UTM_K0 * _KK_A * xi + (0.0 if north else _UTM_FN_S)
    return E, N


def utm_to_lonlat(easting, northing, zone: int, north: bool = True):
    """Inverse UTM -> WGS84 lon/lat degrees (Karney-Krueger inverse series
    + 2 Newton steps on the conformal-latitude relation)."""
    E = np.asarray(easting, np.float64)
    N = np.asarray(northing, np.float64)
    xi = (N - (0.0 if north else _UTM_FN_S)) / (_UTM_K0 * _KK_A)
    eta = (E - _UTM_FE) / (_UTM_K0 * _KK_A)
    xi_p = np.asarray(xi, np.float64).copy()
    eta_p = np.asarray(eta, np.float64).copy()
    for j, b_j in enumerate(_KK_BETA, start=1):
        xi_p = xi_p - b_j * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b_j * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    t = np.sin(xi_p) / np.hypot(np.sinh(eta_p), np.cos(xi_p))
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    # invert tau(phi): Newton on t = sinh(atanh(sin phi) - e atanh(e sin phi))
    phi = np.arctan(t)
    for _ in range(3):
        s = np.sin(phi)
        f_val = np.sinh(np.arctanh(s) - _E1 * np.arctanh(_E1 * s)) - t
        dtau = (np.cosh(np.arctanh(s) - _E1 * np.arctanh(_E1 * s))
                * (1.0 - _E1 ** 2) / ((1.0 - (_E1 * s) ** 2) * np.cos(phi)))
        phi = phi - f_val / dtau
    lon = np.degrees(lam) + utm_central_meridian_deg(zone)
    return lon, np.degrees(phi)


def _parse_crs(crs: str):
    """CRS string -> projection fn lonlat->(x, y) or None if unsupported."""
    c = crs.upper().replace("EPSG:", "")
    if c == "3857":
        return lonlat_to_epsg3857
    if c == "4326":
        return lambda lon, lat: (np.asarray(lon, np.float64),
                                 np.asarray(lat, np.float64))
    if len(c) == 5 and c.isdigit() and c[:3] in ("326", "327"):
        zone = int(c[3:])
        if 1 <= zone <= 60:
            north = c[:3] == "326"
            return lambda lon, lat: lonlat_to_utm(lon, lat, zone, north)
    return None


def label_raster(landmarks: np.ndarray, transform, width: int, height: int,
                 crs: str = "EPSG:3857") -> np.ndarray:
    """YOLO labels for a REAL raster: project landmark bboxes through the
    raster's CRS + geotransform (label_ld.py:56-113).

    landmarks rows: [centroid_lon, centroid_lat, left_lon, bot_lat,
    right_lon, top_lat, ...] (the *_top_salient.csv column content);
    transform: a vinsat_tpu_torch.tools.raster.Affine mapping pixel -> CRS
    world coords (the GDAL geotransform); crs: "EPSG:3857" (Web-Mercator training GeoTIFFs),
    "EPSG:4326" (lon/lat degrees raster), or a UTM zone "EPSG:326xx" /
    "EPSG:327xx" (native Karney-Krueger transverse Mercator — the CRS
    family of MGRS-zone rasters; the reference reaches these via pyproj,
    label_ld.py:62-63).

    Returns (K, 5) rows [cls_idx, xc_n, yc_n, w_n, h_n] with the symmetric
    width/height doubling (:69-74) and the all-corners-in-bounds gate
    (:75-79) of the reference.
    """
    proj = _parse_crs(crs)
    if proj is None:
        raise ValueError(f"unsupported CRS {crs!r}: EPSG:3857 / EPSG:4326 "
                         f"/ EPSG:326xx / EPSG:327xx (UTM)")

    def to_px(lon, lat):
        x, y = proj(lon, lat)
        return transform.world_to_pixel(x, y)

    return _rows_from_projected(landmarks, to_px, width, height)


def write_yolo_labels(rows: np.ndarray, path: str):
    """Write label rows as a YOLO txt file (label_ld.py:97-105)."""
    with open(path, "w") as f:
        for r in rows:
            f.write(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} "
                    f"{r[3]:.6f} {r[4]:.6f}\n")


def read_yolo_labels(path: str) -> np.ndarray:
    """Read a YOLO txt label file back into (K, 5) rows."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) == 5:
                rows.append([float(v) for v in p])
    return np.array(rows) if rows else np.zeros((0, 5))


# 3x5 bitmap digit glyphs for the class-id annotation (cv2.putText stand-in)
_DIGITS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
}


def _draw_digits(im: np.ndarray, text: str, top: int, left: int,
                 color, scale: int = 2):
    H, W = im.shape[:2]
    x = left
    for ch in text:
        g = _DIGITS.get(ch)
        if g is None:
            x += 4 * scale
            continue
        for r in range(5):
            for c in range(3):
                if g[r][c] == "1":
                    y0, x0 = top + r * scale, x + c * scale
                    im[max(0, y0):max(0, min(H, y0 + scale)),
                       max(0, x0):max(0, min(W, x0 + scale))] = color
        x += 4 * scale


def visualize_label(labels: np.ndarray, image: np.ndarray,
                    color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """Overlay YOLO label boxes + class ids on an image — the labeling QA
    visualization of the reference (visualize_label,
    labeling/label_ld.py:116-137: green 2-px cv2 rectangles with the class
    id drawn at the top-left corner), implemented in pure numpy.

    labels: (K, 5) [cls, xc_n, yc_n, w_n, h_n] rows (or a label .txt path);
    image: (H, W, 3) uint8 (or a grayscale (H, W), promoted).
    Returns a new annotated (H, W, 3) uint8 image.
    """
    if isinstance(labels, str):
        labels = read_yolo_labels(labels)
    im = np.asarray(image)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    im = im.astype(np.uint8).copy()
    H, W = im.shape[:2]
    color = np.asarray(color, np.uint8)
    for row in np.asarray(labels):
        cls, xc, yc, w, h = row[:5]
        left = int((xc - w / 2) * W)
        top = int((yc - h / 2) * H)
        right = int((xc + w / 2) * W)
        bottom = int((yc + h / 2) * H)
        l, t_ = max(0, left), max(0, top)
        r_, b = min(W, right + 1), min(H, bottom + 1)
        if r_ <= l or b <= t_:
            continue
        th = thickness
        im[t_:min(b, t_ + th), l:r_] = color          # top edge
        im[max(t_, b - th):b, l:r_] = color           # bottom edge
        im[t_:b, l:min(r_, l + th)] = color           # left edge
        im[t_:b, max(l, r_ - th):r_] = color          # right edge
        _draw_digits(im, str(int(cls)), top - 12, left, color)
    return im


def write_ppm(image: np.ndarray, path: str):
    """Write an (H, W, 3) uint8 image as binary PPM (P6) — dependency-free
    counterpart of the reference's cv2.imwrite for the viz_labels output
    (label_ld.py:113)."""
    im = np.ascontiguousarray(np.asarray(image, np.uint8))
    assert im.ndim == 3 and im.shape[2] == 3
    with open(path, "wb") as f:
        f.write(f"P6\n{im.shape[1]} {im.shape[0]}\n255\n".encode())
        f.write(im.tobytes())
