"""Native WGS84 geodesic solver (Vincenty's formulae, inverse + direct).

The reference samples cross-section paths along the WGS84 geodesic via
the external ``geographiclib`` package (reference
multi_mesh/utils.py:545-574).  That dependency is optional here: this
module solves both geodesic problems from scratch on the WGS84 ellipsoid
with Vincenty's nested-iteration method, accurate to ~0.5 mm -- far
below the sampling resolution any cross-section plot uses -- so
``utils.greatcircle_points`` produces the ellipsoidal path with zero
external dependencies.

Vincenty's inverse iteration is known not to converge for nearly
antipodal endpoints (within ~0.5 deg of the antipode); callers should
catch ``GeodesicError`` and fall back to a spherical great circle there
(which is what ``utils.greatcircle_points`` does).
"""
from __future__ import annotations

import dataclasses
import math

# WGS84 defining parameters
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)

_MAX_ITER = 200
_TOL = 1e-13


class GeodesicError(RuntimeError):
    """Inverse iteration failed to converge (nearly antipodal points)."""


@dataclasses.dataclass
class GeodesicResult:
    """s12: distance in meters; azi1/azi2: forward azimuths (deg,
    clockwise from north) at the start and end point; lat2/lon2: the end
    point (deg) -- mirrors geographiclib's result-dict keys."""

    s12: float
    azi1: float
    azi2: float
    lat1: float
    lon1: float
    lat2: float
    lon2: float

    def __getitem__(self, key):  # geographiclib dict-style access
        return getattr(self, key)


def _reduced_lat(lat_rad: float) -> float:
    return math.atan((1.0 - WGS84_F) * math.tan(lat_rad))


def _series_ab(u2: float) -> tuple:
    A = 1.0 + u2 / 16384.0 * (
        4096.0 + u2 * (-768.0 + u2 * (320.0 - 175.0 * u2))
    )
    B = u2 / 1024.0 * (256.0 + u2 * (-128.0 + u2 * (74.0 - 47.0 * u2)))
    return A, B


def _delta_sigma(B, sin_s, cos_s, cos2m):
    return B * sin_s * (
        cos2m
        + B / 4.0 * (
            cos_s * (-1.0 + 2.0 * cos2m * cos2m)
            - B / 6.0 * cos2m
            * (-3.0 + 4.0 * sin_s * sin_s)
            * (-3.0 + 4.0 * cos2m * cos2m)
        )
    )


def inverse(lat1: float, lon1: float, lat2: float, lon2: float
            ) -> GeodesicResult:
    """Solve the inverse geodesic problem on WGS84 (degrees in/out).

    Returns distance s12 (m) and azimuths azi1/azi2 (deg).  Raises
    GeodesicError for nearly antipodal endpoints where Vincenty's
    lambda-iteration diverges.
    """
    if abs(lat1 - lat2) < 1e-13 and abs(lon1 - lon2) < 1e-13:
        return GeodesicResult(0.0, 0.0, 0.0, lat1, lon1, lat2, lon2)
    phi1, phi2 = math.radians(lat1), math.radians(lat2)
    L = math.radians(lon2 - lon1)
    U1, U2 = _reduced_lat(phi1), _reduced_lat(phi2)
    sU1, cU1 = math.sin(U1), math.cos(U1)
    sU2, cU2 = math.sin(U2), math.cos(U2)

    lam = L
    for _ in range(_MAX_ITER):
        s_lam, c_lam = math.sin(lam), math.cos(lam)
        sin_s = math.hypot(
            cU2 * s_lam, cU1 * sU2 - sU1 * cU2 * c_lam
        )
        if sin_s == 0.0:  # coincident points
            return GeodesicResult(0.0, 0.0, 0.0, lat1, lon1, lat2, lon2)
        cos_s = sU1 * sU2 + cU1 * cU2 * c_lam
        sigma = math.atan2(sin_s, cos_s)
        sin_a = cU1 * cU2 * s_lam / sin_s
        cos2_a = 1.0 - sin_a * sin_a
        if cos2_a == 0.0:  # equatorial line
            cos2m = 0.0
        else:
            cos2m = cos_s - 2.0 * sU1 * sU2 / cos2_a
        C = WGS84_F / 16.0 * cos2_a * (
            4.0 + WGS84_F * (4.0 - 3.0 * cos2_a)
        )
        lam_prev = lam
        lam = L + (1.0 - C) * WGS84_F * sin_a * (
            sigma + C * sin_s * (
                cos2m + C * cos_s * (-1.0 + 2.0 * cos2m * cos2m)
            )
        )
        if abs(lam - lam_prev) < _TOL:
            break
    else:
        raise GeodesicError(
            "Vincenty inverse did not converge (nearly antipodal points)"
        )

    u2 = cos2_a * (WGS84_A * WGS84_A - WGS84_B * WGS84_B) / (
        WGS84_B * WGS84_B
    )
    A, B = _series_ab(u2)
    dsig = _delta_sigma(B, sin_s, cos_s, cos2m)
    s12 = WGS84_B * A * (sigma - dsig)
    azi1 = math.degrees(
        math.atan2(cU2 * s_lam, cU1 * sU2 - sU1 * cU2 * c_lam)
    )
    azi2 = math.degrees(
        math.atan2(cU1 * s_lam, -sU1 * cU2 + cU1 * sU2 * c_lam)
    )
    return GeodesicResult(s12, azi1, azi2, lat1, lon1, lat2, lon2)


def direct(lat1: float, lon1: float, azi1: float, s12: float
           ) -> GeodesicResult:
    """Solve the direct geodesic problem on WGS84 (degrees/meters in,
    degrees out): walk ``s12`` meters from (lat1, lon1) at initial
    azimuth ``azi1``."""
    phi1 = math.radians(lat1)
    alpha1 = math.radians(azi1)
    s_al, c_al = math.sin(alpha1), math.cos(alpha1)
    U1 = _reduced_lat(phi1)
    sU1, cU1 = math.sin(U1), math.cos(U1)
    sigma1 = math.atan2(math.tan(U1), c_al)
    sin_a = cU1 * s_al
    cos2_a = 1.0 - sin_a * sin_a
    u2 = cos2_a * (WGS84_A * WGS84_A - WGS84_B * WGS84_B) / (
        WGS84_B * WGS84_B
    )
    A, B = _series_ab(u2)

    sigma = s12 / (WGS84_B * A)
    for _ in range(_MAX_ITER):
        two_sm = 2.0 * sigma1 + sigma
        sin_s, cos_s = math.sin(sigma), math.cos(sigma)
        cos2m = math.cos(two_sm)
        dsig = _delta_sigma(B, sin_s, cos_s, cos2m)
        sigma_prev = sigma
        sigma = s12 / (WGS84_B * A) + dsig
        if abs(sigma - sigma_prev) < _TOL:
            break

    sin_s, cos_s = math.sin(sigma), math.cos(sigma)
    two_sm = 2.0 * sigma1 + sigma
    cos2m = math.cos(two_sm)
    tmp = sU1 * sin_s - cU1 * cos_s * c_al
    phi2 = math.atan2(
        sU1 * cos_s + cU1 * sin_s * c_al,
        (1.0 - WGS84_F) * math.hypot(sin_a, tmp),
    )
    lam = math.atan2(sin_s * s_al, cU1 * cos_s - sU1 * sin_s * c_al)
    C = WGS84_F / 16.0 * cos2_a * (4.0 + WGS84_F * (4.0 - 3.0 * cos2_a))
    L = lam - (1.0 - C) * WGS84_F * sin_a * (
        sigma + C * sin_s * (
            cos2m + C * cos_s * (-1.0 + 2.0 * cos2m * cos2m)
        )
    )
    lon2 = lon1 + math.degrees(L)
    # normalize to (-180, 180]
    lon2 = (lon2 + 180.0) % 360.0 - 180.0
    azi2 = math.degrees(math.atan2(sin_a, -tmp))
    return GeodesicResult(
        s12, azi1, azi2, lat1, lon1, math.degrees(phi2), lon2
    )


def waypoints(lat1: float, lon1: float, lat2: float, lon2: float,
              npts: int):
    """[npts, 2] (lat, lon) degrees equally spaced in geodesic distance
    from point 1 toward point 2, end point excluded -- the reference's
    sampling convention (i * s12 / npts, reference utils.py:545-574)."""
    import numpy as np

    inv = inverse(lat1, lon1, lat2, lon2)
    out = np.empty((npts, 2))
    for i in range(npts):
        pos = direct(lat1, lon1, inv.azi1, i * inv.s12 / float(npts))
        out[i, 0] = pos.lat2
        out[i, 1] = pos.lon2
    return out
