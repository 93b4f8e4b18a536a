"""WGS-84 coordinate transforms (ECEF ↔ LLH ↔ local ENU).

Closed-form transforms equivalent to the reference's `geo/xyz2llh.m`
(Kaplan's direct solution), `geo/llh2xyz.m`, `geo/xyz2enu.m`,
`geo/enu2xyz.m`.  Written with `jnp` so they are jittable and batch over
leading axes; they accept numpy inputs as well (x64 is enabled
package-wide, so host-precision float64 is preserved).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WGS84_A = 6378137.0
WGS84_B = 6356752.3142
WGS84_F = 1.0 / 298.257223563


@jax.jit
def xyz2llh(xyz):
    """ECEF (…,3) [m] → (lat rad, lon rad, height m) (…,3).

    Kaplan closed-form solution, matching geo/xyz2llh.m.
    """
    xyz = jnp.asarray(xyz, dtype=jnp.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    a, b = WGS84_A, WGS84_B
    e2 = 1.0 - (b / a) ** 2
    ep = jnp.sqrt(e2) * (a / b)
    b2 = b * b
    z2 = z * z
    r = jnp.sqrt(x * x + y * y)
    r2 = r * r
    E2 = a * a - b * b
    F = 54.0 * b2 * z2
    G = r2 + (1.0 - e2) * z2 - e2 * E2
    # NB: written as a product of O(1) ratios — the naive F·r2/G³ reaches
    # ~1e56 at Earth radius, beyond float32 range, so this form stays
    # finite in any floating type the geometry may be evaluated in.
    c = (e2 * e2) * 54.0 * b2 * (z2 / G) * (r2 / G) / G
    s = (1.0 + c + jnp.sqrt(c * c + 2.0 * c)) ** (1.0 / 3.0)
    P = F / (3.0 * (s + 1.0 / s + 1.0) ** 2 * G * G)
    Q = jnp.sqrt(1.0 + 2.0 * e2 * e2 * P)
    ro = -(P * e2 * r) / (1.0 + Q) + jnp.sqrt(jnp.maximum(
        (a * a / 2.0) * (1.0 + 1.0 / Q)
        - (P * (1.0 - e2) * z2) / (Q * (1.0 + Q)) - P * r2 / 2.0, 0.0))
    tmp = (r - e2 * ro) ** 2
    U = jnp.sqrt(tmp + z2)
    V = jnp.sqrt(tmp + (1.0 - e2) * z2)
    zo = (b2 * z) / (a * V)
    height = U * (1.0 - b2 / (a * V))
    lat = jnp.arctan((z + ep * ep * zo) / r)
    lon = jnp.arctan2(y, x)
    return jnp.stack([lat, lon, height], axis=-1)


@jax.jit
def llh2xyz(llh):
    """(lat rad, lon rad, height m) (…,3) → ECEF (…,3) [m] (geo/llh2xyz.m)."""
    llh = jnp.asarray(llh, dtype=jnp.float64)
    lat, lon, ht = llh[..., 0], llh[..., 1], llh[..., 2]
    e2 = (2.0 - WGS84_F) * WGS84_F
    slat, clat = jnp.sin(lat), jnp.cos(lat)
    r_n = WGS84_A / jnp.sqrt(1.0 - e2 * slat * slat)
    x = (r_n + ht) * clat * jnp.cos(lon)
    y = (r_n + ht) * clat * jnp.sin(lon)
    z = (r_n * (1.0 - e2) + ht) * slat
    return jnp.stack([x, y, z], axis=-1)


def enu_rotation(org_llh):
    """(3,3) rotation ECEF→ENU at origin latitude/longitude."""
    lat, lon = org_llh[..., 0], org_llh[..., 1]
    sp, cp = jnp.sin(lat), jnp.cos(lat)
    sl, cl = jnp.sin(lon), jnp.cos(lon)
    return jnp.stack([
        jnp.stack([-sl, cl, jnp.zeros_like(sl)], axis=-1),
        jnp.stack([-sp * cl, -sp * sl, cp], axis=-1),
        jnp.stack([cp * cl, cp * sl, sp], axis=-1),
    ], axis=-2)


@jax.jit
def xyz2enu(xyz, org_xyz):
    """ECEF point → ENU relative to ECEF origin (geo/xyz2enu.m)."""
    xyz = jnp.asarray(xyz, dtype=jnp.float64)
    org = jnp.asarray(org_xyz, dtype=jnp.float64)
    R = enu_rotation(xyz2llh(org))
    return jnp.einsum("...ij,...j->...i", R, xyz - org)


def enu2xyz(enu, org_xyz):
    """ENU relative to ECEF origin → ECEF point (geo/enu2xyz.m)."""
    enu = jnp.asarray(enu, dtype=jnp.float64)
    org = jnp.asarray(org_xyz, dtype=jnp.float64)
    R = enu_rotation(xyz2llh(org))
    return org + jnp.einsum("...ji,...j->...i", R, enu)


@jax.jit
def elevation_azimuth(sv_xyz, usr_xyz):
    """(elevation rad, azimuth rad) of SV seen from user.

    Matches the reference's usage: el = atan(U/‖EN‖), az = atan2(E, N)
    (trackingCT_POS_updated.m:492-494).
    """
    enu = xyz2enu(sv_xyz, usr_xyz)
    el = jnp.arctan2(enu[..., 2], jnp.linalg.norm(enu[..., :2], axis=-1))
    az = jnp.arctan2(enu[..., 0], enu[..., 1])
    return el, az
