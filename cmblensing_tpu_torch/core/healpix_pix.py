"""Minimal HEALPix RING-scheme pixelization math, host-side numpy.

The port's own copy of ``cmblensing_tpu/core/healpix_pix.py``: the ring
geometry written out (the reference reaches healpy), and only what
projection needs: pix2ang, ang2pix, the rings' geometry, and 4-neighbor
ring-bilinear interpolation weights (healpy get_interp_weights-style).
"""
from __future__ import annotations

import numpy as np


def npix2nside(npix):
    nside = int(round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is no HEALPix pixel count")
    return nside


def nside2npix(nside):
    return 12 * nside * nside


def _ring_info(nside, ring):
    """For ring index i (1..4nside-1): (z, npix_in_ring, phi_offset,
    start_pixel_index)."""
    ring = np.asarray(ring)
    npr = np.where(ring < nside, 4 * ring,
                   np.where(ring <= 3 * nside, 4 * nside, 4 * (4 * nside - ring)))
    # z of ring
    z_cap_n = 1.0 - (ring ** 2) / (3.0 * nside ** 2)
    z_eq = 4.0 / 3.0 - 2.0 * ring / (3.0 * nside)
    z_cap_s = -1.0 + ((4 * nside - ring) ** 2) / (3.0 * nside ** 2)
    z = np.where(ring < nside, z_cap_n, np.where(ring <= 3 * nside, z_eq, z_cap_s))
    # phi offset: cap rings 1/2; equatorial alternating 0 or 1/2
    s = np.where(ring < nside, 0.5,
                 np.where(ring <= 3 * nside, ((ring - nside + 1) % 2) * 0.5,
                          0.5))
    # cumulative start index
    ring_ = ring
    start_cap = 2 * ring_ * (ring_ - 1)
    start_eq = 2 * nside * (nside - 1) + (ring_ - nside) * 4 * nside
    rs = 4 * nside - ring_
    start_scap = 12 * nside ** 2 - 2 * rs * (rs + 1)
    start = np.where(ring_ < nside, start_cap,
                     np.where(ring_ <= 3 * nside, start_eq, start_scap))
    return z, npr, s, start


def pix2ang_ring(nside, ipix):
    """(theta, phi) of RING-scheme pixel centers."""
    ipix = np.asarray(ipix, dtype=np.int64)
    ncap = 2 * nside * (nside - 1)
    npix = nside2npix(nside)
    theta = np.empty(ipix.shape, dtype=np.float64)
    phi = np.empty(ipix.shape, dtype=np.float64)

    # north cap
    m = ipix < ncap
    ip = ipix[m]
    ring = ((1 + np.sqrt(1 + 2 * ip)) // 2).astype(np.int64)
    # refine (integer sqrt edge cases)
    ring = np.where(2 * ring * (ring - 1) > ip, ring - 1, ring)
    ring = np.where(2 * ring * (ring + 1) <= ip, ring + 1, ring)
    j = ip - 2 * ring * (ring - 1)
    theta[m] = np.arccos(1.0 - ring ** 2 / (3.0 * nside ** 2))
    phi[m] = np.pi / (2 * ring) * (j + 0.5)

    # equatorial belt
    m = (ipix >= ncap) & (ipix < npix - ncap)
    ip = ipix[m] - ncap
    ring = ip // (4 * nside) + nside
    j = ip % (4 * nside)
    s = ((ring - nside + 1) % 2) * 0.5
    theta[m] = np.arccos(4.0 / 3.0 - 2.0 * ring / (3.0 * nside))
    phi[m] = np.pi / (2 * nside) * (j + s)

    # south cap
    m = ipix >= npix - ncap
    ip = npix - 1 - ipix[m]
    ring = ((1 + np.sqrt(1 + 2 * ip)) // 2).astype(np.int64)
    ring = np.where(2 * ring * (ring - 1) > ip, ring - 1, ring)
    ring = np.where(2 * ring * (ring + 1) <= ip, ring + 1, ring)
    j = ip - 2 * ring * (ring - 1)
    theta[m] = np.arccos(-1.0 + ring ** 2 / (3.0 * nside ** 2))
    phi[m] = np.pi / (2 * ring) * (4 * ring - j - 0.5)

    return theta, phi


def _ring_of_z(nside, z):
    """Fractional ring coordinate of colatitude cos(theta)=z: rings are
    i=1..4nside-1; returns float ring position for interpolation."""
    z = np.asarray(z, dtype=np.float64)
    ring = np.empty(z.shape, dtype=np.float64)
    m = z > 2.0 / 3.0
    ring[m] = nside * np.sqrt(3.0 * (1 - z[m]))
    m = (z <= 2.0 / 3.0) & (z >= -2.0 / 3.0)
    ring[m] = nside * (2.0 - 1.5 * z[m])
    m = z < -2.0 / 3.0
    ring[m] = 4 * nside - nside * np.sqrt(3.0 * (1 + z[m]))
    return ring


def get_interp_weights(nside, theta, phi):
    """4 pixel indices and weights for ring-bilinear interpolation at
    (theta, phi) — same scheme as healpy.get_interp_weights: linear in
    phi along the ring above and below, linear in ring between."""
    theta = np.asarray(theta, dtype=np.float64).ravel()
    phi = np.mod(np.asarray(phi, dtype=np.float64).ravel(), 2 * np.pi)
    z = np.cos(theta)
    fr = _ring_of_z(nside, z)
    r1 = np.clip(np.floor(fr).astype(np.int64), 0, 4 * nside - 1)
    r2 = r1 + 1
    # ring weight
    wr = fr - r1
    # clamp at caps: ring 0 and 4nside are the poles (no pixels)
    r1c = np.clip(r1, 1, 4 * nside - 1)
    r2c = np.clip(r2, 1, 4 * nside - 1)
    wr = np.where(r1 < 1, 1.0, np.where(r2 > 4 * nside - 1, 0.0, wr))

    idxs = np.zeros((4, len(theta)), dtype=np.int64)
    wgts = np.zeros((4, len(theta)), dtype=np.float64)
    for k, (rc, w_ring) in enumerate([(r1c, 1 - wr), (r2c, wr)]):
        z_r, npr, s, start = _ring_info(nside, rc)
        fj = phi / (2 * np.pi) * npr - s
        j1 = np.floor(fj).astype(np.int64)
        wj = fj - j1
        j2 = (j1 + 1) % npr
        j1 = j1 % npr
        idxs[2 * k] = start + j1
        idxs[2 * k + 1] = start + j2
        wgts[2 * k] = w_ring * (1 - wj)
        wgts[2 * k + 1] = w_ring * wj
    return idxs, wgts


def interp_val(m, theta, phi):
    """Interpolate a RING-scheme map m at (theta, phi)."""
    nside = npix2nside(len(m))
    idxs, wgts = get_interp_weights(nside, theta, phi)
    m = np.asarray(m)
    return np.sum(m[idxs] * wgts, axis=0)


def ang2pix_ring(nside, theta, phi):
    idxs, wgts = get_interp_weights(nside, theta, phi)
    return idxs[np.argmax(wgts, axis=0), np.arange(idxs.shape[1])]
