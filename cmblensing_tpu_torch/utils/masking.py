"""Simulated analysis masks: boundary padding, random point sources with
a bleed radius, cosine apodization through distance transforms.

A copy of ``cmblensing_tpu/utils/masking.py`` (numpy and scipy only, run
on the host at set-up): for the same ``np.random.default_rng(seed)`` it
gives the same mask, bit for bit."""
from __future__ import annotations

import numpy as np
from scipy.ndimage import distance_transform_edt, gaussian_filter


def boundarymask(Nside, pad):
    Ny, Nx = (Nside, Nside) if np.isscalar(Nside) else Nside
    m = np.ones((Ny, Nx), dtype=bool)
    m[:pad, :] = False
    m[:, :pad] = False
    m[Ny - pad:, :] = False
    m[:, Nx - pad:] = False
    return m


def bleed(img, w):
    """True within distance w of any True pixel of img."""
    dist = distance_transform_edt(~img)
    return dist < w


def cos_apod(img, w, smooth_distance=False):
    """Cosine-taper the True region of img over w pixels from its edge
    (reference cos_apod, src/masking.jl:46-54)."""
    dist = distance_transform_edt(img)
    if smooth_distance:
        dist = gaussian_filter(dist, smooth_distance)
    return (1 - np.cos(np.minimum(dist, w) / w * np.pi)) / 2


def sim_ptsrcs(rng, Nside, nsources):
    Ny, Nx = (Nside, Nside) if np.isscalar(Nside) else Nside
    m = np.zeros((Ny, Nx), dtype=bool)
    ys = rng.integers(0, Ny, nsources)
    xs = rng.integers(0, Nx, nsources)
    m[ys, xs] = True
    return m


def make_mask(Nside, thetapix, rng=None,
              edge_padding_deg=2, edge_rounding_deg=1, apodization_deg=1,
              ptsrc_radius_arcmin=7, num_ptsrcs=None):
    """Simulated analysis mask as a float array in [0,1]
    (reference make_mask, src/masking.jl:2-24). Returns np.ndarray
    (Ny,Nx); wrap with from_maps to get a Field."""
    if rng is None:
        rng = np.random.default_rng()
    Ny, Nx = (Nside, Nside) if np.isscalar(Nside) else Nside
    if num_ptsrcs is None:
        num_ptsrcs = round(Ny * Nx * (thetapix / 60) ** 2 * 120 / 100)

    def deg2npix(x):
        return round(x / thetapix * 60)

    def arcmin2npix(x):
        return round(x / thetapix)

    if num_ptsrcs == 0:
        ptsrc = np.ones((Ny, Nx), dtype=bool)
    else:
        ptsrc = ~bleed(sim_ptsrcs(rng, (Ny, Nx), num_ptsrcs), arcmin2npix(ptsrc_radius_arcmin))
    boundary = boundarymask((Ny, Nx), deg2npix(edge_padding_deg))
    if apodization_deg in (False, 0):
        mask = (boundary & ptsrc).astype(np.float32)
    else:
        apod_ptsrc = 1.0 if num_ptsrcs == 0 else cos_apod(ptsrc, arcmin2npix(ptsrc_radius_arcmin))
        mask = cos_apod(boundary, deg2npix(apodization_deg), deg2npix(edge_rounding_deg)) * apod_ptsrc
    return mask.astype(np.float32)
