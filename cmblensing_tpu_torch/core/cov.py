"""Fourier-diagonal covariance operators from angular power spectra.

Counterpart of ``cmblensing_tpu/core/cov.py`` (unbinned spectra, pol I
and P): a covariance diagonal in 2-D Fourier space is Cl(|l|)/Omega_pix,
built on the host in numpy and stored on the projection's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .basis import Basis
from .field import Field
from .ops import Diag
from .proj import ProjLambert


def Cl_to_2D(Cl, proj: ProjLambert):
    """A 1-D spectrum on the 2-D |l| grid, NaN -> 0."""
    v = Cl(np.asarray(proj.lmag, dtype=np.float64))
    v = np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
    return v.astype(proj.T)


def Cl_to_Cov(pol, proj: ProjLambert, *Cl, units=None):
    """Fourier-diagonal covariance operator:

    pol='I':  Cl_to_Cov('I', proj, ClTT)          -> Diag on I fourier
    pol='P':  Cl_to_Cov('P', proj, ClEE, ClBB)    -> Diag on EB fourier

    units defaults to Omega_pix (covariance of pixel-unit maps)."""
    if units is None:
        units = float(proj.Omega_pix)
    pol = str(pol)
    if any(isinstance(c, tuple) for c in Cl):
        raise NotImplementedError("banded (bandpower) covariances are not ported yet")
    if pol not in ("I", "P"):
        raise NotImplementedError(f"Cl_to_Cov for pol {pol!r} is not ported yet")
    need = {"I": 1, "P": 2}[pol]
    if len(Cl) != need:
        raise ValueError(f"Cl_to_Cov('{pol}') takes {need} spectra; got {len(Cl)}")
    arr = np.stack([Cl_to_2D(c, proj) / units for c in Cl], axis=0).astype(proj.T)
    basis = Basis("I" if pol == "I" else "EB", "fourier")
    return Diag(Field(torch.as_tensor(arr, device=proj.device), basis, proj))
