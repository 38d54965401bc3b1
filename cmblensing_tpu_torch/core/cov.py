"""Fourier-diagonal covariance operators from angular power spectra.

Counterpart of ``cmblensing_tpu/core/cov.py`` (unbinned spectra, pol I,
P and IP): a covariance diagonal in 2-D Fourier space is Cl(|l|)/Omega_pix,
built on the host in numpy and stored on the projection's device; at pol
IP the T and E blocks of a mode couple through ClTE (BlockDiagIEB).
"""
from __future__ import annotations

import numpy as np
import torch

from .basis import Basis
from .field import Field
from .ops import BlockDiagIEB, Diag
from .proj import ProjLambert


def Cl_to_2D(Cl, proj: ProjLambert):
    """A 1-D spectrum on the 2-D |l| grid, NaN -> 0."""
    v = Cl(np.asarray(proj.lmag, dtype=np.float64))
    v = np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
    return v.astype(proj.T)


def _fourier_field(arrs, proj, pol):
    arr = np.stack(arrs, axis=0).astype(proj.T)
    return Field(torch.as_tensor(arr, device=proj.device), Basis(pol, "fourier"), proj)


def Cl_to_Cov(pol, proj: ProjLambert, *Cl, units=None):
    """Fourier-diagonal covariance operator:

    pol='I':  Cl_to_Cov('I', proj, ClTT)                  -> Diag on I fourier
    pol='P':  Cl_to_Cov('P', proj, ClEE, ClBB)            -> Diag on EB fourier
    pol='IP': Cl_to_Cov('IP', proj, ClTT, ClEE, ClBB, ClTE) -> BlockDiagIEB

    units defaults to Omega_pix (covariance of pixel-unit maps)."""
    if units is None:
        units = float(proj.Omega_pix)
    pol = str(pol)
    if any(isinstance(c, tuple) for c in Cl):
        raise NotImplementedError("banded (bandpower) covariances are not ported yet")
    need = {"I": 1, "P": 2, "IP": 4}.get(pol)
    if need is None:
        raise ValueError(f"pol should be one of 'I', 'P' or 'IP' (got {pol!r})")
    if len(Cl) != need:
        raise ValueError(f"Cl_to_Cov('{pol}') takes {need} spectra; got {len(Cl)}")
    two_d = [Cl_to_2D(c, proj) / units for c in Cl]
    if pol == "IP":
        TT, EE, BB, TE = (_fourier_field([a], proj, "I") for a in two_d)
        return BlockDiagIEB(TT, TE, EE, BB)
    return Diag(_fourier_field(two_d, proj, "I" if pol == "I" else "EB"))
