"""Fourier-diagonal covariance operators from angular power spectra.

Counterpart of ``cmblensing_tpu/core/cov.py`` (pol I, P and IP): a
covariance diagonal in 2-D Fourier space is Cl(|l|)/Omega_pix, built on
the host in numpy and stored on the projection's device; at pol IP the T
and E blocks of a mode couple through ClTE (BlockDiagIEB). A spectrum
given as (Cl, ledges, name) makes the covariance a ParamDependentOp whose
theta entry `name` holds one amplitude per |l| bin (bandpowers).
"""
from __future__ import annotations

import numpy as np
import torch

from .basis import Basis, EB_FOURIER, FOURIER
from .field import Field
from .ops import BlockDiagIEB, Diag, ParamDependentOp
from .proj import ProjLambert


def Cl_to_2D(Cl, proj: ProjLambert):
    """A 1-D spectrum on the 2-D |l| grid, NaN -> 0."""
    v = Cl(np.asarray(proj.lmag, dtype=np.float64))
    v = np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
    return v.astype(proj.T)


def _fourier_field(arrs, proj, pol):
    arr = np.stack(arrs, axis=0).astype(proj.T)
    return Field(torch.as_tensor(arr, device=proj.device), Basis(pol, "fourier"), proj)


SLOTS = {"I": ("TT",), "P": ("EE", "BB"), "IP": ("TT", "EE", "BB", "TE")}


def Cl_to_Cov(pol, proj: ProjLambert, *Cl, units=None):
    """Fourier-diagonal covariance operator:

    pol='I':  Cl_to_Cov('I', proj, ClTT)                  -> Diag on I fourier
    pol='P':  Cl_to_Cov('P', proj, ClEE, ClBB)            -> Diag on EB fourier
    pol='IP': Cl_to_Cov('IP', proj, ClTT, ClEE, ClBB, ClTE) -> BlockDiagIEB

    Any subset of the spectra may instead be a tuple (Cl, ledges, name):
    the result is then a ParamDependentOp of the names, each spectrum
    rescaled bin by bin by theta[name] (`_cl_to_cov_banded`). units
    defaults to Omega_pix (covariance of pixel-unit maps)."""
    if units is None:
        units = float(proj.Omega_pix)
    pol = str(pol)
    slots = SLOTS.get(pol)
    if slots is None:
        raise ValueError(f"pol should be one of 'I', 'P' or 'IP' (got {pol!r})")
    if len(Cl) != len(slots):
        raise ValueError(f"Cl_to_Cov('{pol}') takes {len(slots)} spectra "
                         f"({', '.join(slots)}); got {len(Cl)}")
    if any(isinstance(c, tuple) for c in Cl):
        return _cl_to_cov_banded(pol, proj, Cl, units)
    return _cl_to_cov_fixed(pol, proj, Cl, units)


def _cl_to_cov_fixed(pol, proj, Cl, units):
    two_d = [Cl_to_2D(c, proj) / units for c in Cl]
    if pol == "IP":
        TT, EE, BB, TE = (_fourier_field([a], proj, "I") for a in two_d)
        return BlockDiagIEB(TT, TE, EE, BB)
    return Diag(_fourier_field(two_d, proj, "I" if pol == "I" else "EB"))


def _find_bins(ledges, lmag):
    """The bin of `ledges` each |l| of the grid falls in; nbins where it
    lies outside [ledges[0], ledges[-1])."""
    ledges = np.asarray(ledges, dtype=np.float64)
    lmag = np.asarray(lmag, dtype=np.float64)
    idx = np.searchsorted(ledges, lmag, side="right") - 1
    nbins = len(ledges) - 1
    idx = np.where((lmag < ledges[0]) | (lmag >= ledges[-1]), nbins, idx)
    return idx.astype(np.int64)


def _bandpower_rescale(arr0, bins, amplitudes):
    """arr0 (..., 1, Ny, Nx//2+1) times the amplitude of each mode's bin,
    an implicit 1 for the modes outside every bin. amplitudes (nbins,)
    rescale every batch entry alike; (nchains, nbins) one entry each,
    giving (nchains, 1, Ny, Nx//2+1)."""
    ones = torch.ones(amplitudes.shape[:-1] + (1,), dtype=amplitudes.dtype,
                      device=amplitudes.device)
    amps = torch.cat([amplitudes, ones], dim=-1)
    return amps[..., bins].unsqueeze(-3) * arr0


def _amplitudes(theta, name, nbins, proj):
    """theta[name] as a tensor of bin amplitudes, ones where theta does not
    name it: (nbins,), shared by every batch entry, or (nchains, nbins),
    one row a batch entry (a per-chain vector theta); in the projection's
    precision, but a float64 tensor stays float64 (the theta-score
    differentiates in float64, inference/muse.py)."""
    a = theta.get(name)
    if a is None:
        return torch.ones(nbins, dtype=proj.torch_T, device=proj.device)
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
    dtype = a.dtype if isinstance(a, torch.Tensor) and a.dtype == torch.float64 else proj.torch_T
    a = torch.as_tensor(a, dtype=dtype, device=proj.device)
    if a.ndim not in (1, 2) or a.shape[-1] != nbins:
        raise ValueError(f"theta[{name!r}] takes {nbins} bin amplitudes, shape ({nbins},) or "
                         f"(nchains, {nbins}) per chain; got shape {tuple(a.shape)}")
    return a


def _cl_to_cov_banded(pol, proj, Cl, units):
    """Any subset of the spectra banded, each by its own theta name: the
    fixed covariance of the unscaled spectra, and a ParamDependentOp
    whose function rescales the banded ones' planes (pol I, P) or blocks
    (pol IP) by the amplitudes theta gives."""
    slots = SLOTS[pol]
    base, banded = [], {}
    for slot, c in zip(slots, Cl):
        if isinstance(c, tuple):
            cl0, ledges, name = c
            base.append(cl0)
            bins = torch.as_tensor(_find_bins(ledges, proj.lmag), device=proj.device)
            banded[slot] = (bins, name, len(ledges) - 1)
        else:
            base.append(c)
    names = [b[1] for b in banded.values()]
    if len(set(names)) != len(names):
        raise ValueError(f"banded spectra must use distinct theta names; got {names}")
    C0 = _cl_to_cov_fixed(pol, proj, tuple(base), units)

    def rescaled(arr, slot, theta):
        if slot not in banded:
            return arr
        bins, name, nbins = banded[slot]
        return _bandpower_rescale(arr, bins, _amplitudes(theta, name, nbins, proj))

    if pol in ("I", "P"):
        def fn(deps, **theta):
            (C0,) = deps
            planes = [rescaled(C0.diag.arr[..., k:k + 1, :, :], slot, theta)
                      for k, slot in enumerate(slots)]
            arr = planes[0] if len(planes) == 1 else torch.cat(torch.broadcast_tensors(*planes),
                                                                 dim=-3)
            return Diag(Field(arr, FOURIER if pol == "I" else EB_FOURIER, proj))
    else:
        def fn(deps, **theta):
            (C0,) = deps
            blocks = {slot: Field(rescaled(getattr(C0, slot).arr, slot, theta), FOURIER, proj)
                      for slot in ("TT", "TE", "EE", "BB")}
            return BlockDiagIEB(blocks["TT"], blocks["TE"], blocks["EE"], blocks["BB"])

    return ParamDependentOp(tuple(names), fn, (C0,))


def cov_to_Cl(C, **kwargs):
    """The binned spectrum of a spin-0 Fourier-diagonal covariance (a Diag
    or its diagonal Field): get_Cl (kwargs go to it) of the field whose
    squared Fourier modes are the diagonal, in the units Cl_to_Cov's
    inverse gives."""
    from ..utils.cls import Cls
    from ..utils.spectra import get_Cl
    d = C.diag if isinstance(C, Diag) else C
    proj = d.proj
    alpha = proj.Nx * proj.Ny / float(proj.deltax) ** 2
    cl = get_Cl(Field(torch.sqrt(torch.abs(d.arr)), d.basis, proj), **kwargs)
    return Cls(cl.ell, cl.Cl * alpha)
