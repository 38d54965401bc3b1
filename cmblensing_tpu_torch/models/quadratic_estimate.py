"""Hu-Okamoto flat-sky quadratic estimators for the lensing potential.

Counterpart of ``cmblensing_tpu/models/quadratic_estimate.py``: the TT,
EE and EB estimators with their analytic normalization A_L (N0 = A_L),
on raw (*batch, Ny, Nx//2+1) tensors. Each term is built from memoized legs

    leg(C, brackets, hats) = Map( C * prod_i (i l_bi) * prod_j lhat_hj )

with lhat_j = (i l_j)/|l|.
"""
from __future__ import annotations

from itertools import product

import numpy as np
import torch

from ..core.basis import FOURIER
from ..core.field import Field
from ..core.ops import Diag, ParamDependentOp, _Identity, nan2zero
from ..ops import fft as _fft


def _eps(i, j):
    """2-D Levi-Civita symbol."""
    return {(0, 1): 1.0, (1, 0): -1.0}.get((i, j), 0.0)


def _make_leg_planes(proj):
    """(i lx, i ly, i lhx, i lhy) as full (Ny, Nx//2+1) complex planes."""
    lx = np.asarray(proj.lx, dtype=np.float64)[None, :]
    ly = np.asarray(proj.ly, dtype=np.float64)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        lhx = np.nan_to_num(lx / np.hypot(lx, ly))
        lhy = np.nan_to_num(ly / np.hypot(lx, ly))
    return tuple(torch.as_tensor((1j * np.broadcast_to(a, proj.shape_fourier)).astype(proj.complex_T),
                                 device=proj.device)
                 for a in (lx, ly, lhx, lhy))


class _LegFactory:
    """Memoized legs for one projection. C is a real spectral weight or
    a complex data array of shape (Ny, Nx//2+1)."""

    def __init__(self, proj):
        self.proj = proj
        planes = _make_leg_planes(proj)
        self.il = planes[:2]
        self.ilh = planes[2:]
        self._cache = {}
        self._keep = []   # the keyed arrays stay alive, so their ids stay unique

    def __call__(self, C, brackets=(), hats=()):
        key = (id(C), tuple(sorted(brackets)), tuple(sorted(hats)))
        if key not in self._cache:
            self._keep.append(C)
            X = C.to(self.il[0].dtype)
            for b in brackets:
                X = X * self.il[b]
            for h in hats:
                X = X * self.ilh[h]
            self._cache[key] = _fft.irfft2(X[None], self.proj.Nx)[0]
        return self._cache[key]


def _wf_and_norm(proj, phiqe_unnorm_fourier, AL_arr, Cphi_arr, wiener_filtered, AL_given):
    """Normalize by A_L (the one given, a Diag, else AL_arr) and, with
    `wiener_filtered`, Wiener-filter with Cphi. The estimate keeps the data's
    batch axes: (*batch, 1, Ny, Nx//2+1)."""
    AL = Diag(Field(AL_arr[None], FOURIER, proj)) if AL_given is None else AL_given
    phiqe = AL @ Field(phiqe_unnorm_fourier.unsqueeze(-3), FOURIER, proj)
    if wiener_filtered:
        w = nan2zero(Cphi_arr / (Cphi_arr + AL.diag.arr))
        phiqe = Field(w * phiqe.arr, FOURIER, proj)
    return dict(phiqe=phiqe, AL=AL, Nphi=AL)


def _qe_TT(proj, d1, d2, Cf, Cft, Cn, Cphi, TF, wiener_filtered=True, weights="unlensed",
           AL=None):
    leg = _LegFactory(proj)
    isig = nan2zero(1.0 / (TF ** 2 * Cft + Cn))
    CT = Cf if weights == "unlensed" else Cft
    A = isig * (TF * d1)
    Bc = CT * isig * (TF * d2)
    qe = 0.0
    for i in range(2):
        qe = qe - leg.il[i] * _fft.rfft2((leg(A) * leg(Bc, brackets=(i,)))[None])[0]
    AL_arr = None
    if AL is None:
        W1 = TF ** 2 * CT ** 2 * isig
        W2 = TF ** 2 * isig
        W3 = TF ** 2 * CT * isig
        AL_inv = 0.0
        for i, j in product(range(2), range(2)):
            Aij = (leg(W1, brackets=(i, j)) * leg(W2)
                   + leg(W3, brackets=(i,)) * leg(W3, brackets=(j,)))
            AL_inv = AL_inv + torch.abs(leg.il[i] * leg.il[j] * _fft.rfft2(Aij[None])[0])
        AL_arr = nan2zero(1.0 / AL_inv)
    return _wf_and_norm(proj, qe, AL_arr, Cphi, wiener_filtered, AL)


def _qe_EE(proj, d1E, d2E, CfE, CftE, CnE, Cphi, TFE, wiener_filtered=True, weights="unlensed",
           AL=None):
    leg = _LegFactory(proj)
    TF2 = TFE ** 2
    isig = nan2zero(1.0 / (TF2 * CftE + CnE))
    CE = CfE if weights == "unlensed" else CftE
    A = CE * isig * (TFE * d1E)
    B = isig * (TFE * d2E)
    qe = 0.0
    for i in range(2):
        I_i = 0.0
        for j, k in product(range(2), range(2)):
            I_i = I_i + 2 * leg(A, brackets=(i,), hats=(j, k)) * leg(B, hats=(j, k))
        I_i = I_i - leg(A, brackets=(i,)) * leg(B)
        qe = qe + leg.il[i] * _fft.rfft2((-I_i)[None])[0]
    AL_arr = None
    if AL is None:
        W1 = TF2 * CE ** 2 * isig
        W2 = TF2 * isig
        W3 = TF2 * CE * isig
        AL_inv = 0.0
        for i, j in product(range(2), range(2)):
            A1 = 0.0
            for k, l, m, n, p, q in product(*[range(2)] * 6):
                e = _eps(m, p) * _eps(n, q)
                if e == 0.0:
                    continue
                A1 = A1 + (-4.0) * e * (
                    leg(W1, brackets=(i, j), hats=(k, l, m, n)) * leg(W2, hats=(k, l, p, q))
                    + leg(W3, brackets=(i,), hats=(k, l, m, n)) * leg(W3, brackets=(j,), hats=(k, l, p, q)))
            A2 = (leg(W1, brackets=(i, j)) * leg(W2)
                  + leg(W3, brackets=(i,)) * leg(W3, brackets=(j,)))
            AL_inv = AL_inv + torch.abs(leg.il[i] * leg.il[j] * _fft.rfft2((A1 + A2)[None])[0])
        AL_arr = nan2zero(1.0 / AL_inv)
    return _wf_and_norm(proj, qe, AL_arr, Cphi, wiener_filtered, AL)


def _qe_EB(proj, d1E, d2B, CfE, CfB, CftE, CftB, CnE, CnB, Cphi, TFE, TFB, wiener_filtered=True,
           weights="unlensed", AL=None):
    leg = _LegFactory(proj)
    CE = CfE if weights == "unlensed" else CftE
    CB = CfB if weights == "unlensed" else CftB
    TF2E, TF2B = TFE ** 2, TFB ** 2
    isigE = nan2zero(1.0 / (TF2E * CftE + CnE))
    isigB = nan2zero(1.0 / (TF2B * CftB + CnB))
    AE = CE * isigE * (TFE * d1E)
    BE = isigE * (TFE * d1E)
    AB = isigB * (TFB * d2B)
    BB = CB * isigB * (TFB * d2B)
    qe = 0.0
    for i in range(2):
        I_i = 0.0
        for j, k, l in product(range(2), range(2), range(2)):
            e = _eps(k, l)
            if e == 0.0:
                continue
            term = (leg(AE, brackets=(i,), hats=(j, k)) * leg(AB, hats=(j, l))
                    - leg(BE, hats=(j, k)) * leg(BB, brackets=(i,), hats=(j, l)))
            I_i = I_i + 2 * e * term
        qe = qe + leg.il[i] * _fft.rfft2(I_i[None])[0]
    AL_arr = None
    if AL is None:
        W1 = TF2E * CE ** 2 * isigE
        W2 = TF2B * isigB
        W3 = TF2E * CE * isigE
        W4 = TF2B * CB * isigB
        W5 = TF2E * isigE
        W6 = TF2B * CB ** 2 * isigB
        AL_inv = 0.0
        for i, j in product(range(2), range(2)):
            Aij = 0.0
            for k, l, m, n, p, q in product(*[range(2)] * 6):
                e = _eps(m, p) * _eps(n, q)
                if e == 0.0:
                    continue
                t = (leg(W1, brackets=(i, j), hats=(k, l, m, n)) * leg(W2, hats=(k, l, p, q))
                     - 2 * leg(W3, brackets=(i,), hats=(k, l, m, n)) * leg(W4, brackets=(j,), hats=(k, l, p, q))
                     + leg(W5, hats=(k, l, m, n)) * leg(W6, brackets=(i, j), hats=(k, l, p, q)))
                Aij = Aij + 4 * e * t
            AL_inv = AL_inv + torch.abs(leg.il[i] * leg.il[j] * _fft.rfft2(Aij[None])[0])
        AL_arr = nan2zero(1.0 / AL_inv)
    return _wf_and_norm(proj, qe, AL_arr, Cphi, wiener_filtered, AL)


def _spin0_arr(x):
    """Raw (*batch, Ny, Nx//2+1) tensor from a spin-0 Fourier Diag or Field."""
    if isinstance(x, Diag):
        x = x.diag
    if isinstance(x, Field):
        return x.arr[..., 0, :, :]
    return x


def _fid(op):
    return op.fiducial if isinstance(op, ParamDependentOp) else op


def _same_operator(a, b):
    """Whether two operators are one: the same object, or Diags whose
    fiducial diagonals agree to 1e-6 relative (the JAX package's test)."""
    a, b = _fid(a), _fid(b)
    if a is b:
        return True
    da, db = getattr(a, "diag", None), getattr(b, "diag", None)
    if da is None or db is None or callable(da) or callable(db):
        return False
    return bool(torch.allclose(da.arr, db.arr, rtol=1e-6, atol=0))


_QE_FNS = {"TT": _qe_TT, "EE": _qe_EE, "EB": _qe_EB}


def quadratic_estimate(ds, which=None, wiener_filtered=True, AL=None, weights="unlensed",
                       ds2=None):
    """Quadratic estimate of phi from ds.d, and from ds2.d as the second
    leg when given, from the Fourier-diagonal approximations B_hat, M_hat
    and Cn_hat. which: "TT", "EE" or "EB" ("TT" at pol I, else "EB");
    weights "unlensed" (Cf) or "lensed" (Cf_tilde) in the filters; AL, a
    Fourier Diag, is the normalization used as it is (else computed);
    wiener_filtered multiplies by Cphi / (Cphi + A_L). ds2 must share
    Cf, Cf_tilde, Cn_hat, Cphi and B_hat with ds (the normalization comes
    from ds's), and its d ds.d's batch shape. On batched data A_L is
    computed once, from entry 0 (it does not depend on the data), and
    the estimate of every entry is taken at once along the batch axis.
    Returns dict(phiqe, AL, Nphi)."""
    if weights not in ("lensed", "unlensed"):
        raise ValueError(f"weights should be 'lensed' or 'unlensed' (got {weights!r})")
    ds1 = ds
    if ds2 is None:
        ds2 = ds1
    else:
        for name in ("Cf", "Cf_tilde", "Cn_hat", "Cphi", "B_hat"):
            if not _same_operator(getattr(ds1, name), getattr(ds2, name)):
                raise ValueError(
                    f"quadratic_estimate(ds, ds2=...) requires matching "
                    f"{name} between the two datasets (the normalization "
                    f"is computed from ds1's operators)")
        b1, b2 = ds1.d.batch_shape, ds2.d.batch_shape
        if b1 != b2:
            raise ValueError(f"ds.d and ds2.d must share a batch shape; got {b1} vs {b2}")
    if which is None:
        which = "TT" if ds1.d.basis.pol == "I" else "EB"
    if which not in _QE_FNS:
        raise ValueError(f"which should be one of {tuple(_QE_FNS)} (got {which!r})")
    ds0 = ds1.at({})
    proj = ds0.d.proj
    Cf, Cft, Cn, Cphi = _fid(ds0.Cf), _fid(ds0.Cf_tilde), _fid(ds0.Cn_hat), _fid(ds0.Cphi)

    def tf_component(comp):
        def comp_arr(op):
            return 1.0 if isinstance(op, _Identity) else _spin0_arr(op[comp])
        return comp_arr(ds0.M_hat) * comp_arr(ds0.B_hat)

    Cphi_arr = _spin0_arr(Cphi)
    d1, d2 = ds1.d, ds2.d
    if which == "TT":
        legs = (_spin0_arr(d1["I"].to(FOURIER)), _spin0_arr(d2["I"].to(FOURIER)))
        covs = (_spin0_arr(Cf["I"]), _spin0_arr(Cft["I"]), _spin0_arr(Cn["I"]), Cphi_arr,
                tf_component("I"))
    elif which == "EE":
        legs = (_spin0_arr(d1["E"]), _spin0_arr(d2["E"]))
        covs = (_spin0_arr(Cf["E"]), _spin0_arr(Cft["E"]), _spin0_arr(Cn["E"]), Cphi_arr,
                tf_component("E"))
    else:
        legs = (_spin0_arr(d1["E"]), _spin0_arr(d2["B"]))
        covs = (_spin0_arr(Cf["E"]), _spin0_arr(Cf["B"]), _spin0_arr(Cft["E"]),
                _spin0_arr(Cft["B"]), _spin0_arr(Cn["E"]), _spin0_arr(Cn["B"]), Cphi_arr,
                tf_component("E"), tf_component("B"))
    qe_fn = _QE_FNS[which]
    if d1.batch_shape and AL is None:
        first = (x.reshape((-1,) + x.shape[-2:])[0] for x in legs)
        AL = qe_fn(proj, *first, *covs, wiener_filtered=False, weights=weights)["AL"]
    return qe_fn(proj, *legs, *covs, wiener_filtered=wiener_filtered, weights=weights, AL=AL)
