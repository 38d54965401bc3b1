"""Angular power spectra: the `Cls` container (interpolation, arithmetic)
and `FuncCls` (spectra as functions of ell: ell2, ell4, toDl, toCl), the
fiducial theory spectra and CAMB's output files (`load_camb_cls`),
analytic noise and beam spectra, LOWESS smoothing (`smooth`), and
`shift_l`, `get_l4Cl`, `get_rho_l`.

PyTorch-package counterpart of ``cmblensing_tpu/utils/cls.py`` (host
numpy only). The fiducial spectra are read from the port's own copy of
the JAX package's data file (``dat/default_camb_cls.npz``), so that the
port stands on its own.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_CLS_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dat",
                        "default_camb_cls.npz")


class Cls:
    """A power spectrum with ell labels; interpolates to any ell, and takes
    arithmetic with numbers, callables and other spectra (on the union of
    the two ell grids where both are concrete)."""

    def __init__(self, ell, Cl, concrete=True):
        ell = np.asarray(ell, dtype=np.float64)
        Cl = np.asarray(Cl, dtype=np.float64)
        mask = ~np.isnan(Cl)
        self.ell = ell[mask]
        self.Cl = Cl[mask]
        self.concrete = concrete

    def __call__(self, ell):
        """Linear interpolation, NaN outside the support (consumers map
        NaN to 0)."""
        ell = np.asarray(ell, dtype=np.float64)
        return np.interp(ell, self.ell, self.Cl, left=np.nan, right=np.nan)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            stop = idx.stop if idx.stop is not None else (
                int(self.ell[-1]) + 1 if len(self.ell) else 0)
            return self(np.arange(idx.start or 0, stop, idx.step or 1))
        return self(idx)

    def _binop(self, other, op):
        if isinstance(other, Cls):
            if self.concrete == other.concrete:
                ell = np.union1d(self.ell, other.ell)
            else:
                ell = self.ell if self.concrete else other.ell
            return Cls(ell, op(self(ell), other(ell)), concrete=self.concrete or other.concrete)
        if callable(other):
            return Cls(self.ell, op(self.Cl, other(self.ell)), concrete=self.concrete)
        return Cls(self.ell, op(self.Cl, other), concrete=self.concrete)

    def __add__(self, o):
        return self._binop(o, np.add)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._binop(o, np.subtract)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, np.multiply)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._binop(o, np.divide)

    def __pow__(self, p):
        return Cls(self.ell, self.Cl ** p, concrete=self.concrete)

    def sqrt(self):
        return Cls(self.ell, np.sqrt(self.Cl), concrete=self.concrete)

    def __repr__(self):
        return f"Cls(ell={self.ell[0]:.0f}..{self.ell[-1]:.0f}, n={len(self.ell)})"


class FuncCls:
    """A spectrum given as a function of ell, e.g. ell^2; multiplying or
    dividing a Cls by it gives a Cls on that Cls's ells."""

    def __init__(self, f):
        self.f = f
        self.concrete = False

    def __call__(self, ell):
        return self.f(np.asarray(ell, dtype=np.float64))

    def __mul__(self, o):
        if isinstance(o, Cls):
            return Cls(o.ell, self.f(o.ell) * o.Cl, concrete=o.concrete)
        if isinstance(o, FuncCls):
            return FuncCls(lambda l: self.f(l) * o.f(l))
        return FuncCls(lambda l: self.f(l) * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Cls):
            return Cls(o.ell, self.f(o.ell) / o.Cl, concrete=o.concrete)
        return FuncCls(lambda l: self.f(l) / o)


ell2 = FuncCls(lambda l: l ** 2)
ell4 = FuncCls(lambda l: l ** 4)
toDl = FuncCls(lambda l: l * (l + 1) / (2 * np.pi))
toCl = FuncCls(lambda l: 2 * np.pi / (l * (l + 1)))


def _lowess(x, y, frac=0.75):
    """LOWESS: at each x, the weighted linear fit (tricube weights) over
    the ceil(frac n) nearest points."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    r = max(2, int(np.ceil(frac * n)))
    out = np.empty(n)
    for i in range(n):
        d = np.abs(x - x[i])
        idx = np.argsort(d)[:r]
        dmax = d[idx].max()
        w = (1 - np.clip(d[idx] / max(dmax, 1e-300), 0, 1) ** 3) ** 3
        xw, yw = x[idx], y[idx]
        sw = w.sum()
        xm = (w * xw).sum() / sw
        ym = (w * yw).sum() / sw
        cov = (w * (xw - xm) * (yw - ym)).sum()
        var = (w * (xw - xm) ** 2).sum()
        b = cov / var if var > 0 else 0.0
        out[i] = ym + b * (x[i] - xm)
    return out


def smooth(cl: "Cls", newells=None, xscale="linear", yscale="linear", smoothing=0.75):
    """The LOWESS-smoothed spectrum (in log x and/or log y with
    xscale / yscale "log"), on `newells` (every integer ell of its support
    when None)."""
    fx = np.log if xscale == "log" else (lambda v: v)
    fy, fyi = (np.log, np.exp) if yscale == "log" else ((lambda v: v), (lambda v: v))
    if newells is None:
        newells = np.arange(cl.ell.min(), cl.ell.max() + 1)
    mask = np.isfinite(fy(cl.Cl)) if yscale == "log" else np.ones(len(cl.Cl), bool)
    ys = _lowess(fx(cl.ell[mask]), fy(cl.Cl[mask]), frac=smoothing)
    out = np.interp(fx(np.asarray(newells, dtype=np.float64)), fx(cl.ell[mask]), ys)
    return Cls(newells, fyi(out), concrete=cl.concrete)


def shift_l(dl, cl: "Cls", factor=False):
    """The spectrum with its ells shifted by dl (scaled by dl with
    factor=True)."""
    ell = cl.ell * dl if factor else cl.ell + dl
    return Cls(ell, cl.Cl, concrete=cl.concrete)


def get_l4Cl(f1, f2=None, **kwargs):
    """ell^4 C_ell of the fields' (cross-)spectrum (utils/spectra.py's
    get_Cl, which takes kwargs)."""
    from .spectra import get_Cl
    cl = get_Cl(f1, f2, **kwargs)
    return Cls(cl.ell, cl.ell ** 4 * cl.Cl, concrete=cl.concrete)


def get_rho_l(f1, f2, **kwargs):
    """The cross-correlation coefficient spectrum C_12 / sqrt(C_11 C_22)."""
    from .spectra import get_Cl
    cl1 = get_Cl(f1, **kwargs)
    cl2 = get_Cl(f2, **kwargs)
    clx = get_Cl(f1, f2, **kwargs)
    return Cls(cl1.ell, clx.Cl / np.sqrt(cl1.Cl * cl2.Cl))


def extrapolate_cls(ell_out, ell_in, Cl_in):
    """Power-law extrapolate spectra beyond their support."""
    ell_out = np.asarray(ell_out, dtype=np.float64)
    ell_in = np.asarray(ell_in, dtype=np.float64)
    Cl_in = np.asarray(Cl_in, dtype=np.float64)
    if np.all(Cl_in > 0):
        logC = np.interp(np.log(ell_out), np.log(ell_in), np.log(Cl_in))
        lo, hi = np.log(ell_in[0]), np.log(ell_in[-1])
        slope_lo = (np.log(Cl_in[1]) - np.log(Cl_in[0])) / (np.log(ell_in[1]) - np.log(ell_in[0]))
        slope_hi = (np.log(Cl_in[-1]) - np.log(Cl_in[-2])) / (np.log(ell_in[-1]) - np.log(ell_in[-2]))
        lout = np.log(ell_out)
        logC = np.where(lout < lo, np.log(Cl_in[0]) + slope_lo * (lout - lo), logC)
        logC = np.where(lout > hi, np.log(Cl_in[-1]) + slope_hi * (lout - hi), logC)
        out = np.exp(logC)
    else:
        out = np.interp(ell_out, ell_in, Cl_in, left=0.0, right=0.0)
    return Cls(ell_out, out, concrete=False)


class SpecSet(dict):
    """Dict with attribute access (spectrum components, parameters)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


class CMBSpectra(SpecSet):
    """The theory spectra `camb()` and `load_camb_cls` return: one
    SpecSet a component (unlensed_scalar, lensed_scalar, tensor,
    unlensed_total, total), each with TT/EE/BB/TE/pp Cls, and `params`."""


_DEFAULT_PARAMS = dict(r=0.2, ombh2=0.0224567, omch2=0.118489, tau=0.055, mnu=0.06,
                       theta_s=0.0104098, H0=None, logA=3.043, ns=0.968602,
                       AL=1, k_pivot=0.002)


@functools.lru_cache(maxsize=None)
def _load_default_cls():
    z = np.load(_CLS_NPZ)
    out = CMBSpectra()
    for comp in ["unlensed_scalar", "lensed_scalar", "tensor", "unlensed_total", "total"]:
        d = SpecSet()
        for spec in ["TT", "EE", "BB", "TE", "pp"]:
            d[spec] = Cls(z[f"{comp}_{spec}_l"], z[f"{comp}_{spec}"])
        d["phiphi"] = d["pp"]
        out[comp] = d
    out["params"] = SpecSet({k.replace("param_", ""): float(z[k])
                             for k in z.files if k.startswith("param_")})
    return out


def camb(lmax=6000, r=0.2, ombh2=0.0224567, omch2=0.118489, tau=0.055, mnu=0.06,
         theta_s=0.0104098, H0=None, logA=3.043, ns=0.968602, nt=None,
         AL=1, k_pivot=0.002):
    """The fiducial CMB theory spectra, read from the shipped file. Any
    other parameters need pycamb, which this package does not call."""
    if nt is None:
        nt = -r / 8
    asked = dict(r=r, ombh2=ombh2, omch2=omch2, tau=tau, mnu=mnu, theta_s=theta_s,
                 H0=H0, logA=logA, ns=ns, nt=nt, AL=AL, k_pivot=k_pivot)
    defaults = dict(_DEFAULT_PARAMS, nt=-_DEFAULT_PARAMS["r"] / 8)
    cached = _load_default_cls()
    if (lmax <= cached["params"].get("lmax", 0)
            and all(asked[k] == defaults[k] for k in asked)):
        return cached
    raise RuntimeError(
        "Non-fiducial theory parameters require pycamb, which is not "
        "installed in this environment. Use the fiducial parameters.")


def load_camb_cls(path_prefix, lmax=None,
                  unlensed_scalar_postfix="scalCls.dat",
                  unlensed_tensor_postfix="tensCls.dat",
                  lensed_scalar_postfix="lensedCls.dat",
                  lenspotential_postfix="lenspotentialCls.dat"):
    """Spectra from CAMB's output text files `path_prefix + postfix` (the
    D_ell columns of each, one header line), as `camb()` returns them;
    with `lmax`, each extrapolated to ell = 2 .. lmax - 1."""
    def _ext(ell, Cl):
        return (Cls(ell, Cl, concrete=False) if lmax is None
                else extrapolate_cls(np.arange(2, lmax), ell, Cl))

    def _read(postfix):
        t = np.loadtxt(path_prefix + postfix, skiprows=1)
        return t[:, 0], t, t[:, 0] * (t[:, 0] + 1) / (2 * np.pi)

    ell, lp, _ = _read(lenspotential_postfix)
    Clpp = _ext(ell, lp[:, 5] / ((ell * (ell + 1)) ** 2 / (2 * np.pi)))

    ell, us, fac = _read(unlensed_scalar_postfix)
    unlensed_scalar = SpecSet(
        TT=_ext(ell, us[:, 1] / fac), EE=_ext(ell, us[:, 2] / fac),
        TE=_ext(ell, us[:, 3] / fac), BB=_ext(ell, 0 * ell), pp=Clpp, phiphi=Clpp)
    ell, ls, fac = _read(lensed_scalar_postfix)
    lensed_scalar = SpecSet(
        TT=_ext(ell, ls[:, 1] / fac), EE=_ext(ell, ls[:, 2] / fac),
        BB=_ext(ell, ls[:, 3] / fac), TE=_ext(ell, ls[:, 4] / fac), pp=Clpp, phiphi=Clpp)
    ell, ts, fac = _read(unlensed_tensor_postfix)
    tensor = SpecSet(
        TT=_ext(ell, ts[:, 1] / fac), EE=_ext(ell, ts[:, 2] / fac),
        BB=_ext(ell, ts[:, 3] / fac), TE=_ext(ell, ts[:, 4] / fac), pp=Clpp, phiphi=Clpp)
    xs = ("TT", "EE", "BB", "TE")
    unlensed_total = SpecSet({k: unlensed_scalar[k] + tensor[k] for k in xs},
                             pp=Clpp, phiphi=Clpp)
    total = SpecSet({k: lensed_scalar[k] + tensor[k] for k in xs}, pp=Clpp, phiphi=Clpp)
    return CMBSpectra(unlensed_scalar=unlensed_scalar, tensor=tensor,
                      lensed_scalar=lensed_scalar, unlensed_total=unlensed_total,
                      total=total, params=SpecSet())


def noise_cls(muKarcminT, beamFWHM=0, lmax=8000, lknee=100, alphaknee=3):
    """White + 1/f noise spectra; polarization noise scaled by sqrt(2)."""
    ell = np.arange(2, lmax + 1)
    Bl = beam_cls(beamFWHM=beamFWHM, lmax=lmax)(ell)
    Nl1f = 1 + (lknee / ell) ** alphaknee
    out = SpecSet()
    for x in ["TT", "EE", "BB"]:
        fac = 1 if x == "TT" else 2
        out[x] = Cls(ell, fac * np.deg2rad(muKarcminT / 60) ** 2 / Bl * Nl1f)
    out["TE"] = Cls(ell, np.zeros_like(ell, dtype=np.float64))
    return out


def beam_cls(beamFWHM, lmax=8000):
    """Gaussian beam power spectrum W_ell."""
    ell = np.arange(2, lmax + 1)
    return Cls(ell, np.exp(-ell ** 2 * np.deg2rad(beamFWHM / 60) ** 2 / (8 * np.log(2))))
