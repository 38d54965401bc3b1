"""Angular power spectra: the `Cls` container, the fiducial theory
spectra, and analytic noise and beam spectra.

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
    """A power spectrum with ell labels; interpolates to any ell."""

    def __init__(self, ell, Cl):
        ell = np.asarray(ell, dtype=np.float64)
        Cl = np.asarray(Cl, dtype=np.float64)
        mask = ~np.isnan(Cl)
        self.ell = ell[mask]
        self.Cl = Cl[mask]

    def __call__(self, ell):
        """Linear interpolation, NaN outside the support (consumers map
        NaN to 0)."""
        ell = np.asarray(ell, dtype=np.float64)
        return np.interp(ell, self.ell, self.Cl, left=np.nan, right=np.nan)

    def sqrt(self):
        return Cls(self.ell, np.sqrt(self.Cl))

    def __repr__(self):
        return f"Cls(ell={self.ell[0]:.0f}..{self.ell[-1]:.0f}, n={len(self.ell)})"


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
    return Cls(ell_out, out)


class SpecSet(dict):
    """Dict with attribute access (spectrum components, parameters)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


_DEFAULT_PARAMS = dict(r=0.2, ombh2=0.0224567, omch2=0.118489, tau=0.055, mnu=0.06,
                       theta_s=0.0104098, H0=None, logA=3.043, ns=0.968602,
                       AL=1, k_pivot=0.002)


@functools.lru_cache(maxsize=None)
def _load_default_cls():
    z = np.load(_CLS_NPZ)
    out = SpecSet()
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
