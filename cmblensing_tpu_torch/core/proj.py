"""Flat-sky (Lambert azimuthal equal-area) projection metadata.

PyTorch counterpart of ``cmblensing_tpu/core/proj.py``. A ProjLambert is
a memoized metadata object: its grids (lx, ly, lmag, sin2phi, cos2phi,
lam_rfft) are host numpy arrays, pure functions of (Ny, Nx, thetapix,
T), and ``proj.tensor(name)`` hands out a cached copy of one on the
projection's ``device``: the CUDA card unless the caller names another
(``device="cpu"``); with no card and no ``device`` the constructor
raises rather than carry on on the CPU.

Arrays are (..., ncomp, Ny, Nx) with the FFT over the last two axes and
the rfft half-axis along x. Physical conventions (deltax =
deg2rad(thetapix/60), Omega_pix = deltax^2, unnormalized forward FFTs,
rfft degeneracy weights) are those of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def rfft_degeneracy_fac(n: int) -> np.ndarray:
    """Weights along the rfft half-axis of full length n: 2 where the
    conjugate entry appears in the full-plane FFT, 1 where
    self-conjugate."""
    if n % 2 == 0:
        return np.concatenate([[1.0], np.full(n // 2 - 1, 2.0), [1.0]])
    return np.concatenate([[1.0], np.full(n // 2, 2.0)])


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None. The port runs on the
    card unless asked for another device; without a card it raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless given a device, "
                           "e.g. device='cpu'")
    return torch.device("cuda")


class ProjLambert:
    """Flat-sky projection metadata (one instance per parameter set and
    device)."""

    _cache = {}

    def __new__(cls, Ny, Nx, thetapix=1.0, T=np.float32, device=None,
                rotator=(0.0, 90.0, 0.0)):
        T = np.dtype(T)
        device = resolve_device(device)
        rotator = tuple(map(float, rotator))
        key = (int(Ny), int(Nx), float(thetapix), T.str, str(device), rotator)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        self._init(int(Ny), int(Nx), float(thetapix), T, device, rotator)
        cls._cache[key] = self
        return self

    def _init(self, Ny, Nx, thetapix, T, device, rotator):
        self.Ny = Ny
        self.Nx = Nx
        self.thetapix = thetapix
        self.device = device
        self.rotator = rotator   # the map center's (z, y, x) rotation in degrees; metadata
        self.T = T
        self.complex_T = (np.dtype(np.complex64) if T == np.dtype(np.float32)
                          else np.dtype(np.complex128))
        self.torch_T = _TORCH_DTYPES[T]
        self._tensors = {}

        deltax = np.deg2rad(thetapix / 60.0)
        self.deltax = T.type(deltax)
        self.Omega_pix = T.type(deltax ** 2)
        self.nyquist = T.type(2 * np.pi / (2 * deltax))
        self.delta_lx = T.type(2 * np.pi / (Nx * deltax))
        self.delta_ly = T.type(2 * np.pi / (Ny * deltax))

        # full-length ly (major axis), half-length lx (rfft axis = x)
        ly_full = np.fft.ifftshift(np.arange(-(Ny // 2), (Ny - 1) // 2 + 1)) * float(self.delta_ly)
        lx_full = np.fft.ifftshift(np.arange(-(Nx // 2), (Nx - 1) // 2 + 1)) * float(self.delta_lx)
        self.ly = ly_full.astype(T)                      # (Ny,)
        self.lx = lx_full[: Nx // 2 + 1].astype(T)       # (Nx//2+1,)

        LY = self.ly[:, None].astype(np.float64)
        LX = self.lx[None, :].astype(np.float64)
        self.lmag = np.sqrt(LX ** 2 + LY ** 2).astype(T)   # (Ny, Nx//2+1)

        # polarization rotation angle phi_l = atan2(ly, lx)
        phi = np.angle(LX + 1j * LY)
        sin2phi = np.sin(2 * phi)
        cos2phi = np.cos(2 * phi)
        # fixup at the lx-Nyquist column so conjugate-pair rows match
        if Nx % 2 == 0 and Ny > 1:
            rs = np.arange(1, (Ny - 1) // 2 + 1)
            sin2phi[Ny - rs, -1] = sin2phi[rs, -1]
        self.sin2phi = sin2phi.astype(T)
        self.cos2phi = cos2phi.astype(T)

        self.lam_rfft = rfft_degeneracy_fac(Nx).astype(T)   # (Nx//2+1,)

        self.shape_map = (Ny, Nx)
        self.shape_fourier = (Ny, Nx // 2 + 1)

    def tensor(self, name):
        """Host grid `name` as a tensor on this projection's device
        (cached)."""
        t = self._tensors.get(name)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(getattr(self, name)),
                                device=self.device)
            self._tensors[name] = t
        return t

    def __reduce__(self):
        # pickled by its parameters: unpickling gives the memoized instance
        return (ProjLambert, (self.Ny, self.Nx, self.thetapix, self.T, str(self.device),
                              self.rotator))

    def __hash__(self):
        return hash((ProjLambert, self.Ny, self.Nx, self.thetapix, self.T.str,
                     str(self.device), self.rotator))

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return (f"ProjLambert(Ny={self.Ny}, Nx={self.Nx}, thetapix={self.thetapix}, "
                f"T={self.T.name}, device={self.device})")



def pixwin(thetapix, ell):
    """Pixel window function for square flat-sky pixels of width
    thetapix arcmin."""
    ell = np.asarray(ell, dtype=np.float64)
    return np.sinc(ell * np.deg2rad(thetapix / 60.0) / (2 * np.pi))
