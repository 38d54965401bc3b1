"""The hand-written CUDA LenseFlow kernels against their plain PyTorch
versions, on the card. These tests need a CUDA device (the kernels have
no CPU mode) and skip without one. The module imports no JAX, so that it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bound: 1e-5 relative max-abs, both sides strict FP32 summing in another
order; 5e-4 for grad/Hess(phi), whose float32 value carries ~1e-4
relative error in any form (dense circulants or FFT, measured against
float64 at 256^2), so two FP32 summation orders differ by as much.
"""
import numpy as np
import pytest
import torch

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk

TOL = 1e-5
HESS_TOL = 5e-4
NSTEPS = 3


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _weak_lensing(N, ncomp=2, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1, random f and dy, from numpy."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    return phi, f, dy


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """The CUDA flow kernel against its plain version on the card, at
    64^2 and nsteps=3 (chip_smoke.py does the same at 256^2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow kernel has no CPU mode")
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cuda")
    phi, f, dy = _weak_lensing(N=64)
    mats = tderiv.deriv_mats(tp)
    pt = torch.as_tensor(phi, device="cuda")
    ft, dyt = torch.as_tensor(f, device="cuda"), torch.as_tensor(dy, device="cuda")
    planes = lfk.gradhess(pt, mats)
    assert rel(planes, lfk.gradhess_plain(pt, mats)) < HESS_TOL
    for kind in ("forward", "adjoint"):
        a = lfk.flow_apply(ft, planes, mats, 0., 1., NSTEPS, kind)
        b = lfk.flow_apply_plain(ft, planes, mats, 0., 1., NSTEPS, kind)
        assert rel(a, b) < TOL
    for a, b in zip(lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., NSTEPS),
                    lfk.flow_bwd_plain(dyt, ft, planes, mats, 0., 1., NSTEPS)):
        assert rel(a, b) < TOL


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow kernel has no CPU mode")
    tp = ct.ProjLambert(24, 24, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    x = torch.zeros((2, 24, 24), device="cuda")
    with pytest.raises(ValueError, match="multiples"):
        lfk.flow_apply(x, torch.zeros((5, 24, 24), device="cuda"), mats, 0., 1., 1)
    y = torch.zeros((2, 32, 32), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        lfk.deriv_cuda(y, None, None, torch.empty_like(y), y[0], y[0])
