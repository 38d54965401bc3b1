"""cmblensing_tpu_torch — the lensed-CMB posterior in PyTorch, with the
LenseFlow flow as hand-written CUDA kernels for NVIDIA Hopper.

A port of ``cmblensing_tpu`` (JAX), which stays the reference. This
package imports torch and never jax. It covers the mixed-posterior
phi-gradient and joint MAP estimation: load_sim for pol I, P and IP
(with a simulated pixel mask), Fourier-diagonal operators (the T/E/B
block operator at pol IP), LenseFlow with its continuous-adjoint
gradients, the quadratic estimator that sets the phi mixing, the CG
Wiener filter and MAP_joint with its grid line search.

Strict float32: TF32 is switched off for matmuls and convolutions, the
counterpart of the JAX package pinning every f32 matmul to
Precision.HIGHEST.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .core.proj import ProjLambert, rfft_degeneracy_fac, pixwin  # noqa: E402
from .core.basis import (  # noqa: E402
    Basis, MAP, FOURIER, QU_MAP, QU_FOURIER, EB_MAP, EB_FOURIER, IQU_MAP, IEB_FOURIER,
    lense_basis, deriv_basis, harmonic_basis,
)
from .core.field import Field, dot, norm, fgrad, fvalue_and_grad, zeros_like_field  # noqa: E402
from .core.ops import (  # noqa: E402
    BlockDiagIEB, Diag, Identity, Id, LazyOp, ParamDependentOp, Scaled, BandPass, LowPass,
    evaluate_at, logdet, logdet_rel, simulate_op, nan2zero,
)
from .core.cov import Cl_to_Cov  # noqa: E402
from .utils.cls import Cls, camb, noise_cls, beam_cls, extrapolate_cls  # noqa: E402
from .utils.masking import make_mask  # noqa: E402
from .models.distributions import MvNormal  # noqa: E402
from .models.lenseflow import (  # noqa: E402
    LenseFlow, set_lenseflow_backend, get_lenseflow_backend, lenseflow_backend_ctx,
)
from .models.quadratic_estimate import quadratic_estimate  # noqa: E402
from .models.dataset import (  # noqa: E402
    DataSet, Mixed, mix, unmix, load_sim, dataset_from_numpy,
)
from .ops.solvers import conjugate_gradient  # noqa: E402
from .inference.maximization import MAP_joint, argmaxf_logpdf  # noqa: E402
from .utils.spectra import bandpower_corr, get_Cl  # noqa: E402
