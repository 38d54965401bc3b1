"""cmblensing_tpu_torch — the lensed-CMB posterior in PyTorch, with the
LenseFlow flow as hand-written CUDA kernels for NVIDIA Hopper.

A port of ``cmblensing_tpu`` (JAX), which stays the reference. This
package imports torch and never jax. It covers the mixed-posterior
phi-gradient, joint MAP estimation and Gibbs/HMC sampling: load_sim for
pol I, P and IP with the JAX package's keywords (its noise, beam, mask,
spectra, mixing and lensing operator overrides, a simulated pixel mask,
and a batch of Nbatch copies of its data), datasets without lensing, the
forward-model sites of a dataset, batched Fields, Fourier-diagonal operators (the
T/E/B block operator at pol IP), LenseFlow with its continuous-adjoint
gradients and the other lensing operators (PowerLens, Taylens,
BilinearLens), the quadratic estimator that sets the phi mixing, the CG
Wiener filter (batched), MAP_joint with its grid (batched, an alpha an
entry) or brent line search, its Hessian update and quasi-samples, MAP_marg, sample_joint over a batch of chains with its
checkpoints and chains, banded (bandpower) covariances, the batched and
two-dataset quadratic estimate, and MUSE over a batched simulation
ensemble.

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
from .core.field import (  # noqa: E402
    Field, dot, norm, fgrad, fvalue_and_grad, zeros_like_field, from_maps, zeros, randn,
    sum_field, batch, unbatch, batch_index, batch_length, repeat_batch, batch_map,
)
from .core.ops import (  # noqa: E402
    BlockDiagIEB, Diag, Identity, Id, LazyOp, ParamDependentOp, Scaled, BandPass, LowPass,
    evaluate_at, logdet, logdet_rel, simulate_op, nan2zero,
)
from .core.cov import Cl_to_Cov, cov_to_Cl  # noqa: E402
from .utils.cls import (  # noqa: E402
    Cls, FuncCls, camb, load_camb_cls, noise_cls, beam_cls, extrapolate_cls, smooth, get_rho_l,
    shift_l, get_l4Cl, ell2, ell4, toCl, toDl,
)
from .utils.summation import set_sum_mode, get_sum_mode  # noqa: E402
from .utils.masking import make_mask  # noqa: E402
from .models.distributions import MvNormal  # noqa: E402
from .models.lenseflow import (  # noqa: E402
    LenseFlow, lense, get_max_lensing_step, set_lenseflow_backend, get_lenseflow_backend,
    lenseflow_backend_ctx,
)
from .models.powerlens import PowerLens, antilensing  # noqa: E402
from .models.taylens import Taylens  # noqa: E402
from .models.bilinearlens import BilinearLens  # noqa: E402
from .models import fwdmodel  # noqa: E402
from .models.quadratic_estimate import quadratic_estimate  # noqa: E402
from .models.dataset import (  # noqa: E402
    DataSet, BaseDataSet, NoLensingDataSet, Mixed, mix, unmix, load_sim, load_nolensing_sim,
    simulate, logpdf, gradientf_logpdf, Hessian_logpdf_preconditioner, dataset_from_numpy,
    state_from_numpy,
)
from .ops.solvers import (  # noqa: E402
    rk4_integrate, conjugate_gradient, conjugate_gradient_with_history, gmres,
)
from .inference.maximization import MAP_joint, MAP_marg, argmaxf_logpdf, sample_f  # noqa: E402
from .inference.muse import MuseProblem, muse, score  # noqa: E402
from .inference.sampling import (  # noqa: E402
    sample_joint, hmc_step, symplectic_integrate, mass_matrix_phi, grid_and_sample,
    once_every, start_after_burnin,
)
from .inference.chains import (  # noqa: E402
    Chain, Chains, load_chains, effective_sample_size, mean_std_and_errors, kde,
)
from .utils.spectra import bandpower_corr, get_Cl  # noqa: E402
