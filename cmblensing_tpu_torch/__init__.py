"""cmblensing_tpu_torch — the lensed-CMB posterior in PyTorch, with the
LenseFlow flow as hand-written CUDA kernels for NVIDIA Hopper.

A port of ``cmblensing_tpu`` (JAX), which stays the reference. This
package imports torch and never jax. It covers the mixed-posterior
phi-gradient, joint MAP estimation and Gibbs/HMC sampling: load_sim for
pol I, P and IP (with a simulated pixel mask, and a batch of Nbatch
copies of its data), batched Fields, Fourier-diagonal operators (the
T/E/B block operator at pol IP), LenseFlow with its continuous-adjoint
gradients, the quadratic estimator that sets the phi mixing, the CG
Wiener filter (batched), MAP_joint with its grid line search (batched,
an alpha an entry), MAP_marg, sample_joint over a batch of chains with its
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
from .utils.cls import Cls, camb, noise_cls, beam_cls, extrapolate_cls  # noqa: E402
from .utils.masking import make_mask  # noqa: E402
from .models.distributions import MvNormal  # noqa: E402
from .models.lenseflow import (  # noqa: E402
    LenseFlow, set_lenseflow_backend, get_lenseflow_backend, lenseflow_backend_ctx,
)
from .models.quadratic_estimate import quadratic_estimate  # noqa: E402
from .models.dataset import (  # noqa: E402
    DataSet, Mixed, mix, unmix, load_sim, dataset_from_numpy, state_from_numpy,
)
from .ops.solvers import conjugate_gradient  # noqa: E402
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
