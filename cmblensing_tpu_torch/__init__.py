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
ensemble; the parallel layer on torch.distributed (ensembles split over
ranks with ``mesh=``, and maps split over ranks by rows: the sharded
LenseFlow, pencil FFTs, Wiener filter, joint MAP and Gibbs/HMC); the
field API (FieldTuple, FieldVector / FieldMatrix, FuncOp,
the pass filters and gradient operators, the rfft helpers, ud_grade); and
the curved sky: EquiRect bands with their block covariances and Wiener
filter, HEALPix maps and their projection to and from flat grids
(bilinear or by the NUFFT).

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
    Basis, MAP, FOURIER, QU_MAP, QU_FOURIER, EB_MAP, EB_FOURIER, IQU_MAP, IQU_FOURIER, IEB_MAP,
    IEB_FOURIER,
    lense_basis, deriv_basis, harmonic_basis,
)
from .core.field import (  # noqa: E402
    Field, dot, norm, fgrad, fvalue_and_grad, zeros_like_field, from_maps, zeros, randn,
    sum_field, batch, unbatch, batch_index, batch_length, repeat_batch, batch_map,
)
from .core.ops import (  # noqa: E402
    BlockDiagIEB, Diag, Identity, Id, LazyOp, FuncOp, SymmetricFuncOp, ParamDependentOp, Scaled,
    BandPass, HighPass, LowPass, MidPass, MidPasses, evaluate_at, logdet, logdet_rel,
    simulate_op, nan2zero, gradient, gradient_ops, gradhess, laplacian, tr, diag_field,
)
from .core.field_tuple import FieldTuple, DiagFieldTuple, ft_dot  # noqa: E402
from .core.field_vectors import (  # noqa: E402
    FieldVector, FieldMatrix, gradient_vector, hessian_matrix, magnification_matrix,
)
from .core.proj_equirect import (  # noqa: E402
    ProjEquiRect, EquiRectField, BlockDiagEquiRect, Cl_to_Cov_EquiRect, Cl_to_Beam_EquiRect,
    er_dot, mapblocks,
)
from .core.proj_healpix import ProjHealpix, HealpixField, project  # noqa: E402
from .ops.fft import unfold, fftsyms, rfft2vec, vec2rfft  # noqa: E402
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
    once_every, start_after_burnin, gibbs_sample_f, gibbs_sample_phi, gibbs_sample_slice_theta,
    gibbs_mix, gibbs_unmix, gibbs_postprocess,
)
from .inference.chains import (  # noqa: E402
    Chain, Chains, load_chains, effective_sample_size, mean_std_and_errors, kde,
)
from .parallel.mesh import (  # noqa: E402
    make_mesh, shard_batch, replicate, local_mesh, distributed_initialize, proc_info,
    gather_batch,
)
from .parallel.spatial import (  # noqa: E402
    ShardedLenseFlow, lense_sharded, spatial_mesh, shard_spatial, gather_spatial,
)
from .parallel.sharded_fft import (  # noqa: E402
    rfft2_sharded, irfft2_sharded, pad_multiplier, fourier_diag_apply_sharded, get_Cl_sharded,
)
from .parallel.sharded_wf import (  # noqa: E402
    sharded_wiener_filter, sharded_lensing_logpdf, sharded_MAP_joint, sharded_sample_f,
    sharded_hmc_phi_step, sharded_gibbs_pass, sharded_sample_joint,
)
from .utils.spectra import bandpower_corr, get_Cl, get_Dl  # noqa: E402
from .utils.ud_grade import ud_grade  # noqa: E402
from .utils.timing import timed, timer_report, reset_timers, profiler_trace  # noqa: E402
from .utils.plotting import animate  # noqa: E402


def expnorm(x):
    """exp(x - max(x))."""
    x = torch.as_tensor(x)
    return torch.exp(x - torch.max(x))


def diag(op):
    """The diagonal field of a diagonal-like operator."""
    d = op.diag
    return d() if callable(d) else d


def fieldinfo(f):
    """A one-line description of a field."""
    return (f"{type(f).__name__}(basis={f.basis}, shape={tuple(f.arr.shape)}, "
            f"dtype={f.arr.dtype}, proj={f.proj})")


def firsthalf(x):
    """The first half of a sequence."""
    return x[: len(x) // 2]


def lasthalf(x):
    """The last half of a sequence."""
    return x[len(x) // 2:]
