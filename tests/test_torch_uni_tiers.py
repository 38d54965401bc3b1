"""The "uni" granularity (the universal role-switched kernel K5,
``_bwdAB_kernel``) at the 'high' and 'bf16' tiers, dense and factored,
and the "uni" backend at the JAX defaults, against the JAX package on the
same numpy inputs and against the port's kernel backend.

The port's plain K5 (what the wrapper runs for a CPU tensor) is held to
`_bwdAB_kernel(precision=...)` in a Pallas interpreter kernel, which
really rounds to bf16, dense at 16^2 and factored at radix 4; the uni
flows to `_uni_call(..., precision, interpret=True)`, dense at 32^2 and
factored at radix 4, one RK4 step. Tolerances, relative max-abs per
output plane, as tests/test_torch_high.py and tests/test_torch_bf16.py
hold K3/K4 at the same tier:

- 'high': DERIV_TOL for the roles that take one derivative per product
  (0, 2, 3), FLOW_TOL for role 1, whose outer products split the inner
  stage's sums (a sum one ulp apart may split its residual otherwise) and
  for the flows: the same split operands, summed in another order.
- 'bf16', dense: SAME_ROUNDING_TOL (the same rounded operands). Factored:
  FLIP_TOL, since at radix 8 and in a flow's RK4 states a value formed in
  another order may round to the neighbouring bf16 value. Role 1 and the
  flows, dense as well: their inner sums and states are formed in another
  order on the two sides, so FLIP_TOL there too.
- every reduced-tier result also per plane in relative Frobenius norm:
  its distance to JAX's over its distance to the port's strict result,
  under KERNEL_RATIO (roles) or FLOW_RATIO (flows): what tells the tier
  from strict float32 where the max-abs bounds cannot.
- delta phi of the uni backward flow is integrated in the state on both
  sides by role 1 (unlike K4's hoisted form, whose DPHI_TOL covers two
  orders of rounding): held to the flows' bound.

End to end, on the CPU (JAX's MAP_joint and argmaxf_logpdf take its scan
there, where the tiers change nothing): MAP_joint on "uni" at "auto" and
'bf16' against the kernel backend at the same precision (the same
alphas, fallbacks and retries; logpdfs 1e-6), and argmaxf_logpdf on
"uni" at "auto" on the masked 32^2 IP data against the kernel backend
(the same fallback verdict, passing and falling back).

The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 15).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_bf16 import FLIP_TOL, FLOW_RATIO, KERNEL_RATIO, SAME_ROUNDING_TOL, ratio
from test_torch_high import DERIV_TOL, FLOW_TOL, _jax_factored, _weak_lensing
from test_torch_ieb import IP32  # noqa: F401  (a fixture)

TIERS = ("high", "bf16")
FORMS = ("dense", "factored")
B = 4   # the factored cases' radix
NONZERO = {0: 4, 1: 1, 2: 2, 3: 2}   # the planes each role writes; the rest are 0


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def each(out, ref):
    """The largest rel over the planes (leading axes flattened)."""
    planes = lambda x: np.asarray(x).reshape(-1, *np.shape(x)[-2:])
    return max(rel(o, r) for o, r in zip(planes(out), planes(ref)))


@pytest.fixture(autouse=True)
def _restore_modes():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tderiv.set_matmul_precision("f32")
    ct.set_lenseflow_backend("kernel")


def _ops(form, N):
    """The port's derivative operands (dense circulants or radix B) and
    JAX's (dense mats, fkey None; or packed factored blocks and the fkey
    whose butterfly metadata `_fmeta_from_key` is patched to give)."""
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    if form == "dense":
        return tderiv.deriv_mats(tp), plf._mats_for(JProj(N, N, thetapix=3, T=np.float32),
                                                    np.float32), None, None
    fmats, fmeta = _jax_factored(N, B)
    return tfd.factored_ops(tp, B, B), fmats, ("uni tiers", N, B), fmeta


def _role_tol(role, form, precision):
    if precision == "high":
        return FLOW_TOL if role == 1 else DERIV_TOL
    return SAME_ROUNDING_TOL if form == "dense" and role != 1 else FLIP_TOL


# =========================================================================
# (1) each role of the plain K5 at a tier against `_bwdAB_kernel`
# =========================================================================

@pytest.fixture(scope="module")
def role_inputs():
    """a, b, px, py at 16^2 from numpy: px, py the p(t) planes of a
    weak-lensing phi at t = 0.6."""
    N, t = 16, 0.6
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing(N)
    planes = lfk.gradhess(torch.as_tensor(phi), tderiv.deriv_mats(tp))
    px, py = (p.squeeze(0).numpy() for p in lfk._p_of_t(t, planes))
    return dict(N=N, t=t, a=f[0], b=dy[1], px=px, py=py)


_JAX_CALLS = {}   # (form, precision) -> `_bwdAB_kernel` jitted: one trace serves every role


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("role", [0, 1, 2, 3])
def test_uni_leaf_roles_at_the_tiers_match_jax_bwdAB_kernel(role_inputs, role, form, precision,
                                                            monkeypatch):
    x = role_inputs
    N = x["N"]
    mats, jmats, fkey, fmeta = _ops(form, N)
    if fkey is not None:
        monkeypatch.setattr(plf, "_fmeta_from_key", lambda key: fmeta)
    if (form, precision) not in _JAX_CALLS:
        vm = lambda: pl.BlockSpec(memory_space=pltpu.VMEM)
        _JAX_CALLS[form, precision] = jax.jit(pl.pallas_call(
            functools.partial(plf._bwdAB_kernel, precision=precision, fkey=fkey),
            out_shape=jax.ShapeDtypeStruct((4, N, N), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [vm() for _ in range(6)],
            out_specs=vm(), interpret=True))
    ref = np.asarray(_JAX_CALLS[form, precision](
        jnp.asarray([x["t"], role], jnp.float32),
        *(jnp.asarray(x[k]) for k in ("a", "b", "px", "py")), *jmats))
    args = [torch.as_tensor(x[k]) for k in ("a", "b", "px", "py")]
    out, strict = (torch.full((4, N, N), float("nan")) for _ in range(2))
    lfk.uni_velocity_plain(role, *args, out, mats, x["t"], precision)
    lfk.uni_velocity_plain(role, *args, strict, mats, x["t"])
    n = NONZERO[role]
    e, r = each(out[:n].numpy(), ref[:n]), ratio(out[:n], ref[:n], strict[:n])
    print(f"role {role} {form} {precision!r}: vs JAX {e:.3e}, ratio {r:.4f}")
    assert e < _role_tol(role, form, precision) and r < KERNEL_RATIO, (e, r)
    assert (out[n:] == 0).all() and (ref[n:] == 0).all()


# =========================================================================
# (2) the uni flows at a tier against `_uni_call` in interpret mode
# =========================================================================

@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("flow", ["L", "L^-1", "L^H", "backward"])
def test_uni_flows_at_the_tiers_match_jax_uni_call_interpret(flow, form, precision, monkeypatch):
    N = 32
    mats, jmats, fkey, fmeta = _ops(form, N)
    if fkey is not None:
        monkeypatch.setattr(plf, "_fmeta_from_key", lambda key: fmeta)
    phi, f, dy = _weak_lensing(N)
    planes = lfk.gradhess(torch.as_tensor(phi), mats, precision)
    t0, t1, kind = {"L": (0., 1., "forward"), "L^-1": (1., 0., "forward"),
                    "L^H": (1., 0., "adjoint"), "backward": (1., 0., "backward")}[flow]
    state = f if flow != "backward" else np.concatenate([f, dy, np.zeros((1, N, N), np.float32)])
    jplanes = tuple(jnp.asarray(p) for p in planes.numpy())
    ref = np.asarray(plf._uni_call(jnp.asarray(state), jplanes, jmats, kind, 1, t0, t1, precision,
                                   True, fkey))
    tol = FLOW_TOL if precision == "high" else FLIP_TOL
    if flow == "backward":
        run = lambda p: lfk.uni_flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, mats,
                                         0., 1., 1, p)
        (dphi, df0), (dphi_s, df0_s) = run(precision), run("f32")
        found = {"df0": (df0, ref[2:4], df0_s), "dphi": (dphi, ref[4:], dphi_s)}
    else:
        run = lambda p: lfk.uni_flow_apply(torch.as_tensor(f), planes, mats, t0, t1, 1, kind, p)
        found = {flow: (run(precision), ref, run("f32"))}
    for name, (out, r_, strict) in found.items():
        e, r = each(out.numpy(), r_), ratio(out, r_, strict)
        print(f"uni flow {name} {form} {precision!r}: vs JAX {e:.3e}, ratio {r:.4f}")
        assert out.shape == r_.shape and e < tol and r < FLOW_RATIO, (name, e, r)


# =========================================================================
# (3), (4) the "uni" backend at the JAX defaults against the kernel backend
# =========================================================================

@pytest.mark.parametrize("precision", ["auto", "bf16"])
def test_uni_backend_MAP_joint_at_the_tiers_matches_kernel_backend(precision):
    """MAP_joint on a 32^2 P load_sim at "auto" (the default) and 'bf16',
    each f-step's CG at its default "auto": the uni backend takes the
    kernel backend's alphas, fallbacks and retries, its logpdfs within
    1e-6 (delta phi integrated in the state against hoisted: the phi-step's
    gradients differ in their last bits, not its choices)."""
    ds = ct.load_sim(thetapix=3, Nside=32, pol="P", seed=0, device="cpu")["ds"]
    keys = ("logpdf", "alpha", "precision_fallback", "retry")
    kw = dict(nsteps=2, precision=precision, history_keys=keys,
              conjgrad_kwargs=dict(tol=0.0, nsteps=15, fixed_iters=True))
    hist = {}
    for be in ("kernel", "uni"):
        with ct.lenseflow_backend_ctx(be):
            hist[be] = ct.MAP_joint(ds, **kw)["history"]
    for k in keys[1:]:
        assert [h[k] for h in hist["uni"]] == [h[k] for h in hist["kernel"]], k
    assert hist["uni"][0]["alpha"] > 0
    lk, lu = (np.array([h["logpdf"] for h in hist[be]]) for be in ("kernel", "uni"))
    assert np.isfinite(lu).all() and rel(lu, lk) < 1e-6


@pytest.mark.parametrize("cg,wrong,fallback", [
    (dict(tol=100.0), False, False),
    (dict(tol=0.0, nsteps=20, fixed_iters=True), False, False),
    (dict(tol=0.0, nsteps=60, fixed_iters=True), True, True)])
def test_uni_backend_IP_argmaxf_auto_gives_the_kernel_backends_verdict(IP32, monkeypatch, cg,
                                                                       wrong, fallback):
    """argmaxf_logpdf at "auto" (the default hessian_precision) on the
    masked 32^2 IP data: the uni backend's fallback verdict is the kernel
    backend's, both ways (at tol 100 the 'high' solve passes its strict
    check; at tol 0 with 20 fixed iterations it misses 1e-10 res0 but
    passes the fixed-iteration re-check; with the 'high' Hessian made wrong
    by 1e-2 relative, at 60 fixed iterations, it misses both and re-runs
    strict; tests/test_torch_wiener.py says why these), and their f agree
    within 1e-4 in norm."""
    if wrong:
        from test_torch_wiener import _wrong_high_hessian
        _wrong_high_hessian(monkeypatch, IP32["tds"])
    out = {}
    for be in ("kernel", "uni"):
        with ct.lenseflow_backend_ctx(be):
            out[be] = ct.argmaxf_logpdf(IP32["tds"], phi=IP32["tphi"], conjgrad_kwargs=cg)
    (fk, ik), (fu, iu) = out["kernel"], out["uni"]
    assert iu.get("precision_fallback", False) == ik.get("precision_fallback", False) == fallback
    fk_, fu_ = fk.arr, fu.to(fk.basis).arr
    assert float((fu_ - fk_).norm() / fk_.norm()) < 1e-4
