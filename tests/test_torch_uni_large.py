"""The universal role-switched kernel K5 (``_bwdAB_kernel``) at radix 16
and 32, where the card runs it in channel groups, against the JAX package
on the same numpy inputs, and the "uni" backend at a radix-16 blocking
against the kernel backend.

Radix 16 on a 32^2 plane (A = 2): JAX's interpreted `_bwdAB_kernel` and
`_uni_call` unroll B^2 butterfly terms a derivative (20 to 40 s a
compiled kernel at radix 16, 90 s at 32), so these cases are held to the
JAX package's plain XLA forms instead: each role composed from its XLA
factored derivative at radix 16 (ops/factored_deriv.py::apply_x /
apply_y, `_apply_factored_batched`, strict), and the uni L flow to its
LenseFlow scan at radix 16 (test_torch_high.py::_jax_xla_flow). The
interpreted kernels hold K5 at every tier at radix 4 and 8 and dense
(tests/test_torch_uni.py, test_torch_uni_tiers.py). Radix 32 (64^2) is
held to the same operator in dense form. Tolerances, relative max-abs per
output plane:

- strict: TOL, both sides float32 summed in other orders; the uni flow
  the same, and radix 32 against the dense circulants of its projection
  (the same operator, tests/test_torch_factored.py).
- role 1 at 'high' against the strict XLA form: HIGH_VS_STRICT, the
  split's operator error (its 'high' rounding is held to JAX's
  interpreted kernel at radix 4 and 8 in test_torch_uni_tiers.py).

MAP_joint on "uni" against "kernel" at radix 16 (FACTOR_A patched to 2
where ops/deriv.py and ops/lenseflow_kernels.py read it, so that a 32^2
P simulation takes radix-16 factored operands), one step: the same alpha,
logpdfs within 1e-6 (delta phi integrated in the state against hoisted).

The CUDA kernel is held to this plain version on the card
(tests/test_torch_cuda.py::test_uni_kernel_roles_at_radix_16_and_32_match_plain_on_card,
chip_smoke.py phase 16).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_high import HIGH_VS_STRICT, _jax_factored, _jax_xla_flow, _weak_lensing

TOL = 1e-5
A = 2   # the block size of these cases: N = B * A
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


def _ops(B, monkeypatch):
    """The port's radix-B factored operands of an (A B)^2 projection and
    JAX's (packed blocks, and an fkey whose butterfly metadata
    `_fmeta_from_key` is patched to give)."""
    N = A * B
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    jmats, fmeta = _jax_factored(N, B)
    monkeypatch.setattr(plf, "_fmeta_from_key", lambda key: fmeta)
    return tp, tfd.factored_ops(tp, B, B), jmats, ("uni large", N, B)


def _jax_roles_xla(role, x, t, N, B):
    """The four planes K5 writes for `role` (as uni_velocity_plain forms
    them), composed from the JAX package's XLA factored derivative at
    radix B, strict."""
    from cmblensing_tpu.core.proj import ProjLambert as JProj
    from cmblensing_tpu.ops import factored_deriv as jfd
    op = jfd._factored_ops(N, float(JProj(N, N, thetapix=3, T=np.float32).deltax), "float32",
                           B)[0]
    prec = jax.lax.Precision.HIGHEST

    def planes(a, b, px, py):
        dx, dy = (lambda v: jfd.apply_x(v, op, prec)), (lambda v: jfd.apply_y(v, op, prec))
        zero = jnp.zeros_like(a)
        if role == 0:
            fx, fy = dx(a), dy(a)
            return px * fx + py * fy, dx(px * b) + dy(py * b), b * fx, b * fy
        if role == 1:
            inner = [v + dx(t * px * v) + dy(t * py * v) for v in (a, b)]
            return dx(inner[0]) + dy(inner[1]), zero, zero, zero
        if role == 2:
            return px * dx(a) + py * dy(a), px * dx(b) + py * dy(b), zero, zero
        return dx(px * a) + dy(py * a), dx(px * b) + dy(py * b), zero, zero

    out = jax.jit(lambda *v: jnp.stack(planes(*v)))(*(jnp.asarray(x[k])
                                                      for k in ("a", "b", "px", "py")))
    return np.asarray(out)


def _role_inputs(tp, mats, t=0.6):
    """a, b (numpy) and the p(t) planes px, py of a weak-lensing phi at t."""
    phi, f, dy = _weak_lensing(tp.Nx)
    planes = lfk.gradhess(torch.as_tensor(phi), mats)
    px, py = (p.squeeze(0).numpy() for p in lfk._p_of_t(t, planes))
    return dict(a=f[0], b=dy[1], px=px, py=py)


@pytest.mark.parametrize("role,precision", [(0, "f32"), (1, "f32"), (2, "f32"), (3, "f32"),
                                            (1, "high")])
def test_uni_leaf_at_radix_16_matches_jax_bwdAB_kernel(role, precision, monkeypatch):
    """Each role of the plain K5 at radix 16 (and role 1, the nested one,
    at 'high') against the role composed from the JAX package's XLA
    factored derivative at radix 16 (`_jax_roles_xla`, strict), on p(t)
    planes of a weak-lensing phi at t = 0.6 and random a, b; the planes a
    role leaves at zero exactly zero on both sides."""
    B = 16
    tp, ops, jmats, fkey = _ops(B, monkeypatch)
    N, t = tp.Nx, 0.6
    x = _role_inputs(tp, ops, t)
    ref = _jax_roles_xla(role, x, t, N, B)
    args = [torch.as_tensor(x[k]) for k in ("a", "b", "px", "py")]
    out, strict = (torch.full((4, N, N), float("nan")) for _ in range(2))
    lfk.uni_velocity_plain(role, *args, out, ops, t, precision)
    lfk.uni_velocity_plain(role, *args, strict, ops, t)
    n = NONZERO[role]
    e = each(out[:n].numpy(), ref[:n])
    print(f"radix {B} role {role} {precision!r}: vs JAX {e:.3e}")
    es = each(strict[:n].numpy(), ref[:n])
    assert es < TOL, es
    assert e < (TOL if precision == "f32" else HIGH_VS_STRICT), e
    assert (out[n:] == 0).all() and (ref[n:] == 0).all()


def test_uni_leaf_at_radix_32_matches_the_dense_operator():
    """Every role of the plain K5 at radix 32 (64^2, A = 2) against the
    plain K5 on the dense circulants of the same projection, the same
    derivative operator: TOL; the same zero planes."""
    N, t = 32 * A, 0.6
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    ops, dense = tfd.factored_ops(tp, 32, 32), tderiv.deriv_mats(tp)
    args = [torch.as_tensor(v) for v in _role_inputs(tp, dense, t).values()]
    for role in range(4):
        out, ref = (torch.full((4, N, N), float("nan")) for _ in range(2))
        lfk.uni_velocity_plain(role, *args, out, ops, t)
        lfk.uni_velocity_plain(role, *args, ref, dense, t)
        n = NONZERO[role]
        e = each(out[:n].numpy(), ref[:n].numpy())
        print(f"radix 32 role {role}: vs the dense operator {e:.3e}")
        assert e < TOL and (out[n:] == 0).all() and (ref[n:] == 0).all(), (role, e)


def test_uni_flow_at_radix_16_matches_jax_uni_call_interpret(monkeypatch):
    """The uni L flow (role 2 on the component pair at every stage) at
    radix 16 on a 32^2 plane, one RK4 step, against the JAX package's
    plain XLA L flow at radix 16 (`_jax_xla_flow`): TOL. (The backward
    flow's roles 0 and 1 are held above.)"""
    tp, ops, jmats, fkey = _ops(16, monkeypatch)
    phi, f, _ = _weak_lensing(tp.Nx)
    planes = lfk.gradhess(torch.as_tensor(phi), ops)
    ref = _jax_xla_flow("forward", f, planes, tp.Nx, 16, 0., 1., 1, monkeypatch)
    out = lfk.uni_flow_apply(torch.as_tensor(f), planes, ops, 0., 1., 1, "forward")
    e = each(out.numpy(), ref)
    print(f"uni L flow radix 16: vs JAX {e:.3e}")
    assert out.shape == ref.shape and e < TOL, e


def test_uni_backend_MAP_joint_at_radix_16_matches_kernel_backend(monkeypatch):
    """MAP_joint (1 strict step, 5 fixed CG iterations) on a 32^2 P
    load_sim whose operands are radix 16 (FACTOR_A 2): the uni backend
    takes the kernel backend's alpha, its logpdf within 1e-6."""
    for mod in (tderiv, lfk):
        monkeypatch.setattr(mod, "FACTOR_A", A)
    ds = ct.load_sim(thetapix=3, Nside=32, pol="P", seed=0, device="cpu")["ds"]
    ops = tderiv.deriv_ops(ds.d.proj)
    assert isinstance(ops, tfd.FactoredOps) and ops.FX.shape == (16, A, A)
    hist = {}
    for be in ("kernel", "uni"):
        with ct.lenseflow_backend_ctx(be):
            hist[be] = ct.MAP_joint(ds, nsteps=1, precision=None, history_keys=("logpdf", "alpha"),
                                    conjgrad_kwargs=dict(tol=0.0, nsteps=5, fixed_iters=True))[
                "history"]
    assert [h["alpha"] for h in hist["uni"]] == [h["alpha"] for h in hist["kernel"]]
    assert hist["uni"][0]["alpha"] > 0
    lk, lu = (np.array([h["logpdf"] for h in hist[be]]) for be in ("kernel", "uni"))
    print(f"MAP_joint radix 16: logpdfs uni {lu.tolist()} kernel {lk.tolist()}")
    assert np.isfinite(lu).all() and rel(lu, lk) < 1e-6
