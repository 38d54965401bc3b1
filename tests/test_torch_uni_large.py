"""The universal role-switched kernel K5 (``_bwdAB_kernel``) at radix 16
and 32, where the card runs it in channel groups, against the JAX package
on the same numpy inputs, and the "uni" backend at a radix-16 blocking
against the kernel backend.

Radix 16 on a 32^2 plane (A = 2), as tests/test_torch_high.py holds K1
at small A: JAX's `_bwdAB_kernel` and `_uni_call` run in a Pallas
interpreter with `_fmeta_from_key` patched to the radix's butterflies.
Its interpreted `_fact_apply` unrolls B^2 butterfly terms, so the cases
are few: one compiled kernel at radix 16 takes 20 s on one CPU core (38 s
at 'high'), one at radix 32 about 90 s, so radix 32 (64^2) is held to the
same operator in dense form instead. Tolerances, relative max-abs per
output plane, as tests/test_torch_uni.py and test_torch_uni_tiers.py hold
K5 at radix 4 and 8:

- strict: TOL, both sides float32 summed in other orders; the uni flow
  the same, and radix 32 against the dense circulants of its projection
  (the same operator, tests/test_torch_factored.py).
- role 1 at 'high': FLOW_TOL, since its outer products split the inner
  stage's sums, which the two sides form in other orders; and in relative
  Frobenius norm nearer JAX's than the port's strict result (KERNEL_RATIO).

MAP_joint on "uni" against "kernel" at radix 16 (FACTOR_A patched to 2
where ops/deriv.py and ops/lenseflow_kernels.py read it, so that a 32^2
P simulation takes radix-16 factored operands), one step: the same alpha,
logpdfs within 1e-6 (delta phi integrated in the state against hoisted).

The CUDA kernel is held to this plain version on the card
(tests/test_torch_cuda.py::test_uni_kernel_roles_at_radix_16_and_32_match_plain_on_card,
chip_smoke.py phase 16).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_bf16 import KERNEL_RATIO, ratio
from test_torch_high import FLOW_TOL, _jax_factored, _weak_lensing

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


_JAX_CALLS = {}   # (B, precision) -> `_bwdAB_kernel` jitted: one trace serves every role


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
    at 'high') against `_bwdAB_kernel` at the tier, on p(t) planes of a
    weak-lensing phi at t = 0.6 and random a, b; the planes a role leaves
    at zero exactly zero on both sides."""
    B = 16
    tp, ops, jmats, fkey = _ops(B, monkeypatch)
    N, t = tp.Nx, 0.6
    x = _role_inputs(tp, ops, t)
    if (B, precision) not in _JAX_CALLS:
        vm = lambda: pl.BlockSpec(memory_space=pltpu.VMEM)
        _JAX_CALLS[B, precision] = jax.jit(pl.pallas_call(
            functools.partial(plf._bwdAB_kernel, precision=precision, fkey=fkey),
            out_shape=jax.ShapeDtypeStruct((4, N, N), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [vm() for _ in range(6)],
            out_specs=vm(), interpret=True))
    ref = np.asarray(_JAX_CALLS[B, precision](
        jnp.asarray([t, role], jnp.float32), *(jnp.asarray(x[k]) for k in ("a", "b", "px", "py")),
        *jmats))
    args = [torch.as_tensor(x[k]) for k in ("a", "b", "px", "py")]
    out, strict = (torch.full((4, N, N), float("nan")) for _ in range(2))
    lfk.uni_velocity_plain(role, *args, out, ops, t, precision)
    lfk.uni_velocity_plain(role, *args, strict, ops, t)
    n = NONZERO[role]
    e = each(out[:n].numpy(), ref[:n])
    print(f"radix {B} role {role} {precision!r}: vs JAX {e:.3e}")
    if precision == "f32":
        assert e < TOL, e
    else:
        r = ratio(out[:n], ref[:n], strict[:n])
        print(f"  Frobenius ratio {r:.4f}")
        assert e < FLOW_TOL and r < KERNEL_RATIO, (e, r)
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
    radix 16 on a 32^2 plane, one RK4 step, against `_uni_call(...,
    interpret=True, fkey)`: TOL. (The backward flow's roles 0 and 1 are
    held above; its interpreted flow takes three times as long.)"""
    tp, ops, jmats, fkey = _ops(16, monkeypatch)
    phi, f, _ = _weak_lensing(tp.Nx)
    planes = lfk.gradhess(torch.as_tensor(phi), ops)
    ref = np.asarray(plf._uni_call(jnp.asarray(f), tuple(jnp.asarray(p) for p in planes.numpy()),
                                   jmats, "forward", 1, 0., 1., "f32", True, fkey))
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
