"""The masked IP Wiener filter (`argmaxf_logpdf`) and MAP_joint's
history against the JAX package, on the 32^2 IP dataset of
tests/test_torch_ieb.py and the 32^2 P dataset of tests/test_torch_map.py,
and the dense plain 'high' flows at a plane shape the kernels' 32 x 32
tile does not divide.

Tolerances:
- the strict solve, 30 fixed iterations: f within 1e-4 relative max-abs
  of JAX's (both strict float32; measured 5.5e-6).
- "auto" at the defaults (tol 0.1, nsteps 500) against JAX's strict
  solve: f within 1e-3 in norm, the inexact-Krylov bound of
  tests/test_inference.py:267.
- the precision_fallback verdict: the JAX package's 'high' matmuls are
  exact float32 on the CPU, so its verdict there is the strict solve's.
  The two verdicts are held equal where that is the 'high' solve's too: at
  tol 100 the port's 'high' solve passes its strict check (res_strict
  91.8 <= 100) as JAX's strict one does, and at tol 0 with fixed
  iterations both miss 1e-10 res0 and re-run strict. At the defaults the
  port's 'high' solve misses its check (443 iterations reach res 0.069 on
  their own operator, res_strict 1.5 at tol 1 already) and falls back,
  where JAX on the CPU cannot; the test asserts that the port's verdict is
  its own check's.
- MAP_joint's history at 32^2 P, strict: logpdfs 1e-5 relative, phi and f
  1e-4 relative max-abs (measured 1e-6), the CG residual traces 1e-5.
- the dense plain 'high' flows at 40 x 48 against JAX's whole-flow kernel
  `_flow_call` at 'high' in interpret mode: 1e-5 (the bound of
  tests/test_torch_high.py for 32^2; the same products summed in another
  order), delta phi 2e-5 (hoisted against integrated in the state).
"""
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_ieb import IP32, rel  # noqa: F401  (IP32 is a fixture)
from test_torch_map import P32  # noqa: F401  (a fixture)


@pytest.fixture(autouse=True)
def _restore_modes():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jderiv.set_deriv_mode("auto")
    tderiv.set_matmul_precision("f32")


def _in_jax_basis(tf, jf):
    return tf.to(ct.Basis(jf.basis.pol, jf.basis.space)).arr.numpy()


def test_IP_argmaxf_strict_matches_jax(IP32):
    cg = dict(tol=0.0, nsteps=30, fixed_iters=True, hessian_precision=None)
    jf, _ = jm.argmaxf_logpdf(IP32["jds"], phi=IP32["jphi"], conjgrad_kwargs=cg)
    tf, info = ct.argmaxf_logpdf(IP32["tds"], phi=IP32["tphi"], conjgrad_kwargs=cg)
    assert info["iterations"] == 30 and tf.basis == ct.Basis(jf.basis.pol, jf.basis.space)
    assert rel(_in_jax_basis(tf, jf), np.array(jf.arr)) < 1e-4


def test_IP_argmaxf_auto_at_the_defaults(IP32, monkeypatch):
    """The JAX defaults on both sides (tol 0.1, nsteps 500, "auto"): the
    port's f within 1e-3 in norm of JAX's strict f; its fallback verdict
    the one its own 'high' solve's strict-residual check gives."""
    jf, _ = jm.argmaxf_logpdf(IP32["jds"], phi=IP32["jphi"],
                              conjgrad_kwargs=dict(hessian_precision=None))
    solves, core = [], tm._argmaxf_core

    def spy(*a, **k):
        x, info = core(*a, **k)
        solves.append(dict(info))
        return x, info

    monkeypatch.setattr(tm, "_argmaxf_core", spy)
    tf, info = ct.argmaxf_logpdf(IP32["tds"], phi=IP32["tphi"])
    out, ref = _in_jax_basis(tf, jf), np.array(jf.arr)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-3
    assert bool(info.get("precision_fallback", False)) is not bool(solves[0]["precision_ok"])


@pytest.mark.parametrize("cg,fallback", [(dict(tol=100.0, nsteps=500), False),
                                         (dict(tol=0.0, nsteps=3, fixed_iters=True), True)])
def test_IP_argmaxf_auto_verdict_matches_jax(IP32, cg, fallback):
    jf, jinfo = jm.argmaxf_logpdf(IP32["jds"], phi=IP32["jphi"], conjgrad_kwargs=dict(cg))
    tf, tinfo = ct.argmaxf_logpdf(IP32["tds"], phi=IP32["tphi"], conjgrad_kwargs=dict(cg))
    assert bool(jinfo.get("precision_fallback", False)) is fallback
    assert bool(tinfo.get("precision_fallback", False)) is fallback
    out, ref = _in_jax_basis(tf, jf), np.array(jf.arr)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-3


@pytest.mark.parametrize("precision", ["f32", "high"])
def test_matmul_backend_is_the_kernel_flows_on_plain_leaves(IP32, P32, precision):
    """The "matmul" LenseFlow backend (the reference the card holds the
    kernels to) runs the kernel backend's flows on their plain leaves: on
    the CPU, where the kernel backend runs those same leaves, the IP Wiener
    filter (10 fixed iterations, everything at `precision`) and the P
    phi-gradient (both flows and the transpose-delta flow) come out bit for
    bit the same; strict, the Wiener filter within 1e-4 of JAX's (the bound
    of test_IP_argmaxf_strict_matches_jax)."""
    cg = dict(tol=0.0, nsteps=10, fixed_iters=True, hessian_precision=None)
    ds, ps = IP32["tds"], P32["tds"]
    m = ct.mix(ps, f=P32["tf"], phi=P32["tphi"])
    f_mix, phi_mix = m["f_mix"], m["phi_mix"].to(ct.MAP)
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ps).logpdf(f_mix=f_mix, phi_mix=p))
    out = {}
    for backend in ("kernel", "matmul"):
        with ct.lenseflow_backend_ctx(backend), tderiv.precision_ctx(precision):
            f, _ = ct.argmaxf_logpdf(ds, phi=IP32["tphi"], conjgrad_kwargs=cg)
            out[backend] = (f.arr, vg(phi_mix)[1].arr)
    assert all(torch.equal(a, b) for a, b in zip(out["kernel"], out["matmul"]))
    if precision == "f32":
        jf, _ = jm.argmaxf_logpdf(IP32["jds"], phi=IP32["jphi"], conjgrad_kwargs=cg)
        tf = ct.Field(out["matmul"][0], f.basis, f.proj)
        assert rel(_in_jax_basis(tf, jf), np.array(jf.arr)) < 1e-4


def test_strict_residual_check_is_strict_under_an_outer_high_context(P32):
    """The 'high' solve's strict-residual check pins b, a0 and its residual
    to 'f32' whatever precision is in force around argmaxf_logpdf: under
    an outer precision_ctx("high") it gives the plain-f32 check's
    res_strict exactly."""
    args = (P32["tds"], {}, P32["tphi"], P32["tds"].d, None, False, "high")
    with torch.no_grad():
        _, plain = tm._argmaxf_core(*args, tol=1e-4, nsteps=50)
        with tderiv.precision_ctx("high"):
            _, outer = tm._argmaxf_core(*args, tol=1e-4, nsteps=50)
    assert outer["iterations"] == plain["iterations"]
    assert float(outer["res_strict"]) == float(plain["res_strict"])


def test_argmaxf_warns_on_a_logprior(P32):
    ds = P32["tds"].replace(logprior=lambda theta, f, phi: 0.0)
    with pytest.warns(UserWarning, match="GAUSSIAN conditional"):
        ct.argmaxf_logpdf(ds, phi=P32["tphi"], conjgrad_kwargs=dict(
            tol=0.0, nsteps=1, fixed_iters=True, hessian_precision=None))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ct.argmaxf_logpdf(P32["tds"], phi=P32["tphi"], conjgrad_kwargs=dict(
            tol=0.0, nsteps=1, fixed_iters=True, hessian_precision=None))


def test_MAP_joint_history_keys_match_jax(P32):
    """history_keys ("logpdf", "phi", "f", "cg_res_history") record what
    the JAX package records, step by step (strict on both sides)."""
    keys = ("logpdf", "phi", "f", "cg_res_history")
    cg = dict(tol=0.0, nsteps=3, fixed_iters=True, record_history=True)
    jr = jm.MAP_joint(P32["jds"], nsteps=2, conjgrad_kwargs=cg, history_keys=keys,
                      precision=None)
    tr = ct.MAP_joint(P32["tds"], nsteps=2, conjgrad_kwargs=cg, history_keys=keys,
                      precision=None)
    for jh, th in zip(jr["history"], tr["history"]):
        assert set(th) == set(jh) == set(keys)
        assert abs(th["logpdf"] - jh["logpdf"]) < 1e-5 * abs(jh["logpdf"])
        for k in ("phi", "f"):
            assert th[k].basis == ct.Basis(jh[k].basis.pol, jh[k].basis.space)
            assert rel(th[k].arr.numpy(), np.array(jh[k].arr)) < 1e-4
        assert rel(th["cg_res_history"], jh["cg_res_history"]) < 1e-5
    assert rel(tr["phi"].arr.numpy(), np.array(jr["phi"].arr)) < 1e-4


def test_MAP_joint_refuses_unknown_keys_and_takes_the_jax_signature(P32):
    kw = dict(nsteps=1, conjgrad_kwargs=dict(tol=0.0, nsteps=1, fixed_iters=True),
              precision=None)
    with pytest.raises(ValueError, match="history_keys"):
        ct.MAP_joint(P32["tds"], history_keys=("logpdf", "hessian"), **kw)
    out = ct.MAP_joint(P32["tds"], alpha_tol=1e-4, key=None, **kw)
    assert len(out["history"]) == 1
    # alpha_tol (brent's) and key (quasi_sample's) were refused at other
    # values until brent and quasi-samples were ported; they run now
    out = ct.MAP_joint(P32["tds"], alpha_tol=1e-3, linesearch="brent", **kw)
    assert np.isfinite(out["history"][-1]["logpdf"])
    out = ct.MAP_joint(P32["tds"], key=0, quasi_sample=True, **kw)
    assert np.isfinite(out["history"][-1]["logpdf"])
    with pytest.raises(ValueError, match="linesearch"):
        ct.MAP_joint(P32["tds"], linesearch="golden", **kw)


def _weak_lensing(Ny, Nx, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1, random f and dy."""
    phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2
    phi = np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return phi, (rng.standard_normal((2, Ny, Nx)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("adjoint", 1.0, 0.0),
                                        ("backward", 0.0, 1.0)])
def test_dense_high_flows_at_a_ragged_shape_match_jax_flow_call_interpret(kind, t0, t1):
    """The dense plain 'high' flows (the CPU side of K2 'high', whose edge
    tiles the card runs at such shapes) at 40 x 48 against `_flow_call`
    at 'high' in interpret mode with dense in-kernel derivatives."""
    Ny, Nx, nsteps = 40, 48, 3
    jderiv.set_deriv_mode("matmul")
    jp = JProj(Ny, Nx, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cpu")
    mats = tderiv.deriv_mats(tp)
    phi, (f, dy) = _weak_lensing(Ny, Nx)
    planes = lfk.gradhess_plain(torch.as_tensor(phi), mats)
    g, h = (tuple(jnp.asarray(p) for p in planes.numpy()[s]) for s in (slice(0, 2), slice(2, 5)))
    if kind == "backward":
        dphi_j, df0_j = plf.pallas_flow_bwd(jnp.asarray(dy), jnp.asarray(f), g, h, t0, t1, nsteps,
                                            jp, precision="high", interpret=True)
        dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, mats, t0, t1,
                                 nsteps, "high")
        assert rel(df0.numpy(), df0_j) < 1e-5
        assert rel(dphi.numpy(), dphi_j) < 2e-5
        return
    ref = plf.pallas_flow_apply(jnp.asarray(f), g, h, t0, t1, nsteps, jp, kind, precision="high",
                                interpret=True)
    out = lfk.flow_apply(torch.as_tensor(f), planes, mats, t0, t1, nsteps, kind, "high")
    assert rel(out.numpy(), ref) < 1e-5
