"""The port's "uni" granularity (the universal role-switched kernel K5,
``_bwdAB_kernel``, and the flows built on it), its derivative helpers
and the entry points' default device, against the JAX package on the
same numpy inputs.

Tolerances, relative max-abs:
- each role of the plain K5 leaf (what the wrapper runs for a CPU
  tensor) against JAX's `_bwdAB_kernel` in a Pallas interpreter kernel
  with dense matmul derivatives: 1e-5, dense and factored (A = 8..16).
- the uni flows (L, L^-1, L^H; backward df0 and un-hoisted delta phi)
  against JAX's `_uni_call` in interpret mode: 1e-5, the bound
  tests/test_deriv.py holds `_uni_call` / `_split_call` to.
- `dij_sum`, `div_plus_dij` against JAX: 1e-5.
- the un-hoisted backward flow against the hoisted one in float64:
  1e-12, the bound of tests/test_deriv.py's hoisting test.
- grad_phi° lnP on backend "uni" against JAX: 3e-4, as the kernel and
  plain backends in tests/test_torch_slice.py.
- MAP_joint on "uni" against "kernel": the same alphas, logpdfs 1e-6.

The CUDA kernel itself is held against this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.models import lenseflow as tlf
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_slice import _problem

TOL = 1e-5
NSTEPS = 3
FORMS = ("dense", "factored")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    jderiv.set_deriv_mode("auto")
    ct.set_lenseflow_backend("kernel")


def _weak_lensing(N=32, ncomp=2, dtype=np.float32, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1, random f, dy (as
    tests/test_torch_flow_kernel.py)."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(dtype)
    rng = np.random.default_rng(seed)
    return (phi, rng.standard_normal((ncomp, N, N)).astype(dtype),
            rng.standard_normal((ncomp, N, N)).astype(dtype))


def _mats(form, tp):
    """The port's derivative operands: dense circulants or the factored
    form at radix 4 (A = N / 4)."""
    return tderiv.deriv_mats(tp) if form == "dense" else tfd.factored_ops(tp, 4, 4)


# =========================================================================
# the K5 leaf, role by role
# =========================================================================

@pytest.fixture(scope="module")
def role_inputs():
    """a, b, px, py at 16^2 from numpy: px, py the p(t) planes of a
    weak-lensing phi at t = 0.6."""
    N, t = 16, 0.6
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing(N=N)
    planes = lfk.gradhess(torch.as_tensor(phi), tderiv.deriv_mats(tp))
    px, py = (p.squeeze(0).numpy() for p in lfk._p_of_t(t, planes))
    return dict(N=N, t=t, tp=tp, jp=JProj(N, N, thetapix=3, T=np.float32), a=f[0], b=dy[1],
                px=px, py=py)


def _jax_role(role, x):
    """JAX's `_bwdAB_kernel` for `role` in the Pallas interpreter, dense
    matmul derivatives, as `_uni_call` launches it."""
    N = x["N"]
    vm = lambda: pl.BlockSpec(memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        functools.partial(plf._bwdAB_kernel, precision="f32"),
        out_shape=jax.ShapeDtypeStruct((4, N, N), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [vm() for _ in range(6)],
        out_specs=vm(), interpret=True)
    s = jnp.asarray([x["t"], role], jnp.float32)
    return np.asarray(call(s, *(jnp.asarray(x[k]) for k in ("a", "b", "px", "py")),
                           *plf._mats_for(x["jp"], np.float32)))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("role", [0, 1, 2, 3])
def test_uni_leaf_roles_match_jax_bwdAB_kernel(role_inputs, role, form):
    x = role_inputs
    ref = _jax_role(role, x)
    out = torch.full((4, x["N"], x["N"]), float("nan"))
    lfk.uni_velocity_plain(role, *(torch.as_tensor(x[k]) for k in ("a", "b", "px", "py")), out,
                           _mats(form, x["tp"]), x["t"])
    nonzero = {0: 4, 1: 1, 2: 2, 3: 2}[role]
    for i in range(nonzero):
        assert rel(out[i].numpy(), ref[i]) < TOL, i
    assert (out[nonzero:] == 0).all() and (ref[nonzero:] == 0).all()


# =========================================================================
# the uni flows
# =========================================================================

@pytest.fixture(scope="module")
def uni_refs():
    """JAX's `_uni_call` flows at 32^2 in interpret mode (dense matmul
    derivatives), on phi planes the port computed."""
    N = 32
    jp = JProj(N, N, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing(N=N)
    planes = lfk.gradhess(torch.as_tensor(phi), tderiv.deriv_mats(tp))
    jplanes = tuple(jnp.asarray(p) for p in planes.numpy())
    mats = plf._mats_for(jp, np.float32)
    run = lambda state, kind, t0, t1: np.asarray(
        plf._uni_call(jnp.asarray(state), jplanes, mats, kind, NSTEPS, t0, t1, "f32", True))
    refs = {"L": run(f, "forward", 0., 1.), "L^-1": run(f, "forward", 1., 0.),
            "L^H": run(f, "adjoint", 1., 0.),
            "backward": run(np.concatenate([f, dy, np.zeros((1, N, N), np.float32)]),
                            "backward", 1., 0.)}
    return dict(tp=tp, planes=planes, f=torch.as_tensor(f), dy=torch.as_tensor(dy), refs=refs)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("flow", ["L", "L^-1", "L^H", "backward"])
def test_uni_flows_match_jax_uni_call_interpret(uni_refs, flow, form):
    u = uni_refs
    mats = _mats(form, u["tp"])
    ref = u["refs"][flow]
    if flow == "backward":
        dphi, df0 = lfk.uni_flow_bwd(u["dy"], u["f"], u["planes"], mats, 0., 1., NSTEPS)
        assert dphi.shape == (1, 32, 32) and df0.shape == u["f"].shape
        assert rel(df0.numpy(), ref[2:4]) < TOL
        assert rel(dphi.numpy(), ref[4:]) < TOL
        return
    t0, t1, kind = {"L": (0., 1., "forward"), "L^-1": (1., 0., "forward"),
                    "L^H": (1., 0., "adjoint")}[flow]
    out = lfk.uni_flow_apply(u["f"], u["planes"], mats, t0, t1, NSTEPS, kind)
    assert rel(out.numpy(), ref) < TOL


def test_uni_flows_take_the_batch_in_one_call(uni_refs):
    """A batch of (f, phi) pairs, and an odd component count (the last
    pair repeats its component), through the uni flows equal their
    entries one by one."""
    u = uni_refs
    ops = _mats("factored", u["tp"])
    planes2 = torch.stack([u["planes"], 0.5 * u["planes"]])
    fb = torch.stack([u["f"], u["dy"]])
    out = lfk.uni_flow_apply(fb, planes2, ops, 0., 1., NSTEPS, "adjoint")
    dphi, df0 = lfk.uni_flow_bwd(fb.flip(0), fb, planes2, ops, 0., 1., NSTEPS)
    for i in range(2):
        one = lfk.uni_flow_apply(fb[i], planes2[i], ops, 0., 1., NSTEPS, "adjoint")
        assert rel(out[i].numpy(), one.numpy()) < 1e-6
        dphi1, df01 = lfk.uni_flow_bwd(fb.flip(0)[i], fb[i], planes2[i], ops, 0., 1., NSTEPS)
        assert rel(dphi[i].numpy(), dphi1.numpy()) < 1e-6
        assert rel(df0[i].numpy(), df01.numpy()) < 1e-6
    f3 = torch.cat([u["f"], u["dy"][:1]])
    out3 = lfk.uni_flow_apply(f3, u["planes"], ops, 0., 1., NSTEPS)
    assert rel(out3.numpy(), lfk.flow_apply(f3, u["planes"], ops, 0., 1., NSTEPS).numpy()) < TOL


# =========================================================================
# derivative helpers and the un-hoisted backward velocity
# =========================================================================

@pytest.mark.parametrize("form", ["fft", "dense", "factored"])
@pytest.mark.parametrize("fn", ["dij_sum", "div_plus_dij"])
def test_dij_helpers_match_jax(fn, form):
    """The port's FFT form against JAX's FFT mode, its dense and factored
    products against JAX's matmul mode."""
    N = 32
    jp = JProj(N, N, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    s = np.random.default_rng(4).standard_normal((2, 6, N, N)).astype(np.float32)
    jderiv.set_deriv_mode("fft" if form == "fft" else "matmul")
    mats = None if form == "fft" else _mats(form, tp)
    st = torch.as_tensor(s)
    if fn == "dij_sum":
        ref = np.asarray(jderiv.dij_sum(jnp.asarray(s[:, :4]), jp))
        out = tderiv.dij_sum(st[:, :4], tp, mats)
    else:
        ref = np.asarray(jderiv.div_plus_dij(*jnp.asarray(s).swapaxes(0, 1), jp))
        out = tderiv.div_plus_dij(*st.unbind(1), tp, mats)
    assert out.shape == ref.shape
    assert rel(out.numpy(), ref) < TOL


@pytest.mark.parametrize("form", ["fft", "dense", "factored"])
def test_unhoisted_backward_flow_matches_hoisted_f64(form):
    """Delta phi integrated in the state (RK4 of `_backward_velocity` on
    the FFT path; the uni flow on dense or factored operands) equals the
    hoisted accumulation (`_backward_flow_scan`; `flow_bwd_plain`) in
    float64: the hoist is an exact identity."""
    N = 32
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float64, device="cpu")
    phi, f, dy = (torch.as_tensor(x) for x in _weak_lensing(N=N, dtype=np.float64))
    if form == "fft":
        g, h = tlf._gradhess_phi(phi, tp)
        state = torch.cat([f, dy, torch.zeros_like(phi)])
        y = tlf._rk4(lambda t, y: tlf._backward_velocity(t, y, g, h, tp), state, 1., 0., 4)
        dphi, df0 = y[4:], y[2:4]
        df0_ref, dphi_ref = tlf._backward_flow_scan(f, dy, g, h, tp, 1., 0., 4)
    else:
        mats = _mats(form, tp)
        planes = lfk.gradhess(phi, mats)
        dphi, df0 = lfk.uni_flow_bwd(dy, f, planes, mats, 0., 1., 4)
        dphi_ref, df0_ref = lfk.flow_bwd_plain(dy, f, planes, mats, 0., 1., 4)
    assert rel(df0.numpy(), df0_ref.numpy()) < 1e-12
    assert rel(dphi.numpy(), dphi_ref.numpy()) < 1e-12


# =========================================================================
# the slice on backend "uni"
# =========================================================================

def test_uni_backend_phi_gradient_matches_jax():
    pb = _problem("P", 32)
    with ct.lenseflow_backend_ctx("uni"):
        v, g = ct.fvalue_and_grad(
            lambda p: ct.Mixed(pb["tds"]).logpdf(f_mix=pb["tfm"], phi_mix=p))(pb["tpm"])
    assert abs(float(v) - pb["lnP"]) < 1e-6 * abs(pb["lnP"])
    assert rel(g.arr.numpy(), pb["grad"]) < 3e-4


def test_uni_backend_MAP_joint_matches_kernel_backend():
    ds = ct.load_sim(thetapix=3, Nside=32, pol="P", seed=0, device="cpu")["ds"]
    kw = dict(nsteps=2, precision=None,
              conjgrad_kwargs=dict(tol=0.0, nsteps=15, fixed_iters=True, hessian_precision=None),
              history_keys=("logpdf", "alpha"))
    hist = {}
    for be in ("kernel", "uni"):
        with ct.lenseflow_backend_ctx(be):
            hist[be] = ct.MAP_joint(ds, **kw)["history"]
    lk, lu = (np.array([h["logpdf"] for h in hist[be]]) for be in ("kernel", "uni"))
    assert [h["alpha"] for h in hist["uni"]] == [h["alpha"] for h in hist["kernel"]]
    assert hist["uni"][0]["alpha"] > 0
    assert rel(lu, lk) < 1e-6


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="unknown LenseFlow backend"):
        ct.set_lenseflow_backend("fa")


# =========================================================================
# the entry points' device
# =========================================================================

def test_entry_points_default_to_the_card(monkeypatch):
    """With a card and no `device`, ProjLambert and load_sim's generator
    are on CUDA (here the card is only announced: nothing is allocated
    before the first tensor)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ct.ProjLambert(16, 16, thetapix=3).device == torch.device("cuda")
    seen = []

    def generator(device=None):
        seen.append(torch.device(device))
        raise RuntimeError("stop before the card is touched")

    monkeypatch.setattr(torch, "Generator", generator)
    with pytest.raises(RuntimeError, match="stop before"):
        ct.load_sim(thetapix=3, Nside=16, pol="P", seed=0)
    assert seen == [torch.device("cuda")]


@pytest.mark.parametrize("entry", ["ProjLambert", "load_sim", "dataset_from_numpy"])
def test_entry_points_raise_without_a_card_or_device(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"ProjLambert": lambda: ct.ProjLambert(16, 16, thetapix=3),
            "load_sim": lambda: ct.load_sim(thetapix=3, Nside=16, pol="P", seed=0),
            "dataset_from_numpy": lambda: ct.dataset_from_numpy(
                {}, dict(Ny=16, Nx=16, thetapix=3, T=np.float32))}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert ct.ProjLambert(16, 16, thetapix=3, device="cpu").device == torch.device("cpu")


def test_uni_kernel_wrapper_refuses_what_it_has_no_kernel_for():
    """The K5 wrapper takes dense or factored operands, at every tier, on
    one CUDA device: on a CPU tensor it refuses either form, where the
    dense form's refusal used to name the ROADMAP item; the uni flows on
    dense operands run on the CPU at each tier (K5's plain version), and
    refuse a device with no kernel. On the card it takes every built
    radix, 16 and 32 in channel groups
    (tests/test_torch_cuda.py::test_uni_kernel_roles_at_radix_16_and_32_match_plain_on_card)."""
    x = torch.zeros((1, 1, 16, 16))
    out = torch.empty((1, 1, 4, 16, 16))
    tp = ct.ProjLambert(16, 16, thetapix=3, device="cpu")
    ops = tfd.factored_ops(tp, 2, 2)
    for mats in (tderiv.deriv_mats(tp), ops):
        for p in lfk.PRECISIONS:
            with pytest.raises(ValueError, match="CUDA device"):
                lfk.uni_velocity_cuda(2, x, x, x, x, out, mats, 0.5, p)
    phi, f, _ = _weak_lensing(N=16)
    planes = lfk.gradhess(torch.as_tensor(phi), tderiv.deriv_mats(tp))
    for p in lfk.PRECISIONS:
        fp = lfk.uni_flow_apply(torch.as_tensor(f), planes, tderiv.deriv_mats(tp), 0., 1., 1,
                                precision=p)
        assert fp.shape == f.shape and torch.isfinite(fp).all()
    meta = torch.empty((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no LenseFlow kernel"):
        lfk.uni_flow_apply(meta, torch.empty((5, 16, 16), device="meta"), ops, 0., 1., 1)
