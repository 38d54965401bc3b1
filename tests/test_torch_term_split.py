"""The term-split phi-gradient and the bfloat16 backward-flow state, held
to the JAX package on the same numpy inputs.

- `_term_split_fgrad` (inference/maximization.py): the phi-gradients of
  MAP_marg and MAP_joint taken one logpdf term at a time above
  TERM_SPLIT_MIN_N (patched to the test's 32 here) against the whole
  gradient, the port's and JAX's (`_jit_phi_gradient`,
  `_jit_phi_grad_and_fmix` with `_REMAT_MIN_N` patched to 1): SPLIT_TOL
  1e-5 relative L2 (two sums of the same float32 terms; the JAX test
  tests/test_posterior.py holds its own split at 1e-4), JAX_TOL 1e-4
  against JAX (the two packages' flows and FFTs, tests/test_torch_slice.py's
  gradient bound); the terms sum to the logpdf.
- CMBL_BWD_STATE_DTYPE=bf16 on the plain backend's backward flow
  (models/lenseflow.py::_backward_flow_scan) against JAX's scan with the
  same setting: delta f and delta phi BF16_STATE_JAX_TOL 1e-3 (the same
  bf16 roundings of states that differ by float32 rounding, ~2^-9 of a
  value where one rounds the other way); and the parity test the JAX
  package lacks: the bf16-state gradient against the float32-state one,
  within BF16_STATE_TOL 2e-2 relative L2 (each of the 4 nsteps RK4 stage
  inputs rounded to 2^-9 relative), and farther than 1e-6 (the setting
  acts).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.field import Field as JField
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.models import lenseflow as jlf
from cmblensing_tpu.models.dataset import load_sim as j_load_sim
from cmblensing_tpu.ops import deriv as jderiv

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.models import lenseflow as tlf

N = 32
SPLIT_TOL, JAX_TOL = 1e-5, 1e-4
BF16_STATE_JAX_TOL, BF16_STATE_TOL = 1e-3, 2e-2


def l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def sims():
    """JAX's 32^2 P simulation and the port's dataset with JAX's data."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = j_load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0)
    jds = out["ds"]
    QU, I = JBasis("QU", "map"), JBasis("I", "map")
    d, f, phi = (np.asarray(x.to(b).arr) for x, b in ((jds.d, QU), (out["f"], QU),
                                                        (out["phi"], I)))
    tds = ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0, device="cpu")["ds"]
    tp = tds.d.proj
    tds = tds.replace(d=ct.Field(torch.as_tensor(np.array(d)), ct.QU_MAP, tp))
    yield dict(jds=jds, tds=tds, d=d, f=f, phi=phi, tp=tp, jp=jds.d.proj)
    torch.set_num_threads(threads)


def _port_grads(s):
    tds, tp = s["tds"].at({}).replace(G=ct.Id), s["tp"]
    f = ct.Field(torch.as_tensor(s["f"]), ct.QU_MAP, tp)
    phi = ct.Field(torch.as_tensor(0.5 * s["phi"]), ct.MAP, tp)
    g = tm._phi_gradient(tds, {}, phi, f, tds.d).arr.numpy()
    gm = tm._phi_grad_and_fmix(tds, {}, f, phi)[2].arr.numpy()
    return g, gm


def test_term_split_gradients_match_whole_and_jax(sims, monkeypatch):
    whole = _port_grads(sims)
    monkeypatch.setattr(tm, "TERM_SPLIT_MIN_N", N)
    split = _port_grads(sims)
    from cmblensing_tpu.core.ops import Id as JId
    jds = sims["jds"].at(None).replace(G=JId)
    jp = sims["jp"]
    f = JField(jnp.asarray(sims["f"]), JBasis("QU", "map"), jp)
    phi = JField(jnp.asarray(0.5 * sims["phi"]), JBasis("I", "map"), jp)
    monkeypatch.setattr(jm, "_REMAT_MIN_N", 1)
    jm._jit_phi_gradient.clear_cache()
    jm._jit_phi_grad_and_fmix.clear_cache()
    try:
        with jderiv.mode_ctx("fft"):
            jg = np.asarray(jm._jit_phi_gradient(jds, None, phi, f, jds.d, None).arr)
            jgm = np.asarray(jm._jit_phi_grad_and_fmix(jds, None, f, phi, None)[2].arr)
    finally:
        jm._jit_phi_gradient.clear_cache()
        jm._jit_phi_grad_and_fmix.clear_cache()
    for s, w, j in zip(split, whole, (jg, jgm)):
        assert l2(s, w) < SPLIT_TOL
        assert l2(s, j) < JAX_TOL


def test_mixed_logpdf_terms_sum_to_the_logpdf(sims):
    tds, tp = sims["tds"], sims["tp"]
    f = ct.Field(torch.as_tensor(sims["f"]), ct.QU_MAP, tp)
    phi = ct.Field(torch.as_tensor(sims["phi"]), ct.MAP, tp)
    m = ct.mix(tds, f=f, phi=phi)
    mixed = ct.Mixed(tds)
    lp = float(mixed.logpdf(f_mix=m["f_mix"], phi_mix=m["phi_mix"]))
    terms = sum(float(mixed.logpdf_term(f_mix=m["f_mix"], phi_mix=m["phi_mix"], which=w))
                for w in tm.TERMS)
    assert abs(lp - terms) < 1e-6 * abs(lp)


def _backward(s, bf16, monkeypatch):
    """(df0, dphi) of the plain backend's backward flow (nsteps 4) and of
    JAX's scan, with CMBL_BWD_STATE_DTYPE set or not."""
    if bf16:
        monkeypatch.setenv("CMBL_BWD_STATE_DTYPE", "bf16")
    else:
        monkeypatch.delenv("CMBL_BWD_STATE_DTYPE", raising=False)
    tp, jp = s["tp"], s["jp"]
    phi, f = s["phi"], s["f"]
    dy = np.roll(f, 5, -1)
    g, h = tlf._gradhess_phi(torch.as_tensor(phi), tp)
    df0, dphi = tlf._backward_flow_scan(torch.as_tensor(f), torch.as_tensor(dy), g, h, tp, 1.0,
                                        0.0, 4)
    with jderiv.mode_ctx("fft"):
        jg, jh = jlf._gradhess_phi(jnp.asarray(phi), jp)
        jdf0, jdphi = jax.jit(lambda a, b: jlf._backward_flow_scan(a, b, jg, jh, jp, 1.0, 0.0,
                                                                   4))(jnp.asarray(f),
                                                                       jnp.asarray(dy))
    return (df0.numpy(), dphi.numpy()), (np.asarray(jdf0), np.asarray(jdphi))


def test_bf16_backward_state_matches_jax_and_stays_near_float32(sims, monkeypatch):
    (df0, dphi), (jdf0, jdphi) = _backward(sims, True, monkeypatch)
    (df0_32, dphi_32), _ = _backward(sims, False, monkeypatch)
    assert l2(df0, jdf0) < BF16_STATE_JAX_TOL and l2(dphi, jdphi) < BF16_STATE_JAX_TOL
    for a, b in ((df0, df0_32), (dphi, dphi_32)):
        assert 1e-6 < l2(a, b) < BF16_STATE_TOL
