"""The port's Wiener filter, CG, grid line search and MAP_joint against
the JAX package: a JAX `load_sim` at 32^2 P carried across as numpy
arrays (`dataset_from_numpy`), both at strict float32 (precision=None,
hessian_precision=None on both sides; the "auto" defaults are held to
the JAX package in tests/test_torch_high.py).

Tolerances, relative max-abs:
- CG solutions 1e-5 (measured 1.7e-7) and equal iteration counts: the
  residual falls ~60x per iteration here, and each tol sits inside one
  such step, far from where f32 round-off could move the stopping
  iteration.
- the line search's alphas 1e-6 (the same float32 grid) and dlps 1e-4
  of their range: Delta logpdfs of ~1-10 out of a ~2e4 logpdf.
- the MAP_joint logpdf history 1e-4 (measured 1e-7), alphas 1e-4.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.field import Field as JField
from cmblensing_tpu.core.ops import Diag as JDiag, Id as JId
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.models.dataset import load_sim as j_load_sim
from cmblensing_tpu.ops.solvers import conjugate_gradient as j_cg

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.models.dataset import DIAG_OPS
from cmblensing_tpu_torch.utils import timing

N = 32
CG_STRICT = dict(tol=0.0, nsteps=15, fixed_iters=True)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _carry(jfield, proj):
    return ct.Field(torch.as_tensor(np.array(jfield.arr)),
                    ct.Basis(jfield.basis.pol, jfield.basis.space), proj)


@pytest.fixture(scope="module")
def P32():
    out = j_load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0)
    jds = out["ds"]
    ds0 = jds.at({})
    arrays = {"d": (np.array(jds.d.arr), jds.d.basis.pol, jds.d.basis.space)}
    for name in DIAG_OPS:
        op = getattr(ds0, name)
        arrays[name] = (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    tds = ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=3, T=np.float32), device="cpu")
    jphi = out["phi"].to(out["phi"].basis.with_space("map"))
    jf = out["f"].to(out["f"].basis.with_space("map"))
    proj = tds.d.proj
    return dict(jds=jds, tds=tds, jphi=jphi, jf=jf, tphi=_carry(jphi, proj),
                tf=_carry(jf, proj), proj=proj)


@pytest.mark.parametrize("tol", [1e-2, 1e-4])
def test_argmaxf_logpdf_matches_jax(P32, tol):
    kw = dict(tol=tol, nsteps=200, record_history=True, hessian_precision=None)
    jf, jinfo = jm.argmaxf_logpdf(P32["jds"], phi=P32["jphi"], conjgrad_kwargs=kw)
    tf, tinfo = ct.argmaxf_logpdf(P32["tds"], phi=P32["tphi"], conjgrad_kwargs=kw)
    assert tinfo["iterations"] == int(jinfo["iterations"])
    out = tf.to(ct.Basis(jf.basis.pol, jf.basis.space)).arr.numpy()
    assert rel(out, np.array(jf.arr)) < 1e-5
    jh, th = np.array(jinfo["res_history"]), tinfo["res_history"].numpy()
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    n = tinfo["iterations"] + 1
    assert rel(th[:n], jh[:n]) < 1e-5


def test_conjugate_gradient_matches_jax_per_batch():
    """CG on a Fourier-diagonal system with a batch of two right-hand
    sides, per-batch residuals and best-iterate tracking."""
    rng = np.random.default_rng(0)
    tp = ct.ProjLambert(16, 16, thetapix=3, T=np.float32, device="cpu")
    from cmblensing_tpu.core.proj import ProjLambert as JProj
    jp = JProj(16, 16, thetapix=3, T=np.float32)
    A = (1.0 + rng.random((1, 16, 9)) * 10).astype(np.float32)
    Mw = (A * (1 + 0.5 * rng.random(A.shape))).astype(np.float32)
    b = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    jop = lambda a: JDiag(JField(jnp.asarray(a), JBasis("I", "fourier"), jp))
    top = lambda a: ct.Diag(ct.Field(torch.as_tensor(a), ct.Basis("I", "fourier"), tp))
    jb = JField(jnp.asarray(b), JBasis("I", "map"), jp).to(JBasis("I", "fourier"))
    tb = ct.Field(torch.as_tensor(b), ct.MAP, tp).to(ct.FOURIER)
    jx, jinfo = j_cg(jop(Mw), jop(A), jb, nsteps=50, tol=1e-6, record_history=True)
    tx, tinfo = ct.conjugate_gradient(top(Mw), top(A), tb, nsteps=50, tol=1e-6,
                                      record_history=True)
    assert tinfo["iterations"] == int(jinfo["iterations"]) > 2
    assert tinfo["res"].shape == (2,)
    assert rel(tx.to(ct.Basis("I", jx.basis.space)).arr.numpy(), np.array(jx.arr)) < 1e-5
    assert rel(tinfo["res0"].numpy(), np.array(jinfo["res0"])) < 1e-5


def test_grid_linesearch_matches_jax(P32):
    """(alphas, dlps) of one line search from the same (f°, phi°, dphi);
    trial 0 is alpha = 0 with dlp exactly 0."""
    dsj = P32["jds"].at({}).replace(G=JId)
    f_mix, phi_mix, g = jm._jit_phi_grad_and_fmix(dsj, {}, P32["jf"], 0.5 * P32["jphi"], None)
    dphi = jm.hessian_phimix_preconditioner(dsj).pinv() @ g
    ja, jd = jm._jit_grid_linesearch_dlps(dsj, {}, f_mix, phi_mix, dphi, jnp.float32(2.0), 16,
                                          None, 16)
    proj = P32["proj"]
    dst = P32["tds"].at({}).replace(G=ct.Id)
    ta, td = tm._grid_linesearch_dlps(dst, {}, _carry(f_mix, proj), _carry(phi_mix, proj),
                                      _carry(dphi, proj), 2.0, 16)
    ja, jd = np.array(ja), np.array(jd)
    assert ta.shape == td.shape == (17,)
    assert float(td[0]) == 0.0 and float(jd[0]) == 0.0
    assert rel(ta.numpy(), ja) < 1e-6
    assert np.max(np.abs(td.numpy() - jd)) < 1e-4 * np.ptp(jd)
    assert int(np.argmax(td.numpy())) == int(np.argmax(jd))


def test_MAP_joint_matches_jax(P32):
    keys = ("logpdf", "alpha", "cg_iters", "cg_res", "gradnorm")
    kw = dict(nsteps=3, precision=None, conjgrad_kwargs=CG_STRICT, history_keys=keys)
    jr = jm.MAP_joint(P32["jds"], **kw)
    timing.reset_timers()
    tr = ct.MAP_joint(P32["tds"], **kw)
    jl = np.array([h["logpdf"] for h in jr["history"]])
    tl = np.array([h["logpdf"] for h in tr["history"]])
    # totals of ~2e4 agree to 9e-8 relative, one float32 ulp (0.002); the
    # per-step gains (6 and 0.7 nats) to within a few ulps of the totals
    assert rel(tl, jl) < 1e-6
    ulp = float(np.spacing(np.float32(np.max(np.abs(jl)))))
    assert np.max(np.abs(np.diff(tl) - np.diff(jl))) < 4 * ulp
    assert np.all(np.diff(tl) >= 0)
    ja = np.array([h["alpha"] for h in jr["history"]], np.float64)
    talpha = np.array([h["alpha"] for h in tr["history"]])
    assert talpha[0] > 0 and rel(talpha, ja) < 1e-4
    assert [h["cg_iters"] for h in tr["history"]] == [15] * 3
    assert all(np.isfinite(h["gradnorm"]) and np.isfinite(h["cg_res"]) for h in tr["history"])
    assert tr["phi"].basis == ct.MAP and tr["phi"].arr.shape == (1, N, N)
    assert "MAP_joint/f_step" in timing.timer_report()


@pytest.mark.parametrize("kw,backend", [(dict(precision="bf16"), "uni"),
                                        (dict(linesearch="brent"), "kernel"),
                                        (dict(quasi_sample=True), "kernel"),
                                        (dict(nburnin_update_hessian=1), "kernel"),
                                        (dict(precision="auto"), "uni"),
                                        (dict(precision="high"), "uni")])
def test_MAP_joint_refuses_what_is_not_ported(P32, kw, backend):
    """Every one of these options runs now: one step, a finite logpdf.
    Brent, quasi-samples and the Hessian update raised NotImplementedError
    until they were ported (tests/test_torch_map_options.py holds them to
    the JAX package); 'bf16', "auto" and 'high' on the "uni" backend raised
    while K5 had no 'high' and 'bf16' tiers (tests/test_torch_uni_tiers.py
    holds them to the kernel backend). The test keeps its name."""
    run = lambda: ct.MAP_joint(P32["tds"], nsteps=1, conjgrad_kwargs=dict(
        tol=0.0, nsteps=1, fixed_iters=True), **kw)
    with ct.lenseflow_backend_ctx(backend):
        assert np.isfinite(run()["history"][-1]["logpdf"])


def test_unported_batched_and_reduced_precision_paths_raise(P32):
    tds = P32["tds"]
    d = tds.d
    batched = tds.replace(d=ct.Field(torch.stack([d.arr, d.arr]), d.basis, d.proj))
    # batched MAP_joint runs (tests/test_torch_ensemble.py holds it to JAX's):
    # one step, each entry its unbatched run (the same alpha on the float32
    # grid, phi to float32 round-off: the batched FFTs sum in other orders)
    kw = dict(nsteps=1, precision=None, history_keys=("alpha",),
              conjgrad_kwargs=dict(tol=0.0, nsteps=2, fixed_iters=True))
    rb, r1 = ct.MAP_joint(batched, **kw), ct.MAP_joint(tds, **kw)
    assert rb["phi"].batch_shape == (2,)
    for i in range(2):
        assert abs(float(rb["history"][0]["alpha"][i]) - r1["history"][0]["alpha"]) < 1e-6
        assert rel(rb["phi"].arr[i].numpy(), r1["phi"].arr.numpy()) < 1e-5
    # the batched f-step runs (tests/test_torch_batch.py holds it to JAX's):
    # both entries the unbatched solve
    cg = dict(tol=0.0, nsteps=2, fixed_iters=True, hessian_precision=None)
    fb, _ = ct.argmaxf_logpdf(batched, phi=P32["tphi"], conjgrad_kwargs=cg)
    f1, _ = ct.argmaxf_logpdf(tds, phi=P32["tphi"], conjgrad_kwargs=cg)
    assert fb.batch_shape == (2,)
    for i in range(2):
        assert rel(ct.batch_index(fb, i).arr.numpy(), f1.arr.numpy()) < 1e-5
    # the 'bf16' tier runs (tests/test_torch_bf16.py holds it to JAX's)
    f, info = ct.argmaxf_logpdf(tds, phi=P32["tphi"], conjgrad_kwargs=dict(
        hessian_precision="bf16", tol=0.0, nsteps=2, fixed_iters=True))
    assert torch.isfinite(f.arr).all() and "precision_fallback" in info


def test_MAP_joint_progress_prints_a_line_per_step(P32, capsys, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_tqdm(name, *a, **k):
        if name == "tqdm":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    ct.MAP_joint(P32["tds"], nsteps=2, progress=True,
                 conjgrad_kwargs=dict(tol=0.0, nsteps=2, fixed_iters=True))
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("MAP_joint")]
    assert len(lines) == 2 and "logpdf=" in lines[0] and "CG=2" in lines[0]


def test_MAP_joint_alpha_max_and_gradtol(P32):
    """alpha_max fixes the grid's upper end; a step after minsteps that
    moves phi° by less than gradtol ends the iteration."""
    r = ct.MAP_joint(P32["tds"], nsteps=4, minsteps=1, gradtol=1e30, alpha_max=0.5,
                     conjgrad_kwargs=dict(tol=0.0, nsteps=3, fixed_iters=True),
                     history_keys=("alpha",))
    assert len(r["history"]) == 2
    assert all(0 < h["alpha"] <= 0.5 for h in r["history"])
