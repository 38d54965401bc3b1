"""Batched Fields, batched datasets and the batched f-step of the port
against the JAX package on the same numpy inputs.

Inputs are made once, with numpy or by the JAX package, and handed to
both packages. Tolerances, relative max-abs, each with its reason:
- the Field helpers and constructors move or stack the same float32
  values: exact (0); the operators and sum_field are float32 arithmetic
  in one order on both sides: 1e-6 (sum_field sums 32^2 values: 1e-5).
- the batched CG f-step at 32^2 P: the f-steps of tests/test_torch_map.py
  (1e-5; CG runs the same float32 algebra per entry), each entry against
  its own unbatched solve 1e-5 (the flows batch entries on one grid, whose
  sums run in the same order; measured at float32 round-off); CG's final
  residual 1e-4 (RES_TOL, below).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import field as JF
from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.models.dataset import load_sim as j_load_sim

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core import ops as tops
from cmblensing_tpu_torch.models.dataset import DIAG_OPS

N = 32
CG = dict(tol=0.0, nsteps=4, fixed_iters=True)
STRICT = dict(CG, hessian_precision=None)
FSTEP_TOL = 1e-5
# CG's residual after 4 iterations, b - H x, has fallen ~300x below res0
# by cancellation, so its float32 round-off is that much larger relative
# (measured 1.2e-5)
RES_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for the module (its tensors of 16^2-32^2 are too
    small to share among threads, which only contend with a parallel
    run's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _projs(n=16):
    return (JProj(n, n, thetapix=3, T=np.float32),
            ct.ProjLambert(n, n, thetapix=3, T=np.float32, device="cpu"))


def _pair(arr, pol, jp, tp, space="map"):
    return (JF.Field(jnp.asarray(arr), JBasis(pol, space), jp),
            ct.Field(torch.as_tensor(arr), ct.Basis(pol, space), tp))


def _np(f):
    return np.asarray(f.arr)


# =========================================================================
# Field batching, constructors and operators
# =========================================================================

@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    jp, tp = _projs()
    arrs = [rng.standard_normal((2, 16, 16)).astype(np.float32) for _ in range(3)]
    return jp, tp, arrs


def test_batch_unbatch_and_index_match_jax(fields):
    jp, tp, arrs = fields
    jfs, tfs = zip(*(_pair(a, "QU", jp, tp) for a in arrs))
    jb, tb = JF.batch(jfs), ct.batch(tfs)
    assert tb.batch_shape == jb.batch_shape == (3,) and tb.Nbatch == jb.Nbatch == 3
    np.testing.assert_array_equal(tb.arr.numpy(), _np(jb))
    for i, (ju, tu) in enumerate(zip(JF.unbatch(jb), ct.unbatch(tb))):
        assert tu.batch_shape == () and tu.basis == ct.QU_MAP
        np.testing.assert_array_equal(tu.arr.numpy(), _np(ju))
        np.testing.assert_array_equal(ct.batch_index(tb, i).arr.numpy(),
                                      _np(JF.batch_index(jb, i)))
    assert ct.batch_length(tb) == JF.batch_length(jb) == 3
    assert ct.batch_length(tfs[0]) == JF.batch_length(jfs[0]) == 1
    assert ct.batch_length(torch.zeros(4)) == JF.batch_length(np.zeros(4)) == 4
    assert ct.unbatch(tfs[0])[0] is tfs[0] and ct.batch(tb) is tb
    with pytest.raises(ValueError, match="not batched"):
        ct.batch_index(tfs[0], 0)
    # batch takes the first field's basis
    mixed = ct.batch([tfs[0], tfs[1].to(ct.EB_FOURIER)])
    jmixed = JF.batch([jfs[0], jfs[1].to(JBasis("EB", "fourier"))])
    assert mixed.basis == ct.QU_MAP
    assert rel(mixed.arr.numpy(), _np(jmixed)) < 1e-6


def test_repeat_batch_and_batch_map_match_jax(fields):
    jp, tp, arrs = fields
    jf, tf = _pair(arrs[0], "QU", jp, tp)
    tr, jr = ct.repeat_batch(tf, 4), JF.repeat_batch(jf, 4)
    assert tr.batch_shape == (4,)
    np.testing.assert_array_equal(tr.arr.numpy(), _np(jr))
    # a copy, not a view of f
    tr.arr[0] += 1
    np.testing.assert_array_equal(tf.arr.numpy(), arrs[0])
    jb = JF.batch([_pair(a, "QU", jp, tp)[0] for a in arrs])
    tb = ct.batch([_pair(a, "QU", jp, tp)[1] for a in arrs])
    tm_ = ct.batch_map(lambda f: 2.0 * f.to(ct.EB_FOURIER), tb)
    jm_ = JF.batch_map(lambda f: 2.0 * f.to(JBasis("EB", "fourier")), jb)
    assert tm_.batch_shape == (3,) and tm_.basis == ct.EB_FOURIER
    assert rel(tm_.arr.numpy(), _np(jm_)) < 1e-6
    assert ct.batch_map(lambda f: f.ncomp, [tf, tf]) == [2, 2]


@pytest.mark.parametrize("shape,pol", [((16, 16), None), ((2, 16, 16), None),
                                       ((3, 16, 16), "IQU"), ((4, 1, 16, 16), "I")])
def test_from_maps_matches_jax(shape, pol):
    jp, tp = _projs()
    arr = np.random.default_rng(1).standard_normal(shape)   # float64: cast to proj.T
    jf, tf = JF.from_maps(arr, jp, pol=pol), ct.from_maps(arr, tp, pol=pol)
    assert tf.basis == ct.Basis(jf.basis.pol, "map") and tf.arr.dtype == torch.float32
    np.testing.assert_array_equal(tf.arr.numpy(), _np(jf))


@pytest.mark.parametrize("pol,space,bs", [("I", "map", ()), ("QU", "fourier", (2,)),
                                          ("IEB", "fourier", (3, 2))])
def test_zeros_and_randn_shapes_match_jax(pol, space, bs):
    jp, tp = _projs()
    jz, tz = JF.zeros(jp, JBasis(pol, space), bs), ct.zeros(tp, ct.Basis(pol, space), bs)
    assert tuple(tz.arr.shape) == jz.arr.shape and tz.basis == ct.Basis(pol, space)
    assert str(tz.arr.dtype).split(".")[-1] == str(jz.arr.dtype)
    assert not torch.any(tz.arr)
    g = torch.Generator().manual_seed(0)
    tr = ct.randn(g, tp, pol=pol, batch_shape=bs)
    jr = JF.randn(jax.random.PRNGKey(0), jp, pol=pol, batch_shape=bs)
    assert tuple(tr.arr.shape) == jr.arr.shape and tr.basis == ct.Basis(pol, "map")


def test_sum_field_matches_jax(fields):
    jp, tp, arrs = fields
    jb = JF.batch([_pair(a, "QU", jp, tp)[0] for a in arrs]).to(JBasis("EB", "fourier"))
    tb = ct.batch([_pair(a, "QU", jp, tp)[1] for a in arrs]).to(ct.EB_FOURIER)
    ts, js = ct.sum_field(tb), JF.sum_field(jb)
    assert ts.shape == (3,)
    assert rel(ts.numpy(), np.asarray(js)) < 1e-5


OPS = {"radd": lambda f: 2.5 + f, "rsub": lambda f: 1.5 - f, "truediv": lambda f: f / 3.0,
       "rtruediv": lambda f: 2.0 / (f * f + 1.0), "pow": lambda f: f ** 2,
       "pos": lambda f: +f, "field_truediv": lambda f: f / (f * f + 2.0),
       "batched_scalar": lambda f: f / np.array([1.0, 2.0, 4.0], dtype=np.float32)}


@pytest.mark.parametrize("op", list(OPS))
def test_field_operators_match_jax(fields, op):
    jp, tp, arrs = fields
    jb = JF.batch([_pair(a, "QU", jp, tp)[0] for a in arrs])
    tb = ct.batch([_pair(a, "QU", jp, tp)[1] for a in arrs])
    jo, to = OPS[op](jb), OPS[op](tb)
    assert to.basis == ct.Basis(jo.basis.pol, jo.basis.space)
    assert rel(to.arr.numpy(), _np(jo)) < 1e-6


def test_white_noise_and_simulate_op_take_a_batch_shape():
    """white_noise_like draws f's batch shape, or the one given; and
    simulate_op / MvNormal.sample a batch of draws of the covariance."""
    _, tp = _projs()
    f = ct.zeros(tp, ct.EB_FOURIER, (2,))
    g = torch.Generator().manual_seed(3)
    assert ct.core.field.white_noise_like(g, f).batch_shape == (2,)
    assert ct.core.field.white_noise_like(g, f, batch_shape=(5,)).batch_shape == (5,)
    C = ct.Diag(ct.Field(torch.full((2, 16, 9), 4.0), ct.EB_FOURIER, tp))
    xi = ct.simulate_op(g, C, batch_shape=(3,))
    assert xi.batch_shape == (3,) and xi.basis == ct.EB_FOURIER
    assert ct.MvNormal(0, C).sample(g, (4,)).batch_shape == (4,)
    assert ct.MvNormal(0, C).sample(g).batch_shape == ()


# =========================================================================
# batched datasets and the f-step
# =========================================================================

def test_load_sim_Nbatch_repeats_the_simulation():
    """load_sim(Nbatch=3): d is three copies of the unbatched sim's data,
    and everything else is the unbatched sim's."""
    one = ct.load_sim(thetapix=3, Nside=16, pol="P", seed=4, device="cpu")
    three = ct.load_sim(thetapix=3, Nside=16, pol="P", seed=4, device="cpu", Nbatch=3)
    assert three["d"].batch_shape == (3,) and three["ds"].d is three["d"]
    assert three["ds0"].d.batch_shape == (3,)
    for i in range(3):
        np.testing.assert_array_equal(ct.batch_index(three["d"], i).arr.numpy(),
                                      one["d"].arr.numpy())
    for k in ("f", "phi"):
        np.testing.assert_array_equal(three[k].arr.numpy(), one[k].arr.numpy())
    np.testing.assert_array_equal(three["ds0"].Nphi.diag.arr.numpy(),
                                  one["ds0"].Nphi.diag.arr.numpy())


@pytest.fixture(scope="module")
def P32b():
    """A JAX load_sim at 32^2 P carried across, with a batch of three
    distinct data (the sim's d plus white noise at two levels) and three
    distinct phi; the JAX package's batched f-steps on them, strict and
    at "auto", under fixed iterations."""
    out = j_load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0)
    jds = out["ds"]
    ds0 = jds.at({})
    rng = np.random.default_rng(7)
    d0 = np.asarray(jds.d.to(JBasis("QU", "map")).arr)
    ds_np = np.stack([d0, d0 + 0.1 * d0.std() * rng.standard_normal(d0.shape),
                      d0 + 0.3 * d0.std() * rng.standard_normal(d0.shape)]).astype(np.float32)
    phi0 = np.asarray(out["phi"].to(JBasis("I", "map")).arr)
    phis = np.stack([phi0, 0.7 * phi0, -0.5 * phi0]).astype(np.float32)
    arrays = {"d": (ds_np, "QU", "map")}
    for name in DIAG_OPS:
        op = getattr(ds0, name)
        arrays[name] = (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    tds = ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=3, T=np.float32), device="cpu")
    proj = tds.d.proj
    jds_b = jds.replace(d=JF.Field(jnp.asarray(ds_np), JBasis("QU", "map"), jds.d.proj))
    jphi = JF.Field(jnp.asarray(phis), JBasis("I", "map"), jds.d.proj)
    tphi = ct.Field(torch.as_tensor(phis), ct.MAP, proj)
    runs = {}
    for name, cg in (("strict", STRICT), ("auto", CG)):
        jf, jinfo = jm.argmaxf_logpdf(jds_b, phi=jphi, conjgrad_kwargs=dict(cg))
        runs[name] = (np.asarray(jf.to(JBasis("QU", "map")).arr), jinfo)
    return dict(jds=jds_b, tds=tds, jphi=jphi, tphi=tphi, runs=runs, ds_np=ds_np, phis=phis)


@pytest.mark.parametrize("which", ["strict", "auto"])
def test_batched_argmaxf_matches_jax(P32b, which):
    """A batch of three distinct d and phi, strict and at the default
    "auto" under fixed iterations: at tol 0 the 'high' solve misses its
    strict check in both packages and the whole batch re-runs strict."""
    jf, jinfo = P32b["runs"][which]
    cg = STRICT if which == "strict" else CG
    tf, tinfo = ct.argmaxf_logpdf(P32b["tds"], phi=P32b["tphi"], conjgrad_kwargs=dict(cg))
    assert tf.batch_shape == (3,)
    assert tinfo["res"].shape == (3,) and tinfo["iterations"] == int(jinfo["iterations"])
    fallback = which == "auto"
    assert bool(tinfo.get("precision_fallback", False)) is fallback
    assert bool(jinfo.get("precision_fallback", False)) is fallback
    assert rel(tf.to(ct.QU_MAP).arr.numpy(), jf) < FSTEP_TOL
    assert rel(tinfo["res0"].numpy(), np.asarray(jinfo["res0"])) < FSTEP_TOL
    assert rel(tinfo["res"].numpy(), np.asarray(jinfo["res"])) < RES_TOL


def test_batched_argmaxf_entries_match_their_solo_solves(P32b):
    tds, tphi = P32b["tds"], P32b["tphi"]
    tf, _ = ct.argmaxf_logpdf(tds, phi=tphi, conjgrad_kwargs=dict(STRICT))
    for i in range(3):
        di = ct.batch_index(tds.d, i)
        fi, _ = ct.argmaxf_logpdf(tds.replace(d=di), phi=ct.batch_index(tphi, i),
                                  conjgrad_kwargs=dict(STRICT))
        assert fi.batch_shape == ()
        assert rel(ct.batch_index(tf, i).to(ct.QU_MAP).arr.numpy(),
                   fi.to(ct.QU_MAP).arr.numpy()) < FSTEP_TOL


def test_batched_precision_verdict_covers_every_entry(P32b):
    """precision_ok is one verdict, True only where every entry's strict
    residual meets max(tol, 1e-10 res0): at tol 1e-4 (adaptive) every entry
    passes; with one entry's bound made unreachable the batch re-runs
    strict."""
    tds, tphi = P32b["tds"], P32b["tphi"]
    cg = dict(tol=1e-4, nsteps=200, hessian_precision="high")
    _, info = ct.argmaxf_logpdf(tds, phi=tphi, conjgrad_kwargs=dict(cg))
    assert info["res_strict"].shape == (3,) and info["precision_ok"].shape == ()
    bound = torch.clamp(1e-10 * info["res0"], min=cg["tol"])
    assert bool(info["precision_ok"]) == bool(torch.all(info["res_strict"] <= bound)) is True
    assert "precision_fallback" not in info
    from cmblensing_tpu_torch.inference import maximization as tm
    core = tm._argmaxf_core
    calls = []

    def one_entry_misses(*a, **kw):
        x, inf = core(*a, **kw)
        calls.append(a[6])
        if a[6]:   # the reduced-precision solve: entry 1 misses its bound
            inf["res_strict"] = inf["res_strict"].clone()
            inf["res_strict"][1] = 1.0
            inf["precision_ok"] = torch.all(inf["res_strict"] <= bound)
        return x, inf

    import unittest.mock as um
    with um.patch.object(tm, "_argmaxf_core", one_entry_misses):
        _, info2 = ct.argmaxf_logpdf(tds, phi=tphi, conjgrad_kwargs=dict(cg))
    assert calls == ["high", None] and info2["precision_fallback"] is True


def test_sample_f_matches_jax_with_its_draws(P32b, monkeypatch):
    """sample_f on the batch with JAX's simulation draws handed in: JAX's
    ds.simulate(key) draws f from split(key, 3)[0] and the noise from
    [2]; the port's white noise is replaced by those arrays, in that
    order."""
    jds, key = P32b["jds"], jax.random.PRNGKey(5)
    jf, _ = jm.sample_f(key, jds, phi=P32b["jphi"], conjgrad_kwargs=dict(STRICT))
    k1, _, k3 = jax.random.split(key, 3)
    shape = (3, 2, N, N)
    draws = [np.asarray(jax.random.normal(k, shape, dtype=jnp.float32)) for k in (k1, k3)]

    def handed_in(generator, f, batch_shape=None):
        arr = draws.pop(0)
        bs = f.batch_shape if batch_shape is None else tuple(batch_shape)
        assert arr.shape == bs + (f.basis.ncomp, N, N)
        return ct.Field(torch.as_tensor(np.array(arr)), f.basis.with_space("map"), f.proj)

    monkeypatch.setattr(tops, "white_noise_like", handed_in)
    tf, _ = ct.sample_f(torch.Generator(), P32b["tds"], phi=P32b["tphi"],
                        conjgrad_kwargs=dict(STRICT))
    assert not draws and tf.batch_shape == (3,)
    assert rel(tf.to(ct.QU_MAP).arr.numpy(), np.asarray(jf.to(JBasis("QU", "map")).arr)) \
        < FSTEP_TOL
