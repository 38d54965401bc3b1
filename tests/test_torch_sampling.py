"""The port's Gibbs/HMC sampler, chains and checkpoints against the JAX
package on the same inputs and the same draws.

One JAX Gibbs step at 32^2 P over 2 chains (CG f-step, mix, HMC on phi°
with N = 3, a slice pass over Aphi, unmix, logpdf) runs once, pass by
pass, from a state both packages take (`state_from_numpy`), and its
intermediate states are shared by the cases. The draws are JAX's own:
the cases rebuild its key chain (jax.random.split as the JAX passes split
their keys) and hand each draw to the port where the port makes it, by
replacing core/ops.py's white noise and sampling.py's uniform draws.

Tolerances, relative max-abs unless said, each with its reason:
- f after the strict CG f-step (5 fixed iterations) 1e-5, the f-steps of
  tests/test_torch_map.py; f° and phi° of mix / unmix 1e-5 (one flow each,
  tests/test_torch_slice.py's flows).
- phi° after 3 leapfrog steps of eps 0.003: the step moves phi° by
  eps^2 Lambda^-1 grad, and the phi-gradient agrees to 3e-4 at 64^2 P
  (tests/test_torch_slice.py), so 1e-5 of phi° (measured below 1e-6).
- dH, the change of a ~2e4 Hamiltonian, in absolute units: a few float32
  ulps of 2e4 (2e-3 each) on either side, 2e-2.
- the logpdf 1e-5; theta drawn on the grid 1e-3 absolute (a slice draw
  interpolates the CDF of exp(logpdf) smoothed: logpdfs a few ulps apart
  move it by that much of a grid step at most; measured 4.1e-4).
- the whole step from one state: what follows the theta draw inherits
  its difference (WHOLE_STEP_TOL, below).
- grid_and_sample, the chains' statistics and the KDE: the same numpy
  code on the same float64 values, 1e-12.
"""
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import field as JF
from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.ops import Diag as JDiag
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.inference import chains as jchains
from cmblensing_tpu.inference import sampling as js
from cmblensing_tpu.models.dataset import load_sim as j_load_sim
from cmblensing_tpu import native as jnative

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch import native as tnative
from cmblensing_tpu_torch.core import ops as tops
from cmblensing_tpu_torch.inference import chains as tchains
from cmblensing_tpu_torch.inference import sampling as ts
from cmblensing_tpu_torch.models import dataset as tdsm

N = 32
NB = 2
CGK = dict(tol=0.0, nsteps=5, fixed_iters=True)
SYMP = [dict(N=3, eps=0.003)]
XS = np.linspace(0.6, 1.6, 9)
KEY = 11
FIELD_TOL = 1e-5
DH_ATOL = 2e-2
THETA_ATOL = 1e-3
NUMPY_TOL = 1e-12
# the whole step: the slice pass's Aphi draws differ by up to THETA_ATOL,
# and unmix's phi = G(Aphi)^-1 phi° follows them with d ln G / d ln Aphi
# <= 1/2: phi 5e-4 (measured 7.3e-5); f = D^-1 L(phi)^-1 f° 1e-4 through
# that phi (measured 5.2e-6); the logpdf's Aphi-slope, about half the
# number of phi modes (~500 here) over Aphi, times THETA_ATOL, out of
# ~2e4: 5e-5 (measured 1.1e-5)
WHOLE_STEP_TOL = {"phi": 5e-4, "f": 1e-4, "logpdf": 5e-5}


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


def _np_in(f, pol, space="map"):
    """A Field of either package as a numpy array in basis (pol, space)."""
    if isinstance(f, ct.Field):
        return f.to(ct.Basis(pol, space)).arr.detach().numpy()
    return np.asarray(f.to(JBasis(pol, space)).arr)


# =========================================================================
# the JAX Gibbs step, pass by pass, and its key chain
# =========================================================================

def _jax_draws(key, shape_f, shape_phi):
    """The draws JAX's default passes make from the state's key, in the
    order the port makes them: (normals, uniforms) of each pass."""
    key, sub = jax.random.split(key)                      # gibbs_sample_f
    k1, _, k3 = jax.random.split(sub, 3)                  # ds.simulate: f, phi, noise
    f_draws = [np.asarray(jax.random.normal(k, shape_f, dtype=jnp.float32)) for k in (k1, k3)]
    key, sub = jax.random.split(key)                      # gibbs_sample_phi
    sub, k = jax.random.split(sub)
    kp, ku = jax.random.split(k)                          # hmc_step: momentum, accept
    phi_draws = ([np.asarray(jax.random.normal(kp, shape_phi, dtype=jnp.float32))],
                 [np.asarray(jax.random.uniform(ku, (shape_phi[0],)))])
    key, sub = jax.random.split(key)                      # slice pass over Aphi
    th = []
    for _ in range(shape_phi[0]):                         # grid_and_sample, per entry
        sub, s = jax.random.split(sub)
        th.append(np.asarray(jax.random.uniform(s, (1,))))
    return dict(f=(f_draws, []), phi=phi_draws, theta=([], th))


def _hand_in(monkeypatch, normals, uniforms):
    """Replace the port's white noise and uniform draws by these arrays,
    taken in order."""
    normals, uniforms = list(normals), list(uniforms)

    def white(generator, f, batch_shape=None):
        arr = normals.pop(0)
        bs = f.batch_shape if batch_shape is None else tuple(batch_shape)
        assert arr.shape == bs + (f.basis.ncomp, f.proj.Ny, f.proj.Nx)
        return ct.Field(torch.as_tensor(np.array(arr)), f.basis.with_space("map"), f.proj)

    def uniform(generator, shape):
        arr = uniforms.pop(0)
        assert arr.shape == tuple(shape)
        return torch.as_tensor(np.array(arr))

    monkeypatch.setattr(tops, "white_noise_like", white)
    monkeypatch.setattr(ts, "_uniform", uniform)
    return normals, uniforms


def _port_dataset(jds, d_np):
    """The JAX dataset carried across: its operators at theta = {}, and
    Cphi and G rebuilt as functions of Aphi by the port's own recipes
    (models/dataset.py, as load_sim builds them)."""
    ds0 = jds.at({})
    arrays = {"d": (d_np, "QU", "map")}
    for name in tdsm.DIAG_OPS:
        op = getattr(ds0, name)
        arrays[name] = (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    tds = ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=3, T=np.float32), device="cpu")
    Cphi = ct.ParamDependentOp(("Aphi",), tdsm._cphi_recompute, (tds.Cphi, 1.0))
    G0 = tdsm._G_of(tds.Cphi, tds.Nphi)
    G = ct.ParamDependentOp(("Aphi",), tdsm._g_recompute, (G0, Cphi, tds.Nphi, 1.0))
    return tds.replace(Cphi=Cphi, G=G)


@pytest.fixture(scope="module")
def gibbs():
    out = j_load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0)
    jds = out["ds"]
    rng = np.random.default_rng(7)
    d0 = _np_in(jds.d, "QU")
    d_np = np.stack([d0, d0 + 0.2 * d0.std() * rng.standard_normal(d0.shape)]).astype(np.float32)
    phi0 = _np_in(out["phi"], "I")
    # no f: the f-step's CG starts from 0, as sample_joint's first step does
    start = {"phi": (np.stack([0.8 * phi0, 0.5 * phi0]).astype(np.float32), "I", "map"),
             "theta": {"Aphi": np.array([1.0, 1.2])}, "step": 1}
    jp = jds.d.proj
    jds_b = jds.replace(d=JF.Field(jnp.asarray(d_np), JBasis("QU", "map"), jp))
    s0 = dict(key=jax.random.PRNGKey(KEY), step=1, theta={"Aphi": jnp.asarray([1.0, 1.2])},
              phi=JF.Field(jnp.asarray(start["phi"][0]), JBasis("I", "map"), jp))
    states = [s0]
    for p in (lambda s: js.gibbs_sample_f(s, jds_b, CGK), lambda s: js.gibbs_mix(s, jds_b),
              lambda s: js.gibbs_sample_phi(s, jds_b, SYMP, always_accept=False),
              lambda s: js.gibbs_sample_slice_theta("Aphi", XS)(s, jds_b),
              lambda s: js.gibbs_unmix(s, jds_b), lambda s: js.gibbs_postprocess(s, jds_b)):
        states.append(p(states[-1]))
    tds = _port_dataset(jds, d_np)
    draws = _jax_draws(jax.random.PRNGKey(KEY), (NB, 2, N, N), (NB, 1, N, N))
    return dict(jds=jds_b, tds=tds, start=start, states=states, draws=draws)


def _carry_state(g, js_state):
    """A JAX state as the port's, through state_from_numpy, each field in
    its own basis (a trip through another basis would add FFT round-off,
    which D, large where Cf falls off, amplifies)."""
    arrays = {"theta": {k: np.asarray(v) for k, v in js_state["theta"].items()},
              "step": js_state["step"]}
    for k in ("phi", "f", "f_mix", "phi_mix"):
        if k in js_state:
            f = js_state[k]
            arrays[k] = (np.asarray(f.arr), f.basis.pol, f.basis.space)
    return ct.state_from_numpy(arrays, g["tds"].d.proj, generator=torch.Generator())


# (pass, the JAX state it starts from, its draws, what it is held on)
PASSES = {
    "sample_f": (lambda s, ds: ts.gibbs_sample_f(s, ds, CGK), 0, "f", ("f",)),
    "mix": (ts.gibbs_mix, 1, None, ("f_mix", "phi_mix")),
    "sample_phi": (lambda s, ds: ts.gibbs_sample_phi(s, ds, SYMP, always_accept=False), 2,
                   "phi", ("phi_mix", "dH", "accept")),
    "sample_theta": (ts.gibbs_sample_slice_theta("Aphi", XS), 3, "theta", ("theta",)),
    "unmix": (ts.gibbs_unmix, 4, None, ("f", "phi")),
    "postprocess": (ts.gibbs_postprocess, 5, None, ("logpdf", "ft")),
}


def _held(port, jax_state, keys, tols=None):
    """The port's state against JAX's, fields in the JAX field's basis;
    `tols` overrides FIELD_TOL by key."""
    tols = tols or {}
    for k in keys:
        jv, tv = jax_state[k], port[k]
        if isinstance(jv, JF.Field):
            out = tv.to(ct.Basis(jv.basis.pol, jv.basis.space)).arr.detach().numpy()
            assert rel(out, np.asarray(jv.arr)) < tols.get(k, FIELD_TOL), k
        elif k == "dH":
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=DH_ATOL)
        elif k == "accept":
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        elif k == "theta":
            np.testing.assert_allclose(tv["Aphi"], np.asarray(jv["Aphi"]), rtol=0,
                                       atol=THETA_ATOL)
        else:
            assert rel(tv.numpy(), np.asarray(jv)) < tols.get(k, FIELD_TOL), k


@pytest.mark.parametrize("name", list(PASSES))
def test_gibbs_pass_matches_jax(gibbs, name, monkeypatch):
    """Each default pass from the JAX state before it, with JAX's draws."""
    fn, i, draws, keys = PASSES[name]
    normals, uniforms = _hand_in(monkeypatch, *(gibbs["draws"][draws] if draws else ([], [])))
    out = fn(_carry_state(gibbs, gibbs["states"][i]), gibbs["tds"])
    assert not normals and not uniforms
    _held(out, gibbs["states"][i + 1], keys)


def test_whole_gibbs_step_matches_jax(gibbs, monkeypatch):
    """One whole step of sample_joint's default passes (with a slice pass
    over Aphi) from the same phi and per-chain theta, with JAX's draws:
    f, phi, theta, dH, accept and the logpdf."""
    d = gibbs["draws"]
    normals, uniforms = _hand_in(monkeypatch, d["f"][0] + d["phi"][0],
                                 d["phi"][1] + d["theta"][1])
    start = ct.state_from_numpy(gibbs["start"], gibbs["tds"].d.proj)
    assert start["theta"]["Aphi"].shape == (NB,) and start["phi"].batch_shape == (NB,)
    res = ct.sample_joint(gibbs["tds"], 1, nchains=NB, generator=torch.Generator(),
                          theta_start=start["theta"], theta_range={"Aphi": XS},
                          phi_start=start["phi"], symp_kwargs=SYMP, conjgrad_kwargs=CGK,
                          nburnin_always_accept=0)
    assert not normals and not uniforms
    assert len(res[0]) == 1 and res[0][0]["step"] == 1
    _held(res[0][0], gibbs["states"][-1], ("f", "phi", "theta", "dH", "accept", "logpdf"),
          WHOLE_STEP_TOL)


def test_hmc_step_matches_jax(gibbs, monkeypatch):
    """hmc_step on the mixed posterior at JAX's f° and phi°, its momentum
    and uniform handed in: the same phi°, dH and accept per entry (JAX's
    sample_phi pass is one hmc_step)."""
    _hand_in(monkeypatch, *gibbs["draws"]["phi"])
    s = _carry_state(gibbs, gibbs["states"][2])
    ds, theta = gibbs["tds"], s["theta"]
    U = lambda pm: ct.Mixed(ds).logpdf(f_mix=s["f_mix"], phi_mix=pm, theta=theta)
    with torch.no_grad():
        x, dH, accept = ct.hmc_step(None, U, s["phi_mix"], ct.mass_matrix_phi(theta, ds),
                                    N=SYMP[0]["N"], eps=SYMP[0]["eps"])
    _held(dict(phi_mix=x, dH=dH, accept=accept), gibbs["states"][3], ("phi_mix", "dH", "accept"))


def test_mass_matrix_phi_matches_jax(gibbs):
    for theta in ({}, {"Aphi": 1.3}, {"Aphi": np.array([1.0, 1.2])}):
        jl = js.mass_matrix_phi({k: jnp.asarray(v) for k, v in theta.items()}, gibbs["jds"])
        tl = ct.mass_matrix_phi(theta, gibbs["tds"])
        assert tl.diag.basis == ct.Basis(jl.diag.basis.pol, jl.diag.basis.space)
        assert rel(tl.diag.arr.numpy(), np.asarray(jl.diag.arr)) < FIELD_TOL


def test_symplectic_integrate_matches_jax():
    """The leapfrog from the same x0, p0 and a non-uniform Lambda on a
    Gaussian potential: dH, x and p."""
    rng = np.random.default_rng(2)
    jp = JProj(16, 16, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(16, 16, thetapix=3, T=np.float32, device="cpu")
    x0, p0 = (rng.standard_normal((2, 1, 16, 16)).astype(np.float32) for _ in range(2))
    lam = (1.0 + rng.random((1, 16, 9))).astype(np.float32)
    jx, jpp = (JF.Field(jnp.asarray(a), JBasis("I", "map"), jp) for a in (x0, p0))
    tx, tpp = (ct.Field(torch.as_tensor(a), ct.MAP, tp) for a in (x0, p0))
    jL = JDiag(JF.Field(jnp.asarray(lam), JBasis("I", "fourier"), jp))
    tL = ct.Diag(ct.Field(torch.as_tensor(lam), ct.FOURIER, tp))
    jU, tU = (lambda x: -JF.dot(x, x) / 2), (lambda x: -ct.dot(x, x) / 2)
    jdH, jx1, jp1 = js.symplectic_integrate(jx, jpp, jL, JF.fgrad(lambda x: jnp.sum(jU(x))),
                                            N=20, eps=0.05, U=jU)
    tdH, tx1, tp1 = ct.symplectic_integrate(tx, tpp, tL, ct.fgrad(lambda x: torch.sum(tU(x))),
                                            N=20, eps=0.05, U=tU)
    assert rel(_np_in(tx1, "I"), _np_in(jx1, "I")) < FIELD_TOL
    assert rel(_np_in(tp1, "I"), _np_in(jp1, "I")) < FIELD_TOL
    np.testing.assert_allclose(tdH.detach().numpy(), np.asarray(jdH), rtol=1e-4, atol=1e-4)


def test_symplectic_integrate_energy():
    """JAX's energy test (tests/test_inference.py): the leapfrog on a
    Gaussian conserves the Hamiltonian to O(eps^2)."""
    proj = ct.ProjLambert(16, 16, thetapix=3, T=np.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, p = ct.randn(g, proj, pol="I"), ct.randn(g, proj, pol="I")
    Lam = ct.Diag(ct.Field(torch.ones_like(x.arr), ct.MAP, proj))
    U = lambda x: -ct.dot(x, x) / 2
    dH, _, _ = ct.symplectic_integrate(x, p, Lam, ct.fgrad(lambda x: torch.sum(U(x))),
                                       N=50, eps=0.05, U=U)
    assert abs(float(dH)) < 1.0


@pytest.mark.parametrize("batched", [False, True])
def test_grid_and_sample_matches_jax(batched, monkeypatch):
    """The same grid logpdfs and JAX's uniforms handed in: the same
    samples, interpolants and grid."""
    xs = np.linspace(-4, 4, 81)
    if batched:
        fn = lambda v: -np.asarray(v)[:, None] ** 2 / np.array([2.0, 0.5, 8.0])
        nb, ns = 3, 5
    else:
        fn = lambda v: -v ** 2 / 2
        nb, ns = 1, 200
    key = jax.random.PRNGKey(0)
    jsamp, jinterp, jlps = js.grid_and_sample(key, fn, xs, nsamples=ns, batched=batched)
    us, k = [], key
    for _ in range(nb):
        k, s = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(s, (ns,))))
    _, left = _hand_in(monkeypatch, [], us)
    tsamp, tinterp, tlps = ct.grid_and_sample(None, fn, xs, nsamples=ns, batched=batched)
    assert not left
    np.testing.assert_allclose(tsamp, jsamp, rtol=NUMPY_TOL, atol=0)
    np.testing.assert_allclose(tlps, jlps, rtol=NUMPY_TOL, atol=0)
    ji, ti = (jinterp, tinterp) if batched else ([jinterp], [tinterp])
    for a, b in zip(ti, ji):
        np.testing.assert_allclose(a(0.3), b(0.3), rtol=NUMPY_TOL)
    if not batched:
        assert abs(np.mean(tsamp)) < 0.3 and abs(np.std(tsamp) - 1.0) < 0.3


# =========================================================================
# sample_joint: checkpoints, resume, passes, timing (the JAX package's
# tests/test_inference.py cases on the port)
# =========================================================================

@pytest.fixture(scope="module")
def sim32():
    return ct.load_sim(thetapix=3, Nside=32, pol="I", T=np.float32, seed=3, device="cpu")


def test_sample_joint_checkpoint_resume(sim32, tmp_path):
    ds = sim32["ds"]
    fn = str(tmp_path / "chain")
    kw = dict(nchains=2, symp_kwargs=[dict(N=3, eps=0.01)],
              conjgrad_kwargs=dict(tol=1e-1, nsteps=20))
    ct.sample_joint(ds, nsamps_per_chain=2, filename=fn, nfilewrite=1, **kw)
    loaded = ct.load_chains(fn)
    assert len(loaded) == 2 and len(loaded[0]) == 2
    ct.sample_joint(ds, nsamps_per_chain=3, filename=fn, resume=True, **kw)
    loaded2 = ct.load_chains(fn)
    assert len(loaded2[0]) == 3
    # fields unbatch per chain, on the host
    phi = loaded2[0][0]["phi"]
    assert phi.batch_shape == () and phi.arr.device.type == "cpu"
    assert loaded2[1][2]["accept"].shape == () and np.isfinite(float(loaded2[1][2]["logpdf"]))


def test_sample_joint_resume_continues_the_draws(sim32, tmp_path):
    """A run of 3 steps and a run of 2 resumed to 3 give the same chain:
    the checkpoint carries the generator's state."""
    ds = sim32["ds"]
    kw = dict(nchains=2, symp_kwargs=[dict(N=2, eps=0.01)],
              conjgrad_kwargs=dict(tol=0.0, nsteps=4, fixed_iters=True), nburnin_always_accept=0)
    whole = ct.sample_joint(ds, 3, filename=str(tmp_path / "a"), **kw)
    ct.sample_joint(ds, 2, filename=str(tmp_path / "b"), **kw)
    resumed = ct.sample_joint(ds, 3, filename=str(tmp_path / "b"), resume=True, **kw)
    assert [e["step"] for e in resumed[0]] == [3]
    for k in ("logpdf", "dH", "accept"):
        np.testing.assert_array_equal(resumed[0][0][k].numpy(), whole[0][2][k].numpy())
    np.testing.assert_array_equal(resumed[0][0]["phi"].arr.numpy(), whole[0][2]["phi"].arr.numpy())


def test_gibbs_pass_combinators():
    calls = []

    def mark(state, ds, **kw):
        calls.append(state["step"])
        return state

    every3 = ct.once_every(3, mark)
    for step in range(1, 8):
        every3({"step": step}, None)
    assert calls == [3, 6]
    calls.clear()
    after4 = ct.start_after_burnin(4, mark)
    for step in range(1, 8):
        after4({"step": step}, None)
    assert calls == [5, 6, 7]


def test_sample_joint_verbose_timing(capsys):
    out = ct.load_sim(thetapix=5, Nside=16, pol="I", T=np.float32, seed=2, device="cpu")
    ct.sample_joint(out["ds"], nsamps_per_chain=2, nchains=1, generator=torch.Generator(),
                    symp_kwargs=[dict(N=3, eps=0.01)], conjgrad_kwargs=dict(tol=1e-1, nsteps=5),
                    verbose_timing=True)
    captured = capsys.readouterr()
    assert "gibbs step 1 timing" in captured.out
    assert "gibbs/sample_f" in captured.out
    assert "gibbs/sample_phi" in captured.out


def test_sample_joint_theta_range_and_phi_starts(sim32):
    """A theta slice pass draws one value a chain inside its grid; phi
    starts from zero or a given field; mesh= at one rank (a world of one
    process over gloo) is the unsharded run (several ranks:
    tests/test_torch_parallel.py)."""
    ds = sim32["ds"]
    kw = dict(nchains=2, symp_kwargs=[dict(N=2, eps=0.01)],
              conjgrad_kwargs=dict(tol=0.0, nsteps=3, fixed_iters=True))
    res = ct.sample_joint(ds, 2, theta_range={"Aphi": np.linspace(0.5, 1.5, 7)}, phi_start=0,
                          **kw)
    A = np.array([th["Aphi"] for th in res["theta"][0]])
    assert A.shape == (2, 2) and np.all((A >= 0.5) & (A <= 1.5))
    assert all(np.isfinite(e["logpdf"].numpy()).all() for e in res[0])
    phi1 = ct.batch_index(res[0][-1]["phi"], 1)
    proj = ds.d.proj
    res2 = ct.sample_joint(ds, 1, phi_start=ct.Field(phi1.arr, phi1.basis, proj), **kw)
    assert res2[0][0]["phi"].batch_shape == (2,)
    res3 = ct.sample_joint(ds, 1, phi_start=ct.Field(phi1.arr, phi1.basis, proj),
                           mesh=ct.make_mesh(device="cpu"), **kw)
    assert torch.equal(res3[0][0]["logpdf"], res2[0][0]["logpdf"])
    assert torch.equal(res3[0][0]["phi"].arr, res2[0][0]["phi"].arr)


# =========================================================================
# the native checkpoint records, written by either package
# =========================================================================

PAYLOADS = [pickle.dumps({"i": i, "x": np.arange(i)}) for i in range(7)] + [b"", b"y" * 5000]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_read_back_in_the_other_package(tmp_path, writer):
    """Records written by one package's native writer read back in the
    other's reader, payload for payload, and the two writers' files are
    the same bytes."""
    paths = {}
    for name, mod in (("jax", jnative), ("port", tnative)):
        paths[name] = str(tmp_path / f"{name}.ckpt")
        with mod.CheckpointWriter(paths[name]) as w:
            for p in PAYLOADS:
                w.write(p)
            w.flush()
    reader = tnative if writer == "jax" else jnative
    assert reader.read_records(paths[writer]) == PAYLOADS
    assert reader.scan_count(paths[writer]) == len(PAYLOADS)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


def test_crash_truncation_recovery(tmp_path):
    path = str(tmp_path / "chk")
    with tnative.CheckpointWriter(path) as w:
        for _ in range(10):
            w.write(b"x" * 100)
        w.flush()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 33)   # the last record cut short
    assert len(tnative.read_records(path)) == 9
    # appending after the crash cuts the partial tail: the new record is reachable
    with tnative.CheckpointWriter(path, append=True) as w:
        w.write(b"tail")
        w.flush()
    recs = tnative.read_records(path)
    assert len(recs) == 10 and recs[-1] == b"tail"
    assert jnative.read_records(path) == recs


def test_async_queue_and_build_failure(tmp_path, monkeypatch):
    path = str(tmp_path / "chk")
    w = tnative.CheckpointWriter(path)
    big = b"y" * (1 << 20)
    for _ in range(20):
        w.write(big)
    w.flush()
    w.close()
    assert tnative.scan_count(path) == 20
    # a library that fails to build raises: no quiet fallback writer
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SRC", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building broken.cpp failed"):
        tnative.CheckpointWriter(str(tmp_path / "other"))


# =========================================================================
# chains
# =========================================================================

def test_chain_statistics_match_jax():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=2000)) * 0.05 + rng.normal(size=2000)
    assert tchains.effective_sample_size(x) == jchains.effective_sample_size(x)
    assert tchains.mean_std_and_errors(x) == jchains.mean_std_and_errors(x)
    y = rng.normal(size=2000)
    ess = tchains.effective_sample_size(y)
    assert 500 < ess <= 2100
    st = tchains.mean_std_and_errors(y)
    assert abs(st["mean"]) < 0.1 and abs(st["std"] - 1) < 0.1


@pytest.mark.parametrize("case", ["1d", "1d_bounded", "2d", "2d_bounded"])
def test_kde_matches_jax(case):
    rng = np.random.default_rng(1)
    if case.startswith("1d"):
        x = np.abs(rng.normal(size=3000))
        kw = dict(boundary=(0.0, None)) if case == "1d_bounded" else {}
    else:
        x = np.abs(rng.normal(size=(3000, 2)))
        kw = dict(boundary=((0.0, None), (0.0, None))) if case == "2d_bounded" else {}
    for a, b in zip(tchains.kde(x, **kw), jchains.kde(x, **kw)):
        np.testing.assert_allclose(a, b, rtol=NUMPY_TOL, atol=NUMPY_TOL)


def test_load_chains_unbatches_fields_and_per_chain_values(sim32, tmp_path):
    fn = str(tmp_path / "c")
    ct.sample_joint(sim32["ds"], 2, nchains=3, filename=fn, symp_kwargs=[dict(N=2, eps=0.01)],
                    conjgrad_kwargs=dict(tol=0.0, nsteps=3, fixed_iters=True))
    chains = ct.load_chains(fn)
    assert len(chains) == 3 and all(len(c) == 2 for c in chains)
    assert chains[2][1]["phi"].batch_shape == () and chains[2][1]["dH"].shape == ()
    joined = ct.load_chains(fn, join=True, burnin=1)
    assert len(joined) == 1 and len(joined[0]) == 3
    assert isinstance(chains["logpdf"], list) and chains[0].last("logpdf") is not None


# =========================================================================
# entry points
# =========================================================================

def test_entry_points_default_to_the_card(monkeypatch):
    """With a card and no `device`, load_sim(Nbatch=...) makes its
    generator on CUDA, and sample_joint makes its own on the dataset's
    device (here the card is only announced: nothing is allocated before
    the generator)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def generator(device=None):
        seen.append(torch.device(device))
        raise RuntimeError("stop before the card is touched")

    monkeypatch.setattr(torch, "Generator", generator)
    with pytest.raises(RuntimeError, match="stop before"):
        ct.load_sim(thetapix=3, Nside=16, pol="P", seed=0, Nbatch=2)
    proj = ct.ProjLambert(16, 16, thetapix=3)
    ds = ct.DataSet(d=ct.Field(torch.zeros((2, 2, 16, 16), device="meta"), ct.QU_MAP, proj))
    with pytest.raises(RuntimeError, match="stop before"):
        ct.sample_joint(ds, 1, nchains=2)
    assert seen == [torch.device("cuda")] * 2
