"""The p(t) planes leaf of the port's flows and its reuse across RK4
stages, against the JAX package on the same numpy inputs.

- The plain p-planes function (what the wrapper runs for a CPU tensor)
  against JAX's in-kernel `_p_of_t` and the scan's `_p_t`: rtol 1e-6, the
  float32 rounding of one closed-form 2 x 2 inverse.
- Flows whose p(t) planes are formed once per distinct time and shared by
  the two middle RK4 stages (forward, adjoint, backward; dense and
  factored operands; the uni granularity) against the JAX Pallas flows in
  interpret mode and the JAX scan, at the bounds the parity tests of
  tests/test_torch_flow_kernel.py and tests/test_torch_factored.py use
  (1e-5 relative max-abs).
- A flow asks for p(t) at 2 nsteps + 1 times, the times of `flow_times`,
  and every velocity is evaluated at the planes of its own time.
- The calls a flow makes to each leaf, and with them the kernel launches
  it costs on the card (one line per launch counter).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.models import lenseflow as jlf
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk

TOL = 1e-5
NSTEPS = 3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    jderiv.set_deriv_mode("auto")


def _weak_lensing(N=32, ncomp=2, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1 at every N, and random f, dy
    (as tests/test_torch_flow_kernel.py)."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    return phi, f, dy


def _jax_planes(phi, proj):
    g, h = jlf._gradhess_phi(jnp.asarray(phi), proj)
    return g, h, np.stack([np.asarray(x) for x in (*g, *h)])


@pytest.mark.parametrize("t", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_p_planes_plain_matches_jax(t, batch):
    rng = np.random.default_rng(4)
    planes = rng.standard_normal(batch + (5, 64, 64)).astype(np.float32)
    planes[..., 2:, :, :] *= 0.2          # I + t Hess(phi) stays far from singular
    out = torch.full((2,) + batch + (64, 64), float("nan"))
    lfk.p_planes_plain(t, torch.as_tensor(planes), out)
    jp = [jnp.asarray(planes[..., i, :, :]) for i in range(5)]
    for ref in (plf._p_of_t(t, *jp), jlf._p_t(t, tuple(jp[:2]), tuple(jp[2:]))):
        for a, b in zip(out.numpy(), ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6 * np.abs(b).max())


class _Recorder:
    """A leaf set that runs the plain leaves and records every call: the
    time of each p(t) request, and for each velocity its time and whether
    the planes it was handed are those of that time."""

    def __init__(self, leaves):
        self.leaves, self.batched = leaves, leaves.batched
        self.p_times, self.velocities, self.calls = [], [], {}

    def _count(self, name):
        self.calls[name] = self.calls.get(name, 0) + 1

    def p_planes(self, t, phi, out):
        self._count("p_planes")
        self.p_times.append(t)
        self.leaves.p_planes(t, phi, out)

    def velocity(self, kind, y, k, phi, pt, mats, ncomp, t):
        self._count("velocity")
        fresh = torch.empty_like(pt)
        self.leaves.p_planes(t, phi, fresh)
        self.velocities.append((t, bool(torch.equal(fresh, pt))))
        self.leaves.velocity(kind, y, k, phi, pt, mats, ncomp, t)

    def rk4_update(self, *args):
        self._count("rk4_update")
        self.leaves.rk4_update(*args)

    def deriv(self, *args):
        self._count("deriv")
        self.leaves.deriv(*args)


def _operands(form, N=32):
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    return tderiv.deriv_mats(tp) if form == "dense" else tfd.factored_ops(tp, 4, 4)


@pytest.mark.parametrize("nsteps", [1, 3, 7])
@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (1.0, 0.0)])
def test_flow_asks_for_p_at_2nsteps_plus_1_times(nsteps, t0, t1):
    phi, f, _ = _weak_lensing()
    mats = _operands("dense")
    planes = lfk.gradhess(torch.as_tensor(phi), mats)
    rec = _Recorder(lfk.PLAIN)
    lfk._flow_apply(rec, torch.as_tensor(f), planes, mats, t0, t1, nsteps, "forward")
    times = lfk.flow_times(nsteps, t0, t1)
    assert len(times) == 2 * nsteps + 1 and times[0] == t0 and abs(times[-1] - t1) < 1e-12
    assert rec.p_times == times
    # the stages of step i run at times 2i, 2i + 1, 2i + 1, 2i + 2, each at its own planes
    assert [t for t, _ in rec.velocities] == [times[2 * i + j] for i in range(nsteps)
                                              for j in (0, 1, 1, 2)]
    assert all(ok for _, ok in rec.velocities)


@pytest.mark.parametrize("form", ["dense", "factored"])
@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("adjoint", 1.0, 0.0)])
def test_flow_with_shared_planes_matches_jax(form, kind, t0, t1):
    """Forward and adjoint flows with p(t) shared by the middle stages
    against the JAX whole-flow kernel (interpret mode) and the scan."""
    jderiv.set_deriv_mode("matmul")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    phi, f, _ = _weak_lensing()
    g, h, planes = _jax_planes(phi, jp)
    ref = plf.pallas_flow_apply(jnp.asarray(f), g, h, t0, t1, NSTEPS, jp, kind, interpret=True)
    vel = jlf._velocity if kind == "forward" else jlf._velocity_adj
    scan = jlf._rk4(lambda t, y: vel(t, y, g, h, jp), jnp.asarray(f), t0, t1, NSTEPS)
    mats = _operands(form)
    rec = _Recorder(lfk.PLAIN if form == "dense" else lfk.FPLAIN)
    out = lfk._flow_apply(rec, torch.as_tensor(f), torch.as_tensor(planes), mats, t0, t1, NSTEPS,
                          kind)
    assert rec.calls == {"p_planes": 2 * NSTEPS + 1, "velocity": 4 * NSTEPS,
                         "rk4_update": 4 * NSTEPS}
    assert rel(out.numpy(), ref) < TOL
    assert rel(out.numpy(), scan) < TOL


@pytest.mark.parametrize("form", ["dense", "factored"])
def test_backward_flow_with_shared_planes_matches_jax(form):
    jderiv.set_deriv_mode("matmul")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    phi, f, dy = _weak_lensing()
    g, h, planes = _jax_planes(phi, jp)
    dphi_ref, df0_ref = plf.pallas_flow_bwd(jnp.asarray(dy), jnp.asarray(f), g, h, 0., 1., NSTEPS,
                                            jp, interpret=True)
    dphi_scan, df0_scan = jlf._lenseflow_bwd(0., 1., NSTEPS, jp, "scan", None,
                                             (jnp.asarray(phi), jnp.asarray(f)), jnp.asarray(dy))
    mats = _operands(form)
    rec = _Recorder(lfk.PLAIN if form == "dense" else lfk.FPLAIN)
    dphi, df0 = lfk._flow_bwd(rec, torch.as_tensor(dy), torch.as_tensor(f),
                              torch.as_tensor(planes), mats, 0., 1., NSTEPS)
    assert rec.p_times == lfk.flow_times(NSTEPS, 1.0, 0.0)
    assert all(ok for _, ok in rec.velocities)
    for out, a, b in ((df0, df0_ref, df0_scan), (dphi, dphi_ref, dphi_scan)):
        assert rel(out.numpy(), a) < TOL
        assert rel(out.numpy(), b) < TOL


@pytest.mark.parametrize("kind", ["forward", "adjoint", "backward"])
def test_uni_flow_shares_the_planes_and_matches_the_kernel_granularity(kind):
    """The uni flows take p(t) from the same leaf (no p(t) glue of their
    own per velocity) and agree with the K3/K4-granularity flows."""
    phi, f, dy = _weak_lensing()
    mats = _operands("factored")
    planes = lfk.gradhess(torch.as_tensor(phi), mats)
    rec = _Recorder(lfk.UPLAIN)
    ft, dyt = torch.as_tensor(f), torch.as_tensor(dy)
    if kind == "backward":
        dphi, df0 = lfk._uni_flow_bwd(rec, dyt, ft, planes, mats, 0., 1., NSTEPS)
        dphi_k, df0_k = lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., NSTEPS)
        assert rel(df0.numpy(), df0_k.numpy()) < TOL
        assert rel(dphi.numpy(), dphi_k.numpy()) < 1e-4   # delta phi un-hoisted against hoisted
    else:
        out = lfk._flow_apply(rec, ft, planes, mats, 0., 1., NSTEPS, kind)
        assert rel(out.numpy(), lfk.flow_apply(ft, planes, mats, 0., 1., NSTEPS, kind).numpy()) < TOL
    assert rec.calls["p_planes"] == 2 * NSTEPS + 1 and all(ok for _, ok in rec.velocities)


# kernel launches one call of each leaf makes on the card, by leaf set:
# what the wrappers add to lenseflow_kernels.LAUNCHES (the dense kernel
# leaves run a whole flow in one launch, flow_<kind>, and these counts are
# the plain dense leaves' calls in the flow's walk of the same table)
PER_CALL = {
    "dense": {"velocity": 1, "rk4_update": 1, "p_planes": 1, "deriv": 1},
    # a factored velocity is an x pass and a y pass; K1 one launch per derivative given
    "factored": {"velocity": 2, "rk4_update": 1, "p_planes": 1},
}


@pytest.mark.parametrize("form", ["dense", "factored"])
def test_launches_per_flow(form):
    """Leaf calls per flow, hence launches per counter on the card. Against
    the flows before p(t) became a leaf: velocity, rk4_update and the
    derivative counters are unchanged; p_planes is new, 2 nsteps + 1 per
    flow."""
    phi, f, dy = _weak_lensing()
    mats = _operands(form)
    planes = lfk.gradhess(torch.as_tensor(phi), mats)
    plain = lfk.PLAIN if form == "dense" else lfk.FPLAIN
    n = NSTEPS
    rec = _Recorder(plain)
    lfk._flow_apply(rec, torch.as_tensor(f), planes, mats, 0., 1., n, "forward")
    launches = {k: v * PER_CALL[form][k] for k, v in rec.calls.items()}
    assert launches["velocity"] == 4 * n * PER_CALL[form]["velocity"]   # dense walk / fa_velocity_forward
    assert launches["rk4_update"] == 4 * n                               # rk4_update
    assert launches["p_planes"] == 2 * n + 1                             # p_planes
    assert "deriv" not in launches                                       # deriv / fderiv: none in an apply
    rec = _Recorder(plain)
    lfk._flow_bwd(rec, torch.as_tensor(dy), torch.as_tensor(f), planes, mats, 0., 1., n)
    assert rec.calls["velocity"] == 4 * n        # dense walk 4n, bv_velocity 8n (two passes)
    assert rec.calls["rk4_update"] == 4 * n      # rk4_update
    assert rec.calls["p_planes"] == 2 * n + 1    # p_planes
    assert rec.calls["deriv"] == 3               # deriv 3; fderiv 5 (2 + 1 + 2 derivatives given)
    rec = _Recorder(plain)
    lfk._gradhess(rec, torch.as_tensor(phi), mats)
    assert rec.calls == {"deriv": 5}             # deriv 5; fderiv 5 (one derivative each)


def test_flow_builds_its_launchers_once():
    """Leaves that come with launcher makers (the kernel leaves: checks and
    pointer conversions once per flow) are asked for one launcher per
    kernel and buffer set, and the flow through them is the flow through
    the leaves themselves."""
    phi, f, _ = _weak_lensing()
    mats = _operands("dense")
    planes = lfk.gradhess(torch.as_tensor(phi), mats)
    made = []

    def velocity(kind, y, k, phi, pt, mats, ncomp):
        made.append("velocity")
        return lambda t: lfk.velocity_plain(kind, y, k, phi, pt, mats, ncomp, t)

    def rk4_update(y, k, acc, s):
        made.append("rk4_update")
        return lambda stage, wacc, ws: lfk.rk4_update_plain(y, k, acc, s, stage, wacc, ws)

    def p_planes(phi, out):
        made.append("p_planes")
        return lambda t: lfk.p_planes_plain(t, phi, out)

    leaves = lfk._Leaves(None, None, None, None, False, (velocity, rk4_update, p_planes))
    out = lfk._flow_apply(leaves, torch.as_tensor(f), planes, mats, 0., 1., NSTEPS, "adjoint")
    assert made == ["velocity", "velocity", "rk4_update", "p_planes"]   # at y, at s; one each
    assert torch.equal(out, lfk.flow_apply(torch.as_tensor(f), planes, mats, 0., 1., NSTEPS,
                                           "adjoint"))


def test_kernel_wrappers_count_where_they_launch():
    """The launch counters: one per kernel of the flows, p_planes among
    them, all zero after a reset and untouched by a CPU flow (the plain
    versions launch nothing)."""
    lfk.reset_launches()
    phi, f, _ = _weak_lensing()
    mats = _operands("dense")
    lfk.flow_apply(torch.as_tensor(f), lfk.gradhess(torch.as_tensor(phi), mats), mats, 0., 1., 1)
    assert set(lfk.LAUNCHES) >= {"flow_forward", "flow_adjoint", "flow_backward",
                                 "rk4_update", "p_planes", "deriv", "fderiv",
                                 "fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity"}
    assert all(v == 0 for v in lfk.LAUNCHES.values())


def test_p_planes_wrapper_rejects_misfit_planes():
    phi = torch.zeros((5, 32, 32))
    with pytest.raises(ValueError, match="all tensors must be on one CUDA device"):
        lfk.p_planes_cuda(0.5, phi, torch.empty((2, 32, 32)))
