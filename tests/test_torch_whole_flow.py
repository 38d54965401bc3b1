"""The dense LenseFlow flow as one table of RK4 stages, on the CPU.

The flow kernel (csrc/dense_flow.cu) integrates a whole flow in one
launch: it walks `lenseflow_kernels.flow_schedule`, the stages' times,
weights and buffers, and numbers its work items as `flow_items` below
states. Here, against the same inputs made with numpy:

- the table against the JAX package's `_rk4_steps` (the TPU whole-flow
  kernel's RK4): the same velocity times and weights;
- that no stage writes a state or p(t) buffer it reads, and that each
  stage reads what the stage before it wrote and p(t) at its own time;
- the walk of the table on the plain leaves against the per-stage loop
  it replaced, bit for bit, at every kind and tier, and a flow walked a
  step's slice of the table at a time against the whole table (the card
  test of the white-field flow launches the kernel on such slices);
- every (tile, component, entry) item of a stage taken by exactly one
  block, at any grid size, for square, three-component, ragged and
  batched flows;
- the batched plain flow against entry-by-entry flows.

The kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk


def _jax_stages(nsteps, t0, t1):
    """(time, wacc, ws) of each velocity call of JAX `_rk4_steps`, read off
    a one-plane state: call j of a step returns k = 1, the others 0, so the
    step's result is call j's accumulator weight and the next call's input
    its weight of s."""
    out = []
    for j in range(4):
        calls = []

        def vel(t, y):
            # the call's time and input, recorded as the loop runs
            jax.debug.callback(lambda t, y: calls.append((float(t), float(y[0]))), t, y[0],
                               ordered=True)
            n = len(vel.seen)
            vel.seen.append(None)
            return [jnp.full((1,), 1.0 if n % 4 == j else 0.0, jnp.float32)]

        vel.seen = []   # the calls traced: the four stages of one step's body
        y1 = plf._rk4_steps(vel, [jnp.zeros((1,), jnp.float32)], t0, t1, nsteps)
        jax.effects_barrier()
        out.append((calls, float(y1[0][0])))
    return out


@pytest.mark.parametrize("nsteps,t0,t1", [(1, 0.0, 1.0), (3, 1.0, 0.0), (7, 0.0, 1.0)])
def test_schedule_matches_jax_rk4_steps(nsteps, t0, t1):
    sched = lfk.flow_schedule(nsteps, t0, t1)
    assert len(sched) == 4 * nsteps and [st.rk for st in sched] == [0, 1, 2, 3] * nsteps
    runs = _jax_stages(nsteps, t0, t1)
    times = [t for t, _ in runs[0][0]]
    # JAX forms the times in float32 (t0 + i h, then + h/2, + h): one ulp
    np.testing.assert_allclose([st.t for st in sched], times, rtol=1e-6, atol=1e-7)
    for j, (calls, y1) in enumerate(runs):
        st = sched[j]
        if nsteps == 1:   # the one step's result is stage j's accumulator weight
            assert np.float32(st.wacc) == np.float32(y1)
        if j < 3:         # and the next stage's input its weight of s
            assert np.float32(st.ws) == np.float32(calls[j + 1][1])
    # every step repeats the first one's weights
    for i, st in enumerate(sched):
        assert (st.wacc, st.ws) == (sched[i % 4].wacc, sched[i % 4].ws)


@pytest.mark.parametrize("nsteps,t0,t1", [(1, 0.0, 1.0), (3, 1.0, 0.0), (7, 0.0, 1.0)])
def test_no_stage_writes_a_buffer_it_reads(nsteps, t0, t1):
    sched = lfk.flow_schedule(nsteps, t0, t1)
    times = lfk.flow_times(nsteps, t0, t1)
    state = {0: ("y", 0), 1: None, 2: None}     # buffer -> (what, step) it holds
    p = {sched[0].psrc: sched[0].t}             # p buffer -> the time of its planes
    for i, st in enumerate(sched):
        step = i // 4
        assert st.dst != st.src and st.pdst != st.psrc
        assert (lfk.STATE_BUFFERS[st.dst] == "y") == (st.rk == 3)   # stage 3 writes y, the rest an s
        # the velocity's input: y at stage 0, the s the stage before wrote
        assert state[st.src] == (("y", step) if st.rk == 0 else (f"s{st.rk}", step))
        assert p.get(st.psrc) == st.t == times[2 * step + (st.rk + 1) // 2]
        state[st.dst] = ("y", step + 1) if st.rk == 3 else (f"s{st.rk + 1}", step)
        if st.pdst >= 0:
            assert st.tp == times[2 * step + 1 + st.rk // 2]
            p[st.pdst] = st.tp
    assert state[0] == ("y", nsteps)


def _weak_lensing(N=32, ncomp=2, nb=None, seed=1):
    """phi planes from a one-mode phi (Hess phi ~0.1) and random f, dy, made
    with numpy; with nb, a batch of nb entries, each its own phi scale and
    state."""
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    mats = tderiv.deriv_mats(tp)
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    f = rng.standard_normal(lead + (ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal(lead + (ncomp, N, N)).astype(np.float32)
    scale = 1.0 if nb is None else np.linspace(0.5, 1.5, nb, dtype=np.float32)[:, None, None, None]
    planes = lfk.gradhess(torch.as_tensor(phi * scale), mats)
    return mats, planes, torch.as_tensor(f), torch.as_tensor(dy)


def _per_stage_loop(leaves, kind, y, phi, mats, ncomp, nsteps, t0, t1):
    """The per-stage loop the table replaced: one s and one p buffer, the
    stages written out."""
    y = y.contiguous().clone()
    k, acc, s = torch.empty_like(y), torch.empty_like(y), torch.empty_like(y)
    pt = torch.empty((2,) + tuple(phi.shape[:-3]) + tuple(phi.shape[-2:]))
    h = (t1 - t0) / nsteps
    times = lfk.flow_times(nsteps, t0, t1)
    leaves.p_planes(times[0], phi, pt)
    for i in range(nsteps):
        t, tmid, tend = times[2 * i:2 * i + 3]
        leaves.velocity(kind, y, k, phi, pt, mats, ncomp, t)
        leaves.rk4_update(y, k, acc, s, 0, h / 6, h / 2)
        leaves.p_planes(tmid, phi, pt)
        leaves.velocity(kind, s, k, phi, pt, mats, ncomp, tmid)
        leaves.rk4_update(y, k, acc, s, 1, h / 3, h / 2)
        leaves.velocity(kind, s, k, phi, pt, mats, ncomp, tmid)
        leaves.rk4_update(y, k, acc, s, 2, h / 3, h)
        leaves.p_planes(tend, phi, pt)
        leaves.velocity(kind, s, k, phi, pt, mats, ncomp, tend)
        leaves.rk4_update(y, k, acc, s, 3, h / 6, 0.0)
    return y


@pytest.mark.parametrize("precision", lfk.PRECISIONS)
@pytest.mark.parametrize("kind", ["forward", "adjoint", "backward"])
def test_table_walk_gives_the_per_stage_loops_bits(kind, precision):
    mats, planes, f, dy = _weak_lensing()
    y = f if kind != "backward" else torch.cat([f, dy, 1e-3 * torch.ones((lfk.NACC, 32, 32))])
    leaves = lfk._plain_for(mats, precision)
    t0, t1 = (1.0, 0.0) if kind == "backward" else (0.0, 1.0)
    ref = _per_stage_loop(leaves, kind, y, planes, mats, 2, 3, t0, t1)
    out = lfk._integrate(leaves, kind, y, planes, mats, 2, 3, t0, t1)
    assert torch.equal(out, ref)
    # flow_plain, the plain version of the kernel's one launch, is that walk
    again = y.clone()
    lfk.flow_plain(kind, again, planes, mats, 2, lfk.flow_schedule(3, t0, t1), precision)
    assert torch.equal(again, ref)


@pytest.mark.parametrize("precision", lfk.PRECISIONS)
@pytest.mark.parametrize("kind", ["forward", "adjoint", "backward"])
def test_a_flow_walked_step_by_step_gives_the_whole_tables_bits(kind, precision):
    """A step's four stages start from y alone (stage 0 refills the
    accumulator and s) and the slice forms p of its first time first, so
    the table's step slices walked in turn are the whole flow."""
    mats, planes, f, dy = _weak_lensing()
    y = f if kind != "backward" else torch.cat([f, dy, 1e-3 * torch.ones((lfk.NACC, 32, 32))])
    t0, t1 = (1.0, 0.0) if kind == "backward" else (0.0, 1.0)
    sched = lfk.flow_schedule(3, t0, t1)
    whole, stepped = y.clone(), y.clone()
    lfk.flow_plain(kind, whole, planes, mats, 2, sched, precision)
    for i in range(3):
        lfk.flow_plain(kind, stepped, planes, mats, 2, sched[4 * i:4 * i + 4], precision)
    assert torch.equal(stepped, whole)


DT = 32   # the flow kernel's output tile side (csrc/dense_tile.cuh::DT)


def flow_items(kind, ncomp, nb, Ny, Nx):
    """The work items of one stage of the dense flow kernel, numbered as
    csrc/dense_flow.cu numbers them, as (entry, component, tile row, tile
    column): item i is tile i % ntile of the ceil(Ny / DT) x ceil(Nx / DT)
    tiles in row-major order, component (i // ntile) % nper and entry
    i // (ntile nper), with nper = ncomp, or 1 for the backward kind, whose
    item does every component (component 0 here). Its p(t) items are the
    backward kind's: (entry, 0, tile row, tile column). Block g of a
    launch of `blocks` takes items g, g + blocks, ... (flow_block_items)."""
    ntx = -(-Nx // DT)
    ntile = -(-Ny // DT) * ntx
    nper = 1 if kind == "backward" else ncomp
    return [(i // (ntile * nper), (i // ntile) % nper, (i % ntile) // ntx, (i % ntile) % ntx)
            for i in range(ntile * nper * nb)]


def flow_block_items(items, blocks):
    """The items each block of a launch of `blocks` blocks takes in a
    stage's grid-stride walk."""
    return [items[g::blocks] for g in range(blocks)]


# (kind, ncomp, nb, Ny, Nx): 64^2 P, the slice's 3 x 64^2, a ragged 40 x 56, batch 3
ITEM_CASES = [(kind, *case) for kind in ("forward", "adjoint", "backward")
              for case in ((2, 1, 64, 64), (3, 1, 64, 64), (2, 1, 40, 56), (2, 3, 64, 64))]


@pytest.mark.parametrize("kind,ncomp,nb,Ny,Nx", ITEM_CASES)
def test_every_work_item_is_taken_once_a_stage(kind, ncomp, nb, Ny, Nx):
    items = flow_items(kind, ncomp, nb, Ny, Nx)
    pitems = flow_items("backward", 1, nb, Ny, Nx)
    nty, ntx = -(-Ny // DT), -(-Nx // DT)
    comps = range(1 if kind == "backward" else ncomp)
    want = set(itertools.product(range(nb), comps, range(nty), range(ntx)))
    pwant = set(itertools.product(range(nb), [0], range(nty), range(ntx)))
    assert len(items) == len(want) and set(items) == want and set(pitems) == pwant
    # the tiles cover each pixel once, the ragged last row and column clipped
    hits = np.zeros((Ny, Nx), int)
    for ty, tx in {(i[2], i[3]) for i in items}:
        hits[ty * DT:(ty + 1) * DT, tx * DT:(tx + 1) * DT] += 1
    assert (hits == 1).all()
    # whatever the grid (1 block, fewer blocks than items, 132 SMs x 2, more)
    for blocks in sorted({1, 7, len(items) // 2 + 1, len(items), 264}):
        for walk, expect in ((items, want), (pitems, pwant)):
            taken = [it for share in flow_block_items(walk, blocks) for it in share]
            assert len(taken) == len(expect) and set(taken) == expect


@pytest.mark.parametrize("kind", ["forward", "adjoint", "backward"])
def test_batched_plain_flow_equals_entry_by_entry(kind):
    mats, planes, f, dy = _weak_lensing(nb=3)
    assert all(lfk._plain_for(mats, p).batched for p in lfk.PRECISIONS)
    if kind == "backward":
        dphi, df0 = lfk.flow_bwd(dy, f, planes, mats, 0., 1., 2)
        for b in range(3):
            e_dphi, e_df0 = lfk.flow_bwd(dy[b], f[b], planes[b], mats, 0., 1., 2)
            assert torch.equal(dphi[b], e_dphi) and torch.equal(df0[b], e_df0)
        return
    out = lfk.flow_apply(f, planes, mats, 0., 1., 2, kind)
    for b in range(3):
        assert torch.equal(out[b], lfk.flow_apply(f[b], planes[b], mats, 0., 1., 2, kind))


def test_kernel_leaves_run_a_flow_in_one_call_and_refuse_cpu_tensors():
    """The dense kernel leaves: batched, a whole flow in one call of the
    flow wrapper at their tier, and no per-stage velocity. On a CPU
    tensor the wrapper raises before launching anything."""
    for p in lfk.PRECISIONS:
        leaves = lfk._LEAVES["cuda", False, p]
        assert leaves.batched and leaves.flow is not None and leaves.velocity is None
    mats, planes, f, _ = _weak_lensing()
    lfk.reset_launches()
    with pytest.raises(ValueError, match="one CUDA device"):
        lfk.flow_cuda("forward", f.clone(), planes, mats, 2, lfk.flow_schedule(1, 0., 1.))
    assert all(v == 0 for v in lfk.LAUNCHES.values())
