"""The port's factored (radix-B) derivative and its factored flows
against the JAX package on the same numpy inputs.

- Blocks and butterflies equal JAX's `_factored_ops` in float64 to 1e-12
  (both are built by the same arithmetic from the same circulant).
- The plain factored apply (what the K1 wrapper runs for a CPU tensor)
  matches JAX's in-kernel `_fact_apply` in a Pallas interpreter kernel
  and the dense circulant: 5e-6 relative max-abs, the bound
  tests/test_deriv.py::test_pallas_factored_inkernel_matches_dense holds
  JAX's factored form to.
- The factored flows (forward, reverse L^-1, adjoint; backward) match
  JAX's `_fa_call` / `_bv_flow` in interpret mode with dense in-kernel
  derivatives, which are the same operator: 1e-5, the bound
  tests/test_deriv.py holds those kernels to against the scan.

The factored kernels take blocks of A = 128 on the card; the plain
version takes any A, so these tests run at 32^2-64^2 with A = 2..32.
Radix 16 and 32 (A = 4 and 2 at 64^2) are held to the JAX package's
plain XLA forms, where its interpreted Pallas kernels unroll B^2
butterfly terms a derivative and take minutes: the apply at radix 32 to
the in-kernel derivative body `_make_dd_any` run as XLA (the same jnp
function; radix 16 stays interpreted), the flows to JAX's LenseFlow scan
under its "factored" derivative mode at that radix (ops/factored_deriv.py::
_apply_factored_batched; test_torch_high.py::_jax_xla_flow), both built
from `_factored_ops(n, delta, dtype, B)`; radix 2 to 8 stay interpreted.
The CUDA kernels themselves are held against this plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf
from cmblensing_tpu.ops.factored_deriv import _factored_ops as j_factored_ops

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.models import lenseflow as tlf
from test_torch_high import _jax_dd_xla, _jax_xla_flow, _radix_case
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
    """One torch thread per test (the workers of a parallel run would
    otherwise contend for the cores); the deriv mode restored."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
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


@pytest.mark.parametrize("B", [2, 4, 8, 16, 32])
def test_factored_blocks_match_jax_f64(B):
    delta = float(JProj(64, 64, thetapix=3, T=np.float64).deltax)
    jop = j_factored_ops(64, delta, "float64", B)[0]
    top = tfd.factored_op(64, delta, "float64", B)
    assert (top.B, top.A) == (jop.B, jop.A)
    pairs = [(top.Rf, jop.Rf), (top.Ri, jop.Ri), (top.Gre, jop.Gre)]
    if B > 2:
        pairs += [(top.Gar, jop.Gar), (top.Gai, jop.Gai)]
    for a, b in pairs:
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))
    for transpose in (True, False):
        np.testing.assert_array_equal(top.packed(transpose), plf._pack_factored(jop, transpose))


@pytest.mark.parametrize("B", [2, 4, 8, 16, 32])
def test_factored_apply_matches_jax_in_kernel_and_dense(B):
    N = 64
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    delta = float(tp.deltax)
    jop = j_factored_ops(N, delta, "float32", B)[0]
    FXt, FY = jnp.asarray(plf._pack_factored(jop, True)), jnp.asarray(plf._pack_factored(jop, False))
    fmeta = ((B, jop.A, jop.Rf, jop.Ri), (B, jop.A, jop.Rf, jop.Ri))
    x = np.random.default_rng(B).standard_normal((N, N)).astype(np.float32)

    def kern(x_ref, fx_ref, fy_ref, o_ref):
        ddx, ddy = plf._make_dd_any(fx_ref[:], fy_ref[:], "f32", fmeta)
        o_ref[0] = ddx(x_ref[:])
        o_ref[1] = ddy(x_ref[:])

    if B == 32:
        # the same body as XLA: the interpreter unrolls 32^2 butterfly terms
        ref = _jax_dd_xla(x, (FXt, FY), fmeta, "f32")
    else:
        ref = np.asarray(pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((2, N, N), jnp.float32),
            interpret=True)(jnp.asarray(x), FXt, FY))
    ops = tfd.factored_ops(tp, B, B)
    xt = torch.as_tensor(x)
    out = [tfd.apply_x(xt, ops.FX, ops.bfx).numpy(), tfd.apply_y(xt, ops.FY, ops.bfy).numpy()]
    DxT, Dy = tderiv.deriv_mats(tp)
    dense = [(xt @ DxT).numpy(), (Dy @ xt).numpy()]
    for o, r, d in zip(out, ref, dense):
        assert rel(o, r) < 5e-6
        assert rel(o, d) < 5e-6


def test_factored_gradhess_matches_dense_and_f64():
    """grad/Hess(phi) through the factored derivative against the dense
    one and a float64 evaluation. The gradient planes agree to f32
    round-off (1e-5); the Hessian planes differentiate the gradient's
    float32 rounding again, which costs ~5e-5 relative here in either
    form: 1e-4 (the gradhess bound chip_smoke.py and the JAX package's
    test_lensing.py use)."""
    phi, _, _ = _weak_lensing(N=64)
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cpu")
    tp64 = ct.ProjLambert(64, 64, thetapix=3, T=np.float64, device="cpu")
    pt = torch.as_tensor(phi)
    a = lfk.gradhess(pt, tfd.factored_ops(tp, 4, 4)).numpy()
    b = lfk.gradhess(pt, tderiv.deriv_mats(tp)).numpy()
    c = lfk.gradhess(pt.double(), tfd.factored_ops(tp64, 4, 4)).numpy()
    assert a.shape == (5, 64, 64)
    for i in range(5):
        bound = TOL if i < 2 else 1e-4
        assert rel(a[i], b[i]) < bound
        assert rel(a[i], c[i]) < bound


def _flow_inputs(B, N=32, ncomp=2):
    jp = JProj(N, N, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing(N=N, ncomp=ncomp)
    ops = tfd.factored_ops(tp, B, B)
    planes = lfk.gradhess(torch.as_tensor(phi), ops)
    return jp, ops, planes, f, dy


# radix 2 and 4 against JAX's dense in-kernel derivatives at 32^2 (the
# same operator); radix 16 and 32 against the JAX package's plain XLA
# flows at that radix at 64^2 (`_radix_case`, test_torch_high.py::
# _jax_xla_flow: its factored derivative `_apply_factored_batched`)
FLOW_RADICES = [2, 4, 16, 32]
_FA_KINDS = [("forward", 0.0, 1.0), ("forward", 1.0, 0.0), ("adjoint", 1.0, 0.0)]


# every kind at radix 2, 4 and 16; L^H at radix 32
@pytest.mark.parametrize("kind,t0,t1,B", [(*k, B) for B in (2, 4, 16) for k in _FA_KINDS]
                         + [(*_FA_KINDS[2], 32)])
def test_factored_flow_matches_jax_fa_call_interpret(B, kind, t0, t1, monkeypatch):
    """L, L^-1 (forward kind run 1 -> 0) and L^H against the
    component-gridded `_fa_call` on the same phi planes; at radix 16 and
    32 against the JAX package's plain XLA flow at that radix."""
    N, ncomp, nsteps = _radix_case(B)
    jp, ops, planes, f, _ = _flow_inputs(B, N, ncomp)
    jplanes = tuple(jnp.asarray(p) for p in planes.numpy())
    if B > 8:
        ref = _jax_xla_flow(kind, f, planes, N, B, t0, t1, nsteps, monkeypatch)
    else:
        ref = plf._fa_call(jnp.asarray(f), jplanes, plf._mats_for(jp, np.float32), kind, nsteps,
                           t0, t1, "f32", True)
    out = lfk.flow_apply(torch.as_tensor(f), planes, ops, t0, t1, nsteps, kind)
    assert rel(out.numpy(), ref) < TOL


@pytest.mark.parametrize("B", FLOW_RADICES)
def test_factored_backward_flow_matches_jax_bv_flow_interpret(B, monkeypatch):
    """The backward flow against `_bv_flow` interpreted (radix 2 and 4),
    or the JAX package's plain XLA backward flow at radix 16 and 32."""
    N, ncomp, nsteps = _radix_case(B)
    jp, ops, planes, f, dy = _flow_inputs(B, N, ncomp)
    dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, ops, 0., 1., nsteps)
    assert dphi.shape == (1, N, N) and df0.shape == f.shape
    if B > 8:
        rdphi, rdf0 = _jax_xla_flow("backward", f, planes, N, B, 0.0, 1.0, nsteps, monkeypatch, dy)
        assert rel(df0.numpy(), rdf0) < TOL
        assert rel(dphi.numpy(), rdphi) < TOL
        return
    jderiv.set_deriv_mode("matmul")
    state = jnp.concatenate([jnp.asarray(f), jnp.asarray(dy), jnp.zeros((1, N, N), jnp.float32)])
    ref = plf._bv_flow(state, tuple(jnp.asarray(p) for p in planes.numpy()), jp, nsteps, 1.0, 0.0,
                       "f32", interpret=True)
    assert rel(df0.numpy(), ref[ncomp:2 * ncomp]) < TOL
    assert rel(dphi.numpy(), ref[2 * ncomp:]) < TOL


def test_factored_flows_take_the_batch_in_one_call():
    """A batch of (f, phi) pairs through the factored flows equals its
    entries one by one: batch x component rides on the kernels' grid."""
    _, ops, planes, f, dy = _flow_inputs(4)
    planes2 = torch.stack([planes, 0.5 * planes])
    fb = torch.stack([torch.as_tensor(f), torch.as_tensor(dy)])
    out = lfk.flow_apply(fb, planes2, ops, 0., 1., NSTEPS, "adjoint")
    dphi, df0 = lfk.flow_bwd(fb.flip(0), fb, planes2, ops, 0., 1., NSTEPS)
    for i in range(2):
        assert rel(out[i].numpy(), lfk.flow_apply(fb[i], planes2[i], ops, 0., 1., NSTEPS,
                                                  "adjoint").numpy()) < 1e-6
        one = lfk.flow_bwd(fb.flip(0)[i], fb[i], planes2[i], ops, 0., 1., NSTEPS)
        assert rel(dphi[i].numpy(), one[0].numpy()) < 1e-6
        assert rel(df0[i].numpy(), one[1].numpy()) < 1e-6


def test_deriv_ops_radix_rule():
    """A = 128 where N / 128 is a radix the factored kernels are built for
    (4, 8, 16, 32), else dense: B = 8 packed operands at 1024, B = 4 at
    512, dense (DxT, Dy) at 256; 640 (B = 5, odd) and 768 (B = 6, not
    built) take the dense circulant. The kernels run radix 16 and 32 in
    2 and 4 channel groups of 8 channels."""
    assert [tderiv.radix(n) for n in (256, 384, 512, 640, 768, 1024, 2048, 4096)] == \
        [1, 1, 4, 1, 1, 8, 16, 32]
    assert [tderiv.radix_groups(B) for B in tderiv.BUILT_RADICES] == [1, 1, 2, 4]
    ops = tderiv.deriv_ops(ct.ProjLambert(1024, 1024, thetapix=2, T=np.float32, device="cpu"))
    assert isinstance(ops, tfd.FactoredOps)
    assert ops.FX.shape == ops.FY.shape == (8, 128, 128) and ops.bfx.shape == (2, 8, 8)
    assert ops.FX.dtype == torch.float32
    dense = tderiv.deriv_ops(ct.ProjLambert(256, 256, thetapix=2, T=np.float32, device="cpu"))
    assert isinstance(dense, tuple) and dense[0].shape == (256, 256)


@pytest.mark.parametrize("B,precision,kernel", [(8, "F32", "fa"), (8, "high", "uni_dense"),
                                                 (5, "high", "fderiv")])
def test_pass_launches_refuses_what_no_factored_kernel_runs(B, precision, kernel):
    """A wrapper's launch count comes from pass_launches, so a tier it does
    not know (a misspelt 'f32' would count the cluster tile's one launch
    for the strict kernel's groups), a kernel that is not factored (the
    dense K5) or a radix no kernel is built for raises instead of counting."""
    with pytest.raises(ValueError, match="pass_launches"):
        lfk.pass_launches(B, precision, kernel)


@pytest.mark.parametrize("B,precision,kernel,n", [
    (16, "f32", "fa", 1), (32, "f32", "fa", 1), (16, "f32", "uni", 1), (32, "f32", "uni", 1),
    (8, "f32", "fa", 1), (32, "high", "fa", 1), (16, "bf16", "uni", 1),
    (16, "f32", "bv", 1), (32, "high", "bv", 1), (16, "f32", "fderiv", 1),
    (32, "f32", "fderiv", 1), (32, "bf16", "fderiv", 1)])
def test_pass_launches_counts_what_each_factored_kernel_runs(B, precision, kernel, n):
    """Beside the refusals above, the launches of a pass it accepts: one on
    either tile, every kernel at every tier and radix (at radix 16 and 32
    the cluster tile, K4 and strict K1 too, whose fact_tile forms took a
    launch a channel group there, 2 at radix 16 and 4 at 32; fact_tile at
    radix 4 and 8 holds one group)."""
    assert lfk.pass_launches(B, precision, kernel) == n


# The (kernel, tier) pairs FORMS puts on fact_tile, by radix: where the A/B
# in turns measured fact_tile more than 2 % faster (PERF.md §6)
ON_FACT_TILE = {4: {("fa", "f32"), ("uni", "f32")},
                8: {("fa", "f32"), ("uni", "f32"), ("fa", "high"), ("uni", "high"),
                    ("uni", "bf16"), ("bv", "f32"), ("bv", "high"), ("bv", "bf16")}}


@pytest.mark.parametrize("kernel", ["fderiv", "fa", "uni", "bv"])
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("B", [4, 8, 16, 32])
def test_forms_table_names_a_built_tile_and_its_launches(B, precision, kernel):
    """FORMS names, for every factored kernel, tier and built radix, the one
    tile csrc/ builds that kernel on there (the C entries refuse the
    other): the cluster tile at radix 16 and 32 for every kernel and tier
    (K4 and strict K1 since they left fact_tile's channel groups), K1 at
    'high' and 'bf16' everywhere; at radix 4 and 8 fact_tile only where it
    won the A/B in turns by more than 2 % (ON_FACT_TILE;
    csrc/lenseflow_common.cuh::k3_on_tile .. k5_on_tile; strict K1 won it on
    the cluster tile, its only form). _forms sets the
    bit of each pass the cluster tile runs, each pass by its own radix."""
    on_tile = (kernel, precision) in ON_FACT_TILE.get(B, ())
    form = lfk.FORMS[kernel, precision, B]
    assert form == ("tile" if on_tile else "cluster")
    assert lfk.pass_launches(B, precision, kernel) == 1
    assert lfk._forms(kernel, precision, B, B) == (0 if on_tile else 3)
    assert lfk.FORMS[kernel, precision, 16] == "cluster"
    assert lfk._forms(kernel, precision, B, 16) == (not on_tile) + 2


def test_build_flags_carry_the_forms_table():
    """The build hands csrc/ the entries of FORMS at radix 4 and 8 of every
    factored kernel with two forms (csrc/lenseflow_common.cuh::k3_on_tile,
    k4_on_tile, k5_on_tile decode bit 2 tier + (radix == 8)): K4's mask
    beside K3's and K5's; K1, on the cluster tile alone, has none. The
    library's name changes with them."""
    from cmblensing_tpu_torch.ops import _build
    flags = dict(f[2:].split("=") for f in _build.form_flags())
    assert set(flags) == {"LF_FA_ON_TILE", "LF_BV_ON_TILE", "LF_UNI_ON_TILE"}
    assert all(lfk.FORMS["fderiv", p, B] == "cluster" for p in lfk.PRECISIONS
               for B in (4, 8, 16, 32))
    for kernel in ("fa", "bv", "uni"):
        mask = int(flags[f"LF_{kernel.upper()}_ON_TILE"])
        assert mask < 1 << 6
        for t, precision in enumerate(lfk.PRECISIONS):
            for B in (4, 8):
                on = mask >> (2 * t + (B == 8)) & 1
                assert on == (lfk.FORMS[kernel, precision, B] == "tile"), (kernel, precision, B)
    tag = _build._tag()
    saved = lfk.FORMS["fa", "bf16", 8]
    try:
        lfk.FORMS["fa", "bf16", 8] = "tile" if saved == "cluster" else "cluster"
        assert _build._tag() != tag
    finally:
        lfk.FORMS["fa", "bf16", 8] = saved


@pytest.mark.parametrize("key", [("bv", "f32", 4), ("bv", "high", 8), ("bv", "bf16", 8),
                                 ("fderiv", "f32", 4), ("fderiv", "f32", 8)])
def test_build_tag_follows_the_k1_and_k4_entries(key):
    """Flipping one of K4's entries of FORMS at radix 4 or 8 flips its bit
    in the flags handed to nvcc and renames the library, so that the other
    form is built and none of the old one is reused. Strict K1 has the
    cluster tile alone (its fact_tile form lost the A/B and went): an entry
    that names fact_tile for it is refused, by the flags and so the build."""
    from cmblensing_tpu_torch.ops import _build
    flags, tag = _build.form_flags(), _build._tag()
    saved = lfk.FORMS[key]
    try:
        lfk.FORMS[key] = "tile" if saved == "cluster" else "cluster"
        if key[0] == "fderiv":
            with pytest.raises(ValueError, match="K1"):
                _build._tag()
            return
        changed = [f for f in _build.form_flags() if f not in flags]
        assert len(changed) == 1 and changed[0].startswith(f"-DLF_{key[0].upper()}_ON_TILE=")
        assert _build._tag() != tag
    finally:
        lfk.FORMS[key] = saved
    assert _build._tag() == tag


class _Entry:
    """A C entry's stand-in: records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _fake_card(monkeypatch):
    """The launchers' checks of the card switched off, and a library whose
    entries record their arguments, so that the wrappers' host logic runs
    on CPU tensors."""
    from cmblensing_tpu_torch.ops import _build
    lib = type("Lib", (), {})()
    for name in ("lf_fderiv", "lf_bv_velocity", "lf_fa_velocity"):
        setattr(lib, name, _Entry())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(lfk, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(lfk, "_stream", lambda: None)
    lfk._OPERANDS.clear()
    return lib


@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("shape", [(512, 512), (1024, 2048), (2048, 1024)])
def test_k1_and_k4_launchers_hand_the_entries_each_pass_form(shape, precision, monkeypatch):
    """fvelocity_launcher hands lf_bv_velocity the `forms` bits of each pass
    (bit 0 the x pass, bit 1 the y pass, each by its own radix: the cluster
    tile at 16, FORMS's entry at 4 and 8) and the blocks of the tile each
    pass runs; fderiv_cuda hands lf_fderiv the cluster tile's blocks (its
    one form); both count one launch a pass."""
    lib = _fake_card(monkeypatch)
    Ny, Nx = shape
    ops = tderiv.deriv_ops(ct.ProjLambert(Ny, Nx, thetapix=2, T=np.float32, device="cpu"))
    Bx, By = Nx // 128, Ny // 128
    forms = sum((lfk.FORMS["bv", precision, B] == "cluster") << axis
                for axis, B in enumerate((Bx, By)))
    y = torch.empty((1, 9, Ny, Nx))
    phi, pt = torch.empty((1, 5, Ny, Nx)), torch.empty((2, 1, Ny, Nx))
    lfk.reset_launches()
    lfk.fvelocity_launcher("backward", y, torch.empty_like(y), phi, pt, ops, 2, precision)(0.25)
    (args,) = lib.lf_bv_velocity.calls
    GX, GYT, _, _ = lfk._fops(ops, precision, forms)
    assert args[:2] == (lfk.PRECISIONS.index(precision), forms)
    assert [a.value for a in args[6:8]] == [GX.data_ptr(), GYT.data_ptr()]
    assert args[10:17] == (Bx, By, 1, 2, Ny, Nx, 0.25)
    assert lfk.LAUNCHES["bv_velocity" + ("" if precision == "f32" else "_" + precision)] == 2
    a = torch.empty((1, Ny, Nx))
    lfk.reset_launches()
    lfk.fderiv_cuda(a, a.clone(), None, torch.empty_like(a), ops, precision)
    (args,) = lib.lf_fderiv.calls
    assert args[0] == lfk.PRECISIONS.index(precision) and len(args) == 15
    GX, GYT, _, _ = lfk._fops(ops, precision, 3)
    assert [a_.value for a_ in args[5:7]] == [GX.data_ptr(), GYT.data_ptr()]
    assert lfk.LAUNCHES["fderiv" + ("" if precision == "f32" else "_" + precision)] == 2


@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
def test_fops_hands_each_pass_the_blocks_of_its_tile(precision):
    """_fops gives each pass the blocks its tile reads: strict, on either
    tile, the FP32 (B, A, A) blocks, contiguous, FX and the transposed y
    blocks as fact_tile takes them (the cluster tile's float4 reads along
    m are conflict-free unswizzled); at 'high' and 'bf16' fact_tile the
    split blocks (FXS, FYTS) or their heads, the cluster tile the swizzled
    split (FXW, FYTW), per pass as the forms' bits say."""
    ops = tderiv.deriv_ops(ct.ProjLambert(512, 512, thetapix=2, T=np.float32, device="cpu"))
    for forms in range(4):
        GX, GYT, bfx, bfy = lfk._fops(ops, precision, forms)
        assert bfx is ops.bfx and bfy is ops.bfy
        for axis, G in enumerate((GX, GYT)):
            if precision == "f32":
                want = ops.FX if axis == 0 else ops.FY.transpose(-1, -2)
                assert G.dtype == torch.float32 and G.shape == (4, 128, 128) and G.is_contiguous()
                assert torch.equal(G, want)
            elif forms >> axis & 1:
                assert G is (ops.FXW if axis == 0 else ops.FYTW)
            else:
                S = ops.FXS if axis == 0 else ops.FYTS
                assert torch.equal(G, S if precision == "high" else S[0])


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_kernel_backend_at_512_runs_factored_and_matches_plain(dtype, bound):
    """At 512^2 the 'kernel' backend routes through the factored flows
    (B = 4); on a Cphi-drawn phi and Cf-drawn f its apply and
    phi-gradient agree with the FFT 'plain' backend. In float64 the two
    are one operator (measured 2e-12). In float32 the apply is held to
    1e-4: the backends form grad/Hess phi in two ways whose float32
    values differ by ~1e-4 relative, and the apply inherits 4.6e-5 of
    it against float64 (plain 7.3e-5). The float32 gradient of this
    objective is ill-conditioned in any form (2e-3 from float64 here,
    kernel and plain alike), so it is compared in float64 only."""
    N = 512
    tp = ct.ProjLambert(N, N, thetapix=2, T=dtype, device="cpu")
    rng = np.random.default_rng(3)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(
        torch.as_tensor(rng.standard_normal((n, N, N)).astype(dtype)), ct.Basis(pol, "map"), tp)
    phi_f = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP)
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    f_f = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP)
    assert isinstance(tderiv.deriv_ops(tp), tfd.FactoredOps)
    out = {}
    for be in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(be):
            out[be] = [(ct.LenseFlow(phi_f, 2) @ f_f).arr]
            if dtype == np.float64:
                out[be].append(ct.fgrad(lambda p: ct.dot(ct.LenseFlow(p, 2) @ f_f, f_f))(phi_f).arr)
    for a, b in zip(out["kernel"], out["plain"]):
        assert rel(a.numpy(), b.numpy()) < bound


def test_factored_wrapper_rejects_devices_without_a_kernel():
    x = torch.empty((1, 2, 16, 16), device="meta")
    ops = tfd.FactoredOps(*(torch.empty((2, 8, 8), device="meta"),) * 2,
                          *(torch.empty((2, 2, 2), device="meta"),) * 2)
    with pytest.raises(ValueError, match="no LenseFlow kernel"):
        lfk.flow_apply(x, torch.empty((1, 5, 16, 16), device="meta"), ops, 0., 1., 1)


def test_swizzled_blocks_unpack_to_the_split_blocks():
    """The 'high' and 'bf16' kernels on the cluster tile (csrc/fact_sm90.cuh:
    K1, K3, K5) read the split blocks with each row's 8-element chunks
    permuted by the row index (swizzle_blocks; FactoredOps.FXW, FYTW, made
    by factored_ops): element m of row k sits at column m ^ 8 (k % 8), the
    map is its own inverse, so unpacking FXW / FYTW gives back FXS / FYTS
    exactly; the layout exists only for rows of whole 64-element groups
    (the kernels' A = 128)."""
    ops = tfd.factored_ops(ct.ProjLambert(512, 512, thetapix=2, T=np.float32, device="cpu"), 4, 4)
    k, m = torch.arange(128)[:, None], torch.arange(128)[None, :]
    moved = (m ^ (k % 8) * 8).expand(128, 128)
    for S, W in ((ops.FXS, ops.FXW), (ops.FYTS, ops.FYTW)):
        assert W.dtype == torch.bfloat16 and W.shape == S.shape == (2, 4, 128, 128)
        assert torch.equal(tfd.swizzle_blocks(W), S)
        assert torch.equal(W[..., k.expand(128, 128), moved], S)
        assert not torch.equal(W, S)
    small = tfd.factored_ops(ct.ProjLambert(64, 64, thetapix=2, T=np.float32, device="cpu"), 2, 2)
    assert small.FXW is None and small.FYTW is None and small.FXS is not None
    with pytest.raises(ValueError, match="multiple of 64"):
        tfd.swizzle_blocks(small.FXS)
