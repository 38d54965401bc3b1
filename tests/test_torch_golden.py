"""The reference's golden values (tests/test_golden.py, tests/golden_values.json)
held on the port.

- `test_frozen_logpdf`: the logpdf of load_sim(thetapix=3, Nside=64, pol=P
  and I, seed=0), the dataset built by the JAX package on the CPU and
  carried across (`dataset_from_numpy`; JAX's threefry draws are not the
  port's), evaluated by the port at JAX's f and phi, against the frozen
  value at the JAX test's bound, 2e-3 |ref| + 1.
- `test_frozen_map_correlation` (slow): the port's MAP_joint on JAX's
  128^2 P dataset (8 steps, CG tol 1e-1 and at most 100 iterations, the
  port's "auto" default as JAX's), corr(phi_MAP, phi_true) above the frozen
  value less 0.02.
- `test_lensed_spectra_match_camb_anchor` (slow): scripts/make_golden.py's
  recipe on the port's own draws (load_sim at 256^2, seeds 0-3, pol I for
  T and P for E and B, LenseFlow nsteps 7, get_Cl in bins of 100 over
  [300, 2000]): the seeds' mean lensed band powers over CAMB's lensed
  theory, each bin within 0.25 of 1 and each spectrum's mean within 0.06
  (the bounds the JAX test holds its committed ratios to), computed by
  scripts/torch_lensed_anchor.py, which chip_smoke.py runs on the card.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from cmblensing_tpu.models.dataset import load_sim as j_load_sim

import cmblensing_tpu_torch as ct
from test_torch_ieb import carry_field, dataset_to_port

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_lensed_anchor as anchor  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_values.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def _carried(N, pol):
    """JAX's load_sim(thetapix=3, Nside=N, pol, seed=0) in the port: (ds,
    f, phi) on the CPU."""
    o = j_load_sim(thetapix=3, Nside=N, pol=pol, T=np.float32, seed=0)
    ds = dataset_to_port(o["ds"], dict(Ny=N, Nx=N, thetapix=3, T=np.float32))
    proj = ds.d.proj
    return ds, carry_field(o["f"], proj), carry_field(o["phi"], proj)


@pytest.mark.parametrize("pol,key", [("P", "logpdf_P_64"), ("I", "logpdf_I_64")])
def test_frozen_logpdf(golden, pol, key):
    ds, f, phi = _carried(64, pol)
    with torch.no_grad():
        lp = float(torch.sum(ds.logpdf(f=f, phi=phi)))
    ref = golden["frozen"][key]
    # f32 tolerance on a ~1e4-magnitude logpdf
    assert abs(lp - ref) < 2e-3 * abs(ref) + 1.0, (pol, lp, ref)


@pytest.mark.slow
def test_frozen_map_correlation(golden):
    ds, _, phi = _carried(128, "P")
    res = ct.MAP_joint(ds, nsteps=8, conjgrad_kwargs=dict(tol=1e-1, nsteps=100))
    pm = res["phi"].to(phi.basis)
    corr = float(ct.dot(pm, phi) / (ct.norm(pm) * ct.norm(phi)))
    ref = golden["frozen"]["map_corr_P_128"]
    assert corr > ref - 0.02, (corr, ref)


@pytest.mark.slow
def test_lensed_spectra_match_camb_anchor():
    ratios = anchor.ratios(device="cpu")
    assert set(ratios) == {"TT", "EE", "BB"}
    assert all(len(r) == len(anchor.LEDGES) - 1 for r in ratios.values())
    assert not anchor.misses(ratios)
