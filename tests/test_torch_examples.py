"""The port's examples (examples/torch/01_lense_a_map.py ... 09_bigmap.py),
each run as a user runs it, in a subprocess, on the CPU
(CMBL_EXAMPLE_DEVICE=cpu) at the JAX examples' fast-lane sizes
(CMBL_EXAMPLE_FAST=1): each must exit 0, which it does only when the check
it ends with passes. Examples 06 and 09 start their two gloo ranks
themselves. Without a card and without an explicit cpu, every example
raises before it computes anything. The examples import neither jax nor
the JAX package."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
EXAMPLES = [
    "01_lense_a_map.py",
    "02_posterior.py",
    "03_joint_MAP.py",
    "04_field_basics.py",
    "05_sampling.py",
    "06_multichip.py",
    "07_muse.py",
    "08_equirect.py",
    "09_bigmap.py",
]
# each example's own limit; the slowest, 03, takes about 30 s on 8 cores
TIMEOUT_S = 180


def _run(name, device):
    """The example in a subprocess at the fast lane's sizes, on `device`
    (None: CMBL_EXAMPLE_DEVICE unset), two threads a process (the suite
    runs several test files at once)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", CMBL_EXAMPLE_FAST="1")
    env.pop("CMBL_EXAMPLE_DEVICE", None)
    if device is not None:
        env["CMBL_EXAMPLE_DEVICE"] = device
    return subprocess.run([sys.executable, os.path.join(EXAMPLES_DIR, name)], cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S, env=env)


def test_one_example_for_each_of_the_jax_package():
    jax_examples = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                          if f.endswith(".py"))
    assert jax_examples == EXAMPLES
    assert sorted(f for f in os.listdir(EXAMPLES_DIR) if f[:2].isdigit()) == EXAMPLES


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
    r = _run(name, "cpu")
    assert r.returncode == 0, f"{name}:\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}"
    assert "check:" in r.stdout and "FAILED" not in r.stdout, r.stdout[-2000:]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_raises(name):
    r = _run(name, None)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "CMBL_EXAMPLE_DEVICE=cpu" in r.stderr, r.stderr[-2000:]
    assert "check:" not in r.stdout


def test_examples_import_no_jax():
    """No example, nor their shared module, imports jax or the JAX
    package (cmblensing_tpu); they import the port."""
    for name in EXAMPLES + ["_example.py"]:
        with open(os.path.join(EXAMPLES_DIR, name)) as fh:
            tree = ast.parse(fh.read())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
        bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "cmblensing_tpu")]
        assert not bad, (name, bad)
        if name != "_example.py":
            assert any(m.split(".")[0] == "cmblensing_tpu_torch" for m in mods), name
