"""What the port's examples share: the device and the distributed backend
they run on, the fast lane's switch, the check each one ends with, and the
spawning of ranks for the parallel examples.

    CMBL_EXAMPLE_DEVICE   cuda (the default) or cpu
    CMBL_EXAMPLE_FAST     1: the small sizes of the CI lane
    CMBL_EXAMPLE_BACKEND  the ranks' backend: nccl on cuda, gloo on cpu by
                          default (NCCL refuses two ranks on one card: name
                          gloo to share one card)
    CMBL_EXAMPLE_RANKS    the number of ranks of examples 06 and 09 (2)
"""
import os
import socket
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

FAST = bool(int(os.environ.get("CMBL_EXAMPLE_FAST", "0")))


def device():
    """The device the example runs on: the CUDA card unless
    CMBL_EXAMPLE_DEVICE names another. Without a card, only an explicit
    cpu runs."""
    dev = os.environ.get("CMBL_EXAMPLE_DEVICE", "cuda")
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"CMBL_EXAMPLE_DEVICE={dev}, but there is no CUDA device: the "
                           "examples run on the card; set CMBL_EXAMPLE_DEVICE=cpu to run on "
                           "the CPU")
    return dev


def backend(dev):
    return os.environ.get("CMBL_EXAMPLE_BACKEND",
                          "nccl" if torch.device(dev).type == "cuda" else "gloo")


def generator(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def tmp_path(name):
    """`name` in the temporary directory (TMPDIR, else /tmp)."""
    return os.path.join(tempfile.gettempdir(), name)


def check(ok, what):
    """Print the check's verdict; exit with code 1 when it failed."""
    print(f"check: {what}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        sys.exit(1)


def spawn(fn, *args):
    """Run fn(rank, world, port, *args) on CMBL_EXAMPLE_RANKS ranks, each a
    process, which join a world at localhost:port; raises when a rank
    fails."""
    import torch.multiprocessing as mp
    world = int(os.environ.get("CMBL_EXAMPLE_RANKS", "2"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(fn, args=(world, port) + args, nprocs=world, join=True)


def join(rank, world, port, dev):
    """This rank's place in the world of `world` ranks at localhost:port,
    on `dev`'s backend; a rank on cuda takes the card its rank names, modulo
    the cards there are."""
    import cmblensing_tpu_torch as ct
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    ct.distributed_initialize(f"localhost:{port}", world, rank, backend=backend(dev))
