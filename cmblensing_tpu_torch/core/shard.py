"""An ensemble's batch axis split over the ranks of a mesh dimension.

The JAX package shards the sims or chains axis of a batched Field over a
device mesh and lets XLA insert the collectives: a stop test that reads
every entry (CG's, the strict re-check's, the line search's stall) sees
the whole batch. In the port each rank runs its own entries (SPMD): the
entry points that take ``mesh=`` (MAP_marg, muse, sample_joint) make a
`BatchShard` (parallel/mesh.py::batch_shard) and hand it, as `shard=`,
to what they call that draws or decides across the batch:

  * draws: the entry point draws the whole batch, as the unsharded run
    does, and keeps this rank's entries (`BatchShard.slice`), so that
    every rank's generator moves as the unsharded run's does and each
    entry gets the numbers it gets there (the result does not depend on
    the rank count);
  * `any_`, `all_`, `max_`, `sum_`: a per-entry reduction read on the
    host, reduced over the ranks;
  * `gather`: the whole batch of a per-entry tensor, on every rank.

With shard None each is the plain single-process reduction.
"""
from __future__ import annotations

import torch


class BatchShard:
    """Entries lo:lo + n of a batch of `total` on this rank; `reduce(t,
    op)` ('sum' or 'max') and `gather(t)` (concatenated along dim 0, in
    rank order) act over the ranks holding the other entries."""

    __slots__ = ("lo", "n", "total", "reduce", "gather")

    def __init__(self, lo, n, total, reduce, gather):
        self.lo, self.n, self.total = int(lo), int(n), int(total)
        self.reduce, self.gather = reduce, gather

    @property
    def entries(self):
        """This rank's entries of the whole batch, a slice."""
        return slice(self.lo, self.lo + self.n)

    def slice(self, x):
        """This rank's entries of a whole-batch tensor (or Field)."""
        if hasattr(x, "arr"):
            return type(x)(x.arr[self.entries], x.basis, x.proj)
        return x[self.entries]


def _reduced(shard, t, op):
    return t if shard is None else shard.reduce(t, op)


def any_(shard, flags) -> bool:
    """Whether any entry's flag is set, over every rank's entries."""
    t = torch.any(torch.as_tensor(flags)).to(torch.int32).reshape(1)
    return bool(_reduced(shard, t, "max")[0])


def all_(shard, flags) -> bool:
    return not any_(shard, ~torch.as_tensor(flags, dtype=torch.bool))


def max_(shard, x) -> float:
    """The largest entry of x over every rank's entries."""
    t = torch.max(torch.as_tensor(x)).reshape(1).to(torch.float64)
    return float(_reduced(shard, t, "max")[0])


def sum_(shard, x):
    """The sum of x's entries over every rank's entries (a 0-d tensor)."""
    return _reduced(shard, torch.sum(torch.as_tensor(x)).reshape(1), "sum")[0]


def gather(shard, x):
    """A per-entry tensor (leading axis this rank's entries) as the whole
    batch, on every rank."""
    return x if shard is None else shard.gather(x)
