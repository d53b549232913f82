"""The one traffic generator: what a cell's workload file asks for, made
from the seed.

A workload file (``portbench/workloads/<cell>.json``) holds:

* ``config``: the configuration it runs (its file gives the precision,
  the entry and the ranks);
* ``n``: the transform length, a power of two;
* ``batch``: transforms a call (rows of the planes; 1 for one signal);
* ``step``: the calls of one step, ``["forward"]``, ``["inverse"]`` or
  ``["forward", "inverse"]`` (a round trip, the inverse on the forward's
  output);
* ``ranks``: processes, one a card, that share one transform (1: each
  call is a single-device call);
* ``input``: ``"normal"``: re and im standard normal, or, where the
  configuration's entry is ``"real"``, one real plane of standard normal
  samples (the same draw as a complex input's re);
* ``fingerprint``: points of every step's outputs kept for the check.

A real entry's forward is an R2C, whose output is the n/2 + 1 bins of each
row, and its inverse a C2R, whose output is the n reals again.

The cell is a closed loop with one caller: each step runs ``step`` on the
input made once from the seed, and ends in a synchronise. Every seed gives
the same sizes and the same calls; only the values differ.
"""

from __future__ import annotations

import numpy as np

STEPS = (("forward",), ("inverse",), ("forward", "inverse"))
KEYS = {"config", "n", "batch", "step", "ranks", "input", "fingerprint"}


def check(traffic: dict, name: str) -> dict:
    """The workload file's fields, checked."""
    if set(traffic) != KEYS:
        raise ValueError(f"workload {name}: keys {sorted(traffic)}, want {sorted(KEYS)}")
    n, batch, ranks = traffic["n"], traffic["batch"], traffic["ranks"]
    if n < 2 or n & (n - 1):
        raise ValueError(f"workload {name}: n = {n} is not a power of two >= 2")
    if tuple(traffic["step"]) not in STEPS:
        raise ValueError(f"workload {name}: step {traffic['step']} not one of {STEPS}")
    if ranks < 1 or ranks & (ranks - 1) or (ranks > 1 and batch != 1):
        raise ValueError(f"workload {name}: {ranks} ranks share one transform of batch 1")
    if traffic["input"] != "normal":
        raise ValueError(f"workload {name}: input {traffic['input']!r} is not 'normal'")
    if not 1 <= traffic["fingerprint"] <= 4096:
        raise ValueError(f"workload {name}: fingerprint of 1..4096 points")
    return traffic


def derived_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for a torch generator, from the run's seed (any whole
    number, also past 32 bits) and ``parts`` (the rank, a stream)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *parts]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def local_shape(traffic: dict) -> tuple:
    """The shape of one process's planes: (batch, n), (n,) for one signal,
    (n / ranks,) for its shard of a shared one."""
    n, batch, ranks = traffic["n"], traffic["batch"], traffic["ranks"]
    if ranks > 1:
        return (n // ranks,)
    return (n,) if batch == 1 else (batch, n)


def make_input(traffic: dict, seed: int, rank: int, dtype, device, real: bool = False):
    """This process's input planes, drawn on ``device`` from the seed in
    two calls (``real``: one plane, the first call's); the shards of all
    ranks together are the whole signal."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, rank, 0))
    shape = local_shape(traffic)
    xr = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if real:
        return (xr,)
    xi = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return xr, xi


def output_sizes(traffic: dict, real: bool = False) -> list:
    """Points of each plane of each call's output in this process, in the
    order of ``step``: the input's for a complex call, the n/2 + 1 bins of
    each row after an R2C and the n reals after a C2R."""
    size = int(np.prod(local_shape(traffic)))
    if not real:
        return [size for _ in traffic["step"]]
    rows = size // traffic["n"]
    return [rows * (traffic["n"] // 2 + 1) if call == "forward" else size
            for call in traffic["step"]]


def fingerprint_index(traffic: dict, seed: int, rank: int, device, real: bool = False) -> list:
    """For each call of the step, flat indices into its output planes whose
    values every step keeps, drawn from the seed over that output's own
    size (sorted, distinct; the same count for every call)."""
    import torch

    sizes = output_sizes(traffic, real)
    k = min(traffic["fingerprint"], *sizes)
    out = []
    for size in sizes:
        rng = np.random.default_rng([int(seed) % (1 << 64), rank, 1])
        idx = np.sort(rng.choice(size, size=k, replace=False))
        out.append(torch.from_numpy(idx.astype(np.int64)).to(device))
    return out


def points_per_step(traffic: dict) -> int:
    """Points transformed by all ranks in one step: each call counts
    batch * n, complex points of a C2C or real samples of an R2C / C2R."""
    return len(traffic["step"]) * traffic["batch"] * traffic["n"]
