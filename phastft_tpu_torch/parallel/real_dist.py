"""Distributed R2C / C2R: the real transform of one signal split over the
ranks of a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/real_dist.py``: the half-length
trick (``ops/r2c.py``) around the distributed four-step
(``parallel/fourstep_dist.py``), with the same checks and messages.

Layout (d ranks, H = n/2, L = H/d). Rank r holds the contiguous n/d reals
[r n/d, (r+1) n/d) of the signal, so its deinterleave is local: its even /
odd values are the half-length input's points [rL, (r+1)L). The forward
returns rank r's bins [rL, (r+1)L) of the compact spectrum, and the last
rank also bin H (L + 1 bins); ``c2r_fft_distributed`` takes the spectrum in
the same layout and returns each rank's n/d reals. (The JAX package returns
one global array sharded over its mesh.)

The mirror crosses ranks. Bin k = rL + j pairs with z[H - k]: for j >= 1
that is rank d-1-r's point L - j, and for j = 0 the first point of rank d-r
(for r = 0, z[0] itself in the forward, the last rank's bin H in the
inverse). So each rank swaps its shard with its partner d-1-r and one
element with rank d-r (one ``batch_isend_irecv``; a rank that is its own
peer copies nothing), never gathering z, and runs ``untangle`` /
``pre_untangle`` in their mirror form (one bin a thread, the partner's shard
as the mirror; one device runs the paired kernel), both directions on the
planner's quarter table. The inverse's half-length transform is the forward on swapped
planes, unscaled, and the 2/n scale is folded into ``interleave_scale``.
Every check precedes the first collective and fails alike on every rank.
An inner planner built on ``Options(use_pallas=False)`` runs the four
passes and the half-length transform on their plain versions
(``ops/route.PLAIN``), as the JAX package follows its ``use_pallas``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..errors import LengthMismatchError, NonPowerOfTwoError, ensure_power_of_two
from ..fft import _as_tensor
from ..ops.route import passes_for
from ..planner import Direction
from ..tracing import traced
from .fourstep_dist import _layout, fft_distributed

__all__ = ["r2c_fft_distributed", "c2r_fft_distributed"]


def _check_r2c_size(n: int, d: int):
    ensure_power_of_two(n)
    if n < 4:
        raise NonPowerOfTwoError(
            f"R2C requires n to be a power of 2 and n >= 4, got {n}"
        )
    if n // 2 < 4 * d * d:
        raise NonPowerOfTwoError(
            f"n=2^{n.bit_length() - 1} too small to shard the half-length "
            f"transform over {d} devices"
        )


def _world(group):
    d = dist.get_world_size(group)
    if d & (d - 1):
        raise NonPowerOfTwoError(
            f"the group must have a power-of-2 size, got {d} ranks")
    return d, dist.get_rank(group)


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _mirror(a_re, a_im, length: int, rank: int, d: int, group, inverse: bool):
    """(p_re, p_im, w_re, w_im) of this rank's bins: the partner's shard
    (rank d-1-r, L values, or L + 1 from the last rank in the inverse) and
    the wrap element (the first value of rank d-r; for rank 0 its own first
    value in the forward, the last rank's bin H in the inverse)."""
    send = torch.stack((a_re, a_im))
    partner = d - 1 - rank
    ops = []
    if partner == rank:
        recv = send
    else:
        plen = length + int(inverse and partner == d - 1)
        recv = torch.empty((2, plen), dtype=send.dtype, device=send.device)
        ops += [dist.P2POp(dist.isend, send, _peer(group, partner), group),
                dist.P2POp(dist.irecv, recv, _peer(group, partner), group)]
    wrap_peer = (d - rank) % d
    if rank == 0:
        wrap = recv[:, length] if inverse else send[:, 0]
    elif wrap_peer == rank:
        wrap = send[:, 0]
    else:
        wrap = torch.empty(2, dtype=send.dtype, device=send.device)
        ops += [dist.P2POp(dist.isend, send[:, 0].contiguous(), _peer(group, wrap_peer),
                           group),
                dist.P2POp(dist.irecv, wrap, _peer(group, wrap_peer), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv[0], recv[1], wrap[0], wrap[1]


@traced("phastft.dist")
def r2c_fft_distributed(signal, planner, *, group=None):
    """Distributed forward R2C of one length-n real signal over the ranks of
    ``group`` (the default process group when None). Every rank calls it
    with its contiguous shard of n/d reals (1-D, numpy or a tensor on the
    planner's device) and gets (spec_re, spec_im) of its bins [rL, (r+1)L)
    of the compact spectrum, L = n/(2d), the last rank L + 1 bins (with bin
    n/2).

    ``planner``: a ``PlannerR2c32`` / ``PlannerR2c64`` for n; its
    ``dit_planner`` runs the half-length ``fft_distributed`` in natural
    order. Raises ``LengthMismatchError`` when n differs from the
    planner's, ``NonPowerOfTwoError`` when n is not a power of two, below 4
    or n/2 < 4 d^2 (the JAX package's classes and messages), and what
    ``fft_distributed`` raises for the half-length shape, before any
    collective."""
    d, rank = _world(group)
    x = _as_tensor(signal, planner)
    if x.dim() != 1:
        raise ValueError(
            f"r2c_fft_distributed takes this rank's 1-D shard, got {tuple(x.shape)}")
    n = int(x.shape[0]) * d
    if planner.n != n:
        raise LengthMismatchError(
            f"planner is for size {planner.n} but input has size {n}"
        )
    _check_r2c_size(n, d)
    half = n // 2
    length = half // d
    _layout(half, d, planner.dit_planner, False)
    k = passes_for(planner.dit_planner.options.use_pallas is False)
    even, odd = k.deinterleave(x)
    z_re, z_im = fft_distributed(even, odd, Direction.Forward, planner.dit_planner,
                                 group=group)
    del even, odd
    mirror = _mirror(z_re, z_im, length, rank, d, group, False)
    return k.untangle(z_re, z_im, planner.twiddles_re, planner.twiddles_im, mirror,
                      k0=rank * length, half=half, nyquist=rank == d - 1)


@traced("phastft.dist")
def c2r_fft_distributed(spec_re, spec_im, planner, *, group=None):
    """Distributed inverse C2R: every rank passes its bins of the compact
    spectrum in ``r2c_fft_distributed``'s layout (L = n/(2d) bins, the last
    rank L + 1) and gets its contiguous n/d reals of the signal, scaled so
    that C2R(R2C(x)) == x. Raises as ``r2c_fft_distributed`` does, and
    ``LengthMismatchError`` for planes of two shapes or a shard of another
    length, before any collective."""
    d, rank = _world(group)
    a_re = _as_tensor(spec_re, planner)
    a_im = _as_tensor(spec_im, planner)
    if a_re.shape != a_im.shape:
        raise LengthMismatchError(
            f"spec_re and spec_im must be of equal length, got "
            f"{tuple(a_re.shape)} and {tuple(a_im.shape)}"
        )
    n = planner.n
    length = max(1, n // (2 * d))
    want = length + int(rank == d - 1)
    if a_re.dim() != 1 or int(a_re.shape[0]) != want:
        raise LengthMismatchError(
            f"spec must have length N/2 + 1 = {n // 2 + 1} over the ranks: "
            f"rank {rank} holds {want} bins, got {tuple(a_re.shape)}"
        )
    _check_r2c_size(n, d)
    half = n // 2
    _layout(half, d, planner.dit_planner, False)
    k = passes_for(planner.dit_planner.options.use_pallas is False)
    mirror = _mirror(a_re, a_im, length, rank, d, group, True)
    z_re, z_im = k.pre_untangle(a_re[:length], a_im[:length], planner.twiddles_re,
                                planner.twiddles_im, mirror, k0=rank * length, half=half)
    del mirror
    # swap trick: swap(IDFT(z)) = DFT(swap(z)) / H, the 1/H in the scale
    o_im, o_re = fft_distributed(z_im, z_re, Direction.Forward, planner.dit_planner,
                                 group=group)
    del z_re, z_im
    return k.interleave_scale(o_re, o_im, 2.0 / n)
