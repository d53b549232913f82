"""Distributed four-step FFT: one length-n f32 transform split over the
ranks of a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/fourstep_dist.py``
(``_build_distributed``), with the same factorization and layouts, so
that its permuted layout D[k1, k2] matches the JAX package's element for
element. Layout algebra (d ranks, n = n1 * n2, d | n1, d | n2):

  x split by rows of A[i1, i2] = x[i1*n2 + i2]     (rank r holds rows
                                                    [r*n1/d, (r+1)*n1/d))
  1. all_to_all row -> column shard: local (n1, n2/d)
  2+3. the column DFT over i1 and the twiddle W_n^(k1*i2) (i2 the global
       column) in one kernel, ``colfft``
  4. all_to_all column -> row shard, (n1/d, n2)
  5. the row DFTs over i2 (``ops/fourstep.fft_rows``, the planner's
     leaf kernels)
  6. natural order: all_to_all to (n1, n2/d) and the local transpose
     (``transpose2``); with ``permuted_output`` the rank returns its rows
     of D[k1, k2] instead.

``permuted_input`` consumes that D layout and returns natural order: the
row DFTs over k2, the twiddle W_n^(k1*m2) (plain torch from f64 angles, as
the JAX package's XLA pass), an all_to_all, the bare column DFT over k1
(``colfft_nocorr``) and an all_to_all back.

A collective is ``all_to_all_single`` on a contiguous copy permuted so that
the block for rank j is the j-th; every rank makes the same calls in the
same order. The JAX package splits the column block into chunks (4 from
8 MiB) so that XLA overlaps one chunk's all_to_all with the next chunk's
compute; the layout is the same for any chunk count. The port runs one
chunk: its collectives do not overlap its kernels yet, and chunks without
overlap only add launches and copies (ROADMAP.md Queue 1 item 19).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..errors import NonPowerOfTwoError, ensure_power_of_two, not_ported
from ..fft import _as_tensor, _coerce_direction
from ..ops.colfft import MAX_N1, MIN_KERNEL_N2, colfft, colfft_nocorr
from ..ops.fourstep import fft_rows, plan_rows
from ..ops.transpose import transpose2
from ..planner import Direction

__all__ = ["fft_distributed"]


def _factor(n: int, d: int, leaf_limit: int) -> tuple[int, int]:
    """n = n1 * n2 with d | n1, d | n2, n2 at most the leaf limit and n1 as
    small as possible (the JAX package's ``_factor``)."""
    log_n = n.bit_length() - 1
    log_d = d.bit_length() - 1
    log_leaf = leaf_limit.bit_length() - 1
    log_n2 = min(log_leaf, log_n - log_d)
    log_n1 = log_n - log_n2
    if log_n1 < log_d or log_n2 < log_d:
        raise NonPowerOfTwoError(
            f"n=2^{log_n} too small to shard over {d} devices "
            f"(need n >= {d * d})"
        )
    return 1 << log_n1, 1 << log_n2


def _all_to_all(blocks, group):
    """Block j of ``blocks`` (d, ...) to rank j; returns (d, ...) with
    block s from rank s."""
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return out


def _row_to_col(x, n1: int, cols: int, d: int, group):
    """(n1/d, cols) row shard -> (n1, cols/d) column shard: row
    s*n1/d + r is rank s's row r, the columns this rank's block."""
    blocks = x.reshape(n1 // d, d, cols // d).transpose(0, 1).contiguous()
    return _all_to_all(blocks, group).reshape(n1, cols // d)


def _col_to_row(x, n1: int, d: int, group):
    """(n1, c) column shard -> (d, n1/d, c): block s is this rank's rows
    of rank s's c columns."""
    return _all_to_all(x.reshape(d, n1 // d, x.shape[-1]), group)


def _columns(re, im, n1: int, col_base: int, n: int, bare: bool):
    """The column pass of this rank's block: ``colfft`` with the twiddle of
    the block's global columns from ``col_base``, or the bare
    ``colfft_nocorr``; n1 = 1 is a copy (its only twiddle is W^0)."""
    if n1 == 1:
        return re.clone(), im.clone()
    if bare:
        return colfft_nocorr(re, im, n1)
    return colfft(re, im, None, n1, n_total=n, col_base=col_base)


def _natural(re_l, im_l, n, n1, n2, d, rank, group, row_plan, corrs,
             leaf_kernel, permuted_output):
    """Steps 1-6 on this rank's (n1/d, n2) rows; returns its flat shard."""
    local_cols = n2 // d
    t_re, t_im = _columns(_row_to_col(re_l, n1, n2, d, group),
                          _row_to_col(im_l, n1, n2, d, group),
                          n1, rank * local_cols, n, False)
    # (d, n1/d, n2/d) -> (n1/d, d, n2/d): global column s*n2/d + j
    r_re = _col_to_row(t_re, n1, d, group).transpose(0, 1).reshape(n1 // d, n2)
    r_im = _col_to_row(t_im, n1, d, group).transpose(0, 1).reshape(n1 // d, n2)
    del t_re, t_im
    d_re, d_im = fft_rows(r_re, r_im, row_plan, corrs, leaf_kernel)
    del r_re, r_im
    if permuted_output:
        return d_re.reshape(-1), d_im.reshape(-1)
    # D[k1, k2] -> (n1, n2/d) holding this rank's k2 block -> (n2/d, n1)
    o_re, o_im = transpose2(_row_to_col(d_re, n1, n2, d, group),
                            _row_to_col(d_im, n1, n2, d, group))
    return o_re.reshape(-1), o_im.reshape(-1)


def _permuted_in(re_l, im_l, n, n1, n2, d, rank, group, row_plan, corrs,
                 leaf_kernel):
    """The mirrored pipeline on this rank's rows of D[k1, k2]; returns its
    flat shard in natural order."""
    rows = n1 // d
    r_re, r_im = fft_rows(re_l, im_l, row_plan, corrs, leaf_kernel)
    dev = re_l.device
    k1 = torch.arange(rank * rows, (rank + 1) * rows, dtype=torch.float64,
                      device=dev)[:, None]
    m2 = torch.arange(n2, dtype=torch.float64, device=dev)[None, :]
    ang = (-2.0 * np.pi) * ((k1 * m2) * (1.0 / float(n)))
    cr, ci = torch.cos(ang).float(), torch.sin(ang).float()
    del ang
    t_re = r_re * cr - r_im * ci
    t_im = r_re * ci + r_im * cr
    del cr, ci, r_re, r_im
    z_re, z_im = _columns(_row_to_col(t_re, n1, n2, d, group),
                          _row_to_col(t_im, n1, n2, d, group), n1, 0, n, True)
    del t_re, t_im
    # block s holds this rank's rows of columns [s*n2/d, (s+1)*n2/d)
    out_re = _col_to_row(z_re, n1, d, group).transpose(0, 1).reshape(-1)
    out_im = _col_to_row(z_im, n1, d, group).transpose(0, 1).reshape(-1)
    return out_re, out_im


def fft_distributed(reals, imags, direction, planner, *, group=None,
                    permuted_output: bool = False,
                    permuted_input: bool = False):
    """Distributed f32 C2C FFT of one length-n transform split over the
    ranks of ``group`` (the default process group when None), n = d times
    the local length. Every rank calls it with its contiguous shard of n/d
    points (1-D, numpy or a tensor on the planner's device) and gets its
    shard of the result: natural order, or with ``permuted_output`` its
    rows of the digit-permuted D[k1, k2] (one all_to_all fewer);
    ``permuted_input`` consumes that layout from a permuted forward on the
    same group and planner and returns natural order. The flags are
    mutually exclusive. ``planner`` is a ``PlannerDit32`` for n; its
    ``leaf_fft_size`` fixes the factorization and its ``leaf_kernel`` the
    row kernels. The inverse scales by 1/n, through the swap trick.

    Raises ``NonPowerOfTwoError`` when n is not a power of two, differs from
    the planner's or is below d^2 (the JAX package's classes), and
    ``NotImplementedError`` for an f64 planner and for a column factor
    n1 > 2048, naming their ROADMAP.md items; every check precedes the
    first collective and fails alike on every rank."""
    direction = _coerce_direction(direction)
    if permuted_input and permuted_output:
        raise ValueError(
            "permuted_input and permuted_output are mutually exclusive"
        )
    if planner.dtype == np.float64:
        engine = planner.options.f64_engine or "native"
        raise not_ported(f"fft_distributed with f64_engine={engine!r}",
                         "dist_f64")
    d = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if d & (d - 1):
        raise NonPowerOfTwoError(
            f"the group must have a power-of-2 size, got {d} ranks")
    re_l = _as_tensor(reals, planner)
    im_l = _as_tensor(imags, planner)
    if re_l.dim() != 1 or re_l.shape != im_l.shape:
        raise ValueError(
            f"fft_distributed takes this rank's 1-D shard of reals and "
            f"imags, got {tuple(re_l.shape)} and {tuple(im_l.shape)}")
    n = int(re_l.shape[0]) * d
    ensure_power_of_two(n)
    if planner.n != n:
        raise NonPowerOfTwoError(
            f"planner is for size {planner.n} but input has size {n}"
        )
    leaf_limit = planner.options.leaf_fft_size
    n1, n2 = _factor(n, d, leaf_limit)
    if n1 > MAX_N1:
        raise not_ported(
            f"fft_distributed with a column factor n1 = {n1} (n = 2^"
            f"{n.bit_length() - 1} over {d} ranks, leaf {leaf_limit})",
            "dist_col")
    # both branches run their column pass on blocks of n2/d columns
    if re_l.is_cuda and n1 > 1 and n2 // d < MIN_KERNEL_N2:
        raise not_ported(
            f"fft_distributed with column blocks of {n2 // d} "
            f"columns (n = 2^{n.bit_length() - 1} over {d} ranks)", "dist_col")
    row_plan = plan_rows(n2, leaf_limit)
    leaf_kernel = planner.options.leaf_kernel
    corrs = planner.tables_for(row_plan, leaf_kernel)
    scale = direction is Direction.Reverse
    if scale:  # IFFT swap trick: swap(IDFT(z)) = (1/N) DFT(swap(z))
        re_l, im_l = im_l, re_l
    view = (n1 // d, n2)
    if permuted_input:
        out_re, out_im = _permuted_in(re_l.view(view), im_l.view(view), n, n1,
                                      n2, d, rank, group, row_plan, corrs,
                                      leaf_kernel)
    else:
        out_re, out_im = _natural(re_l.view(view), im_l.view(view), n, n1, n2,
                                  d, rank, group, row_plan, corrs, leaf_kernel,
                                  permuted_output)
    if scale:
        out_re.mul_(1.0 / n)
        out_im.mul_(1.0 / n)
        return out_im, out_re
    return out_re, out_im
