#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``phastft_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It prints one JSON line per phase and fails (non-zero exit, no final line)
on any failed check:

1. ``device``: the card, and its name and power limit from ``nvidia-smi``.
2. ``build``: builds the CUDA kernels from ``phastft_tpu_torch/csrc``, and
   prints the clusters of each cluster shape resident at once (the CUDA
   occupancy query; none may be 0: ``leaf``, ``leaf3``, ``ddleaf``,
   ``leaft`` at A = 8..128, ``colfft`` at n1 = 1024, 2048 in its three
   modes, ``col64`` at n1 = 1024, 2048 (8-block clusters), ``ddcol`` and
   ``ddcol_nocorr`` at n1 = 1024, 2048, ``ozleaft`` at A = 8..64,
   ``hybrid`` at n1 = 128..1024 (2..16 blocks), and ``ozcol``'s blocks per
   SM), the ``-Xptxas -v`` lines of
   the two oz kernels and of ``ddcol``, and the FP32 issue rate of the dd
   bounds.
3. ``parity``: each kernel against its plain torch version on the card, at
   the slice's shapes (n1, n2) = (128, 8192), (1024, 16384), (2048, 16384),
   (128, 1024), (128, 2048), (256, 16384), at a batch of 32 of (128, 16384),
   the inner level of a 2^26 nested plan, and at batches of 3 of (128, 4096)
   and (512, 16384), rel L2 <= 1e-6.
4. ``e2e``: the split plans' main path through the public entries, launch
   counters set to 0 just before and read just after: ``fft_32_dit``
   forward at 2^17, 2^19, 2^20, 2^24 and 2^25 against numpy's f64 FFT (rel L2 <= 5e-7 *
   max(1, log2(n)/18)), a round trip at 2^24 (<= 1e-6), one
   ``PlannerDit32`` reused on a (4, 2^22) batch, and 2^20 on planes that
   are views 4 bytes past a 16-byte boundary. Each transform must launch
   each two-pass kernel exactly once, and no leaf kernel.
5. ``times``: device-time medians of 20 calls (CUDA events, the GPU kept
   busy until the call is enqueued), L2 flushed before each, at 2^17, 2^20,
   2^24 and 2^25: each kernel, its plain version, the whole transform (and
   its host-clock time), and ``torch.fft.fft`` on complex64 as a yardstick
   (the port never calls it), beside each kernel's memory bound; at 2^25
   also the other route for the row work, ``leaf`` on the 2048 rows of 2^14
   then ``transpose2``, beside ``leaft``.
6. ``parity_leaf``: the leaf kernels against their plain versions on 257
   rows (an odd count): ``leaf`` at n = 2, 64, 128, 256, 4096, 2^13, 2^14,
   2^15, ``leaf3`` at 2^16, ``leaf3`` on 1 and 50 rows and ``leaf``'s
   cluster shapes (2^14, 2^15) on 1 row and on one more row than their
   resident clusters (a ragged last wave), rel L2 <= 1e-6.
7. ``e2e_leaf``: the leaf plans' main path, counters set to 0 just before
   and read just after: ``fft_32_dit`` forward at every n = 2^0..2^16 with
   max(1, 2^20/n) rows against numpy's f64 FFT, a round trip at 2^16 x 16
   rows, one ``PlannerDit32(2^12)`` reused on a (1024, 4096) batch, and
   2^17 rows of 256 points. Each transform with n >= 2 must launch exactly
   one of ``leaf``/``leaf3`` and nothing else; n = 1 launches nothing.
8. ``times_leaf``: as 5, at n = 2^8, 2^10, 2^12, 2^13, 2^14, 2^15, 2^16
   with 2^27/n rows (1 GiB of planar input), and at 2^16 x 1 row for
   latency; the library call is ``torch.fft.fft`` on complex64 of the same
   rows.

9. ``parity_nested``: ``colfft`` against ``colfft_plain`` at (n1, n2) =
   (32, 2^21), (128, 2^21), (256, 2^21), (512, 2^21) (the outer levels of
   2^26 and 2^28..2^30), (2, 2^16), (4, 2^16), (8, 2^16), (64, 2^16),
   (2048, 2^14) and batches of 3 at (128, 2^14), 3 at (16, 2^16) and 5 at
   (2, 2^16) (the classic plans' shapes), rel L2 <= 1e-6; ``transpose2``
   against ``transpose2_plain`` at (32, 2^21), (2, 2^16), (2048, 2^16), the
   same three batches and a narrow (256, 8), bit for bit.
10. ``e2e_nested``: the nested and classic plans' main path, counters set to
   0 just before and read just after, inputs made on the card from a seeded
   generator: ``fft_32_dit`` at 2^26 and 2^28 against an f64 FFT of the same
   input (rel L2 <= 5e-7 * max(1, log2(n)/18)), forward then inverse at 2^26
   (<= 1e-6) and the inverse of N * delta (exactly all ones: the scale is
   1/N), one ``PlannerDit32(2^26)`` reused on a (2, 2^26) batch, 2^30 once
   (256 output bins against a direct f64 DFT with integer phases, a round
   trip, and the peak of allocated device memory), and the classic one-level
   plans of ``Options(leaf_fft_size=2^16)`` at 2^20 (n1 = 16) and 2^17
   (n1 = 2). A nested transform must launch ``colfft``, ``colfft_out3d``,
   ``leaft`` and ``transpose2`` once each; a classic one ``colfft``, one
   leaf kernel and ``transpose2`` once each.
11. ``times_nested``: as 5 with 10 calls, at 2^26 and 2^28 (and the whole
   transform at 2^30, 5 calls): ``colfft`` and ``transpose2`` alone, their
   plain versions, the inner level's two kernels on the outer level's rows
   as one batch, the whole transform (device and host clock),
   ``torch.fft.fft`` on complex64, and ``x.transpose(-1, -2).contiguous()``
   on both planes as the library call for ``transpose2``; then ``colfft``
   alone at the outer levels of 2^29 and 2^30, (256, 2^21) and (512, 2^21),
   and ``colfft_out3d`` at the fused 2^22 and 2^23 plans' (256, 2^14) and
   (512, 2^14), each beside its bound.

12. ``dd_exact``: TwoSum and TwoProd as the dd kernels' ``csrc/dd.cuh``
   computes them, on 2^20 random pairs: s + e = a + b and p + e = a * b
   with a residual of exactly 0 in f64.
13. ``parity_dd``: the dd (double-float) kernels against their plain
   versions on joined f64 values (hi + lo), rel L2 <= 1e-13: ``ddcol`` at
   (n1, n2) = (256, 2^16), 2 x (64, 2^16), (2048, 2^16), (1024, 2^16) (the
   cluster shapes), (512, 2^16), 5 x (2, 2^13), the split leaf's
   4096 x (64, 128) and 256 x (512, 128), and 3 x (2, 128) (several entries
   per block); ``ddcol_nocorr`` at 4096 x (128, 64), 256 x (128, 512) and
   5 x (128, 2); both at n1 = 1024 and 2048 on one more entry than their
   clusters resident at once (``ddcol`` (n1, 128), ``ddcol_nocorr``
   (n1, 32)); ``ddleaf`` at n1 = 1, 8, 64, 128, 256
   and 512 (several rows per block, and clusters of 2, 4, 8 and 16 blocks)
   with 1, 5 and 256 rows, the clusters also on one more row than are
   resident. The tables are those of a ``PlannerDit64``.
14. ``e2e_dd``: the df64 engine's main path, counters set to 0 just
   before and read just after, each transform's launches checked against
   its plan: ``fft_64_dit_with_planner`` on planners of the default leaf
   rule pinned to ``"df64"`` (the default engine is the native one up to
   2^25) at every n = 2^0..2^16 on 2^18 points against
   numpy's f64 FFT, at 2^20, 2^24, 2^27 and the nested plan of 2^28 against
   ``torch.fft.fft`` in complex128 on the card (rel L2 <= 1e-12), one
   ``PlannerDit64(2^22)`` reused on a (4, 2^22) batch, ``"df64-split"`` at
   2^13 x 64 rows, 2^10 x 5 rows (several entries per block of the column
   kernel) and at 2^24, forward then inverse at 2^24 (<= 1e-12), the
   inverse of N * delta (exactly ones), and the peak of allocated device
   memory at 2^27.
15. ``times_dd``: as 5 with 10 calls: ``ddcol`` at the 2^24..2^27 plans'
   split levels (n1 = 256..2048 over 2^16) and the outer level of 2^28
   (32 x 2^23), ``ddleaf`` at 2^16 x 256, 2^16 x 2048, 2^13 x 2^11 and 2^10 x 2^14
   (each beside the library call), the split
   leaf's two passes and its transposes at 2^16 x 256, each kernel's plain
   version at the smaller shape (3 calls), and the whole f64 transform at
   2^20, 2^24 and 2^27 (device and host clock) beside ``torch.fft.fft`` on
   complex128. The library call of ``ddleaf`` is ``torch.fft.fft`` of the
   same rows as one complex128 tensor, that of ``ddcol_nocorr``
   ``torch.fft.fft(dim=-2)``; ``ddcol`` fuses a twiddle and has none. The dd
   bounds are the larger of 32 B per element over the memory rate and the
   FP32 instructions the function needs over the card's issue rate (132 SMs
   x 128 lanes x the SM clock ``nvidia-smi`` reports; dd arithmetic is
   single adds and multiplies, so the FMA rate would count each twice),
   both printed (``bound_bytes_ms``, ``bound_instr_ms``): a DFT by radix-4
   decimation with the trivial twiddles dropped (``dd_dft_instr``, the
   schedule the dd kernels run; ``ddcol``'s long-column split adds one
   product per element between its factors) and 42 per dd complex product
   of a correction.

16. ``oz_exact``: the bf16 tensor-core product of ``csrc/oz.cuh`` alone on
   random integer slices |s| <= 128 (128 x 64 outputs), by the oz kernels'
   path (cp.async tiles, ldmatrix, wgmma accumulating in place): one slice
   pair at depths 32, 64, 128 and 512, and a tier's five pairs in one
   accumulator at depths 16..512, equal to the int64 product bit for bit.
17. ``parity_oz``: the Ozaki kernels against their plain versions on a
   ``PlannerDit64``'s tables, rel L2 <= 1e-13 on joined values (and whether
   they agree bit for bit): ``ozcol`` at (n1, n2) = (128, 8192), (2048,
   8192), (512, 2048), 3 x (256, 1024), 4 x (128, 8192) and (1024, 2048);
   ``ozleaft`` at
   A = 8, 16, 32, 64 and n1 = 128, 2048 on 3 entries, each also within 1e-10
   of an f64 FFT of the transform it ends.
18. ``e2e_oz``: the ``f64_engine="df64-oz"`` main path, counters set to 0
   just before and read just after: ``fft_64_dit_with_planner`` on
   ``Options(f64_engine="df64-oz", leaf_fft_size=2^13)`` at 2^20, 2^22, 2^24
   and the nested 2^26, on ``leaf_fft_size=2^10`` at 2^17, a (4, 2^20) batch
   on one planner, a round trip and the inverse at 2^24, each within 1e-10 of
   ``torch.fft`` in complex128; one ``ozcol`` and one ``ozleaft`` per
   transform (2^26: also one ``ddcol`` and two ``transpose2``), and a
   per-call ``"df64-oz"`` on a ``"df64"`` planner at 2^24 launching the df64
   kernels alone.
19. ``times_oz``: as 15 at 2^20 and 2^24: ``ozcol`` and ``ozleaft`` with
   their plain versions (3 calls) and bounds, the whole oz transform (device
   and host clock), the df64 transform and complex128 ``torch.fft.fft``;
   and both kernels on the inner level of the nested 2^26 plan (64 x (128,
   8192)) beside their bounds. The
   oz bound is the larger of 32 B per element plus the tables over the memory
   rate and the bf16 tensor-core flops of the JAX kernels' counts over
   989 TFLOP/s (``oz_bound``).

20. ``parity_hybrid``: the hybrid leaf against its plain version at n1 = 2,
   8, 64, 128, 256, 512, 1024 (one block, and clusters of 2, 4, 8, 16
   blocks) on 257 rows and on 1, rel L2 <= 1e-6.
21. ``e2e_hybrid``: the leaf plans with ``Options(leaf_kernel="hybrid")``,
   counters set to 0 just before and read just after: per call at every
   n = 2^8..2^17 on 2^20 points against numpy's f64 FFT (the leaf plans'
   bound; 2^17 on ``leaf_fft_size=2^17``), planners built with it at
   2^12 x 256 rows and at 2^17 x 4, the classic plans of
   ``leaf_fft_size=2^16`` at 2^20 and of ``leaf_fft_size=2^17`` at 2^24
   (``colfft``, ``hybrid``, ``transpose2``), an f32 R2C / C2R round trip
   at 2^18 on an inner planner of ``leaf_fft_size=2^17`` (against numpy's
   rfft and back, <= 1e-6), a round trip at 2^16 x 16 rows (<= 1e-6). Each
   leaf transform launches ``hybrid`` once and no ``leaf``/``leaf3``. The
   2^17 leaf, the 2^24 plan and the R2C / C2R on the same inputs without
   ``"hybrid"`` launch ``leaf3`` and no ``hybrid``.
22. ``times_hybrid``: as 8, on 2^27 points at n = 2^8, 2^12, 2^15, 2^16,
   2^17 (2^17: the default leaf kernel is ``leaf3`` at a = 256):
   ``hybrid`` beside its bound (``hybrid_bound``: the bytes or flops of a
   length-n DFT; beside it the time of the kernel's own 3xTF32 products at
   the TF32 tensor-core peak and of its F(n1) and correction at the f32
   peak), its plain
   version, the default leaf kernel on the same rows, ``torch.fft.fft`` on
   complex64, and the transform with and without the hybrid leaf.
23. ``parity_nocorr``: ``colfft_nocorr`` against its plain version at
   (2048, 4096), (32, 2^14), (2, 2^16), 3 x (128, 2^14), (1024, 2^14),
   3 x (2048, 4096), 2 x (2048, 16) and 3 x (1024, 8) (narrower than a
   cluster's slab), and ``colfft`` with ``n_total``/``col_base`` on shard
   blocks (2048, 4096) of 2^25, (32, 64) of 2^16, and (512, 16) and (2048, 8)
   (narrower than 32 columns), rel L2 <= 1e-6.
24. ``dist``: ``torch.distributed`` on NCCL at world size 1 (``nccl_world``:
   a ``file://`` store in the output directory), counters set to 0 just before and read
   just after, each transform's launches checked against its plan (one
   ``colfft`` or ``colfft_nocorr``, the row plan's leaf kernel,
   ``transpose2`` for natural output; the column pass once a chunk of the
   port's count, ``fourstep_dist.column_chunks``): ``fft_distributed`` at 2^19 (n1 = 128)
   and 2^25 (n1 = 2048, a 256 MiB local block) forward against
   an f64 FFT, ``permuted_output`` into a ``permuted_input`` inverse
   (<= 1e-6), a ``permuted_input`` forward of the permuted signal against
   the natural spectrum, the inverse of N * delta (exactly ones), and
   ``batch_fft_sharded`` on (8, 2^20).
25. ``times_dist``: ``colfft_nocorr`` at (2048, 2^14) and (1024, 2^14) beside its bound, its
   plain version and ``torch.fft.fft(dim=-2)`` on complex64; three times
   over, the whole ``fft_distributed`` at 2^25 beside
   ``fft_32_dit_with_planner`` at 2^25, each on the device clock with its
   enqueue covered (median, min, max of 10), on the host clock, and 20
   calls back to back; then a ``torch.profiler`` breakdown.

The native f64 engine's phases run between 19 and 20:

26. ``build_native`` / ``parity_native``: the clusters of ``leaf64``
   (2^13..2^16) and ``col64`` (n1 = 1024, 2048) resident at once (none may
   be 0); its three kernels against their plain versions on the card:
   ``leaf64`` at every n = 2..2^16 on 5 rows, below 2^13 on three blocks'
   rows and one, and at 2^13..2^16 on one row and on one more row than its
   clusters resident at once; ``col64`` at every column factor n1 = 2..512
   over n2 = 2^13 (batches of 1 and 3) and 64..512 over 2^16, at n1 = 1024
   and 2048 over 2^13 (batches of 1 and 3) and 2^16, at n2 = 16 (the
   one-block design) and on a ragged last wave: one more entry of 32 columns
   than its clusters resident at once at n1 = 1024 (one cluster an entry),
   and at 2048 (two an entry) one or two more clusters than resident, and
   on the nested plans' levels: (32, 2^23), 32 x (128, 2^16) and
   (128, 2^23) (2^30 points: ``col64_plain`` on each half
   of the columns, the input held on the host meanwhile); rel L2 <= 1e-13;
   ``transpose2_64`` at the same shapes, bit for bit.
27. ``e2e_native``: its main path, counters set to 0 just before and read
   just after, each transform's launches checked against its plan (one
   ``leaf64``; per split level one ``col64`` and one ``transpose2_64``
   around the inner plan; nothing else): ``fft_64_dit`` forward and back at
   every n = 2^0..2^29 against ``torch.fft.fft`` in complex128 on the card
   and the input (rel L2 <= 1e-12; at 2^29 also the direct f64 DFT's 256
   bins against complex128, and the port against both on them), at 2^30 on
   256 bins of a direct f64 DFT
   and a round trip (the input made again from its seed, so that no more
   than three 16 GiB pairs are held), a batch of 3 at 2^16 and 2^20 on one
   ``PlannerDit64``, an engine-less ``Options()`` planner at 2^20, a
   per-call ``"native"`` on a ``"df64"`` planner at 2^24, the inverse of
   N * delta at 2^25 (exactly ones), and the peak of allocated device
   memory at 2^25 and 2^30 (at 2^30 it fails past the input and two pairs).
28. ``race_native`` / ``times_native``: at 2^10 x 2^14 rows and every
   2^13, 2^16, 2^20, 2^22, 2^24..2^30, ``fft_64_dit_with_planner`` on the
   native planner, the ``"df64"`` one up to 2^28, the ``"df64-oz"`` one
   (2^20..2^24, ``leaf_fft_size=2^13``) and ``torch.fft.fft`` in complex128
   on the same data up to 2^29, device time and host clock (10 calls each),
   with the winner beside what ``Options.guess_options`` picks; then each
   kernel of the native plan on the shapes the transform gives it (every
   split level's ``col64`` and ``transpose2_64``, and the leaf), beside its
   bound (32 B per element and pass plus the tables, against 5 * log2(len)
   + 6 FP64 flops at 132 x 64 x 2 x ``clocks.max.sm``) and its library call
   (``torch.fft.fft`` of the same rows for ``leaf64``, at 2^30 only where
   the card holds it, else the reason; ``.transpose(-1, -2).contiguous()``
   of both planes for ``transpose2_64``; ``col64`` fuses a twiddle and has
   none), and at (256, 2^16) its plain
   version; then ``col64`` at (1024, 2^16) and (2048, 2^16) on its
   long-column (cluster) design and on a build of the same source with that
   design off (every shape one block; ``times_col64_designs``, both held to
   ``col64_plain``); then ``leaf64`` alone at every row length 2^1..2^16 on
   2^24 points (``times_native_rows``), beside its bound and complex128
   ``torch.fft.fft`` on the same rows.

The distributed four-step in f64 and past n1 = 2048 runs after 25, in the
same world of one rank:

29. ``parity_dist64``: ``col64`` on shard blocks with ``col64_shard_tables``
   (n, n1, ncols, col_base) = (2^25, 2048, 4096, 8192) and (2^22, 1024, 32,
   2016) (clusters), (2^20, 128, 2048, 6144) and (2^16, 64, 2, 510) (one
   block); ``col64_nocorr`` (its bare mode) at (2048, 2^16), 3 x (1024, 32)
   (clusters), 3 x (128, 4096), (2, 2^16) and 2 x (2048, 16) (one block);
   ``ddcol`` on ``dd_shard_tables`` of (2^20, 8, 2^15, 2^16); rel L2 <= 1e-13
   against the plain versions.
30. ``dist64``: counters set to 0 just before and read just after, each
   transform's launches checked against its plan: ``fft_distributed`` on the
   default ``PlannerDit64`` (native) at 2^20, 2^27 (n1 = 2048), 2^29 and 2^30
   (n1 = 2^13, 2^14: the long-column route) and on the default
   ``PlannerDit32`` at 2^27 and 2^30 (n1 = 2^13, 2^16), each forward against
   complex128 ``torch.fft.fft`` (at 2^30 on 256 direct bins), a
   ``permuted_output`` forward into a ``permuted_input`` inverse (the input
   made again from its seed), the ``permuted_input`` forward of the permuted
   signal (2^20, 2^27), the inverse of N * delta (exactly ones) and the peak
   of allocated device memory of the natural forward (at 2^30 it fails past
   the input and three pairs); df64 at 2^20 and 2^24, and ``"df64-oz"``
   (``leaf_fft_size=2^13``) at 2^20 and 2^24 (where its rows arm ``ozcol`` +
   ``ozleaft``), natural order, against complex128 (<= 1e-12, <= 1e-10).
31. ``times_dist64`` / ``times_long_columns``: ``col64_nocorr`` at (2048,
   2^16) beside its bound, its plain version, ``col64`` and complex128
   ``torch.fft.fft(dim=-2)``; the two routes for a column factor past 2048
   on the block of a world of one, the package's (the block transposed, the
   row plan of n1, the twiddle in torch, transposed back) and two column
   passes with the twiddles folded and two transposes, at f32 2^30 (256 x
   256) and f64 2^29 (64 x 128), held to each other; the whole f64
   ``fft_distributed`` at 2^27 and 2^30 beside ``fft_64_dit_with_planner``
   (medians of 5, min and max), with a ``torch.profiler`` breakdown split
   into NCCL's copies and the kernels; the f32 one at 2^30 beside
   ``fft_32_dit_with_planner``.

The real transforms run last, in the same world of one rank:

32. ``parity_r2c``: the four passes of ``csrc/r2c.cu`` (``deinterleave``,
   ``untangle``, ``pre_untangle``, ``interleave_scale``) against their plain
   versions in f32 and f64 at N = 4, 8, 2^16, 2^26 and on 257 rows of 2^12
   and 4 of 2^22, rel L2 <= 1e-6 (f32) and 1e-14 (f64), and whether they
   agree bit for bit; the one-device untangles' paired kernel in both its
   schedules (``parity_r2c_pair``: scalar and vector) on the quarter table,
   which must agree bit for bit; and the two untangles in the distributed
   real transforms' mirror form: z and the bins of 2^16, 2^26 and 257 rows of 2^12 cut into the
   shards of 2 and 4 ranks, each shard with its partner's as the mirror,
   its first bin and the wrap element as ``parallel/real_dist.py`` passes
   them, bit for bit with the plain versions on the same arguments, and
   the shards' outputs joined bit for bit with the one-device (paired)
   kernel's.
33. ``e2e_r2c``: the real transforms' main path, counters set to 0 just
   before and read just after: every R2C launches ``deinterleave`` and
   ``untangle`` exactly once, every C2R ``pre_untangle`` and
   ``interleave_scale`` once, and each some kernel of the half-length
   transform: ``r2c_fft_f32`` / ``r2c_fft_f64`` at 2^16, 2^20, 2^24, 2^26
   against numpy's f64 rfft (f32 5e-7 * max(1, log2(n)/18), f64 1e-12) and
   back (1e-6, 1e-12), a (4, 2^22) batch twice on one reused planner, f64
   at 2^29 (a nested inner plan) on 256 bins of ``dft_bins`` and a round
   trip, the ``"df64"`` and ``"df64-oz"`` inner planners at 2^24 (which
   must run ``ddcol``/``ddleaf`` and ``ozcol``/``ozleaft``), and
   ``r2c_fft_distributed`` / ``c2r_fft_distributed`` at 2^26 in both
   dtypes.
34. ``times_r2c``: at 2^26 each pass beside its bound (``r2c_bounds``: each
   input read once, each output written once; on one device the mirror is
   the input itself, and both untangles read only the quarter table; the
   bytes the paired kernel's loads and stores request are reported beside
   it, and each untangle's time in both schedules), its plain version (3
   calls) and, for ``deinterleave`` and ``interleave_scale``, one torch
   call computing the same function
   (``x.view(n/2, 2).movedim(-1, 0).contiguous()``, ``torch.stack``); at
   2^16, 2^20, 2^24, 2^26 (and f64 2^29) each whole transform through
   ``*_with_planner`` (device and host clock) beside ``torch.fft.rfft`` /
   ``irfft`` of the same dtype (a yardstick the port never calls) and the
   port's zero-imaginary C2C of n, forward and inverse.

Past 2^30 (ROADMAP item 16) last, in the same world of one rank
(``giant_phases``):

35. ``parity_giant``: the kernels of the 2^31 f32 plan at its shapes:
   ``colfft`` at the outer level (1024, 2^21) on its clusters against
   ``colfft_plain`` on three slices of 4096 columns (the first, middle and
   last, with their columns' twiddle), ``transpose2`` of its output on the
   matching rows bit for bit, and ``colfft_out3d`` / ``leaft`` on the inner
   level, 1024 entries of (128, 2^14), on entries 0, 512 and 1023, rel L2 <=
   1e-6; then ``times_giant`` for those four beside their bounds (and
   ``.transpose(-1, -2).contiguous()`` for ``transpose2``); then
   ``e2e_giant_leaf``: ``leaf`` on (2^17, 2^14), ``leaf3`` on (2^15, 2^16)
   f32 and ``leaf64`` on (2^15, 2^16) f64, 2^31 elements each, their first,
   middle and last four rows against complex128 ``torch.fft.fft`` and
   their plain versions, each timed beside ``torch.fft.fft`` of the same
   rows (complex64 / complex128; on half the rows where the card cannot
   hold the call).
36. ``e2e_giant``: the main path, counters set to 0 just before and read
   just after, each transform's launches checked against its plan:
   ``fft_32_dit_with_planner`` and ``fft_distributed`` (world size 1) at
   2^31 on 256 bins of ``dft_bins``, a round trip (<= 1e-6) and the inverse
   of N * delta (exactly ones); f32 R2C / C2R at 2^32 and f64 at 2^31 on 256
   bins, a round trip (the signal made again from its seed) and the C2R of
   N * delta, the C2R leaving the planner's full-length table unbuilt;
   the peak of allocated memory of each (the f32 C2C's may not pass 50
   GiB); then ``giant_tables``: the quarter table of 2^32 by numpy on the
   host against the card's build.
37. ``times_giant``: each whole transform, medians of 5, beside the bound
   of its passes and ``torch.fft.fft`` complex64 / ``torch.fft.rfft`` of
   the same data (the reason where the card cannot run one), and the real
   transforms' four passes at f32 2^32 beside their bounds (the untangles
   in both schedules).

38. ``edge_phases`` (the window's edges: every ``Options.leaf_fft_size``
   and every shard width; its seconds on the ``edge_phases`` line):
   ``parity_edges``, the four kernels that take the new shapes against
   their plain versions on the card: ``colfft`` at n1 = 16, 1024, 2048 and
   n2 = 1, 2, 4, 64 (classic mode on the planner's ``pcol{n1}x{n2}``, and
   the shard mode on the block of each of 4 ranks) and its bare mode at
   n2 = 1, 2 (rel L2 <= 1e-6); ``col64`` / ``col64_nocorr`` at n2 = 1 on
   the blocks of 4 ranks, ``ddcol`` at n2 = 1, 8, 64 and ``ddcol_nocorr``
   at n2 = 1 (<= 1e-13); ``leaf3`` at 2^17 on 2^10 rows (2^27 points), its
   first and last rows against ``leaf3_plain`` (<= 1e-6); then
   ``e2e_edges``, the main path through ``fft_32_dit_with_planner`` /
   ``fft_64_dit_with_planner``, counters set to 0 just before each
   transform and its launches checked against its plan: f32, native f64
   and df64 at 2^20 with ``leaf_fft_size`` = 1, 16, 64, and at 2^24 with
   2^17, 2^18, 2^20, 2^24 (at 2^24 the whole transform is one leaf of
   n1 = 2^17 on the long columns), each against complex128
   ``torch.fft.fft`` on the card (f32 <= 5e-7 * max(1, log2(n)/18), f64
   <= 1e-12), forward then inverse (f32 <= 1e-6, f64 <= 1e-12) and the
   inverse of N * delta (exactly ones); ``fft_distributed`` at world size
   1 with ``leaf_fft_size = 2^17`` (f32 2^24: the shard's rows on ``leaf3``
   at a = 256), and with leaves of 2 (f32) and 1 (f64) at 2^20: blocks of
   two and one columns, natural order against the oracle and a
   ``permuted_output`` forward into a ``permuted_input`` inverse; then
   ``times_edges``: each new shape's kernel
   time beside its bound (``kernel_bound`` / ``native_bound`` /
   ``ddcol_bound``), its plain version and, where one call computes the
   same function, that call (``torch.fft.fft`` of the 2^17 rows for
   ``leaf3``, ``torch.fft.fft(dim=-2)`` for the bare column passes), and
   each transform beside ``torch.fft.fft``.
39. ``tune`` (``PlannerMode.Tune``, ROADMAP item 8; ``tune_phases`` prints
   its seconds): with ``PHASTFT_TPU_TUNE_CACHE`` set to a fresh temporary
   directory (removed at the end), f64 C2C 2^20, f32 and f64 C2C 2^24 and
   f32 R2C 2^26 are tuned: every candidate's device ms as Tune measured it
   (``tune._measure`` / ``_measure_r2c`` wrapped), the winner, the
   heuristic's options and its time in the race, Tune's wall seconds; the
   tuned and the heuristic transform timed in turns (tuned, heuristic,
   twice; the tuned one may take at most 1.05x), the tuned forward against
   the card's complex128 oracle (``rfft`` for the R2C) and its round trip
   (PERF.md section 2's bounds), the kernels it launched (counters read
   around one forward), and after ``clear_tune_cache()`` the planner built
   again from the disk entry: the same options, no candidate measured.
40. ``oracle_plain`` and ``oracle_staged`` (ROADMAP item 7;
   ``oracle_phases`` prints its seconds):
   ``Options(use_pallas=False)`` per call on the C2C entries at f32 2^20,
   2^24, 2^26 (nested), native f64 2^20, 2^24 and df64 2^20, on the real
   transforms' inner options (R2C / C2R f32 and f64 at 2^22, a round trip)
   and on ``fft_distributed``'s planner at world size 1 (f32 2^25); and
   ``Options(strategy="staged")`` at f32 and f64 2^20 and 2^24, forward
   and inverse, the bit reversal tiled and flat. Each against the card's
   complex128 oracle, its time beside the default engine's, and every
   kernel's launch counter unchanged across each call (a plain or staged
   call that launches a kernel fails the phase).
41. ``dist_chunks`` (ROADMAP item 19; ``dist_chunks_phases`` prints its
   seconds): ``fft_distributed``'s chunked column stage at world size 1,
   each count forced through PHASTFT_TPU_DIST_CHUNKS: f32 2^25 and native
   f64 2^27, natural and permuted input, at 1, 2, 4, 8 chunks and the
   default (one chunk), df64 2^24 natural at 1 and 4; each against the
   card's complex128 oracle (PERF.md section 2's bounds), its max abs
   difference from the one-chunk output, its launches checked against the
   chunk-aware ``dist_launches`` (each column pass once a chunk), and its
   device ms (median, min-max) and enqueue ms.

Every timing follows ``release_memory``'s wait where 8 GiB or more went
back to CUDA (``cudaFree``) just before it.

``python3 chip_smoke.py --chunks RANKS`` (1, or 4 on four cards) runs none
of this: ``fft_distributed`` at one chunk and at 4 over RANKS ranks, a card
and a process each on NCCL (``chunks_rank``): f32 at 2^25 and native f64 at
2^27 points a rank (and f32 2^27 a rank on four), each against a complex128
FFT, the two counts' difference, each rank's added peak, ``overlap_ms`` (the
time a collective's copy and a port kernel ran at once, from the intervals
of a ``torch.profiler`` trace behind a sleep kernel; an incomplete trace
fails), then the two counts in turns 1, 4, 4, 1 (three times), device ms
and host clock: the readings that set ``fourstep_dist._chunk_count``'s
default. On one rank also f32 2^31 and native 2^30 at both counts on 256
bins, with their peaks and the native column tables' bytes.

``python3 chip_smoke.py --fold PARENT`` runs none of this: in turns parent,
this, this, parent, a process each (``--fold-tree DIR``), it times the
forward and the inverse of one planner (FOLD_SIZES: f32 2^31, the cells'
f32 2^12 x 2^19 rows and 2^24 x 128 rows, native f64 2^30; CUDA events,
medians) and checksums both outputs (``checksum``: a seeded input, each
turn the same), reads ``tracing.launches`` and ``tracing.scales`` of one
inverse, and times each kernel that can end a transform at one shape
(FOLD_KERNELS) at ``out_scale`` 1 and, where the tree's wrapper takes it,
at FOLD_SCALE, checking the second against the first times the scale bit for
bit. It prints each turn, the checksums' agreement across the turns (every
forward and every inverse the same bits as the parent's), the inverse over
the forward in each tree, and this tree's kernel times over the parent's.

``python3 chip_smoke.py --turns PARENT`` runs none of this: it times the
existing transforms (f32 2^20, 2^25, 2^28, native f64 2^24, 2^27, the
hybrid leaf at 2^16 x 2^11 rows, the f32 and f64 R2C and C2R at 2^26, and
``fft_distributed`` at f32 2^25 and native 2^27 at world size 1 in an NCCL
world of the turn's own, with the device events of one traced call; CUDA
events, medians) of the package under
the directory PARENT (a
``git archive`` of another commit) and of this checkout's, in turns parent,
this, this, parent, each turn a process of its own
(``--time-tree DIR``), and prints each turn's times and this tree's ratio
to the parent's.

Then a ``run`` line gives the whole run's seconds, the build included, and
the run's ``tracing.launches`` beside its ``tracing.scales`` (where each
inverse's 1/n went). The
line before the last is the kernel summary (twenty-one rows: the TPU
kernels' file:line beside each of the thirteen, and for the native f64
kernels, ``col64_nocorr`` among them, and the real transforms' four passes
(f32 at 2^26), the JAX package's XLA code they stand for); the last line is
the device record. No CUDA device: exit 1 before any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
#: (non-tensor-core) flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: (batch, n1, n2) of the fused two-pass kernels' parity checks: the split
#: plans' levels, and the inner level of a 2^26 nested plan on the outer
#: level's 32 rows as one batch.
PARITY_SHAPES = [(1, 128, 8192), (1, 1024, 16384), (1, 2048, 16384),
                 (32, 128, 16384), (1, 128, 1024), (1, 128, 2048), (3, 128, 4096),
                 (1, 256, 16384), (3, 512, 16384)]
E2E_LOGS = (17, 18, 19, 20, 24, 25)
TIME_LOGS = (17, 20, 24, 25)
#: A of the row kernel's cluster shapes (8 rows a cluster over A/8 blocks)
#: and n1 of the column kernel's (a 32-column slab over n1/256 blocks).
LEAFT_CLUSTER_AS = (8, 16, 32, 64, 128)
COL_CLUSTER_N1S = (1024, 2048)
LEAF_PARITY_LOGS = (1, 6, 7, 8, 12, 13, 14, 15, 16)
LEAF_PARITY_ROWS = 257
LEAF3_PARITY_ROWS = (1, 50)
#: n1 of the leaf kernels' cluster shapes (leaf: 2^14, 2^15; ddleaf: 2^13..2^16),
#: each also checked on 1 row and on one more row than the clusters resident
#: at once (a ragged last wave).
LEAF_CLUSTER_N1S = (128, 256)
DD_LEAF_CLUSTER_N1S = (64, 128, 256, 512)
LEAF_E2E_POINTS = 1 << 20
#: (log2 n, rows) of the leaf timings: 2^27 points (1 GiB planar), and one
#: row of 2^16 for latency.
LEAF_TIME_SHAPES = ((8, 1 << 19), (10, 1 << 17), (12, 1 << 15), (13, 1 << 14),
                    (14, 1 << 13), (15, 1 << 12), (16, 1 << 11), (16, 1))
#: (batch or None, n1, n2) of the classic column pass's parity checks (the
#: outer levels of 2^26 and 2^28..2^30, every other one-block n1 = 2..512,
#: a cluster shape, batches), and (batch or None, R, C) of the paired
#: transpose's.
NESTED_COL_SHAPES = ((None, 32, 1 << 21), (None, 128, 1 << 21), (None, 256, 1 << 21),
                     (None, 512, 1 << 21), (None, 2, 1 << 16), (None, 4, 1 << 16),
                     (None, 8, 1 << 16), (None, 64, 1 << 16), (None, 2048, 1 << 14),
                     (3, 128, 1 << 14), (3, 16, 1 << 16), (5, 2, 1 << 16))
NESTED_TRANSPOSE_SHAPES = ((None, 32, 1 << 21), (None, 2, 1 << 16),
                           (None, 2048, 1 << 16), (3, 128, 1 << 14),
                           (3, 16, 1 << 16), (5, 2, 1 << 16), (None, 256, 8))
NESTED_E2E_LOGS = (26, 28)
NESTED_TIME_LOGS = (26, 28)
#: (n1, n2) of the column pass alone at the outer levels of 2^29 and 2^30
#: (classic), and of the fused 2^22 and 2^23 plans (out3d), one-block shapes.
NESTED_OUTER_TIMES = ((256, 1 << 21), (512, 1 << 21))
FUSED_COL_TIMES = ((256, 1 << 14), (512, 1 << 14))
TOP_LOG = 30
TOP_BINS = 256
#: Elements per step of the chunked error sums and the direct DFT.
CHUNK = 1 << 26
KERNEL_TOL = 1e-6
#: dd kernels against their plain versions, and the f64 entries against a
#: complex128 FFT (the bound of the JAX package's df64 tests).
DD_KERNEL_TOL = 1e-13
DD_E2E_TOL = 1e-12
DD_EXACT_PAIRS = 1 << 20
#: (batch, n1, n2) of the dd column passes' parity checks, and (n1, rows) of
#: the dd leaf's.
DD_COL_SHAPES = ((1, 256, 1 << 16), (2, 64, 1 << 16), (1, 2048, 1 << 16),
                 (1, 1024, 1 << 16), (1, 512, 1 << 16),
                 (5, 2, 1 << 13), (4096, 64, 128), (3, 2, 128), (256, 512, 128))
#: n1 of the dd column kernel's cluster shapes (a 32-column slab over n1/128
#: blocks), each also checked on one more entry than the clusters resident at
#: once (a ragged last wave): ddcol on (2048, 128) entries, ddcol_nocorr on
#: (2048, 32), one cluster an entry.
DD_COL_CLUSTER_N1S = (1024, 2048)
#: (n1, n2) of the dd column pass's timings: the 2^24..2^27 plans' split
#: levels and the outer level of 2^28 (a PlannerDit64(2^28)'s table).
DD_COL_TIME_SHAPES = ((256, 1 << 16), (512, 1 << 16), (1024, 1 << 16), (2048, 1 << 16),
                      (32, 1 << 23))
DD_NOCORR_SHAPES = ((4096, 128, 64), (5, 128, 2), (256, 128, 512))
DD_LEAF_N1S = (1, 8, 64, 128, 256, 512)
DD_LEAF_ROWS = (1, 5, 256)
DD_E2E_POINTS = 1 << 18
DD_E2E_LOGS = (20, 24, 27)
DD_NESTED_LOG = 28
DD_TIME_LOGS = (20, 24, 27)
#: (log2 n, rows) of the "df64-split" transform whose entries are smaller
#: than the column kernel's slab, so that a block holds several.
DD_SPLIT_SMALL = (10, 5)
#: FP32 instructions of dd arithmetic, counted from csrc/dd.cuh: a dd
#: complex sum (two dd sums of 11) and a dd complex product (four lazy
#: products of 5, two dd sums). Each is one single-rounded add, multiply or
#: fused multiply-add; the card issues FP32_LANES of them per clock on each
#: of its SMS SMs.
DD_CADD_INSTR = 22
DD_CMUL_INSTR = 42
SMS, FP32_LANES = 132, 128
#: The SM clock in Hz (``nvidia-smi`` clocks.max.sm), read once.
_SM_CLOCK_HZ = []
#: The Ozaki engine's checks: depths of the exact integer product; (batch,
#: n1, n2) of the column pass's parity; A, n1 and the batch of the row
#: pass's; (log2 n, leaf) of the transforms; the f64 contract bound.
OZ_EXACT_ROWS, OZ_EXACT_COLS = 128, 64
OZ_EXACT_DEPTHS = (32, 64, 128, 512)
#: Depths of the exact product of a tier's five slice pairs in one
#: accumulator (the oz kernels' accumulation chain).
OZ_EXACT_TIER_DEPTHS = (16, 32, 64, 128, 256, 512)
OZ_TIER_PAIRS = 5
OZ_COL_SHAPES = ((1, 128, 8192), (1, 2048, 8192), (1, 512, 2048), (3, 256, 1024),
                 (4, 128, 8192), (1, 1024, 2048))
#: A of ozleaft's cluster shapes (8 rows a cluster over A/8 blocks).
OZ_LEAF_CLUSTER_AS = (8, 16, 32, 64)
#: The inner level of the nested 2^26 "df64-oz" plan: (batch, n1, n2).
OZ_INNER_LEVEL = (64, 128, 8192)
OZ_LEAF_AS = (8, 16, 32, 64)
OZ_LEAF_N1S = (128, 2048)
OZ_LEAF_BATCH = 3
OZ_E2E = ((17, 1 << 10), (20, 1 << 13), (22, 1 << 13), (24, 1 << 13), (26, 1 << 13))
OZ_ROUNDTRIP_LOG = 24
OZ_TIME_LOGS = (20, 24)
OZ_E2E_TOL = 1e-10
#: Published H100 SXM dense bf16 and TF32 tensor-core rates (f32
#: accumulation).
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
#: The hybrid leaf's checks: n1 and row counts of its parity, the leaf
#: sizes of its transforms (on HYBRID_E2E_POINTS points each), and the leaf
#: sizes it is timed at on 2^27 points.
HYBRID_N1S = (2, 8, 64, 128, 256, 512, 1024)
HYBRID_ROWS = (257, 1)
HYBRID_E2E_LOGS = tuple(range(8, 18))
HYBRID_E2E_POINTS = 1 << 20
HYBRID_TIME_LOGS = (8, 12, 15, 16, 17)
#: n1 of the hybrid's cluster shapes (2, 4, 8, 16 blocks).
HYBRID_CLUSTER_N1S = (128, 256, 512, 1024)
HYBRID_TIME_POINTS = 1 << 27
#: The hybrid kernel's own arithmetic per element, printed beside the bound,
#: not the bound (a length-n DFT needs 5 * log2(n) + 6): on the tensor
#: cores the F(128) contraction as three products of three TF32 passes of
#: 128 multiply-adds; on the CUDA cores, besides its F(n1), the sum
#: u_r + u_i, the two output differences and the correction's complex
#: product.
HYBRID_TC_FLOPS = 3 * 3 * 2 * 128
HYBRID_FLOPS = 1 + 3 + 6
#: The distributed four-step at world size 1: its sizes (n1 = 128 at 2^19,
#: 2048 at 2^25, one column pass each), the bare column pass's parity shapes
#: (batch, n1, n2), shard blocks of colfft (n1, n2, n_total, col_base: one
#: on the cluster path, three one-block, two of them narrower than 32
#: columns), and batch_fft_sharded's rows.
DIST_LOGS = (19, 25)
NOCORR_SHAPES = ((1, 2048, 4096), (1, 32, 1 << 14), (1, 2, 1 << 16), (3, 128, 1 << 14),
                 (1, 1024, 1 << 14), (3, 2048, 4096), (2, 2048, 16), (3, 1024, 8))
SHARD_BLOCKS = ((2048, 4096, 1 << 25, 8192), (32, 64, 1 << 16, 512),
                (512, 16, 1 << 20, 2032), (2048, 8, 1 << 22, 1000))
#: (n1, n2) of the bare column pass's times; the first is the kernels line's.
NOCORR_TIMES = ((2048, 1 << 14), (1024, 1 << 14))
DIST_BATCH = (8, 1 << 20)
DIST_TIME_REPEATS = 3
#: The distributed four-step in f64 and past n1 = 2048 at world size 1: the
#: native sizes (n1 = 128, 2048, 2^13 and 2^14 on the default leaves: the
#: last two past the column kernels, as the long-column route), the df64 and
#: df64-oz sizes (n1 = 8), the f32 sizes through the long columns (n1 = 2^13,
#: 2^16), the sizes at which the permuted-input forward of the permuted
#: signal is checked (its index tensor is 8 GiB at 2^30), and the sizes timed.
DIST64_LOGS = (20, 27, 29, 30)
DIST64_DD_LOGS = (20, 24)
DIST64_OZ_LOGS = (20, 24)
DIST64_F32_LOGS = (27, 30)
DIST64_PERMUTED_IN_LOGS = (20, 27)
DIST64_TIME_LOGS = (27, 30)
#: col64 on shard blocks (n, n1, ncols, col_base): the cluster design, a
#: 32-column cluster slab, the one-block design and the narrowest block, each
#: off column 0; ddcol on one (n, n1 = 8, ncols, col_base).
COL64_SHARD_BLOCKS = ((1 << 25, 2048, 4096, 8192), (1 << 22, 1024, 32, 2016),
                      (1 << 20, 128, 2048, 6144), (1 << 16, 64, 2, 510))
DDCOL_SHARD_BLOCK = (1 << 20, 8, 1 << 15, 1 << 16)
#: col64_nocorr's parity shapes (batch, n1, n2): the cluster design at 1024 /
#: 2048, the one-block design at 2..512 and at 2048 under a 32-column slab;
#: its time at the 2^27 permuted-input column pass (2048, 2^16).
COL64_NOCORR_SHAPES = ((1, 2048, 1 << 16), (3, 1024, 32), (3, 128, 4096), (1, 2, 1 << 16),
                       (2, 2048, 16))
COL64_NOCORR_TIME = (2048, 1 << 16)
#: The two routes for a column factor past 2048, timed on the column block
#: of a world of one: (dtype, n, n2) at f32 2^30 (n1 = 2^16 = 256 x 256) and
#: f64 2^29 (n1 = 2^13 = 64 x 128).
LONG_COLUMN_ROUTES = (("f32", 1 << 30, 1 << 14), ("f64", 1 << 29, 1 << 16))
#: The chunked column stage of ``fft_distributed`` at world size 1, each
#: count forced through PHASTFT_TPU_DIST_CHUNKS (None: the default count):
#: (engine, log2 n, layouts, chunk counts, the first one chunk).
DIST_CHUNK_CASES = (("f32", 25, ("natural", "permuted_input"), (1, 2, 4, 8, None)),
                    ("native", 27, ("natural", "permuted_input"), (1, 2, 4, 8, None)),
                    ("df64", 24, ("natural",), (1, 4)))
DIST_CHUNK_REPS = 10
#: ``--chunks RANKS``: (engine, log2 of the points a rank) of the runs at
#: one chunk and at 4, over RANKS ranks; the turns' rounds; the sizes of the
#: peaks in a world of one; the mode's time limit in seconds.
CHUNK_MODE_RUNS = {1: (("f32", 25), ("native", 27)),
                   4: (("f32", 25), ("f32", 27), ("native", 27))}
DIST_CHUNK_ROUNDS = 3
#: 4 chunks faster than one by this factor contradict the default of one.
DIST_CHUNK_GAIN = 1.03
CHUNK_MODE_PEAKS = (("f32", 31), ("native", 30))
CHUNK_MODE_TIMEOUT = 420
#: The least sleep ahead of a traced call.
TRACE_SLEEP_MS = 100.0
#: The native f64 engine: row lengths of the leaf's parity (every n =
#: 2..2^16, on NATIVE_LEAF_ROWS rows, an odd count; below 2^13 also on three
#: blocks' rows and one (a ragged last block), from 2^13 on one row and on one
#: more row than its clusters resident at once), (n1, n2) of the column
#: pass's and the 64-bit transpose's (the column factors 2..512 of the
#: native plans, 2..256 over 2^13 and 64..512 over 2^16, and 512 over 2^13;
#: each over 2^13 also on a batch of 3), the transforms' sizes, and the
#: race: (log2 n, rows) of each size.
NATIVE_LEAF_ROWS = 5
#: Points of the leaf's times at every row length 2^1..2^16 (2^24 / n rows).
NATIVE_LEAF_TIME_POINTS = 1 << 24
NATIVE_COL_SHAPES = tuple((1 << k, 1 << 13) for k in range(1, 10)) + tuple(
    (1 << k, 1 << 16) for k in range(6, 10))
#: (batch, n1, n2) of the column pass's long factors: the cluster design over
#: 2^13 and 2^16 (batches of 1 and 3) and the one-block design at n2 = 16;
#: besides, a ragged last wave: (resident clusters + 1, 1024, 32) and
#: (resident clusters // 2 + 1, 2048, 32) (two 16-column slabs an entry).
NATIVE_LONG_COL_SHAPES = tuple((b, n1, n2) for n1 in (1024, 2048) for b, n2 in (
    (1, 1 << 13), (3, 1 << 13), (1, 1 << 16), (3, 16)))
#: (batch, n1, n2) of the nested plans' levels: the outer level of 2^28 and
#: the inner level batched as at 2^28; and the outer level of 2^30, whose
#: plain column pass is held on each half of the columns (it does not fit
#: the card whole beside the kernel's output).
NATIVE_NESTED_COL_SHAPES = ((1, 32, 1 << 23), (32, 128, 1 << 16))
NATIVE_TOP_COL_SHAPE = (1, 128, 1 << 23)
#: (batch, n1, n2) at which col64's long-column (cluster) design is timed
#: against its one-block design (COL64_ONEBLOCK).
NATIVE_DESIGN_SHAPES = ((1, 1024, 1 << 16), (1, 2048, 1 << 16))
#: Sizes of the forward / round-trip check against complex128 (the 2^30 top
#: of the window is checked on NATIVE_TOP_BINS direct bins).
NATIVE_E2E_LOGS = tuple(range(30))
NATIVE_TOP_LOG = 30
NATIVE_TOP_BINS = 256
#: The size at which the direct bins are held against complex128 as well:
#: the 2^30 check's oracle, measured where both run.
NATIVE_BINS_LOG = 29
#: log2 n at which the peak of allocated device memory is printed.
NATIVE_PEAK_LOGS = (25, 30)
NATIVE_BATCH_LOGS = (16, 20)
NATIVE_RACE = ((10, 1 << 14), (13, 1), (16, 1), (20, 1), (22, 1), (24, 1), (25, 1), (26, 1),
               (27, 1), (28, 1), (29, 1), (30, 1))
#: The race's contenders past 2^25: df64 up to 2^28, complex128 up to 2^29;
#: 2^30 runs native alone.
NATIVE_RACE_DF64_MAX_LOG = 28
NATIVE_RACE_LIBRARY_MAX_LOG = 29
#: The df64-oz contender's window on leaf_fft_size = 2^13.
NATIVE_RACE_OZ_LOGS = (20, 22, 24)
#: csrc/col64.cu built with -DCOL64_CLUSTER_N1=4096 (every shape on the
#: one-block design), under the build directory.
COL64_ONEBLOCK = "col64_oneblock.so"
#: The kernels line's shapes: the 2^24 plan's split level (256 x 2^16).
NATIVE_TOP = (256, 1 << 16)
#: FP64 lanes of an H100 SM; each retires one fused multiply-add (2 flops)
#: a clock.
FP64_LANES = 64
OUT_DIR = "chiprun_out"
#: ~1 ms at the H100's clocks: the shortest sleep before a timed call.
SLEEP_CYCLES = 2_000_000
#: Cycles of ``torch.cuda._sleep`` per ms on this card, measured once.
_SLEEP_RATE = []
#: ``release_memory`` waits RELEASE_WAIT_S once it has returned at least
#: RELEASE_WAIT_BYTES to CUDA.
RELEASE_WAIT_BYTES = 8 << 30
RELEASE_WAIT_S = 1.0

#: The real transforms' four passes (``csrc/r2c.cu``) against their plain
#: versions: rel L2 bounds per dtype (they agree bit for bit on the H100).
R2C_KERNEL_TOL = {"f32": 1e-6, "f64": 1e-14}
#: (rows, n) of the passes' parity: N = 4, 8, 2^16, 2^26, 257 rows of 2^12
#: and 4 of 2^22 (the untangles' rows of H + 1 bins, unaligned past row 0).
R2C_PARITY_SHAPES = ((1, 4), (1, 8), (1, 1 << 16), (1, 1 << 26), (257, 1 << 12),
                     (4, 1 << 22))
#: The paired untangle kernel's schedules (``ops/r2c.pair_schedule``).
R2C_PAIR_SCHEDULES = {"scalar": 0, "vector": 1}
#: (rows, n) and world sizes of the untangles' mirror-form parity.
R2C_MIRROR_SHAPES = ((1, 1 << 16), (1, 1 << 26), (257, 1 << 12))
R2C_MIRROR_RANKS = (2, 4)
#: log2 n of the real entries held to numpy's f64 rfft / irfft, and timed
#: (BASELINE.md's R2C config, 2^16..2^26 at full width).
R2C_E2E_LOGS = (16, 20, 24, 26)
#: f64 at 2^29 (its inner 2^28 runs the nested plan), held to a direct DFT
#: on R2C_TOP_BINS bins of the compact spectrum.
R2C_TOP_LOG = 29
R2C_TOP_BINS = 256
#: (rows, n) of the batch on one reused planner.
R2C_BATCH = (4, 1 << 22)
#: The df64 and df64-oz inner planners, and the distributed real
#: transforms at world size 1.
R2C_DD_LOG = 24
R2C_DIST_LOG = 26
#: (f64_engine, other inner options, kernels the inner transform must run)
#: of the dd inner planners at R2C_DD_LOG.
R2C_DD_ENGINES = (("df64", {}, ("ddcol", "ddleaf")),
                  ("df64-oz", {"leaf_fft_size": 1 << 13}, ("ozcol", "ozleaft")))
#: FP operations per bin of an untangle (s and d: 4, tw * d: 6, the output:
#: 4), and per real of interleave_scale (the scale).
R2C_UNTANGLE_FLOPS = 14

#: Past 2^30 (ROADMAP item 16), what one H100 holds: f32 C2C at 2^31 (the
#: input and two pairs of 16 GiB), through the single-device entry and
#: ``fft_distributed`` at world size 1; R2C / C2R of (dtype, log2 n).
GIANT_LOG = 31
GIANT_R2C = (("f32", 32), ("f64", 31))
#: Output bins held to ``dft_bins``; the inputs' seeds (made again from them
#: where a transform cannot hold its input beside it).
GIANT_BINS = 256
GIANT_SEED = 31
#: The f32 C2C at 2^31 may hold at most this many GiB, its input included:
#: the input and two pairs (48 GiB) and the plan's tables.
GIANT_PEAK_GIB = 50
#: Columns (rows) of each slice of colfft's (transpose2's) output at the
#: outer level (1024, 2^21) held to the plain version: the first, middle
#: and last.
GIANT_SLICE = 4096
#: The leaf kernels on batches of 2^31 elements: (kernel, rows, n, dtype);
#: GIANT_LEAF_ROWS rows at the start, middle and end held to an f64 FFT.
GIANT_LEAF_BATCHES = (("leaf", 1 << 17, 1 << 14, "f32"), ("leaf3", 1 << 15, 1 << 16, "f32"),
                      ("leaf64", 1 << 15, 1 << 16, "f64"))
GIANT_LEAF_ROWS = 4
GIANT_TIME_REPS = 5

#: The window's edges (ROADMAP items 15 and 18). The column kernels' new
#: widths: n1 and n2 of colfft (classic on the planner's table, and the
#: shard mode on the block of each of EDGE_RANKS ranks), the bare mode's
#: n2, col64's n1 at n2 = 1, ddcol's (n1, n2); each on EDGE_COL_POINTS
#: points (a batch), the shard blocks on one entry.
EDGE_COL_N1S = (16, 1024, 2048)
EDGE_COL_N2S = (1, 2, 4, 64)
EDGE_NOCORR_N2S = (1, 2)
EDGE_RANKS = 4
EDGE_DD_COL = ((64, 1), (64, 8), (64, 64), (1024, 1), (2048, 8), (2048, 64))
EDGE_COL_POINTS = 1 << 22
#: leaf3 at a = 256: rows of 2^17, EDGE_LEAF3_ROWS of them (2^27 points);
#: EDGE_LEAF3_CHECK rows at each end held to the plain version.
EDGE_LEAF3_ROWS = 1 << 10
EDGE_LEAF3_CHECK = 2
#: (log2 n, leaf_fft_size, engines) of the main-path transforms.
EDGE_E2E = ((20, 1, ("f32", "native", "df64")), (20, 16, ("f32", "native", "df64")),
            (20, 64, ("f32", "native", "df64")),
            (24, 1 << 17, ("f32", "native", "df64")), (24, 1 << 18, ("f32", "native", "df64")),
            (24, 1 << 20, ("f32", "native", "df64")), (24, 1 << 24, ("f32", "native", "df64")))
#: fft_distributed at world size 1: (log2 n, leaf_fft_size), f32; and the
#: narrow blocks a small leaf gives at world size 1, (dtype, log2 n, leaf):
#: n2 = leaf columns, the column factor past 2048 on the long columns.
EDGE_DIST = (24, 1 << 17)
EDGE_DIST_NARROW = (("f32", 20, 2), ("f64", 20, 1))
EDGE_TIME_REPS = 10
#: The transforms of --turns: (dtype, log2 n); "hybrid" is the f32 leaf
#: transform with Options(leaf_kernel="hybrid") on HYBRID_TIME_POINTS points,
#: "r2c_*" / "c2r_*" the real transforms through their planner entries.
TURN_SIZES = (("f32", 20), ("f32", 25), ("f32", 28), ("f64", 24), ("f64", 27), ("hybrid", 16),
              ("r2c_f32", 26), ("c2r_f32", 26), ("r2c_f64", 26), ("c2r_f64", 26),
              ("dist_f32", 25), ("dist_f64", 27))
TURN_REPS = 20
#: --fold: the transforms timed forward and inverse on one planner, (name,
#: dtype, log2 n, rows): the f32 2^31 C2C, the cells' step transforms
#: (``portbench`` reuse-f32 n12 / n24, qsim30), each input drawn from a
#: seeded generator on the card.
FOLD_SIZES = (("f32_2^31", "f32", 31, 1), ("n12_cell", "f32", 12, 1 << 19),
              ("n24_cell", "f32", 24, 128), ("qsim30_cell", "f64", 30, 1))
FOLD_REPS = 10
#: --fold: each kernel that can end a transform, at one shape of a cell's
#: plan or the kernel table's: (name, dtype, input shape). leaft's is
#: (batch, A, n1, 128); the transposes' (R, C).
FOLD_KERNELS = (("leaf", "f32", (1 << 19, 1 << 12)), ("leaf3", "f32", (1 << 11, 1 << 16)),
                ("hybrid", "f32", (1 << 15, 1 << 12)), ("leaft", "f32", (128, 128, 1024, 128)),
                ("transpose2", "f32", (128, 1 << 21)), ("transpose2_64", "f64", (128, 1 << 23)),
                ("leaf64", "f64", (1 << 14, 1 << 16)))
#: --fold: the output scale of the kernels' second reading (an inverse's
#: 1/n at 2^24).
FOLD_SCALE = 2.0 ** -24
#: --fold: elements of a plane a checksum reads at once.
CHECKSUM_CHUNK = 1 << 26

#: Tune (ROADMAP item 8): (kind, dtype, log2 n) raced with PlannerMode.Tune:
#: BASELINE.md's single-device f64 config (2^20), the top of its
#: planner-reuse config (2^24) in both dtypes, the top of its R2C config.
TUNE_CASES = (("c2c", "f64", 20), ("c2c", "f32", 24), ("c2c", "f64", 24), ("r2c", "f32", 26))
#: The tuned transform may take at most this many times the heuristic's
#: device time, both timed in turns in one call (tuned, heuristic, twice).
TUNE_SLOWER = 1.05
TUNE_TIME_REPS = 10
#: The oracles (ROADMAP item 7), each held to the card's complex128 oracle
#: and launching no kernel: use_pallas=False on (engine, log2 n) of the C2C
#: entries, the real transforms at ORACLE_R2C_LOG, fft_distributed at world
#: size 1 at ORACLE_DIST_LOG; strategy="staged" on (dtype, log2 n), forward
#: and inverse, the bit reversal tiled and flat.
ORACLE_PLAIN = (("f32", 20), ("f32", 24), ("f32", 26), ("native", 20), ("native", 24),
                ("df64", 20))
ORACLE_R2C_LOG = 22
ORACLE_DIST_LOG = 25
ORACLE_STAGED = (("f32", 20), ("f32", 24), ("f64", 20), ("f64", 24))
ORACLE_TIME_REPS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_l2(got_re, got_im, want_re, want_im, worst: bool = False):
    """rel L2 of a planar pair against another, summed in f64 in chunks of
    CHUNK elements (at 2^30 points a plane in f64 is 8 GiB). ``got_im`` and
    ``want_im`` None: one plane. ``worst``: (rel L2, max abs error), and a
    result that is not finite raises."""
    num = den = top = 0.0
    for got, want in ((got_re, want_re), (got_im, want_im)):
        if got is None:
            continue
        got, want = got.reshape(-1), want.reshape(-1)
        for s in range(0, got.numel(), CHUNK):
            w = want[s:s + CHUNK].double()
            d = got[s:s + CHUNK].double() - w
            num += float((d ** 2).sum())
            den += float((w ** 2).sum())
            if worst:
                top = max(top, float(d.abs().max()))
    err = float(np.sqrt(num / den))
    if not worst:
        return err
    if not np.isfinite(err):
        raise AssertionError("output is not finite")
    return err, top


def max_abs(got_re, got_im, want_re, want_im) -> float:
    return float(max((got_re - want_re).abs().max(), (got_im - want_im).abs().max()))


def oracle_err(got, x, real: bool = False) -> float:
    """rel L2 of (re, im) tensors against numpy's f64 FFT of complex x, or
    with ``real`` its compact rfft of real x."""
    want = (np.fft.rfft(x.astype(np.float64), axis=-1) if real
            else np.fft.fft(x.astype(np.complex128), axis=-1))
    g = got[0].cpu().numpy().astype(np.float64) + 1j * got[1].cpu().numpy()
    if not np.all(np.isfinite(g)) or g.shape != want.shape:
        raise AssertionError(f"bad output: shape {g.shape}, finite {np.isfinite(g).all()}")
    return float(np.linalg.norm(g - want) / np.linalg.norm(want))


def card_oracle_err(got, xr, xi) -> float:
    """rel L2 of (re, im) tensors against an f64 FFT of the same input,
    taken on the card (an oracle: the port never calls ``torch.fft``)."""
    import torch

    want = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-1)
    if got[0].shape != want.shape or got[1].shape != want.shape:
        raise AssertionError(f"bad output shape {tuple(got[0].shape)}")
    want = want.reshape(-1)
    g_re, g_im = got[0].reshape(-1), got[1].reshape(-1)
    num = den = 0.0
    for s in range(0, want.numel(), CHUNK):
        w = want[s:s + CHUNK]
        g = torch.complex(g_re[s:s + CHUNK].double(), g_im[s:s + CHUNK].double())
        num += float(((g - w).abs() ** 2).sum())
        den += float((w.abs() ** 2).sum())
    err = float(np.sqrt(num / den))
    if not np.isfinite(err):
        raise AssertionError("output is not finite")
    return err


def dft_bins(xr, xi, ks):
    """X[k] for the bins ``ks`` (int64 tensor) of one length-n planar
    signal (``xi`` None: a real one), by a direct DFT in f64 with
    integer-exact phases: i = i1*n2 + i2, X[k] = sum_i2 W_n^(i2*k) sum_i1
    W_n1^(i1*k) x[i1, i2], the inner sum a complex128 product over i1,
    column chunk by column chunk."""
    import torch

    n = xr.numel()
    log_n = n.bit_length() - 1
    n2 = 1 << (log_n // 2)
    n1 = n // n2
    dev = xr.device
    k = ks.to(dev)[:, None]
    i1 = torch.arange(n1, dtype=torch.int64, device=dev)[None, :]
    ang = ((k * i1) % n1).double() * (-2.0 / n1)
    w1 = torch.complex(torch.cos(ang * np.pi), torch.sin(ang * np.pi))
    acc = torch.zeros(len(ks), dtype=torch.complex128, device=dev)
    cols = max(1, CHUNK // n1)
    x2r = xr.view(n1, n2)
    x2i = None if xi is None else xi.view(n1, n2)
    for c0 in range(0, n2, cols):
        part = x2r[:, c0:c0 + cols].double()
        xc = torch.complex(part, torch.zeros_like(part) if x2i is None
                           else x2i[:, c0:c0 + cols].double())
        y = w1 @ xc
        i2 = torch.arange(c0, min(c0 + cols, n2), dtype=torch.int64, device=dev)[None, :]
        ang = ((k * i2) % n).double() * (-2.0 / n)
        acc += (y * torch.complex(torch.cos(ang * np.pi), torch.sin(ang * np.pi))).sum(1)
    return acc


def signal(rng, shape):
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return re, im


def check(name, value, bound):
    if not value <= bound:
        raise AssertionError(f"{name}: {value} > {bound}")


def sleep_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the GPU busy for at least
    ``ms`` (and SLEEP_CYCLES at least), at the rate of one timed sleep."""
    import torch

    if not _SLEEP_RATE:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        end.synchronize()
        _SLEEP_RATE.append(SLEEP_CYCLES / start.elapsed_time(end))
    return int(max(SLEEP_CYCLES, ms * _SLEEP_RATE[0]))


def release_memory() -> None:
    """``torch.cuda.empty_cache()``, then a wait of RELEASE_WAIT_S where it
    returned RELEASE_WAIT_BYTES or more to CUDA. On the H100 the
    kernels timed in the ~0.2 s after 16 GiB or more went back read 13%
    slower, at an unchanged SM clock and no throttle reason; after 8 GiB,
    or with the memory left in the allocator's cache, they did not."""
    import torch

    held = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    if held - torch.cuda.memory_reserved() >= RELEASE_WAIT_BYTES:
        time.sleep(RELEASE_WAIT_S)


def device_times(fn, flush, reps=20):
    """(CUDA-event times of ``reps`` calls of ``fn``, host ms to enqueue one
    call), after 3 warm-up calls, with the L2 flushed before each timed
    call. Before each, a sleep kernel of twice the enqueue time keeps the
    GPU busy until the host has enqueued all of ``fn``, so that the host's
    Python overhead does not fall between the events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = sleep_cycles(2 * enqueue)
    out = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out, enqueue


def time_ms(fn, flush, reps=20):
    """Median device time of ``fn`` (``device_times``)."""
    return float(np.median(device_times(fn, flush, reps)[0]))


def stream_ms(fn, calls=20):
    """Device ms per call of ``calls`` calls of ``fn`` enqueued back to back
    between one pair of events, after 3 warm-up calls: the rate of a
    caller that streams transforms, the host's enqueue included where it is
    the slower side."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def wall_ms(fn, flush, reps=20):
    """Median host-clock time of ``fn`` up to its synchronised end, L2
    flushed before each call: what a caller of one transform waits."""
    import torch

    out = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def copy_bound(n: int):
    """(bound_ms, bound_by) of moving n planar f32 complex elements once: 8 B
    read and 8 B written each, no arithmetic."""
    return 16 * n / HBM_BYTES_PER_S * 1e3, "bytes"


def kernel_bound(n: int, log_len: int, table_floats: int = 0):
    """(bound_ms, bound_by) of one pass over a length-n planar f32
    transform: 8 B read and 8 B written per complex element, plus the
    tables the kernel reads, against 5*log2(len) + 6 flops per element."""
    nbytes = 16 * n + 4 * table_floats
    flops = (5 * log_len + 6) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dd_dft_instr(log_len: int) -> float:
    """FP32 instructions per point that a dd DFT of length 2^log_len needs,
    by radix-4 decimation with the trivial twiddles dropped: a butterfly of
    four points is 8 dd complex sums (a product by -i is free) and 3 dd
    complex products, which the last radix-4 stage, whose twiddles are all
    1, does not need; an odd log2 ends on a radix-2 stage of sums alone.
    csrc/ddleaf.cu and csrc/ddcol.cu run this schedule (plus the products
    of their corrections); ddcol.cu's clusters (n1 = 1024, 2048) run it per
    factor, P = n1 / 128 and 128, with one more product between them."""
    radix4_with_products = max(0, (log_len + 1) // 2 - 1)
    return DD_CADD_INSTR * log_len + 0.75 * DD_CMUL_INSTR * radix4_with_products


def fp32_instr_per_s() -> float:
    """FP32 instructions the card issues per second: SMS * FP32_LANES lanes
    at the SM clock ``nvidia-smi`` reports as its maximum."""
    if not _SM_CLOCK_HZ:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.split()[0]
        _SM_CLOCK_HZ.append(float(mhz) * 1e6)
    return SMS * FP32_LANES * _SM_CLOCK_HZ[0]


def dd_bound(points: int, log_len: int, cmuls: int, table_floats: int = 0):
    """The bound of one dd pass of length-2^log_len DFTs over ``points``
    complex elements: four f32 planes read and written once (32 B per
    element) plus the tables, against dd_dft_instr(log_len) +
    DD_CMUL_INSTR * cmuls FP32 instructions per element at the card's issue
    rate (dd arithmetic is single adds and multiplies: the FMA rate of
    F32_FLOPS_PER_S would count each as two flops). Returns ``bound_ms``
    (the larger), ``bound_by``, and both times (``bound_instr_ms`` for the
    instructions)."""
    t_bytes = (32 * points + 4 * table_floats) / HBM_BYTES_PER_S * 1e3
    instr = points * (dd_dft_instr(log_len) + DD_CMUL_INSTR * cmuls)
    t_instr = instr / fp32_instr_per_s() * 1e3
    return {"bound_ms": max(t_bytes, t_instr),
            "bound_by": "bytes" if t_bytes >= t_instr else "operations",
            "bound_bytes_ms": t_bytes, "bound_instr_ms": t_instr}


def ddcol_bound(b: int, n1: int, n2: int, corr: bool = True):
    """A column pass: the length-n1 DFT and, with ``corr``, the two dd
    complex products of the factored correction."""
    t = min(256, n2)
    tables = 4 * (n1 // 2) + (4 * (n1 * (n2 // t) + n1 * t) if corr else 0)
    return dd_bound(b * n1 * n2, n1.bit_length() - 1, 2 if corr else 0, tables)


def ddleaf_bound(rows: int, n1: int):
    """A leaf: one DFT of the whole row of n1 * 128 points (the correction
    between the kernel's two factors is that DFT's own twiddle)."""
    tables = 4 * 64 + (4 * (n1 * 128 + n1 // 2) if n1 > 1 else 0)
    return dd_bound(rows * n1 * 128, n1.bit_length() - 1 + 7, 0, tables)


def oz_bound(kind: str, n: int, n1: int, batch: int = 1):
    """The bound of an oz pass over ``batch`` entries of n points (a split
    level n1 x n2): four f32 planes read and written once (32 B per
    element) plus the tables, against the bf16 tensor-core flops of the JAX
    kernels' own counts (pallas_ozdd.py:275 and :404): 90 * n1/4 per element
    for ``ozcol``, 90 * (A + 128) for ``ozleaft``."""
    n2 = n // n1
    a, m = n2 // 128, n1 // 4
    if kind == "ozcol":
        tables = 2 * 15 * m * m + 16 * (4 * m + n1 * (n2 // 256) + n1 * 256)
        flops = 90 * m * n * batch
    else:
        tables = 2 * 15 * (a * a + 128 * 128) + 16 * a * 128
        flops = 90 * (a + 128) * n * batch
    t_bytes = (32 * n * batch + tables) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops}


def fp64_flops_per_s() -> float:
    """FP64 flops the card retires per second: SMS * FP64_LANES lanes, two
    flops a fused multiply-add, at the SM clock ``nvidia-smi`` reports as
    its maximum."""
    fp32_instr_per_s()  # reads the clock once
    return SMS * FP64_LANES * 2 * _SM_CLOCK_HZ[0]


def native_bound(points: int, log_len: int, passes: int = 1, table_bytes: int = 0):
    """The bound of ``passes`` native f64 passes over ``points`` complex
    elements: two f64 planes read and written once a pass (32 B per
    element) plus the tables, against 5 * log2(len) + 6 FP64 flops per
    element (a length-2^log_len DFT; none for a copy, log_len None) at the
    card's FP64 rate."""
    t_bytes = (32 * points * passes + table_bytes) / HBM_BYTES_PER_S * 1e3
    flops = 0 if log_len is None else points * (5 * log_len + 6)
    t_ops = flops / fp64_flops_per_s() * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops}


def native_tables(plan) -> int:
    """Bytes of the tables a native transform of ``plan`` reads: the split
    twiddles of every level and the leaf correction, each f64 (re, im), and
    the kernels' W_m step tables (m/2 pairs)."""
    nbytes = 0
    while plan[0] == "split":
        _, n1, plan, n2 = plan
        s = 1 << ((n2.bit_length() - 1) // 2)
        nbytes += 16 * n1 * (n2 // s + s) + 8 * n1
    if plan[0] == "leaf":
        n1 = plan[1]
        nbytes += 8 * 128 + (16 * n1 * 128 + 8 * n1 if n1 > 1 else 0)
    else:
        nbytes += 8 * plan[1]
    return nbytes


def native_launches(plan):
    """{kernel: launches} of one native f64 transform of ``plan``."""
    want = {"col64": 0, "leaf64": 0, "transpose2_64": 0}
    while plan[0] == "split":
        want["col64"] += 1
        want["transpose2_64"] += 1
        plan = plan[2]
    if plan[0] == "leaf" and plan[1] > 512:  # leaf_columns
        for name, count in long_column_launches(plan[1], "native").items():
            want[name] += count
        want["transpose2_64"] += 1
    if plan[0] == "leaf" or plan[1] > 1:
        want["leaf64"] += 1
    return want


def dd_launches(plan, split: bool):
    """{kernel: launches} of one df64 transform of ``plan``; ``split`` is
    the "df64-split" leaf lowering."""
    want = {"ddcol": 0, "ddcol_nocorr": 0, "ddleaf": 0, "transpose2": 0}
    while plan[0] == "split":
        want["ddcol"] += 1
        want["transpose2"] += 2
        plan = plan[2]
    if plan[0] == "leaf":
        if plan[1] > 512 or (split and plan[1] > 1):
            # the split leaf: its first pass on the long dd columns, two
            # transposes, ddcol_nocorr over 128
            for name, count in long_column_launches(plan[1], "dd").items():
                want[name] += count
            want["transpose2"] += 2
            want["ddcol_nocorr"] += 1
        else:
            want["ddleaf"] += 1
    return want


def dd_rel(got, want):
    """(rel L2, max abs error) of a dd quadruple against another on the
    joined f64 values hi + lo, in chunks of CHUNK elements."""
    num = den = worst = 0.0
    for h, l in ((0, 1), (2, 3)):
        gh, gl = got[h].reshape(-1), got[l].reshape(-1)
        wh, wl = want[h].reshape(-1), want[l].reshape(-1)
        for s in range(0, gh.numel(), CHUNK):
            w = wh[s:s + CHUNK].double() + wl[s:s + CHUNK].double()
            d = gh[s:s + CHUNK].double() + gl[s:s + CHUNK].double() - w
            num += float((d ** 2).sum())
            den += float((w ** 2).sum())
            worst = max(worst, float(d.abs().max()))
    err = float(np.sqrt(num / den))
    if not np.isfinite(err):
        raise AssertionError("dd output is not finite")
    return err, worst


def leaf_call(planner):
    """(wrapper, plain version, arguments, table floats read) of the leaf
    kernel that the planner's tiny or leaf plan runs."""
    from phastft_tpu_torch.ops.leaf import leaf, leaf3, leaf3_plain, leaf_plain

    kind, n1 = planner.plan
    corrs = planner.leaf_corrs
    if kind == "tiny":
        return leaf, leaf_plain, ((), 1), 0
    mats3 = corrs.get(f"mxu3_{n1}")
    if mats3 is not None:  # rows 1 of F(a) and F(128), c1 (a, 512), c2 (4, 128)
        a = mats3[0].shape[0]
        tables = a + 128 + 2 * a * 512 + 2 * 4 * 128
        return leaf3, leaf3_plain, (mats3, a, 128), tables
    if n1 == 1:  # row 1 of F(128)
        return leaf, leaf_plain, (corrs["mxu1"], 1), 128
    # rows 1 of F(n1) and F(128), and the (n1, 128) correction
    mats = corrs[f"mxu{n1}"][:6] + corrs[f"leaf{n1}"]
    return leaf, leaf_plain, (mats, n1), n1 + 128 + 2 * n1 * 128


def hybrid_bound(rows: int, n1: int):
    """The bound of what the hybrid leaf computes on ``rows`` rows of
    n1 * 128 points, a length-n1 * 128 DFT: 16 B per element plus row 1 of
    F(128) and the (n1, 128) correction, against 5 * log2(n) + 6 flops per
    element (as ``leaf``'s). Besides: ``kernel_tc_ms``, the time of the
    kernel's 3xTF32 products (HYBRID_TC_FLOPS per element) at the TF32
    tensor-core peak, and ``kernel_ops_ms``, that of its F(n1) and
    correction (5 * log2(n1) + HYBRID_FLOPS per element) at the f32 peak."""
    points = rows * n1 * 128
    log_n = n1.bit_length() - 1 + 7
    t_bytes = (16 * points + 4 * (2 * 128 + 2 * n1 * 128)) / HBM_BYTES_PER_S * 1e3
    t_ops = points * (5 * log_n + 6) / F32_FLOPS_PER_S * 1e3
    own = points * (5 * (n1.bit_length() - 1) + HYBRID_FLOPS)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "kernel_tc_ms": points * HYBRID_TC_FLOPS / TF32_FLOPS_PER_S * 1e3,
            "kernel_ops_ms": own / F32_FLOPS_PER_S * 1e3}


def device_breakdown(fn, top_k=12):
    """{kernel name: [device ms, calls]} of one call of ``fn`` under
    ``torch.profiler``, the ``top_k`` largest; empty when the profiler
    records no device time on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((e.key[:80], us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return {k: [ms, c] for k, ms, c in rows[:top_k]}


def kernel_launches(kernel) -> int:
    """The launches so far of the kernel wrapper ``kernel``, as
    ``phastft_tpu_torch.tracing.launches`` counts them under its name."""
    from phastft_tpu_torch.tracing import launch_count

    return launch_count(kernel.__name__)


def zero_launches(kernels) -> None:
    """The launch counts of the kernel wrappers ``kernels`` set to 0."""
    from phastft_tpu_torch.tracing import launches

    for k in kernels:
        launches[k.__name__] = 0


def counted(counters):
    """run(fn, want): fn() once; it must launch exactly ``want`` ({name:
    count}) of ``counters``' kernels, and nothing else among them. The
    totals of every run are in run.total."""
    names = [k.__name__ for k in counters]
    total = dict.fromkeys(names, 0)

    def run(fn, want):
        before = [kernel_launches(k) for k in counters]
        out = fn()
        delta = {nm: kernel_launches(k) - b0 for nm, k, b0 in zip(names, counters, before)}
        full = {nm: want.get(nm, 0) for nm in names}
        if delta != full:
            raise AssertionError(f"launches {delta}, want {full}")
        for nm in names:
            total[nm] += full[nm]
        return out

    run.total = total
    return run


def hybrid_phases(dev, gen, rng, flush, smi, top, launches, max_err) -> None:
    """The opt-in hybrid leaf: parity with its plain version, the leaf
    plans' main path with ``Options(leaf_kernel="hybrid")``, and times."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerR2c32, c2r_fft_f32_with_planner,
        fft_32_dit_with_planner, fft_32_dit_with_planner_and_opts, r2c_fft_f32_with_planner,
    )
    from phastft_tpu_torch.ops import r2c as R
    from phastft_tpu_torch.ops.colfft import colfft, colfft_out3d
    from phastft_tpu_torch.ops.leaf import hybrid, hybrid_plain, leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft
    from phastft_tpu_torch.ops.transpose import transpose2

    def mats(planner, n1):
        corrs = planner.tables_for(planner.plan, "hybrid")
        return corrs[f"mxu{n1}"][3:6] + corrs[f"leaf{n1}"]

    def leaf_planner(n, **opts):
        """A planner whose plan is the leaf of n points (2^17:
        ``leaf_fft_size=2^17``)."""
        if n > 1 << 16:
            opts["leaf_fft_size"] = n
        return PlannerDit32(n, options=Options(**opts) if opts else None)

    max_err["hybrid"] = 0.0
    for n1 in HYBRID_N1S:
        m = mats(leaf_planner(n1 * 128), n1)
        for rows in HYBRID_ROWS:
            xr = torch.randn((rows, n1 * 128), generator=gen, device=dev)
            xi = torch.randn((rows, n1 * 128), generator=gen, device=dev)
            k = hybrid(xr, xi, m, n1)
            torch.cuda.synchronize()
            p = hybrid_plain(xr, xi, m, n1)
            err = rel_l2(k[0], k[1], p[0], p[1])
            mabs = max_abs(k[0], k[1], p[0], p[1])
            max_err["hybrid"] = max(max_err["hybrid"], mabs)
            emit({"phase": "parity_hybrid", "n1": n1, "rows": rows, "rel_l2": err,
                  "max_abs_err": mabs, "bound": KERNEL_TOL})
            check(f"hybrid parity at n1 = {n1}, {rows} rows", err, KERNEL_TOL)
            del k, p, xr, xi

    # -- main path: counters at 0 just before, read just after
    passes = (R.deinterleave, R.untangle, R.pre_untangle, R.interleave_scale)
    counters = (hybrid, leaf, leaf3, colfft, colfft_out3d, leaft, transpose2, *passes)
    zero_launches(counters)
    run = counted(counters)
    opts = Options(leaf_kernel="hybrid")
    errs = {}
    for log_n in HYBRID_E2E_LOGS:
        n = 1 << log_n
        re, im = signal(rng, (HYBRID_E2E_POINTS // n, n))
        planner = leaf_planner(n)
        out = run(lambda: fft_32_dit_with_planner_and_opts(
            re, im, Direction.Forward, planner, opts), {"hybrid": 1})
        err = oracle_err(out, re + 1j * im)
        errs[f"fwd_2^{log_n}"] = err
        check(f"hybrid leaf 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
    for n, rows in ((1 << 12, 256), (1 << 17, 4)):
        planner = leaf_planner(n, leaf_kernel="hybrid")
        re, im = signal(rng, (rows, n))
        out = run(lambda: fft_32_dit_with_planner(re, im, Direction.Forward, planner),
                  {"hybrid": 1})
        errs[f"hybrid_planner_2^{n.bit_length() - 1}_x{rows}"] = err = oracle_err(
            out, re + 1j * im)
        check(f"hybrid planner {n} x {rows}", err, 5e-7)
    # the 2^17 leaf under a classic level, and under a real transform, with
    # "hybrid" and without it (leaf3 at a = 256): the same inputs
    n = 1 << 24
    xr, xi = (torch.randn((n,), generator=gen, device=dev) for _ in range(2))
    for kernel, leaf_kernel in (("hybrid", "hybrid"), ("leaf3", None)):
        planner = PlannerDit32(n, options=Options(leaf_fft_size=1 << 17,
                                                  leaf_kernel=leaf_kernel))
        out = run(lambda: fft_32_dit_with_planner(xr, xi, Direction.Forward, planner),
                  {"colfft": 1, kernel: 1, "transpose2": 1})
        errs[f"classic_2^24_leaf_2^17_{kernel}"] = err = card_oracle_err(out, xr, xi)
        check(f"classic 2^24 over {kernel} 2^17 rows", err, 5e-7 * max(1.0, 24 / 18.0))
        del out
    del xr, xi
    n = 1 << 18
    x = rng.standard_normal((n,)).astype(np.float32)
    for kernel, leaf_kernel in (("hybrid", "hybrid"), ("leaf3", None)):
        planner = PlannerR2c32(n, inner_options=Options(leaf_fft_size=1 << 17,
                                                        leaf_kernel=leaf_kernel))
        spec = run(lambda: r2c_fft_f32_with_planner(x, planner),
                   {"deinterleave": 1, kernel: 1, "untangle": 1})
        errs[f"r2c_2^18_leaf_2^17_{kernel}"] = err = oracle_err(spec, x, real=True)
        check(f"R2C 2^18 over {kernel} 2^17 rows", err, 5e-7)
        back = run(lambda: c2r_fft_f32_with_planner(spec[0], spec[1], planner),
                   {"pre_untangle": 1, kernel: 1, "interleave_scale": 1})
        rt = rel_l2(back, None, torch.from_numpy(x).to(dev), None)
        errs[f"r2c_c2r_roundtrip_2^18_{kernel}"] = rt
        check(f"R2C / C2R round trip 2^18 over {kernel}", rt, 1e-6)
        del spec, back
    re, im = signal(rng, (4, 1 << 17))
    planner = leaf_planner(1 << 17)
    out = run(lambda: fft_32_dit_with_planner(re, im, Direction.Forward, planner),
              {"leaf3": 1})
    errs["leaf_2^17_x4_leaf3"] = err = oracle_err(out, re + 1j * im)
    check("2^17 leaf x 4 on leaf3", err, 5e-7)
    planner = PlannerDit32(1 << 20, options=Options(leaf_fft_size=1 << 16,
                                                    leaf_kernel="hybrid"))
    re, im = signal(rng, (1 << 20,))
    out = run(lambda: fft_32_dit_with_planner(re, im, Direction.Forward, planner),
              {"colfft": 1, "hybrid": 1, "transpose2": 1})
    errs["classic_2^20_leaf_2^16"] = err = oracle_err(out, re + 1j * im)
    check("classic 2^20 over hybrid rows", err, 5e-7 * max(1.0, 20 / 18.0))
    n = 1 << 16
    planner = PlannerDit32(n)
    re, im = signal(rng, (16, n))
    out = run(lambda: fft_32_dit_with_planner_and_opts(re, im, Direction.Forward,
                                                       planner, opts), {"hybrid": 1})
    back = run(lambda: fft_32_dit_with_planner_and_opts(out[0], out[1], Direction.Reverse,
                                                        planner, opts), {"hybrid": 1})
    rt = rel_l2(back[0], back[1], torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev))
    errs["roundtrip_2^16x16"] = rt
    check("hybrid round trip 2^16 x 16", rt, 1e-6)
    torch.cuda.synchronize()
    got = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_hybrid", "rel_l2": errs, "launches": got, "want": run.total})
    if got != run.total or got["hybrid"] < 1:
        raise AssertionError(f"launches {got}, want {run.total}")
    launches["hybrid"] = got["hybrid"]
    del out, back

    # -- times on 2^27 points, beside the default leaf kernel of the same rows
    for log_n in HYBRID_TIME_LOGS:
        n = 1 << log_n
        n1 = n // 128
        rows = HYBRID_TIME_POINTS // n
        planner = leaf_planner(n)
        m = mats(planner, n1)
        xr = torch.randn((rows, n), generator=gen, device=dev)
        xi = torch.randn((rows, n), generator=gen, device=dev)
        xc = torch.complex(xr, xi)
        fn, _, args, _ = leaf_call(planner)
        row = {"ms": time_ms(lambda: hybrid(xr, xi, m, n1), flush, 10),
               "plain_ms": time_ms(lambda: hybrid_plain(xr, xi, m, n1), flush, 3),
               **hybrid_bound(rows, n1),
               "library_ms": time_ms(lambda: torch.fft.fft(xc), flush, 10),
               "n": n, "rows": rows}
        emit({"phase": "times_hybrid", "card": smi, **row,
              f"{fn.__name__}_ms": time_ms(lambda: fn(xr, xi, *args), flush, 10),
              "transform_hybrid_ms": time_ms(lambda: fft_32_dit_with_planner_and_opts(
                  xr, xi, Direction.Forward, planner, opts), flush, 10),
              "transform_default_ms": time_ms(lambda: fft_32_dit_with_planner(
                  xr, xi, Direction.Forward, planner), flush, 10)})
        top["hybrid"] = row  # the kernels line: the last (largest) leaf
        del xr, xi, xc
    release_memory()


def r2c_bounds(rows: int, n: int, f64: bool):
    """{pass: bound} of the four passes of a real transform of ``rows`` rows
    of n points on one device: each input read once, each output written
    once, against the passes' FP operations at the f32 / FP64 peak. The
    untangles' mirror is their input itself, and both read only the quarter
    table (H/2 + 1 entries, tw[H - k] = -conj(tw[k]) past it).
    ``requested_ms`` is the time of the bytes the paired kernel's loads and
    stores ask for: z, the bins and the quarter table once a row (on one
    row, the bound's bytes)."""
    e = 8 if f64 else 4
    h = n // 2
    rate = fp64_flops_per_s() if f64 else F32_FLOPS_PER_S
    quarter = 2 * (h // 2 + 1)

    def bound(nbytes, flops, requested=None):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
        out = {"bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops}
        if requested is not None:
            out["requested_ms"] = requested * e / HBM_BYTES_PER_S * 1e3
        return out

    spectrum = 2 * rows * (h + 1)
    planes = 2 * rows * h
    return {
        "deinterleave": bound(2 * rows * n * e, 0),
        "untangle": bound((planes + quarter + spectrum) * e, R2C_UNTANGLE_FLOPS * rows * h,
                          requested=planes + rows * quarter + spectrum),
        "pre_untangle": bound((spectrum + quarter + planes) * e, R2C_UNTANGLE_FLOPS * rows * h,
                              requested=spectrum + rows * quarter + planes),
        "interleave_scale": bound(2 * rows * n * e, rows * n),
    }


def pair_schedule_ms(name: str, src, tw, flush, reps: int) -> dict:
    """{schedule: ms} of the paired untangle kernel (``name``: "untangle" or
    "pre_untangle") on the planes ``src`` and the quarter table ``tw``, in
    each of R2C_PAIR_SCHEDULES."""
    from phastft_tpu_torch.ops import r2c as R

    inverse = name == "pre_untangle"
    half = int(src[0].shape[-1]) - int(inverse)
    return {sched: time_ms(lambda: R._launch_untangle_pair(name, inverse, *src, *tw, half, code),
                           flush, reps)
            for sched, code in R2C_PAIR_SCHEDULES.items()}


def r2c_phases(dev, gen, flush, smi, top, launches, max_err) -> None:
    """The real transforms (run inside ``nccl_world``): the four passes
    against their plain versions, the main path through the public entries
    with its launches, the distributed real transforms at world size 1, and
    times."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerDit64, PlannerR2c32, PlannerR2c64,
        c2r_fft_f32, c2r_fft_f32_with_planner, c2r_fft_f64, c2r_fft_f64_with_planner,
        fft_32_dit_with_planner, fft_64_dit_with_planner, r2c_fft_f32,
        r2c_fft_f32_with_planner, r2c_fft_f64, r2c_fft_f64_with_planner,
    )
    from phastft_tpu_torch.ops import r2c as R
    from phastft_tpu_torch.ops.colfft import colfft, colfft_nocorr, colfft_out3d
    from phastft_tpu_torch.ops.dd import ddcol, ddcol_nocorr, ddleaf
    from phastft_tpu_torch.ops.leaf import hybrid, leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft
    from phastft_tpu_torch.ops.native import col64, col64_nocorr, leaf64
    from phastft_tpu_torch.ops.ozdd import ozcol, ozleaft
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_64
    from phastft_tpu_torch.parallel import c2r_fft_distributed, r2c_fft_distributed

    passes = (R.deinterleave, R.untangle, R.pre_untangle, R.interleave_scale)
    inner = (colfft, colfft_nocorr, colfft_out3d, leaft, leaf, leaf3, hybrid, transpose2,
             ddcol, ddcol_nocorr, ddleaf, ozcol, ozleaft, col64, col64_nocorr, leaf64,
             transpose2_64)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    planners = {"f32": PlannerR2c32, "f64": PlannerR2c64}
    entries = {"f32": (r2c_fft_f32, c2r_fft_f32, r2c_fft_f32_with_planner,
                       c2r_fft_f32_with_planner, fft_32_dit_with_planner, PlannerDit32),
               "f64": (r2c_fft_f64, c2r_fft_f64, r2c_fft_f64_with_planner,
                       c2r_fft_f64_with_planner, fft_64_dit_with_planner, PlannerDit64)}

    def randn(shape, tag):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtypes[tag])

    def parity(got, want):
        """(rel L2, max abs error, bit for bit) of a kernel's output planes
        against its plain version's."""
        if [g.shape for g in got] != [w.shape for w in want]:
            raise AssertionError(f"shapes {[tuple(g.shape) for g in got]}, "
                                 f"want {[tuple(w.shape) for w in want]}")
        two = len(got) == 2
        err, mabs = rel_l2(got[0], got[1] if two else None, want[0],
                           want[1] if two else None, worst=True)
        return err, mabs, all(bool(torch.equal(g, w)) for g, w in zip(got, want))

    # -- parity: each pass against its plain version on the same inputs
    for k in passes:
        max_err[k.__name__] = 0.0
    for tag in dtypes:
        for rows, n in R2C_PARITY_SHAPES:
            p = planners[tag](n)
            x = randn((rows, n), tag)
            z = (randn((rows, n // 2), tag), randn((rows, n // 2), tag))
            sp = (randn((rows, n // 2 + 1), tag), randn((rows, n // 2 + 1), tag))
            tw = (p.twiddles_re, p.twiddles_im)
            cases = (
                ("deinterleave", lambda: R.deinterleave(x), lambda: R.deinterleave_plain(x)),
                ("untangle", lambda: R.untangle(*z, *tw), lambda: R.untangle_plain(*z, *tw)),
                ("pre_untangle", lambda: R.pre_untangle(*sp, *tw),
                 lambda: R.pre_untangle_plain(*sp, *tw)),
                ("interleave_scale", lambda: (R.interleave_scale(*z, 2.0 / n),),
                 lambda: (R.interleave_scale_plain(*z, 2.0 / n),)),
            )
            for name, kernel, plain in cases:
                k = kernel()
                torch.cuda.synchronize()
                want = plain()
                err, mabs, equal = parity(k, want)
                max_err[name] = max(max_err[name], mabs)
                emit({"phase": "parity_r2c", "kernel": name, "dtype": tag, "rows": rows,
                      "n": n, "rel_l2": err, "max_abs_err": mabs, "bit_equal": equal,
                      "bound": R2C_KERNEL_TOL[tag]})
                check(f"{name} parity {tag} at {rows} x {n}", err, R2C_KERNEL_TOL[tag])
                if name in ("untangle", "pre_untangle"):
                    # the paired kernel in each schedule, bit for bit
                    inverse = name == "pre_untangle"
                    src = sp if inverse else z
                    for sched, code in R2C_PAIR_SCHEDULES.items():
                        got = R._launch_untangle_pair(name, inverse, *src, *tw, n // 2, code)
                        torch.cuda.synchronize()
                        _, m, eq = parity(got, want)
                        emit({"phase": "parity_r2c_pair", "kernel": name, "schedule": sched,
                              "dtype": tag, "rows": rows, "n": n, "max_abs_err": m,
                              "bit_equal": eq})
                        if not eq:
                            raise AssertionError(f"{name} {sched} schedule {tag} at {rows} x "
                                                 f"{n}: not bit for bit the plain version")
                        del got
                del k, want
            del x, z, sp, p
    torch.cuda.empty_cache()

    # -- the untangles in the mirror form of d ranks (parallel/real_dist.py):
    # rank r's shard z[rL, (r+1)L), its partner d-1-r's shard as the mirror
    # (with bin H on the inverse's last shard), the wrap element z[(d-r)L]
    # (z[0] / X[H] for r = 0), bins from k0 = rL, the Nyquist bin on the last
    for tag in dtypes:
        for rows, n in R2C_MIRROR_SHAPES:
            p = planners[tag](n)
            half = n // 2
            tw = (p.twiddles_re, p.twiddles_im)
            z = (randn((rows, half), tag), randn((rows, half), tag))
            sp = (randn((rows, half + 1), tag), randn((rows, half + 1), tag))
            whole = (R.untangle(*z, *tw), R.pre_untangle(*sp, *tw))
            for d in R2C_MIRROR_RANKS:
                length = half // d

                def shard(x, r, extra=0):
                    return x[..., r * length:(r + 1) * length + extra].contiguous()

                outs = {"untangle": [], "pre_untangle": []}
                for r in range(d):
                    partner = d - 1 - r
                    wrap = 0 if r == 0 else (d - r) * length
                    mirror = (shard(z[0], partner), shard(z[1], partner),
                              z[0][..., wrap], z[1][..., wrap])
                    args = (shard(z[0], r), shard(z[1], r), *tw, mirror)
                    kw = {"k0": r * length, "half": half, "nyquist": r == d - 1}
                    k = R.untangle(*args, **kw)
                    torch.cuda.synchronize()
                    outs["untangle"].append((k, R.untangle_plain(*args, **kw)))
                    last = int(partner == d - 1)
                    wrap = half if r == 0 else (d - r) * length
                    mirror = (shard(sp[0], partner, last), shard(sp[1], partner, last),
                              sp[0][..., wrap], sp[1][..., wrap])
                    args = (shard(sp[0], r), shard(sp[1], r), *tw, mirror)
                    kw = {"k0": r * length, "half": half}
                    k = R.pre_untangle(*args, **kw)
                    torch.cuda.synchronize()
                    outs["pre_untangle"].append((k, R.pre_untangle_plain(*args, **kw)))
                for (name, pairs), one in zip(outs.items(), whole):
                    err = mabs = 0.0
                    equal = True
                    for k, pl in pairs:
                        e, m, eq = parity(k, pl)
                        err, mabs, equal = max(err, e), max(mabs, m), equal and eq
                    joined = all(bool(torch.equal(torch.cat([k[i] for k, _ in pairs], -1),
                                                  one[i])) for i in range(2))
                    max_err[name] = max(max_err[name], mabs)
                    emit({"phase": "parity_r2c_mirror", "kernel": name, "dtype": tag,
                          "rows": rows, "n": n, "ranks": d, "rel_l2": err,
                          "max_abs_err": mabs, "bit_equal": equal,
                          "joined_equals_one_device": joined, "bound": R2C_KERNEL_TOL[tag]})
                    check(f"{name} mirror form {tag} at {rows} x {n}, {d} ranks", err,
                          R2C_KERNEL_TOL[tag])
                    if not joined:
                        raise AssertionError(f"{name} mirror form {tag} at {rows} x {n}, "
                                             f"{d} ranks: the shards do not join to the "
                                             f"one-device result")
                del outs, pairs, k
            del z, sp, whole, p
    torch.cuda.empty_cache()

    # -- the main path: counters at 0 just before, read just after
    zero_launches((*passes, *inner))
    run = counted(passes)
    fwd = {"deinterleave": 1, "untangle": 1}
    inv = {"pre_untangle": 1, "interleave_scale": 1}
    inner_seen = {}

    def transform(fn, want, what):
        """run(fn, want), which must also launch the half-length transform's
        kernels; the inner kernels it launched are recorded under ``what``."""
        before = {k.__name__: kernel_launches(k) for k in inner}
        out = run(fn, want)
        got = {k.__name__: kernel_launches(k) - before[k.__name__] for k in inner}
        got = {k: v for k, v in got.items() if v}
        if not got:
            raise AssertionError(f"{what}: no kernel of the half-length transform ran")
        inner_seen[what] = got
        return out

    def spec_err(spec, x):
        """rel L2 against numpy's f64 rfft of x; the DC and Nyquist bins must
        be real."""
        if bool(spec[1][..., 0].any()) or bool(spec[1][..., -1].any()):
            raise AssertionError("the DC or Nyquist bin is not real")
        return oracle_err(spec, x.cpu().numpy(), real=True)

    def back_err(back, x):
        return rel_l2(back, None, x, None, worst=True)[0]

    def fwd_tol(tag, log_n):
        return 5e-7 * max(1.0, log_n / 18.0) if tag == "f32" else DD_E2E_TOL

    def rt_tol(tag):
        return 1e-6 if tag == "f32" else DD_E2E_TOL

    errs = {}
    for tag in dtypes:
        r2c, c2r, r2c_p, c2r_p, _, _ = entries[tag]
        for log_n in R2C_E2E_LOGS:
            n = 1 << log_n
            x = randn((n,), tag)
            spec = transform(lambda: r2c(x), fwd, f"{tag} r2c 2^{log_n}")
            errs[f"{tag}_r2c_2^{log_n}"] = err = spec_err(spec, x)
            check(f"{tag} r2c 2^{log_n}", err, fwd_tol(tag, log_n))
            back = transform(lambda: c2r(*spec), inv, f"{tag} c2r 2^{log_n}")
            errs[f"{tag}_roundtrip_2^{log_n}"] = rt = back_err(back, x)
            check(f"{tag} round trip 2^{log_n}", rt, rt_tol(tag))
            del x, spec, back
        # one planner reused on a batch
        rows, n = R2C_BATCH
        log_b = n.bit_length() - 1
        p = planners[tag](n)
        for i in range(2):
            x = randn((rows, n), tag)
            spec = transform(lambda: r2c_p(x, p), fwd, f"{tag} r2c {rows} x {n}")
            err = spec_err(spec, x)
            errs.setdefault(f"{tag}_planner_batch{rows}_2^{log_b}", []).append(err)
            check(f"{tag} r2c planner reuse {rows} x {n}", err, fwd_tol(tag, log_b))
            back = transform(lambda: c2r_p(*spec, p), inv, f"{tag} c2r {rows} x {n}")
            rt = back_err(back, x)
            errs.setdefault(f"{tag}_planner_roundtrip_batch{rows}_2^{log_b}", []).append(rt)
            check(f"{tag} planner round trip {rows} x {n}", rt, rt_tol(tag))
            del x, spec, back
        torch.cuda.empty_cache()
    # f64 at 2^29: 256 bins of a direct DFT (0, 1, n/4 and n/2 among them),
    # and a round trip
    n = 1 << R2C_TOP_LOG
    x = randn((n,), "f64")
    spec = transform(lambda: r2c_fft_f64(x), fwd, f"f64 r2c 2^{R2C_TOP_LOG}")
    ks = torch.randint(0, n // 2 + 1, (R2C_TOP_BINS,), generator=gen, device=dev)
    ks[:4] = torch.tensor([0, 1, n // 4, n // 2], device=dev)
    zero = torch.zeros_like(x)
    want = dft_bins(x, zero, ks)
    del zero
    got = torch.complex(spec[0][ks], spec[1][ks])
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    errs[f"f64_r2c_2^{R2C_TOP_LOG}_{R2C_TOP_BINS}_bins"] = err
    check(f"f64 r2c 2^{R2C_TOP_LOG} on {R2C_TOP_BINS} bins", err, DD_E2E_TOL)
    if bool(spec[1][0] != 0) or bool(spec[1][-1] != 0):
        raise AssertionError(f"f64 r2c 2^{R2C_TOP_LOG}: the DC or Nyquist bin is not real")
    back = transform(lambda: c2r_fft_f64(*spec), inv, f"f64 c2r 2^{R2C_TOP_LOG}")
    errs[f"f64_roundtrip_2^{R2C_TOP_LOG}"] = rt = back_err(back, x)
    check(f"f64 round trip 2^{R2C_TOP_LOG}", rt, DD_E2E_TOL)
    del x, spec, back, want, got
    release_memory()
    # the df64 and df64-oz inner planners
    n = 1 << R2C_DD_LOG
    for engine, opts, arms in R2C_DD_ENGINES:
        p = PlannerR2c64(n, inner_options=Options(f64_engine=engine, **opts))
        x = randn((n,), "f64")
        spec = transform(lambda: r2c_fft_f64_with_planner(x, p), fwd,
                         f"{engine} r2c 2^{R2C_DD_LOG}")
        if not all(inner_seen[f"{engine} r2c 2^{R2C_DD_LOG}"].get(k) for k in arms):
            raise AssertionError(f"{engine}: the inner transform did not run {arms}")
        tol = OZ_E2E_TOL if engine == "df64-oz" else DD_E2E_TOL
        errs[f"{engine}_r2c_2^{R2C_DD_LOG}"] = err = spec_err(spec, x)
        check(f"{engine} r2c 2^{R2C_DD_LOG}", err, tol)
        back = transform(lambda: c2r_fft_f64_with_planner(*spec, p), inv,
                         f"{engine} c2r 2^{R2C_DD_LOG}")
        errs[f"{engine}_roundtrip_2^{R2C_DD_LOG}"] = rt = back_err(back, x)
        check(f"{engine} round trip 2^{R2C_DD_LOG}", rt, tol)
        del p, x, spec, back
    # the distributed real transforms at world size 1 (NCCL)
    n = 1 << R2C_DIST_LOG
    for tag in dtypes:
        p = planners[tag](n)
        x = randn((n,), tag)
        spec = transform(lambda: r2c_fft_distributed(x, p), fwd, f"{tag} r2c_dist 2^{R2C_DIST_LOG}")
        errs[f"{tag}_r2c_distributed_2^{R2C_DIST_LOG}"] = err = spec_err(spec, x)
        check(f"{tag} r2c_fft_distributed 2^{R2C_DIST_LOG}", err, fwd_tol(tag, R2C_DIST_LOG))
        back = transform(lambda: c2r_fft_distributed(*spec, p), inv,
                         f"{tag} c2r_dist 2^{R2C_DIST_LOG}")
        errs[f"{tag}_distributed_roundtrip_2^{R2C_DIST_LOG}"] = rt = back_err(back, x)
        check(f"{tag} distributed round trip 2^{R2C_DIST_LOG}", rt, rt_tol(tag))
        del p, x, spec, back
    torch.cuda.synchronize()
    got = {k.__name__: kernel_launches(k) for k in passes}
    emit({"phase": "e2e_r2c", "rel_l2": errs, "launches": got, "want": run.total,
          "inner_launches": inner_seen})
    if got != run.total:
        raise AssertionError(f"launches {got}, want {run.total}")
    for name, count in got.items():
        if count < 1:
            raise AssertionError(f"{name} was never launched on the real transforms' path")
        launches[name] = count
    from phastft_tpu_torch.real_fft import _cached_planner

    _cached_planner.cache_clear()  # the auto-planned entries' tables
    release_memory()

    # -- times: each pass beside its bound, its plain version and its
    # one-call library equivalent; each whole transform beside
    # torch.fft.rfft / irfft and the port's zero-imaginary C2C of n
    for tag in dtypes:
        r2c, c2r, r2c_p, c2r_p, c2c, dit = entries[tag]
        logs = R2C_E2E_LOGS + ((R2C_TOP_LOG,) if tag == "f64" else ())
        for log_n in logs:
            n = 1 << log_n
            reps = 20 if log_n <= 24 else 10 if log_n <= 26 else 5
            p = planners[tag](n)
            x = randn((n,), tag)
            spec = r2c_p(x, p)
            row = {}
            if log_n == max(R2C_E2E_LOGS):
                z = R.deinterleave(x)
                bounds = r2c_bounds(1, n, tag == "f64")
                calls = {
                    "deinterleave": (lambda: R.deinterleave(x), lambda: R.deinterleave_plain(x),
                                     lambda: x.view(n // 2, 2).movedim(-1, 0).contiguous()),
                    "untangle": (lambda: R.untangle(*z, p.twiddles_re, p.twiddles_im),
                                 lambda: R.untangle_plain(*z, p.twiddles_re, p.twiddles_im),
                                 None),
                    "pre_untangle": (lambda: R.pre_untangle(*spec, p.twiddles_re, p.twiddles_im),
                                     lambda: R.pre_untangle_plain(*spec, p.twiddles_re,
                                                                  p.twiddles_im),
                                     None),
                    "interleave_scale": (lambda: R.interleave_scale(*z, 2.0 / n),
                                         lambda: R.interleave_scale_plain(*z, 2.0 / n),
                                         lambda: torch.stack(z, -1)),
                }
                for name, (kern, plain, lib) in calls.items():
                    row[name] = {"ms": time_ms(kern, flush, reps),
                                 "plain_ms": time_ms(plain, flush, 3),
                                 "library_ms": None if lib is None else time_ms(lib, flush, reps),
                                 "n": n, "rows": 1, "dtype": tag, **bounds[name]}
                    row[name]["bound_share"] = row[name]["bound_ms"] / row[name]["ms"]
                tw = (p.twiddles_re, p.twiddles_im)
                row["untangle"]["schedule_ms"] = pair_schedule_ms("untangle", z, tw, flush, reps)
                row["pre_untangle"]["schedule_ms"] = pair_schedule_ms("pre_untangle", spec, tw,
                                                                      flush, reps)
                # and on the batch: rows of H + 1 start aligned every V-th row
                rows_b, n_b = R2C_BATCH
                p_b = planners[tag](n_b)
                tw_b = (p_b.twiddles_re, p_b.twiddles_im)
                for name, width in (("untangle", n_b // 2), ("pre_untangle", n_b // 2 + 1)):
                    src = (randn((rows_b, width), tag), randn((rows_b, width), tag))
                    row[name]["batch_schedule_ms"] = {
                        "rows": rows_b, "n": n_b,
                        **pair_schedule_ms(name, src, tw_b, flush, reps)}
                del p_b, tw_b, src
                if tag == "f32":  # the kernels line: f32 at the top of BASELINE's range
                    top.update(row)
                del z
            zero = torch.zeros_like(x)
            sc = torch.complex(*spec)
            c2c_planner = dit(n)
            out = {
                "r2c_ms": time_ms(lambda: r2c_p(x, p), flush, reps),
                "r2c_wall_ms": wall_ms(lambda: r2c_p(x, p), flush, reps),
                "c2r_ms": time_ms(lambda: c2r_p(*spec, p), flush, reps),
                "rfft_library_ms": time_ms(lambda: torch.fft.rfft(x), flush, reps),
                "irfft_library_ms": time_ms(lambda: torch.fft.irfft(sc), flush, reps),
                "c2c_forward_ms": time_ms(
                    lambda: c2c(x, zero, Direction.Forward, c2c_planner), flush, reps),
                "c2c_inverse_ms": time_ms(
                    lambda: c2c(x, zero, Direction.Reverse, c2c_planner), flush, reps),
            }
            emit({"phase": "times_r2c", "dtype": tag, "n": n, "card": smi, **out,
                  "passes": row})
            del p, x, spec, sc, zero, c2c_planner
            release_memory()


def dist_phases(dev, gen, flush, smi, top, launches, max_err) -> None:
    """The distributed four-step and batch sharding at world size 1 on NCCL,
    the bare column pass's parity, and times."""
    import torch
    import torch.distributed as dist

    from phastft_tpu_torch import Direction, PlannerDit32, fft_32_dit_with_planner
    from phastft_tpu_torch.ops.colfft import (
        colfft, colfft_nocorr, colfft_nocorr_plain, colfft_out3d, colfft_plain,
    )
    from phastft_tpu_torch.ops.leaf import hybrid, leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft
    from phastft_tpu_torch.ops.transpose import transpose2
    from phastft_tpu_torch.parallel import batch_fft_sharded, fft_distributed
    from phastft_tpu_torch.parallel.fourstep_dist import _factor, column_chunks

    def randn_pair(shape):
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))

    # -- the bare column pass, and colfft on a shard block, against plain
    max_err["colfft_nocorr"] = 0.0
    for b, n1, n2 in NOCORR_SHAPES:
        xr, xi = randn_pair((b, n1, n2))
        k = colfft_nocorr(xr, xi, n1)
        torch.cuda.synchronize()
        p = colfft_nocorr_plain(xr, xi, n1)
        err = rel_l2(k[0], k[1], p[0], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        max_err["colfft_nocorr"] = max(max_err["colfft_nocorr"], mabs)
        emit({"phase": "parity_nocorr", "kernel": "colfft_nocorr", "batch": b, "n1": n1,
              "n2": n2, "rel_l2": err, "max_abs_err": mabs, "bound": KERNEL_TOL})
        check(f"colfft_nocorr parity at ({b}, {n1}, {n2})", err, KERNEL_TOL)
        del k, p, xr, xi
    for n1, n2, n_total, base in SHARD_BLOCKS:
        xr, xi = randn_pair((n1, n2))
        k = colfft(xr, xi, None, n1, n_total=n_total, col_base=base)
        torch.cuda.synchronize()
        p = colfft_plain(xr, xi, None, n1, n_total=n_total, col_base=base)
        err = rel_l2(k[0], k[1], p[0], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        max_err["colfft"] = max(max_err["colfft"], mabs)
        emit({"phase": "parity_nocorr", "kernel": "colfft", "n1": n1, "n2": n2,
              "n_total": n_total, "col_base": base, "rel_l2": err, "max_abs_err": mabs,
              "bound": KERNEL_TOL})
        check(f"colfft parity on a shard block {(n1, n2, n_total, base)}", err, KERNEL_TOL)
        del k, p, xr, xi

    counters = (colfft, colfft_nocorr, colfft_out3d, leaft, leaf, leaf3, hybrid,
                transpose2)
    zero_launches(counters)
    run = counted(counters)
    errs = {}
    for log_n in DIST_LOGS:
        n = 1 << log_n
        planner = PlannerDit32(n)
        n1, n2 = _factor(n, 1, planner.options.leaf_fft_size)
        # n1 = 1: the column pass is a copy; else one launch a chunk
        cols = column_chunks(n, 1, planner) if n1 > 1 else 0
        rows = {"leaf3" if n2 == 1 << 16 else "leaf": 1}
        fwd = {"colfft": cols, **rows}
        emit({"phase": "dist_plan", "n": n, "n1": n1, "n2": n2})
        xr, xi = randn_pair((n,))
        out = run(lambda: fft_distributed(xr, xi, Direction.Forward, planner),
                  {**fwd, "transpose2": 1})
        errs[f"fwd_2^{log_n}"] = err = card_oracle_err(out, xr, xi)
        check(f"fft_distributed 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
        po = run(lambda: fft_distributed(xr, xi, Direction.Forward, planner,
                                         permuted_output=True), fwd)
        back = run(lambda: fft_distributed(po[0], po[1], Direction.Reverse, planner,
                                           permuted_input=True),
                   {"colfft_nocorr": cols, **rows})
        errs[f"permuted_roundtrip_2^{log_n}"] = rt = rel_l2(back[0], back[1], xr, xi)
        check(f"permuted round trip 2^{log_n}", rt, 1e-6)
        del po, back
        # the permuted layout of x: P[k1*n2 + k2] = x[k1 + k2*n1]
        perm = torch.arange(n, device=dev).view(n2, n1).t().reshape(-1)
        pin = run(lambda: fft_distributed(xr[perm], xi[perm], Direction.Forward,
                                          planner, permuted_input=True),
                  {"colfft_nocorr": cols, **rows})
        errs[f"permuted_input_fwd_2^{log_n}"] = err = card_oracle_err(pin, xr, xi)
        check(f"permuted-input forward 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
        del pin, perm
        dr = torch.zeros(n, device=dev)
        dr[0] = float(n)
        ones = run(lambda: fft_distributed(dr, torch.zeros_like(dr), Direction.Reverse,
                                           planner), {**fwd, "transpose2": 1})
        exact = bool((ones[0] == 1.0).all()) and bool((ones[1] == 0.0).all())
        errs[f"inverse_scale_exact_2^{log_n}"] = exact
        if not exact:
            raise AssertionError("distributed inverse of N * delta is not exactly ones")
        del out, ones, dr, xr, xi
    rows, n = DIST_BATCH
    planner = PlannerDit32(n)
    xr, xi = randn_pair((rows, n))
    out = run(lambda: batch_fft_sharded(xr, xi, Direction.Forward, planner),
              {"colfft_out3d": 1, "leaft": 1})
    errs[f"batch_{rows}x2^{n.bit_length() - 1}"] = err = card_oracle_err(out, xr, xi)
    check("batch_fft_sharded", err, 5e-7 * max(1.0, 20 / 18.0))
    del out, xr, xi
    torch.cuda.synchronize()
    got = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "dist", "world_size": dist.get_world_size(),
          "backend": dist.get_backend(), "rel_l2": errs, "launches": got,
          "want": run.total})
    if got != run.total or got["colfft_nocorr"] < 1:
        raise AssertionError(f"launches {got}, want {run.total}")
    launches["colfft_nocorr"] = got["colfft_nocorr"]
    release_memory()

    # -- times: the bare column pass, and the whole distributed transform
    for n1, n2 in NOCORR_TIMES:
        xr, xi = randn_pair((n1, n2))
        xc = torch.complex(xr, xi)
        bound = kernel_bound(n1 * n2, n1.bit_length() - 1)
        row = {
            "ms": time_ms(lambda: colfft_nocorr(xr, xi, n1), flush, 10),
            "plain_ms": time_ms(lambda: colfft_nocorr_plain(xr, xi, n1), flush, 3),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": time_ms(lambda: torch.fft.fft(xc, dim=-2), flush, 10),
            "n": n1 * n2, "rows": 1}
        emit({"phase": "times_dist", "kernel": "colfft_nocorr", "n1": n1, "n2": n2,
              "card": smi, **row})
        top.setdefault("colfft_nocorr", row)  # the kernels line: the first shape
        del xr, xi, xc
    n = 1 << max(DIST_LOGS)
    planner = PlannerDit32(n)
    xr, xi = randn_pair((n,))

    def whole():
        return fft_distributed(xr, xi, Direction.Forward, planner)

    def single():
        return fft_32_dit_with_planner(xr, xi, Direction.Forward, planner)

    # three readings of each, in one process: device time with the
    # enqueue covered (median, min, max), host clock, back to back
    for rep in range(DIST_TIME_REPEATS):
        d_times, d_enq = device_times(whole, flush, 10)
        s_times, s_enq = device_times(single, flush, 10)
        emit({"phase": "times_dist", "n": n, "card": smi, "repeat": rep,
              "fft_distributed_ms": float(np.median(d_times)),
              "fft_distributed_min_max_ms": [min(d_times), max(d_times)],
              "fft_distributed_enqueue_ms": d_enq,
              "fft_distributed_wall_ms": wall_ms(whole, flush, 10),
              "fft_distributed_stream_ms": stream_ms(whole),
              "fft_32_dit_ms": float(np.median(s_times)),
              "fft_32_dit_min_max_ms": [min(s_times), max(s_times)],
              "fft_32_dit_enqueue_ms": s_enq,
              "fft_32_dit_wall_ms": wall_ms(single, flush, 10),
              "fft_32_dit_stream_ms": stream_ms(single)})
    emit({"phase": "times_dist", "n": n, "breakdown_ms": device_breakdown(whole)})
    del xr, xi
    release_memory()


class nccl_world:
    """A ``torch.distributed`` world of one rank on NCCL (a ``file://`` store
    in the output directory), for the distributed phases; destroyed, and the
    store removed, on exit."""

    def __enter__(self):
        import torch.distributed as dist

        self.store = os.path.abspath(os.path.join(OUT_DIR, "nccl_store"))
        if os.path.exists(self.store):
            os.remove(self.store)
        dist.init_process_group("nccl", init_method=f"file://{self.store}", rank=0,
                                world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        if os.path.exists(self.store):
            os.remove(self.store)
        return False


def f32_row_launches(plan):
    """{kernel: launches} of ``ops/fourstep.fft_rows`` on ``plan`` with the
    default leaf kernels."""
    from phastft_tpu_torch.ops.fourstep import fused_two_pass

    want = {}

    def add(name):
        want[name] = want.get(name, 0) + 1

    while plan[0] == "split":
        _, n1, plan2, n2 = plan
        if fused_two_pass(n1, plan2, n2):
            add("colfft_out3d")
            add("leaft")
            return want
        add("colfft")
        add("transpose2")
        plan = plan2
    if plan[0] == "leaf" and plan[1] > 1024:  # leaf_columns
        for name, count in long_column_launches(plan[1], "f32").items():
            want[name] = want.get(name, 0) + count
        add("leaf")
        add("transpose2")
    elif plan[0] == "leaf":
        add("leaf3" if plan[1] in (512, 1024) else "leaf")
    elif plan[1] > 1:
        add("leaf")
    return want


def long_column_launches(n1: int, engine: str, bare: bool = False, whole: bool = True):
    """{kernel: launches} of ``ops/longcol.columns`` (``engine`` "f32" or
    "native") or ``longcol.dd_columns`` ("dd") over n1 on a block of every
    column (a single-device leaf's, or a world of one's; ``whole`` False: a
    chunk of one), ``bare`` for permuted input: one column pass up to 2048;
    past it two passes (the first one nested again past 2048^2) and two
    transposes a level (dd: two paired transposes of a quadruple, four
    transpose2)."""
    from phastft_tpu_torch.ops.longcol import long_split

    col = {"f32": "colfft", "native": "col64", "dd": "ddcol"}[engine]
    tr = "transpose2_64" if engine == "native" else "transpose2"
    # a level's first pass: col64 and ddcol on their tables; in f32 colfft's
    # own shard twiddle on a block of every column, else its bare mode (and
    # the twiddle in torch)
    first = col + ("_nocorr" if (bare or not whole) and engine == "f32" else "")
    last = col + ("_nocorr" if bare else "")
    want = {}
    m = n1
    while m > 2048:
        p, _ = long_split(m)
        want[first] = want.get(first, 0) + 1
        want[tr] = want.get(tr, 0) + (4 if engine == "dd" else 2)
        m //= p
    if m > 1:
        want[last] = want.get(last, 0) + 1
    return want


def dist_launches(planner, layout: str, chunks=None):
    """{kernel: launches} of one ``fft_distributed`` at world size 1 on
    ``planner``'s native (f64) or f32 pipeline: the column pass (``col64`` /
    ``colfft``, their bare modes for ``permuted_input``; past n1 = 2048 two
    column passes and two transposes, ``long_column_launches``) once a chunk
    of the column stage (``chunks``, None: the port's own count,
    ``fourstep_dist.column_chunks``), the row plan of n2, and for natural
    output the last transpose."""
    from phastft_tpu_torch.ops.fourstep import plan_rows
    from phastft_tpu_torch.parallel.fourstep_dist import _factor, column_chunks

    n, leaf, f64 = planner.n, planner.options.leaf_fft_size, planner.dtype == np.float64
    if chunks is None:
        chunks = column_chunks(n, 1, planner, layout != "natural")
    n1, n2 = _factor(n, 1, leaf)
    rows = native_launches if f64 else f32_row_launches
    want = {}

    def merge(counts, times=1):
        for k, v in counts.items():
            want[k] = want.get(k, 0) + v * times

    merge(rows(plan_rows(n2, leaf)))
    merge(long_column_launches(n1, "native" if f64 else "f32", layout == "permuted_input",
                               chunks == 1), chunks)
    if layout == "natural":
        merge({"transpose2_64" if f64 else "transpose2": 1})
    return {k: v for k, v in want.items() if v}


def dd_dist_launches(rp, chunks: int):
    """{kernel: launches} of one df64 / df64-oz ``fft_distributed`` at world
    size 1 whose row planner is ``rp``: ``ddcol`` once a chunk of the column
    stage, the row plan as ``fft_rows_dd`` runs it (a level with oz tables
    is ``ozcol`` + ``ozleaft`` and ends the plan), and the last transpose
    (two ``transpose2``)."""
    corrs = rp.dd_state[1]
    want = {"ddcol": chunks, "transpose2": 2}
    plan = rp.plan
    while plan[0] == "split":
        _, p1, plan2, p2 = plan
        if f"ozcol{p1}x{p2}" in corrs:
            want.update(ozcol=1, ozleaft=1)
            break
        want["ddcol"] += 1
        want["transpose2"] += 2
        plan = plan2
    else:
        if plan[0] == "leaf":
            want["ddleaf"] = 1
    return {k: v for k, v in want.items() if v}


def nccl_split(breakdown):
    """The device ms of a ``device_breakdown`` split into NCCL's self-copies
    at world size 1 (the ``Memcpy DtoD`` rows) and the kernels; the
    ``nccl:*`` rows are the profiler's ranges around those copies, which
    hold the same device time, and count in neither."""
    copies = sum(ms for k, (ms, _) in breakdown.items() if "memcpy" in k.lower())
    ranges = sum(ms for k, (ms, _) in breakdown.items() if k.lower().startswith("nccl:"))
    return {"nccl_copies_ms": copies,
            "kernels_ms": sum(ms for ms, _ in breakdown.values()) - copies - ranges}


def dist64_phases(dev, gen, flush, smi, top, launches, max_err) -> None:
    """The distributed four-step in f64 (native in its three layouts, df64
    and df64-oz in natural order) and past n1 = 2048 (f32 and f64) at world
    size 1 on NCCL: the column kernels on shard blocks against their plain
    versions, the main path's errors, launches and peaks, and times. The
    checks return memory with ``torch.cuda.empty_cache`` alone; the timings
    follow ``release_memory``'s wait."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerDit64, fft_32_dit_with_planner,
        fft_64_dit_with_planner,
    )
    from phastft_tpu_torch.ops.colfft import colfft, colfft_nocorr, colfft_out3d
    from phastft_tpu_torch.ops.dd import dd_shard_tables, ddcol, ddcol_nocorr, ddcol_plain, ddleaf
    from phastft_tpu_torch.ops.df64 import split_f64
    from phastft_tpu_torch.ops.fourstep import plan_rows
    from phastft_tpu_torch.ops.leaf import hybrid, leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft
    from phastft_tpu_torch.ops.native import (
        col64, col64_nocorr, col64_nocorr_plain, col64_plain, col64_shard_tables,
        dif_twiddles, leaf64,
    )
    from phastft_tpu_torch.ops.ozdd import ozcol, ozleaft
    from phastft_tpu_torch.ops.stockham import split_correction_host
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_64
    from phastft_tpu_torch.parallel import fft_distributed
    from phastft_tpu_torch.ops.longcol import long_columns, twiddle_
    from phastft_tpu_torch.parallel.fourstep_dist import (
        _dd_row_planner, _factor, _factor_dd, _row_pass, column_chunks,
    )

    def randn(shape, dtype=torch.float64, g=gen):
        return (torch.randn(shape, generator=g, device=dev, dtype=dtype),
                torch.randn(shape, generator=g, device=dev, dtype=dtype))

    def parity(name, k, p, **where):
        err = rel_l2(k[0], k[1], p[0], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        max_err[name] = max(max_err.get(name, 0.0), mabs)
        emit({"phase": "parity_dist64", "kernel": name, **where, "rel_l2": err,
              "max_abs_err": mabs, "bound": DD_KERNEL_TOL})
        check(f"{name} parity at {where}", err, DD_KERNEL_TOL)

    # -- the column kernels on shard blocks, and the bare mode
    for n, n1, ncols, base in COL64_SHARD_BLOCKS:
        x = randn((n1, ncols))
        tabs, w = col64_shard_tables(n, n1, ncols, base, dev), dif_twiddles(n1, dev)
        k = col64(*x, tabs, n1, w)
        torch.cuda.synchronize()
        parity("col64", k, col64_plain(*x, tabs, n1, w), n=n, n1=n1, ncols=ncols,
               col_base=base)
        del k, x
    for b, n1, n2 in COL64_NOCORR_SHAPES:
        x = randn((b, n1, n2))
        w = dif_twiddles(n1, dev)
        k = col64_nocorr(*x, n1, w)
        torch.cuda.synchronize()
        parity("col64_nocorr", k, col64_nocorr_plain(*x, n1, w), batch=b, n1=n1, n2=n2)
        del k, x
    n, n1, ncols, base = DDCOL_SHARD_BLOCK
    quad = [*split_f64(randn((n1, ncols))[0]), *split_f64(randn((n1, ncols))[1])]
    t1, t2 = dd_shard_tables(n, n1, ncols, base, dev)
    k = ddcol(*quad, t1, t2, n1)
    torch.cuda.synchronize()
    p = ddcol_plain(*quad, t1, t2, n1)
    err, mabs = dd_rel(k, p)
    max_err["ddcol"] = max(max_err["ddcol"], mabs)
    emit({"phase": "parity_dist64", "kernel": "ddcol", "n": n, "n1": n1, "ncols": ncols,
          "col_base": base, "rel_l2": err, "max_abs_err": mabs, "bound": DD_KERNEL_TOL})
    check("ddcol parity on a shard block", err, DD_KERNEL_TOL)
    del k, p, quad
    torch.cuda.empty_cache()

    # -- the main path: counters at 0 just before, read just after
    counters = (col64, col64_nocorr, leaf64, transpose2_64, transpose2, ddcol, ddcol_nocorr,
                ddleaf, ozcol, ozleaft, colfft, colfft_nocorr, colfft_out3d, leaft, leaf,
                leaf3, hybrid)
    zero_launches(counters)
    run = counted(counters)
    errs, peaks = {}, {}

    def peak(tag, fn, want):
        """run(fn, want) with the peak of allocated device memory above what
        was held before."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = run(fn, want)
        torch.cuda.synchronize()
        top_bytes = torch.cuda.max_memory_allocated()
        peaks[tag] = {"peak_gib": top_bytes / 2 ** 30, "held_before_gib": held / 2 ** 30,
                      "added_gib": (top_bytes - held) / 2 ** 30}
        return out

    def bins(n):
        ks = torch.randint(0, n, (NATIVE_TOP_BINS,), generator=gen, device=dev)
        ks[:4] = torch.tensor([0, 1, n // 2, n - 1], device=dev)
        return ks

    def spectrum_err(out, xr, xi, log_n):
        """rel L2 against complex128 ``torch.fft.fft`` of the input, and from
        2^30 on NATIVE_TOP_BINS bins of a direct f64 DFT instead."""
        if log_n < NATIVE_TOP_LOG:
            return card_oracle_err(out, xr, xi)
        ks = bins(xr.numel())
        want = dft_bins(xr, xi, ks)
        got = torch.complex(out[0][ks].double(), out[1][ks].double())
        return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))

    def inverse_exact(planner, n, dtype, want):
        dr = torch.zeros(n, device=dev, dtype=dtype)
        dr[0] = float(n)
        ones = run(lambda: fft_distributed(dr, torch.zeros_like(dr), Direction.Reverse,
                                           planner), want)
        exact = bool((ones[0] == 1.0).all()) and bool((ones[1] == 0.0).all())
        del ones, dr
        return exact

    def layouts(log_n, planner, dtype, tol, tag):
        """Natural forward, permuted output into a permuted-input inverse,
        the permuted-input forward of the permuted signal (up to 2^27), and
        the inverse of N * delta; the input made again from its seed where
        it was dropped."""
        n = 1 << log_n
        f64 = dtype == torch.float64
        leaf_n = planner.options.leaf_fft_size
        n1, n2 = _factor(n, 1, leaf_n)
        emit({"phase": "dist64_plan", "dtype": tag, "n": n, "n1": n1, "n2": n2,
              "long_columns": n1 > 2048})
        seeded = torch.Generator(device=dev)
        xr, xi = randn((n,), dtype, seeded.manual_seed(log_n))
        want = {lay: dist_launches(planner, lay)
                for lay in ("natural", "permuted_output", "permuted_input")}
        out = peak(f"{tag}_2^{log_n}",
                   lambda: fft_distributed(xr, xi, Direction.Forward, planner),
                   want["natural"])
        errs[f"{tag}_fwd_2^{log_n}"] = err = spectrum_err(out, xr, xi, log_n)
        check(f"{tag} fft_distributed 2^{log_n}", err, tol)
        del out
        torch.cuda.empty_cache()
        po = run(lambda: fft_distributed(xr, xi, Direction.Forward, planner,
                                         permuted_output=True), want["permuted_output"])
        if log_n in DIST64_PERMUTED_IN_LOGS:
            # the permuted layout of x: P[k1*n2 + k2] = x[k1 + k2*n1]
            perm = torch.arange(n, device=dev).view(n2, n1).t().reshape(-1)
            pin = run(lambda: fft_distributed(xr[perm], xi[perm], Direction.Forward,
                                              planner, permuted_input=True),
                      want["permuted_input"])
            errs[f"{tag}_permuted_input_fwd_2^{log_n}"] = err = card_oracle_err(pin, xr, xi)
            check(f"{tag} permuted-input forward 2^{log_n}", err, tol)
            del pin, perm
        del xr, xi
        torch.cuda.empty_cache()
        back = run(lambda: fft_distributed(po[0], po[1], Direction.Reverse, planner,
                                           permuted_input=True), want["permuted_input"])
        del po
        torch.cuda.empty_cache()
        xr, xi = randn((n,), dtype, seeded.manual_seed(log_n))
        errs[f"{tag}_permuted_roundtrip_2^{log_n}"] = rt = rel_l2(back[0], back[1], xr, xi)
        check(f"{tag} permuted round trip 2^{log_n}", rt, tol)
        del back, xr, xi
        torch.cuda.empty_cache()
        exact = inverse_exact(planner, n, dtype, want["natural"])
        errs[f"{tag}_inverse_scale_exact_2^{log_n}"] = exact
        if not exact:
            raise AssertionError(f"{tag} distributed inverse of N * delta at 2^{log_n} is "
                                 "not exactly ones")
        torch.cuda.empty_cache()

    for log_n in DIST64_LOGS:
        layouts(log_n, PlannerDit64(1 << log_n), torch.float64, DD_E2E_TOL, "native")
    for log_n in DIST64_F32_LOGS:
        layouts(log_n, PlannerDit32(1 << log_n), torch.float32,
                5e-7 * max(1.0, log_n / 18.0), "f32")
    # df64 and df64-oz: natural order, against complex128
    for engine, logs, tol, leaf_n in (("df64", DIST64_DD_LOGS, DD_E2E_TOL, None),
                                      ("df64-oz", DIST64_OZ_LOGS, OZ_E2E_TOL, 1 << 13)):
        for log_n in logs:
            n = 1 << log_n
            guess = Options.guess_options(n, np.float64)
            opts = dataclasses.replace(guess, f64_engine=engine,
                                       leaf_fft_size=leaf_n or guess.leaf_fft_size)
            planner = PlannerDit64(n, options=opts)
            n1, n2 = _factor_dd(n, 1)
            rp = _dd_row_planner(n2, opts.leaf_fft_size, engine, dev)
            oz = any(k.startswith("oz") for k in rp.dd_state[1])
            want = dd_dist_launches(rp, column_chunks(n, 1, planner))
            xr, xi = randn((n,))
            out = run(lambda: fft_distributed(xr, xi, Direction.Forward, planner), want)
            errs[f"{engine}_fwd_2^{log_n}"] = err = card_oracle_err(out, xr, xi)
            errs[f"{engine}_oz_rows_2^{log_n}"] = oz
            check(f"{engine} fft_distributed 2^{log_n}", err, tol)
            del out, xr, xi
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    got = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "dist64", "world_size": 1, "rel_l2": errs, "launches": got,
          "want": run.total, "peaks": peaks})
    if got != run.total:
        raise AssertionError(f"launches {got}, want {run.total}")
    for name in ("col64", "col64_nocorr", "leaf64", "transpose2_64"):
        if got[name] < 1:
            raise AssertionError(f"{name} was never launched on the distributed f64 path")
    launches["col64_nocorr"] = got["col64_nocorr"]
    top_peak = peaks[f"native_2^{max(DIST64_LOGS)}"]
    if top_peak["added_gib"] > 2 * 16 * 2 ** (max(DIST64_LOGS) - 30) + 1:
        raise AssertionError(f"native 2^{max(DIST64_LOGS)} holds more than its input, two "
                             f"pairs and 1 GiB: {top_peak}")
    torch.cuda.empty_cache()

    # -- times: col64_nocorr at the 2^27 permuted-input column pass
    n1, n2 = COL64_NOCORR_TIME
    x = randn((n1, n2))
    w = dif_twiddles(n1, dev)
    xc = torch.complex(*x)
    bound = native_bound(n1 * n2, n1.bit_length() - 1, 1, 8 * n1)
    row = {"ms": time_ms(lambda: col64_nocorr(*x, n1, w), flush, 10),
           "plain_ms": time_ms(lambda: col64_nocorr_plain(*x, n1, w), flush, 3),
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "bound_bytes_ms": bound["bound_bytes_ms"], "bound_ops_ms": bound["bound_ops_ms"],
           "library_ms": time_ms(lambda: torch.fft.fft(xc, dim=-2), flush, 10),
           "n": n1 * n2, "rows": 1}
    tabs = tuple(torch.from_numpy(a.copy()).to(dev)
                 for a in split_correction_host(n1, n2, "float64")[1:])
    emit({"phase": "times_dist64", "kernel": "col64_nocorr", "n1": n1, "n2": n2, "card": smi,
          **row, "col64_ms": time_ms(lambda: col64(*x, tabs, n1, w), flush, 10)})
    top["col64_nocorr"] = row
    del x, xc, tabs
    release_memory()

    # -- the two routes past n1 = 2048, on the column block of a world of one
    for tag, n, n2 in LONG_COLUMN_ROUTES:
        f64 = tag == "f64"
        dtype = torch.float64 if f64 else torch.float32
        n1 = n // n2
        planner = (PlannerDit64 if f64 else PlannerDit32)(n)
        leaf_n = planner.options.leaf_fft_size
        if _factor(n, 1, leaf_n) != (n1, n2):
            raise AssertionError(f"route shapes {(n, n2)} are not the plan's")
        x = randn((n1, n2), dtype)
        tr = transpose2_64 if f64 else transpose2
        long_rows = _row_pass(planner, plan_rows(n1, leaf_n), None)
        k1 = torch.arange(n1, dtype=torch.int64, device=dev)
        j = torch.arange(n2, dtype=torch.int64, device=dev)

        def nested_route():  # the package's: two column passes, two transposes
            return long_columns(list(x), n, n1, 0, False, f64)

        def rows_route():  # transposed, the row plan of n1, the twiddle in torch, back
            r = long_rows(list(tr(*x)))
            twiddle_(r[0], r[1], n, j, k1)
            return tr(*r)

        a_out = nested_route()
        b_out = rows_route()
        agree = rel_l2(a_out[0], a_out[1], b_out[0], b_out[1])
        del a_out, b_out
        release_memory()
        ms_a = time_ms(nested_route, flush, 5)
        ms_b = time_ms(rows_route, flush, 5)
        ms_a2 = time_ms(nested_route, flush, 5)
        pp = 1 << ((n1.bit_length() - 1) // 2)
        emit({"phase": "times_long_columns", "dtype": tag, "n": n, "n1": n1, "n2": n2,
              "P": pp, "Q": n1 // pp, "card": smi, "routes_agree_rel_l2": agree,
              "nested_route_ms": [ms_a, ms_a2], "rows_route_ms": ms_b,
              "bound_ms": (native_bound(n1 * n2, n1.bit_length() - 1)["bound_ms"] if f64
                           else kernel_bound(n1 * n2, n1.bit_length() - 1)[0])})
        check(f"the two long-column routes agree ({tag})", agree,
              DD_KERNEL_TOL if f64 else KERNEL_TOL)
        del x
        release_memory()

    # -- times: the whole distributed transform beside the single-device
    # entry at the same n, and where the distributed one spends its time
    for log_n in DIST64_TIME_LOGS:
        n = 1 << log_n
        planner = PlannerDit64(n)
        xr, xi = randn((n,))

        def whole():
            return fft_distributed(xr, xi, Direction.Forward, planner)

        def single():
            return fft_64_dit_with_planner(xr, xi, Direction.Forward, planner)

        d_times, d_enq = device_times(whole, flush, 5)
        release_memory()
        s_times, s_enq = device_times(single, flush, 5)
        release_memory()
        breakdown = device_breakdown(whole, 24)
        release_memory()
        emit({"phase": "times_dist64", "n": n, "card": smi,
              "fft_distributed_ms": float(np.median(d_times)),
              "fft_distributed_min_max_ms": [min(d_times), max(d_times)],
              "fft_distributed_enqueue_ms": d_enq,
              "fft_64_dit_ms": float(np.median(s_times)),
              "fft_64_dit_min_max_ms": [min(s_times), max(s_times)],
              "fft_64_dit_enqueue_ms": s_enq,
              "breakdown_ms": breakdown, **nccl_split(breakdown)})
        del xr, xi
        release_memory()
    n = 1 << max(DIST64_F32_LOGS)
    planner = PlannerDit32(n)
    xr, xi = randn((n,), torch.float32)
    whole_ms = time_ms(lambda: fft_distributed(xr, xi, Direction.Forward, planner), flush, 5)
    release_memory()
    single_ms = time_ms(lambda: fft_32_dit_with_planner(xr, xi, Direction.Forward, planner),
                        flush, 5)
    emit({"phase": "times_dist64", "dtype": "f32", "n": n, "card": smi,
          "fft_distributed_ms": whole_ms, "fft_32_dit_ms": single_ms})
    del xr, xi
    release_memory()


@contextlib.contextmanager
def dist_chunks_env(value):
    """PHASTFT_TPU_DIST_CHUNKS set to ``value`` (None: unset) inside the
    block, restored after it."""
    old = os.environ.pop("PHASTFT_TPU_DIST_CHUNKS", None)
    if value is not None:
        os.environ["PHASTFT_TPU_DIST_CHUNKS"] = str(value)
    try:
        yield
    finally:
        os.environ.pop("PHASTFT_TPU_DIST_CHUNKS", None)
        if old is not None:
            os.environ["PHASTFT_TPU_DIST_CHUNKS"] = old


def _spans_ms(spans) -> float:
    """Length in ms of disjoint (start, end) intervals in microseconds."""
    return sum(b - a for a, b in spans) / 1e3


def _spans_union(spans):
    """The union of (start, end) intervals as sorted disjoint [start, end]."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_trace(fn):
    """One call of ``fn`` under ``torch.profiler`` behind a sleep kernel, so
    that the host does not pace the device (as in ``device_times``): (the
    profile, the device events of its exported trace as (name, category,
    stream, start us, end us), the sleep left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    sleep_ms = max(4 * (time.perf_counter() - t0) * 1e3, TRACE_SLEEP_MS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(sleep_cycles(sleep_ms))
        fn()
        torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = json.load(f).get("traceEvents", [])
    os.remove(path)
    events = []
    for e in raw:
        cat, name = e.get("cat", ""), e.get("name", "")
        if (e.get("ph") != "X" or "dur" not in e or cat not in ("kernel", "gpu_memcpy")
                or "spin_kernel" in name):
            continue
        stream = (e.get("args") or {}).get("stream", e.get("tid"))
        events.append((name, cat, stream, float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return prof, events


def trace_overlap(events, launches: int):
    """{overlap_ms, ...} of ``device_trace``'s events of one call that
    launched ``launches`` port kernels: overlap_ms is the device time during
    which a collective's copy (a memcpy or an NCCL kernel on a stream that
    runs no port kernel) and a port kernel (a kernel outside ATen and NCCL)
    ran at once, from the intervals, not from summed times; span_ms from the
    first device event's start to the last one's end. Raises unless the trace
    holds every port kernel the call launched."""
    port = [ev for ev in events if ev[1] == "kernel" and "at::" not in ev[0]
            and "nccl" not in ev[0].lower()]
    if len(port) != launches:
        raise AssertionError(f"the trace holds {len(port)} port kernels, the call "
                             f"launched {launches}")
    port_streams = {ev[2] for ev in port}
    copies = [ev for ev in events if ev[1] == "gpu_memcpy" or "nccl" in ev[0].lower()]
    nccl = [ev[3:] for ev in copies if ev[2] not in port_streams]
    u_nccl, u_port = _spans_union(nccl), _spans_union([ev[3:] for ev in port])
    both, i, j = [], 0, 0
    while i < len(u_nccl) and j < len(u_port):
        a, b = max(u_nccl[i][0], u_port[j][0]), min(u_nccl[i][1], u_port[j][1])
        if a < b:
            both.append((a, b))
        if u_nccl[i][1] < u_port[j][1]:
            i += 1
        else:
            j += 1
    return {"overlap_ms": _spans_ms(both),
            "nccl_busy_ms": _spans_ms(_spans_union([ev[3:] for ev in copies])),
            "port_busy_ms": _spans_ms(u_port),
            "device_busy_ms": _spans_ms(_spans_union([ev[3:] for ev in events])),
            "span_ms": (max(ev[4] for ev in events) - min(ev[3] for ev in events)) / 1e3,
            "nccl_events": len(copies), "nccl_side_events": len(nccl),
            "port_events": len(port)}


def dist_chunks_phases(dev, gen, flush, smi) -> None:
    """The chunked column stage of ``fft_distributed`` at world size 1 on
    NCCL (run inside ``nccl_world``), each chunk count forced through
    PHASTFT_TPU_DIST_CHUNKS: each call against the card's oracle and the
    one-chunk output, its launches (each column pass once a chunk) and its
    device time. The turns, peaks and overlap are ``--chunks``'s."""
    import torch

    from phastft_tpu_torch import Direction, Options, PlannerDit32, PlannerDit64
    from phastft_tpu_torch.parallel import fft_distributed
    from phastft_tpu_torch.parallel.fourstep_dist import (
        _dd_row_planner, _factor, _factor_dd, column_chunks,
    )

    t_phase = time.perf_counter()
    run = counted(all_kernels())
    for engine, log_n, layouts, counts in DIST_CHUNK_CASES:
        n = 1 << log_n
        dtype = torch.float32 if engine == "f32" else torch.float64
        planner = chunk_planner(engine, n)
        tol = chunk_tol(engine, log_n)
        seeded = torch.Generator(device=dev).manual_seed(log_n)
        xr = torch.randn((n,), generator=seeded, device=dev, dtype=dtype)
        xi = torch.randn((n,), generator=seeded, device=dev, dtype=dtype)
        for layout in layouts:
            flags = {"permuted_input": True} if layout == "permuted_input" else {}
            if flags:
                n1, n2 = _factor(n, 1, planner.options.leaf_fft_size)
                perm = torch.arange(n, device=dev).view(n2, n1).t().reshape(-1)
                ar, ai = xr[perm], xi[perm]
                del perm
            else:
                ar, ai = xr, xi
            one = None
            for forced in counts:
                with dist_chunks_env(forced):
                    chunks = column_chunks(n, 1, planner, bool(flags))
                    if engine == "df64":
                        rp = _dd_row_planner(_factor_dd(n, 1)[1],
                                             planner.options.leaf_fft_size, engine, dev)
                        want = dd_dist_launches(rp, chunks)
                    else:
                        want = dist_launches(planner, layout, chunks)

                    def call():
                        return fft_distributed(ar, ai, Direction.Forward, planner, **flags)

                    out = run(call, want)
                    err = card_oracle_err(out, xr, xi)
                    check(f"{engine} 2^{log_n} {layout} at {chunks} chunks", err, tol)
                    if one is None:
                        if chunks != 1:
                            raise AssertionError(f"{engine} 2^{log_n}: the first count of "
                                                 f"{counts} runs {chunks} chunks, not one")
                        one, diff = out, 0.0
                    else:
                        diff = max_abs(out[0], out[1], one[0], one[1])
                    del out
                    times, enq = device_times(call, flush, DIST_CHUNK_REPS)
                    emit({"phase": "dist_chunks", "engine": engine, "n": n, "layout": layout,
                          "forced": forced, "chunks": chunks, "launches": want,
                          "rel_l2": err, "bound": tol, "max_abs_vs_one_chunk": diff,
                          "ms": float(np.median(times)), "min_max_ms": [min(times), max(times)],
                          "enqueue_ms": enq, "card": smi})
            del one, ar, ai
        del xr, xi, planner
        release_memory()
    emit({"phase": "dist_chunks_phases", "seconds": time.perf_counter() - t_phase,
          "launches": run.total, "card": smi})


def chunk_planner(engine: str, n: int):
    """The planner of a ``dist_chunks`` / ``--chunks`` case: f32, native f64,
    or the df64 engine on the f64 heuristic's options."""
    from phastft_tpu_torch import Options, PlannerDit32, PlannerDit64

    if engine == "f32":
        return PlannerDit32(n)
    if engine == "native":
        return PlannerDit64(n)
    guess = Options.guess_options(n, np.float64)
    return PlannerDit64(n, options=dataclasses.replace(guess, f64_engine=engine))


def chunk_tol(engine: str, log_n: int) -> float:
    """PERF.md section 2's bound of a transform of 2^log_n points."""
    return 5e-7 * max(1.0, log_n / 18.0) if engine == "f32" else DD_E2E_TOL


def chunks_mode(ranks: int) -> int:
    """``--chunks RANKS``: the chunked column stage of ``fft_distributed``
    against one chunk over RANKS ranks (1 or 4), one card and one process
    each on NCCL (``tcp://localhost``), the kernels built once before the
    ranks start (``chunks_rank``); rank 0's lines, beside every card's name
    and power limit. A rank that fails, or a run past CHUNK_MODE_TIMEOUT,
    fails the mode (every rank is stopped)."""
    import socket

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if ranks not in CHUNK_MODE_RUNS or torch.cuda.device_count() < ranks:
        print(f"chip_smoke: --chunks takes {sorted(CHUNK_MODE_RUNS)} ranks, one card "
              f"each; {torch.cuda.device_count()} cards", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    from phastft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.makedirs(OUT_DIR, exist_ok=True)
    logs = [open(os.path.join(OUT_DIR, f"chunks_rank{r}.log"), "w+") for r in range(ranks)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--chunks-rank",
                               str(r), str(ranks), str(port)],
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    deadline = time.monotonic() + CHUNK_MODE_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for log in logs:
        log.seek(0)
    text = [log.read() for log in logs]
    for log in logs:
        log.close()
    lines = [ln for ln in text[0].splitlines() if ln.startswith("{")]
    for ln in lines:
        print(ln, flush=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            print(f"-- rank {r}, rc {procs[r].returncode}:\n{text[r][-4000:]}", file=sys.stderr)
        return 1
    emit({"phase": "chunks_mode", "ranks": ranks, "seconds": time.perf_counter() - t0,
          "card": smi})
    return 0


def chunks_rank(rank: int, ranks: int, port: int) -> int:
    """One rank of ``--chunks``: for each (engine, log2 n) of
    CHUNK_MODE_RUNS[ranks], a signal of 2^log2 n points a rank (the same
    on every rank, from a seed) through ``fft_distributed`` in natural order
    at one chunk and at 4 (PHASTFT_TPU_DIST_CHUNKS): the rel L2 of the
    gathered result against a complex128 FFT on each card, the max abs
    difference of the two counts, each rank's added peak, the overlap of
    the collectives' copies with the port's kernels and the device span
    (``device_trace``, rank 0's), then the two counts in turns 1, 4, 4, 1
    (DIST_CHUNK_ROUNDS times), device ms (the slowest rank's median, each
    call behind a barrier and a sleep) and host clock; 4 chunks faster by
    DIST_CHUNK_GAIN than one, where the default is one, fail. One rank also runs
    CHUNK_MODE_PEAKS: the added peak of 4 chunks at the largest sizes, on
    bins of a direct DFT, and the native column tables' bytes."""
    import datetime

    import torch
    import torch.distributed as dist

    from phastft_tpu_torch import Direction
    from phastft_tpu_torch.parallel import fft_distributed
    from phastft_tpu_torch.parallel.fourstep_dist import column_chunks

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=ranks, timeout=datetime.timedelta(seconds=120),
                            device_id=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[rank]
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    kernels = all_kernels()

    def worst(x, op=dist.ReduceOp.MAX):
        t = torch.tensor([float(x)], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=op)
        return float(t.item())

    def times(call, reps):
        """(device ms of each call, the slowest rank's median; host ms)."""
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        call()
        cycles = sleep_cycles(2 * (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms, wall = [], []
        for _ in range(reps):
            flush.zero_()
            dist.barrier()
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return worst(np.median(dev_ms)), worst(np.median(wall))

    for engine, log_local in CHUNK_MODE_RUNS[ranks]:
        n = ranks << log_local
        m = n // ranks
        dtype = torch.float32 if engine == "f32" else torch.float64
        planner = chunk_planner(engine, n)
        seeded = torch.Generator(device=dev).manual_seed(log_local)
        xr = torch.randn((n,), generator=seeded, device=dev, dtype=dtype)
        xi = torch.randn((n,), generator=seeded, device=dev, dtype=dtype)
        want = torch.fft.fft(torch.complex(xr.double(), xi.double()))[rank * m:(rank + 1) * m]
        want = want.clone()
        sr, si = xr[rank * m:(rank + 1) * m].clone(), xi[rank * m:(rank + 1) * m].clone()
        del xr, xi
        torch.cuda.empty_cache()
        row = {"engine": engine, "n": n, "ranks": ranks}
        outs = {}
        for forced in (1, 4):
            with dist_chunks_env(forced):
                row[f"chunks_{forced}"] = column_chunks(n, ranks, planner)

                def call():
                    return fft_distributed(sr, si, Direction.Forward, planner)

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                before = sum(kernel_launches(k) for k in kernels)
                out = call()
                launched = sum(kernel_launches(k) for k in kernels) - before
                torch.cuda.synchronize()
                row[f"added_peak_gib_{forced}"] = worst(
                    (torch.cuda.max_memory_allocated() - held) / 2 ** 30)
                got = torch.complex(out[0].double(), out[1].double())
                num = worst(float(torch.linalg.vector_norm(got - want)) ** 2, dist.ReduceOp.SUM)
                den = worst(float(torch.linalg.vector_norm(want)) ** 2, dist.ReduceOp.SUM)
                row[f"rel_l2_{forced}"] = err = (num / den) ** 0.5
                check(f"{engine} 2^{n.bit_length() - 1} over {ranks} at {forced} chunks", err,
                      chunk_tol(engine, n.bit_length() - 1))
                outs[forced] = out
                del got, out
                _, events = device_trace(call)
                for k, v in trace_overlap(events, launched).items():
                    row[f"{k}_{forced}"] = v
        row["max_abs_4_vs_1"] = worst(max_abs(outs[4][0], outs[4][1], outs[1][0], outs[1][1]))
        del outs, want
        readings = {1: [], 4: []}
        walls = {1: [], 4: []}
        for _ in range(DIST_CHUNK_ROUNDS):
            for forced in (1, 4, 4, 1):
                with dist_chunks_env(forced):
                    ms, wall = times(lambda: fft_distributed(sr, si, Direction.Forward, planner),
                                     DIST_CHUNK_REPS)
                readings[forced].append(ms)
                walls[forced].append(wall)
        row.update(ms_one=readings[1], ms_four=readings[4], wall_ms_one=walls[1],
                   wall_ms_four=walls[4],
                   four_over_one=float(np.mean(readings[4]) / np.mean(readings[1])),
                   wall_four_over_one=float(np.mean(walls[4]) / np.mean(walls[1])))
        if rank == 0:
            emit({"phase": "chunks_turns", **row, "card": smi})
        with dist_chunks_env(None):
            default = column_chunks(n, ranks, planner)
        if default == 1 and row["four_over_one"] * DIST_CHUNK_GAIN < 1:
            raise AssertionError(f"{engine} 2^{n.bit_length() - 1} over {ranks}: 4 chunks "
                                 f"read {row['four_over_one']:.3f}x one chunk, a gain the "
                                 "default of one chunk (fourstep_dist._chunk_count) forgoes")
        del sr, si, planner
        release_memory()
    if ranks == 1:
        chunk_peaks(dev, smi)
    dist.destroy_process_group()
    return 0


def chunk_peaks(dev, smi) -> None:
    """CHUNK_MODE_PEAKS in a world of one: natural order at one chunk and at
    4, each on GIANT_BINS bins of a direct f64 DFT, with the peak it held
    beside its input, and the native column tables' bytes."""
    import torch

    from phastft_tpu_torch import Direction
    from phastft_tpu_torch.parallel import fft_distributed

    gen = torch.Generator(device=dev).manual_seed(0)
    for engine, log_n in CHUNK_MODE_PEAKS:
        n = 1 << log_n
        dtype = torch.float32 if engine == "f32" else torch.float64
        planner = chunk_planner(engine, n)
        xr = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
        xi = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
        ks = torch.randint(0, n, (GIANT_BINS,), generator=gen, device=dev)
        ks[:4] = torch.tensor([0, 1, n // 2, n - 1], device=dev)
        want = dft_bins(xr, xi, ks)
        for forced in (1, 4):
            with dist_chunks_env(forced):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                out = fft_distributed(xr, xi, Direction.Forward, planner)
                torch.cuda.synchronize()
                added = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
                got = torch.complex(out[0][ks].double(), out[1][ks].double())
                del out
                err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
                check(f"{engine} 2^{log_n} at {forced} chunks on {GIANT_BINS} bins", err,
                      chunk_tol(engine, log_n))
                row = {"engine": engine, "n": n, "chunks": forced, "rel_l2_bins": err,
                       "added_gib": added, "with_input_gib": 2 * xr.nbytes / 2 ** 30 + added}
                if engine == "native":
                    row["shard_table_bytes"] = dist_table_bytes(n, planner, forced)
                emit({"phase": "chunks_peak", **row, "card": smi})
                del got
        del xr, xi, planner, want
        release_memory()


def dist_table_bytes(n: int, planner, chunks: int) -> int:
    """Bytes of the native column stage's twiddle tables at world size 1 in
    ``chunks`` chunks, from the same cached table functions the pipeline calls (a
    column factor past 2048: the long columns' level tables, and the shard
    tables of their second pass)."""
    from phastft_tpu_torch.ops.longcol import _level_tables, long_split
    from phastft_tpu_torch.ops.native import col64_shard_tables
    from phastft_tpu_torch.parallel.fourstep_dist import _factor

    n1, n2 = _factor(n, 1, planner.options.leaf_fft_size)
    w = n2 // chunks
    dev = planner.device
    total = 0
    for c in range(chunks):
        m, nn, base = n1, n, c * w
        while m > 2048:
            pp, qq = long_split(m)
            total += sum(t.nbytes for t in _level_tables(nn, m, pp, w, base, False, dev))
            m, nn = qq, nn // pp
        if m > 1:
            total += sum(t.nbytes for t in col64_shard_tables(nn, m, w, base, dev))
    return total


def native_phases(dev, gen, flush, smi, top, launches, max_err) -> None:
    """The native f64 engine: its three kernels against their plain
    versions, its main path through the four f64 entries at every n =
    2^0..2^30, and the race that sets the f64 default."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit64, fft_64_dit, fft_64_dit_with_planner,
        fft_64_dit_with_planner_and_opts,
    )
    from phastft_tpu_torch.ops.colfft import colfft, colfft_out3d
    from phastft_tpu_torch.ops.dd import ddcol, ddcol_nocorr, ddleaf
    from phastft_tpu_torch.ops.leaf import hybrid, leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft
    from phastft_tpu_torch.ops.native import (
        col64, col64_plain, dif_twiddles_host, leaf64, leaf64_plain,
    )
    from phastft_tpu_torch.ops.ozdd import ozcol, ozleaft
    from phastft_tpu_torch.ops.stockham import split_correction_host
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_64, transpose2_plain

    from phastft_tpu_torch.fft import _cached_planner
    from phastft_tpu_torch.ops import _build
    from phastft_tpu_torch.ops._build import library
    from phastft_tpu_torch.ops.fourstep import split_levels

    lib = library()

    def randn64(shape, g=gen):
        return (torch.randn(shape, generator=g, device=dev, dtype=torch.float64),
                torch.randn(shape, generator=g, device=dev, dtype=torch.float64))

    def engine_planner(n, engine):
        """A planner on the default leaf rule of n, pinned to ``engine``."""
        guess = Options.guess_options(n, np.float64)
        return PlannerDit64(n, options=dataclasses.replace(guess, f64_engine=engine))

    def leaf_args(state, n):
        """leaf64's (correction, step tables) for n-point rows from a
        native state that holds them (the correction is None below 256
        points)."""
        n1 = n // 128
        return state.get(f"leaf{n1}"), (state[f"dif{n1}"][0] if n1 > 1 else None,
                                        state[f"dif{min(n, 128)}"][0])

    def leaf_state(n):
        """The native state of a planner whose plan is one n-point leaf."""
        return PlannerDit64(n, options=Options(leaf_fft_size=max(n, 128))).native_state

    def col_args(n1, n2):
        """col64's (split tables, step table): the planner's tables
        (``split{n1}x{n2}``, ``dif{n1}``), built from the same host
        functions for any (n1, n2)."""
        return (tuple(torch.from_numpy(a.copy()).to(dev)
                      for a in split_correction_host(n1, n2, "float64")[1:]),
                torch.from_numpy(dif_twiddles_host(n1)).to(dev))

    def col_bound(b, n1, n2):
        s2 = 1 << ((n2.bit_length() - 1) // 2)
        return native_bound(b * n1 * n2, n1.bit_length() - 1, 1,
                            16 * n1 * (n2 // s2 + s2) + 8 * n1)

    def transpose_parity(k, p, **where):
        equal = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        parity("transpose2_64", k, p, 0.0, **where)
        if not equal:
            raise AssertionError(f"transpose2_64 differs at {where}")

    # -- parity: each kernel against its plain version on the card
    max_err.update(leaf64=0.0, col64=0.0, transpose2_64=0.0)
    resident = {n: lib.phastft_leaf64_clusters(n) for n in (1 << 13, 1 << 14, 1 << 15,
                                                           1 << 16)}
    col_resident = {n1: lib.phastft_col64_clusters(n1) for n1 in (1024, 2048)}
    emit({"phase": "build_native", "leaf64_resident_clusters": resident,
          "col64_resident_clusters": col_resident})
    if min(resident.values()) < 1 or min(col_resident.values()) < 1:
        raise AssertionError(f"a native cluster shape does not fit the card: {resident}, "
                             f"{col_resident}")

    def parity(name, k, p, bound, **where):
        err = rel_l2(k[0], k[1], p[0], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        max_err[name] = max(max_err[name], mabs)
        emit({"phase": "parity_native", "kernel": name, **where, "rel_l2": err,
              "max_abs_err": mabs, "bound": bound})
        check(f"{name} parity at {where}", err, bound)

    for log_n in range(1, 17):
        n = 1 << log_n
        corr, steps = leaf_args(leaf_state(n), n)
        ragged = (1, resident[n] + 1) if n in resident else (3 * (4096 // n) + 1,)
        for rows in (NATIVE_LEAF_ROWS,) + ragged:
            x = randn64((rows, n))
            k = leaf64(*x, corr, n, steps)
            torch.cuda.synchronize()
            parity("leaf64", k, leaf64_plain(*x, corr, n, steps), DD_KERNEL_TOL,
                   n=n, rows=rows)
            del k, x
    col_shapes = ([(b, n1, n2) for n1, n2 in NATIVE_COL_SHAPES
                   for b in ((1, 3) if n2 == 1 << 13 else (1,))]
                  + list(NATIVE_LONG_COL_SHAPES)
                  + [(col_resident[1024] + 1, 1024, 32),
                     (col_resident[2048] // 2 + 1, 2048, 32)]
                  + list(NATIVE_NESTED_COL_SHAPES))
    for b, n1, n2 in col_shapes:
        tabs, w = col_args(n1, n2)
        x = randn64((b, n1, n2))
        k = col64(*x, tabs, n1, w)
        torch.cuda.synchronize()
        parity("col64", k, col64_plain(*x, tabs, n1, w), DD_KERNEL_TOL,
               batch=b, n1=n1, n2=n2)
        del k
        k = transpose2_64(*x)
        torch.cuda.synchronize()
        transpose_parity(k, transpose2_plain(*x), batch=b, n1=n1, n2=n2)
        del k, x
        release_memory()
    # the outer level of 2^30 (16 GiB a pair): the transpose first; then
    # col64_plain on each half of the columns, the input held on the host
    # meanwhile. log2(n2) is odd, so a half keeps the split factor s and its
    # tables are T1's matching columns and all of T2: the same products.
    b, n1, n2 = NATIVE_TOP_COL_SHAPE
    x = randn64((b, n1, n2))
    transpose_parity(transpose2_64(*x), transpose2_plain(*x), batch=b, n1=n1, n2=n2)
    release_memory()
    tabs, w = col_args(n1, n2)
    k = col64(*x, tabs, n1, w)
    host = tuple(a.cpu() for a in x)
    del x
    release_memory()
    h, s2 = n2 // 2, int(tabs[2].shape[1])
    if (n2.bit_length() - 1) % 2 != 1:
        raise AssertionError(f"col64 by halves needs an odd log2(n2), got n2 = {n2}")
    for c in range(2):
        cols = slice(c * h, (c + 1) * h)
        xs = tuple(a[..., cols].contiguous().to(dev) for a in host)
        ts = tuple(t[:, c * h // s2:(c + 1) * h // s2].contiguous() for t in tabs[:2])
        p = col64_plain(*xs, ts + tabs[2:], n1, w)
        del xs
        parity("col64", tuple(a[..., cols] for a in k), p, DD_KERNEL_TOL, batch=b, n1=n1,
               n2=n2, columns=f"{c * h}:{(c + 1) * h}")
        del p
    del k, host
    release_memory()

    # -- main path: counters at 0 just before, read just after; every
    # transform's launches are checked against its plan
    counters = (col64, leaf64, transpose2_64, transpose2, ddcol, ddcol_nocorr, ddleaf,
                ozcol, ozleaft, leaf, leaf3, hybrid, colfft, colfft_out3d, leaft)
    zero_launches(counters)
    run = counted(counters)
    errs, peaks = {}, {}

    def peak_run(log_n, fn, want):
        """run(fn, want); at NATIVE_PEAK_LOGS with the peak of allocated
        device memory above what was held before (fft_64_dit's tables
        built first)."""
        if log_n not in NATIVE_PEAK_LOGS:
            return run(fn, want)
        _cached_planner(1 << log_n, 64, dev).native_state
        torch.cuda.synchronize()
        release_memory()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = run(fn, want)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[log_n] = {"peak_bytes": peak, "held_before": held, "peak_gib": peak / 2 ** 30,
                        "added_gib": (peak - held) / 2 ** 30}
        return out

    def bins(n):
        """NATIVE_TOP_BINS bins of n: 0, 1, n/2, n-1 and random ones."""
        ks = torch.randint(0, n, (NATIVE_TOP_BINS,), generator=gen, device=dev)
        ks[:4] = torch.tensor([0, 1, n // 2, n - 1], device=dev)
        return ks

    def rel(got, want):
        return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))

    for log_n in NATIVE_E2E_LOGS:
        n = 1 << log_n
        xr, xi = randn64((n,))
        plan = PlannerDit64(n).plan
        out = peak_run(log_n, lambda: fft_64_dit(xr, xi, Direction.Forward),
                       native_launches(plan))
        if out[0].dtype != torch.float64:
            raise AssertionError(f"fft_64_dit returned {out[0].dtype}")
        err = card_oracle_err(out, xr, xi)
        if log_n == NATIVE_BINS_LOG:
            # the direct bins (the oracle at 2^30) against complex128, and
            # the port against both, on the same bins
            ks = bins(n)
            want = torch.fft.fft(torch.complex(xr, xi))[ks]
            release_memory()
            direct = dft_bins(xr, xi, ks)
            got = torch.complex(out[0][ks], out[1][ks])
            errs.update({f"bins_direct_vs_c128_2^{log_n}": rel(direct, want),
                         f"bins_port_vs_c128_2^{log_n}": rel(got, want),
                         f"bins_port_vs_direct_2^{log_n}": rel(got, direct)})
            check(f"direct bins at 2^{log_n}", errs[f"bins_direct_vs_c128_2^{log_n}"],
                  DD_E2E_TOL)
            del want, direct, got
        release_memory()
        back = run(lambda: fft_64_dit(out[0], out[1], Direction.Reverse),
                   native_launches(plan))
        rt = rel_l2(back[0], back[1], xr, xi)
        errs[f"fwd_2^{log_n}"], errs[f"roundtrip_2^{log_n}"] = err, rt
        check(f"native fft_64_dit 2^{log_n}", err, DD_E2E_TOL)
        check(f"native round trip 2^{log_n}", rt, DD_E2E_TOL)
        del out, back, xr, xi
    release_memory()
    # the top of the window: one f64 pair is 16 GiB. The input is dropped
    # once the bins are read and made again from its seed for the round
    # trip, so no more than three pairs are ever held.
    n = 1 << NATIVE_TOP_LOG
    plan = PlannerDit64(n).plan
    top_gen = torch.Generator(device=dev)
    xr, xi = randn64((n,), top_gen.manual_seed(NATIVE_TOP_LOG))
    out = peak_run(NATIVE_TOP_LOG, lambda: fft_64_dit(xr, xi, Direction.Forward),
                   native_launches(plan))
    if not (bool(torch.isfinite(out[0]).all()) and bool(torch.isfinite(out[1]).all())):
        raise AssertionError(f"native 2^{NATIVE_TOP_LOG}: output is not finite")
    ks = bins(n)
    want = dft_bins(xr, xi, ks)
    got = torch.complex(out[0][ks], out[1][ks])
    errs[f"bins_2^{NATIVE_TOP_LOG}"] = err = rel(got, want)
    check(f"native fft_64_dit 2^{NATIVE_TOP_LOG}, {NATIVE_TOP_BINS} bins", err, DD_E2E_TOL)
    del xr, xi, want, got
    release_memory()
    back = run(lambda: fft_64_dit(out[0], out[1], Direction.Reverse), native_launches(plan))
    del out
    release_memory()
    xr, xi = randn64((n,), top_gen.manual_seed(NATIVE_TOP_LOG))
    rt = rel_l2(back[0], back[1], xr, xi)
    errs[f"roundtrip_2^{NATIVE_TOP_LOG}"] = rt
    check(f"native round trip 2^{NATIVE_TOP_LOG}", rt, DD_E2E_TOL)
    del back, xr, xi
    release_memory()
    pair = 16 * n  # one f64 pair at 2^30
    if peaks[NATIVE_TOP_LOG]["peak_bytes"] - peaks[NATIVE_TOP_LOG]["held_before"] > 2 * pair:
        raise AssertionError(f"native 2^{NATIVE_TOP_LOG} holds more than its input and two "
                             f"pairs: {peaks[NATIVE_TOP_LOG]}")
    for log_n in NATIVE_BATCH_LOGS:
        n = 1 << log_n
        planner = PlannerDit64(n)
        xr, xi = randn64((3, n))
        out = run(lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, planner),
                  native_launches(planner.plan))
        errs[f"batch3_2^{log_n}"] = err = card_oracle_err(out, xr, xi)
        check(f"native 3 x 2^{log_n}", err, DD_E2E_TOL)
        del out, xr, xi
    # the other two entries: an engine-less Options() (2^16 leaves) and a
    # per-call "native" on a df64 planner
    n = 1 << 20
    bare = PlannerDit64(n, options=Options())
    xr, xi = randn64((n,))
    out = run(lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, bare),
              native_launches(bare.plan))
    errs["options_bare_2^20"] = err = card_oracle_err(out, xr, xi)
    check("native on Options() 2^20", err, DD_E2E_TOL)
    df = engine_planner(1 << 24, "df64")
    xr, xi = randn64((1 << 24,))
    out = run(lambda: fft_64_dit_with_planner_and_opts(
        xr, xi, Direction.Forward, df, Options(f64_engine="native")), native_launches(df.plan))
    errs["per_call_native_2^24"] = err = card_oracle_err(out, xr, xi)
    check("per-call native 2^24", err, DD_E2E_TOL)
    n = 1 << 25
    dr = torch.zeros(n, device=dev, dtype=torch.float64)
    dr[0] = float(n)
    back = run(lambda: fft_64_dit(dr, torch.zeros_like(dr), Direction.Reverse),
               native_launches(PlannerDit64(n).plan))
    exact = bool((back[0] == 1.0).all()) and bool((back[1] == 0.0).all())
    errs["inverse_scale_exact_2^25"] = exact
    if not exact:
        raise AssertionError("native inverse of N * delta is not exactly ones")
    del out, back, dr, xr, xi
    torch.cuda.synchronize()
    got = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_native", "rel_l2": errs, "launches": got, "want": run.total,
          "peaks": {f"2^{k}": v for k, v in peaks.items()}})
    if got != run.total:
        raise AssertionError(f"launches {got}, want {run.total}")
    for name in ("col64", "leaf64", "transpose2_64"):
        if got[name] < 1:
            raise AssertionError(f"{name} was never launched on the native main path")
        launches[name] = got[name]
    release_memory()

    # -- times: the race of the f64 contenders, and each kernel of the
    # native plan at each race size
    def race_row(fn):
        return {"ms": time_ms(fn, flush, 10), "wall_ms": wall_ms(fn, flush, 10)}

    race = {}
    for log_n, rows in NATIVE_RACE:
        n = 1 << log_n
        xr, xi = randn64((rows, n))
        native = engine_planner(n, "native")
        plan = native.plan
        row = {"native": race_row(lambda: fft_64_dit_with_planner(
                   xr, xi, Direction.Forward, native))}
        if log_n <= NATIVE_RACE_DF64_MAX_LOG:
            df = engine_planner(n, "df64")
            row["df64"] = race_row(lambda: fft_64_dit_with_planner(
                xr, xi, Direction.Forward, df))
            del df
            release_memory()
        if log_n in NATIVE_RACE_OZ_LOGS:
            oz = PlannerDit64(n, options=Options(f64_engine="df64-oz", leaf_fft_size=1 << 13))
            row["df64-oz"] = race_row(lambda: fft_64_dit_with_planner(
                xr, xi, Direction.Forward, oz))
            del oz
        if log_n <= NATIVE_RACE_LIBRARY_MAX_LOG:
            xc = torch.complex(xr, xi)
            row["library"] = race_row(lambda: torch.fft.fft(xc))
            del xc
            release_memory()
        levels = [(n1, n2) for n1, _, n2 in split_levels(plan)]
        bound = native_bound(rows * n, log_n, 1 + 2 * len(levels), native_tables(plan))
        engines = [e for e in ("native", "df64", "df64-oz") if e in row]
        winner = min(engines, key=lambda e: row[e]["ms"])
        guess = Options.guess_options(n, np.float64).f64_engine or "native"
        race[log_n] = winner
        emit({"phase": "race_native", "n": n, "rows": rows, "plan": repr(plan), "card": smi,
              **row, "transform_bound": bound, "winner": winner, "guess_options": guess})
        # each kernel of the plan alone, on the shapes the transform gives
        # it: every split level's col64 and transpose2_64, then the leaf on
        # the innermost rows (inputs: views of xr, xi)
        kern = {}
        batch = rows
        for i, (n1, n2) in enumerate(levels):
            x = tuple(a.reshape(batch, n1, n2) for a in (xr, xi))
            tabs, w = col_args(n1, n2)
            tag = "" if i == 0 else f"_level{i}"
            kern["col64" + tag] = {"ms": time_ms(lambda: col64(*x, tabs, n1, w), flush, 10),
                                   **col_bound(batch, n1, n2), "library_ms": None,
                                   "batch": batch, "n1": n1, "n2": n2}
            kern["transpose2_64" + tag] = {
                "ms": time_ms(lambda: transpose2_64(*x), flush, 10),
                **native_bound(rows * n, None),
                "library_ms": time_ms(lambda: (x[0].transpose(-1, -2).contiguous(),
                                               x[1].transpose(-1, -2).contiguous()),
                                      flush, 10), "batch": batch, "n1": n1, "n2": n2}
            if levels == [NATIVE_TOP]:
                # the kernels line's shapes: timed against, and held to,
                # the plain versions on the same inputs
                kern["col64"]["plain_ms"] = time_ms(lambda: col64_plain(*x, tabs, n1, w),
                                                    flush, 3)
                kern["transpose2_64"]["plain_ms"] = time_ms(
                    lambda: transpose2_plain(*x), flush, 3)
                parity("col64", col64(*x, tabs, n1, w), col64_plain(*x, tabs, n1, w),
                       DD_KERNEL_TOL, batch=rows, n1=n1, n2=n2, timed=True)
                transpose_parity(transpose2_64(*x), transpose2_plain(*x), batch=rows,
                                 n1=n1, n2=n2, timed=True)
            del x
            release_memory()
            batch *= n1
        ln = n * rows // batch
        corr, steps = leaf_args(native.native_state, ln)
        y = tuple(a.reshape(batch, ln) for a in (xr, xi))
        kern["leaf64"] = {"ms": time_ms(lambda: leaf64(*y, corr, ln, steps), flush, 10),
                          **native_bound(batch * ln, ln.bit_length() - 1, 1,
                                         native_tables(("leaf", ln // 128) if ln >= 128
                                                       else ("tiny", ln))),
                          "library_ms": None, "n": ln, "rows": batch}
        try:  # past NATIVE_RACE_LIBRARY_MAX_LOG the card may not hold it
            yc = torch.complex(*y)
            kern["leaf64"]["library_ms"] = time_ms(lambda: torch.fft.fft(yc), flush, 10)
        except (torch.cuda.OutOfMemoryError, RuntimeError) as exc:
            if log_n <= NATIVE_RACE_LIBRARY_MAX_LOG:
                raise
            kern["leaf64"]["library_note"] = f"not run: {type(exc).__name__}: {exc}"[:300]
        yc = None
        release_memory()
        if levels == [NATIVE_TOP]:
            kern["leaf64"]["plain_ms"] = time_ms(lambda: leaf64_plain(*y, corr, ln, steps),
                                                 flush, 3)
            parity("leaf64", leaf64(*y, corr, ln, steps), leaf64_plain(*y, corr, ln, steps),
                   DD_KERNEL_TOL, n=ln, rows=batch, timed=True)
            for name in kern:
                top[name] = {"plain_ms": None, "n": n, "rows": rows, **kern[name]}
        emit({"phase": "times_native", "n": n, "rows": rows, "card": smi, "kernels": kern})
        del xr, xi, y, native
        release_memory()
    emit({"phase": "race_native_winners", "winners": race,
          "guess_options": {log_n: Options.guess_options(1 << log_n, np.float64).f64_engine
                            for log_n, _ in NATIVE_RACE}})

    # -- col64 at n1 = 1024 / 2048: the long-column design (the entry as
    # built) against the one-block design on the same inputs, turns
    # cluster, one-block, one-block, cluster; both held to col64_plain
    oneblock = ctypes.CDLL(str(_build.BUILD_DIR / COL64_ONEBLOCK))
    oneblock.phastft_col64.argtypes = _build._SIGNATURES["phastft_col64"]
    oneblock.phastft_col64.restype = ctypes.c_int

    def col64_oneblock(xr, xi, tabs, n1, w):
        out = (torch.empty_like(xr), torch.empty_like(xi))
        rc = oneblock.phastft_col64(
            xr.data_ptr(), xi.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in tabs),
            out[0].data_ptr(), out[1].data_ptr(), xr.numel() // (n1 * xr.shape[-1]), n1,
            xr.shape[-1], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"col64's one-block build failed to launch: CUDA error {rc}")
        return out

    for b, n1, n2 in NATIVE_DESIGN_SHAPES:
        tabs, w = col_args(n1, n2)
        x = randn64((b, n1, n2))
        p = col64_plain(*x, tabs, n1, w)
        for name, fn in (("col64", col64), ("col64_oneblock", col64_oneblock)):
            err = rel_l2(*fn(*x, tabs, n1, w), *p)
            check(f"{name} parity at {(b, n1, n2)}", err, DD_KERNEL_TOL)
        del p
        turns = [time_ms(lambda: fn(*x, tabs, n1, w), flush, 10)
                 for fn in (col64, col64_oneblock, col64_oneblock, col64)]
        emit({"phase": "times_col64_designs", "batch": b, "n1": n1, "n2": n2, "card": smi,
              "cluster_ms": [turns[0], turns[3]], "oneblock_ms": turns[1:3],
              **col_bound(b, n1, n2)})
        del x
        release_memory()

    # -- leaf64 at every row length on 2^24 points: every block and cluster
    # shape of the kernel, beside its bound and complex128 torch.fft.fft
    for log_n in range(1, 17):
        n = 1 << log_n
        rows = NATIVE_LEAF_TIME_POINTS // n
        corr, steps = leaf_args(leaf_state(n), n)
        y = randn64((rows, n))
        yc = torch.complex(*y)
        emit({"phase": "times_native_rows", "n": n, "rows": rows, "card": smi,
              "ms": time_ms(lambda: leaf64(*y, corr, n, steps), flush, 10),
              **native_bound(rows * n, log_n, 1,
                             native_tables(("leaf", n // 128) if n >= 128 else ("tiny", n))),
              "library_ms": time_ms(lambda: torch.fft.fft(yc), flush, 10)})
        del y, yc
    release_memory()


def giant_phases(dev, gen, flush, smi, top, launches, max_err) -> None:
    """Transforms past 2^30 (run inside ``nccl_world``): the kernels on the
    shapes those plans give them, the main path through the public entries
    at f32 C2C 2^31 (also on ``fft_distributed``), f32 R2C / C2R 2^32 and
    f64 R2C / C2R 2^31 with each one's peak of allocated memory, the leaf
    kernels on batches of 2^31 elements, the untangle table's build on the
    host and on the card, and times."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerDit64, PlannerR2c32, PlannerR2c64,
        c2r_fft_f32_with_planner, c2r_fft_f64_with_planner, fft_32_dit_with_planner,
        r2c_fft_f32_with_planner, r2c_fft_f64_with_planner,
    )
    from phastft_tpu_torch.ops import r2c as R
    from phastft_tpu_torch.ops.colfft import (
        col_tile3d, colfft, colfft_nocorr, colfft_out3d, colfft_out3d_plain, colfft_plain,
    )
    from phastft_tpu_torch.ops.leaf import hybrid, leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft, leaft_plain
    from phastft_tpu_torch.ops.native import col64, col64_nocorr, leaf64, leaf64_plain
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_64
    from phastft_tpu_torch.parallel import fft_distributed

    n = 1 << GIANT_LOG
    gib = float(1 << 30)

    def randn(shape, dtype=torch.float32, g=gen):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def seeded(seed, shape, dtype=torch.float32):
        """Made again from its seed after a transform that could not hold it."""
        return randn(shape, dtype, torch.Generator(device=dev).manual_seed(seed))

    def parity(name, got, want, tol, **where):
        err, mabs = rel_l2(got[0], got[1], want[0], want[1], worst=True)
        max_err[name] = max(max_err.get(name, 0.0), mabs)
        emit({"phase": "parity_giant", "kernel": name, **where, "rel_l2": err,
              "max_abs_err": mabs, "bound": tol})
        check(f"{name} at {where}", err, tol)

    def bins_err(got, want, ks):
        g = torch.complex(got[0][ks].double(), got[1][ks].double())
        return float(torch.linalg.vector_norm(g - want) / torch.linalg.vector_norm(want))

    # -- the kernels at the shapes of the 2^31 plan: the outer level (1024,
    # 2^21) on colfft's clusters and transpose2, the inner level 1024 x (128,
    # 2^14) on colfft_out3d and leaft; slices that include the last columns,
    # rows and entries against the plain versions
    release_memory()
    planner = PlannerDit32(n)
    _, n1, inner, n2 = planner.plan
    _, a1, _, a2 = inner
    corrs = planner.leaf_corrs
    xr, xi = randn((n1, n2)), randn((n1, n2))
    c = colfft(xr, xi, corrs[f"pcol{n1}x{n2}"], n1)
    torch.cuda.synchronize()
    w = GIANT_SLICE
    for c0 in (0, n2 // 2, n2 - w):
        want = colfft_plain(xr[:, c0:c0 + w].contiguous(), xi[:, c0:c0 + w].contiguous(),
                            None, n1, n_total=n, col_base=c0)
        parity("colfft", (c[0][:, c0:c0 + w], c[1][:, c0:c0 + w]), want, KERNEL_TOL,
               n1=n1, n2=n2, columns=[c0, c0 + w])
        del want
    times = {"colfft": {"ms": time_ms(lambda: colfft(xr, xi, corrs[f"pcol{n1}x{n2}"], n1),
                                      flush, GIANT_TIME_REPS),
                        "n1": n1, "n2": n2,
                        **dict(zip(("bound_ms", "bound_by"),
                                   kernel_bound(n, n1.bit_length() - 1, 2 * n1 * 128)))}}
    del xr, xi
    release_memory()
    t = transpose2(*c)
    torch.cuda.synchronize()
    for r0 in (0, n2 // 2, n2 - w):
        same = all(bool(torch.equal(t[i][r0:r0 + w], c[i][:, r0:r0 + w].t())) for i in (0, 1))
        max_err["transpose2"] = max(max_err.get("transpose2", 0.0), 0.0 if same else 1.0)
        emit({"phase": "parity_giant", "kernel": "transpose2", "rows": n1, "cols": n2,
              "out_rows": [r0, r0 + w], "bit_for_bit": same})
        if not same:
            raise AssertionError(f"transpose2 at ({n1}, {n2}) rows {r0}: not bit for bit")
    del t
    times["transpose2"] = {
        "ms": time_ms(lambda: transpose2(*c), flush, GIANT_TIME_REPS), "rows": n1, "cols": n2,
        "library_ms": time_ms(lambda: [x.transpose(-1, -2).contiguous() for x in c], flush,
                              GIANT_TIME_REPS),
        **dict(zip(("bound_ms", "bound_by"), copy_bound(n)))}
    release_memory()
    # the inner level on the outer level's rows: n1 entries of (a1, a2)
    view = (n1, a1, a2)
    tabs3, mats = corrs[f"pcolT{a1}x{a2}"], corrs[f"leafT{a2}"]
    c3 = colfft_out3d(c[0].view(view), c[1].view(view), tabs3, a1)
    torch.cuda.synchronize()
    for b in (0, n1 // 2, n1 - 1):
        want = colfft_out3d_plain(c[0][b:b + 1].view(1, a1, a2),
                                  c[1][b:b + 1].view(1, a1, a2), tabs3, a1)
        parity("colfft_out3d", (c3[0][b:b + 1], c3[1][b:b + 1]), want, KERNEL_TOL,
               batch_entry=b, n1=a1, n2=a2)
    times["colfft_out3d"] = {
        "ms": time_ms(lambda: colfft_out3d(c[0].view(view), c[1].view(view), tabs3, a1),
                      flush, GIANT_TIME_REPS), "batch": n1, "n1": a1, "n2": a2,
        **dict(zip(("bound_ms", "bound_by"),
                   kernel_bound(n, a1.bit_length() - 1, 2 * a1 * col_tile3d(a1, a2))))}
    del c
    release_memory()
    d = leaft(*c3, mats, a1)
    torch.cuda.synchronize()
    for b in (0, n1 // 2, n1 - 1):
        want = leaft_plain(c3[0][b:b + 1], c3[1][b:b + 1], mats, a1)
        parity("leaft", (d[0][b:b + 1], d[1][b:b + 1]), want, KERNEL_TOL,
               batch_entry=b, n1=a1, n2=a2)
    del d
    times["leaft"] = {
        "ms": time_ms(lambda: leaft(*c3, mats, a1), flush, GIANT_TIME_REPS),
        "batch": n1, "n1": a1, "n2": a2,
        **dict(zip(("bound_ms", "bound_by"),
                   kernel_bound(n, a2.bit_length() - 1, 2 * (a2 // 128) * 128)))}
    for row in times.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "times_giant", "level": f"the kernels of 2^{GIANT_LOG}", "card": smi,
          "kernels": times})
    del c3
    release_memory()

    # -- the leaf kernels on batches of 2^31 elements: the first, middle and
    # last rows against an f64 FFT and the plain version (a wrapped 32-bit
    # offset lands on the last rows)
    for name, rows, m, tag in GIANT_LEAF_BATCHES:
        f64 = tag == "f64"
        dtype = torch.float64 if f64 else torch.float32
        x = (randn((rows, m), dtype), randn((rows, m), dtype))
        if f64:
            state = PlannerDit64(m, options=Options(leaf_fft_size=m)).native_state
            args = (state.get(f"leaf{m // 128}"), m,
                    (state[f"dif{m // 128}"][0], state["dif128"][0]))
            kern, plain = leaf64, leaf64_plain
        else:
            kern, plain, args, _ = leaf_call(PlannerDit32(m))
            if kern.__name__ != name:
                raise AssertionError(f"the {m}-point plan runs {kern.__name__}, not {name}")
        y = kern(*x, *args)
        torch.cuda.synchronize()
        errs = {}
        for r0 in (0, rows // 2, rows - GIANT_LEAF_ROWS):
            sl = slice(r0, r0 + GIANT_LEAF_ROWS)
            got = (y[0][sl], y[1][sl])
            want = torch.fft.fft(torch.complex(x[0][sl].double(), x[1][sl].double()), dim=-1)
            errs[f"rows_{r0}"] = err = rel_l2(got[0], got[1], want.real, want.imag)
            check(f"{name} ({rows}, {m}) rows {r0}", err,
                  DD_E2E_TOL if f64 else 5e-7 * max(1.0, (m.bit_length() - 1) / 18.0))
            parity(name, got, plain(x[0][sl], x[1][sl], *args),
                   DD_KERNEL_TOL if f64 else KERNEL_TOL, rows=[r0, r0 + GIANT_LEAF_ROWS],
                   batch=rows, n=m)
        del y, got, want
        release_memory()
        log_m = m.bit_length() - 1
        bound = (native_bound(rows * m, log_m) if f64
                 else dict(zip(("bound_ms", "bound_by"), kernel_bound(rows * m, log_m))))
        ms = time_ms(lambda: kern(*x, *args), flush, GIANT_TIME_REPS)
        # one library call on the same rows: torch.fft.fft of complex64 /
        # complex128; where it cannot hold its output beside the input, on
        # the first half of the rows (the shape is named)
        xc = torch.complex(*x)
        del x
        release_memory()
        library = {"rows": rows, "n": m}
        try:
            library["ms"] = time_ms(lambda: torch.fft.fft(xc), flush, GIANT_TIME_REPS)
        except (torch.OutOfMemoryError, RuntimeError) as exc:
            torch.cuda.synchronize()
            library["error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
            release_memory()
            part = xc[:rows // 2]
            library["half_rows"] = {"rows": rows // 2, "n": m, "ms": time_ms(
                lambda: torch.fft.fft(part), flush, GIANT_TIME_REPS)}
            del part
        emit({"phase": "e2e_giant_leaf", "kernel": name, "rows": rows, "n": m,
              "elements": rows * m, "rel_l2_vs_f64_fft": errs, "ms": ms, **bound,
              "bound_share": bound["bound_ms"] / ms, "library": library, "card": smi})
        del xc
        release_memory()

    # -- the main path: counters at 0 just before, read just after
    counters = (colfft, colfft_out3d, colfft_nocorr, leaft, leaf, leaf3, hybrid, transpose2,
                col64, col64_nocorr, leaf64, transpose2_64, R.deinterleave, R.untangle,
                R.pre_untangle, R.interleave_scale)
    zero_launches(counters)
    run = counted(counters)
    c2c = f32_row_launches(planner.plan)
    errs, peaks, builds = {}, {}, {}

    def peaked(key, fn, want):
        """run(fn, want) with the peak of allocated bytes over it in peaks,
        the allocator's cache emptied first (the transforms of 2^31 points
        fill the card to within 8 GiB)."""
        release_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = run(fn, want)
        torch.cuda.synchronize()
        peaks[key] = {"peak_gib": torch.cuda.max_memory_allocated() / gib,
                      "held_before_gib": held / gib}
        return out

    def ones_exact(key, re, im=None):
        """The inverse of N * delta: exactly ones (the scale is 1/N)."""
        exact = bool((re == 1.0).all()) and (im is None or bool((im == 0.0).all()))
        errs[f"inverse_of_n_delta_exact_{key}"] = exact
        if not exact:
            raise AssertionError(f"{key}: the inverse of N * delta is not exactly ones")

    xr, xi = seeded(GIANT_SEED, (n,)), seeded(GIANT_SEED + 1, (n,))
    ks = torch.randint(0, n, (GIANT_BINS,), generator=gen, device=dev)
    ks[:4] = torch.tensor([0, 1, n // 2, n - 1], device=dev)
    want = dft_bins(xr, xi, ks)
    tol = 5e-7 * max(1.0, GIANT_LOG / 18.0)
    entries = {
        "c2c": lambda a, b, direction: fft_32_dit_with_planner(a, b, direction, planner),
        "fft_distributed": lambda a, b, direction: fft_distributed(a, b, direction, planner),
    }
    wants = {"c2c": c2c, "fft_distributed": dist_launches(planner, "natural")}
    for key, entry in entries.items():
        out = peaked(f"{key}_forward", lambda: entry(xr, xi, Direction.Forward), wants[key])
        errs[f"{key}_bins"] = err = bins_err(out, want, ks)
        check(f"{key} 2^{GIANT_LOG} on {GIANT_BINS} bins", err, tol)
        back = peaked(f"{key}_inverse", lambda: entry(*out, Direction.Reverse), wants[key])
        del out
        errs[f"{key}_roundtrip"] = rt = rel_l2(back[0], back[1], xr, xi, worst=True)[0]
        check(f"{key} round trip 2^{GIANT_LOG}", rt, 1e-6)
        del back
        release_memory()
        dr = torch.zeros(n, device=dev)
        dr[0] = float(n)
        ones_exact(key, *run(lambda: entry(dr, torch.zeros_like(dr), Direction.Reverse),
                             wants[key]))
        del dr
        release_memory()
    check(f"peak of the f32 C2C at 2^{GIANT_LOG}, GiB", peaks["c2c_forward"]["peak_gib"],
          GIANT_PEAK_GIB)
    del xr, xi, want
    release_memory()

    real = {"f32": (PlannerR2c32, r2c_fft_f32_with_planner, c2r_fft_f32_with_planner,
                    torch.float32),
            "f64": (PlannerR2c64, r2c_fft_f64_with_planner, c2r_fft_f64_with_planner,
                    torch.float64)}
    for tag, log_r in GIANT_R2C:
        cls, r2c_p, c2r_p, dtype = real[tag]
        m = 1 << log_r
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = cls(m)
        torch.cuda.synchronize()
        builds[f"{tag}_planner_r2c_2^{log_r}_s"] = time.perf_counter() - t0
        inner = (native_launches if tag == "f64" else f32_row_launches)(p.dit_planner.plan)
        fwd = {"deinterleave": 1, "untangle": 1, **inner}
        inv = {"pre_untangle": 1, "interleave_scale": 1, **inner}
        x = seeded(GIANT_SEED + 2, (m,), dtype)
        spec = peaked(f"{tag}_r2c_2^{log_r}", lambda: r2c_p(x, p), fwd)
        rk = torch.randint(0, m // 2 + 1, (GIANT_BINS,), generator=gen, device=dev)
        rk[:4] = torch.tensor([0, 1, m // 4, m // 2], device=dev)
        errs[f"{tag}_r2c_2^{log_r}_bins"] = err = bins_err(spec, dft_bins(x, None, rk), rk)
        check(f"{tag} r2c 2^{log_r} on {GIANT_BINS} bins", err,
              DD_E2E_TOL if tag == "f64" else 5e-7 * max(1.0, log_r / 18.0))
        if bool(spec[1][0] != 0) or bool(spec[1][-1] != 0):
            raise AssertionError(f"{tag} r2c 2^{log_r}: the DC or Nyquist bin is not real")
        del x
        release_memory()
        back = peaked(f"{tag}_c2r_2^{log_r}", lambda: c2r_p(*spec, p), inv)
        if p._c2r_tw is not None:
            raise AssertionError(f"{tag} c2r 2^{log_r} built the full-length table")
        del spec
        x = seeded(GIANT_SEED + 2, (m,), dtype)
        errs[f"{tag}_roundtrip_2^{log_r}"] = rt = rel_l2(back, None, x, None, worst=True)[0]
        check(f"{tag} round trip 2^{log_r}", rt, DD_E2E_TOL if tag == "f64" else 1e-6)
        del back, x
        release_memory()
        sr = torch.zeros(m // 2 + 1, device=dev, dtype=dtype)
        sr[0] = float(m)
        back = run(lambda: c2r_p(sr, torch.zeros_like(sr), p), inv)
        ones_exact(f"{tag}_c2r_2^{log_r}", back)
        del sr, back, p
        release_memory()
    torch.cuda.synchronize()
    got = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_giant", "n": n, "rel_l2": errs, "peaks": peaks, "builds": builds,
          "launches": got, "want": run.total, "card": smi})
    if got != run.total:
        raise AssertionError(f"launches {got}, want {run.total}")
    for name, count in got.items():
        if count:
            launches[name] = launches.get(name, 0) + count

    # -- the untangle table of n = 2^32 (2^30 + 1 entries a plane): numpy on
    # the host (what the planner ran before) against the card's build
    m = 1 << GIANT_R2C[0][1]
    t0 = time.perf_counter()
    host = R.r2c_twiddles_host(m, m // 4 + 1, np.float32)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = R.r2c_twiddles(m, m // 4 + 1, np.float32, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    probe = torch.arange(0, m // 4 + 1, (m // 4) // 4096, dtype=torch.int64)
    diff = max(float(np.abs(h[probe.numpy()] - c[probe.to(dev)].cpu().numpy()).max())
               for h, c in zip(host, card))
    emit({"phase": "giant_tables", "n": m, "entries": m // 4 + 1, "host_numpy_s": host_s,
          "card_s": card_s, "max_abs_diff_on_4097_entries": diff, "card": smi})
    del host, card
    release_memory()

    # -- times: each whole transform, medians of GIANT_TIME_REPS, beside the
    # bound of its passes and one torch call computing the same function
    def library(fn):
        try:
            ms = time_ms(fn, flush, GIANT_TIME_REPS)
        except (torch.OutOfMemoryError, RuntimeError) as exc:
            torch.cuda.synchronize()
            return f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
        return ms

    # the real transforms' four passes at n = 2^32 (2^31 bins), each beside
    # its bound and, for the two copies, one torch call
    m = 1 << GIANT_R2C[0][1]
    p = PlannerR2c32(m)
    tw = (p.twiddles_re, p.twiddles_im)
    b = r2c_bounds(1, m, False)
    x = seeded(GIANT_SEED + 2, (m,))
    passes = {
        "deinterleave": {
            "ms": time_ms(lambda: R.deinterleave(x), flush, GIANT_TIME_REPS),
            "library_ms": time_ms(lambda: x.view(m // 2, 2).movedim(-1, 0).contiguous(),
                                  flush, GIANT_TIME_REPS)}}
    z = R.deinterleave(x)
    del x
    release_memory()
    passes["untangle"] = {"ms": time_ms(lambda: R.untangle(*z, *tw), flush, GIANT_TIME_REPS),
                          "library_ms": None,
                          "schedule_ms": pair_schedule_ms("untangle", z, tw, flush,
                                                          GIANT_TIME_REPS)}
    spec = R.untangle(*z, *tw)
    passes["interleave_scale"] = {
        "ms": time_ms(lambda: R.interleave_scale(*z, 2.0 / m), flush, GIANT_TIME_REPS),
        "library_ms": time_ms(lambda: torch.stack(z, -1), flush, GIANT_TIME_REPS)}
    del z
    release_memory()
    passes["pre_untangle"] = {
        "ms": time_ms(lambda: R.pre_untangle(*spec, *tw), flush, GIANT_TIME_REPS),
        "library_ms": None,
        "schedule_ms": pair_schedule_ms("pre_untangle", spec, tw, flush, GIANT_TIME_REPS)}
    for name, row in passes.items():
        row.update(n=m, rows=1, dtype="f32", **b[name])
        row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "times_giant", "level": f"the real transforms' passes at 2^{m.bit_length() - 1}",
          "card": smi, "passes": passes})
    del p, tw, spec
    release_memory()

    xr, xi = seeded(GIANT_SEED, (n,)), seeded(GIANT_SEED + 1, (n,))
    out = {}
    for key, entry in entries.items():
        out[key] = {
            "forward_ms": time_ms(lambda: entry(xr, xi, Direction.Forward), flush,
                                  GIANT_TIME_REPS),
            "forward_wall_ms": wall_ms(lambda: entry(xr, xi, Direction.Forward), flush,
                                       GIANT_TIME_REPS),
            "inverse_ms": time_ms(lambda: entry(xr, xi, Direction.Reverse), flush,
                                  GIANT_TIME_REPS),
            "bound_ms": 4 * copy_bound(n)[0]}
        release_memory()
    xc = torch.complex(xr, xi)
    del xr, xi
    release_memory()
    out["c2c"]["library_ms"] = library(lambda: torch.fft.fft(xc))
    del xc
    release_memory()
    for tag, log_r in GIANT_R2C:
        cls, r2c_p, c2r_p, dtype = real[tag]
        m = 1 << log_r
        p = cls(m)
        x = seeded(GIANT_SEED + 2, (m,), dtype)
        b = r2c_bounds(1, m, tag == "f64")
        inner_passes = sum(f32_row_launches(p.dit_planner.plan).values()) if tag == "f32" \
            else sum(native_launches(p.dit_planner.plan).values())
        inner_ms = inner_passes * (16 if tag == "f32" else 32) * (m // 2) / HBM_BYTES_PER_S * 1e3
        row = {"r2c_ms": time_ms(lambda: r2c_p(x, p), flush, GIANT_TIME_REPS),
               "r2c_wall_ms": wall_ms(lambda: r2c_p(x, p), flush, GIANT_TIME_REPS),
               "r2c_bound_ms": b["deinterleave"]["bound_ms"] + inner_ms
               + b["untangle"]["bound_ms"]}
        spec = r2c_p(x, p)
        del x
        release_memory()
        row["c2r_ms"] = time_ms(lambda: c2r_p(*spec, p), flush, GIANT_TIME_REPS)
        row["c2r_bound_ms"] = (b["pre_untangle"]["bound_ms"] + inner_ms
                               + b["interleave_scale"]["bound_ms"])
        del spec, p
        release_memory()
        x = seeded(GIANT_SEED + 2, (m,), dtype)
        row["rfft_library_ms"] = library(lambda: torch.fft.rfft(x))
        out[f"{tag}_r2c_2^{log_r}"] = row
        del x
        release_memory()
    emit({"phase": "times_giant", "n": n, "card": smi, **out})


def edge_phases(dev, gen, flush, smi, top, launches, max_err) -> None:
    """The window's edges (run inside ``nccl_world``, module docstring item
    38): the four kernels at their new shapes against their plain versions,
    the main path at every kind of leaf size and on a world of one, and the
    new shapes' times."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerDit64, fft_32_dit_with_planner,
        fft_64_dit_with_planner,
    )
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, colfft, colfft_nocorr, colfft_nocorr_plain,
        colfft_out3d, colfft_plain,
    )
    from phastft_tpu_torch.ops.dd import (
        dd_col_tables_host, ddcol, ddcol_nocorr, ddcol_nocorr_plain, ddcol_plain, ddleaf,
    )
    from phastft_tpu_torch.ops.df64 import split_f64
    from phastft_tpu_torch.ops.leaf import hybrid, leaf, leaf3, leaf3_plain
    from phastft_tpu_torch.ops.leaft import leaft
    from phastft_tpu_torch.ops.mxu import mxu_leaf_tables3_host
    from phastft_tpu_torch.ops.native import (
        col64, col64_nocorr, col64_nocorr_plain, col64_plain, col64_shard_tables,
        dif_twiddles, leaf64,
    )
    from phastft_tpu_torch.ops.ozdd import ozcol, ozleaft
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_64
    from phastft_tpu_torch.parallel import fft_distributed

    t_edges = time.perf_counter()

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def parity(name, got, want, tol, dd=False, **where):
        err, mabs = (dd_rel(got, want) if dd
                     else rel_l2(got[0], got[1], want[0], want[1], worst=True))
        max_err[name] = max(max_err.get(name, 0.0), mabs)
        emit({"phase": "parity_edges", "kernel": name, **where, "rel_l2": err,
              "max_abs_err": mabs, "bound": tol})
        check(f"{name} at {where}", err, tol)

    def timed(name, fn, plain, bound, library=None, **where):
        emit({"phase": "times_edges", "kernel": name, **where, "card": smi,
              "ms": time_ms(fn, flush, EDGE_TIME_REPS),
              "plain_ms": time_ms(plain, flush, 3), **bound,
              "library_ms": time_ms(library, flush, EDGE_TIME_REPS) if library else None})

    def bound_of(pair):
        return dict(zip(("bound_ms", "bound_by"), pair))

    # -- colfft: the classic mode on the planner's tables (n2 columns wide
    # below 128), the shard mode on the block of each of EDGE_RANKS ranks,
    # the bare mode; each shape timed
    for n1 in EDGE_COL_N1S:
        for n2 in EDGE_COL_N2S:
            b = max(1, EDGE_COL_POINTS // (n1 * n2))
            x = (randn((b, n1, n2)), randn((b, n1, n2)))
            tabs = tuple(torch.from_numpy(a).to(dev) for a in
                         col_split_tables_host(n1, n2, "float32", t=col_tile(n1, n2)))
            parity("colfft", colfft(*x, tabs, n1), colfft_plain(*x, tabs, n1), KERNEL_TOL,
                   n1=n1, n2=n2, batch=b, mode="classic")
            block = (x[0][-1].contiguous(), x[1][-1].contiguous())
            n_total = n1 * n2 * EDGE_RANKS
            for r in range(EDGE_RANKS):
                kw = dict(n_total=n_total, col_base=r * n2)
                parity("colfft", colfft(*block, None, n1, **kw),
                       colfft_plain(*block, None, n1, **kw), KERNEL_TOL,
                       n1=n1, n2=n2, mode="shard", rank=r, ranks=EDGE_RANKS)
            timed("colfft", lambda: colfft(*x, tabs, n1), lambda: colfft_plain(*x, tabs, n1),
                  bound_of(kernel_bound(b * n1 * n2, n1.bit_length() - 1, 2 * n1 * n2)),
                  n1=n1, n2=n2, batch=b, mode="classic")
            if n2 in EDGE_NOCORR_N2S:
                parity("colfft_nocorr", colfft_nocorr(*x, n1), colfft_nocorr_plain(*x, n1),
                       KERNEL_TOL, n1=n1, n2=n2, batch=b)
                xc = torch.complex(*x)
                timed("colfft_nocorr", lambda: colfft_nocorr(*x, n1),
                      lambda: colfft_nocorr_plain(*x, n1),
                      bound_of(kernel_bound(b * n1 * n2, n1.bit_length() - 1)),
                      lambda: torch.fft.fft(xc, dim=-2), n1=n1, n2=n2, batch=b)
                del xc
            del x, block

    # -- col64 and its bare mode on one-column blocks (the shard tables of
    # each of EDGE_RANKS ranks' column; rank 0's is the split table of a
    # tiny-row split, W^0 = 1)
    for n1 in EDGE_COL_N1S:
        b = EDGE_COL_POINTS // n1
        x = (randn((b, n1, 1), torch.float64), randn((b, n1, 1), torch.float64))
        steps = dif_twiddles(n1, dev)
        for r in range(EDGE_RANKS):
            tabs = col64_shard_tables(n1 * EDGE_RANKS, n1, 1, r, dev)
            parity("col64", col64(*x, tabs, n1, steps), col64_plain(*x, tabs, n1, steps),
                   DD_KERNEL_TOL, n1=n1, n2=1, batch=b, rank=r, ranks=EDGE_RANKS)
        parity("col64_nocorr", col64_nocorr(*x, n1, steps),
               col64_nocorr_plain(*x, n1, steps), DD_KERNEL_TOL, n1=n1, n2=1, batch=b)
        tabs = col64_shard_tables(n1, n1, 1, 0, dev)
        log1 = n1.bit_length() - 1
        timed("col64", lambda: col64(*x, tabs, n1, steps),
              lambda: col64_plain(*x, tabs, n1, steps),
              native_bound(b * n1, log1, table_bytes=32 * n1 + 8 * n1), n1=n1, n2=1, batch=b)
        xc = torch.complex(*x)
        timed("col64_nocorr", lambda: col64_nocorr(*x, n1, steps),
              lambda: col64_nocorr_plain(*x, n1, steps),
              native_bound(b * n1, log1, table_bytes=8 * n1),
              lambda: torch.fft.fft(xc, dim=-2), n1=n1, n2=1, batch=b)
        del x, xc

    # -- ddcol at n2 = 1..64 on dd_col_tables_host(n1, n2), ddcol_nocorr at
    # n2 = 1
    def quad(shape):
        return (*split_f64(randn(shape, torch.float64)), *split_f64(randn(shape, torch.float64)))

    for n1, n2 in EDGE_DD_COL:
        b = max(1, EDGE_COL_POINTS // (n1 * n2))
        q = quad((b, n1, n2))
        _, t1, t2 = dd_col_tables_host(n1, n2)
        t1, t2 = (tuple(torch.from_numpy(a.copy()).to(dev) for a in t) for t in (t1, t2))
        parity("ddcol", ddcol(*q, t1, t2, n1), ddcol_plain(*q, t1, t2, n1), DD_KERNEL_TOL,
               dd=True, n1=n1, n2=n2, batch=b)
        timed("ddcol", lambda: ddcol(*q, t1, t2, n1), lambda: ddcol_plain(*q, t1, t2, n1),
              ddcol_bound(b, n1, n2), n1=n1, n2=n2, batch=b)
        if n2 == 1:
            parity("ddcol_nocorr", ddcol_nocorr(*q, n1), ddcol_nocorr_plain(*q, n1),
                   DD_KERNEL_TOL, dd=True, n1=n1, n2=n2, batch=b)
            xc = torch.complex(q[0].double() + q[1].double(), q[2].double() + q[3].double())
            timed("ddcol_nocorr", lambda: ddcol_nocorr(*q, n1),
                  lambda: ddcol_nocorr_plain(*q, n1), ddcol_bound(b, n1, n2, False),
                  lambda: torch.fft.fft(xc, dim=-2), n1=n1, n2=n2, batch=b)
            del xc
        del q
    release_memory()

    # -- leaf3 at a = 256 (rows of 2^17) on EDGE_LEAF3_ROWS rows, the first
    # and last rows against the plain version
    mats = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in mxu_leaf_tables3_host(256, 128, "float32"))
    rows, n = EDGE_LEAF3_ROWS, 1 << 17
    x = (randn((rows, n)), randn((rows, n)))
    out = leaf3(*x, mats, 256, 128)
    k = EDGE_LEAF3_CHECK
    for r0 in (0, rows - k):
        part = tuple(a[r0:r0 + k] for a in x)
        parity("leaf3", tuple(o[r0:r0 + k] for o in out), leaf3_plain(*part, mats, 256, 128),
               KERNEL_TOL, n=n, rows=[r0, r0 + k], of_rows=rows)
    del out
    xc = torch.complex(*x)
    bound = bound_of(kernel_bound(rows * n, 17, 2 * 256 + 2 * 128 + 2 * 256 * 512 + 2 * 4 * 128))
    timed("leaf3", lambda: leaf3(*x, mats, 256, 128), lambda: leaf3_plain(*x, mats, 256, 128),
          bound, lambda: torch.fft.fft(xc), n=n, rows=rows)
    del x, xc
    release_memory()

    # -- the main path: each transform's launches against its plan, the
    # error against complex128 torch.fft.fft on the card, the round trip
    # and the inverse of N * delta
    kernels = (colfft, colfft_nocorr, colfft_out3d, leaft, leaf, leaf3, hybrid, transpose2,
               col64, col64_nocorr, leaf64, transpose2_64, ddcol, ddcol_nocorr, ddleaf,
               ozcol, ozleaft)
    run = counted(kernels)
    for log_n, leaf_n, engines in EDGE_E2E:
        n = 1 << log_n
        for engine in engines:
            f32 = engine == "f32"
            dtype = torch.float32 if f32 else torch.float64
            if f32:
                planner = PlannerDit32(n, options=Options(leaf_fft_size=leaf_n))
                entry, want = fft_32_dit_with_planner, f32_row_launches(planner.plan)
                tol, back_tol = 5e-7 * max(1.0, log_n / 18.0), 1e-6
            else:
                planner = PlannerDit64(n, options=Options(leaf_fft_size=leaf_n,
                                                          f64_engine=engine))
                entry = fft_64_dit_with_planner
                want = (native_launches(planner.plan) if engine == "native"
                        else dd_launches(planner.plan, False))
                tol = back_tol = DD_E2E_TOL
            x = (randn((n,), dtype), randn((n,), dtype))
            zero_launches(kernels)
            out = run(lambda: entry(*x, Direction.Forward, planner), want)
            counts = {k.__name__: kernel_launches(k) for k in kernels if kernel_launches(k)}
            err = card_oracle_err(out, *x)
            back = run(lambda: entry(*out, Direction.Reverse, planner), want)
            rt = rel_l2(back[0], back[1], x[0], x[1])
            delta = torch.zeros(n, dtype=dtype, device=dev)
            delta[0] = n
            ones = run(lambda: entry(delta, torch.zeros_like(delta), Direction.Reverse,
                                     planner), want)
            exact = bool(torch.all(ones[0] == 1.0)) and bool(torch.all(ones[1] == 0.0))
            ms = time_ms(lambda: entry(*x, Direction.Forward, planner), flush, EDGE_TIME_REPS)
            xc = torch.complex(*x)
            lib = time_ms(lambda: torch.fft.fft(xc), flush, EDGE_TIME_REPS)
            emit({"phase": "e2e_edges", "dtype": engine, "n": n, "leaf_fft_size": leaf_n,
                  "plan": str(planner.plan), "launches": counts, "rel_l2": err,
                  "bound": tol, "roundtrip_rel_l2": rt, "inverse_delta_exact": exact,
                  "card": smi, "ms": ms, "library_ms": lib})
            check(f"{engine} 2^{log_n} leaf {leaf_n}", err, tol)
            check(f"{engine} 2^{log_n} leaf {leaf_n} round trip", rt, back_tol)
            if not exact:
                raise AssertionError(f"{engine} 2^{log_n} leaf {leaf_n}: 1/N not exact")
            del x, out, back, ones, delta, xc
        release_memory()

    # -- fft_distributed at world size 1 over NCCL: the shard's rows on the
    # 2^17 leaf (leaf3 at a = 256)
    log_n, leaf_n = EDGE_DIST
    n = 1 << log_n
    planner = PlannerDit32(n, options=Options(leaf_fft_size=leaf_n))
    x = (randn((n,)), randn((n,)))
    want = dist_launches(planner, "natural")
    if want.get("leaf3") != 1:
        raise AssertionError(f"the shard's rows do not run leaf3: {want}")
    zero_launches(kernels)
    out = run(lambda: fft_distributed(*x, Direction.Forward, planner), want)
    err = card_oracle_err(out, *x)
    emit({"phase": "e2e_edges", "entry": "fft_distributed", "world": 1, "dtype": "f32",
          "n": n, "leaf_fft_size": leaf_n, "launches": want, "rel_l2": err,
          "bound": 5e-7 * max(1.0, log_n / 18.0), "card": smi})
    check("fft_distributed leaf 2^17", err, 5e-7 * max(1.0, log_n / 18.0))
    del x, out
    # blocks of one and two columns: natural order against the oracle, and
    # a permuted_output forward into a permuted_input inverse (the bare
    # column passes) back to the input
    for tag, log_n, leaf_n in EDGE_DIST_NARROW:
        n = 1 << log_n
        f64 = tag == "f64"
        dtype = torch.float64 if f64 else torch.float32
        planner = (PlannerDit64 if f64 else PlannerDit32)(
            n, options=Options(leaf_fft_size=leaf_n))
        x = (randn((n,), dtype), randn((n,), dtype))
        want = dist_launches(planner, "natural")
        zero_launches(kernels)
        out = run(lambda: fft_distributed(*x, Direction.Forward, planner), want)
        err = card_oracle_err(out, *x)
        perm = fft_distributed(*x, Direction.Forward, planner, permuted_output=True)
        back = fft_distributed(*perm, Direction.Reverse, planner, permuted_input=True)
        rt = rel_l2(back[0], back[1], x[0], x[1])
        tol = DD_E2E_TOL if f64 else 5e-7 * max(1.0, log_n / 18.0)
        emit({"phase": "e2e_edges", "entry": "fft_distributed", "world": 1, "dtype": tag,
              "n": n, "leaf_fft_size": leaf_n, "columns": leaf_n, "launches": want,
              "rel_l2": err, "bound": tol, "permuted_roundtrip_rel_l2": rt, "card": smi})
        check(f"fft_distributed {tag} blocks of {leaf_n} columns", err, tol)
        check(f"fft_distributed {tag} permuted round trip", rt, DD_E2E_TOL if f64 else 1e-6)
        del x, out, perm, back
    release_memory()
    emit({"phase": "edge_phases", "seconds": time.perf_counter() - t_edges, "card": smi})


def all_kernels():
    """Every kernel wrapper of the port (``ops/route.KERNELS``), each with its
    launch counter."""
    from phastft_tpu_torch.ops.route import KERNELS

    return tuple(dict.fromkeys(vars(KERNELS).values()))


def launches_of(kernels, fn):
    """(fn(), {kernel: launches} of that call, the kernels it launched only)."""
    before = [kernel_launches(k) for k in kernels]
    out = fn()
    counts = {k.__name__: kernel_launches(k) - b for k, b in zip(kernels, before)}
    return out, {name: c for name, c in counts.items() if c}


def tune_phases(dev, gen, flush, smi) -> None:
    """``PlannerMode.Tune`` (module docstring item 39): each case of
    TUNE_CASES tuned in a fresh wisdom directory, the candidates' device
    times, the winner beside the heuristic's options, the two transforms in
    turns, the tuned one against the oracle and back, and the disk entry read
    again with no candidate measured."""
    import shutil
    import tempfile

    import torch

    from phastft_tpu_torch import (
        Direction, PlannerDit32, PlannerDit64, PlannerMode, PlannerR2c32,
        c2r_fft_f32_with_planner, fft_32_dit_with_planner, fft_64_dit_with_planner,
        r2c_fft_f32_with_planner,
    )
    from phastft_tpu_torch import tune
    from phastft_tpu_torch.ops.fourstep import plan_rows

    t_phase = time.perf_counter()
    kernels = all_kernels()
    wisdom = tempfile.mkdtemp(prefix="phastft_tune_")
    saved_env = os.environ.get("PHASTFT_TPU_TUNE_CACHE")
    os.environ["PHASTFT_TPU_TUNE_CACHE"] = wisdom
    measured = []
    real = {"c2c": tune._measure, "r2c": tune._measure_r2c}

    def recorder(fn):
        def measure(n, dtype, opts, device):
            seconds = fn(n, dtype, opts, device)
            measured.append((opts, seconds))
            return seconds
        return measure

    tune._measure = recorder(real["c2c"])
    tune._measure_r2c = recorder(real["r2c"])
    tune.clear_tune_cache()

    def described(opts):
        return {"leaf_fft_size": opts.leaf_fft_size, "f64_engine": opts.f64_engine,
                "leaf_kernel": opts.leaf_kernel}

    try:
        for kind, tag, log_n in TUNE_CASES:
            n = 1 << log_n
            f64 = tag == "f64"
            dtype = torch.float64 if f64 else torch.float32
            if kind == "r2c":
                def build(mode):
                    return PlannerR2c32(n, mode)

                def options(planner):
                    return planner.inner_opts

                x = torch.randn((n,), generator=gen, device=dev, dtype=dtype)

                def forward(planner):
                    return r2c_fft_f32_with_planner(x, planner)

                def err_of(out):
                    want = torch.fft.rfft(x.double())
                    got = torch.complex(out[0].double(), out[1].double())
                    return float(torch.linalg.vector_norm(got - want)
                                 / torch.linalg.vector_norm(want))

                def back_of(planner, out):
                    back = c2r_fft_f32_with_planner(out[0], out[1], planner)
                    return rel_l2(back, None, x, None, worst=True)[0]
            else:
                cls = PlannerDit64 if f64 else PlannerDit32
                entry = fft_64_dit_with_planner if f64 else fft_32_dit_with_planner

                def build(mode):
                    return cls(n, mode)

                def options(planner):
                    return planner.options

                x = (torch.randn((n,), generator=gen, device=dev, dtype=dtype),
                     torch.randn((n,), generator=gen, device=dev, dtype=dtype))

                def forward(planner):
                    return entry(*x, Direction.Forward, planner)

                def err_of(out):
                    return card_oracle_err(out, *x)

                def back_of(planner, out):
                    back = entry(*out, Direction.Reverse, planner)
                    return rel_l2(back[0], back[1], x[0], x[1])
            measured.clear()
            t0 = time.perf_counter()
            tuned = build(PlannerMode.Tune)
            tune_s = time.perf_counter() - t0
            race = [{**described(o), "ms": sec * 1e3} for o, sec in measured]
            heur = build(PlannerMode.Heuristic)
            won, guess = options(tuned), options(heur)
            # the heuristic's time in the race: its own candidate, or the
            # candidate that runs its plan on its engine
            key = tune._engine_key
            plan_n = n // 2 if kind == "r2c" else n
            np_dtype = np.float64 if f64 else np.float32
            guess_ms = [sec * 1e3 for o, sec in measured
                        if plan_rows(plan_n, o.leaf_fft_size) == plan_rows(
                            plan_n, guess.leaf_fft_size)
                        and key(o, np_dtype) == key(guess, np_dtype)]
            turns = {"tuned": [], "heuristic": []}
            for _ in range(2):
                for name, planner in (("tuned", tuned), ("heuristic", heur)):
                    turns[name].append(time_ms(lambda: forward(planner), flush,
                                               TUNE_TIME_REPS))
            tuned_ms = float(np.mean(turns["tuned"]))
            heur_ms = float(np.mean(turns["heuristic"]))
            out, moved = launches_of(kernels, lambda: forward(tuned))
            err = err_of(out)
            rt = back_of(tuned, out)
            del out
            oz = (won.f64_engine or "").startswith("df64-oz")
            tol = (OZ_E2E_TOL if oz else DD_E2E_TOL) if f64 else 5e-7 * max(1.0, log_n / 18.0)
            rt_tol = (OZ_E2E_TOL if oz else DD_E2E_TOL) if f64 else 1e-6
            # the disk entry: a fresh in-process cache reads it, measuring none
            tune.clear_tune_cache()
            measured.clear()
            again = options(build(PlannerMode.Tune))
            emit({"phase": "tune", "kind": kind, "dtype": tag, "n": n, "card": smi,
                  "candidates": race, "winner": described(won),
                  "heuristic": described(guess), "heuristic_race_ms": guess_ms,
                  "tune_wall_s": tune_s, "tuned_ms": turns["tuned"],
                  "heuristic_ms": turns["heuristic"], "ratio": tuned_ms / heur_ms,
                  "rel_l2": err, "bound": tol, "roundtrip_rel_l2": rt,
                  "launches": moved, "disk_options_equal": again == won,
                  "disk_candidates_measured": len(measured)})
            check(f"tuned {kind} {tag} 2^{log_n}", err, tol)
            check(f"tuned {kind} {tag} 2^{log_n} round trip", rt, rt_tol)
            check(f"tuned {kind} {tag} 2^{log_n} against the heuristic", tuned_ms / heur_ms,
                  TUNE_SLOWER)
            if again != won or measured:
                raise AssertionError(f"tune {kind} {tag} 2^{log_n}: the disk entry gave "
                                     f"{again} after {len(measured)} measurements")
            if not moved:
                raise AssertionError(f"tuned {kind} {tag} 2^{log_n} launched no kernel")
            del x, tuned, heur
            release_memory()
    finally:
        tune._measure, tune._measure_r2c = real["c2c"], real["r2c"]
        tune.clear_tune_cache()
        shutil.rmtree(wisdom, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("PHASTFT_TPU_TUNE_CACHE", None)
        else:
            os.environ["PHASTFT_TPU_TUNE_CACHE"] = saved_env
    emit({"phase": "tune_phases", "seconds": time.perf_counter() - t_phase, "card": smi})


def oracle_phases(dev, gen, flush, smi) -> None:
    """The oracles (run inside ``nccl_world``, module docstring item 40):
    ``use_pallas=False`` and ``strategy="staged"`` on the card, each against
    the card's complex128 oracle and beside the default engine's time,
    every kernel's launch counter unchanged across each call."""
    import torch

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerDit64, PlannerR2c32, PlannerR2c64,
        c2r_fft_f32_with_planner, c2r_fft_f64_with_planner, fft_32_dit_with_planner,
        fft_32_dit_with_planner_and_opts, fft_64_dit_with_planner,
        fft_64_dit_with_planner_and_opts, r2c_fft_f32_with_planner, r2c_fft_f64_with_planner,
    )
    from phastft_tpu_torch.parallel import fft_distributed

    t_phase = time.perf_counter()
    kernels = all_kernels()
    plain = Options(use_pallas=False)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def none_launched(fn, what):
        out, moved = launches_of(kernels, fn)
        if moved:
            raise AssertionError(f"{what} launched kernels: {moved}")
        return out

    def inverse_err(got, xr, xi):
        want = torch.fft.ifft(torch.complex(xr.double(), xi.double()))
        g = torch.complex(got[0].double(), got[1].double())
        return float(torch.linalg.vector_norm(g - want) / torch.linalg.vector_norm(want))

    def f32_tol(log_n):
        return 5e-7 * max(1.0, log_n / 18.0)

    # use_pallas=False on the C2C entries (per call), against the default
    for engine, log_n in ORACLE_PLAIN:
        n = 1 << log_n
        f32 = engine == "f32"
        dtype = torch.float32 if f32 else torch.float64
        if f32:
            planner = PlannerDit32(n)
            entry, default = fft_32_dit_with_planner_and_opts, fft_32_dit_with_planner
        else:
            leaf_n = Options.guess_options(n, np.float64).leaf_fft_size
            planner = PlannerDit64(n, options=Options(
                leaf_fft_size=leaf_n, f64_engine=None if engine == "native" else engine))
            entry, default = fft_64_dit_with_planner_and_opts, fft_64_dit_with_planner
        x = (randn((n,), dtype), randn((n,), dtype))
        out = none_launched(lambda: entry(*x, Direction.Forward, planner, plain),
                            f"use_pallas=False {engine} 2^{log_n}")
        err = card_oracle_err(out, *x)
        del out
        tol = f32_tol(log_n) if f32 else DD_E2E_TOL
        emit({"phase": "oracle_plain", "entry": "c2c", "engine": engine, "n": n,
              "plan": str(planner.plan), "rel_l2": err, "bound": tol, "launches": {},
              "card": smi,
              "ms": time_ms(lambda: entry(*x, Direction.Forward, planner, plain), flush,
                            ORACLE_TIME_REPS),
              "default_ms": time_ms(lambda: default(*x, Direction.Forward, planner), flush,
                                    TUNE_TIME_REPS)})
        check(f"use_pallas=False {engine} 2^{log_n}", err, tol)
        del x, planner
        release_memory()
    # the real transforms on plain inner options
    n = 1 << ORACLE_R2C_LOG
    for tag, cls, r2c, c2r in (("f32", PlannerR2c32, r2c_fft_f32_with_planner,
                                c2r_fft_f32_with_planner),
                               ("f64", PlannerR2c64, r2c_fft_f64_with_planner,
                                c2r_fft_f64_with_planner)):
        dtype = torch.float32 if tag == "f32" else torch.float64
        leaf_n = Options.guess_options(n // 2, np.float32 if tag == "f32" else np.float64)
        planner = cls(n, inner_options=Options(leaf_fft_size=leaf_n.leaf_fft_size,
                                               use_pallas=False))
        heur = cls(n)
        x = randn((n,), dtype)
        spec = none_launched(lambda: r2c(x, planner), f"use_pallas=False r2c {tag}")
        want = torch.fft.rfft(x.double())
        err = float(torch.linalg.vector_norm(torch.complex(spec[0].double(), spec[1].double())
                                             - want) / torch.linalg.vector_norm(want))
        back = none_launched(lambda: c2r(spec[0], spec[1], planner),
                             f"use_pallas=False c2r {tag}")
        rt = rel_l2(back, None, x, None, worst=True)[0]
        tol = f32_tol(ORACLE_R2C_LOG) if tag == "f32" else DD_E2E_TOL
        rt_tol = 1e-6 if tag == "f32" else DD_E2E_TOL
        emit({"phase": "oracle_plain", "entry": "r2c / c2r", "dtype": tag, "n": n,
              "rel_l2": err, "bound": tol, "roundtrip_rel_l2": rt, "launches": {},
              "card": smi,
              "r2c_ms": time_ms(lambda: r2c(x, planner), flush, ORACLE_TIME_REPS),
              "default_r2c_ms": time_ms(lambda: r2c(x, heur), flush, TUNE_TIME_REPS),
              "c2r_ms": time_ms(lambda: c2r(spec[0], spec[1], planner), flush,
                                ORACLE_TIME_REPS),
              "default_c2r_ms": time_ms(lambda: c2r(spec[0], spec[1], heur), flush,
                                        TUNE_TIME_REPS)})
        check(f"use_pallas=False r2c {tag} 2^{ORACLE_R2C_LOG}", err, tol)
        check(f"use_pallas=False c2r {tag} 2^{ORACLE_R2C_LOG} round trip", rt, rt_tol)
        del x, spec, back, want, planner, heur
    # fft_distributed at world size 1 on a use_pallas=False planner
    n = 1 << ORACLE_DIST_LOG
    planner = PlannerDit32(n, options=Options(
        leaf_fft_size=Options.guess_options(n, np.float32).leaf_fft_size, use_pallas=False))
    heur = PlannerDit32(n)
    x = (randn((n,), torch.float32), randn((n,), torch.float32))
    out = none_launched(lambda: fft_distributed(*x, Direction.Forward, planner),
                        "use_pallas=False fft_distributed")
    err = card_oracle_err(out, *x)
    del out
    emit({"phase": "oracle_plain", "entry": "fft_distributed", "world": 1, "dtype": "f32",
          "n": n, "rel_l2": err, "bound": f32_tol(ORACLE_DIST_LOG), "launches": {},
          "card": smi,
          "ms": time_ms(lambda: fft_distributed(*x, Direction.Forward, planner), flush,
                        ORACLE_TIME_REPS),
          "default_ms": time_ms(lambda: fft_distributed(*x, Direction.Forward, heur), flush,
                                TUNE_TIME_REPS)})
    check("use_pallas=False fft_distributed", err, f32_tol(ORACLE_DIST_LOG))
    del x, planner, heur
    release_memory()
    # the staged strategy, forward and inverse, tiled and flat bit reversal
    for tag, log_n in ORACLE_STAGED:
        n = 1 << log_n
        f64 = tag == "f64"
        dtype = torch.float64 if f64 else torch.float32
        planner = (PlannerDit64 if f64 else PlannerDit32)(n)
        entry = fft_64_dit_with_planner_and_opts if f64 else fft_32_dit_with_planner_and_opts
        default = fft_64_dit_with_planner if f64 else fft_32_dit_with_planner
        x = (randn((n,), dtype), randn((n,), dtype))
        tol = DD_E2E_TOL if f64 else f32_tol(log_n)
        row = {"phase": "oracle_staged", "dtype": tag, "n": n, "bound": tol, "launches": {},
               "card": smi,
               "default_ms": time_ms(lambda: default(*x, Direction.Forward, planner), flush,
                                     TUNE_TIME_REPS)}
        for tiled in (True, False):
            opts = Options(strategy="staged", tiled_bit_reversal=tiled)
            name = "tiled" if tiled else "flat"
            fwd = none_launched(lambda: entry(*x, Direction.Forward, planner, opts),
                                f"staged {tag} 2^{log_n} forward {name}")
            inv = none_launched(lambda: entry(*x, Direction.Reverse, planner, opts),
                                f"staged {tag} 2^{log_n} inverse {name}")
            row[f"forward_{name}_rel_l2"] = card_oracle_err(fwd, *x)
            row[f"inverse_{name}_rel_l2"] = inverse_err(inv, *x)
            row[f"{name}_ms"] = time_ms(lambda: entry(*x, Direction.Forward, planner, opts),
                                        flush, ORACLE_TIME_REPS)
            del fwd, inv
            check(f"staged {tag} 2^{log_n} forward {name}", row[f"forward_{name}_rel_l2"],
                  tol)
            check(f"staged {tag} 2^{log_n} inverse {name}", row[f"inverse_{name}_rel_l2"],
                  tol)
        emit(row)
        del x, planner
        release_memory()
    emit({"phase": "oracle_phases", "seconds": time.perf_counter() - t_phase, "card": smi})


def time_tree(tree: str) -> int:
    """``--time-tree``: the TURN_SIZES transforms of the package under
    ``tree`` (medians of TURN_REPS calls, CUDA events), as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import phastft_tpu_torch as P

    here = os.path.dirname(os.path.abspath(P.__file__))
    if not here.startswith(os.path.abspath(tree)):
        raise AssertionError(f"{here} is not under {tree}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB, as main
    out, traces = {}, {}
    with nccl_world():  # fft_distributed at world size 1
        time_sizes(P, dev, gen, flush, out, traces)
    print(json.dumps({"tree": tree, "package": here, "ms": out, "traces": traces}), flush=True)
    return 0


def time_sizes(P, dev, gen, flush, out, traces) -> None:
    """``time_tree``'s readings of the package ``P`` into ``out``, and of
    each ``fft_distributed`` the device events of one traced call into
    ``traces``: per kernel its calls and device ms, and the device span and
    busy time (``device_trace``)."""
    import torch

    for tag, log_n in TURN_SIZES:
        n = 1 << log_n
        f32 = not tag.endswith("f64")
        dtype = torch.float32 if f32 else torch.float64
        if tag[:4] in ("r2c_", "c2r_"):
            planner = (P.PlannerR2c32 if f32 else P.PlannerR2c64)(n)
            r2c = P.r2c_fft_f32_with_planner if f32 else P.r2c_fft_f64_with_planner
            c2r = P.c2r_fft_f32_with_planner if f32 else P.c2r_fft_f64_with_planner
            x = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
            if tag.startswith("r2c_"):
                call = functools.partial(r2c, x, planner)
            else:
                call = functools.partial(c2r, *r2c(x, planner), planner)
            out[f"{tag}_2^{log_n}"] = time_ms(call, flush, TURN_REPS)
            del x, call, planner
            release_memory()
            continue
        options = P.Options(leaf_kernel="hybrid") if tag == "hybrid" else None
        planner = (P.PlannerDit32 if f32 else P.PlannerDit64)(n, options=options)
        entry = P.fft_32_dit_with_planner if f32 else P.fft_64_dit_with_planner
        if tag.startswith("dist_"):
            from phastft_tpu_torch.parallel import fft_distributed as entry
        shape = (HYBRID_TIME_POINTS // n, n) if tag == "hybrid" else (n,)
        x = tuple(torch.randn(shape, generator=gen, device=dev, dtype=dtype) for _ in range(2))
        key = f"{tag}_2^{log_n}"
        out[key] = time_ms(lambda: entry(*x, P.Direction.Forward, planner), flush, TURN_REPS)
        if tag.startswith("dist_"):
            _, events = device_trace(lambda: entry(*x, P.Direction.Forward, planner))
            rows = {}
            for name, _, stream, a, b in events:
                row = rows.setdefault(f"{name[:60]} @{stream}", [0, 0.0])
                row[0] += 1
                row[1] += (b - a) / 1e3
            traces[key] = {"kernels": rows,
                           "busy_ms": _spans_ms(_spans_union([ev[3:] for ev in events])),
                           "span_ms": (max(ev[4] for ev in events)
                                       - min(ev[3] for ev in events)) / 1e3}
        del x, planner
        release_memory()


def _mix(h, shift: int):
    """h ^ (h >>> shift) on int64 (a logical shift): a bijection of 2^64."""
    return h ^ ((h >> shift) & ((1 << (64 - shift)) - 1))


def checksum(x) -> int:
    """A fingerprint of the bits of the tensor ``x`` on the card: the sum,
    mod 2^64, over its elements of a bijective mix of each one's bits (a
    signed int of its width) and its flat index, so that two tensors that
    differ in one element always differ in it, and a change of many (one
    exponent step of every value) almost surely."""
    import torch

    bits = x.reshape(-1).view(torch.int32 if x.element_size() == 4 else torch.int64)
    total = 0
    for i in range(0, bits.numel(), CHECKSUM_CHUNK):
        part = bits[i:i + CHECKSUM_CHUNK].to(torch.int64)
        idx = torch.arange(i, i + part.numel(), dtype=torch.int64, device=x.device)
        # odd multipliers, which 2^64 inverts: every step is a bijection
        h = _mix((part + idx) * -7046029254386353131, 31) * -4658895280553007687
        total = (total + int(_mix(h, 29).sum())) % (1 << 64)
    return total


def fold_kernel_case(P, name, dtype, shape, dev, gen):
    """(wrapper, arguments) of the kernel ``name`` of the package ``P`` on
    an input of ``shape``, with the tables of the plan that runs it."""
    import torch

    from importlib import import_module

    ops = lambda m: import_module(f"{P.__name__}.ops.{m}")  # noqa: E731
    dt = torch.float32 if dtype == "f32" else torch.float64
    x = tuple(torch.randn(shape, generator=gen, device=dev, dtype=dt) for _ in range(2))
    if name in ("transpose2", "transpose2_64"):
        return getattr(ops("transpose"), name), x
    if name == "leaft":
        a, n1 = shape[-3], shape[-2]
        mats = tuple(torch.from_numpy(t).to(dev)
                     for t in ops("leaft").leaft_tables_host(a * 128))
        return ops("leaft").leaft, (*x, mats, n1)
    n = shape[-1]
    if name == "leaf64":
        p = P.PlannerDit64(n, options=P.Options(leaf_fft_size=1 << 16))
        st, n1 = p.native_state, n // 128
        return ops("native").leaf64, (*x, st[f"leaf{n1}"], n,
                                      (st[f"dif{n1}"][0], st["dif128"][0]))
    if name == "hybrid":
        p = P.PlannerDit32(n, options=P.Options(leaf_kernel="hybrid"))
        n1 = p.plan[1]
        corrs = p.tables_for(p.plan, "hybrid")
        return ops("leaf").hybrid, (*x, corrs[f"mxu{n1}"][3:6] + tuple(corrs[f"leaf{n1}"]), n1)
    p = P.PlannerDit32(n)
    n1 = p.plan[1]
    if name == "leaf3":
        return ops("leaf").leaf3, (*x, p.leaf_corrs[f"mxu3_{n1}"], 128, 128)
    mats = p.leaf_corrs[f"mxu{n1}"][:6] + tuple(p.leaf_corrs[f"leaf{n1}"])
    return ops("leaf").leaf, (*x, mats, n1)


def fold_tree(tree: str) -> int:
    """``--fold-tree``: the readings of ``--fold`` of the package under
    ``tree``, as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import inspect

    import torch

    import phastft_tpu_torch as P
    from phastft_tpu_torch import tracing

    here = os.path.dirname(os.path.abspath(P.__file__))
    if not here.startswith(os.path.abspath(tree)):
        raise AssertionError(f"{here} is not under {tree}")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB, as main
    out = {"tree": tree, "package": here, "transforms": {}, "kernels": {}}
    for tag, dtype, log_n, rows in FOLD_SIZES:
        n = 1 << log_n
        f32 = dtype == "f32"
        dt = torch.float32 if f32 else torch.float64
        planner = (P.PlannerDit32 if f32 else P.PlannerDit64)(n)
        entry = P.fft_32_dit_with_planner if f32 else P.fft_64_dit_with_planner
        gen = torch.Generator(device=dev).manual_seed(log_n)
        shape = (rows, n) if rows > 1 else (n,)
        x = tuple(torch.randn(shape, generator=gen, device=dev, dtype=dt) for _ in range(2))
        row = {}
        for direction in (P.Direction.Forward, P.Direction.Reverse):
            key = "forward" if direction is P.Direction.Forward else "inverse"
            tracing.launches.clear()
            scales = getattr(tracing, "scales", None)
            if scales is not None:
                scales.clear()
            got = entry(*x, direction, planner)
            row[f"{key}_checksums"] = [checksum(g) for g in got]
            row[f"{key}_launches"] = dict(tracing.launches)
            row[f"{key}_scales"] = None if scales is None else dict(scales)
            del got
            release_memory()
            row[f"{key}_ms"] = time_ms(lambda: entry(*x, direction, planner), flush, FOLD_REPS)
        row["inverse_over_forward"] = row["inverse_ms"] / row["forward_ms"]
        out["transforms"][tag] = row
        del x, planner
        release_memory()
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, dtype, shape in FOLD_KERNELS:
        fn, args = fold_kernel_case(P, name, dtype, shape, dev, gen)
        row = {"shape": list(shape), "ms": time_ms(lambda: fn(*args), flush, TURN_REPS)}
        if "out_scale" in inspect.signature(fn).parameters:
            want = fn(*args)
            for w in want:
                w.mul_(FOLD_SCALE)
            got = fn(*args, out_scale=FOLD_SCALE)
            row["scaled_bitwise"] = all(torch.equal(g, w) for g, w in zip(got, want))
            del want, got
            release_memory()
            row["scaled_ms"] = time_ms(lambda: fn(*args, out_scale=FOLD_SCALE), flush, TURN_REPS)
        out["kernels"][name] = row
        del fn, args
        release_memory()
    print(json.dumps(out), flush=True)
    return 0


def fold_turns(parent: str) -> int:
    """``--fold PARENT``: ``fold_tree`` of the parent's package and this
    checkout's in turns parent, this, this, parent, one process each; every
    checksum must agree across the four turns."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for tree in (parent, here, here, parent):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--fold-tree", tree],
                             capture_output=True, text=True, timeout=1500)
        if res.returncode != 0:
            raise RuntimeError(f"--fold-tree {tree} failed:\n{res.stdout}\n{res.stderr}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["turn"] = "parent" if tree == parent else "this"
        rows.append(row)
        emit({"phase": "fold_turn", **row, "card": smi})
    same, ratio = {}, {}
    for tag in rows[0]["transforms"]:
        for key in ("forward_checksums", "inverse_checksums"):
            same[f"{tag}.{key}"] = all(r["transforms"][tag][key] == rows[0]["transforms"][tag][key]
                                       for r in rows)
        for key in ("forward_ms", "inverse_ms"):
            mine = (rows[1]["transforms"][tag][key] + rows[2]["transforms"][tag][key]) / 2
            theirs = (rows[0]["transforms"][tag][key] + rows[3]["transforms"][tag][key]) / 2
            ratio[f"{tag}.{key}"] = mine / theirs
    for name in rows[0]["kernels"]:
        theirs = (rows[0]["kernels"][name]["ms"] + rows[3]["kernels"][name]["ms"]) / 2
        for key in ("ms", "scaled_ms"):
            mine = (rows[1]["kernels"][name][key] + rows[2]["kernels"][name][key]) / 2
            ratio[f"{name}.{key}"] = mine / theirs
    scaled = all(r["kernels"][k]["scaled_bitwise"] for r in rows[1:3] for k in r["kernels"])
    emit({"phase": "fold", "card": smi, "bitwise_as_parent": same,
          "scaled_bitwise": scaled, "this_over_parent": ratio})
    if not all(same.values()) or not scaled:
        raise AssertionError("an output differs from the parent's, or a scaled kernel from "
                             "its unscaled output times the scale")
    return 0


def turns(parent: str) -> int:
    """``--turns PARENT``: ``time_tree`` of the parent's package and this
    checkout's in turns parent, this, this, parent, one process each; the
    medians and this tree's ratio to the parent's (mean of its two turns
    over the parent's two), beside the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for tree in (parent, here, here, parent):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"--time-tree {tree} failed:\n{res.stdout}\n{res.stderr}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["turn"] = "parent" if tree == parent else "this"
        rows.append(row)
        emit({"phase": "turn", **row, "card": smi})
    ratio = {}
    for key in rows[0]["ms"]:
        mine = (rows[1]["ms"][key] + rows[2]["ms"][key]) / 2
        theirs = (rows[0]["ms"][key] + rows[3]["ms"][key]) / 2
        ratio[key] = mine / theirs
    emit({"phase": "turns", "card": smi, "this_over_parent": ratio})
    return 0


def main() -> int:
    t_run = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from phastft_tpu_torch import (
        Direction, Options, PlannerDit32, PlannerDit64, fft_32_dit,
        fft_32_dit_with_planner, fft_64_dit_with_planner, fft_64_dit_with_planner_and_opts,
    )
    from phastft_tpu_torch.ops import _build
    from phastft_tpu_torch.ops.dd import (
        ddcol, ddcol_nocorr, ddcol_nocorr_plain, ddcol_plain, ddleaf, ddleaf_plain,
    )
    from phastft_tpu_torch.ops.df64 import split_f64
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, col_tile3d, colfft, colfft_out3d,
        colfft_out3d_plain, colfft_plain,
    )
    from phastft_tpu_torch.ops.leaf import leaf, leaf3
    from phastft_tpu_torch.ops.leaft import leaft, leaft_plain, leaft_tables_host
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "torch_name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # col64's one-block build compiles beside the library's own sources
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    oneblock = subprocess.Popen(
        [_build._nvcc(), *_build._NVCC_FLAGS, "-DCOL64_CLUSTER_N1=4096", "-shared", "-o",
         str(_build.BUILD_DIR / COL64_ONEBLOCK), str(_build.SRC_DIR / "col64.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    try:
        _build.library()
    finally:
        oneblock_log, _ = oneblock.communicate()
    build_s = time.perf_counter() - t0
    if oneblock.returncode != 0:
        raise RuntimeError(f"nvcc failed on col64.cu's one-block build:\n{oneblock_log}")
    log = _build.build_log()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(f"{log}\n== col64.cu, one-block build\n{oneblock_log}")
    ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    lib = _build.library()
    resident = {"leaf3": lib.phastft_leaf3_clusters(128),
                "leaf3_a_256": lib.phastft_leaf3_clusters(256),
                **{f"leaf_n1_{n1}": lib.phastft_leaf_clusters(n1) for n1 in LEAF_CLUSTER_N1S},
                **{f"ddleaf_n1_{n1}": lib.phastft_ddleaf_clusters(n1)
                   for n1 in DD_LEAF_CLUSTER_N1S},
                **{f"ddcol{tag}_n1_{n1}": lib.phastft_ddcol_clusters(n1, corr)
                   for n1 in DD_COL_CLUSTER_N1S for tag, corr in (("", 1), ("_nocorr", 0))},
                **{f"leaft_a_{a}": lib.phastft_leaft_clusters(a) for a in LEAFT_CLUSTER_AS},
                **{f"colfft_n1_{n1}_mode_{mode}": lib.phastft_colfft_clusters(n1, mode)
                   for n1 in COL_CLUSTER_N1S for mode in (0, 1, 2)},
                **{f"col64_n1_{n1}": lib.phastft_col64_clusters(n1) for n1 in COL_CLUSTER_N1S},
                **{f"ozleaft_a_{a}": lib.phastft_ozleaft_clusters(a) for a in OZ_LEAF_CLUSTER_AS},
                **{f"hybrid_n1_{n1}": lib.phastft_hybrid_clusters(n1)
                   for n1 in HYBRID_CLUSTER_N1S},
                "ozcol_blocks_per_sm": lib.phastft_ozcol_blocks()}
    oz_ptxas, ddcol_ptxas, section = [], [], ""
    for ln in log.splitlines():
        if ln.startswith("== "):
            section = ln[3:].strip()
        elif "Used" in ln or "spill" in ln or "Compiling" in ln:
            if section in ("ozcol.cu", "ozleaft.cu"):
                oz_ptxas.append(f"{section}: {ln.strip()}")
            elif section == "ddcol.cu":
                ddcol_ptxas.append(ln.strip())
    emit({"phase": "build", "seconds": build_s,
          "sources": sorted(os.listdir(_build.SRC_DIR)), "ptxas": ptxas, "oz_ptxas": oz_ptxas,
          "ddcol_ptxas": ddcol_ptxas,
          "resident_clusters": resident,
          "fp32_instr_per_s": fp32_instr_per_s(), "sm_clock_hz": _SM_CLOCK_HZ[0]})
    if min(resident.values()) < 1:
        raise AssertionError(f"a cluster shape does not fit the card: {resident}")

    # -- parity: each kernel against its plain version on the same inputs
    rng = np.random.default_rng(2025)
    max_err = {"colfft_out3d": 0.0, "leaft": 0.0}
    gen = torch.Generator(device=dev).manual_seed(2025)
    for b, n1, n2 in PARITY_SHAPES:
        if b == 1:
            re, im = signal(rng, (1, n1, n2))
            xr = torch.from_numpy(re).to(dev)
            xi = torch.from_numpy(im).to(dev)
        else:  # 2^26 points: made on the card
            xr = torch.randn((b, n1, n2), generator=gen, device=dev)
            xi = torch.randn((b, n1, n2), generator=gen, device=dev)
        tabs = tuple(
            torch.from_numpy(a).to(dev)
            for a in col_split_tables_host(n1, n2, "float32", t=col_tile3d(n1, n2))
        )
        mats = tuple(torch.from_numpy(a).to(dev) for a in leaft_tables_host(n2))
        kc = colfft_out3d(xr, xi, tabs, n1)
        pc = colfft_out3d_plain(xr, xi, tabs, n1)
        torch.cuda.synchronize()
        kl = leaft(pc[0], pc[1], mats, n1)
        pl = leaft_plain(pc[0], pc[1], mats, n1)
        torch.cuda.synchronize()
        for name, k, p in (("colfft_out3d", kc, pc), ("leaft", kl, pl)):
            err = rel_l2(k[0], k[1], p[0], p[1])
            mabs = max_abs(k[0], k[1], p[0], p[1])
            max_err[name] = max(max_err[name], mabs)
            emit({"phase": "parity", "kernel": name, "batch": b, "n1": n1,
                  "n2": n2, "rel_l2": err, "max_abs_err": mabs,
                  "bound": KERNEL_TOL})
            check(f"{name} parity at ({b}, {n1}, {n2})", err, KERNEL_TOL)
        del kc, pc, kl, pl, xr, xi

    # -- main path: counters at 0 just before, read just after
    zero_launches((colfft_out3d, leaft, leaf, leaf3, colfft, transpose2))
    transforms = 0
    errs = {}
    x24 = None
    for log_n in E2E_LOGS:
        n = 1 << log_n
        re, im = signal(rng, (n,))
        out = fft_32_dit(re, im, Direction.Forward)
        transforms += 1
        err = oracle_err(out, re + 1j * im)
        errs[f"fwd_2^{log_n}"] = err
        check(f"fft_32_dit 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
        if log_n == 24:
            x24 = (re, im, out)
    re, im, out = x24
    back = fft_32_dit(out[0], out[1], Direction.Reverse)
    transforms += 1
    rt = rel_l2(back[0], back[1], torch.from_numpy(re).to(dev),
                torch.from_numpy(im).to(dev))
    errs["roundtrip_2^24"] = rt
    check("round trip 2^24", rt, 1e-6)
    planner = PlannerDit32(1 << 22)
    for _ in range(2):
        re, im = signal(rng, (4, 1 << 22))
        out = fft_32_dit_with_planner(re, im, Direction.Forward, planner)
        transforms += 1
        err = oracle_err(out, re + 1j * im)
        errs.setdefault("planner_2^22_batch4", []).append(err)
        check("planner reuse 2^22 x4", err, 5e-7 * max(1.0, 22 / 18.0))
    # planes that start 4 bytes past a 16-byte boundary: the entry copies them
    n = 1 << 20
    re, im = signal(rng, (n,))
    views = []
    for plane in (re, im):
        buf = torch.zeros(n + 4, dtype=torch.float32, device=dev)
        buf[1:1 + n] = torch.from_numpy(plane).to(dev)
        views.append(buf[1:1 + n])
    if any(v.data_ptr() % 16 == 0 for v in views):
        raise AssertionError("the unaligned views are aligned")
    out = fft_32_dit(views[0], views[1], Direction.Forward)
    transforms += 1
    err = oracle_err(out, re + 1j * im)
    errs["fwd_2^20_unaligned_view"] = err
    check("fft_32_dit 2^20 on unaligned views", err, 5e-7 * max(1.0, 20 / 18.0))
    del views
    torch.cuda.synchronize()
    launches = {"colfft_out3d": kernel_launches(colfft_out3d), "leaft": kernel_launches(leaft)}
    emit({"phase": "e2e", "rel_l2": errs, "transforms": transforms,
          "launches": launches})
    for name, count in launches.items():
        if count != transforms:
            raise AssertionError(f"{name}: {count} launches for {transforms} transforms")
    if any(kernel_launches(k) for k in (leaf, leaf3, colfft, transpose2)):
        raise AssertionError("a fused split plan launched another kernel")

    # -- times
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    summary = {}
    for log_n in TIME_LOGS:
        n = 1 << log_n
        planner = PlannerDit32(n)
        _, n1, _, n2 = planner.plan
        a = n2 // 128
        tabs = planner.leaf_corrs[f"pcolT{n1}x{n2}"]
        mats = planner.leaf_corrs[f"leafT{n2}"]
        re, im = signal(rng, (1, n))
        xr = torch.from_numpy(re).to(dev)
        xi = torch.from_numpy(im).to(dev)
        ar, ai = xr.view(1, n1, n2), xi.view(1, n1, n2)
        c3 = colfft_out3d(ar, ai, tabs, n1)
        xc = torch.complex(xr, xi)
        row = {
            "colfft_out3d": {
                "ms": time_ms(lambda: colfft_out3d(ar, ai, tabs, n1), flush),
                "plain_ms": time_ms(lambda: colfft_out3d_plain(ar, ai, tabs, n1), flush),
            },
            "leaft": {
                "ms": time_ms(lambda: leaft(c3[0], c3[1], mats, n1), flush),
                "plain_ms": time_ms(lambda: leaft_plain(c3[0], c3[1], mats, n1), flush),
            },
        }
        bound_a = kernel_bound(n, n1.bit_length() - 1)
        bound_b = kernel_bound(n, n2.bit_length() - 1, a + 128 + 2 * a * 128)
        row["colfft_out3d"].update(bound_ms=bound_a[0], bound_by=bound_a[1])
        row["leaft"].update(bound_ms=bound_b[0], bound_by=bound_b[1])
        def transform():
            return fft_32_dit_with_planner(xr, xi, Direction.Forward, planner)

        emit({"phase": "times", "n": n, "n1": n1, "n2": n2, "card": smi,
              "kernels": row, "transform_ms": time_ms(transform, flush),
              "transform_wall_ms": wall_ms(transform, flush),
              "transform_bound_ms": bound_a[0] + bound_b[0],
              "library_ms": time_ms(lambda: torch.fft.fft(xc), flush)})
        summary[log_n] = row
        if log_n == max(TIME_LOGS):
            # the other route for the same row work: the leaf kernel on the n1
            # rows of n2, then transpose2 into the natural order
            fn, _, args, _ = leaf_call(PlannerDit32(n2))
            rows2 = (xr.view(n1, n2), xi.view(n1, n2))
            lo = fn(*rows2, *args)
            leaf_ms = time_ms(lambda: fn(*rows2, *args), flush)
            tr_ms = time_ms(lambda: transpose2(*lo), flush)
            emit({"phase": "times", "n": n, "route": "leaf rows + transpose2", "card": smi,
                  "leaf_rows_ms": leaf_ms, "transpose2_ms": tr_ms,
                  "sum_ms": leaf_ms + tr_ms, "leaft_ms": row["leaft"]["ms"]})
            del lo
        del c3, xc

    top = summary[max(TIME_LOGS)]
    for name in ("colfft_out3d", "leaft"):
        top[name].update(n=1 << max(TIME_LOGS), rows=1, library_ms=None)

    # -- leaf kernels: parity with the plain versions on an odd row count
    max_err.update(leaf=0.0, leaf3=0.0)
    shapes = [(log_n, LEAF_PARITY_ROWS) for log_n in LEAF_PARITY_LOGS]
    shapes += [(16, rows) for rows in LEAF3_PARITY_ROWS]
    shapes += [(n1.bit_length() + 6, rows) for n1 in LEAF_CLUSTER_N1S
               for rows in (1, resident[f"leaf_n1_{n1}"] + 1)]
    for log_n, rows in shapes:
        n = 1 << log_n
        fn, plain, args, _ = leaf_call(PlannerDit32(n))
        re, im = signal(rng, (rows, n))
        xr = torch.from_numpy(re).to(dev)
        xi = torch.from_numpy(im).to(dev)
        k = fn(xr, xi, *args)
        torch.cuda.synchronize()
        p = plain(xr, xi, *args)
        err = rel_l2(k[0], k[1], p[0], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        name = fn.__name__
        max_err[name] = max(max_err[name], mabs)
        emit({"phase": "parity_leaf", "kernel": name, "n": n, "rows": rows,
              "rel_l2": err, "max_abs_err": mabs, "bound": KERNEL_TOL})
        check(f"{name} parity at n = {n}, {rows} rows", err, KERNEL_TOL)
        del k, p, xr, xi

    # -- main path of the leaf plans: counters at 0 just before, read just after
    counters = (colfft_out3d, leaft, leaf, leaf3)
    zero_launches(counters)
    want_launches = {"leaf": 0, "leaf3": 0}
    errs = {}

    def run(fn, n):
        """fn() once; it must launch one leaf kernel (none at n = 1)."""
        before = [kernel_launches(k) for k in counters]
        out = fn()
        delta = [kernel_launches(k) - b for k, b in zip(counters, before)]
        want = [0, 0, int(2 <= n < 1 << 16), int(n == 1 << 16)]
        if delta != want:
            raise AssertionError(f"n = {n}: launches {delta}, want {want} "
                                 "(colfft_out3d, leaft, leaf, leaf3)")
        want_launches["leaf"] += want[2]
        want_launches["leaf3"] += want[3]
        return out

    for log_n in range(17):
        n = 1 << log_n
        re, im = signal(rng, (max(1, LEAF_E2E_POINTS // n), n))
        out = run(lambda: fft_32_dit(re, im, Direction.Forward), n)
        err = oracle_err(out, re + 1j * im)
        errs[f"fwd_2^{log_n}"] = err
        check(f"fft_32_dit 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
    n = 1 << 16
    re, im = signal(rng, (16, n))
    out = run(lambda: fft_32_dit(re, im, Direction.Forward), n)
    back = run(lambda: fft_32_dit(out[0], out[1], Direction.Reverse), n)
    rt = rel_l2(back[0], back[1], torch.from_numpy(re).to(dev),
                torch.from_numpy(im).to(dev))
    errs["roundtrip_2^16x16"] = rt
    check("round trip 2^16 x 16", rt, 1e-6)
    planner = PlannerDit32(1 << 12)
    for _ in range(2):
        re, im = signal(rng, (1024, 1 << 12))
        out = run(lambda: fft_32_dit_with_planner(re, im, Direction.Forward,
                                                  planner), 1 << 12)
        err = oracle_err(out, re + 1j * im)
        errs.setdefault("planner_2^12_batch1024", []).append(err)
        check("planner reuse 2^12 x 1024", err, 5e-7)
    re, im = signal(rng, (1 << 17, 256))
    out = run(lambda: fft_32_dit(re, im, Direction.Forward), 256)
    err = oracle_err(out, re + 1j * im)
    errs["2^17_rows_of_256"] = err
    check("2^17 rows of 256", err, 5e-7)
    torch.cuda.synchronize()
    launches_leaf = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_leaf", "rel_l2": errs, "launches": launches_leaf,
          "want": want_launches})
    for name, count in want_launches.items():
        if launches_leaf[name] != count:
            raise AssertionError(
                f"{name}: {launches_leaf[name]} launches, want {count}")
    if launches_leaf["colfft_out3d"] or launches_leaf["leaft"]:
        raise AssertionError("a leaf plan launched a two-pass kernel")
    launches.update(leaf=launches_leaf["leaf"], leaf3=launches_leaf["leaf3"])
    del out, back, re, im

    # -- leaf times: 1 GiB of planar input, and one row for latency
    for log_n, rows in LEAF_TIME_SHAPES:
        n = 1 << log_n
        planner = PlannerDit32(n)
        fn, plain, args, table_floats = leaf_call(planner)
        xr = torch.randn((rows, n), generator=gen, device=dev)
        xi = torch.randn((rows, n), generator=gen, device=dev)
        xc = torch.complex(xr, xi)
        bound = kernel_bound(rows * n, log_n, table_floats)

        def transform():
            return fft_32_dit_with_planner(xr, xi, Direction.Forward, planner)

        row = {"ms": time_ms(lambda: fn(xr, xi, *args), flush),
               "plain_ms": time_ms(lambda: plain(xr, xi, *args), flush),
               "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": time_ms(lambda: torch.fft.fft(xc), flush),
               "n": n, "rows": rows}
        emit({"phase": "times_leaf", "kernel": fn.__name__, "card": smi, **row,
              "transform_ms": time_ms(transform, flush),
              "transform_wall_ms": wall_ms(transform, flush)})
        if rows > 1 and log_n in (15, 16):  # the kernels line: the batched
            top[fn.__name__] = row          # top size of each kernel
        del xr, xi, xc


    # -- classic column pass and paired transpose against their plain versions
    max_err.update(colfft=0.0, transpose2=0.0)
    for b, n1, n2 in NESTED_COL_SHAPES:
        shape = ((b,) if b else ()) + (n1, n2)
        xr = torch.randn(shape, generator=gen, device=dev)
        xi = torch.randn(shape, generator=gen, device=dev)
        tabs = tuple(
            torch.from_numpy(a).to(dev)
            for a in col_split_tables_host(n1, n2, "float32", t=col_tile(n1, n2))
        )
        k = colfft(xr, xi, tabs, n1)
        torch.cuda.synchronize()
        p = colfft_plain(xr, xi, tabs, n1)
        err = rel_l2(k[0], k[1], p[0], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        max_err["colfft"] = max(max_err["colfft"], mabs)
        emit({"phase": "parity_nested", "kernel": "colfft", "batch": b or 1,
              "n1": n1, "n2": n2, "rel_l2": err, "max_abs_err": mabs,
              "bound": KERNEL_TOL})
        check(f"colfft parity at {shape}", err, KERNEL_TOL)
        del k, p, xr, xi
    for b, rows, cols in NESTED_TRANSPOSE_SHAPES:
        shape = ((b,) if b else ()) + (rows, cols)
        xa = torch.randn(shape, generator=gen, device=dev)
        xb = torch.randn(shape, generator=gen, device=dev)
        k = transpose2(xa, xb)
        torch.cuda.synchronize()
        p = transpose2_plain(xa, xb)
        same = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        mabs = max_abs(k[0], k[1], p[0], p[1])
        max_err["transpose2"] = max(max_err["transpose2"], mabs)
        emit({"phase": "parity_nested", "kernel": "transpose2", "batch": b or 1,
              "rows": rows, "cols": cols, "equal": same, "max_abs_err": mabs})
        if not same:
            raise AssertionError(f"transpose2 differs from its plain version at {shape}")
        del k, p, xa, xb
    release_memory()

    # -- main path of the nested and classic plans: counters at 0 just before,
    # read just after; every transform's own launches are checked as it runs
    counters = (colfft, colfft_out3d, leaft, leaf, leaf3, transpose2)
    names = [k.__name__ for k in counters]
    zero_launches(counters)
    want_total = dict.fromkeys(names, 0)
    nested_launches = {"colfft": 1, "colfft_out3d": 1, "leaft": 1, "transpose2": 1}

    def run_counted(fn, want):
        """fn() once; it must launch exactly ``want`` ({name: count})."""
        before = [kernel_launches(k) for k in counters]
        out = fn()
        delta = {nm: kernel_launches(k) - b0 for nm, k, b0 in zip(names, counters, before)}
        full = {nm: want.get(nm, 0) for nm in names}
        if delta != full:
            raise AssertionError(f"launches {delta}, want {full}")
        for nm in names:
            want_total[nm] += full[nm]
        return out

    def randn_pair(shape):
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))

    errs = {}
    for log_n in NESTED_E2E_LOGS:
        n = 1 << log_n
        xr, xi = randn_pair((n,))
        out = run_counted(lambda: fft_32_dit(xr, xi, Direction.Forward),
                          nested_launches)
        err = card_oracle_err(out, xr, xi)
        errs[f"fwd_2^{log_n}"] = err
        check(f"fft_32_dit 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
        if log_n == 26:
            back = run_counted(
                lambda: fft_32_dit(out[0], out[1], Direction.Reverse),
                nested_launches)
            rt = rel_l2(back[0], back[1], xr, xi)
            errs["roundtrip_2^26"] = rt
            check("round trip 2^26", rt, 1e-6)
            # the inverse of N * delta is all ones, exactly: the scale is 1/N
            dr = torch.zeros(n, device=dev)
            dr[0] = float(n)
            back = run_counted(
                lambda: fft_32_dit(dr, torch.zeros_like(dr), Direction.Reverse),
                nested_launches)
            exact = bool((back[0] == 1.0).all()) and bool((back[1] == 0.0).all())
            errs["inverse_scale_exact_2^26"] = exact
            if not exact:
                raise AssertionError("inverse of N * delta is not exactly ones")
            del back, dr
        del out, xr, xi
    planner = PlannerDit32(1 << 26)
    for _ in range(2):
        xr, xi = randn_pair((2, 1 << 26))
        out = run_counted(
            lambda: fft_32_dit_with_planner(xr, xi, Direction.Forward, planner),
            nested_launches)
        err = card_oracle_err(out, xr, xi)
        errs.setdefault("planner_2^26_batch2", []).append(err)
        check("planner reuse 2^26 x2", err, 5e-7 * max(1.0, 26 / 18.0))
        del out, xr, xi
    for log_n, rows in ((20, 3), (17, 5)):
        n = 1 << log_n
        planner = PlannerDit32(n, options=Options(leaf_fft_size=1 << 16))
        if planner.plan != ("split", n >> 16, ("leaf", 512), 1 << 16):
            raise AssertionError(f"unexpected classic plan {planner.plan}")
        xr, xi = randn_pair((rows, n))
        out = run_counted(
            lambda: fft_32_dit_with_planner(xr, xi, Direction.Forward, planner),
            {"colfft": 1, "leaf3": 1, "transpose2": 1})
        err = card_oracle_err(out, xr, xi)
        errs[f"classic_2^{log_n}_leaf_2^16_x{rows}"] = err
        check(f"classic plan 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
        del out, xr, xi
    # the top of the window: 8 GiB per planar pair
    n = 1 << TOP_LOG
    release_memory()
    xr, xi = randn_pair((n,))
    planner = PlannerDit32(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = run_counted(
        lambda: fft_32_dit_with_planner(xr, xi, Direction.Forward, planner),
        nested_launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not (bool(torch.isfinite(out[0]).all()) and bool(torch.isfinite(out[1]).all())):
        raise AssertionError("2^30: output is not finite")
    ks = torch.randint(0, n, (TOP_BINS,), generator=gen, device=dev)
    ks[:4] = torch.tensor([0, 1, n // 2, n - 1], device=dev)
    want = dft_bins(xr, xi, ks)
    got = torch.complex(out[0][ks].double(), out[1][ks].double())
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    errs[f"bins_2^{TOP_LOG}"] = err
    check(f"fft_32_dit 2^{TOP_LOG}, {TOP_BINS} bins", err,
          5e-7 * max(1.0, TOP_LOG / 18.0))
    del want, got
    back = run_counted(
        lambda: fft_32_dit_with_planner(out[0], out[1], Direction.Reverse, planner),
        nested_launches)
    rt = rel_l2(back[0], back[1], xr, xi)
    errs[f"roundtrip_2^{TOP_LOG}"] = rt
    check(f"round trip 2^{TOP_LOG}", rt, 1e-6)
    del back, out
    torch.cuda.synchronize()
    launches_nested = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_nested", "rel_l2": errs, "launches": launches_nested,
          "want": want_total,
          f"peak_bytes_2^{TOP_LOG}": peak, f"held_before_2^{TOP_LOG}": held,
          f"peak_gib_2^{TOP_LOG}": peak / 2 ** 30})
    if launches_nested != want_total:
        raise AssertionError(f"launches {launches_nested}, want {want_total}")
    launches.update(colfft=launches_nested["colfft"],
                    transpose2=launches_nested["transpose2"])

    # -- nested times; xr, xi still hold 2^30 points
    def time_transform(planner, reps):
        """Times of the whole transform (four passes of 16 B per element)
        and of the library's complex64 FFT on the first planner.n points."""
        ar, ai = xr[:planner.n], xi[:planner.n]

        def transform():
            return fft_32_dit_with_planner(ar, ai, Direction.Forward, planner)

        out = {"transform_ms": time_ms(transform, flush, reps),
               "transform_wall_ms": wall_ms(transform, flush, reps),
               "transform_bound_ms": 4 * copy_bound(planner.n)[0]}
        release_memory()
        xc = torch.complex(ar, ai)
        out["library_ms"] = time_ms(lambda: torch.fft.fft(xc), flush, reps)
        return out

    emit({"phase": "times_nested", "n": n, "card": smi, **time_transform(planner, 5)})
    release_memory()
    for log_n in NESTED_TIME_LOGS:
        n = 1 << log_n
        planner = PlannerDit32(n)
        _, n1, _, n2 = planner.plan
        tabs = planner.leaf_corrs[f"pcol{n1}x{n2}"]
        ar, ai = xr[:n].view(1, n1, n2), xi[:n].view(1, n1, n2)
        bound_c = kernel_bound(n, n1.bit_length() - 1)
        bound_t = copy_bound(n)
        row = {
            "colfft": {
                "ms": time_ms(lambda: colfft(ar, ai, tabs, n1), flush, 10),
                "plain_ms": time_ms(lambda: colfft_plain(ar, ai, tabs, n1), flush, 10),
                "bound_ms": bound_c[0], "bound_by": bound_c[1],
                "library_ms": None, "n": n, "rows": 1,
            },
            "transpose2": {
                "ms": time_ms(lambda: transpose2(ar, ai), flush, 10),
                "plain_ms": time_ms(lambda: transpose2_plain(ar, ai), flush, 10),
                "bound_ms": bound_t[0], "bound_by": bound_t[1],
                "library_ms": time_ms(
                    lambda: (ar.transpose(-1, -2).contiguous(),
                             ai.transpose(-1, -2).contiguous()), flush, 10),
                "n": n, "rows": 1,
            },
        }
        # the inner fused level on the outer level's n1 rows, as one batch
        _, m1, _, m2 = planner.plan[2]
        tabs3 = planner.leaf_corrs[f"pcolT{m1}x{m2}"]
        mats = planner.leaf_corrs[f"leafT{m2}"]
        br, bi = ar.view(n1, m1, m2), ai.view(n1, m1, m2)
        c3 = colfft_out3d(br, bi, tabs3, m1)
        inner = {
            "batch": n1, "n1": m1, "n2": m2,
            "colfft_out3d_ms": time_ms(lambda: colfft_out3d(br, bi, tabs3, m1), flush, 10),
            "leaft_ms": time_ms(lambda: leaft(c3[0], c3[1], mats, m1), flush, 10),
        }
        del c3
        emit({"phase": "times_nested", "n": n, "n1": n1, "n2": n2, "card": smi,
              "kernels": row, "inner": inner, **time_transform(planner, 10)})
        top.update(row)  # the kernels line: the last (largest) shape
    # the column pass alone at the outer levels of 2^29 and 2^30 and on the
    # fused 2^22 and 2^23 plans' column shapes (one-block paths)
    for name, fn, tile, shapes in (("colfft", colfft, col_tile, NESTED_OUTER_TIMES),
                                   ("colfft_out3d", colfft_out3d, col_tile3d,
                                    FUSED_COL_TIMES)):
        for n1, n2 in shapes:
            n = n1 * n2
            ar, ai = xr[:n].view(1, n1, n2), xi[:n].view(1, n1, n2)
            tabs = tuple(torch.from_numpy(a).to(dev) for a in
                         col_split_tables_host(n1, n2, "float32", t=tile(n1, n2)))
            bound = kernel_bound(n, n1.bit_length() - 1)
            emit({"phase": "times_nested", "kernel": name, "n1": n1, "n2": n2, "card": smi,
                  "ms": time_ms(lambda: fn(ar, ai, tabs, n1), flush, 10),
                  "bound_ms": bound[0], "bound_by": bound[1]})
    del xr, xi, ar, ai, br, bi  # the views hold the 2^30-point planes

    release_memory()

    # -- dd arithmetic on the card: TwoSum and TwoProd exact against f64
    n_pairs = DD_EXACT_PAIRS

    def signed(count):
        mag = torch.rand(count, generator=gen, device=dev) * (16 - 1 / 16) + 1 / 16
        sign = torch.randint(0, 2, (count,), generator=gen, device=dev) * 2 - 1
        return mag * sign

    pa, pb = signed(n_pairs), signed(n_pairs)
    ps, pe, pp, ppe = (torch.empty_like(pa) for _ in range(4))
    rc = _build.library().phastft_dd_exact(
        pa.data_ptr(), pb.data_ptr(), ps.data_ptr(), pe.data_ptr(), pp.data_ptr(),
        ppe.data_ptr(), n_pairs, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"dd_exact: CUDA error {rc}")
    sum_resid = float((ps.double() + pe.double() - (pa.double() + pb.double())).abs().max())
    prod_resid = float((pp.double() + ppe.double() - pa.double() * pb.double()).abs().max())
    inexact = float((pe != 0).float().mean()), float((ppe != 0).float().mean())
    emit({"phase": "dd_exact", "pairs": n_pairs, "two_sum_residual": sum_resid,
          "two_prod_residual": prod_resid, "nonzero_error_terms": inexact})
    if sum_resid != 0.0 or prod_resid != 0.0:
        raise AssertionError("TwoSum or TwoProd is not exact on this card")
    if min(inexact) < 0.25:
        raise AssertionError("dd_exact: the pairs do not exercise the error terms")
    del pa, pb, ps, pe, pp, ppe

    # -- dd kernels against their plain versions, on joined f64 values
    def dd_quad(shape):
        return (*split_f64(torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)),
                *split_f64(torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)))

    def dd_join(quad):
        """The complex128 tensor a dd quadruple stands for."""
        return torch.complex(quad[0].double() + quad[1].double(),
                             quad[2].double() + quad[3].double())

    # the tables are the ones a planner hands the main path: a plan with a
    # leaf of n2 points is one split level n1 x n2, a leaf of n1 * 128 one leaf
    def dd_corrs(n, leaf):
        return PlannerDit64(n, options=Options(leaf_fft_size=leaf,
                                               f64_engine="df64")).dd_state[1]

    def col_tables(n1, n2):
        return dd_corrs(n1 * n2, n2)[f"ddpcol{n1}x{n2}"]

    def leaf_corr(n1):
        return dd_corrs(n1 * 128, n1 * 128)[f"ddleaf{n1}"] if n1 > 1 else None

    max_err.update(ddcol=0.0, ddcol_nocorr=0.0, ddleaf=0.0)

    def dd_parity(name, k, p, **where):
        err, worst = dd_rel(k, p)
        max_err[name] = max(max_err[name], worst)
        emit({"phase": "parity_dd", "kernel": name, **where, "rel_l2": err,
              "max_abs_err": worst, "bound": DD_KERNEL_TOL})
        check(f"{name} parity at {where}", err, DD_KERNEL_TOL)

    for b, n1, n2 in DD_COL_SHAPES:
        x = dd_quad((b, n1, n2))
        t1, t2 = col_tables(n1, n2)
        k = ddcol(*x, t1, t2, n1)
        torch.cuda.synchronize()
        dd_parity("ddcol", k, ddcol_plain(*x, t1, t2, n1), batch=b, n1=n1, n2=n2)
        del k, x
    for b, n1, n2 in DD_NOCORR_SHAPES:
        x = dd_quad((b, n1, n2))
        k = ddcol_nocorr(*x, n1)
        torch.cuda.synchronize()
        dd_parity("ddcol_nocorr", k, ddcol_nocorr_plain(*x, n1), batch=b, n1=n1, n2=n2)
        del k, x
    # a ragged last wave of clusters: one more entry than are resident
    for n1 in DD_COL_CLUSTER_N1S:
        b = resident[f"ddcol_n1_{n1}"] + 1
        x = dd_quad((b, n1, 128))
        t1, t2 = col_tables(n1, 128)
        k = ddcol(*x, t1, t2, n1)
        torch.cuda.synchronize()
        dd_parity("ddcol", k, ddcol_plain(*x, t1, t2, n1), batch=b, n1=n1, n2=128)
        b = resident[f"ddcol_nocorr_n1_{n1}"] + 1
        x = dd_quad((b, n1, 32))
        k = ddcol_nocorr(*x, n1)
        torch.cuda.synchronize()
        dd_parity("ddcol_nocorr", k, ddcol_nocorr_plain(*x, n1), batch=b, n1=n1, n2=32)
        del k, x
    for n1 in DD_LEAF_N1S:
        corr = leaf_corr(n1)
        ragged = (resident[f"ddleaf_n1_{n1}"] + 1,) if n1 in DD_LEAF_CLUSTER_N1S else ()
        for rows in DD_LEAF_ROWS + ragged:
            x = dd_quad((rows, n1 * 128))
            k = ddleaf(*x, corr, n1)
            torch.cuda.synchronize()
            dd_parity("ddleaf", k, ddleaf_plain(*x, corr, n1), n=n1 * 128, rows=rows)
            del k, x
    release_memory()

    # -- main path of the f64 (df64) plans: counters at 0 just before, read
    # just after; every transform's own launches are checked against its plan
    counters = (ddcol, ddcol_nocorr, ddleaf, transpose2, colfft, colfft_out3d,
                leaft, leaf, leaf3)
    names = [k.__name__ for k in counters]
    zero_launches(counters)
    want_total = dict.fromkeys(names, 0)

    def run_dd(fn, plan, split=False):
        """fn() once; it must launch what a df64 transform of ``plan`` does."""
        return run_counted(fn, dd_launches(plan, split))

    def df64_planner(n):
        """A planner on the default leaf rule of n, pinned to "df64" (the
        default engine is the native one up to 2^25)."""
        return PlannerDit64(n, options=dataclasses.replace(
            Options.guess_options(n, np.float64), f64_engine="df64"))

    def randn64(shape):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float64),
                torch.randn(shape, generator=gen, device=dev, dtype=torch.float64))

    errs = {}
    for log_n in range(17):
        n = 1 << log_n
        re = rng.standard_normal((max(1, DD_E2E_POINTS // n), n))
        im = rng.standard_normal(re.shape)
        planner = df64_planner(n)
        out = run_dd(lambda: fft_64_dit_with_planner(re, im, Direction.Forward, planner),
                     planner.plan)
        if out[0].dtype != torch.float64:
            raise AssertionError(f"fft_64_dit_with_planner returned {out[0].dtype}")
        err = oracle_err(out, re + 1j * im)
        errs[f"fwd_2^{log_n}"] = err
        check(f"fft_64_dit 2^{log_n}", err, DD_E2E_TOL)
    peak27 = held27 = None
    for log_n in (*DD_E2E_LOGS, DD_NESTED_LOG):
        n = 1 << log_n
        xr, xi = randn64((n,))
        planner = df64_planner(n)
        if (log_n == DD_NESTED_LOG) != (planner.plan[2][0] == "split"):
            raise AssertionError(f"unexpected f64 plan {planner.plan}")
        planner.dd_state  # the tables are built before the memory reading
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = run_dd(lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, planner),
                     planner.plan)
        torch.cuda.synchronize()
        if log_n == 27:
            peak27, held27 = torch.cuda.max_memory_allocated(), held
        err = card_oracle_err(out, xr, xi)
        errs[f"fwd_2^{log_n}"] = err
        check(f"fft_64_dit 2^{log_n}", err, DD_E2E_TOL)
        if log_n == 24:
            back = run_dd(lambda: fft_64_dit_with_planner(out[0], out[1],
                                                          Direction.Reverse, planner),
                          planner.plan)
            rt = rel_l2(back[0], back[1], xr, xi)
            errs["roundtrip_2^24"] = rt
            check("f64 round trip 2^24", rt, DD_E2E_TOL)
            dr = torch.zeros(n, device=dev, dtype=torch.float64)
            dr[0] = float(n)
            back = run_dd(lambda: fft_64_dit_with_planner(dr, torch.zeros_like(dr),
                                                          Direction.Reverse, planner),
                          planner.plan)
            exact = bool((back[0] == 1.0).all()) and bool((back[1] == 0.0).all())
            errs["inverse_scale_exact_2^24"] = exact
            if not exact:
                raise AssertionError("f64 inverse of N * delta is not exactly ones")
            split_planner = PlannerDit64(n, options=Options(
                leaf_fft_size=planner.options.leaf_fft_size, f64_engine="df64-split"))
            out = run_dd(lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward,
                                                         split_planner),
                         planner.plan, split=True)
            err = card_oracle_err(out, xr, xi)
            errs["split_2^24"] = err
            check("df64-split 2^24", err, DD_E2E_TOL)
            del back, dr
        del out, xr, xi
        release_memory()
    planner = df64_planner(1 << 22)
    for _ in range(2):
        xr, xi = randn64((4, 1 << 22))
        out = run_dd(lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, planner),
                     planner.plan)
        err = card_oracle_err(out, xr, xi)
        errs.setdefault("planner_2^22_batch4", []).append(err)
        check("PlannerDit64 reuse 2^22 x4", err, DD_E2E_TOL)
        del out, xr, xi
    planner = PlannerDit64(1 << 13)
    xr, xi = randn64((64, 1 << 13))
    out = run_dd(lambda: fft_64_dit_with_planner_and_opts(
        xr, xi, Direction.Forward, planner, Options(f64_engine="df64-split")),
        planner.plan, split=True)
    err = card_oracle_err(out, xr, xi)
    errs["split_2^13_x64"] = err
    check("df64-split 2^13 x 64", err, DD_E2E_TOL)
    del out, xr, xi
    log_n, rows = DD_SPLIT_SMALL
    planner = PlannerDit64(1 << log_n)
    xr, xi = randn64((rows, 1 << log_n))
    out = run_dd(lambda: fft_64_dit_with_planner_and_opts(
        xr, xi, Direction.Forward, planner, Options(f64_engine="df64-split")),
        planner.plan, split=True)
    err = card_oracle_err(out, xr, xi)
    errs[f"split_2^{log_n}_x{rows}"] = err
    check(f"df64-split 2^{log_n} x {rows}", err, DD_E2E_TOL)
    del out, xr, xi
    torch.cuda.synchronize()
    launches_dd = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_dd", "rel_l2": errs, "launches": launches_dd,
          "want": want_total, "peak_bytes_2^27": peak27, "held_before_2^27": held27,
          "peak_gib_2^27": peak27 / 2 ** 30})
    if launches_dd != want_total:
        raise AssertionError(f"launches {launches_dd}, want {want_total}")
    for name in ("ddcol", "ddcol_nocorr", "ddleaf"):
        if launches_dd[name] < 1:
            raise AssertionError(f"{name} was never launched on the f64 main path")
        launches[name] = launches_dd[name]
    release_memory()

    # -- dd times
    def dd_row(fn, plain, bound, n, rows, library=None, reps=10):
        return {"ms": time_ms(fn, flush, reps), "plain_ms": time_ms(plain, flush, 3),
                **bound,
                "library_ms": time_ms(library, flush, reps) if library else None,
                "n": n, "rows": rows}

    for n1, n2 in DD_COL_TIME_SHAPES:
        x = dd_quad((1, n1, n2))
        t1, t2 = (col_tables(n1, n2) if n2 <= 1 << 16 else
                  PlannerDit64(n1 * n2).dd_state[1][f"ddpcol{n1}x{n2}"])
        bound = ddcol_bound(1, n1, n2)
        if n1 * n2 == 1 << 24:
            row = dd_row(lambda: ddcol(*x, t1, t2, n1),
                         lambda: ddcol_plain(*x, t1, t2, n1), bound, n1 * n2, 1)
            top["ddcol"] = row
        else:
            row = {"ms": time_ms(lambda: ddcol(*x, t1, t2, n1), flush, 10), **bound}
        emit({"phase": "times_dd", "kernel": "ddcol", "batch": 1, "n1": n1, "n2": n2,
              "card": smi, **row})
        del x
    for n1, rows, with_plain in ((512, 256, True), (512, 2048, False), (64, 1 << 11, False),
                                 (8, 1 << 14, False)):
        x = dd_quad((rows, n1 * 128))
        corr = leaf_corr(n1)
        bound = ddleaf_bound(rows, n1)
        if with_plain:
            # the library call: the same rows' DFT on a complex128 tensor
            # assembled outside the timed region
            xc = dd_join(x)
            row = dd_row(lambda: ddleaf(*x, corr, n1),
                         lambda: ddleaf_plain(*x, corr, n1), bound, n1 * 128, rows,
                         library=lambda: torch.fft.fft(xc))
            top["ddleaf"] = row
            del xc
        else:
            xc = dd_join(x)
            row = {"ms": time_ms(lambda: ddleaf(*x, corr, n1), flush, 10), **bound,
                   "library_ms": time_ms(lambda: torch.fft.fft(xc), flush, 10)}
            del xc
        emit({"phase": "times_dd", "kernel": "ddleaf", "n": n1 * 128, "rows": rows,
              "card": smi, **row})
        del x
    # the split leaf at 2^16 x 256: ddcol over 512, the transposes, the bare
    # column DFT over 128
    rows, n1 = 256, 512
    x = dd_quad((rows, n1, 128))
    t1, t2 = col_tables(n1, 128)
    xt = tuple(a.swapaxes(-1, -2).contiguous() for a in x)
    bound = ddcol_bound(rows, 128, n1, corr=False)
    xc = dd_join(xt)
    top["ddcol_nocorr"] = dd_row(lambda: ddcol_nocorr(*xt, 128),
                                 lambda: ddcol_nocorr_plain(*xt, 128), bound,
                                 n1 * 128, rows,
                                 library=lambda: torch.fft.fft(xc, dim=-2))
    del xc
    bound1 = ddcol_bound(rows, n1, 128)
    emit({"phase": "times_dd", "kernel": "split leaf", "n": n1 * 128, "rows": rows,
          "card": smi,
          "ddcol_ms": time_ms(lambda: ddcol(*x, t1, t2, n1), flush, 10),
          "ddcol_bound_ms": bound1["bound_ms"], "ddcol_bound_by": bound1["bound_by"],
          "transposes_ms": time_ms(
              lambda: (transpose2(x[0], x[2]), transpose2(x[1], x[3])), flush, 10),
          "transposes_bound_ms": 2 * copy_bound(rows * n1 * 128)[0],
          "ddcol_nocorr": top["ddcol_nocorr"]})
    del x, xt
    release_memory()
    for log_n in DD_TIME_LOGS:
        n = 1 << log_n
        xr, xi = randn64((n,))
        planner = df64_planner(n)

        def transform():
            return fft_64_dit_with_planner(xr, xi, Direction.Forward, planner)

        _, n1, (_, l1), n2 = planner.plan
        bound = (ddcol_bound(1, n1, n2)["bound_ms"] + ddleaf_bound(n1, l1)["bound_ms"]
                 + 2 * copy_bound(n)[0])
        row = {"transform_ms": time_ms(transform, flush, 10),
               "transform_wall_ms": wall_ms(transform, flush, 10),
               "transform_bound_ms": bound}
        xc = torch.complex(xr, xi)
        row["library_ms"] = time_ms(lambda: torch.fft.fft(xc), flush, 10)
        emit({"phase": "times_dd", "n": n, "n1": n1, "n2": n2, "card": smi, **row})
        del xr, xi, xc
        release_memory()

    release_memory()

    # -- Ozaki engine: the tensor-core product of integer slices is exact
    from phastft_tpu_torch.ops.ozdd import ozcol, ozcol_plain, ozleaft, ozleaft_plain

    stream = torch.cuda.current_stream().cuda_stream
    exact = {}
    for depth in OZ_EXACT_DEPTHS:
        ia = torch.randint(-128, 129, (OZ_EXACT_ROWS, depth), generator=gen, device=dev)
        ib = torch.randint(-128, 129, (OZ_EXACT_COLS, depth), generator=gen, device=dev)
        a16, b16 = ia.to(torch.bfloat16), ib.to(torch.bfloat16)
        d = torch.empty((OZ_EXACT_ROWS, OZ_EXACT_COLS), device=dev)
        rc = _build.library().phastft_oz_exact(
            a16.data_ptr(), b16.data_ptr(), d.data_ptr(), 1, OZ_EXACT_ROWS, OZ_EXACT_COLS,
            depth, stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"oz_exact: CUDA error {rc}")
        want = (ia.cpu() @ ib.cpu().T).to(dev)  # the int64 product
        exact[depth] = {"equal": bool((d.to(torch.int64) == want).all())
                        and bool((d == d.round()).all()),
                        "max_abs_err": float((d.double() - want.double()).abs().max()),
                        "max_abs_sum": float(want.abs().max())}
        del ia, ib, a16, b16, d, want
    for depth in OZ_EXACT_TIER_DEPTHS:
        # a tier: five slice pairs into one accumulator, chunk after chunk
        shape_a = (OZ_TIER_PAIRS, OZ_EXACT_ROWS, depth)
        shape_b = (OZ_TIER_PAIRS, OZ_EXACT_COLS, depth)
        ia = torch.randint(-128, 129, shape_a, generator=gen, device=dev)
        ib = torch.randint(-128, 129, shape_b, generator=gen, device=dev)
        a16, b16 = ia.to(torch.bfloat16), ib.to(torch.bfloat16)
        d = torch.empty((OZ_EXACT_ROWS, OZ_EXACT_COLS), device=dev)
        rc = _build.library().phastft_oz_exact(
            a16.data_ptr(), b16.data_ptr(), d.data_ptr(), OZ_TIER_PAIRS, OZ_EXACT_ROWS,
            OZ_EXACT_COLS, depth, stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"oz_exact: CUDA error {rc}")
        want = sum(ia[q].cpu() @ ib[q].cpu().T for q in range(OZ_TIER_PAIRS)).to(dev)
        exact[f"tier_{depth}"] = {"pairs": OZ_TIER_PAIRS,
                                  "equal": bool((d.to(torch.int64) == want).all())
                                  and bool((d == d.round()).all()),
                                  "max_abs_err": float((d.double() - want.double()).abs().max()),
                                  "max_abs_sum": float(want.abs().max())}
        del ia, ib, a16, b16, d, want
    emit({"phase": "oz_exact", "rows": OZ_EXACT_ROWS, "cols": OZ_EXACT_COLS,
          "depths": exact})
    if not all(v["equal"] for v in exact.values()):
        raise AssertionError("the bf16 product of integer slices is not exact on this card")

    # -- oz kernels against their plain versions, on a planner's tables
    def oz_tables(n1, n2):
        corrs = PlannerDit64(n1 * n2, options=Options(
            f64_engine="df64-oz", leaf_fft_size=n2)).dd_state[1]
        return corrs[f"ozcol{n1}x{n2}"], corrs[f"ozleafT{n2}"]

    max_err.update(ozcol=0.0, ozleaft=0.0)

    def oz_parity(name, k, p, **where):
        err, worst = dd_rel(k, p)
        max_err[name] = max(max_err[name], worst)
        emit({"phase": "parity_oz", "kernel": name, **where, "rel_l2": err,
              "bit_equal": all(torch.equal(u, v) for u, v in zip(k, p)),
              "max_abs_err": worst, "bound": DD_KERNEL_TOL})
        check(f"{name} parity at {where}", err, DD_KERNEL_TOL)

    for b, n1, n2 in OZ_COL_SHAPES:
        x = dd_quad((b, n1, n2))
        ct, _ = oz_tables(n1, n2)
        k = ozcol(*x, ct, n1)
        torch.cuda.synchronize()
        oz_parity("ozcol", k, ozcol_plain(*x, ct, n1), batch=b, n1=n1, n2=n2)
        del k, x
    for a in OZ_LEAF_AS:
        for n1 in OZ_LEAF_N1S:
            n2 = a * 128
            ct, lt = oz_tables(n1, n2)
            x = dd_quad((OZ_LEAF_BATCH, n1, n2))
            c = ozcol_plain(*x, ct, n1)
            k = ozleaft(*c, lt, n1)
            torch.cuda.synchronize()
            oz_parity("ozleaft", k, ozleaft_plain(*c, lt, n1), batch=OZ_LEAF_BATCH, a=a,
                      n1=n1)
            # ozleaft ends the transform that ozcol began
            flat = (OZ_LEAF_BATCH, n1 * n2)
            err = card_oracle_err((k[0].double() + k[1], k[2].double() + k[3]),
                                  (x[0].double() + x[1]).reshape(flat),
                                  (x[2].double() + x[3]).reshape(flat))
            emit({"phase": "parity_oz", "kernel": "ozcol -> ozleaft", "a": a, "n1": n1,
                  "rel_l2_vs_fft": err, "bound": OZ_E2E_TOL})
            check(f"ozleaft at A = {a}, n1 = {n1} against an f64 FFT", err, OZ_E2E_TOL)
            del x, c, k
    release_memory()

    # -- main path of the "df64-oz" plans: counters at 0 just before, read just
    # after; every transform's own launches are checked against its plan
    counters = (ozcol, ozleaft, ddcol, ddcol_nocorr, ddleaf, transpose2, colfft,
                colfft_out3d, leaft, leaf, leaf3)
    names = [k.__name__ for k in counters]
    zero_launches(counters)
    want_total = dict.fromkeys(names, 0)
    oz_level = {"ozcol": 1, "ozleaft": 1}

    def oz_planner(n, leaf=1 << 13):
        return PlannerDit64(n, options=Options(f64_engine="df64-oz", leaf_fft_size=leaf))

    def inverse_err(got, xr, xi):
        want = torch.fft.ifft(torch.complex(xr, xi))
        return float(torch.linalg.vector_norm(torch.complex(*got) - want)
                     / torch.linalg.vector_norm(want))

    errs = {}
    for log_n, leaf_size in OZ_E2E:
        n = 1 << log_n
        planner = oz_planner(n, leaf_size)
        want = dict(oz_level)
        if planner.plan[2][0] == "split":  # nested: a df64 outer level around oz
            want.update(ddcol=1, transpose2=2)
        xr, xi = randn64((n,))
        out = run_counted(
            lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, planner), want)
        err = card_oracle_err(out, xr, xi)
        errs[f"fwd_2^{log_n}"] = err
        check(f"df64-oz 2^{log_n}", err, OZ_E2E_TOL)
        if log_n == OZ_ROUNDTRIP_LOG:
            back = run_counted(
                lambda: fft_64_dit_with_planner(out[0], out[1], Direction.Reverse,
                                                planner), want)
            rt = rel_l2(back[0], back[1], xr, xi)
            errs[f"roundtrip_2^{log_n}"] = rt
            check(f"df64-oz round trip 2^{log_n}", rt, OZ_E2E_TOL)
            del back
            inv = run_counted(
                lambda: fft_64_dit_with_planner(xr, xi, Direction.Reverse, planner), want)
            err = inverse_err(inv, xr, xi)
            errs[f"inverse_2^{log_n}"] = err
            check(f"df64-oz inverse 2^{log_n}", err, OZ_E2E_TOL)
            del inv
            # a per-call "df64-oz" on a "df64" planner finds no oz tables
            df = df64_planner(n)
            out2 = run_counted(lambda: fft_64_dit_with_planner_and_opts(
                xr, xi, Direction.Forward, df, Options(f64_engine="df64-oz")),
                dd_launches(df.plan, False))
            err = card_oracle_err(out2, xr, xi)
            errs[f"per_call_oz_on_df64_2^{log_n}"] = err
            check(f"per-call df64-oz on a df64 planner 2^{log_n}", err, DD_E2E_TOL)
            del out2
        del out, xr, xi
        release_memory()
    planner = oz_planner(1 << 20)
    for _ in range(2):
        xr, xi = randn64((4, 1 << 20))
        out = run_counted(
            lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, planner), oz_level)
        err = card_oracle_err(out, xr, xi)
        errs.setdefault("planner_2^20_batch4", []).append(err)
        check("df64-oz planner reuse 2^20 x4", err, OZ_E2E_TOL)
        del out, xr, xi
    torch.cuda.synchronize()
    launches_oz = {k.__name__: kernel_launches(k) for k in counters}
    emit({"phase": "e2e_oz", "rel_l2": errs, "launches": launches_oz, "want": want_total})
    if launches_oz != want_total:
        raise AssertionError(f"launches {launches_oz}, want {want_total}")
    for name in ("ozcol", "ozleaft"):
        if launches_oz[name] < 1:
            raise AssertionError(f"{name} was never launched on the df64-oz main path")
        launches[name] = launches_oz[name]
    release_memory()

    # -- oz times, beside the df64 transform and the library's complex128 FFT
    for log_n in OZ_TIME_LOGS:
        n = 1 << log_n
        planner = oz_planner(n)
        _, n1, _, n2 = planner.plan
        ct = planner.dd_state[1][f"ozcol{n1}x{n2}"]
        lt = planner.dd_state[1][f"ozleafT{n2}"]
        x = dd_quad((1, n1, n2))
        c = ozcol(*x, ct, n1)
        row = {
            "ozcol": dd_row(lambda: ozcol(*x, ct, n1), lambda: ozcol_plain(*x, ct, n1),
                            oz_bound("ozcol", n, n1), n, 1),
            "ozleaft": dd_row(lambda: ozleaft(*c, lt, n1),
                              lambda: ozleaft_plain(*c, lt, n1),
                              oz_bound("ozleaft", n, n1), n, 1),
        }
        del x, c
        xr, xi = randn64((n,))
        df = df64_planner(n)

        def transform():
            return fft_64_dit_with_planner(xr, xi, Direction.Forward, planner)

        xc = torch.complex(xr, xi)
        emit({"phase": "times_oz", "n": n, "n1": n1, "n2": n2, "card": smi,
              "kernels": row, "transform_ms": time_ms(transform, flush, 10),
              "transform_wall_ms": wall_ms(transform, flush, 10),
              "transform_bound_ms": row["ozcol"]["bound_ms"] + row["ozleaft"]["bound_ms"],
              "df64_transform_ms": time_ms(
                  lambda: fft_64_dit_with_planner(xr, xi, Direction.Forward, df), flush, 10),
              "library_ms": time_ms(lambda: torch.fft.fft(xc), flush, 10)})
        top.update(row)  # the kernels line: the last (largest) shape
        del xr, xi, xc
        release_memory()
    # the inner level of the nested 2^26 plan: 64 entries of (128, 8192)
    b, n1, n2 = OZ_INNER_LEVEL
    ct, lt = oz_tables(n1, n2)
    x = dd_quad((b, n1, n2))
    c = ozcol(*x, ct, n1)
    inner = {"ozcol": {"ms": time_ms(lambda: ozcol(*x, ct, n1), flush, 10),
                       **oz_bound("ozcol", n1 * n2, n1, b)},
             "ozleaft": {"ms": time_ms(lambda: ozleaft(*c, lt, n1), flush, 10),
                         **oz_bound("ozleaft", n1 * n2, n1, b)}}
    emit({"phase": "times_oz", "level": "inner level of 2^26", "batch": b, "n1": n1, "n2": n2,
          "card": smi, "kernels": inner})
    del x, c
    release_memory()

    # -- the native f64 engine, the hybrid leaf, then the distributed
    # four-step at world size 1
    native_phases(dev, gen, flush, smi, top, launches, max_err)
    hybrid_phases(dev, gen, rng, flush, smi, top, launches, max_err)
    with nccl_world():
        dist_phases(dev, gen, flush, smi, top, launches, max_err)
        dist64_phases(dev, gen, flush, smi, top, launches, max_err)
        dist_chunks_phases(dev, gen, flush, smi)
        r2c_phases(dev, gen, flush, smi, top, launches, max_err)
        giant_phases(dev, gen, flush, smi, top, launches, max_err)
        edge_phases(dev, gen, flush, smi, top, launches, max_err)
        tune_phases(dev, gen, flush, smi)
        oracle_phases(dev, gen, flush, smi)

    sources = {
        "colfft_out3d": ("phastft_tpu_torch/csrc/colfft.cu",
                         "phastft_tpu/ops/pallas_col.py:490"),
        "leaft": ("phastft_tpu_torch/csrc/leaft.cu",
                  "phastft_tpu/ops/pallas_leaft.py:322"),
        "leaf": ("phastft_tpu_torch/csrc/leaf.cu",
                 "phastft_tpu/ops/pallas_leaf.py:151"),
        "leaf3": ("phastft_tpu_torch/csrc/leaf3.cu",
                  "phastft_tpu/ops/pallas_leaf.py:304"),
        "colfft": ("phastft_tpu_torch/csrc/colfft.cu",
                   "phastft_tpu/ops/pallas_col.py:490"),
        "transpose2": ("phastft_tpu_torch/csrc/transpose.cu",
                       "phastft_tpu/ops/pallas_transpose.py:64"),
        "ddcol": ("phastft_tpu_torch/csrc/ddcol.cu",
                  "phastft_tpu/ops/pallas_dd.py:207"),
        "ddcol_nocorr": ("phastft_tpu_torch/csrc/ddcol.cu",
                         "phastft_tpu/ops/pallas_dd.py:287"),
        "ddleaf": ("phastft_tpu_torch/csrc/ddleaf.cu",
                   "phastft_tpu/ops/pallas_dd.py:382"),
        "ozcol": ("phastft_tpu_torch/csrc/ozcol.cu",
                  "phastft_tpu/ops/pallas_ozdd.py:286"),
        "ozleaft": ("phastft_tpu_torch/csrc/ozleaft.cu",
                    "phastft_tpu/ops/pallas_ozdd.py:415"),
        "hybrid": ("phastft_tpu_torch/csrc/hybrid.cu",
                   "phastft_tpu/ops/pallas_leaf.py:410"),
        "colfft_nocorr": ("phastft_tpu_torch/csrc/colfft.cu",
                          "phastft_tpu/ops/pallas_col.py:281"),
        "col64_nocorr": ("phastft_tpu_torch/csrc/col64.cu",
                         "phastft_tpu/parallel/fourstep_dist.py:203"),
        # the native f64 engine: no TPU kernel; what each stands for
        "leaf64": ("phastft_tpu_torch/csrc/leaf64.cu",
                   "phastft_tpu/ops/stockham.py:236"),
        "col64": ("phastft_tpu_torch/csrc/col64.cu",
                  "phastft_tpu/ops/fourstep.py:353-380"),
        "transpose2_64": ("phastft_tpu_torch/csrc/transpose64.cu",
                          "phastft_tpu/ops/fourstep.py:149"),
        # the real transforms' passes: no TPU kernel; the XLA code of
        # phastft_tpu/ops/r2c.py that each stands for
        "deinterleave": ("phastft_tpu_torch/csrc/r2c.cu", "phastft_tpu/ops/r2c.py:302"),
        "untangle": ("phastft_tpu_torch/csrc/r2c.cu", "phastft_tpu/ops/r2c.py:65"),
        "pre_untangle": ("phastft_tpu_torch/csrc/r2c.cu", "phastft_tpu/ops/r2c.py:96"),
        "interleave_scale": ("phastft_tpu_torch/csrc/r2c.cu", "phastft_tpu/ops/r2c.py:451"),
    }
    from phastft_tpu_torch import tracing

    emit({"phase": "run", "seconds": time.perf_counter() - t_run, "card": smi,
          "launches": dict(tracing.launches), "scales": dict(tracing.scales)})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": top[name]["ms"], "plain_ms": top[name]["plain_ms"],
         "bound_ms": top[name]["bound_ms"], "bound_by": top[name]["bound_by"],
         "library_ms": top[name]["library_ms"], "n": top[name]["n"],
         "rows": top[name]["rows"],
         **{k: top[name][k] for k in ("bound_bytes_ms", "bound_ops_ms", "bound_instr_ms",
                                      "kernel_tc_ms", "kernel_ops_ms") if k in top[name]}}
        for name, (src, rep) in sources.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fold"]:
        sys.exit(fold_turns(sys.argv[2]))
    if sys.argv[1:2] == ["--fold-tree"]:
        sys.exit(fold_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--turns"]:
        sys.exit(turns(sys.argv[2]))
    if sys.argv[1:2] == ["--time-tree"]:
        sys.exit(time_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--chunks"]:
        sys.exit(chunks_mode(int(sys.argv[2])))
    if sys.argv[1:2] == ["--chunks-rank"]:
        sys.exit(chunks_rank(*map(int, sys.argv[2:5])))
    sys.exit(main())
