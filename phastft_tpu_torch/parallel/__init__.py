"""Multi-device execution on ``torch.distributed``: sharded batch FFTs and
the distributed four-step.

Counterpart of the JAX package's ``parallel/``, with a process group in
place of a device mesh: every rank calls the same entry with its own local
shard, on its own device, and gets its own shard back (NCCL between cards,
gloo between CPU processes). The group is the caller's, initialised with
``torch.distributed.init_process_group``; the default group when none is
given.

* ``batch_fft_sharded``: a batch of independent transforms split over the
  ranks, no communication;
* ``fft_distributed``: one length-n transform split over the ranks, in
  f32 or f64 (the native, df64 and df64-oz engines), its global transposes
  as ``all_to_all_single``;
* ``r2c_fft_distributed`` / ``c2r_fft_distributed``: the real transforms
  of one signal split over the ranks, ``fft_distributed`` on half the
  length between the untangle kernels, the mirror swapped with a partner
  rank (``parallel/real_dist.py``).
"""

from .batch import batch_fft_sharded
from .fourstep_dist import fft_distributed
from .real_dist import c2r_fft_distributed, r2c_fft_distributed

__all__ = ["batch_fft_sharded", "fft_distributed", "r2c_fft_distributed",
           "c2r_fft_distributed"]
