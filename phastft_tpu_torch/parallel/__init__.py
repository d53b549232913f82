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
  as ``all_to_all_single``.

The distributed real transforms (``parallel/real_dist.py``) wait for R2C
(ROADMAP.md Queue 1 item 10).
"""

from .batch import batch_fft_sharded
from .fourstep_dist import fft_distributed

__all__ = ["batch_fft_sharded", "fft_distributed"]
