"""The port with one fault planted under it, for showing that the check
fails where the timed path is broken. Used by ``test_portbench_faults.py``
on the CPU and by ``readings.py --system fault:<name>`` on the card.

* ``identity``: a call that returns its input unchanged (a step that
  returns its state unchanged);
* ``half_batch``: only the first half of the rows transformed, the other
  half given the same outputs (half the batch left out);
* ``no_exchange``: every ``all_to_all_single`` a local copy (the exchange
  between chips left out);
* ``altered``: one output point of every call changed by more than its own
  size (an answer altered where it is produced).
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist

from .systems import Port

NAMES = ("identity", "half_batch", "no_exchange", "altered")


@contextlib.contextmanager
def _local_exchange():
    real = dist.all_to_all_single

    class Done:
        def wait(self):
            return True

    def local(output, input, *args, async_op=False, **kwargs):
        output.copy_(input)
        return Done() if async_op else None

    dist.all_to_all_single = local
    try:
        yield
    finally:
        dist.all_to_all_single = real


class Faulty(Port):
    def __init__(self, fault: str, config: dict, traffic: dict, device):
        if fault not in NAMES:
            raise ValueError(f"unknown fault {fault!r}: {NAMES}")
        super().__init__(config, traffic, device)
        self.fault = fault

    def _call(self, call, re, im):
        if self.fault == "identity":
            return re.clone(), im.clone()
        if self.fault == "half_batch":
            half = re.shape[0] // 2
            if re.dim() != 2 or half == 0:
                raise ValueError("half_batch needs a batch of two rows or more")
            yr, yi = call(re[:half].contiguous(), im[:half].contiguous())
            reps = -(-re.shape[0] // half)
            return (yr.repeat(reps, 1)[:re.shape[0]].contiguous(),
                    yi.repeat(reps, 1)[:re.shape[0]].contiguous())
        if self.fault == "no_exchange":
            with _local_exchange():
                return call(re, im)
        yr, yi = call(re, im)
        flat = yr.view(-1)
        at = flat.numel() // 3
        flat[at] += flat[at].abs() + 1.0
        return yr, yi

    def forward(self, re, im):
        return self._call(super().forward, re, im)

    def inverse(self, re, im):
        return self._call(super().inverse, re, im)
