"""The port with one fault planted under it, for showing that the check
fails where the timed path is broken. Used by ``test_portbench_check.py``
on the CPU and by ``readings.py --system fault:<name>`` on the card.

* ``identity``: a call that returns its input unchanged (a step that
  returns its state unchanged); not for a real entry, whose outputs have
  another shape than its inputs;
* ``half_batch``: only the first half of the rows transformed, the other
  half given the same outputs (half the batch left out);
* ``no_exchange``: every ``all_to_all_single`` a local copy (the exchange
  between chips left out);
* ``altered``: one output point of every call changed by more than its own
  size (an answer altered where it is produced);
* ``conjugate``: the forward's output conjugated, its imaginary plane
  negated (the sign slip an untangle can make).
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist

from .systems import Port

NAMES = ("identity", "half_batch", "no_exchange", "altered", "conjugate")


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
        if fault == "identity" and config["entry"] == "real":
            raise ValueError("identity has no real form: an R2C's output is not its input's shape")
        super().__init__(config, traffic, device)
        self.fault = fault

    def _call(self, call, planes):
        if self.fault == "identity":
            return tuple(p.clone() for p in planes)
        if self.fault == "half_batch":
            rows, half = planes[0].shape[0], planes[0].shape[0] // 2
            if planes[0].dim() != 2 or half == 0:
                raise ValueError("half_batch needs a batch of two rows or more")
            outs = call(*(p[:half].contiguous() for p in planes))
            reps = -(-rows // half)
            return tuple(o.repeat(reps, 1)[:rows].contiguous() for o in outs)
        if self.fault == "no_exchange":
            with _local_exchange():
                return call(*planes)
        outs = call(*planes)
        if self.fault == "altered":
            flat = outs[0].view(-1)
            at = flat.numel() // 3
            flat[at] += flat[at].abs() + 1.0
        return outs

    def forward(self, *planes):
        outs = self._call(super().forward, planes)
        if self.fault == "conjugate":
            outs[1].neg_()
        return outs

    def inverse(self, *planes):
        return self._call(super().inverse, planes)
