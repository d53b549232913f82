"""Spans and the launch counter: what the port records of its own work.

``span(name)`` is a ``torch.profiler.record_function(name)`` while a
profiler records, else one shared ``contextlib.nullcontext()``, so a span
costs one check when nobody traces. ``@traced(name)`` puts a whole
function's calls in such a span. To see the spans, run the port under
``torch.profiler.profile(activities=[ProfilerActivity.CPU,
ProfilerActivity.CUDA])``: they are user annotations on the same timeline
as the CUDA kernels, copies and collectives, so each gap on the device
falls inside the host code that left it. Spans nest by time on the
caller's thread; the outermost entry span is a call's root.

==============================  =============================================
``phastft.fft``                 a C2C call (``fft._run``)
``phastft.real``                an R2C / C2R call (``real_fft``)
``phastft.dist``                a distributed call (``parallel``)
``phastft.convert``             an input copied or converted to the planner's
``phastft.plan``                a plan, a planner or its tables built (a
                                cache miss; never on a reused planner)
``phastft.pass.leaf``           a leaf or tiny plan
``phastft.pass.fused``          a fused two-pass split level
``phastft.pass.split``          a classic split level, its inner plan inside
``phastft.pass.columns``        a leaf past the leaf kernels (``leaf_columns``)
``phastft.scale``               the inverse's 1/n as a pass of its own (the
                                df64 and Ozaki engines, the staged oracle,
                                a distributed permuted input)
``phastft.launch.<entry>``      one kernel launch through ``ops/_build.call``
``phastft.dist.send``           a permuted contiguous send copy
``phastft.dist.a2a``            an ``all_to_all_single`` issued
``phastft.dist.column``         a chunk's column pass
``phastft.dist.land``           a received plane into the row planes
``phastft.dist.wait``           a wait on a collective in flight
==============================  =============================================

``launches`` counts the kernel launches that returned no error, by the
launching wrapper's name (``leaf``, ``colfft_out3d``, ``untangle``, ...),
always. ``launch_count`` reads it.

``scales`` counts where each inverse's 1/n went, always: the name of the
wrapper that stores the transform's output with it folded into its store
(``leaf``, ``leaft``, ``transpose2_64``, ...; ``fold`` counts it where a
row pass hands it over), or ``"torch"`` where it is a multiply of its own in
the ``phastft.scale`` span. A fast f32 or native f64 inverse of one point
has nothing to fold (its 1/n is 1) and counts nothing.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

__all__ = ["span", "traced", "launches", "launch_count", "scales", "fold"]

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

#: Kernel launches by wrapper name, since the process started.
launches: collections.Counter = collections.Counter()

#: Inverses' 1/n by where they went: a wrapper's name, or "torch".
scales: collections.Counter = collections.Counter()


def span(name: str):
    """A profiler span named ``name`` while a profiler records, else a
    shared context that does nothing."""
    return torch.profiler.record_function(name) if _recording() else _OFF


def traced(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def launch_count(*kernels: str) -> int:
    """The launches of the wrappers ``kernels`` summed, or of every wrapper
    when none is named."""
    if not kernels:
        return sum(launches.values())
    return sum(launches[k] for k in kernels)


def fold(kernel: str, out_scale: float) -> float:
    """``out_scale``, handed to the wrapper ``kernel`` as the factor of its
    stores; counted in ``scales[kernel]`` when it is not 1 (an inverse's
    1/n)."""
    if out_scale != 1.0:
        scales[kernel] += 1
    return out_scale
