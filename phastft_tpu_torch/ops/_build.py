"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface. On first use each
source is compiled by its own ``nvcc`` process (all started together) for
``sm_90a``, the objects are linked into one shared library under
``phastft_tpu_torch/_build/``, and the library is loaded with ``ctypes``.
The library's name carries a hash of the sources and flags, so a changed
source is rebuilt. No PyTorch header is compiled: a build takes seconds.

A failed build raises; nothing falls back to another path. Importing this
module needs neither ``nvcc`` nor a GPU: it builds only when called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import MappingProxyType

from ..tracing import launches, span

__all__ = ["library", "build_log", "call", "check_args", "SRC_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
#: C entry points and their argument types: pointers and the stream are
#: c_void_p (a c_int would cut a 64-bit pointer), sizes are c_int, and a
#: batch or row count whose product with n can pass 2^31 is c_int64. Every
#: c_int is a length of one axis (n1, n2, a row length, a table's width) or
#: a flag. A c_double is an output scale (the kernels that can end a
#: transform multiply every stored value by it: 1, an inverse's 1/n, the
#: C2R's 2/n).
#: Every wrapper launches through ``call``, whose ``check_args``
#: refuses a value past its type, which ctypes would cut without a word.
#: Inside the kernels every offset into a tensor is 64-bit.
_SIGNATURES = {
    "phastft_colfft": [_P] * 5 + [_I, _P, _P, _L, _I, _I, _I, _L, _L, _P],
    "phastft_colfft_clusters": [_I, _I],
    "phastft_leaft": [_P] * 10 + [_L, _I, _I, _D, _P],
    "phastft_leaft_clusters": [_I],
    "phastft_leaf": [_P] * 10 + [_L, _I, _I, _D, _P],
    "phastft_leaf_clusters": [_I],
    "phastft_leaf3": [_P] * 12 + [_L, _I, _D, _P],
    "phastft_leaf3_clusters": [_I],
    "phastft_hybrid": [_P] * 8 + [_L, _I, _D, _P],
    "phastft_hybrid_clusters": [_I],
    "phastft_transpose2": [_P] * 4 + [_L, _L, _L, _D, _P],
    "phastft_ddcol": [_P] * 17 + [_L, _I, _I, _P],
    "phastft_ddcol_nocorr": [_P] * 9 + [_L, _I, _I, _P],
    "phastft_ddcol_clusters": [_I, _I],
    "phastft_ddleaf": [_P] * 14 + [_L, _I, _P],
    "phastft_ddleaf_clusters": [_I],
    "phastft_dd_exact": [_P] * 6 + [_L, _P],
    # the oz kernels take a host array of their device pointers
    "phastft_ozcol": [_P, _L, _I, _I, _P],
    "phastft_ozleaft": [_P, _L, _I, _I, _P],
    "phastft_ozcol_blocks": [],
    "phastft_ozleaft_clusters": [_I],
    "phastft_oz_exact": [_P] * 3 + [_I, _I, _I, _I, _P],
    # the native f64 engine
    "phastft_col64": [_P] * 9 + [_L, _I, _I, _P],
    "phastft_col64_nocorr": [_P] * 5 + [_L, _I, _I, _P],
    "phastft_col64_clusters": [_I],
    "phastft_leaf64": [_P] * 8 + [_L, _I, _D, _P],
    "phastft_leaf64_clusters": [_I],
    "phastft_transpose2_64": [_P] * 4 + [_L, _L, _L, _D, _P],
    # the real transforms' passes (f64 flag first)
    "phastft_r2c_deinterleave": [_I, _P, _P, _P, _L, _P],
    "phastft_r2c_interleave": [_I, _P, _P, _P, _L, _D, _P],
    "phastft_r2c_untangle": [_I, _I] + ([_P, _P, _L] * 3) + [_P] * 4 + [_L] * 5 + [_I, _P],
    "phastft_r2c_untangle_pair": [_I, _I] + [_P] * 6 + [_L, _L, _I, _P],
}

#: The C entries that launch a kernel (not the ``*_clusters``,
#: ``*_blocks`` and ``*_exact`` queries), each with its span's name.
_LAUNCH_SPANS = MappingProxyType({
    name: "phastft.launch." + name for name in _SIGNATURES
    if not name.endswith(("_clusters", "_blocks", "_exact"))})

_lock = threading.Lock()
_lib = None
_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(srcs, out: Path) -> str:
    """Compile every source in parallel, link ``out``; return nvcc's
    messages (register and shared-memory use per kernel)."""
    nvcc = _nvcc()
    tmp = out.parent / f"{out.stem}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log)
        )
    so_tmp = tmp / out.name
    link = [nvcc, "-shared", "-o", str(so_tmp), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"linking {out.name} failed:\n{res.stderr}")
    os.replace(so_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, _log
    with _lock:
        if _lib is None:
            srcs = _sources()
            out = BUILD_DIR / f"libphastft_kernels_{_digest(srcs)}.so"
            if not out.exists():
                _log = _build(srcs, out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_args(name: str, args) -> tuple:
    """``args`` of the C entry ``name`` as a tuple, checked against its
    signature: as many as it takes, each c_int within 32 bits and each
    c_int64 within 64 (ctypes would pass the low bits of a larger int).
    Needs neither the library nor a GPU."""
    types = _SIGNATURES[name]
    args = tuple(args)
    if len(args) != len(types):
        raise TypeError(f"{name} takes {len(types)} arguments, got {len(args)}")
    for i, (value, kind) in enumerate(zip(args, types)):
        bits = 32 if kind is _I else 64 if kind is _L else 0
        if bits and not -(1 << (bits - 1)) <= int(value) < 1 << (bits - 1):
            raise OverflowError(
                f"{name}: argument {i} = {value} does not fit a {bits}-bit int")
    return args


def call(name: str, args, kernel: str | None = None) -> int:
    """The C entry ``name`` on ``check_args(name, args)``; returns its CUDA
    error code. A launch entry runs inside its ``phastft.launch.<name>``
    span and, when it returns 0, adds one to ``tracing.launches[kernel]``:
    ``kernel`` is the launching wrapper's name, which a launch entry needs."""
    label = _LAUNCH_SPANS.get(name)
    if label is None:
        return getattr(library(), name)(*check_args(name, args))
    if kernel is None:
        raise ValueError(f"{name}: a launch names its kernel")
    with span(label):
        err = getattr(library(), name)(*check_args(name, args))
    if err == 0:
        launches[kernel] += 1
    return err


def build_log() -> str:
    """nvcc's messages from the build this process made ('' when the
    library was already built)."""
    return _log
