"""The port stands alone: it imports neither JAX nor the JAX package, and
importing its kernel modules builds nothing (no nvcc, no GPU needed)."""

import os
import re
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "phastft_tpu_torch")

# `phastft_tpu` followed by a word character is another name
# (phastft_tpu_torch); only the JAX package and its submodules count.
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|phastft_tpu)(?:\.|\s|$)", re.MULTILINE
)


def _run(code: str, **env):
    full = dict(os.environ, **env)
    full["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=full, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_import_pulls_in_no_jax():
    out = _run(
        "import sys, phastft_tpu_torch, phastft_tpu_torch.fft, "
        "phastft_tpu_torch.ops.fourstep, phastft_tpu_torch.ops.dd, "
        "phastft_tpu_torch.ops.df64, phastft_tpu_torch.ops.leaf, "
        "phastft_tpu_torch.parallel, phastft_tpu_torch.parallel.fourstep_dist, "
        "phastft_tpu_torch.tune, phastft_tpu_torch.ops.bitrev, "
        "phastft_tpu_torch.ops.route\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'phastft_tpu') "
        "or m.startswith(('jax.', 'phastft_tpu.')))\n"
        "print(repr(bad))"
    )
    assert out.strip() == "[]"


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        found = _FORBIDDEN.findall(f.read())
    assert not found, f"{path}: {found}"


def test_kernel_modules_import_without_nvcc_or_gpu():
    out = _run(
        "import phastft_tpu_torch.ops.colfft, phastft_tpu_torch.ops.leaft, "
        "phastft_tpu_torch.ops.leaf, phastft_tpu_torch.ops.transpose, "
        "phastft_tpu_torch.ops.dd, phastft_tpu_torch.ops.df64, "
        "phastft_tpu_torch.parallel, phastft_tpu_torch.parallel.fourstep_dist, "
        "phastft_tpu_torch.tune, phastft_tpu_torch.ops.bitrev, "
        "phastft_tpu_torch.ops.route\n"
        "from phastft_tpu_torch.ops import _build\n"
        "print(_build._lib is None, _build.build_log() == '')",
        PATH="/nonexistent", CUDA_VISIBLE_DEVICES="",
    )
    assert out.strip() == "True True"
