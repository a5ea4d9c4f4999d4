"""Build and load the port's CUDA kernels.

Each ``amcx_torch/csrc/*.cu`` is compiled into a shared library of its own
with a plain C interface, at first use, into ``amcx_torch/build/`` (named by
a hash of that source, the shared headers and the flags, so an edit rebuilds
and an unchanged tree reuses the library). The ``nvcc`` processes of all
missing libraries are started together and run in parallel. The libraries
are loaded with ``ctypes``. Nothing here runs at import: importing the port
never touches CUDA or ``nvcc``.

No ``--use_fast_math``: it swaps ``expf``/``logf``/division for
approximations, and the induction's exercise boundaries flip on f32 noise
of that size. ``-fmad=false`` keeps every multiply and add rounded on its
own, as torch's separate elementwise ops round them, so a kernel and its
plain version can agree to the bit (see ``csrc/lsmc_mega.cu``).

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on any value other than 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "libraries", "function", "check", "build_info", "sm_count"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

build_info = {"seconds": None, "paths": None, "built": None}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if "CUDA_HOME" in os.environ else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def libraries() -> dict:
    """Build (if needed) and load every kernel library: source stem → CDLL."""
    t0 = time.perf_counter()
    outs = {src: BUILD_DIR / f"lib{src.stem}_{_digest(src)}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    jobs = []
    for src, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a temporary name, then rename: a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, tmp, out, proc))
    failures = []
    for cmd, tmp, out, proc in jobs:  # wait for every process before raising
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    libs = {src.stem: ctypes.CDLL(str(out)) for src, out in outs.items()}
    build_info.update(seconds=time.perf_counter() - t0,
                      paths=[str(out) for out in outs.values()], built=bool(jobs))
    return libs


def _symbol(name: str):
    for lib in libraries().values():
        if hasattr(lib, name):
            return getattr(lib, name)
    raise RuntimeError(f"no kernel library exports {name}")


def function(name: str, argtypes):
    """The C entry ``name`` with its ``argtypes`` declared (pointers and the
    stream as ``c_void_p``, so ctypes never truncates them to 32 bits)."""
    fn = _symbol(name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent grids
    (kernels 3 and 8) size their blocks by it."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        err = _symbol("amcx_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {rc} ({err(rc).decode()})")
