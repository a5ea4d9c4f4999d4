"""Build and load the port's CUDA kernels.

Every ``amcx_torch/csrc/*.cu`` is compiled by ONE ``nvcc`` call into a
shared library with a plain C interface, at first use, into
``amcx_torch/build/`` (named by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library). The library is loaded
with ``ctypes``. Nothing here runs at import: importing the port never
touches CUDA or ``nvcc``.

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

__all__ = ["NVCC_FLAGS", "library", "function", "check", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

build_info = {"seconds": None, "path": None, "built": None}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if "CUDA_HOME" in os.environ else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    t0 = time.perf_counter()
    out = BUILD_DIR / f"libamcx_torch_{_digest()}.so"
    built = False
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        # build to a temporary name, then rename: a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        built = True
    lib = ctypes.CDLL(str(out))
    lib.amcx_error_string.argtypes = [ctypes.c_int]
    lib.amcx_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=str(out), built=built)
    return lib


def function(name: str, argtypes):
    """The C entry ``name`` with its ``argtypes`` declared (pointers and the
    stream as ``c_void_p``, so ctypes never truncates them to 32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().amcx_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
