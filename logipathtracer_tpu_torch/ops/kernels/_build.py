"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, at first use, into the package's git-ignored
``build/kernels`` directory, and loads with ``ctypes``.  A library is
rebuilt when its source is newer.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build", "kernels")

# Per-source extra flags.  -fmad=false keeps nvcc from contracting a*b+c
# into one FMA, so the kernels round every product and sum as the plain
# PyTorch versions (and the JAX reference on the CPU) do; each source
# states the same in its header.
EXTRA_FLAGS = {
    "compact_intersect": ["-fmad=false"],
    "shade": ["-fmad=false"],
    "flush": [],
}

BUILD_SECONDS: dict[str, float] = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, name + ".cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            t0 = time.perf_counter()
            tmp = so + f".{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   *EXTRA_FLAGS.get(name, []), "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
            os.replace(tmp, so)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (None in ``shape`` matches any extent)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
