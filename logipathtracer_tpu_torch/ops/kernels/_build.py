"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, at first use, into the package's git-ignored
``build/kernels`` directory, and loads with ``ctypes``.  A library is
rebuilt when its source is newer.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
raises on a non-zero code.

The launch counts live here too (``COUNTS``, one entry a kernel): its
wrapper counts a launch (``launched``) or a call of its plain version
(``plain``).  ``recording`` and ``add`` let a
CUDA graph's capture and its replays (render/graph.py) count as the
eager calls do.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

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
    "stream_cluster": ["-fmad=false"],
    "stream_chunk": ["-fmad=false"],
    "cluster_sweep": ["-fmad=false"],
    "shade": ["-fmad=false"],
    "tex_prologue": ["-fmad=false"],
    "flush": [],
    "trace": [],
}

BUILD_SECONDS: dict[str, float] = {}

_LOCK = threading.Lock()
# Guards the launch counts (``COUNTS``), which the mesh's worker threads
# (one per device) update at once.  Re-entrant: a graph capture
# (render/graph.py) holds it while the wrappers it runs take it.
COUNT_LOCK = threading.RLock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
# (source name, entry point) -> the bound C function.
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _source_mtime(src: str) -> float:
    """The newest of the source and the shared headers it may include."""
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
               if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in [src, *headers])


def nvcc_command(name: str, out: str, *extra: str) -> list[str]:
    """The nvcc command that builds csrc/<name>.cu into ``out``."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            *EXTRA_FLAGS.get(name, []), *extra, "-o", out,
            os.path.join(CSRC, name + ".cu")]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, name + ".cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        if (not os.path.exists(so)
                or os.path.getmtime(so) < _source_mtime(src)):
            t0 = time.perf_counter()
            tmp = so + f".{os.getpid()}.tmp"
            res = subprocess.run(nvcc_command(name, tmp),
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
            os.replace(tmp, so)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib


def load_all(names) -> list:
    """Build and load several sources at once: one nvcc per source, all
    started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        return list(ex.map(load, names))


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _ctype(a, fn: str):
    if isinstance(a, torch.Tensor) or a is None or isinstance(
            a, ctypes.c_void_p):
        return ctypes.c_void_p
    if isinstance(a, (bool, int)):
        return ctypes.c_int
    if isinstance(a, float):
        return ctypes.c_float
    raise TypeError(f"{fn}: argument of type {type(a).__name__}")


def launch(name: str, fn: str, *args):
    """Call the C entry point ``fn`` of csrc/<name>.cu: tensors pass as
    device pointers, None as a null pointer, bools and ints as ``int``,
    floats as ``float`` and a ``c_void_p`` (the stream) as it is.  The
    entry point's argument types are bound at its first call, from that
    call's arguments, and kept (``_ENTRIES``): later calls pass the same
    kinds.  Raises on a non-zero return."""
    f = _ENTRIES.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = [_ctype(a, fn) for a in args]
        f.restype = ctypes.c_int
        _ENTRIES[(name, fn)] = f
    check(f(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]), fn)


def stream_ptr(device) -> ctypes.c_void_p:
    """The handle of ``device``'s current CUDA stream, through torch's raw
    accessor (as Triton's launchers read it): a fraction of a
    microsecond, where ``torch.cuda.current_stream(device)`` builds a
    Stream object in several."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def require(t, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (None in ``shape`` matches any extent).  A shape given
    in full takes one fused test, a few hundred nanoseconds: the
    wrappers call this for every input of every launch."""
    if (t.dtype is dtype and t.shape == shape and t.is_contiguous()
            and t.device == device):
        return
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


class Counts:
    """One entry of ``COUNTS``: a kernel's ``launches``, its plain
    version's calls (``plain_calls``) and its launches by mode
    (``modes``).  ``kernel`` is False for a route with no kernel (plain
    torch on every device): its calls count as plain calls, and they are
    no fallback."""

    def __init__(self, kernel: bool = True):
        self.kernel = kernel
        self.launches = 0
        self.plain_calls = 0
        self.modes = collections.Counter()


# Every hand-written kernel's counts by name, whatever has been
# imported; a wrapper counts only under a name listed here.  Modes:
# compact_intersect (K1), stream_cluster (K4), worklist_chunk (K5) and
# compact_order (K7) "closest" / "tmax" / "any_hit"; octant_chunk (K6)
# those after "cap0/" or "cap/"; dense_sweep (K8) "closest" / "tmax";
# shade (K2) "base" / "tex" / "nee" / "tex+nee".  shade_basic is the
# basic BSDF's route, plain torch on every device.
COUNTS: dict[str, Counts] = {name: Counts() for name in (
    "compact_intersect", "worklist_prepass", "shade", "flush",
    "stream_cluster", "worklist_chunk", "octant_chunk", "compact_order",
    "dense_sweep", "tex_prologue")}
COUNTS["shade_basic"] = Counts(kernel=False)


def launched(name: str, mode: str | None = None):
    """Count one launch of kernel ``name``, in ``mode`` if given."""
    with COUNT_LOCK:
        c = COUNTS[name]
        c.launches += 1
        if mode is not None:
            c.modes[mode] += 1


def plain(name: str):
    """Count one call of ``name``'s plain version."""
    with COUNT_LOCK:
        COUNTS[name].plain_calls += 1


def reset():
    """Zero every count."""
    with COUNT_LOCK:
        for c in COUNTS.values():
            c.launches = c.plain_calls = 0
            c.modes.clear()


def _values() -> dict:
    return {name: (c.launches, c.plain_calls, collections.Counter(c.modes))
            for name, c in COUNTS.items()}


@contextlib.contextmanager
def recording():
    """Record what the counts gain inside the block and put them back
    after it.  Yields a dict that, once the block ends, holds the gains
    as name -> (launches, plain calls, modes), for ``add``.  Holds
    COUNT_LOCK through the block, so no other thread's counts mix in."""
    delta = {}
    with COUNT_LOCK:
        before = _values()
        try:
            yield delta
        finally:
            for name, c in COUNTS.items():
                n, p, m = before.get(name, (0, 0, collections.Counter()))
                gain = (c.launches - n, c.plain_calls - p, c.modes - m)
                if any(gain):
                    delta[name] = gain
                c.launches, c.plain_calls = n, p
                c.modes.clear()
                c.modes.update(m)


def add(delta: dict):
    """Add a delta of ``recording`` to the counts."""
    with COUNT_LOCK:
        for name, (n, p, m) in delta.items():
            c = COUNTS[name]
            c.launches += n
            c.plain_calls += p
            c.modes.update(m)
