"""Radiance flush: add retired paths' radiance into the accumulator by
pixel id (kernel K3, csrc/flush.cu).

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/flush.py::
flush_bins`` (``_flush_kernel`` with its ``flush_bin_segments``
prepass).  Its contract: ``pix`` is ascending with a -1 prefix for rows
to skip (the wavefront sorts retired lanes to the pool tail keyed by
pixel id), and every retired row's radiance is added into
``accum[pix]``.

On the card: one thread per row; the thread at the start of each run of
equal pixel ids adds the run's rows in order into its pixel.  No
atomics, so a repeat run is bit-identical (checkpoint/restore stays
exact), and the sum order is the one of the JAX package's scatter
twin (``wavefront.py:302-305``): accum + a0 + a1 + ...
Bound: bytes — 16 B per pool row read plus 24 B per flushed pixel;
a 2^20-row pool is ~17 MB, a few microseconds of HBM bandwidth.  The
design spends no effort on that; the launch costs more than the bytes.

``accum`` is updated in place (the JAX version donates its buffer).
"""

from __future__ import annotations

import ctypes

import torch

from logipathtracer_tpu_torch.ops.kernels import _build

# Launch counter of the CUDA kernel and call counter of the plain
# version (the main path must run the first and never the second).
launches = 0
plain_calls = 0

SOURCE = "logipathtracer_tpu_torch/csrc/flush.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/flush.py:144"


def flush_sorted_plain(accum, pix, acc):
    """Plain PyTorch version: rows of rank k within their pixel's run
    are added in pass k, so each pixel receives its rows in order."""
    global plain_calls
    plain_calls += 1
    n = pix.shape[0]
    if n == 0:
        return accum
    idx = torch.arange(n, device=pix.device)
    valid = pix >= 0
    start = torch.ones(n, dtype=torch.bool, device=pix.device)
    start[1:] = pix[1:] != pix[:-1]
    run0 = torch.cummax(torch.where(start, idx, 0), 0).values
    rank = idx - run0
    rank = torch.where(valid, rank, -1)
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        p = pix[sel].long()
        accum[p] = accum[p] + acc[sel]
    return accum


def flush_sorted(accum, pix, acc):
    """accum [npix, 3] f32 += per-pixel runs of acc [P, 3] f32 keyed by
    pix [P] i32 (ascending, -1 = skip).  In place; returns accum.  A
    CPU tensor takes the plain version, a CUDA tensor the kernel."""
    global launches
    if accum.device.type == "cpu":
        return flush_sorted_plain(accum, pix, acc)
    if accum.device.type != "cuda":
        raise ValueError(f"flush_sorted: unsupported device {accum.device}")
    dev = accum.device
    p = pix.shape[0]
    _build.require(accum, "accum", torch.float32, (None, 3), dev)
    _build.require(pix, "pix", torch.int32, (p,), dev)
    _build.require(acc, "acc", torch.float32, (p, 3), dev)
    lib = _build.load("flush")
    fn = lib.lpt_flush_sorted
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if p:
        _build.check(fn(_build.ptr(accum), _build.ptr(pix), _build.ptr(acc),
                        p, accum.shape[0], _build.stream_ptr(dev)),
                     "flush kernel")
        launches += 1
    return accum
