"""Radiance flush: add retired paths' radiance into the accumulator by
pixel id (kernel K3, csrc/flush.cu).

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/flush.py::
flush_bins`` (``_flush_kernel`` with its ``flush_bin_segments``
prepass).  Its contract: ``pix`` is ascending with a -1 prefix for rows
to skip (the wavefront sorts retired lanes to the pool tail keyed by
pixel id), and every retired row's radiance is added into
``accum[pix]``.

On the card: the thread at the start of each run of equal pixel ids
adds the run's rows in order into its pixel; each thread takes four
rows a grid's width apart and issues all its loads before it adds
(csrc/flush.cu), so the -1 prefix costs its pixel ids and no threads
of its own.  No atomics, so a repeat run is bit-identical
(checkpoint/restore stays exact), and the sum order is the one of the
JAX package's scatter twin (``wavefront.py:302-305``): accum + a0 +
a1 + ...  Bound: bytes — 4 B of pixel id per row, 12 B of radiance per
retired row, 24 B per flushed pixel; ~13 MB for 2^18 retired of 2^20
rows, a few microseconds of HBM bandwidth.  The wrapper's host time
(checks, the C call bound once by ``_build.launch``) is of the same
order.

``accum`` is updated in place (the JAX version donates its buffer).
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.kernels import _build

SOURCE = "logipathtracer_tpu_torch/csrc/flush.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/flush.py:144"


def flush_sorted_plain(accum, pix, acc):
    """Plain PyTorch version: rows of rank k within their pixel's run
    are added in pass k, so each pixel receives its rows in order."""
    _build.plain("flush")
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
    if accum.device.type == "cpu":
        return flush_sorted_plain(accum, pix, acc)
    if accum.device.type != "cuda":
        raise ValueError(f"flush_sorted: unsupported device {accum.device}")
    dev = accum.device
    p = pix.shape[0]
    _build.require(accum, "accum", torch.float32, (None, 3), dev)
    _build.require(pix, "pix", torch.int32, (p,), dev)
    _build.require(acc, "acc", torch.float32, (p, 3), dev)
    if p:
        _build.launch("flush", "lpt_flush_sorted", accum, pix, acc, p,
                      accum.shape[0], _build.stream_ptr(dev))
        _build.launched("flush")
    return accum
