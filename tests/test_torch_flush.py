"""The plain version of kernel K3 (ops/kernels/flush.py) against the JAX
package's scatter twin (render/wavefront.py:302-305,
``accum.at[pixid].add(where(flush, acc, 0))``; the Pallas ``flush_bins``
has no interpreter support).  Both add one pixel's rows in row order,
so the sums agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch.ops.kernels import flush as tflush
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render.wavefront import _flush_unsorted


def _tail(npix, rows, retired, seed):
    r = np.random.default_rng(seed)
    pix = np.sort(r.integers(0, npix, retired)).astype(np.int32)
    pix = np.concatenate([np.full(rows - retired, -1, np.int32), pix])
    acc = (r.random((rows, 3)) * 2).astype(np.float32)
    base = r.random((npix, 3)).astype(np.float32)
    return pix, acc, base


def _jax_scatter(base, pix, acc):
    flush = pix >= 0
    vals = jnp.where(jnp.asarray(flush)[:, None], jnp.asarray(acc), 0.0)
    idx = jnp.asarray(np.where(flush, pix, 0))
    return np.asarray(jnp.asarray(base).at[idx].add(vals))


@pytest.mark.parametrize("npix,rows,retired", [
    (64, 256, 200),       # many repeats per pixel
    (4096, 4096, 1024),   # the usual retire burst
    (1024, 512, 0),       # nothing to flush
])
def test_plain_flush_matches_jax_scatter(npix, rows, retired):
    pix, acc, base = _tail(npix, rows, retired, seed=npix + rows)
    ref = _jax_scatter(base, pix, acc)
    k3 = COUNTS["flush"]
    before = k3.plain_calls
    got = tflush.flush_sorted(torch.from_numpy(base.copy()),
                              torch.from_numpy(pix), torch.from_numpy(acc))
    assert k3.plain_calls == before + 1 and k3.launches == 0
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unsorted_flush_keeps_lane_order():
    """The wavefront's unsorted path (sort_rays=False, the final drain
    flush) sorts retired rows by pixel stably, so each pixel still
    receives its rows in lane order — the scatter's order."""
    r = np.random.default_rng(11)
    p, npix = 512, 40
    pixid = r.integers(0, npix, p).astype(np.int32)
    alive = r.random(p) < 0.4
    pending = alive | (r.random(p) < 0.5)
    acc = r.random((p, 3)).astype(np.float32)
    base = r.random((npix, 3)).astype(np.float32)
    flush = pending & ~alive
    ref = _jax_scatter(base, np.where(flush, pixid, -1), acc)
    st = dict(pixid=torch.from_numpy(pixid), alive=torch.from_numpy(alive),
              pending=torch.from_numpy(pending), acc=torch.from_numpy(acc),
              accum=torch.from_numpy(base.copy()))
    _flush_unsorted(st)
    np.testing.assert_array_equal(st["accum"].numpy(), ref)
    assert not (st["pending"] & ~st["alive"]).any()


def test_flush_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tflush.flush_sorted(torch.zeros((4, 3), device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"),
                            torch.zeros((2, 3), device="meta"))


def test_flush_times_inputs_and_no_card(monkeypatch):
    """tools/kernel_times.py flush: its K3 tail (tools/harness.py) is a
    -1 prefix then ascending pixel ids, and it refuses to run without a
    card."""
    from logipathtracer_tpu_torch.tools import harness, kernel_times
    pix, acc = harness.make_tail(64, 256, 200, "cpu")
    assert (pix[:56] == -1).all() and (pix[56:] >= 0).all()
    assert (pix[56:].diff() >= 0).all() and acc.shape == (256, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_times.main(["flush"])
