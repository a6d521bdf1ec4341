"""Rendering over a 2-D device mesh (the JAX package's
``parallel/mesh.py``), one controller over a list of torch devices.

  * The mesh is ``(samples, tiles)``: each sample slice renders the same
    pixels with its own host seed, each tile slice a disjoint row slab
    of the frame.  Shards never communicate while they render; the
    sample axis is reduced once, when the image is read.
  * The scene is copied once to each distinct device.
  * Each distinct device gets its own worker thread (a mesh of one
    distinct device renders on the calling thread), which enters
    ``torch.cuda.device`` for its card (the kernels launch on the
    thread's current device); the shards on one device run in turn on
    its thread, in (sample, tile) order.  ``torch.distributed`` is not
    used: the API is one process, as the JAX package's is.

Pixel RNG streams are keyed by absolute pixel coordinates and the
per-sample host seed, so each (sample, tile) shard renders exactly the
pixels a single-device render of that seed and slab gives: sharding
changes wall clock, not radiance.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.render.megakernel import render_rows
from logipathtracer_tpu_torch.render.progressive import (ProgressiveRenderer,
                                                         default_device)
from logipathtracer_tpu_torch.render.wavefront import render_wavefront
from logipathtracer_tpu_torch.utils import trace as tracing


@dataclass(frozen=True)
class DeviceMesh:
    """What ``MeshRenderer`` reads of a mesh, as of a
    ``jax.sharding.Mesh``: ``devices``, a [samples, tiles] object array
    of ``torch.device``, and ``shape``, {"samples": s, "tiles": t}."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        s, t = self.devices.shape
        return {"samples": s, "tiles": t}


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, samples: int | None = None,
              tiles: int | None = None) -> DeviceMesh:
    """Build a (samples, tiles) mesh from ``devices`` (default: every
    CUDA card; without one it raises).  A device may appear more than
    once: its shards then run in turn."""
    if devices is None:
        default_device()                  # raises when there is no card
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if samples is None and tiles is None:
        tiles = 1
        samples = n
    elif samples is None:
        samples = n // tiles
    elif tiles is None:
        tiles = n // samples
    if samples * tiles != n:
        raise ValueError(f"a {samples}x{tiles} mesh needs "
                         f"{samples * tiles} devices, got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(samples, tiles))


class MeshRenderer(ProgressiveRenderer):
    """Progressive accumulation sharded over a 2-D mesh, with the session
    protocol of ProgressiveRenderer (camera dirty/reset, throughput,
    checkpoint/resume).

    ``accum`` is the [S, H, W, 3] sum, held as ``accum[i][j]``, the
    [H / T, W, 3] rows of tile j of sample slice i on that shard's
    device.  Each mesh round renders S more samples, one per sample
    slice.  Every shard renders through ``render_wavefront`` with
    ``renderer`` "wavefront" or "auto", else through the megakernel's
    ``render_rows``."""

    def __init__(self, scene, config: RenderConfig, mesh: DeviceMesh,
                 camera=None, host_seed: int = 0):
        self.mesh = mesh
        t = mesh.shape["tiles"]
        h = config.render_height
        if h % t:
            raise ValueError(f"height {h} not divisible by tile axis {t}")
        self._rows = h // t
        super().__init__(scene, config, camera=camera, host_seed=host_seed,
                         device=mesh.devices[0, 0])
        self._scenes = {self.device: self.scene}
        by_device: dict[torch.device, list] = {}
        for (i, j), d in np.ndenumerate(mesh.devices):
            if d not in self._scenes:
                self._scenes[d] = self.scene.to(d)
            by_device.setdefault(d, []).append((i, j))
        self._by_device = by_device
        # One worker thread per distinct device; with one device the
        # shards run on the calling thread.
        self._pool = (ThreadPoolExecutor(max_workers=len(by_device))
                      if len(by_device) > 1 else None)
        self._wavefront = config.renderer in ("wavefront", "auto")

    def _new_accum(self):
        s, t = self.mesh.shape["samples"], self.mesh.shape["tiles"]
        w, devices = self.config.render_width, self.mesh.devices
        return [[torch.zeros((self._rows, w, 3), device=devices[i, j])
                 for j in range(t)] for i in range(s)]

    def _render_shard(self, i: int, j: int, seeds: np.ndarray,
                      reset: bool):
        """Render sample slice i's seed over tile j's rows on the
        shard's device: (its new accumulator, rays traced)."""
        d = self.mesh.devices[i, j]
        scene, cfg = self._scenes[d], self.config
        tracing.host_sync("upload")
        cam = torch.from_numpy(self.camera_world).to(d)
        tracing.host_sync("upload")
        seed = torch.from_numpy(seeds[i:i + 1]).to(d)
        y0 = j * self._rows
        if self._wavefront:
            img, rays, _ = render_wavefront(
                scene, cfg, cam, self.fov_y, seed,
                pool=min(cfg.pool_size, self._rows * cfg.render_width),
                y0=y0, rows=self._rows, _eager=self._eager)
        else:
            img, rays = render_rows(scene, cfg, cam, self.fov_y, seed[0],
                                    y0, self._rows)
            tracing.host_sync("fold")
            rays = int(rays)
        return (img if reset else self.accum[i][j] + img), rays

    def _render_on(self, d: torch.device, shards, seeds: np.ndarray,
                   reset: bool):
        """Render ``shards`` (a list of (i, j)) in turn on device ``d``
        and wait for the device: nothing is left in flight."""
        ctx = (torch.cuda.device(d) if d.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            out = [self._render_shard(i, j, seeds, reset) for i, j in shards]
            tracing.host_sync("sync")
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return out

    def _round(self, seeds: np.ndarray, reset: bool):
        """One mesh round: every shard's (new accumulator, rays) by
        (i, j)."""
        if self._pool is None:
            (d, shards), = self._by_device.items()
            return dict(zip(shards, self._render_on(d, shards, seeds, reset)))
        futures = {d: self._pool.submit(self._render_on, d, shards, seeds,
                                        reset)
                   for d, shards in self._by_device.items()}
        out = {}
        for d, shards in self._by_device.items():
            out.update(zip(shards, futures[d].result()))
        return out

    def step(self, samples: int | None = None):
        """Render at least ``samples`` more samples (default: one mesh
        round = S samples, the sample-axis width)."""
        return self._step(samples, sync=True)

    def _step(self, samples: int | None, sync: bool):
        # Each round waits for its devices, so ``step_nosync`` is
        # ``step``.
        s = self.mesh.shape["samples"]
        rounds = 1 if samples is None else -(-samples // s)
        for _ in range(rounds):
            if self._dirty:
                self._reset_counts()  # src/RendererPT.cpp:575-581
            seeds = self._host_rng.integers(1, 2 ** 31, (s, 2),
                                            dtype=np.int64)
            t0 = time.perf_counter()
            shards = self._round(seeds, self._dirty or self.sample_count == 0)
            rays = 0
            for (i, j), (acc, n) in shards.items():
                self.accum[i][j] = acc
                rays += n
            self._elapsed += time.perf_counter() - t0
            self.sample_count += s
            self._session_samples += s
            self.total_rays += rays
            self._session_rays += rays
            self._dirty = False
        return self

    def _frame_sum(self) -> torch.Tensor:
        """The sum over sample slices, in index order, on the mesh's
        first device, tiles concatenated: [H, W, 3]."""
        tiles = []
        for j in range(self.mesh.shape["tiles"]):
            acc = self.accum[0][j].to(self.device)
            for row in self.accum[1:]:
                acc = acc + row[j].to(self.device)
            tiles.append(acc)
        return torch.cat(tiles, 0)

    def _load_accum(self, accum: np.ndarray):
        """A checkpoint holds the sample-axis sum: it goes to sample
        slice 0, zeros elsewhere, so it restores on any mesh shape."""
        for j in range(self.mesh.shape["tiles"]):
            rows = accum[j * self._rows:(j + 1) * self._rows]
            for i, row in enumerate(self.accum):
                row[j] = (torch.from_numpy(rows) if i == 0
                          else torch.zeros(rows.shape)).to(
                              self.mesh.devices[i, j])
