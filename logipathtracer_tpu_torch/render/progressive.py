"""Progressive render session (the JAX package's
``render/progressive.py``): accumulation state, the camera-dirty reset
protocol (src/RendererPT.cpp:575-581), per-sample host seeds (:584-585),
sample counting and throughput, and checkpoint/resume in the same
``.npz`` format — a checkpoint written by the JAX package restores here.

Rendering goes through the pooled wavefront (render/wavefront.py) with
the pool carried over between ``step()`` calls — reads drain it first;
with ``pool_carryover=False`` each ``step()`` is one ``render_wavefront``
— or, with ``renderer="megakernel"``, through one ``accumulate_sample``
(render/megakernel.py) per sample, with nothing left in flight.  On a
CUDA card the wavefront's iterations replay captured stages
(render/graph.py): a camera move empties the pool in place, so its
stages are captured once per session.
``renderer="auto"`` is the wavefront (the JAX package takes it on a TPU
only).  Several devices: ``parallel/mesh.py`` ``MeshRenderer``.

The session counts its host syncs and marks its step, drain and image
as spans in utils/trace.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.film.image import tonemap
from logipathtracer_tpu_torch.render.megakernel import (accumulate_sample,
                                                        pick_intersect)
from logipathtracer_tpu_torch.render.wavefront import (pix_layout,
                                                       render_wavefront,
                                                       reset_pool_state,
                                                       unblock_accum,
                                                       wavefront_chunk,
                                                       wavefront_drain,
                                                       wavefront_pool_state)
from logipathtracer_tpu_torch.scene.types import CameraState, SceneSoA
from logipathtracer_tpu_torch.utils import trace as tracing


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    if axis == 1:
        m[i, j] = s
        m[j, i] = -s
    else:
        m[i, j] = -s
        m[j, i] = s
    return m


def default_device() -> torch.device:
    """The first CUDA card.  Without one it raises: rendering on the CPU
    is the caller's choice (``device="cpu"``), never a quiet fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found: the renderer runs on the card; pass "
            'device="cpu" to render on the CPU')
    return torch.device("cuda")


class ProgressiveRenderer:
    """Accumulating progressive renderer with the reference's
    accumulate/reset protocol.

    ``scene``: this package's SceneSoA (host or device) or any object
    with the SoA attributes (e.g. the JAX package's compiled scene).
    ``device``: where to render (default: the first CUDA card; without
    one the constructor raises).  One device: ``MeshRenderer`` renders
    across several.  ``accumulate_fn`` replaces the megakernel's
    ``accumulate_sample`` (same arguments and results), as in the JAX
    package."""

    def __init__(self, scene, config: RenderConfig,
                 camera: CameraState | None = None, host_seed: int = 0,
                 device=None, accumulate_fn=None):
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise NotImplementedError(
                    "ProgressiveRenderer renders on one device; for "
                    "multi-device rendering use MeshRenderer "
                    "(logipathtracer_tpu_torch.parallel.mesh)")
            device = device[0]
        self.device = torch.device(device) if device is not None \
            else default_device()
        if config.renderer not in ("auto", "wavefront", "megakernel"):
            raise ValueError(f"unknown renderer {config.renderer!r}")
        if not isinstance(scene, SceneSoA):
            scene = SceneSoA.from_numpy(scene)
        if camera is None:
            if not scene.cameras:
                raise ValueError("scene has no camera; pass camera= "
                                 "explicitly (src/RendererRTX.cpp:53-55)")
            camera = scene.cameras[0]
        # An unknown intersect mode fails here, before any work.
        pick_intersect(config, scene)
        # Commit the scene to the device once.
        self.scene = scene.to(self.device)
        self.config = config
        self._accumulate = accumulate_fn or accumulate_sample
        self.camera_world = np.asarray(camera.world_matrix,
                                       np.float32).copy()
        self.fov_y = float(camera.yfov)
        self._host_rng = np.random.default_rng(host_seed)
        self.accum = self._new_accum()
        self.sample_count = 0
        self.total_rays = 0.0
        self.last_iterations = 0
        self._dirty = True
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0
        self._wf_state = None
        self._wf_rays_base = 0.0
        # The wavefront loop's eager form on the card, for comparisons
        # with the captured stages (render/graph.py); internal.
        self._eager = False

    def _new_accum(self):
        h, w = self.config.render_height, self.config.render_width
        return torch.zeros((h, w, 3), dtype=torch.float32,
                           device=self.device)

    # -- camera (src/Main.cpp:57-93 semantics) -------------------------

    def reset(self):
        """Restart accumulation on the next step."""
        self._dirty = True

    def set_camera(self, world_matrix, fov_y: float | None = None):
        self.camera_world = np.asarray(world_matrix, np.float32).copy()
        if fov_y is not None:
            self.fov_y = float(fov_y)
        self._dirty = True

    def translate(self, axis: int, amount: float):
        """Translate along a local camera axis (lsg translateX/Y/Z)."""
        delta = np.zeros(3, np.float32)
        delta[axis] = amount
        self.camera_world[:3, 3] += self.camera_world[:3, :3] @ delta
        self._dirty = True

    def rotate(self, axis: int, angle: float):
        """Rotate about a local camera axis (lsg rotateX/Y/Z)."""
        self.camera_world = (self.camera_world @ _rot(axis, angle)).astype(
            np.float32)
        self._dirty = True

    # -- progressive stepping ------------------------------------------

    def step(self, samples: int = 1):
        """Render ``samples`` more samples into the accumulator."""
        return self._step(samples, sync=True)

    def step_nosync(self, samples: int = 1):
        """step() without the closing device synchronize: identical
        rendering, and the chunk's last kernels may still run when it
        returns (its time then covers dispatch only)."""
        return self._step(samples, sync=False)

    def _sync(self):
        tracing.host_sync("sync")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the renderer's device: a copy from pageable memory,
        which waits for the device's stream."""
        tracing.host_sync("upload")
        return torch.from_numpy(a).to(self.device)

    def _fold_rays(self, st):
        tracing.host_sync("fold")
        rays_now = self._wf_rays_base + float(st["rays"])
        self._session_rays += rays_now - self.total_rays
        self.total_rays = rays_now
        self.last_iterations = st["host_it"]

    def _reset_counts(self):
        """The reset protocol (src/RendererPT.cpp:575-581)."""
        self.sample_count = 0
        self.total_rays = 0.0
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0

    def _step(self, samples: int, sync: bool):
        with tracing.span("step"):
            cam = self._upload(self.camera_world)
            if self.config.renderer == "megakernel":
                self._step_megakernel(samples, cam, sync)
            else:
                self._step_wavefront(samples, cam, sync)
        return self

    def _step_megakernel(self, samples: int, cam, sync: bool):
        """One ``accumulate_sample`` per sample, each with its own host
        seed pair (integers(1, 2**31, 2), as the JAX package draws them);
        the first after a reset replaces the accumulator.  The ray counts
        stay on the device until the one host read at the end."""
        rays = torch.zeros((), dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        for _ in range(samples):
            if self._dirty:
                self._reset_counts()
            seed = self._upload(self._host_rng.integers(
                1, 2 ** 31, 2, dtype=np.int64))
            self.accum, n = self._accumulate(self.scene, self.config, cam,
                                             self.fov_y, seed, self.accum,
                                             self._dirty)
            rays += n
            self.sample_count += 1
            self._session_samples += 1
            self._dirty = False
        if sync:
            self._sync()
        self._elapsed += time.perf_counter() - t0
        tracing.host_sync("fold")
        n = float(rays)
        self.total_rays += n
        self._session_rays += n

    def _step_wavefront(self, samples: int, cam, sync: bool):
        cfg = self.config
        if self._dirty:
            self._reset_counts()
            self.accum = torch.zeros_like(self.accum)
            if self._wf_state is not None:
                # In place: the pool's captured stages stay valid.
                reset_pool_state(self._wf_state)
                self._wf_rays_base = self.total_rays
        seeds = self._upload(self._host_rng.integers(
            1, 2 ** 31, (samples, 2), dtype=np.int64))
        npix = cfg.render_width * cfg.render_height
        pool = min(cfg.pool_size, npix)
        t0 = time.perf_counter()
        if not cfg.pool_carryover:
            # Single shot: every path of this batch ends in this call.
            batch, rays, self.last_iterations = render_wavefront(
                self.scene, cfg, cam, self.fov_y, seeds, pool=pool,
                _eager=self._eager)
            self.accum = self.accum + batch
            self.total_rays += rays
            self._session_rays += rays
        else:
            if self._wf_state is None:
                self._wf_state = wavefront_pool_state(pool, npix,
                                                      self.device)
                self._wf_rays_base = self.total_rays
            self._wf_state = wavefront_chunk(self.scene, cfg, cam,
                                             self.fov_y, seeds,
                                             self._wf_state,
                                             _eager=self._eager)
            self._fold_rays(self._wf_state)
        if sync:
            self._sync()
        self._elapsed += time.perf_counter() - t0
        self.sample_count += samples
        self._session_samples += samples
        self._dirty = False

    def _drain_pool(self):
        """Complete all in-flight paths and fold the pool's block-major
        accumulator into ``self.accum``."""
        if self._wf_state is None:
            return
        t0 = time.perf_counter()
        with tracing.span("drain"):
            st = wavefront_drain(self.scene, self.config, self._wf_state,
                                 _eager=self._eager)
            h, w = self.config.render_height, self.config.render_width
            blocked, bh, bw = pix_layout(self.config, self.scene, h, w)
            self.accum = self.accum + unblock_accum(st["accum"], blocked,
                                                    bh, bw, h, w)
            st["accum"].zero_()
            self._fold_rays(st)
            self._wf_state = st
            self._sync()
        self._elapsed += time.perf_counter() - t0

    def _drop_pool(self):
        """Discard the carried-over pool and the stages captured for
        it."""
        if self._wf_state is not None and self.device.type == "cuda":
            from logipathtracer_tpu_torch.render.graph import graph_cache
            graph_cache(self.scene).drop(self._wf_state)
        self._wf_state = None

    def _frame_sum(self) -> torch.Tensor:
        """The radiance sum [H, W, 3] of every sample stepped so far."""
        self._drain_pool()
        return self.accum

    def _load_accum(self, accum: np.ndarray):
        self.accum = self._upload(accum)

    def samples_per_sec(self) -> float:
        return self._session_samples / max(self._elapsed, 1e-9)

    def mrays_per_sec(self) -> float:
        return self._session_rays / max(self._elapsed, 1e-9) / 1e6

    # -- output ---------------------------------------------------------

    def image(self) -> torch.Tensor:
        """Tonemapped display image [H, W, 3] (tex_to_quad.frag); with
        render_scale > 1 the supersampled buffer is box-filtered first."""
        with tracing.span("image"):
            accum = self._frame_sum()
            s = self.config.render_scale
            if s > 1:
                h, w = self.config.height, self.config.width
                accum = accum.reshape(h, s, w, s, 3).mean(dim=(1, 3))
            return tonemap(accum, max(self.sample_count, 1),
                           exposure=self.config.exposure,
                           gamma=self.config.gamma)

    def image_u8(self) -> torch.Tensor:
        """Display frame as device-side uint8 RGBA [H, W, 4]."""
        img = self.image()
        u8 = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
        alpha = torch.full(u8.shape[:2] + (1,), 255, dtype=torch.uint8,
                           device=u8.device)
        return torch.cat([u8, alpha], dim=-1)

    def radiance(self) -> np.ndarray:
        """Mean radiance (pre-tonemap; the RMSE-metric quantity)."""
        accum = self._frame_sum()
        tracing.host_sync("radiance")
        return accum.cpu().numpy() / max(self.sample_count, 1)

    # -- checkpoint / resume ---------------------------------------------

    @staticmethod
    def checkpoint_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def checkpoint(self, path: str):
        path = self.checkpoint_path(path)
        accum = self._frame_sum()                  # drains the pool first
        tracing.host_sync("radiance")
        accum = accum.cpu().numpy()
        st = self._host_rng.bit_generator.state["state"]
        np.savez(path, accum=accum,
                 sample_count=self.sample_count,
                 total_rays=self.total_rays,
                 camera_world=self.camera_world, fov_y=self.fov_y,
                 # PCG64 state words are 128-bit ints: store as strings.
                 rng_state=np.str_(str(st["state"])),
                 rng_inc=np.str_(str(st["inc"])))

    def restore(self, path: str):
        data = np.load(self.checkpoint_path(path))
        self._load_accum(np.asarray(data["accum"], np.float32))
        self.sample_count = int(data["sample_count"])
        self.total_rays = float(data["total_rays"])
        self.camera_world = data["camera_world"].astype(np.float32)
        self.fov_y = float(data["fov_y"])
        st = self._host_rng.bit_generator.state
        st["state"]["state"] = int(str(data["rng_state"]))
        st["state"]["inc"] = int(str(data["rng_inc"]))
        self._host_rng.bit_generator.state = st
        self._drop_pool()
        self._dirty = False
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0
        return self
