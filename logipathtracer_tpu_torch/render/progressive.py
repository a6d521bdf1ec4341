"""Progressive render session (the JAX package's
``render/progressive.py``): accumulation state, the camera-dirty reset
protocol (src/RendererPT.cpp:575-581), per-sample host seeds (:584-585),
sample counting and throughput, and checkpoint/resume in the same
``.npz`` format — a checkpoint written by the JAX package restores here.

Rendering goes through the pooled wavefront (render/wavefront.py) with
the pool carried over between ``step()`` calls; reads drain it first.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.film.image import tonemap
from logipathtracer_tpu_torch.render.megakernel import (pick_intersect,
                                                        resolve_shade_mode)
from logipathtracer_tpu_torch.render.wavefront import (pix_layout,
                                                       unblock_accum,
                                                       wavefront_chunk,
                                                       wavefront_drain,
                                                       wavefront_pool_state)
from logipathtracer_tpu_torch.scene.types import CameraState, SceneSoA

log = logging.getLogger("logipathtracer_tpu_torch.progressive")


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
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class ProgressiveRenderer:
    """Accumulating progressive renderer with the reference's
    accumulate/reset protocol.

    ``scene``: this package's SceneSoA (host or device) or any object
    with the SoA attributes (e.g. the JAX package's compiled scene).
    ``device``: where to render (default: the first CUDA card, else the
    CPU).  One device: multi-device rendering is a ROADMAP item."""

    def __init__(self, scene, config: RenderConfig,
                 camera: CameraState | None = None, host_seed: int = 0,
                 device=None):
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise NotImplementedError(
                    "rendering across more than one device is not ported "
                    "(ROADMAP Queue 1: multi-device)")
            device = device[0]
        self.device = torch.device(device) if device is not None \
            else default_device()
        if config.renderer not in ("auto", "wavefront"):
            raise NotImplementedError(
                f"renderer={config.renderer!r}: the megakernel renderer is "
                "not ported (ROADMAP Queue 1: megakernel and BVH walk)")
        if not isinstance(scene, SceneSoA):
            scene = SceneSoA.from_numpy(scene)
        if camera is None:
            if not scene.cameras:
                raise ValueError("scene has no camera; pass camera= "
                                 "explicitly (src/RendererRTX.cpp:53-55)")
            camera = scene.cameras[0]
        # What the slice does not cover fails here, before any work.
        resolve_shade_mode(config, scene)
        pick_intersect(config, scene)
        # Commit the scene to the device once.
        self.scene = scene.to(self.device)
        self.config = config
        self.camera_world = np.asarray(camera.world_matrix,
                                       np.float32).copy()
        self.fov_y = float(camera.yfov)
        self._host_rng = np.random.default_rng(host_seed)
        h, w = config.render_height, config.render_width
        self.accum = torch.zeros((h, w, 3), dtype=torch.float32,
                                 device=self.device)
        self.sample_count = 0
        self.total_rays = 0.0
        self.last_iterations = 0
        self._dirty = True
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0
        self._wf_state = None
        self._wf_rays_base = 0.0

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fold_rays(self, st):
        rays_now = self._wf_rays_base + float(st["rays"])
        self._session_rays += rays_now - self.total_rays
        self.total_rays = rays_now
        self.last_iterations = int(st["it"])

    def _step(self, samples: int, sync: bool):
        cfg = self.config
        if self._dirty:
            self.sample_count = 0
            self.total_rays = 0.0
            self._session_samples = 0
            self._session_rays = 0.0
            self._elapsed = 0.0
            self.accum = torch.zeros_like(self.accum)
            self._wf_state = None
        seeds = torch.from_numpy(self._host_rng.integers(
            1, 2 ** 31, (samples, 2), dtype=np.int64)).to(self.device)
        cam = torch.from_numpy(self.camera_world).to(self.device)
        npix = cfg.render_width * cfg.render_height
        pool = min(cfg.pool_size, npix)
        t0 = time.perf_counter()
        if self._wf_state is None:
            self._wf_state = wavefront_pool_state(pool, npix, self.device)
            self._wf_rays_base = self.total_rays
        self._wf_state = wavefront_chunk(self.scene, cfg, cam, self.fov_y,
                                         seeds, self._wf_state)
        self._fold_rays(self._wf_state)
        if not cfg.pool_carryover:
            # Single-shot semantics: finish every path of this chunk.
            self._drain_pool(timed=False)
        if sync:
            self._sync()
        self._elapsed += time.perf_counter() - t0
        self.sample_count += samples
        self._session_samples += samples
        self._dirty = False
        if self.sample_count % 10 < samples:
            log.info("samples: %d  samples/s: %.3f  Mrays/s: %.2f",
                     self.sample_count, self.samples_per_sec(),
                     self.mrays_per_sec())
        return self

    def _drain_pool(self, timed: bool = True):
        """Complete all in-flight paths and fold the pool's block-major
        accumulator into ``self.accum``."""
        if self._wf_state is None:
            return
        t0 = time.perf_counter()
        st = wavefront_drain(self.scene, self.config, self._wf_state)
        h, w = self.config.render_height, self.config.render_width
        blocked, bh, bw = pix_layout(self.config, self.scene, h, w)
        self.accum = self.accum + unblock_accum(st["accum"], blocked, bh,
                                                bw, h, w)
        st["accum"].zero_()
        self._fold_rays(st)
        self._wf_state = st
        if timed:
            self._sync()
            self._elapsed += time.perf_counter() - t0

    def samples_per_sec(self) -> float:
        return self._session_samples / max(self._elapsed, 1e-9)

    def mrays_per_sec(self) -> float:
        return self._session_rays / max(self._elapsed, 1e-9) / 1e6

    # -- output ---------------------------------------------------------

    def image(self) -> torch.Tensor:
        """Tonemapped display image [H, W, 3] (tex_to_quad.frag); with
        render_scale > 1 the supersampled buffer is box-filtered first."""
        self._drain_pool()
        accum = self.accum
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
        self._drain_pool()
        return self.accum.cpu().numpy() / max(self.sample_count, 1)

    # -- checkpoint / resume ---------------------------------------------

    @staticmethod
    def checkpoint_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def checkpoint(self, path: str):
        path = self.checkpoint_path(path)
        self._drain_pool()
        st = self._host_rng.bit_generator.state["state"]
        np.savez(path, accum=self.accum.cpu().numpy(),
                 sample_count=self.sample_count,
                 total_rays=self.total_rays,
                 camera_world=self.camera_world, fov_y=self.fov_y,
                 # PCG64 state words are 128-bit ints: store as strings.
                 rng_state=np.str_(str(st["state"])),
                 rng_inc=np.str_(str(st["inc"])))

    def restore(self, path: str):
        data = np.load(self.checkpoint_path(path))
        self.accum = torch.from_numpy(
            np.asarray(data["accum"], np.float32)).to(self.device)
        self.sample_count = int(data["sample_count"])
        self.total_rays = float(data["total_rays"])
        self.camera_world = data["camera_world"].astype(np.float32)
        self.fov_y = float(data["fov_y"])
        st = self._host_rng.bit_generator.state
        st["state"]["state"] = int(str(data["rng_state"]))
        st["state"]["inc"] = int(str(data["rng_inc"]))
        self._host_rng.bit_generator.state = st
        self._wf_state = None
        self._dirty = False
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0
        return self
