"""Camera ray generation (shaders/path_tracing.comp:107-127; the JAX
package's ``ops/camera.py``).

Pinhole camera from the camera node's world matrix columns + vertical
FOV, with a tent-filter sub-pixel jitter (2 rands per ray).  Pixel
coordinates: x = column, y = row counted from the top.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.rng import rand_parity_masked


def _tent(r):
    r = 2.0 * r
    return torch.where(r < 1.0, torch.sqrt(r) - 1.0,
                       1.0 - torch.sqrt(2.0 - r))


def generate_ray(cam_world, fov_y, pixel_xy, resolution, seed, active=None,
                 rand=rand_parity_masked):
    """Tent-jittered primary rays.

    cam_world: [4, 4] float32 tensor (column-vector convention).
    fov_y: vertical field of view (radians; rounded to float32).
    pixel_xy: [..., 2] float32 pixel indices (x=col, y=row).
    resolution: (width, height) python ints.
    seed: [..., 2] int64 RNG state.  Consumes 2 rands on active lanes.

    Returns (origin [..., 3], direction [..., 3], seed').
    """
    if active is None:
        active = torch.ones(pixel_xy.shape[:-1], dtype=torch.bool,
                            device=pixel_xy.device)
    res = torch.tensor(resolution, dtype=torch.float32,
                       device=pixel_xy.device)
    r1, seed = rand(seed, active)
    r2, seed = rand(seed, active)
    jitter = torch.stack([_tent(r1), _tent(r2)], -1) / (res * 0.5)

    uv = 2.0 * pixel_xy / res - 1.0 + jitter
    aspect = res[0] / res[1]
    # tan in f32 on the host, so card and CPU renders share its bits.
    half = torch.as_tensor(fov_y, dtype=torch.float32).cpu() / 2.0
    tan_half = torch.tan(half).to(pixel_xy.device)
    ux = uv[..., 0] * aspect * tan_half
    uy = uv[..., 1] * tan_half

    right = cam_world[:3, 0]
    up = cam_world[:3, 1]
    back = cam_world[:3, 2]
    origin = cam_world[:3, 3].expand(uv.shape[:-1] + (3,))

    d = ux[..., None] * right + uy[..., None] * up - back
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    return origin, d / norm[..., None], seed

