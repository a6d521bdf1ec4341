"""Film / display transform (shaders/tex_to_quad.frag:21-33; the JAX
package's ``film/image.py``)."""

from __future__ import annotations

import numpy as np
import torch

from logipathtracer_tpu_torch.utils import trace as tracing


def tonemap(accum: torch.Tensor, sample_count: float,
            exposure: float = 1.5, gamma: float = 2.2,
            flip: bool = True) -> torch.Tensor:
    """accum [H, W, 3] radiance sums → [H, W, 3] float32 in [0, 1]."""
    hdr = accum * (1.0 / sample_count)
    mapped = 1.0 - torch.exp(-hdr * exposure)
    mapped = torch.pow(torch.clamp(mapped, min=0.0), 1.0 / gamma)
    if flip:
        mapped = torch.flip(mapped, dims=(0,))
    return mapped


def to_uint8(img) -> np.ndarray:
    """[..., C] float image in [0, 1] (a numpy array or a tensor on any
    device) -> uint8 numpy array, rounded half up and clipped."""
    if isinstance(img, torch.Tensor):
        tracing.host_sync("frame")
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB EOTF (shaders/common/util.glsl:4-16)."""
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB OETF, the inverse of ``srgb_to_linear``."""
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp(c, min=1e-12), 1 / 2.4)
                       - 0.055)


def rmse(a, b) -> float:
    """Per-pixel RMSE between two images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
