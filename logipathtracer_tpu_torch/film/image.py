"""Film / display transform (shaders/tex_to_quad.frag:21-33; the JAX
package's ``film/image.py``)."""

from __future__ import annotations

import numpy as np
import torch


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


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB EOTF (shaders/common/util.glsl:4-16)."""
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def rmse(a, b) -> float:
    """Per-pixel RMSE between two images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
