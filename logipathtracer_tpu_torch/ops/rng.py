"""Counter-style RNG streams (the JAX package's ``ops/rng.py``).

* ``rand_parity`` — the reference's GLSL hash
  (shaders/common/random.glsl:9-15), bit for bit, including its
  degenerate zero streams.
* ``rand_threefry`` — the Threefry-2x32 quality path
  (config.parity_rng=False) over the same state layout.

State: an int64 tensor [..., 2] holding the uvec2 words as values in
[0, 2^32).  All u32 arithmetic runs in int64 and is masked back to 32
bits: 1103515245 * (2^32 - 1) < 2^63, so no product overflows, and
torch's partial uint32 support is avoided.  Every draw returns
(value float32, new_state); masked draws advance only where the mask
is true.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_MUL = 1103515245
# float(0xffffffffu) rounds to 2^32 in f32, so the reference's divide is
# an exact scale by 2^-32 (random.glsl:14).
_INV = 2.0 ** -32
_INV24 = 2.0 ** -24


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), without int64 overflow:
    b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def seed_from_pixel(ubo_seed, pixel_xy, parity: bool = True):
    """Per-pixel stream seed (path_tracing.comp:341): ubo.seed * pixel.xy
    with u32 wraparound for parity; the odd-constant mix otherwise.
    ubo_seed [..., 2] integer, pixel_xy [..., 2] non-negative float or
    integer pixel indices.  Returns int64 [..., 2]."""
    ubo = torch.as_tensor(ubo_seed).to(torch.int64) & M32
    pix = torch.as_tensor(pixel_xy)
    if pix.is_floating_point():
        pix = pix.to(torch.int64)
    pix = pix.to(torch.int64) & M32
    ubo, pix = torch.broadcast_tensors(ubo, pix)
    if parity:
        return _mul32(ubo, pix)
    return torch.stack([
        (ubo[..., 0] + _mul32(pix[..., 0], torch.full_like(
            pix[..., 0], 0x9E3779B9))) & M32,
        (ubo[..., 1] + _mul32(pix[..., 1], torch.full_like(
            pix[..., 1], 0x85EBCA6B))) & M32], dim=-1)


def _parity_hash(sx, sy):
    qx = (_MUL * ((sx >> 1) ^ sy)) & M32
    qy = (_MUL * ((sy >> 1) ^ sx)) & M32
    return (_MUL * (qx ^ (qy >> 3))) & M32


def rand_parity(state):
    """One draw: state [..., 2] → (value [...] f32 in [0, 1], state')."""
    state = (state + 1) & M32
    n = _parity_hash(state[..., 0], state[..., 1])
    # int64 → f32 rounds once to nearest (n < 2^32 is exact in f64 on
    # the way), the same rounding as the u32 → f32 cast in rng.py:70.
    return n.to(torch.float32) * _INV, state


def rand_parity_masked(state, mask):
    value, new_state = rand_parity(state)
    return value, torch.where(mask[..., None], new_state, state)


_TF_KS = (0xCAFEF00D, 0xBAADF00D)
_TF_K0 = 0x1BD11BDA ^ 0xCAFEF00D ^ 0xBAADF00D
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _threefry2x32(c0, c1):
    """20-round Threefry-2x32 with the fixed key of the JAX package."""
    ks0, ks1 = _TF_KS
    ks2 = _TF_K0
    x0 = (c0 + ks0) & M32
    x1 = (c1 + ks1) & M32
    sched = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2), (ks2, ks0))
    for block in range(5):
        for r in _TF_ROT[4 * (block % 2): 4 * (block % 2) + 4]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        ka, kb = sched[block]
        x0 = (x0 + ka) & M32
        x1 = (x1 + kb + block + 1) & M32
    return x0, x1


def rand_threefry(state):
    """One draw: state [..., 2] → (value [...] f32 in [0, 1), state')."""
    state = (state + 1) & M32
    n, _ = _threefry2x32(state[..., 0], state[..., 1])
    return (n >> 8).to(torch.float32) * _INV24, state


def rand_threefry_masked(state, mask):
    value, new_state = rand_threefry(state)
    return value, torch.where(mask[..., None], new_state, state)


def get_rand(parity: bool):
    """Masked-draw function for config.parity_rng."""
    return rand_parity_masked if parity else rand_threefry_masked
