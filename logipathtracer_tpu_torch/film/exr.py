"""Minimal OpenEXR writer: uncompressed float32 scanlines (the JAX
package's ``film/exr.py``, byte for byte the same file).

HDR radiance output of ``render --exr``.  Write-only; readable by
OpenEXR, oiio and tev."""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 0x01312F76


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<I", len(data)) + data


def encode_exr(img) -> bytes:
    """img: [H, W, 3] float32 linear radiance -> EXR bytes."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"encode_exr: {c} channels, expected 3")
    # Channel list, alphabetical (B, G, R), each FLOAT (type 2).
    chan = b"".join(name + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
                    for name in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join((
        _attr(b"channels", b"chlist", chan),
        _attr(b"compression", b"compression", b"\0"),      # none
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\0"),          # increasing y
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\0"))
    head = struct.pack("<II", _MAGIC, 2) + header
    # Scanline offset table, then per scanline: y, byte count, and the
    # B, G, R planes.
    line_size = 8 + w * 4 * 3
    data_off = len(head) + 8 * h
    offsets = b"".join(struct.pack("<Q", data_off + y * line_size)
                       for y in range(h))
    planes = img[:, :, ::-1].transpose(0, 2, 1)            # [H, 3, W]
    prefix = np.zeros((h, 2), "<i4")
    prefix[:, 0] = np.arange(h)
    prefix[:, 1] = w * 4 * 3
    body = np.concatenate([prefix.view(np.uint8).reshape(h, 8),
                           np.ascontiguousarray(planes, "<f4").view(np.uint8)
                           .reshape(h, -1)], axis=1)
    return head + offsets + body.tobytes()


def write_exr(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_exr(img))
