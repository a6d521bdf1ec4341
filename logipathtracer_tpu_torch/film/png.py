"""Minimal dependency-free PNG encode/decode (numpy + zlib).

Carried over from the JAX package's module of the same name so that
this package never imports JAX.

Replaces the reference's display path outputs: the reference presents
via a Vulkan swapchain (src/RendererCore.cpp:401-402); headless
rendering instead writes the tonemapped frame to disk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """Encode [H, W], [H, W, 3] or [H, W, 4] uint8 image to PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("encode_png expects uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter 0 (None) per scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    data = zlib.compress(raw.tobytes(), 6)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filters. raw: [h, 1+stride] uint8."""
    out = np.zeros((h, stride), np.uint16)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.uint16)
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.uint16)
        if ftype == 0:
            out[y] = line
        elif ftype == 1:  # Sub
            for x in range(stride):
                a = out[y, x - bpp] if x >= bpp else 0
                out[y, x] = (line[x] + a) & 0xFF
        elif ftype == 2:  # Up
            out[y] = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            for x in range(stride):
                a = out[y, x - bpp] if x >= bpp else 0
                out[y, x] = (line[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(out[y, x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                cc = int(out[y - 1, x - bpp]) if (x >= bpp and y > 0) else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                out[y, x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to [H, W, 4] uint8 RGBA (8-bit, non-interlaced)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = color_type = interlace = None
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bitdepth != 8 or interlace != 0:
        raise NotImplementedError("only 8-bit non-interlaced PNG supported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, 1 + stride)
    img = _unfilter(raw, h, stride, channels).reshape(h, w, channels)
    if color_type == 3:  # palette
        rgb = palette[img[:, :, 0]]
        alpha = np.full((h, w, 1), 255, np.uint8)
        if trns is not None:
            a = np.full(palette.shape[0], 255, np.uint8)
            a[:len(trns)] = trns
            alpha = a[img[:, :, 0]][:, :, None]
        return np.concatenate([rgb, alpha], axis=-1)
    if channels == 1:
        g = img
        return np.concatenate([g, g, g, np.full((h, w, 1), 255, np.uint8)], -1)
    if channels == 2:
        g, a = img[:, :, :1], img[:, :, 1:]
        return np.concatenate([g, g, g, a], -1)
    if channels == 3:
        return np.concatenate(
            [img, np.full((h, w, 1), 255, np.uint8)], -1)
    return img
