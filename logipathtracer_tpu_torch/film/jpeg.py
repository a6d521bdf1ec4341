"""Baseline JPEG decoder (pure numpy + Python entropy loop).

Carried over from the JAX package's module of the same name so that
this package never imports JAX.

The reference's lsg image layer hands the renderer whatever pixel data
the asset holds (src/PTSceneConverter.cpp:243-389), and real-world glTF
PBR scenes (the BASELINE config-5 Sponza class) ship JPEG base-color
textures — so the loader needs a decoder without external deps.

Scope: baseline sequential DCT (SOF0/1) AND progressive DCT (SOF2 —
spectral selection + successive approximation), 8-bit,
grayscale or YCbCr with any h/v chroma subsampling (4:4:4 / 4:2:2 /
4:2:0), restart markers.  Arithmetic coding and hierarchical modes
raise ValueError — callers surface the error instead of silently
substituting pixels.

Entropy decoding uses a 16-bit lookahead table per Huffman table
(~1 µs/symbol in Python); the IDCT runs batched over all blocks in
numpy (separable 8x8 DCT-III as two matmuls).
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# DCT-III (inverse DCT) basis: x = C^T . X . C with C[k,n] scaled.
_C = np.zeros((8, 8), np.float32)
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16.0) * (
            np.sqrt(0.125) if _k == 0 else 0.5)


class _HuffTable:
    """Canonical Huffman table with a 16-bit lookahead decode table."""

    def __init__(self, counts, symbols):
        self.lookup = np.zeros(1 << 16, np.uint32)  # (sym << 8) | length
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                self.lookup[lo:hi] = (sym << 8) | length
                code += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over entropy-coded bytes (0xFF00 unstuffed,
    restart markers handled by the caller via align+reset)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0

    def _fill(self):
        data = self.data
        while self.nbits <= 48:
            if self.pos >= len(data):
                self.buf = (self.buf << 8) | 0  # pad zeros past the end
                self.nbits += 8
                continue
            b = data[self.pos]
            if b == 0xFF:
                nxt = data[self.pos + 1] if self.pos + 1 < len(data) else 0
                if nxt == 0x00:
                    self.pos += 2
                    self.buf = (self.buf << 8) | 0xFF
                    self.nbits += 8
                    continue
                # marker: stop feeding real bits (caller handles)
                self.buf = self.buf << 8
                self.nbits += 8
                continue
            self.pos += 1
            self.buf = (self.buf << 8) | b
            self.nbits += 8

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        return (self.buf >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int):
        self.nbits -= n
        self.buf &= (1 << self.nbits) - 1

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        v = (self.buf >> (self.nbits - n)) & ((1 << n) - 1)
        self.skip(n)
        return v

    def align_to_marker(self):
        """Drop buffered bits and consume a restart marker at self.pos."""
        self.buf = 0
        self.nbits = 0
        d = self.data
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    return v if v >= (1 << (size - 1)) else v - (1 << size) + 1


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG to RGBA8 [H, W, 4] (alpha = 255)."""
    if data[0:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    planes = None  # progressive: per-component coefficient planes
    restart_interval = 0
    n = len(data)

    while pos < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    tbl = np.frombuffer(seg[p:p + 128], ">u2").astype(
                        np.int32)
                    p += 128
                else:
                    tbl = np.frombuffer(seg[p:p + 64], np.uint8).astype(
                        np.int32)
                    p += 64
                qt[tq] = tbl
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                total = sum(counts)
                syms = list(seg[p + 17:p + 17 + total])
                (huff_dc if tc == 0 else huff_ac)[th] = _HuffTable(
                    counts, syms)
                p += 17 + total
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 prog
            prec, h, w, nc = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
            if prec != 8:
                raise ValueError(f"JPEG precision {prec} unsupported")
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = dict(h=h, w=w, comps=comps,
                         progressive=marker == 0xC2)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError(
                f"JPEG SOF marker 0x{marker:02X} unsupported "
                "(lossless/arithmetic/hierarchical)")
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack(">H", seg[0:2])
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG SOS before SOF")
            ns = seg[0]
            scan = {}
            order = []
            for c in range(ns):
                cid, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                scan[cid] = (tt >> 4, tt & 15)
                order.append(cid)
            if not frame["progressive"]:
                pos = pos + seglen
                return _decode_scan(data, pos, frame, scan, qt, huff_dc,
                                    huff_ac, restart_interval)
            ss, se, aa = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = aa >> 4, aa & 15
            if planes is None:
                planes = _alloc_planes(frame)
            pos = _progressive_scan(
                data, pos + seglen, frame, scan, order, huff_dc, huff_ac,
                restart_interval, planes, ss, se, ah, al)
            continue
        pos += seglen
    if planes is not None:
        return _reconstruct(frame, planes, qt)
    raise ValueError("JPEG has no SOS scan")


def _upsample(plane: np.ndarray, factor: int, axis: int) -> np.ndarray:
    if factor == 1:
        return plane
    if factor != 2:
        return np.repeat(plane, factor, axis=axis)
    # Triangle filter: out[2i] = (3*x[i] + x[i-1] + 2) / 4,
    #                  out[2i+1] = (3*x[i] + x[i+1] + 2) / 4 (edges clamp).
    x = np.moveaxis(plane, axis, 0)
    prev = np.concatenate([x[:1], x[:-1]], axis=0)
    nxt = np.concatenate([x[1:], x[-1:]], axis=0)
    lo = (3.0 * x + prev) * 0.25
    hi = (3.0 * x + nxt) * 0.25
    out = np.empty((2 * x.shape[0],) + x.shape[1:], x.dtype)
    out[0::2] = lo
    out[1::2] = hi
    return np.moveaxis(out, 0, axis)


def _decode_scan(data, pos, frame, scan, qt, huff_dc, huff_ac,
                 restart_interval):
    h, w, comps = frame["h"], frame["w"], frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))

    # Per-component coefficient planes (in blocks).
    planes = []
    for c in comps:
        bw = mcux * c["h"]
        bh = mcuy * c["v"]
        planes.append(np.zeros((bh * bw, 64), np.int32))

    br = _BitReader(data, pos)
    pred = [0] * len(comps)
    mcu_count = mcux * mcuy
    for m in range(mcu_count):
        if restart_interval and m and m % restart_interval == 0:
            br.align_to_marker()
            pred = [0] * len(comps)
        my, mx = divmod(m, mcux)
        for ci, c in enumerate(comps):
            tdc, tac = scan[c["id"]]
            dct = huff_dc[tdc].lookup
            act = huff_ac[tac].lookup
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    blk = planes[ci][
                        (my * c["v"] + by) * (mcux * c["h"])
                        + mx * c["h"] + bx]
                    # DC
                    e = int(dct[br.peek16()])
                    size, length = e >> 8, e & 255
                    if length == 0:
                        raise ValueError("bad JPEG Huffman code (DC)")
                    br.skip(length)
                    pred[ci] += _extend(br.get(size), size)
                    blk[0] = pred[ci]
                    # AC
                    k = 1
                    while k < 64:
                        e = int(act[br.peek16()])
                        rs, length = e >> 8, e & 255
                        if length == 0:
                            raise ValueError("bad JPEG Huffman code (AC)")
                        br.skip(length)
                        run, size = rs >> 4, rs & 15
                        if size == 0:
                            if run == 15:
                                k += 16
                                continue
                            break  # EOB
                        k += run
                        if k > 63:
                            raise ValueError("JPEG AC run past block end")
                        blk[k] = _extend(br.get(size), size)
                        k += 1

    return _reconstruct(frame, planes, qt)


def _mcu_grid(frame):
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-frame["w"] // (8 * hmax))
    mcuy = -(-frame["h"] // (8 * vmax))
    return hmax, vmax, mcux, mcuy


def _alloc_planes(frame):
    """MCU-padded per-component coefficient planes [(bh*bw, 64) i32]."""
    _, _, mcux, mcuy = _mcu_grid(frame)
    return [np.zeros((mcuy * c["v"] * mcux * c["h"], 64), np.int32)
            for c in frame["comps"]]


def _reconstruct(frame, planes, qt):
    """Dequantize + batched inverse DCT + chroma upsample + YCbCr."""
    h, w, comps = frame["h"], frame["w"], frame["comps"]
    hmax, vmax, mcux, mcuy = _mcu_grid(frame)
    out_planes = []
    for ci, c in enumerate(comps):
        coeff = planes[ci] * qt[c["tq"]][None, :]
        grid = np.zeros((coeff.shape[0], 64), np.float32)
        grid[:, ZIGZAG] = coeff.astype(np.float32)
        blocks = grid.reshape(-1, 8, 8)
        spatial = np.einsum("ki,bkl,lj->bij", _C, blocks, _C,
                            optimize=True) + 128.0
        bw = mcux * c["h"]
        bh = mcuy * c["v"]
        plane = spatial.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(bh * 8, bw * 8)
        # Upsample to full MCU-aligned resolution: triangle filter for
        # 2x factors (libjpeg "fancy upsampling"), nearest otherwise.
        plane = _upsample(plane, vmax // c["v"], axis=0)
        plane = _upsample(plane, hmax // c["h"], axis=1)
        out_planes.append(plane[:h, :w])

    if len(comps) == 1:
        y = np.clip(out_planes[0], 0, 255)
        rgb = np.stack([y, y, y], axis=-1)
    elif len(comps) == 3:
        y, cb, cr = out_planes
        cb = cb - 128.0
        cr = cr - 128.0
        rgb = np.stack([
            y + 1.402 * cr,
            y - 0.344136 * cb - 0.714136 * cr,
            y + 1.772 * cb], axis=-1)
        rgb = np.clip(rgb, 0, 255)
    else:
        raise ValueError(f"JPEG with {len(comps)} components unsupported")

    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., :3] = rgb.astype(np.uint8)
    rgba[..., 3] = 255
    return rgba


def _progressive_scan(data, pos, frame, scan, order, huff_dc, huff_ac,
                      restart_interval, planes, ss, se, ah, al):
    """Decode one progressive scan (ITU T.81 G.2) into ``planes``.

    Four scan kinds: DC first (Ss=0, Ah=0; may interleave components),
    DC refinement (Ss=0, Ah>0), AC first (Ss>0, Ah=0; single component,
    EOB runs), AC refinement (Ss>0, Ah>0; correction bits).  Returns
    the byte position of the next marker."""
    comps = frame["comps"]
    hmax, vmax, mcux, mcuy = _mcu_grid(frame)
    by_id = {c["id"]: (ci, c) for ci, c in enumerate(comps)}
    br = _BitReader(data, pos)

    if ss == 0 and len(order) > 1:
        # ---- interleaved DC scan over MCUs ---------------------------
        pred = {cid: 0 for cid in order}
        for m in range(mcux * mcuy):
            if restart_interval and m and m % restart_interval == 0:
                br.align_to_marker()
                pred = {cid: 0 for cid in order}
            my, mx = divmod(m, mcux)
            for cid in order:
                ci, c = by_id[cid]
                dct = huff_dc[scan[cid][0]].lookup if ah == 0 else None
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        blk = planes[ci][
                            (my * c["v"] + by) * (mcux * c["h"])
                            + mx * c["h"] + bx]
                        _dc_unit(br, blk, dct, pred, cid, ah, al)
    else:
        # ---- non-interleaved scan in the component's own block grid --
        cid = order[0]
        ci, c = by_id[cid]
        cw = -(-frame["w"] * c["h"] // hmax)
        ch = -(-frame["h"] * c["v"] // vmax)
        cbw = -(-cw // 8)
        cbh = -(-ch // 8)
        row_stride = mcux * c["h"]
        dct = (huff_dc[scan[cid][0]].lookup
               if ss == 0 and ah == 0 else None)
        act = huff_ac[scan[cid][1]].lookup if ss > 0 else None
        pred = {cid: 0}
        eobrun = [0]
        nblk = 0
        for by in range(cbh):
            for bx in range(cbw):
                if (restart_interval and nblk
                        and nblk % restart_interval == 0):
                    br.align_to_marker()
                    pred = {cid: 0}
                    eobrun[0] = 0
                nblk += 1
                blk = planes[ci][by * row_stride + bx]
                if ss == 0:
                    _dc_unit(br, blk, dct, pred, cid, ah, al)
                elif ah == 0:
                    _ac_first_unit(br, blk, act, ss, se, al, eobrun)
                else:
                    _ac_refine_unit(br, blk, act, ss, se, al, eobrun)

    # Advance to the next marker (skip any trailing RST).
    d = data
    p = br.pos
    while p + 1 < len(d):
        if d[p] == 0xFF and d[p + 1] != 0x00:
            if 0xD0 <= d[p + 1] <= 0xD7:
                p += 2
                continue
            return p
        p += 1
    return len(d)


def _dc_unit(br, blk, dct, pred, cid, ah, al):
    if ah == 0:
        e = int(dct[br.peek16()])
        size, length = e >> 8, e & 255
        if length == 0:
            raise ValueError("bad JPEG Huffman code (prog DC)")
        br.skip(length)
        pred[cid] += _extend(br.get(size), size)
        blk[0] = pred[cid] << al
    else:
        if br.get(1):
            blk[0] |= 1 << al


def _ac_first_unit(br, blk, act, ss, se, al, eobrun):
    if eobrun[0] > 0:
        eobrun[0] -= 1
        return
    k = ss
    while k <= se:
        e = int(act[br.peek16()])
        rs, length = e >> 8, e & 255
        if length == 0:
            raise ValueError("bad JPEG Huffman code (prog AC)")
        br.skip(length)
        run, size = rs >> 4, rs & 15
        if size == 0:
            if run < 15:
                eobrun[0] = (1 << run) - 1
                if run:
                    eobrun[0] += br.get(run)
                return
            k += 16
            continue
        k += run
        if k > se:
            raise ValueError("JPEG progressive AC run past band end")
        blk[k] = _extend(br.get(size), size) << al
        k += 1


def _ac_refine_unit(br, blk, act, ss, se, al, eobrun):
    p1 = 1 << al
    m1 = -1 << al
    k = ss
    if eobrun[0] == 0:
        while k <= se:
            e = int(act[br.peek16()])
            rs, length = e >> 8, e & 255
            if length == 0:
                raise ValueError("bad JPEG Huffman code (prog AC ref)")
            br.skip(length)
            run, size = rs >> 4, rs & 15
            val = 0
            if size == 0:
                if run < 15:
                    eobrun[0] = 1 << run
                    if run:
                        eobrun[0] += br.get(run)
                    break
                # run == 15: skip 16 zero-history coefficients
            else:
                if size != 1:
                    raise ValueError("JPEG AC refinement size != 1")
                val = p1 if br.get(1) else m1
            # Advance over `run` zero-history coefficients, applying
            # correction bits to nonzero ones passed on the way.
            while k <= se:
                if blk[k] != 0:
                    if br.get(1) and (blk[k] & p1) == 0:
                        blk[k] += p1 if blk[k] > 0 else m1
                else:
                    if run == 0:
                        break
                    run -= 1
                k += 1
            if val and k <= se:
                blk[k] = val
            k += 1
    if eobrun[0] > 0:
        # Correction-bit pass over the rest of the band.
        while k <= se:
            if blk[k] != 0:
                if br.get(1) and (blk[k] & p1) == 0:
                    blk[k] += p1 if blk[k] > 0 else m1
            k += 1
        eobrun[0] -= 1
