"""Dependency-free baseline JPEG codec (write + read).

The port's own copy of ``volumeraytracer_tpu/utils/jpeg.py`` (numpy and the
standard library only; importing the JAX package's module would import jax
through its package ``__init__``), line for line, so that both packages
write the same bytes.  C17 parity with the reference's JPEG layer
(IMG_IO::load_jpeg/write_jpeg, the reference's ``src/image_io.h:16-22``,
``image_io.cpp`` — libjpeg there), used by the debug image-stack exporter.  Implemented directly against ITU T.81:

  * ``write_jpeg``: baseline sequential DCT, 8-bit, grayscale or YCbCr
    4:4:4, standard Annex-K quantization (quality-scaled, libjpeg
    convention) and Huffman tables.  The DCT is a vectorized numpy matrix
    product over all 8×8 blocks at once; only the entropy coding is a
    per-block Python loop.
  * ``read_jpeg``: baseline sequential decoder (SOF0), arbitrary sampling
    factors (nearest-neighbour upsampling), restart markers, 1- or
    3-component; tables are taken from the file's DQT/DHT segments.

Progressive, arithmetic, 12-bit and CMYK files are rejected with a clear
error — the reference's debug dumps never use them.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

# ---------------------------------------------------------------------------
# constants (ITU T.81 Annex K)
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

Q_LUM = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.float64)
Q_CHR = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.float64)

DC_LUM_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_LUM_VALS = list(range(12))
DC_CHR_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
DC_CHR_VALS = list(range(12))
AC_LUM_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_LUM_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
AC_CHR_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
AC_CHR_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]

# orthonormal DCT-II matrix, scaled to the JPEG (non-orthonormal) convention
_C = np.zeros((8, 8))
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16.0)
_ALPHA = np.full(8, 0.5)
_ALPHA[0] = 1.0 / (2.0 ** 0.5) / 2.0 * 2.0  # 1/sqrt(2) * 1/2 * 2 = guards below
_ALPHA = np.array([1.0 / np.sqrt(2)] + [1.0] * 7) / 2.0
_DCT = _C * _ALPHA[:, None]  # forward: F = DCT @ f @ DCT.T  (T.81 A.3.3)


def _build_huff_encode(bits, vals):
    """(bits, vals) → {symbol: (code, length)} by canonical code assignment."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.buf.append(b)
            if b == 0xFF:  # byte stuffing (T.81 F.1.2.3)
                self.buf.append(0x00)

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)  # 1-pad to a byte boundary


def _magnitude(v: int):
    """(size, amplitude bits) of a coefficient (T.81 F.1.2.1.2)."""
    if v == 0:
        return 0, 0
    a = abs(v)
    size = int(a).bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


def _blockify(plane: np.ndarray):
    """(H, W) → (n_blocks, 8, 8), edge-padded to multiples of 8."""
    h, w = plane.shape
    H = -(-h // 8) * 8
    W = -(-w // 8) * 8
    p = np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")
    return (
        p.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8),
        H // 8, W // 8,
    )


def _quality_tables(quality: int):
    quality = min(max(int(quality), 1), 100)
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    qs = []
    for base in (Q_LUM, Q_CHR):
        q = np.floor((base * scale + 50.0) / 100.0)
        qs.append(np.clip(q, 1, 255).astype(np.int32))
    return qs


def _rgb_to_ycbcr(img: np.ndarray):
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return [y, cb, cr]


def write_jpeg(path: Union[str, Path], image: np.ndarray, quality: int = 90) -> None:
    """Encode a (H, W) grayscale or (H, W, 3) RGB uint8 array as baseline
    JPEG (4:4:4 for color).  ≙ IMG_IO::write_jpeg (image_io.cpp)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_jpeg needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
    elif img.ndim == 3 and img.shape[2] == 3:
        planes = _rgb_to_ycbcr(img)
    else:
        raise ValueError(f"write_jpeg needs (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    ncomp = len(planes)
    qtabs = _quality_tables(quality)

    # vectorized FDCT + quantization for every component
    comp_coeffs = []
    for ci, plane in enumerate(planes):
        blocks, _, _ = _blockify(plane - 128.0)
        F = np.einsum("ij,njk,lk->nil", _DCT, blocks, _DCT)
        q = qtabs[0 if ci == 0 else 1].reshape(8, 8).astype(np.float64)
        coeffs = np.round(F / q).astype(np.int32)
        comp_coeffs.append(coeffs.reshape(-1, 64)[:, ZIGZAG])

    out = bytearray()
    out += b"\xFF\xD8"  # SOI
    out += b"\xFF\xE0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00" \
        + struct.pack(">HH", 1, 1) + b"\x00\x00"
    # DQT
    for tid in range(2 if ncomp == 3 else 1):
        zz = qtabs[tid][ZIGZAG].astype(np.uint8).tobytes()
        out += b"\xFF\xDB" + struct.pack(">H", 67) + bytes([tid]) + zz
    # SOF0
    out += b"\xFF\xC0" + struct.pack(">HBHHB", 8 + 3 * ncomp, 8, h, w, ncomp)
    for ci in range(ncomp):
        out += bytes([ci + 1, 0x11, 0 if ci == 0 else 1])  # 4:4:4
    # DHT
    tables = [(0x00, DC_LUM_BITS, DC_LUM_VALS), (0x10, AC_LUM_BITS, AC_LUM_VALS)]
    if ncomp == 3:
        tables += [(0x01, DC_CHR_BITS, DC_CHR_VALS), (0x11, AC_CHR_BITS, AC_CHR_VALS)]
    for tc, bits, vals in tables:
        out += b"\xFF\xC4" + struct.pack(">H", 19 + len(vals)) + bytes([tc])
        out += bytes(bits) + bytes(vals)
    # SOS
    out += b"\xFF\xDA" + struct.pack(">HB", 6 + 2 * ncomp, ncomp)
    for ci in range(ncomp):
        out += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
    out += b"\x00\x3F\x00"

    dc_codes = [_build_huff_encode(DC_LUM_BITS, DC_LUM_VALS),
                _build_huff_encode(DC_CHR_BITS, DC_CHR_VALS)]
    ac_codes = [_build_huff_encode(AC_LUM_BITS, AC_LUM_VALS),
                _build_huff_encode(AC_CHR_BITS, AC_CHR_VALS)]

    bw = _BitWriter()
    pred = [0] * ncomp
    n_blocks = comp_coeffs[0].shape[0]
    for bi in range(n_blocks):  # 4:4:4 MCU = one block per component
        for ci in range(ncomp):
            tid = 0 if ci == 0 else 1
            zz = comp_coeffs[ci][bi]
            diff = int(zz[0]) - pred[ci]
            pred[ci] = int(zz[0])
            size, bits_v = _magnitude(diff)
            code, length = dc_codes[tid][size]
            bw.write(code, length)
            if size:
                bw.write(bits_v, size)
            run = 0
            last = 63
            while last > 0 and zz[last] == 0:
                last -= 1
            for k in range(1, last + 1):
                v = int(zz[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    code, length = ac_codes[tid][0xF0]  # ZRL
                    bw.write(code, length)
                    run -= 16
                size, bits_v = _magnitude(v)
                code, length = ac_codes[tid][(run << 4) | size]
                bw.write(code, length)
                bw.write(bits_v, size)
                run = 0
            if last < 63:
                code, length = ac_codes[tid][0x00]  # EOB
                bw.write(code, length)
    bw.flush()
    out += bw.buf
    out += b"\xFF\xD9"  # EOI
    Path(path).write_bytes(bytes(out))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0xD9
                if nxt == 0x00:
                    self.pos += 1  # stuffed byte
                else:
                    # marker: treat as end of entropy data (pad with zeros)
                    self.pos -= 1
                    self.acc = (self.acc << 8) & 0xFFFFFFFF
                    self.nbits += 8
                    continue
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        return v

    def align(self):
        self.nbits -= self.nbits % 8


def _build_huff_decode(bits, vals):
    """(bits, vals) → dict {(length, code): symbol}."""
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[(length, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _decode_symbol(br: _BitReader, table) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.read(1)
        sym = table.get((length, code))
        if sym is not None:
            return sym
    raise ValueError("invalid JPEG: bad Huffman code")


def _extend(v: int, size: int) -> int:
    return v if v >= (1 << (size - 1)) else v - (1 << size) + 1


def read_jpeg(path: Union[str, Path]) -> np.ndarray:
    """Decode a baseline sequential JPEG → (H, W) or (H, W, 3) uint8.
    ≙ IMG_IO::load_jpeg (image_io.cpp).  Rejects progressive/arithmetic/
    12-bit files with a ValueError."""
    data = Path(path).read_bytes()
    if data[:2] != b"\xFF\xD8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    restart_interval = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("invalid JPEG: expected marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2 : pos + seglen]
        pos += seglen
        if marker == 0xDB:  # DQT
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 0xF
                o += 1
                if pq:
                    tab = np.frombuffer(seg[o : o + 128], ">u2").astype(np.int32)
                    o += 128
                else:
                    tab = np.frombuffer(seg[o : o + 64], np.uint8).astype(np.int32)
                    o += 64
                dq = np.zeros(64, np.int32)
                dq[ZIGZAG] = tab
                qt[tq] = dq
        elif marker == 0xC4:  # DHT
            o = 0
            while o < len(seg):
                tc, th = seg[o] >> 4, seg[o] & 0xF
                o += 1
                bits = list(seg[o : o + 16])
                o += 16
                nv = sum(bits)
                vals = list(seg[o : o + nv])
                o += nv
                tab = _build_huff_decode(bits, vals)
                (huff_ac if tc else huff_dc)[th] = tab
        elif marker == 0xC0 or marker == 0xC1:  # SOF0/1 (baseline/ext seq)
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"unsupported JPEG precision {prec}")
            comps = []
            for i in range(nc):
                cid, samp, tq = seg[6 + 3 * i : 9 + 3 * i]
                comps.append({"id": cid, "h": samp >> 4, "v": samp & 0xF, "tq": tq})
            frame = {"h": h, "w": w, "comps": comps}
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError("unsupported JPEG mode (progressive/arithmetic)")
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("invalid JPEG: SOS before SOF")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                comp = next(c for c in frame["comps"] if c["id"] == cs)
                scan.append({**comp, "td": tt >> 4, "ta": tt & 0xF})
            out = _decode_scan(
                data[pos:], frame, scan, qt, huff_dc, huff_ac, restart_interval
            )
            return out
    raise ValueError("invalid JPEG: no scan data")


def _decode_scan(entropy, frame, scan, qt, huff_dc, huff_ac, restart_interval):
    h, w = frame["h"], frame["w"]
    hmax = max(c["h"] for c in scan)
    vmax = max(c["v"] for c in scan)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    planes = [
        np.zeros((mcuy * c["v"] * 8, mcux * c["h"] * 8), np.float64)
        for c in scan
    ]
    idct = _DCT.T  # inverse: f = DCTᵀ @ F @ DCT
    br = _BitReader(entropy)
    pred = [0] * len(scan)
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_count and mcu_count % restart_interval == 0:
                br.align()
                # skip the RSTn marker bytes if present
                while br.pos + 1 < len(br.data) and br.data[br.pos] == 0xFF \
                        and 0xD0 <= br.data[br.pos + 1] <= 0xD7:
                    br.pos += 2
                    br.acc = 0
                    br.nbits = 0
                pred = [0] * len(scan)
            for ci, c in enumerate(scan):
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        zz = np.zeros(64, np.int32)
                        size = _decode_symbol(br, huff_dc[c["td"]])
                        if size:
                            zz[0] = _extend(br.read(size), size)
                        zz[0] += pred[ci]
                        pred[ci] = int(zz[0])
                        k = 1
                        while k < 64:
                            rs = _decode_symbol(br, huff_ac[c["ta"]])
                            r, s = rs >> 4, rs & 0xF
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                raise ValueError("invalid JPEG: AC overflow")
                            zz[k] = _extend(br.read(s), s)
                            k += 1
                        blk = np.zeros(64, np.float64)
                        blk[ZIGZAG] = zz * qt[c["tq"]][ZIGZAG]
                        F = blk.reshape(8, 8)
                        f = idct @ F @ _DCT + 128.0
                        y0 = (my * c["v"] + by) * 8
                        x0 = (mx * c["h"] + bx) * 8
                        planes[ci][y0 : y0 + 8, x0 : x0 + 8] = f
            mcu_count += 1

    # upsample to full size (nearest) and crop
    full = []
    for ci, c in enumerate(scan):
        p = planes[ci]
        ry, rx = vmax // c["v"], hmax // c["h"]
        if ry > 1 or rx > 1:
            p = np.repeat(np.repeat(p, ry, axis=0), rx, axis=1)
        full.append(p[:h, :w])
    if len(full) == 1:
        return np.clip(full[0], 0, 255).astype(np.uint8)
    if len(full) == 3:
        y, cb, cr = full
        r = y + 1.402 * (cr - 128.0)
        g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
        b = y + 1.772 * (cb - 128.0)
        return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
    raise ValueError(f"unsupported JPEG component count {len(full)}")
