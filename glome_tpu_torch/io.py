"""Minimal image output (PNG via stdlib zlib, PPM fallback).

The reference blits to an SDL window (Glome.hs:353-367); a headless TPU
framework writes files instead.  Color quantization mirrors rgbf
(Glome.hs:107-110): clamp to [0, 1-delta], floor(c * 256).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .config import DELTA


def quantize(rgb) -> np.ndarray:
    arr = np.asarray(rgb, dtype=np.float64)
    arr = np.clip(arr, 0.0, 1.0 - DELTA)
    return np.floor(arr * 256.0).astype(np.uint8)


def write_png(path: str, rgb):
    """rgb: (H, W, 3) floats in [0, 1]."""
    img = quantize(rgb)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return (struct.pack(">I", len(data)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_ppm(path: str, rgb):
    img = quantize(rgb)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG whose rows use
    filter type 0 -- what write_png writes (and the repo's goldens)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    if np.any(rows[:, 0] != 0):
        raise ValueError(f"{path}: only filter type 0 rows")
    return rows[:, 1:].reshape(h, w, 3).copy()
