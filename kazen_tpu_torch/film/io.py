"""Image output: PNG with the sRGB tonemap (bitmap.cpp:38-64).

The port of ``kazen_tpu/film/io.py:save_png``. The PNG is written with the
standard library (zlib + struct), so the port needs no imaging package.
"""
from __future__ import annotations

import struct
import zlib

from .film import to_srgb8


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def save_png(path: str, img) -> None:
    """Per-pixel sRGB tonemap + 8-bit RGB PNG of an (H, W, 3) linear image."""
    rgb = to_srgb8(img)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
