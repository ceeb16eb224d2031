"""Image files: PNG with the sRGB tonemap (bitmap.cpp:38-64), a PNG reader,
and a self-contained OpenEXR writer and reader in place of the reference's
OIIO dependency (bitmap.cpp:7-36).

The port of ``kazen_tpu/film/io.py``, on the standard library (zlib,
struct) and numpy only, so the port needs no imaging package. The EXR
reader handles single-part scanline files with NONE / ZIPS / ZIP
compression and HALF / FLOAT / UINT channels; a PIZ or tiled file raises
the reference's ValueError (the reference falls back to cv2, which neither
package has here). ``load_image`` reads the texture files the scene
compiler meets: PNG (8 and 16 bits; gray, gray+alpha, RGB, RGBA and
palette) and EXR; any other format raises NotImplementedError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .film import to_srgb8

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_EXR_MAGIC = 20000630


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
        f.write(_PNG_MAGIC)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# PNG reader
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter_sequential(ftype: int, raw: bytes, prev: bytes, bpp: int) -> bytes:
    """Average (3) and Paeth (4) rows, whose bytes depend on their left
    neighbours' reconstructed values: one byte at a time."""
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return bytes(out)


def _png_unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) uint8 scanlines of a non-interlaced image."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        raw = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            row = raw
        elif ftype == 1:  # Sub: a running sum of each byte lane, mod 256
            row = (np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF)
            row = row.astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            row = raw + prev
        elif ftype in (3, 4):
            row = np.frombuffer(
                _unfilter_sequential(ftype, raw.tobytes(), prev.tobytes(), bpp), np.uint8
            )
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def load_png(path: str) -> np.ndarray:
    """A PNG's samples as stored: (H, W) for gray and (H, W, C) otherwise
    (gray+alpha 2, RGB 3, RGBA 4; palette images as RGB), uint8 or uint16
    by bit depth. Bit depths below 8 and interlaced files raise
    NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat, palette, hdr = [], None, None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype}")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise NotImplementedError(f"{path}: PNG bit depth {depth} (8 and 16 are read)")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


# ---------------------------------------------------------------------------
# OpenEXR
# ---------------------------------------------------------------------------


def save_exr(path: str, img, compression: str = "none") -> None:
    """OpenEXR 2.0 writer: single part, scanline, float32, channels B,G,R
    (alphabetical, per spec). compression: "none" or "zip" (zlib over
    16-scanline chunks with the ImfZip predictor)."""
    img = np.asarray(torch.as_tensor(img).detach().cpu(), np.float32)
    h, w = img.shape[:2]
    comp_id = {"none": 0, "zip": 3}[compression]
    lines = 1 if comp_id == 0 else 16

    def attr(name, type_name, data):
        return (
            name.encode() + b"\0" + type_name.encode() + b"\0"
            + struct.pack("<i", len(data)) + data
        )

    def channel(name):
        # name, pixel type (2=float), pLinear+reserved, xSampling, ySampling
        return name.encode() + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    chlist = channel("B") + channel("G") + channel("R") + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            attr("channels", "chlist", chlist),
            attr("compression", "compression", bytes([comp_id])),
            attr("dataWindow", "box2i", box),
            attr("displayWindow", "box2i", box),
            attr("lineOrder", "lineOrder", b"\0"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )
    magic = struct.pack("<ii", _EXR_MAGIC, 2)
    chunks = []
    for y0 in range(0, h, lines):
        n_lines = min(lines, h - y0)
        payload = b"".join(
            img[y, :, c].tobytes()
            for y in range(y0, y0 + n_lines)
            for c in (2, 1, 0)  # B, G, R
        )
        packed = payload
        if comp_id == 3:
            packed = zlib.compress(_exr_predict(payload))
            if len(packed) >= len(payload):  # spec: store raw if bigger
                packed = payload
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)
    off = len(magic) + len(header) + 8 * len(chunks)
    offsets = []
    for ch in chunks:
        offsets.append(struct.pack("<Q", off))
        off += len(ch)
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(b"".join(offsets))
        for ch in chunks:
            f.write(ch)


def _exr_predict(payload: bytes) -> bytes:
    """Inverse of _exr_unpredict: de-interleave then delta-encode."""
    d = np.frombuffer(payload, np.uint8)
    n = len(d)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    p = t.astype(np.int16)
    p[1:] = p[1:] - t[:-1].astype(np.int16) + 128
    return (p & 0xFF).astype(np.uint8).tobytes()


def _exr_unpredict(d: np.ndarray) -> bytes:
    """OpenEXR ImfZip reconstruction: delta-decode then re-interleave."""
    t = ((np.cumsum(d.astype(np.int64) - 128) + 128) & 0xFF).astype(np.uint8)
    n = len(t)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


class _UnsupportedEXR(Exception):
    pass


_PIX_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def load_exr(path: str) -> np.ndarray:
    """The (H, W, 3) float32 RGB of an EXR file (a Y-only file as gray)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _ = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    try:
        return _load_exr_native(data)
    except _UnsupportedEXR as e:
        raise ValueError(f"{path}: {e} (and no cv2 fallback available)") from e


def _load_exr_native(data: bytes) -> np.ndarray:
    if struct.unpack_from("<i", data, 4)[0] & 0x200:
        raise _UnsupportedEXR("tiled EXR")
    pos = 8
    w = h = None
    channels = []  # (name, dtype)
    compression = 0
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end].decode()
        pos = data.index(b"\0", name_end + 1) + 1  # past the type name
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if name == "dataWindow":
            x0, y0, x1, y1 = struct.unpack_from("<iiii", data, pos)
            w, h = x1 - x0 + 1, y1 - y0 + 1
        elif name == "compression":
            compression = data[pos]
        elif name == "channels":
            p = pos
            while data[p] != 0:
                ch_end = data.index(b"\0", p)
                cname = data[p:ch_end].decode()
                (ptype,) = struct.unpack_from("<i", data, ch_end + 1)
                xs, ys = struct.unpack_from("<ii", data, ch_end + 9)
                if ptype not in _PIX_DTYPE:
                    raise _UnsupportedEXR(f"channel type {ptype}")
                if (xs, ys) != (1, 1):
                    raise _UnsupportedEXR("subsampled channels")
                channels.append((cname, _PIX_DTYPE[ptype]))
                p = ch_end + 1 + 16
        pos += size
    pos += 1  # header terminator
    if compression not in _LINES_PER_CHUNK:
        raise _UnsupportedEXR(f"compression {compression} (only NONE/ZIPS/ZIP)")
    lines = _LINES_PER_CHUNK[compression]
    n_chunks = -(-h // lines)
    pos += 8 * n_chunks  # offset table (chunks are sequential here)

    line_bytes = sum(w * np.dtype(dt).itemsize for _, dt in channels)
    planes = {name: np.zeros((h, w), dt) for name, dt in channels}
    for _ in range(n_chunks):
        y0, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = data[pos: pos + nbytes]
        pos += nbytes
        n_lines = min(lines, h - y0)
        want = line_bytes * n_lines
        if compression == 0 or nbytes == want:
            buf = raw  # NONE, or a zip chunk stored raw (the spec allows it)
        else:
            buf = zlib.decompress(raw)
            if len(buf) != want:
                raise _UnsupportedEXR("bad zip chunk size")
            buf = _exr_unpredict(np.frombuffer(buf, np.uint8))
        off = 0
        for ly in range(n_lines):
            for cname, dt in channels:  # header order == file order
                planes[cname][y0 + ly] = np.frombuffer(buf, dt, w, off)
                off += w * np.dtype(dt).itemsize

    def chan(name):
        if name in planes:
            return planes[name].astype(np.float32)
        return np.zeros((h, w), np.float32)

    if "Y" in planes and "R" not in planes:
        y = chan("Y")
        return np.stack([y, y, y], -1)
    return np.stack([chan("R"), chan("G"), chan("B")], -1)


# ---------------------------------------------------------------------------
# texture files
# ---------------------------------------------------------------------------

_KNOWN_FORMATS = (
    (b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\0", "TIFF"),
    (b"MM\0*", "TIFF"), (b"RIFF", "WebP"), (b"#?RADIANCE", "Radiance HDR"),
    (b"#?RGBE", "Radiance HDR"), (b"8BPS", "PSD"),
)


def load_image(path: str) -> np.ndarray:
    """A texture file's pixels as stored, by the file's magic bytes: PNG
    through ``load_png`` (uint8/uint16), EXR through ``load_exr`` (float32
    RGB). Other formats raise NotImplementedError naming the format: the
    port has no decoder for them."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(_PNG_MAGIC):
        return load_png(path)
    if len(head) >= 4 and struct.unpack_from("<i", head, 0)[0] == _EXR_MAGIC:
        return load_exr(path)
    fmt = next((name for magic, name in _KNOWN_FORMATS if head.startswith(magic)), None)
    if fmt is None:
        fmt = "unknown format " + (path.rsplit(".", 1)[-1] if "." in path else repr(head[:8]))
    raise NotImplementedError(
        f"{path}: {fmt} image (kazen_tpu_torch reads PNG and EXR texture files only)"
    )
