"""Dependency-free image and video output: uncompressed AVI and 8-bit PNG
(port of nerf_emitter_tpu/utils/video.py).

The reference muxes trajectory renders as MJPEG-in-AVI, each frame a JPEG
that PIL encodes. The port does not depend on PIL (a GPU host need not
have it), and a JPEG encoder is not worth carrying here, so `write_avi`
keeps the reference's
RIFF container (header, one stream, `movi` chunks, `idx1` index) but stores
each frame as an uncompressed 24-bit bottom-up DIB (fourcc `DIB `, chunks
`00db`): the stdlib and numpy suffice, every mainstream player reads it,
and a frame reads back bit for bit. The files are larger than MJPEG's, by
about the JPEG's compression ratio. The LDR frames the render CLI saves are
PNGs from `write_png` (stdlib zlib); `read_png` reads them back, and the
8-bit PNGs other writers (PIL, OpenCV) make, whose rows are filtered.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels


def to_uint8(frame: np.ndarray) -> np.ndarray:
    """(H, W, C) float in [0, 1] (clipped) or uint8 -> uint8."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return (np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)


def _dib_bytes(frame: np.ndarray) -> bytes:
    """A frame as a BI_RGB DIB: BGR, rows bottom-up, each padded to 4 bytes."""
    rgb = to_uint8(frame)[..., :3]
    h, w = rgb.shape[:2]
    rows = np.zeros((h, (3 * w + 3) // 4 * 4), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    return rows.tobytes()


def write_avi(path, frames, fps: int = 24) -> Path:
    """frames: iterable of (H, W, 3) float [0, 1] or uint8 arrays, all of
    one size -> an uncompressed AVI at `path`."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("frames differ in size")
    dibs = [_dib_bytes(f) for f in frames]
    n, size = len(dibs), len(dibs[0])  # DIB rows are 4-byte aligned, so every chunk is word-aligned

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    # AVIMAINHEADER: usec per frame, max bytes/s, padding, flags (HASINDEX),
    # frames, initial frames, streams, suggested buffer, width, height
    avih = struct.pack("<14I", int(1e6 // fps), size * fps, 0, 0x10, n, 0, 1, size, w, h, 0, 0, 0, 0)
    # AVISTREAMHEADER after fccType/fccHandler: flags, priority, language,
    # initial frames, scale, rate, start, length, suggested buffer, quality,
    # sample size, then rcFrame as 4 shorts
    strh = b"vids" + b"DIB " + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, n, size, 0xFFFFFFFF, 0) \
        + struct.pack("<4H", 0, 0, w, h)
    # BITMAPINFOHEADER: BI_RGB (0), 24 bits, a positive height (bottom-up rows)
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00db", d) for d in dibs))
    # idx1: each chunk's offset from the 'movi' fourcc
    idx = b"".join(b"00db" + struct.pack("<III", 0x10, 4 + i * (8 + size), size) for i in range(n))
    payload = b"AVI " + hdrl + movi + chunk(b"idx1", idx)
    path = Path(path)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(payload)) + payload)
    return path


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1|2|3|4) float [0, 1] or uint8 -> the bytes of an
    8-bit PNG (every row filter 0)."""
    img = to_uint8(image)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> Path:
    """encode_png(image) written to `path`."""
    path = Path(path)
    path.write_bytes(encode_png(image))
    return path


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of (H, 1 + row bytes) scanlines -> (H, row bytes) uint8."""
    h, n = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, n), np.int64)
    prior = np.zeros(n, np.int64)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if kind == 0:
            row = line
        elif kind == 1:
            row = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:
            row = (line + prior) % 256
        elif kind in (3, 4):
            row = line.copy()
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, n, bpp):
                up = prior[x:x + bpp]
                pred = (left + up) // 2 if kind == 3 else _paeth(left, up, up_left)
                left = row[x:x + bpp] = (line[x:x + bpp] + pred) % 256
                up_left = up
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = prior = row
    return out.astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced grey, grey-alpha, RGB or RGBA PNG (any row
    filters: write_png's, PIL's or OpenCV's) -> (H, W, C) uint8. Other PNGs
    (palette, 16-bit, interlaced) raise ValueError."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are read (depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    rows = raw[:, 1:] if not raw[:, 0].any() else _unfilter(raw, c)
    return rows.reshape(h, w, c).copy()
