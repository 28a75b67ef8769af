"""Minimal pure-numpy OpenEXR codec (scanline, NONE/ZIP/ZIPS compression);
a copy of nerf_emitter_tpu/utils/exr.py without its optional native codec.

The EXR 2.0 single-part scanline format: HALF/FLOAT channels, NONE and
ZIP(S) compression (zlib + the OpenEXR byte-reorder/delta predictor).
Covers what the port reads and writes: dataset EXRs, envmap snapshots,
HDR render outputs.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP = 0, 2, 3
_DTYPES = {_PT_HALF: np.dtype("<f2"), _PT_FLOAT: np.dtype("<f4"), _PT_UINT: np.dtype("<u4")}


def _read_cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes):
    if struct.unpack("<i", buf[:4])[0] != _MAGIC:
        raise ValueError("not an EXR file")
    version = struct.unpack("<i", buf[4:8])[0]
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    if version & 0x800:
        raise NotImplementedError("deep EXR not supported")
    tiled = bool(version & 0x200)
    del tiled
    pos = 8
    attrs = {}
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstr(buf, pos)
        typ, pos = _read_cstr(buf, pos)
        size = struct.unpack("<i", buf[pos : pos + 4])[0]
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size
    return attrs, pos


def _parse_channels(raw: bytes):
    """-> list of (name, pixel_type) sorted as stored (alphabetical)."""
    chans = []
    pos = 0
    while raw[pos] != 0:
        name, pos = _read_cstr(raw, pos)
        ptype = struct.unpack("<i", raw[pos : pos + 4])[0]
        pos += 16  # pixel type + pLinear/reserved + xSampling + ySampling
        chans.append((name, ptype))
    return chans


def _unpredict(data: bytearray) -> bytes:
    arr = np.frombuffer(bytes(data), np.uint8).astype(np.int32)
    # undo delta: t[i] = t[i-1] + t[i] - 128
    deltas = arr.copy()
    deltas[1:] -= 128
    out = np.cumsum(deltas, dtype=np.int32) & 0xFF
    # undo reorder (deinterleave halves)
    n = len(out)
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = out[:half].astype(np.uint8)[: len(res[0::2])]
    res[1::2] = out[half:].astype(np.uint8)[: len(res[1::2])]
    return res.tobytes()


def _predict(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = arr[0::2]
    tmp[half:] = arr[1::2]
    t = tmp.astype(np.int32)
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def read_exr(path) -> np.ndarray:
    """Read an EXR into float32 (H, W, C); channels ordered R,G,B[,A] when
    present, otherwise alphabetical."""
    buf = Path(path).read_bytes()
    attrs, pos = _parse_header(buf)
    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    dw = struct.unpack("<4i", attrs["dataWindow"][1])
    xmin, ymin, xmax, ymax = dw
    w, h = xmax - xmin + 1, ymax - ymin + 1

    lines_per_block = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}.get(comp)
    if lines_per_block is None:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    # skip offset table
    pos += 8 * n_blocks

    names = [n for n, _ in chans]
    order = [c for c in ("R", "G", "B", "A") if c in names] or sorted(names)

    out = {name: np.empty((h, w), np.float32) for name, _ in chans}
    bytes_per_line = sum(_DTYPES[pt].itemsize for _, pt in chans) * w

    for _ in range(n_blocks):
        y, size = struct.unpack("<ii", buf[pos : pos + 8])
        pos += 8
        raw = buf[pos : pos + size]
        pos += size
        y0 = y - ymin
        n_lines = min(lines_per_block, h - y0)
        expect = bytes_per_line * n_lines
        if comp in (_COMP_ZIP, _COMP_ZIPS) and size < expect:
            raw = _unpredict(bytearray(zlib.decompress(raw)))
        lp = 0
        for li in range(n_lines):
            for name, pt in chans:
                dt = _DTYPES[pt]
                nb = dt.itemsize * w
                out[name][y0 + li] = np.frombuffer(
                    raw[lp : lp + nb], dt
                ).astype(np.float32)
                lp += nb

    return np.stack([out[c] for c in order], axis=-1)


def read_exr_size(path) -> tuple[int, int]:
    buf = Path(path).read_bytes()
    attrs, _ = _parse_header(buf)
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    return ymax - ymin + 1, xmax - xmin + 1  # (H, W)


def write_exr(path, image: np.ndarray, half: bool = True, compress: bool = True):
    """Write (H, W, C<=4) float image as scanline EXR (ZIP or NONE)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    names = ["R", "G", "B", "A"][:c] if c <= 4 else [f"C{i}" for i in range(c)]
    order = sorted(range(c), key=lambda i: names[i])
    pt = _PT_HALF if half else _PT_FLOAT
    dt = _DTYPES[pt]

    chl = b""
    for i in order:
        chl += names[i].encode() + b"\0"
        chl += struct.pack("<i", pt) + struct.pack("<B3x", 0) + struct.pack("<ii", 1, 1)
    chl += b"\0"

    comp = _COMP_ZIP if compress else _COMP_NONE
    lines_per_block = 16 if compress else 1

    def attr(name, typ, val):
        return (
            name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(val)) + val
        )

    header = b""
    header += attr("channels", "chlist", chl)
    header += attr("compression", "compression", struct.pack("<B", comp))
    header += attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        n_lines = min(lines_per_block, h - y0)
        # (n_lines, C, w): line-major channel-interleaved scanline layout
        chunk = np.ascontiguousarray(
            image[y0 : y0 + n_lines, :, order].transpose(0, 2, 1).astype(dt)
        )
        raw = chunk.tobytes()
        if compress:
            z = zlib.compress(_predict(raw))
            data = z if len(z) < len(raw) else raw
        else:
            data = raw
        blocks.append(struct.pack("<ii", y0, len(data)) + data)

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    offset0 = len(preamble) + 8 * n_blocks
    offsets, off = [], offset0
    for blk in blocks:
        offsets.append(off)
        off += len(blk)

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for blk in blocks:
            f.write(blk)
