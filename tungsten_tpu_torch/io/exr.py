"""Minimal OpenEXR 2.0 scanline codec (pure Python, zlib).

Replaces the reference's OpenEXR dependency (io/ImageIO.cpp:50-120 loadExr /
saveExr via the OpenEXR library, optional per CMakeLists.txt:121-195).
Supports what a renderer actually needs:
  write: RGB(A), HALF or FLOAT, ZIP (16-scanline blocks) or NO compression
  read:  single-part scanline images, HALF/FLOAT channels, NONE/ZIP/ZIPS
No tiles, no deep data, no multi-part, no PIZ/B44 — those raise.

EXR ZIP blocks apply a byte predictor + interleave (the "reorder" pass) on
top of zlib — implemented with numpy below.

A copy of tungsten_tpu/io/exr.py (numpy only), kept in the port so that
it loads nothing of the JAX package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2
_NO_COMP = 0
_ZIPS_COMP = 2   # 1 scanline / block
_ZIP_COMP = 3    # 16 scanlines / block


# ---------------------------------------------------------------------------
# ZIP block predictor (OpenEXR ImfZip.cpp reorder + delta)
# ---------------------------------------------------------------------------

def _zip_post_decompress(raw: bytes) -> bytes:
    data = np.frombuffer(raw, np.uint8)
    # undo the sequential predictor d[i] += d[i-1] - 128: closed form
    # u[i] = (cumsum(d)[i] - 128*i) mod 256
    un = ((np.cumsum(data.astype(np.int64))
           - 128 * np.arange(len(data))) % 256).astype(np.uint8)
    # de-interleave: first half = even bytes, second half = odd bytes
    n = len(un)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = un[:half]
    out[1::2] = un[half:]
    return out.tobytes()


def _zip_pre_compress(raw: bytes) -> bytes:
    data = np.frombuffer(raw, np.uint8)
    n = len(data)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = data[0::2]
    inter[half:] = data[1::2]
    # delta encode: d[i] = x[i] - x[i-1] + 128 (mod 256)
    d = inter.astype(np.int16)
    d[1:] = (d[1:] - inter[:-1].astype(np.int16) + 128) % 256
    return d.astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def write_exr(path, img, half=True, compress=True):
    """img: [H, W, 3] or [H, W, 4] float linear."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    H, W, C = img.shape
    names = [b"B", b"G", b"R"] if C == 3 else [b"A", b"B", b"G", b"R"]
    # channel order in the file is alphabetical; map to img planes
    plane = {b"R": 0, b"G": 1, b"B": 2, b"A": 3}
    ptype = _HALF if half else _FLOAT
    dtype = np.float16 if half else np.float32

    chlist = b""
    for nm in names:
        chlist += nm + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chlist += b"\x00"

    comp = _ZIP_COMP if compress else _NO_COMP
    header = b""
    header += _attr(b"channels", b"chlist", chlist)
    header += _attr(b"compression", b"compression", bytes([comp]))
    header += _attr(b"dataWindow", b"box2i",
                    struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _attr(b"displayWindow", b"box2i",
                    struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    rows_per = 16 if compress else 1
    n_blocks = (H + rows_per - 1) // rows_per
    blocks = []
    for b in range(n_blocks):
        y0 = b * rows_per
        ny = min(rows_per, H - y0)
        # block layout: for each scanline, each channel contiguously
        lines = []
        for y in range(y0, y0 + ny):
            for nm in names:
                lines.append(img[y, :, plane[nm]].astype(dtype).tobytes())
        raw = b"".join(lines)
        if compress:
            z = zlib.compress(_zip_pre_compress(raw), 6)
            if len(z) >= len(raw):
                z = raw  # EXR stores raw when compression doesn't help
        else:
            z = raw
        blocks.append((y0, z))

    with open(path, "wb") as f:
        head = struct.pack("<ii", _MAGIC, 2) + header
        offset_table_pos = len(head)
        data_pos = offset_table_pos + 8 * n_blocks
        f.write(head)
        off = data_pos
        for y0, z in blocks:
            f.write(struct.pack("<Q", off))
            off += 8 + len(z)
        for y0, z in blocks:
            f.write(struct.pack("<ii", y0, len(z)))
            f.write(z)


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

def _read_cstr(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end], end + 1


def read_exr(path):
    """Returns [H, W, C] float32 (C = channel count, RGB(A) ordered when the
    standard names are present)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    if version & (0x800 | 0x1000):
        raise ValueError(f"{path}: multi-part/deep EXR not supported")
    pos = 8
    channels = []
    comp = _NO_COMP
    dw = None
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            break
        typ, pos = _read_cstr(buf, pos)
        (sz,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        val = buf[pos:pos + sz]
        pos += sz
        if name == b"channels":
            cp = 0
            while val[cp] != 0:
                cn, cp = _read_cstr(val, cp)
                ptype, _, _, _ = struct.unpack_from("<iiii", val, cp)
                cp += 16
                channels.append((cn.decode(), ptype))
        elif name == b"compression":
            comp = val[0]
        elif name == b"dataWindow":
            dw = struct.unpack("<iiii", val)
    if dw is None:
        raise ValueError(f"{path}: missing dataWindow")
    if comp not in (_NO_COMP, _ZIPS_COMP, _ZIP_COMP):
        raise ValueError(f"{path}: compression {comp} not supported "
                         "(NONE/ZIP/ZIPS only)")
    W = dw[2] - dw[0] + 1
    H = dw[3] - dw[1] + 1
    rows_per = {_NO_COMP: 1, _ZIPS_COMP: 1, _ZIP_COMP: 16}[comp]
    n_blocks = (H + rows_per - 1) // rows_per
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    C = len(channels)
    out = np.zeros((H, W, C), np.float32)
    bytes_per = {_HALF: 2, _FLOAT: 4}
    line_bytes = sum(bytes_per[pt] * W for _, pt in channels)
    for off in offsets:
        y0, sz = struct.unpack_from("<ii", buf, off)
        y0 -= dw[1]
        z = buf[off + 8: off + 8 + sz]
        ny = min(rows_per, H - y0)
        expect = line_bytes * ny
        raw = z if sz == expect else _zip_post_decompress(zlib.decompress(z))
        p = 0
        for y in range(y0, y0 + ny):
            for ci, (cn, pt) in enumerate(channels):
                nb = bytes_per[pt] * W
                dt = np.float16 if pt == _HALF else np.float32
                out[y, :, ci] = np.frombuffer(
                    raw[p:p + nb], dt).astype(np.float32)
                p += nb
    # reorder alphabetical channel storage to RGB(A)
    names = [c for c, _ in channels]
    want = [n for n in ("R", "G", "B", "A") if n in names]
    if len(want) == len(names):
        idx = [names.index(n) for n in want]
        out = out[:, :, idx]
    return out
