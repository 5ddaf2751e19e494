"""Image output: PNG (own encoder over zlib, with the linear, gamma,
Reinhard and filmic tone curves) and PFM (linear float), byte for byte as
tungsten_tpu/io/image.py writes them.

Kept in the port so that it loads nothing of the JAX package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_gamma(img, exposure=1.0, gamma=2.2):
    x = np.clip(np.asarray(img, np.float64) * exposure, 0.0, None)
    return np.clip(x ** (1.0 / gamma), 0.0, 1.0)


def tonemap_reinhard(img, exposure=1.0, gamma=2.2):
    x = np.clip(np.asarray(img, np.float64) * exposure, 0.0, None)
    return np.clip((x / (1.0 + x)) ** (1.0 / gamma), 0.0, 1.0)


def tonemap_filmic(img, exposure=1.0):
    """Hejl-Burgess-Dawson filmic curve (the reference Tonemap::Filmic)."""
    x = np.maximum(np.asarray(img, np.float64) * exposure - 0.004, 0.0)
    return np.clip((x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06),
                   0.0, 1.0)


CURVES = {"linear": lambda x: np.clip(x, 0, 1), "gamma": tonemap_gamma,
          "reinhard": tonemap_reinhard, "filmic": tonemap_filmic}


def write_png(path, img, tonemap=True, curve="gamma"):
    """img: [H, W, 3] (or [H, W]) linear float, tone-mapped by `curve`
    (unless `tonemap` is false) to 8-bit RGB; or uint8, written as is."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        if tonemap:
            a = CURVES.get(curve, tonemap_gamma)(a)
        a = (np.clip(a, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return (struct.pack(">I", len(data)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_pfm(path, img):
    """img: [H, W, 3] float, stored little-endian, bottom row first."""
    a = np.asarray(img, np.float32)
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if a.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(a).tobytes())


def read_pfm(path):
    """[H, W, C] float32 from a PFM file (C = 3 for PF, 1 for Pf)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    c = 3 if header == b"PF" else 1
    return np.flipud(data.reshape(h, w, c))
