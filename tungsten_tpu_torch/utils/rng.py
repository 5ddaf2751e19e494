"""Counter-based xxhash32 randomness, bit-exact with tungsten_tpu/utils/rng.py.

Every uint32 word is held in an int64 tensor (or a Python int) with a value
in [0, 2^32): PyTorch on the CPU has no add or shift for uint32.  Each
operation masks back to 32 bits, and each 32x32-bit multiply is split so
that no product passes 2^48 and nothing relies on signed overflow.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF

_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393


def u32(x):
    """An integer tensor (or Python int) as uint32 words held in int64.

    Negative values wrap as `astype(int32).astype(uint32)` does."""
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def _mul(a, c):
    """(a * c) mod 2^32 for a word `a` and a constant `c` < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _rotl17(x):
    return ((x << 17) & MASK32) | (x >> 15)


def _final(h):
    h = _mul(h ^ (h >> 15), _P2)
    h = _mul(h ^ (h >> 13), _P3)
    return h ^ (h >> 16)


def xxhash32(p):
    """xxhash32 of one word."""
    h = (u32(p) + _P5) & MASK32
    return _final(_mul(_rotl17(h), _P4))


def xxhash32_2(x, y):
    """xxhash32 of two words."""
    h = (u32(y) + _P5 + _mul(u32(x), _P3)) & MASK32
    return _final(_mul(_rotl17(h), _P4))


def xxhash32_3(x, y, z):
    """xxhash32 of three words."""
    h = (u32(z) + _P5 + _mul(u32(x), _P3)) & MASK32
    h = _mul(_rotl17(h), _P4)
    h = (h + _mul(u32(y), _P3)) & MASK32
    return _final(_mul(_rotl17(h), _P4))


def xxhash32_4(x, y, z, w):
    """xxhash32 of four words."""
    h = (u32(w) + _P5 + _mul(u32(x), _P3)) & MASK32
    h = _mul(_rotl17(h), _P4)
    h = (h + _mul(u32(y), _P3)) & MASK32
    h = _mul(_rotl17(h), _P4)
    h = (h + _mul(u32(z), _P3)) & MASK32
    return _final(_mul(_rotl17(h), _P4))


def u32_to_uniform(u):
    """Word -> float32 in [0, 1) from its top 24 bits (exact in float32)."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(key, ctr):
    """The ctr-th U[0,1) variate of stream `key` (broadcasting words)."""
    return u32_to_uniform(xxhash32_2(key, ctr))


def uniform2(key, ctr):
    """The variates at counters 2 ctr and 2 ctr + 1 of stream `key`."""
    c = (2 * u32(ctr)) & MASK32
    return uniform(key, c), uniform(key, (c + 1) & MASK32)


def normal2(key, ctr):
    """A Box-Muller pair of N(0, 1) variates from uniform2(key, ctr)."""
    u1, u2 = uniform2(key, ctr)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    a = 2.0 * math.pi * u2
    return r * torch.cos(a), r * torch.sin(a)


def bernoulli_pm1(u):
    """+-1 with p = 1/2 from a uniform."""
    return torch.where(u < 0.5, -1.0, 1.0).to(torch.float32)
