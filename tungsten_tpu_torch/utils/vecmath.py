"""Vector and frame math on trailing-axis-3 float32 tensors
(counterpart of tungsten_tpu/utils/vecmath.py).

Dot products are written out as x + y + z rather than `sum(-1)`, so the
rounding is the same on every device and batch size.  The tangent frame is
the branchless Duff et al. 2017 basis: the frame decides which GP
realization a ray samples, so it must match the reference exactly.
"""
from __future__ import annotations

import torch


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def length(a):
    # the floor keeps |a| = 0 finite, as the JAX package does
    return torch.sqrt(torch.clamp(dot(a, a), min=1e-24))


def normalize(a):
    return a / length(a)[..., None]


def safe_normalize(a):
    """a / |a|, or (1, 0, 0) where |a| <= 1e-20."""
    n = length(a)
    safe = n > 1e-20
    out = a / torch.where(safe, n, 1.0)[..., None]
    fallback = torch.zeros_like(a)
    fallback[..., 0] = 1.0
    return torch.where(safe[..., None], out, fallback)


def tangent_frame(n):
    """(tangent, bitangent) of the Duff et al. 2017 basis; `n` normalized."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def frame_to_local(t, b, n, v):
    """World vector -> (tangent, bitangent, normal) coordinates."""
    return torch.stack([dot(t, v), dot(b, v), dot(n, v)], dim=-1)


def frame_to_world(t, b, n, v):
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def inverse3(m):
    """Inverse of [R, 3, 3] matrices by the adjugate over the determinant
    (no host sync, unlike torch.linalg.inv's error check on CUDA)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    c00, c01, c02 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * c00 + b * c01 + c * c02
    adj = torch.stack([
        torch.stack([c00, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([c01, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([c02, b * g - a * h, a * e - b * d], dim=-1)], dim=-2)
    return adj / det[:, None, None]


def mat_vec(m, v):
    """[R, 3, 3] (or [1, 3, 3]) @ [R, 3] with the sums written out."""
    return (m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2]
            + m[:, :, 2] * v[:, 2:3])
