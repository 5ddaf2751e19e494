"""Visible-normal sampling of the GGX and Beckmann microfacet
distributions (the part of tungsten_tpu/models/ndf.py that the media's
`beckmann` and `ggx` normal methods use), in the local shading frame: +z
is the macro normal and wi points away from the surface.  alpha is the
isotropic roughness."""
from __future__ import annotations

import math

import torch

GGX = 0
BECKMANN = 1


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True),
                                      min=1e-24))


def sample_vndf_ggx(wi, alpha, u1, u2):
    """Heitz 2018 GGX visible-normal sampling; wi [..., 3] with wi_z > 0,
    alpha, u1, u2 [...]."""
    v = _unit(torch.stack([alpha * wi[..., 0], alpha * wi[..., 1],
                           wi[..., 2]], dim=-1))
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    t1 = torch.where(
        lensq[..., None] > 1e-7,
        torch.stack([-v[..., 1] * inv, v[..., 0] * inv,
                     torch.zeros_like(inv)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device))
    t2v = _cross(v, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-12)) \
        + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-12))
    nh = p1[..., None] * t1 + p2[..., None] * t2v + p3[..., None] * v
    m = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                     torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return _unit(m)


def sample_vndf_beckmann(wi, alpha, u1, u2):
    """Beckmann normals by Walter 2007 D-sampling (wi is not used: the
    JAX package samples the full distribution)."""
    a2 = alpha * alpha
    t2 = -a2 * torch.log(torch.clamp(1.0 - u1, min=1e-12))
    cz = 1.0 / torch.sqrt(1.0 + t2)
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([sz * torch.cos(phi), sz * torch.sin(phi), cz],
                       dim=-1)
