"""Mesh SDF baking (tungsten_tpu/ops/mesh_sdf.py): the signed distance of
a triangle mesh on a dense grid, for the `mesh` mean type, which serves it
as a TabulatedMean.

For every grid point: the unsigned distance to the nearest triangle
(point-triangle closest point) and, for the sign, the generalized winding
number (solid angle / 4 pi summed over the triangles, van Oosterom &
Strackee): inside where it exceeds 1/2.  A brute-force O(points x
triangles) pass in chunks of points on the caller's device, at scene
load.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# points per chunk of the bake: [chunk, T] pair tensors
_CHUNK = 1024


def _sum3(a, b):
    return (a * b).sum(dim=-1)


def _point_tri_dist_sq(p, a, b, c):
    """Squared distance of points p [P, 3] to triangles (a, b, c) [T, 3]:
    [P, T]."""
    p = p[:, None, :]
    ab, ac, ap = b - a, c - a, p - a
    d1 = _sum3(ab, ap)
    d2 = _sum3(ac, ap)
    bp = p - b
    d3 = _sum3(ab, bp)
    d4 = _sum3(ac, bp)
    cp = p - c
    d5 = _sum3(ab, cp)
    d6 = _sum3(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-20)
    v = torch.clamp(vb / denom, 0.0, 1.0)
    w = torch.clamp(vc / denom, 0.0, 1.0)
    q_face = a + v[..., None] * ab + w[..., None] * ac

    def edge_q(e0, ev):
        t = torch.clamp(_sum3(p - e0, ev)
                        / torch.clamp(_sum3(ev, ev), min=1e-20), 0.0, 1.0)
        return e0 + t[..., None] * ev

    def d2_to(q):
        return ((p - q) ** 2).sum(dim=-1)

    in_face = (va >= 0) & (vb >= 0) & (vc >= 0)
    d_edges = torch.minimum(d2_to(edge_q(a, ab)),
                            torch.minimum(d2_to(edge_q(a, ac)),
                                          d2_to(edge_q(b, c - b))))
    return torch.where(in_face, d2_to(q_face), d_edges)


def _winding(p, a, b, c):
    """Each triangle's winding-number contribution at points p: [P, T]."""
    p = p[:, None, :]
    va, vb, vc = a - p, b - p, c - p
    la = torch.linalg.norm(va, dim=-1)
    lb = torch.linalg.norm(vb, dim=-1)
    lc = torch.linalg.norm(vc, dim=-1)
    num = _sum3(va, torch.linalg.cross(vb, vc, dim=-1))
    den = (la * lb * lc + _sum3(va, vb) * lc + _sum3(vb, vc) * la
           + _sum3(vc, va) * lb)
    return torch.atan2(num, den) / (2.0 * math.pi)


def bake_mesh_sdf(pos, tris, res=64, pad=0.15, signed=True, device="cpu"):
    """Returns (grid [res, res, res], bounds_min [3], bounds_max [3]) as
    numpy float32; grid[i, j, k] indexed x, y, z like TabulatedMean."""
    pos = np.asarray(pos, np.float32)
    tris = np.asarray(tris, np.int64)
    tri = [torch.as_tensor(pos[tris[:, k]], device=device) for k in range(3)]
    bmin = pos.min(0)
    bmax = pos.max(0)
    ext = (bmax - bmin).max()
    bmin = bmin - pad * ext
    bmax = bmax + pad * ext
    axes = [np.linspace(bmin[k], bmax[k], res, dtype=np.float32)
            for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = torch.as_tensor(np.stack([gx, gy, gz], -1).reshape(-1, 3),
                          device=device)
    out = []
    for i in range(0, pts.shape[0], _CHUNK):
        p = pts[i:i + _CHUNK]
        d = torch.sqrt(torch.clamp(_point_tri_dist_sq(p, *tri).amin(dim=1),
                                   min=0.0))
        if signed:
            w = _winding(p, *tri).sum(dim=1)
            d = torch.where(w > 0.5, -d, d)
        out.append(d)
    grid = torch.cat(out).cpu().numpy().reshape(res, res, res)
    return (grid.astype(np.float32), bmin.astype(np.float32),
            bmax.astype(np.float32))
