"""Quads and cubes as one SoA table, intersected by brute force as a batched
[R, P] computation (the quad and cube parts of
tungsten_tpu/models/primitives.py).

Conventions match the Tungsten scene format: a quad is the unit square in
xz, centred, transformed; a cube is the [-s, s] box of its transform.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.vecmath import dot

PRIM_QUAD = 0
PRIM_CUBE = 2
INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class PrimitiveSoA:
    kind: torch.Tensor  # [P] int64
    p0: torch.Tensor  # [P, 3] quad base corner / cube centre
    e0: torch.Tensor  # [P, 3] quad edges
    e1: torch.Tensor
    n: torch.Tensor  # [P, 3] quad normal
    rot: torch.Tensor  # [P, 3, 3] cube rotation, world -> local
    scale: torch.Tensor  # [P, 3] cube half extents
    area: torch.Tensor  # [P]
    emission: torch.Tensor  # [P, 3]
    bsdf: torch.Tensor  # [P] int64
    int_medium: torch.Tensor  # [P] int64, -1 = keep the current medium
    ext_medium: torch.Tensor  # [P] int64


def build_soa(prims, device):
    """Table from parsed primitive dicts (kind, transform 4x4, emission,
    bsdf, int_medium, ext_medium), computed in numpy as the JAX package
    does."""
    P = max(len(prims), 1)
    kind = np.zeros(P, np.int64)
    p0, e0, e1, n = (np.zeros((P, 3), np.float32) for _ in range(4))
    rot = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    scale = np.zeros((P, 3), np.float32)
    area = np.zeros(P, np.float32)
    emission = np.zeros((P, 3), np.float32)
    bsdf = np.zeros(P, np.int64)
    int_m = -np.ones(P, np.int64)
    ext_m = -np.ones(P, np.int64)
    for i, pr in enumerate(prims):
        kind[i] = pr["kind"]
        tf = np.asarray(pr["transform"], np.float32)
        pos = tf[:3, 3]
        if pr["kind"] == PRIM_QUAD:
            ed0 = tf[:3, :3] @ np.array([1.0, 0, 0], np.float32)
            ed1 = tf[:3, :3] @ np.array([0, 0, 1.0], np.float32)
            base = pos - (0.5 * ed0 + 0.5 * ed1)
            nn = np.cross(ed1, ed0)
            a = np.linalg.norm(nn)
            p0[i], e0[i], e1[i], n[i] = base, ed0, ed1, nn / max(a, 1e-20)
            area[i] = a
        elif pr["kind"] == PRIM_CUBE:
            s = np.linalg.norm(tf[:3, :3], axis=0)
            p0[i], scale[i] = pos, 0.5 * s
            rot[i] = (tf[:3, :3] / s[None, :]).T
            area[i] = 8.0 * (s[1] * s[2] + s[2] * s[0] + s[0] * s[1]) / 4.0
        else:
            raise NotImplementedError(
                f"primitive kind {pr['kind']} is not ported")
        emission[i] = np.asarray(pr.get("emission", (0.0, 0.0, 0.0)),
                                 np.float32)
        bsdf[i] = pr.get("bsdf", 0)
        int_m[i] = pr.get("int_medium", -1)
        ext_m[i] = pr.get("ext_medium", -1)

    def t(a):
        return torch.from_numpy(a).to(device)
    return PrimitiveSoA(kind=t(kind), p0=t(p0), e0=t(e0), e1=t(e1), n=t(n),
                        rot=t(rot), scale=t(scale), area=t(area),
                        emission=t(emission), bsdf=t(bsdf),
                        int_medium=t(int_m), ext_medium=t(ext_m))


def _isect_quad(s, ro, rd):
    """[R, P] hit distance, back-side flag and normal against every quad."""
    n = s.n[None]  # [1, P, 3]
    n_dot_w = dot(rd[:, None, :], n)
    t = dot(n, s.p0[None] - ro[:, None, :]) / torch.where(
        n_dot_w.abs() < 1e-6, 1e30, n_dot_w)
    v = ro[:, None, :] + t[..., None] * rd[:, None, :] - s.p0[None]
    l0 = dot(v, s.e0[None]) / torch.clamp(dot(s.e0, s.e0), min=1e-20)
    l1 = dot(v, s.e1[None]) / torch.clamp(dot(s.e1, s.e1), min=1e-20)
    valid = ((n_dot_w.abs() >= 1e-6) & (l0 >= 0) & (l0 <= 1) & (l1 >= 0)
             & (l1 <= 1))
    return torch.where(valid, t, INF), n_dot_w >= 0.0, n.expand(
        ro.shape[0], -1, -1)


def _rot_apply(rot, v):
    """rot [P, 3, 3] @ v [R, P, 3] per prim, written out in float32."""
    return (rot[None, :, :, 0] * v[..., 0:1] + rot[None, :, :, 1] * v[..., 1:2]
            + rot[None, :, :, 2] * v[..., 2:3])


def _isect_cube(s, ro, rd):
    """[R, P] hit distance, back-side flag and normal against every cube."""
    P = s.kind.shape[0]
    p = _rot_apply(s.rot, ro[:, None, :] - s.p0[None])
    d = _rot_apply(s.rot, rd[:, None, :].expand(-1, P, -1))
    inv_d = torch.clamp(1.0 / torch.where(d.abs() < 1e-7,
                                          torch.where(d < 0, -1e-7, 1e-7), d),
                        -1e7, 1e7)
    rel_min = (-s.scale[None] - p) * inv_d
    rel_max = (s.scale[None] - p) * inv_d
    tmin_ax = torch.minimum(rel_min, rel_max)
    tmax_ax = torch.maximum(rel_min, rel_max)
    t_entry = tmin_ax.amax(dim=-1)
    tmin = torch.clamp(t_entry, min=1e-4)
    tmax = tmax_ax.amin(dim=-1)
    hit = (tmin <= tmax) & (tmax > 1e-4)
    back = ~(t_entry > 1e-4)
    t = torch.where(back, tmax, t_entry)
    # the normal's axis: max tmin (entry) or min tmax (exit)
    ax = torch.where(back, tmax_ax.argmin(dim=-1), tmin_ax.argmax(dim=-1))
    onehot = (ax[..., None] == torch.arange(3, device=ro.device)).to(
        d.dtype)
    sign = -torch.sign((d * onehot).sum(dim=-1))
    n_local = onehot * sign[..., None]
    # rot^T n_local (local -> world)
    rot_t = s.rot.transpose(1, 2)
    normal = _rot_apply(rot_t, n_local)
    return torch.where(hit, t, INF), back, normal


def intersect(soa, ro, rd, near, far):
    """Closest hit of each ray ro, rd [R, 3] within (near, far).

    Returns dict(hit, t (far on a miss), prim, normal (geometric), back_side).
    """
    tq, bq, nq = _isect_quad(soa, ro, rd)
    tc, bc, nc = _isect_cube(soa, ro, rd)
    is_q = soa.kind[None] == PRIM_QUAD
    t = torch.where(is_q, tq, torch.where(soa.kind[None] == PRIM_CUBE, tc,
                                          INF))
    back = torch.where(is_q, bq, bc)
    nrm = torch.where(is_q[..., None], nq, nc)
    far = torch.as_tensor(far, dtype=torch.float32, device=ro.device)
    if far.dim() == 1:
        far = far[:, None]
    t = torch.where((t > near) & (t < far), t, INF)
    idx = t.argmin(dim=-1)
    t_min = t.gather(1, idx[:, None])[:, 0]
    hit = t_min < INF
    rows = torch.arange(ro.shape[0], device=ro.device)
    return {"hit": hit,
            "t": torch.where(hit, t_min, far.reshape(-1).expand_as(t_min)),
            "prim": idx, "normal": nrm[rows, idx], "back_side":
                back[rows, idx]}


def sample_direct(soa, li, p, u1, u2):
    """Area-sample quad light `li` [R] from points p [R, 3].

    Returns (direction, distance, solid-angle pdf, valid)."""
    q = soa.p0[li] + u1[:, None] * soa.e0[li] + u2[:, None] * soa.e1[li]
    dq = q - p
    r_sq = torch.clamp(dot(dq, dq), min=1e-12)
    dist = torch.sqrt(r_sq)
    dq = dq / dist[:, None]
    n = soa.n[li]
    cos_q = -dot(n, dq)
    pdf = r_sq / (torch.clamp(cos_q, min=1e-6)
                  * torch.clamp(soa.area[li], min=1e-12))
    valid = (dot(n, p - soa.p0[li]) > 0.0) & (cos_q > 1e-6)
    return dq, dist, pdf, valid


def direct_pdf(soa, li, w, t_hit):
    """Solid-angle pdf of hitting quad light `li` along w at distance t_hit."""
    cos_theta = dot(soa.n[li], w).abs()
    return t_hit * t_hit / (torch.clamp(cos_theta, min=1e-6)
                            * torch.clamp(soa.area[li], min=1e-12))
