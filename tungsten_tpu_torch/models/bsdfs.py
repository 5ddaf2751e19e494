"""BSDFs in a small table, evaluated per hit by row index (the lambert,
null, mirror and forward kinds of tungsten_tpu/models/bsdfs.py).

All functions work in the local shading frame (+z = normal) and are batched
over the leading dimensions of `bi` / `wi`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# kind numbers are the JAX package's, so converted tables stay valid
NULL = 0
LAMBERT = 1
MIRROR = 2
FORWARD = 6
KINDS = (NULL, LAMBERT, MIRROR, FORWARD)
SPECULAR_KINDS = (MIRROR,)  # the ported kinds of the JAX SPECULAR_KINDS


@dataclasses.dataclass(frozen=True)
class BsdfTable:
    kind: torch.Tensor  # [B] int64
    albedo: torch.Tensor  # [B, 3]
    kinds: tuple  # the kinds again, on the host, for static queries


def build_table(bsdfs, device):
    """Table from parsed rows ({"kind", "albedo"})."""
    for b in bsdfs:
        if b["kind"] not in KINDS:
            raise NotImplementedError(f"bsdf kind {b['kind']} is not ported")
    rows = bsdfs or [{"kind": NULL, "albedo": (1.0, 1.0, 1.0)}]
    return BsdfTable(
        kind=torch.tensor([b["kind"] for b in rows], dtype=torch.int64,
                          device=device),
        albedo=torch.tensor([list(b["albedo"]) for b in rows],
                            dtype=torch.float32, device=device),
        kinds=tuple(int(b["kind"]) for b in rows))


def is_forward(table, bi):
    return table.kind[bi] == FORWARD


def is_null(table, bi):
    return table.kind[bi] == NULL


def is_pure_specular(table, bi):
    return table.kind[bi] == MIRROR


def cosine_hemisphere(u1, u2):
    phi = u1 * 2.0 * math.pi
    r = torch.sqrt(u2)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u2, min=1e-12))], dim=-1)


def eval_bsdf(table, bi, wi, wo):
    """f(wi, wo) * |cos(wo)|; the Dirac kinds (null, mirror, forward)
    give 0."""
    k = table.kind[bi]
    czi, czo = wi[..., 2], wo[..., 2]
    f_lam = table.albedo[bi] / math.pi * torch.clamp(czo, min=0.0)[..., None]
    same_side = (czi > 0) & (czo > 0)
    return torch.where(((k == LAMBERT) & same_side)[..., None], f_lam, 0.0)


def pdf_bsdf(table, bi, wi, wo):
    """Solid-angle pdf of sample_bsdf producing wo."""
    k = table.kind[bi]
    p_cos = torch.clamp(wo[..., 2], min=0.0) / math.pi
    return torch.where((k == LAMBERT) & (wi[..., 2] > 0), p_cos, 0.0)


def sample_bsdf(table, bi, wi, u):
    """Sample wo given wi; u [..., 5] uniforms.  Returns dict(wo, weight
    [..., 3], pdf, specular, valid)."""
    k = table.kind[bi]
    k = k.expand(wi.shape[:-1])
    albedo = table.albedo[bi].expand(wi.shape)
    wo_d = cosine_hemisphere(u[..., 0], u[..., 1])
    pdf_d = torch.clamp(wo_d[..., 2], min=1e-6) / math.pi
    lam = k == LAMBERT
    fwd = k == FORWARD
    mir = k == MIRROR
    wo_m = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
    wo = torch.where(fwd[..., None], -wi,
                     torch.where(mir[..., None], wo_m, wo_d))
    weight = torch.where((lam | mir)[..., None], albedo,
                         torch.where(fwd[..., None], 1.0, 0.0))
    pdf = torch.where(lam, pdf_d, 1.0)
    # a mirror reflects from either side
    valid = torch.where(lam, wi[..., 2] > 0, k != NULL)
    return {"wo": wo, "weight": weight, "pdf": pdf, "specular": fwd | mir,
            "valid": valid}
