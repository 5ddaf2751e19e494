"""The phase functions of a GPIS medium (tungsten_tpu/models/phase.py):
the BRDF phase function, under which the medium scatters like a
micro-surface whose shading normal is the sampled GP gradient
(PHASE_BRDF), and the isotropic one (PHASE_ISOTROPIC), which the JAX
package's image-level gradient checks put in its place.  `wi` is the
propagation direction."""
from __future__ import annotations

import math

import torch

from ..utils.vecmath import (frame_to_local, frame_to_world, safe_normalize,
                             tangent_frame)
from . import bsdfs

PHASE_BRDF = "brdf"
PHASE_ISOTROPIC = "isotropic"
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def _uniform_sphere(u1, u2):
    phi = u1 * 2.0 * math.pi
    z = u2 * 2.0 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _local(wi, wo, aniso):
    n = safe_normalize(aniso)
    t, b = tangent_frame(n)
    wil = safe_normalize(frame_to_local(t, b, n, -wi))
    wol = safe_normalize(frame_to_local(t, b, n, wo))
    return wil, wol


def eval_phase(med, table, wi, wo, aniso):
    if med.phase_kind == PHASE_ISOTROPIC:
        return torch.full(wi.shape[:-1] + (3,), INV_FOUR_PI,
                          device=wi.device)
    wil, wol = _local(wi, wo, aniso)
    return bsdfs.eval_bsdf(table, med.phase_bsdf, wil, wol)


def pdf_phase(med, table, wi, wo, aniso):
    if med.phase_kind == PHASE_ISOTROPIC:
        return torch.full(wi.shape[:-1], INV_FOUR_PI, device=wi.device)
    wil, wol = _local(wi, wo, aniso)
    return bsdfs.pdf_bsdf(table, med.phase_bsdf, wil, wol)


def phase_is_specular(med, table):
    """Whether the phase function's BSDF is a Dirac lobe (a static query
    on the table's host-side kinds)."""
    return (med.phase_kind == PHASE_BRDF
            and table.kinds[med.phase_bsdf] in bsdfs.SPECULAR_KINDS)


def sample_phase(med, table, wi, aniso, u):
    """Sample wo.  Returns dict(w, weight [R, 3], pdf, specular, valid)."""
    if med.phase_kind == PHASE_ISOTROPIC:
        shape = wi.shape[:-1]
        return {"w": _uniform_sphere(u[..., 0], u[..., 1]),
                "weight": torch.ones(shape + (3,), device=wi.device),
                "pdf": torch.full(shape, INV_FOUR_PI, device=wi.device),
                "specular": torch.zeros(shape, dtype=torch.bool,
                                        device=wi.device),
                "valid": torch.ones(shape, dtype=torch.bool,
                                    device=wi.device)}
    n = safe_normalize(aniso)
    t, b = tangent_frame(n)
    wil = safe_normalize(frame_to_local(t, b, n, -wi))
    s = bsdfs.sample_bsdf(table, med.phase_bsdf, wil, u)
    w = safe_normalize(frame_to_world(t, b, n, s["wo"]))
    return {"w": w, "weight": s["weight"], "pdf": s["pdf"],
            "specular": s["specular"], "valid": s["valid"]}
