"""The BRDF phase function: a GPIS medium scatters like a micro-surface
whose shading normal is the sampled GP gradient (PHASE_BRDF of
tungsten_tpu/models/phase.py).  `wi` is the propagation direction."""
from __future__ import annotations

from ..utils.vecmath import (frame_to_local, frame_to_world, safe_normalize,
                             tangent_frame)
from . import bsdfs


def _local(wi, wo, aniso):
    n = safe_normalize(aniso)
    t, b = tangent_frame(n)
    wil = safe_normalize(frame_to_local(t, b, n, -wi))
    wol = safe_normalize(frame_to_local(t, b, n, wo))
    return wil, wol


def eval_phase(med, table, wi, wo, aniso):
    wil, wol = _local(wi, wo, aniso)
    return bsdfs.eval_bsdf(table, med.phase_bsdf, wil, wol)


def pdf_phase(med, table, wi, wo, aniso):
    wil, wol = _local(wi, wo, aniso)
    return bsdfs.pdf_bsdf(table, med.phase_bsdf, wil, wol)


def phase_is_specular(med, table):
    """Whether the phase function's BSDF is a Dirac lobe (a static query
    on the table's host-side kinds)."""
    return table.kinds[med.phase_bsdf] in bsdfs.SPECULAR_KINDS


def sample_phase(med, table, wi, aniso, u):
    """Sample wo.  Returns dict(w, weight [R, 3], pdf, specular, valid)."""
    n = safe_normalize(aniso)
    t, b = tangent_frame(n)
    wil = safe_normalize(frame_to_local(t, b, n, -wi))
    s = bsdfs.sample_bsdf(table, med.phase_bsdf, wil, u)
    w = safe_normalize(frame_to_world(t, b, n, s["wo"]))
    return {"w": w, "weight": s["weight"], "pdf": s["pdf"],
            "specular": s["specular"], "valid": s["valid"]}
