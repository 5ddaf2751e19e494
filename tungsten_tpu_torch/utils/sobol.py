"""Sobol path sampling.

The reference's SobolPathSampler (src/core/sampling/SobolPathSampler.hpp:12-33)
draws a scrambled Sobol sequence per pixel with a per-pixel permutation of the
sample index.  The equivalent here: one UNSCRAMBLED Sobol point per
sample index is generated host-side (scipy.stats.qmc), shipped to the device
as a [D] vector, and each pixel decorrelates it with a Cranley-Patterson
rotation by its own hash-derived offset — u = frac(sobol[dim] + xi(pixel)).
This preserves Sobol's per-pixel stratification, costs one gather per draw,
and keeps the whole path deterministic in (pixel, sample index), matching the
reference's seekability contract.

Dimension budget: QMC_BOUNCES bounces x 64 slots; deeper bounces fall back to
the hash sampler (standard "padded Sobol").

A copy of tungsten_tpu/utils/sobol.py (numpy and scipy only), kept in the
port so that it loads nothing of the JAX package; models/integrator.py's
`trace(..., qmc=)` draws from it as the JAX path tracer does.
"""
from __future__ import annotations

import numpy as np

QMC_BOUNCES = 4
SLOTS = 64
DIMS = QMC_BOUNCES * SLOTS

_sobol_cache = {}


def sobol_point(index: int) -> np.ndarray:
    """The index-th point of the DIMS-dimensional Sobol sequence [D]f32."""
    from scipy.stats import qmc
    eng = _sobol_cache.get("eng")
    if eng is None or _sobol_cache.get("next", -1) != index:
        eng = qmc.Sobol(d=DIMS, scramble=False)
        if index > 0:
            eng.fast_forward(index)
        _sobol_cache["eng"] = eng
    pt = eng.random(1)[0].astype(np.float32)
    _sobol_cache["next"] = index + 1
    return pt
