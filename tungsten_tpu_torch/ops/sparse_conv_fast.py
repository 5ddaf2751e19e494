"""The march-step evaluator: value_at(t) along a ray batch, with the raw
lattice sum in kernel K1 (stationary, world-space branch of
tungsten_tpu/ops/sparse_conv_fast.py::make_value_at).

Everything that does not change along a ray (seeds, the splat quadratic
form, the cell radius, the variance normalization) is computed once per
batch, so each step is K1 plus a few elementwise ops on [R] tensors.
"""
from __future__ import annotations

import torch

from ..kernels import noise3d
from . import sparse_conv as sc


def make_value_at(cfg, gp, ro, rd, pss, scene_seed):
    """value_at(t [R]) -> (f [R], gp_id [R]) for the rays ro + t * rd."""
    cov = gp.cov
    seed0 = sc.compute_seed(cfg, pss, scene_seed)
    kr = cov.splat_radius()
    # K1 takes its scalars by value: one host read for all four; the splat
    # form is diagonal, so its off-diagonal entries are 0
    *diag, kr_f = torch.cat([cov.splat_form(), kr[None]]).tolist()
    m6 = diag + [0.0, 0.0, 0.0]
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, kr))
    K = cfg.impulse_count

    def value_at(t):
        p = ro + t[:, None] * rd
        total = noise3d.noise3d_sum_s(p, seed0, kr_f, m6, K)
        mean, gp_id = gp.mean_and_id(p)
        return cov.amplitude(p) * (total / norm) + mean, gp_id

    return value_at
