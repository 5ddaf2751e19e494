"""Sparse-convolution noise, batched over rays: the world-space 3D branch of
tungsten_tpu/ops/sparse_conv.py.

A noise value at a point is a pure function of (point, cell lattice, seed):
each of the 3^3 neighbour cells is hash-keyed, carries `impulse_count`
Bernoulli-weighted impulses and adds a splat term; the sum is normalized by
the analytic noise variance.  The JAX package writes these functions per
point and vmaps them; here the ray batch is the leading dimension.

This is the evaluator behind the gradient (the conditioned-Gaussian normal
at a crossing).  The march evaluates values through ops/sparse_conv_fast.py
and kernel K1.  Not ported yet: conditioning (renewal / renewal+ with
per-path realizations), isotropic and 1D sampling, multi-resolution noise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import rng
from ..utils.vecmath import dot

CTXT_GLOBAL = "global"
CTXT_RENEWAL_PLUS = "renewal+"
CTXT_RENEWAL = "renewal"
CTXT_NONE = "none"

# (dx, dy, dz) for dx, dy, dz in (-1, 0, 1)
_CELL_OFFSETS_3D = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)]


@dataclasses.dataclass(frozen=True)
class GP:
    """Mean + covariance."""
    mean: object
    cov: object

    def mean_and_id(self, p):
        """Mean value and the id of the GP that supplies it (always 0: a
        single mean, no CSG additional mean)."""
        return self.mean.mean(p), torch.zeros(p.shape[:-1], dtype=torch.int64,
                                              device=p.device)

    def mean_grad_by_id(self, p, gp_id):
        """Gradient of the mean that supplied the value (with one mean,
        that mean's)."""
        return self.mean.grad(p)


@dataclasses.dataclass(frozen=True)
class SparseConvConfig:
    global_seed: int  # a uint32 word
    impulse_density: torch.Tensor  # scalar float32
    ctxt: str = CTXT_RENEWAL_PLUS
    use_single_realization: bool = False
    impulse_count: int = 3

    @property
    def activate_conditioning(self):
        return (not self.use_single_realization
                and self.ctxt in (CTXT_RENEWAL, CTXT_RENEWAL_PLUS))


def compute_seed(cfg, pss, scene_seed):
    """Realization seed per ray from (pixel.x, pixel.y, spp, bounce) words
    pss [R, 4] and the scene seed; one shared seed for a single realization.
    Under the Global context all bounces share one realization."""
    if cfg.use_single_realization:
        return torch.full(pss.shape[:-1], cfg.global_seed, dtype=torch.int64,
                          device=pss.device)
    w = torch.zeros_like(pss[..., 3]) if cfg.ctxt == CTXT_GLOBAL \
        else pss[..., 3]
    h = rng.xxhash32_4(pss[..., 0], pss[..., 1], pss[..., 2], w)
    return (cfg.global_seed + h + rng.xxhash32(scene_seed)) & rng.MASK32


def _noise3d(cfg, cov, p, seed, kernel_radius):
    """27-cell x K splat sum at p [R, 3] with seeds [R]; returns
    (val [R], grad [R, 3])."""
    dev = p.device
    K = cfg.impulse_count
    p_grid = p / kernel_radius
    base = torch.floor(p_grid)
    frac = p_grid - base
    offs = torch.tensor(_CELL_OFFSETS_3D, dtype=torch.int64, device=dev)
    cells = rng.u32(base.to(torch.int32)[:, None, :] + offs)  # [R, 27, 3]
    # cells are keyed in (z, y, x, seed) order
    key = (rng.xxhash32_4(cells[..., 2], cells[..., 1], cells[..., 0],
                          seed[:, None]) + 1) & rng.MASK32  # [R, 27]
    ctr = 4 * torch.arange(K, dtype=torch.int64, device=dev)  # [K]
    key = key[:, :, None]
    u = torch.stack([rng.uniform(key, ctr + j) for j in range(3)],
                    dim=-1)  # [R, 27, K, 3]
    w = rng.bernoulli_pm1(rng.uniform(key, ctr + 3))  # [R, 27, K]
    d = (frac[:, None, :] - offs.to(torch.float32))[:, :, None, :] - u
    inside = dot(d, d) < 1.0
    val, grad = cov.splat3_val_grad(kernel_radius * d)
    wm = torch.where(inside, w, 0.0)
    return ((wm * val).sum(dim=(1, 2)),
            (wm[..., None] * grad).sum(dim=(1, 2)))


def eval_noise3d_world(cfg, gp, p, seed):
    """Normalized world-space 3D noise and its gradient at p [R, 3].

    A stationary covariance samples world space at spatial scale 1, so the
    multi-resolution seed offset is 0 and the cell radius is the splat's."""
    cov = gp.cov
    radius = cov.splat_radius()
    val, grad = _noise3d(cfg, cov, p, seed, radius)
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, radius))
    return val / norm, grad / norm


def eval_value(cfg, gp, p, pss, scene_seed):
    """GPIS value f(p) = amplitude * noise + mean; returns (val, gp_id)."""
    seed = compute_seed(cfg, pss, scene_seed)
    nv, _ = eval_noise3d_world(cfg, gp, p, seed)
    m, gp_id = gp.mean_and_id(p)
    return gp.cov.amplitude(p) * nv + m, gp_id


def eval_gradient(cfg, gp, p, pss, scene_seed):
    """GPIS gradient at p [R, 3]: amplitude * noise gradient + mean
    gradient."""
    seed = compute_seed(cfg, pss, scene_seed)
    _, ng = eval_noise3d_world(cfg, gp, p, seed)
    return gp.cov.amplitude(p)[..., None] * ng + gp.mean.grad(p)
