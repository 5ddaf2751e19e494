"""Sparse-convolution noise, batched over rays: the world-space 3D branch
(stationary, and the multi-resolution levels of a nonstationary
covariance) and the 1D (along-ray) branch of tungsten_tpu/ops/sparse_conv.py.

A noise value at a point is a pure function of (point, cell lattice, seed):
each neighbour cell (3^3 in 3D, 3 along the ray in 1D) is hash-keyed,
carries `impulse_count` Bernoulli-weighted impulses and adds a splat term;
the sum is normalized by the analytic noise variance.  The JAX package
writes these functions per point and vmaps them; here the ray batch is the
leading dimension.

These are the evaluators behind the gradient (the conditioned-Gaussian
normal at a crossing), the renewal and renewal+ conditioning of per-path
realizations (3D: `conditioning_3d`, 1D: `conditioning_1d`) and the
mirror NEE of 1D media (`nee_grad`, `nee_pdf`).  3D noise is sampled in
world space or in isotropic-ray space (`cfg.isotropic_3d`: each point
mapped world -> isotropic and rotated into its ray's frame, the splat
exp(-|ab|^2 / 2) at cell radius kernel_scale).  The march evaluates values
through ops/sparse_conv_fast.py and kernels K1 and K3.  As in the JAX
package, this general evaluator computes the 1D cell coordinate as
t / kernel_radius, the march as t * (1 / kernel_radius).
Not ported yet: plain isotropic 3D sampling (`isotropic_ray_3d` false),
conditioning of nonstationary covariances and the multi-resolution 1D
branches (the parser refuses what needs them).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import rng
from . import means
from ..utils.vecmath import (dot, frame_to_local, frame_to_world, inverse3,
                             mat_vec, normalize, tangent_frame)

CTXT_GLOBAL = "global"
CTXT_RENEWAL_PLUS = "renewal+"
CTXT_RENEWAL = "renewal"
CTXT_NONE = "none"

# 1D sampling schemes of the mirror NEE (the JAX package's numbers)
SCHEME_UNI = 0
SCHEME_NEE = 1
SCHEME_MIS = 2

# (dx, dy, dz) for dx, dy, dz in (-1, 0, 1)
_CELL_OFFSETS_3D = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)]
_CELL_OFFSETS_1D = [-1, 0, 1]
# float32 constants as the JAX package rounds them
_SQRT2 = float(torch.sqrt(torch.tensor(2.0, dtype=torch.float32)))
# the multi-resolution grid's level base (SparseConvolutionNoise.cpp:32) and
# its float32 log
MULTI_RES_BASE = 2.5
_LOG_BASE = float(torch.log(torch.tensor(MULTI_RES_BASE,
                                         dtype=torch.float32)))


@dataclasses.dataclass(frozen=True)
class GP:
    """Mean + covariance.  A CSG union is its left child's GP holding the
    right child's in `csg_right` (the function-space medium marches both)
    and the right child's mean in `mean_additional` (the sparse-conv and
    weight-space media take the min of the two means).  The optional
    vector fields color_field and emission_field give the scatter color
    and the volume emission at a point."""
    mean: object
    cov: object
    mean_additional: object = None
    csg_right: GP | None = None
    color_field: object = None
    emission_field: object = None

    def color(self, p):
        if self.color_field is None:
            return torch.ones(p.shape, dtype=torch.float32, device=p.device)
        return self.color_field(p)

    def emission(self, p):
        if self.emission_field is None:
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return self.emission_field(p)

    def mean_and_id(self, p):
        """The mean's value and the id of the GP that supplies it (1 where
        the additional mean is the smaller, else 0)."""
        return means.mean_and_id(self.mean, self.mean_additional, p)

    def mean_grad_by_id(self, p, gp_id):
        """The gradient of the mean that supplied the value."""
        return means.mean_grad_by_id(self.mean, self.mean_additional, p,
                                     gp_id)


@dataclasses.dataclass(frozen=True)
class Coeffs:
    """Pathwise conditioning coefficients of a ray batch."""
    value_scale: torch.Tensor  # [R]
    gradient_scale: torch.Tensor  # [R, 3]
    ray_origin: torch.Tensor  # [R, 3]

    @staticmethod
    def zeros(n, device):
        return Coeffs(
            value_scale=torch.zeros(n, dtype=torch.float32, device=device),
            gradient_scale=torch.zeros(n, 3, dtype=torch.float32,
                                       device=device),
            ray_origin=torch.zeros(n, 3, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class SparseConvConfig:
    global_seed: int  # a uint32 word
    impulse_density: torch.Tensor  # scalar float32
    ctxt: str = CTXT_RENEWAL_PLUS
    use_single_realization: bool = False
    impulse_count: int = 3
    one_d: bool = False
    scheme: int = SCHEME_UNI
    correlation_xy: bool = False
    isotropic_3d: bool = False  # 3D sampling in isotropic-ray space

    @staticmethod
    def create(global_seed, impulse_density, device, ctxt=CTXT_RENEWAL_PLUS,
               use_single_realization=False, one_d=False, scheme=SCHEME_UNI,
               correlation_xy=False, isotropic_3d=False):
        """A config from scene-file values with the JAX package's derived
        fields: NEE/MIS applies to per-path 1D realizations only, every
        other config samples UNI; the impulse count is the integer part of
        the density (a Python float)."""
        return SparseConvConfig(
            global_seed=int(global_seed) & rng.MASK32,
            impulse_density=torch.tensor(impulse_density,
                                         dtype=torch.float32, device=device),
            ctxt=ctxt,
            use_single_realization=use_single_realization,
            impulse_count=int(impulse_density), one_d=one_d,
            scheme=(scheme if one_d and not use_single_realization
                    else SCHEME_UNI),
            correlation_xy=correlation_xy, isotropic_3d=isotropic_3d)

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


def _noise3d(cfg, cov, p, seed, kernel_radius, global_scale=1.0,
            is_identity=False):
    """27-cell x K splat sum at p [R, 3] (in the sampling space) with seeds
    [R], cell radius `kernel_radius` and the splat at spatial scale
    `global_scale` (each a scalar tensor or one per ray, [R]), or the
    isotropic splat (`is_identity`); returns (val [R], grad [R, 3])."""
    dev = p.device
    K = cfg.impulse_count
    if kernel_radius.dim():
        kernel_radius = kernel_radius[:, None]
        global_scale = global_scale[:, None, None, None]
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
    # (a multi-resolution level's covariance has no isotropic splat)
    iso = {"is_identity": True} if is_identity else {}
    val, grad = cov.splat3_val_grad(kernel_radius[..., None, None] * d,
                                    global_scale, **iso)
    wm = torch.where(inside, w, 0.0)
    return ((wm * val).sum(dim=(1, 2)),
            (wm[..., None] * grad).sum(dim=(1, 2)))


def _level_word(kernel_spatial_scale):
    """The multi-resolution level of a spatial scale [R], as the word the
    seed is offset by (int64; the sum with the seed wraps at 2^32)."""
    return torch.floor(torch.log(kernel_spatial_scale)
                       / _LOG_BASE).to(torch.int64)


def eval_noise3d_world(cfg, gp, p, seed, kernel_spatial_scale=None,
                       coeff3=None, conditioning=False):
    """Normalized world-space 3D noise and its gradient at p [R, 3].

    A stationary covariance samples world space at spatial scale 1: the
    seed offset is 0 and the cell radius is the splat's; with
    `conditioning` under a renewal context it adds the conditioning splat
    of `coeff3` ([R] Coeffs).  A multi-resolution level passes its scale
    s [R]: the seed is offset by the level of s, and the cell radius and
    splat are the base's at s."""
    cov = gp.cov
    if kernel_spatial_scale is None:
        scale = 1.0
        radius = cov.splat_radius()
    else:
        scale = kernel_spatial_scale
        seed = (seed + _level_word(scale)) & rng.MASK32
        radius = cov.splat_radius(scale)
    val, grad = _noise3d(cfg, cov, p, seed, radius, scale)
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, radius, scale))
    val, grad = val / norm, grad / norm[..., None]
    if cfg.activate_conditioning and conditioning:
        dv, dg = cov.splat3_conditioning_combo(
            p - coeff3.ray_origin, coeff3.gradient_scale, coeff3.value_scale)
        val, grad = val + dv, grad + dg
    return val, grad


def eval_noise3d_iso_ray(cfg, gp, p, ray_dir, seed, coeff3=None,
                         conditioning=False):
    """Normalized 3D noise in isotropic-ray space and its world gradient at
    p [R, 3] (stationary: spatial scale 1, seed offset 0): p is mapped
    world -> isotropic and rotated into its ray's frame (`_ray_frame`),
    the lattice sum runs there with the isotropic splat at cell radius
    kernel_scale, and the gradient is rotated and mapped back.  With
    `conditioning` under a renewal context it adds the conditioning splat
    of `coeff3` around its origin, rotated into the same frame."""
    cov = gp.cov
    radius = torch.full((), cov.splat_radius_iso(), dtype=torch.float32,
                        device=p.device)
    tg, bt, rdi = _ray_frame(cov, ray_dir)
    p_ir = frame_to_local(tg, bt, rdi, cov.pos_world_to_local(p))
    val, grad_ir = _noise3d(cfg, cov, p_ir, seed, radius, is_identity=True)
    grad = cov.grad_local_to_world(frame_to_world(tg, bt, rdi, grad_ir))
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, radius,
                                    is_identity=True))
    val, grad = val / norm, grad / norm
    if cfg.activate_conditioning and conditioning:
        o_ir = frame_to_local(tg, bt, rdi,
                              cov.pos_world_to_local(coeff3.ray_origin))
        dv, dg_ir = cov.splat3_conditioning_combo(
            p_ir - o_ir, coeff3.gradient_scale, coeff3.value_scale,
            is_identity=True)
        dg = cov.grad_local_to_world(frame_to_world(tg, bt, rdi, dg_ir))
        val, grad = val + dv, grad + dg
    return val, grad


def level_pair(gp, p):
    """The two multi-resolution levels around the lateral scale ls(p) and
    their blend weights (kernelScaleLevelRatio): (lower level [R], its
    scale s_lo, the upper scale s_hi = s_lo * base, r_lo, r_hi), with
    r_lo^2 + r_hi^2 = 1 so the blend keeps unit variance."""
    ls = gp.cov.lateral_scale(p)
    lvl_lo = torch.floor(torch.log(ls) / _LOG_BASE)
    s_lo = torch.pow(MULTI_RES_BASE, lvl_lo)
    s_hi = torch.pow(MULTI_RES_BASE, lvl_lo + 1.0)
    frac = (ls - s_lo) / (s_hi - s_lo)
    denom = torch.sqrt(1.0 - 2.0 * frac + 2.0 * frac * frac)
    return lvl_lo, s_lo, s_hi, (1.0 - frac) / denom, frac / denom


def eval_noise3d(cfg, gp, p, seed, coeff3=None, ray_dir=None,
                 conditioning=False):
    """Normalized 3D noise and its gradient at p [R, 3]: isotropic-ray space
    (`cfg.isotropic_3d`, which needs the rays' directions) or world space
    at scale 1 for a stationary covariance, each conditioned on `coeff3`
    with `conditioning`; the blend of two world-space levels for a
    multi-resolution one (which conditions nothing)."""
    if cfg.isotropic_3d:
        return eval_noise3d_iso_ray(cfg, gp, p, ray_dir, seed, coeff3,
                                    conditioning)
    if gp.cov.is_stationary:
        return eval_noise3d_world(cfg, gp, p, seed, None, coeff3,
                                  conditioning)
    _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
    v_lo, g_lo = eval_noise3d_world(cfg, gp, p, seed, s_lo)
    v_hi, g_hi = eval_noise3d_world(cfg, gp, p, seed, s_hi)
    return (r_lo * v_lo + r_hi * v_hi,
            r_lo[:, None] * g_lo + r_hi[:, None] * g_hi)


def sampling_scheme(cfg, gp, p):
    """The 1D sampling scheme at p [R, 3]: UNI where the noise amplitude
    vanishes, the config's scheme elsewhere."""
    amp = gp.cov.amplitude(p)
    return torch.where(amp < 1e-6, SCHEME_UNI, cfg.scheme).to(torch.int64)


def _noise1d(cfg, cov, t, seed, kernel_radius):
    """3-cell x K splat sum along the iso-ray axis at coordinates t [R]
    with seeds [R]; returns (val [R], dval/dt [R])."""
    dev = t.device
    K = cfg.impulse_count
    t_grid = t / kernel_radius
    base = torch.floor(t_grid)
    frac = t_grid - base
    offs = torch.tensor(_CELL_OFFSETS_1D, dtype=torch.int64, device=dev)
    cells = rng.u32(base.to(torch.int32)[:, None] + offs)  # [R, 3]
    key = (rng.xxhash32_2(cells, seed[:, None]) + 1) & rng.MASK32
    ctr = 2 * torch.arange(K, dtype=torch.int64, device=dev)  # [K]
    key = key[:, :, None]
    ti = rng.uniform(key, ctr)  # [R, 3, K]
    w = rng.bernoulli_pm1(rng.uniform(key, ctr + 1))
    d = (frac[:, None] - offs.to(torch.float32))[:, :, None] - ti
    inside = d * d < 1.0
    val, grad = cov.splat1_val_grad(kernel_radius * d)
    wm = torch.where(inside, w, 0.0)
    return (wm * val).sum(dim=(1, 2)), (wm * grad).sum(dim=(1, 2))


def _ray_frame(cov, ray_dir):
    """The iso-ray frame: (tangent, bitangent, ray direction in isotropic
    space, normalized)."""
    rdi = normalize(cov.pos_world_to_local(ray_dir))
    tg, bt = tangent_frame(rdi)
    return tg, bt, rdi


def eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                            conditioning):
    """1D noise along the ray in iso-ray space at p [R, 3]: [R, 4] of
    (value, gx, gy, gz), where gz is the noise's derivative along the ray
    and gx, gy carry only the correlationXY conditioning terms."""
    cov = gp.cov
    tg, bt, rdi = _ray_frame(cov, ray_dir)
    pz = dot(cov.pos_world_to_local(p), rdi)
    R = cov.splat_radius_iso()
    val, gz = _noise1d(cfg, cov, pz, seed, R)
    norm = torch.sqrt(cov.variance1(cfg.impulse_density, R))
    val, gz = val / norm, gz / norm
    gx_c = torch.zeros_like(val)
    gy_c = torch.zeros_like(val)
    if cfg.activate_conditioning and conditioning:
        oz = dot(cov.pos_world_to_local(coeff1.ray_origin), rdi)
        dt = pz - oz
        cv, cg = cov.cov1_val_grad(dt)
        g1, g2 = cov.cov1_grad_grad2(dt)
        vs, gs = coeff1.value_scale, coeff1.gradient_scale
        val = val + (vs * cv + gs[:, 2] * g1)
        gz = gz + (vs * cg + gs[:, 2] * g2)
        if cfg.correlation_xy:
            h = cov.cov1_grad2_for_3d_normal(dt)
            gx_c = gs[:, 0] * h
            gy_c = gs[:, 1] * h
    return torch.stack([val, gx_c, gy_c, gz], dim=-1)


def eval_value_noise1d(cfg, gp, coeff1, p, ray_dir, seed, conditioning):
    """The normalized 1D noise value at p [R, 3]."""
    return eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                   conditioning)[:, 0]


def _xy_correlation_factor(t_seg):
    """(correlation factor, conditional variance) of the lateral gradient
    between a segment's start and t_seg along it (Renewal+ with
    correlationXY)."""
    f = torch.exp(-t_seg * t_seg / 4.0) * (0.5 - t_seg * t_seg * 0.25)
    return f, 0.5 - f * f * 2.0


def _xy_seed(pss, scene_seed):
    """Stream key of the lateral-gradient Gaussians, from the (pixel,
    sample, bounce) words pss [R, 4]."""
    h = rng.xxhash32_4(pss[..., 0], pss[..., 1], pss[..., 2], pss[..., 3])
    return (h + rng.xxhash32(scene_seed) + 1) & rng.MASK32


def eval_gradient_noise1d(cfg, gp, coeff1, p, t_segment, ray_dir, pss,
                          scene_seed, conditioning):
    """World-space gradient [R, 3] of the 1D GPIS noise at p.

    The along-ray component is the 1D noise derivative; the lateral ones
    are N(0, 1/2) draws from the ray's own stream (correlated with the
    segment start under Renewal+ with correlationXY), plus conditioning
    terms.  Rays with t_segment == 0 take the start-of-segment draw."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    tg, bt, rdi = _ray_frame(cov, ray_dir)
    key = _xy_seed(pss, scene_seed)
    g_base = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                     conditioning)[:, 1:]
    n0, n1 = rng.normal2(key, 0)
    xy_start = torch.stack([n0, n1], dim=-1) / _SQRT2
    m0, m1 = rng.normal2(key, 1)
    if cfg.ctxt == CTXT_RENEWAL_PLUS and cfg.correlation_xy:
        f, cvar = _xy_correlation_factor(t_segment)
        mu = (f * 2.0)[:, None] * xy_start
        xy_end = (torch.stack([m0, m1], dim=-1)
                  * torch.sqrt(torch.clamp(cvar, min=1e-12))[:, None] + mu)
    else:
        xy_end = torch.stack([m0, m1], dim=-1) / _SQRT2
    xy = torch.where((t_segment == 0.0)[:, None], xy_start, xy_end)
    g_ir = torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=-1) + g_base
    return cov.grad_local_to_world(frame_to_world(tg, bt, rdi, g_ir))


def eval_value(cfg, gp, p, pss, scene_seed, ray_dir=None, coeff1=None,
               coeff3=None):
    """GPIS value f(p) = amplitude * noise + mean; returns (val, gp_id).
    1D and isotropic-ray 3D sampling need the rays' directions, a renewal
    context the conditioning coefficients (coeff1 in 1D, coeff3 in 3D)."""
    seed = compute_seed(cfg, pss, scene_seed)
    if cfg.one_d:
        nv = eval_value_noise1d(cfg, gp, coeff1, p, ray_dir, seed, True)
    else:
        nv, _ = eval_noise3d(cfg, gp, p, seed, coeff3, ray_dir, True)
    m, gp_id = gp.mean_and_id(p)
    return gp.cov.amplitude(p) * nv + m, gp_id


def eval_gradient(cfg, gp, p, pss, scene_seed, ray_dir=None, t_segment=None,
                  coeff1=None, coeff3=None):
    """GPIS gradient at p [R, 3]: amplitude * noise gradient + mean
    gradient.  1D sampling needs the rays' directions, their distances
    t_segment from the segment start and conditioning coefficients;
    isotropic-ray 3D sampling the directions, and a renewal context the 3D
    coefficients."""
    if cfg.one_d:
        ng = eval_gradient_noise1d(cfg, gp, coeff1, p, t_segment, ray_dir,
                                   pss, scene_seed, True)
    else:
        seed = compute_seed(cfg, pss, scene_seed)
        _, ng = eval_noise3d(cfg, gp, p, seed, coeff3, ray_dir, True)
    _, gp_id = gp.mean_and_id(p)
    return (gp.cov.amplitude(p)[..., None] * ng
            + gp.mean_grad_by_id(p, gp_id))


# ---------------------------------------------------------------------------
# Renewal / Renewal+ conditioning of per-path realizations
# ---------------------------------------------------------------------------

def conditioning_3d(cfg, gp, p, ray_dir, target_val, target_grad, pss,
                    scene_seed):
    """Coefficients [R] that make the fresh 3D realization of each ray
    reproduce target_val (renewal) and target_grad (renewal+) at the
    segment start p [R, 3] (stationary covariances): the value scale of the
    covariance kernel's splat and, under renewal+, the gradient scale that
    its first derivatives carry, in the sampling space."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    amp = cov.amplitude(p)
    safe_amp = torch.where(amp == 0.0, 1.0, amp)
    m, gp_id = gp.mean_and_id(p)
    nv, ng = eval_noise3d(cfg, gp, p, seed, None, ray_dir, False)
    value_scale = (target_val - m) / safe_amp - nv
    gradient_scale = torch.zeros_like(p)
    if cfg.ctxt == CTXT_RENEWAL_PLUS:
        mg = gp.mean_grad_by_id(p, gp_id)
        delta = (target_grad - mg) / safe_amp[:, None] - ng
        if cfg.isotropic_3d:
            tg, bt, rdi = _ray_frame(cov, ray_dir)
            delta = frame_to_local(tg, bt, rdi,
                                   cov.grad_world_to_local(delta))
        # times the squared nonstationary splat scale, 1 here
        gradient_scale = mat_vec(
            cov.one_over_second_derivative(cfg.isotropic_3d)[None], delta)
    ok = amp != 0.0
    return Coeffs(value_scale=torch.where(ok, value_scale, 0.0),
                  gradient_scale=torch.where(ok[:, None], gradient_scale,
                                             0.0),
                  ray_origin=p)


def conditioning_1d(cfg, gp, p, ray_dir, target_val, target_grad, pss,
                    scene_seed):
    """Coefficients [R] that make the fresh realization of each ray
    reproduce (target_val, target_grad) at the segment start p [R, 3]."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    amp = cov.amplitude(p)
    safe_amp = torch.where(amp == 0.0, 1.0, amp)
    m, gp_id = gp.mean_and_id(p)
    nv = eval_value_noise1d(cfg, gp, None, p, ray_dir, seed, False)
    value_scale = (target_val - m) / safe_amp - nv
    gradient_scale = torch.zeros_like(p)
    if cfg.ctxt == CTXT_RENEWAL_PLUS:
        mg = gp.mean_grad_by_id(p, gp_id)
        ng = eval_gradient_noise1d(cfg, gp, None, p, torch.zeros_like(amp),
                                   ray_dir, pss, scene_seed, False)
        delta = (target_grad - mg) / safe_amp[:, None] - ng
        tg, bt, rdi = _ray_frame(cov, ray_dir)
        gs_iso = frame_to_local(tg, bt, rdi, cov.grad_world_to_local(delta))
        # times the squared 1D splat scales (sx, sy, sz), all 1 here
        gradient_scale = -2.0 * gs_iso
        if not cfg.correlation_xy:
            gradient_scale = torch.cat(
                [torch.zeros_like(gradient_scale[:, :2]),
                 gradient_scale[:, 2:]], dim=-1)
    ok = amp != 0.0
    return Coeffs(value_scale=torch.where(ok, value_scale, 0.0),
                  gradient_scale=torch.where(ok[:, None], gradient_scale,
                                             0.0),
                  ray_origin=p)


def conditioning(cfg, gp, coeff3, coeff1, p, ray_dir, target_val,
                 target_grad, pss, scene_seed):
    """(coeff3, coeff1) conditioned at p [R, 3] on (target_val,
    target_grad): the 1D set for 1D sampling, the 3D set otherwise; both
    unchanged when the config conditions nothing."""
    if not cfg.activate_conditioning:
        return coeff3, coeff1
    if cfg.one_d:
        return coeff3, conditioning_1d(cfg, gp, p, ray_dir, target_val,
                                       target_grad, pss, scene_seed)
    return conditioning_3d(cfg, gp, p, ray_dir, target_val, target_grad,
                           pss, scene_seed), coeff1


# ---------------------------------------------------------------------------
# NEE for 1D GPIS with a mirror phase
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _nee_shared(cfg, gp, coeff1, ray_dir, normal, p, pss, scene_seed):
    """The normal plane of the conditioned 1D realization at p and where
    the line along `normal` meets it: (grad_constraint [R, 3], gradient in
    iso-ray space [R, 3], plane normal [R, 3], plane stretch [R],
    intersection distance [R])."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    amp = cov.amplitude(p)
    _, gp_id = gp.mean_and_id(p)
    mean_grad = gp.mean_grad_by_id(p, gp_id)
    tg, bt, rdi = _ray_frame(cov, ray_dir)
    mtx_ray = torch.stack([tg, bt, rdi], dim=-1)  # columns t, b, n
    mtx_pt = amp[:, None, None] * (
        cov.local_to_world_inv_transpose()[:, None] * mtx_ray)
    gc = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                 True)[:, 1:]
    plane_pt = mtx_pt[:, :, 2] * gc[:, 2:3] + mean_grad
    cp = _cross(mtx_pt[:, :, 0], mtx_pt[:, :, 1])
    stretch = torch.sqrt(torch.clamp(dot(cp, cp), min=1e-30))
    plane_n = cp / stretch[:, None]
    isect_dist = dot(plane_pt, plane_n) / dot(normal, plane_n)
    grad_ir = mat_vec(inverse3(mtx_pt),
                       isect_dist[:, None] * normal - mean_grad)
    return gc, grad_ir, plane_n, stretch, isect_dist


def nee_grad(cfg, gp, coeff1, ray_dir, normal, p, pss, scene_seed):
    """The 3D gradient [R, 3] along `normal` that the conditioned 1D
    realization allows at p (the normal a light-sampled mirror bounce
    needs)."""
    isect_dist = _nee_shared(cfg, gp, coeff1, ray_dir, normal, p, pss,
                             scene_seed)[4]
    return isect_dist[:, None] * normal


def nee_pdf(cfg, gp, coeff1, ray_dir, normal, p, t_segment, pss,
            scene_seed):
    """Solid-angle pdf [R] of sampling the mirror normal `normal` at p by
    forward sampling of the gradient (0 where the plane lies behind)."""
    gc, g_ir, plane_n, stretch, isect_dist = _nee_shared(
        cfg, gp, coeff1, ray_dir, normal, p, pss, scene_seed)
    # the 1D splat scales sx, sy are 1 for a stationary covariance
    if cfg.ctxt == CTXT_RENEWAL_PLUS and cfg.correlation_xy:
        n0, n1 = rng.normal2(_xy_seed(pss, scene_seed), 0)
        f, cvar = _xy_correlation_factor(t_segment)
        cs = torch.sqrt(torch.clamp(cvar, min=1e-12))
        samp_x = (g_ir[:, 0] - gc[:, 0] - f * 2.0 * (n0 / _SQRT2)) / cs
        samp_y = (g_ir[:, 1] - gc[:, 1] - f * 2.0 * (n1 / _SQRT2)) / cs
        pdf_area = (torch.exp(-0.5 * samp_x ** 2)
                    * torch.exp(-0.5 * samp_y ** 2) / (2.0 * math.pi)
                    / torch.clamp(cvar, min=1e-12))
    else:
        samp_x = (g_ir[:, 0] - gc[:, 0]) * _SQRT2
        samp_y = (g_ir[:, 1] - gc[:, 1]) * _SQRT2
        pdf_area = (torch.exp(-0.5 * samp_x ** 2)
                    * torch.exp(-0.5 * samp_y ** 2) / (2.0 * math.pi) * 2.0)
    cos_theta = dot(normal, plane_n).abs()
    pdf_normal = (pdf_area * isect_dist ** 2
                  / torch.clamp(cos_theta, min=1e-12) / stretch)
    pdf_omega = pdf_normal / torch.clamp(4.0 * dot(normal, -ray_dir),
                                         min=1e-12)
    return torch.where(isect_dist < 0.0, 0.0, pdf_omega)
