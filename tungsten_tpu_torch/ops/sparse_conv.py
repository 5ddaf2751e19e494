"""Sparse-convolution noise, batched over rays: the general evaluator of
tungsten_tpu/ops/sparse_conv.py, in 3D (world, isotropic and
isotropic-ray space) and in 1D (along the ray), for stationary
covariances and the procedural nonstationary one in multi-resolution and
brute-force mode.

A noise value at a point is a pure function of (point, cell lattice, seed):
each neighbour cell (3^3 in 3D, 3 along the ray in 1D) is hash-keyed,
carries `impulse_count` Bernoulli-weighted impulses and adds a splat term;
the sum is normalized by the analytic noise variance.  The JAX package
writes these functions per point and vmaps them; here the ray batch is the
leading dimension.

These are the evaluators behind the gradient (the conditioned-Gaussian
normal at a crossing), the renewal and renewal+ conditioning of per-path
realizations (3D: `conditioning_3d`, 1D: `conditioning_1d`) and the
mirror NEE of 1D media (`nee_grad`, `nee_pdf`), and the march's values
on the multi-resolution 1D path.  3D noise is sampled in world space or
in isotropic space (`cfg.isotropic_3d`: each point mapped world ->
isotropic, and with `cfg.isotropic_ray_3d` rotated into its ray's frame;
the splat exp(-|ab|^2 / 2) at cell radius kernel_scale).  A
multi-resolution covariance blends two levels of the lattice around
ls(p), each at its own scale and seed (`level_pair`); a brute-force one
samples at the scale max(ls) with each splat scaled per point.  The
march evaluates 3D values and stationary 1D values through
ops/sparse_conv_fast.py and kernels K1, K2 and K3.  As in the JAX
package, this general evaluator computes the 1D cell coordinate as
t / kernel_radius, the march as t * (1 / kernel_radius).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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
    # the conditioning on a mesh point set (ops/gp.py GlobalCond), which
    # the function-space medium reads
    global_cond: object = None
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
    isotropic_3d: bool = False  # 3D sampling in isotropic space
    # isotropic space rotated into each ray's frame (the scene files'
    # isotropic_3D_sampling); False only where a caller replaces it, as in
    # the JAX package
    isotropic_ray_3d: bool = True
    # the gp id of a value is 0 where the unscaled variance is below the
    # threshold, else 1
    surf_vol_phase_separate: bool = False
    surf_vol_phase_amp_thresh: float = 0.0

    @staticmethod
    def create(global_seed, impulse_density, device, ctxt=CTXT_RENEWAL_PLUS,
               use_single_realization=False, one_d=False, scheme=SCHEME_UNI,
               correlation_xy=False, isotropic_3d=False,
               surf_vol_phase_separate=False, surf_vol_phase_amp_thresh=0.0):
        """A config from scene-file values with the JAX package's derived
        fields: NEE/MIS applies to per-path 1D realizations only, every
        other config samples UNI; the impulse count is the integer part of
        the density (a Python float); the threshold is a float32 value."""
        return SparseConvConfig(
            global_seed=int(global_seed) & rng.MASK32,
            impulse_density=torch.tensor(impulse_density,
                                         dtype=torch.float32, device=device),
            ctxt=ctxt,
            use_single_realization=use_single_realization,
            impulse_count=int(impulse_density), one_d=one_d,
            scheme=(scheme if one_d and not use_single_realization
                    else SCHEME_UNI),
            correlation_xy=correlation_xy, isotropic_3d=isotropic_3d,
            surf_vol_phase_separate=surf_vol_phase_separate,
            surf_vol_phase_amp_thresh=float(np.float32(
                surf_vol_phase_amp_thresh)))

    def multi_res(self, gp):
        """Whether the GP samples the multi-resolution grid's levels."""
        return not gp.cov.is_stationary and gp.cov.use_multi_res_grid

    def gp_id(self, gp, p, gp_id):
        """The gp id at p [R, 3]: the mean's, or under
        surf_vol_phase_separate 0 where the unscaled variance is below the
        threshold and 1 elsewhere."""
        if not self.surf_vol_phase_separate:
            return gp_id
        return torch.where(gp.cov.unscaled_variance(p)
                           < self.surf_vol_phase_amp_thresh, 0, 1)

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


_OFFSETS = {}


def _offsets(cells, device):
    """The cell offsets as an int64 tensor on `device`, made once per
    device (a copy to the card each call would sync the host)."""
    key = (id(cells), device)
    if key not in _OFFSETS:
        _OFFSETS[key] = torch.tensor(cells, dtype=torch.int64, device=device)
    return _OFFSETS[key]


def _noise3d(cfg, cov, p, seed, kernel_radius, global_scale=1.0,
             is_identity=False, p_world=None):
    """27-cell x K splat sum at p [R, 3] (in the sampling space) with seeds
    [R], cell radius `kernel_radius` and the splat at spatial scale
    `global_scale` (each a scalar tensor or one per ray, [R]), or the
    isotropic splat (`is_identity`); a brute-force nonstationary
    covariance scales each splat by its per-point scale at the world
    point p_world [R, 3].  Returns (val [R], grad [R, 3])."""
    dev = p.device
    K = cfg.impulse_count
    if kernel_radius.dim():
        kernel_radius = kernel_radius[:, None]
    if isinstance(global_scale, torch.Tensor) and global_scale.dim():
        global_scale = global_scale[:, None, None, None]
    p_grid = p / kernel_radius
    base = torch.floor(p_grid)
    frac = p_grid - base
    offs = _offsets(_CELL_OFFSETS_3D, dev)
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
    kr = kernel_radius[..., None, None] if kernel_radius.dim() \
        else kernel_radius
    val, grad = cov.splat3_val_grad(kr * d, global_scale, is_identity,
                                    p_world)
    wm = torch.where(inside, w, 0.0)
    return ((wm * val).sum(dim=(1, 2)),
            (wm[..., None] * grad).sum(dim=(1, 2)))


def _level_word(kernel_spatial_scale):
    """The multi-resolution level of a spatial scale (a float32 tensor,
    [R] or scalar), as the word the seed is offset by (int64; the sum with
    the seed wraps at 2^32)."""
    return torch.floor(torch.log(kernel_spatial_scale)
                       / _LOG_BASE).to(torch.int64)


def _scale_arg(s):
    """A spatial scale as the forms take it: a Python float, or a tensor
    per point with a trailing axis of size 1."""
    return s[:, None] if isinstance(s, torch.Tensor) and s.dim() else s


def _f32(x, device):
    return torch.tensor(np.float32(x), device=device)


def eval_noise3d_world(cfg, gp, p, seed, kernel_spatial_scale=None,
                       coeff3=None, conditioning=False, radius_scale=None):
    """Normalized world-space 3D noise and its gradient at p [R, 3].

    A stationary covariance samples world space at spatial scale 1 (seed
    offset 0, the splat's cell radius); a brute-force nonstationary one at
    the scale max(ls) (seed offset by its level, the cell radius the
    base's at max(ls), each splat scaled per point).  A multi-resolution
    level passes its scale s [R]: the seed is offset by the level of s,
    and the cell radius and splat are the base's at s.  With
    `conditioning` under a renewal context it adds the conditioning splat
    of `coeff3` ([R] Coeffs) at the same scale."""
    cov = gp.cov
    dev = p.device
    if kernel_spatial_scale is None:
        # the world sampling scale: 1, or max(ls) in brute-force mode
        brute = not cov.is_stationary and not cov.use_multi_res_grid
        scale = _f32(cov.max_ls, dev) if brute else 1.0
        radius = cov.splat_radius()
        if brute:
            seed = (seed + _level_word(scale)) & rng.MASK32
    else:
        scale = kernel_spatial_scale
        seed = (seed + _level_word(scale)) & rng.MASK32
        radius = cov.splat_radius(scale if radius_scale is None
                                  else radius_scale)
    val, grad = _noise3d(cfg, cov, p, seed, radius, scale, p_world=p)
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, radius, scale,
                                    p=p))
    val, grad = val / norm, grad / norm[..., None]
    if cfg.activate_conditioning and conditioning:
        dv, dg = cov.splat3_conditioning_combo(
            p - coeff3.ray_origin, coeff3.gradient_scale, coeff3.value_scale,
            global_scale=_scale_arg(scale), p=p)
        val, grad = val + dv, grad + dg
    return val, grad


def _iso_noise(cfg, gp, p, ray_dir, seed, kernel_spatial_scale, coeff3,
               conditioning, ray_frame):
    """Normalized 3D noise in isotropic space (`ray_frame`: rotated into
    each ray's frame) at spatial scale s (1, or a level's [R]) and its
    world gradient at p [R, 3]: p is mapped world -> isotropic at s (and
    rotated), the lattice sum runs there with the isotropic splat at cell
    radius kernel_scale (seed offset by the level of s), and the gradient
    is rotated and mapped back.  With `conditioning` under a renewal
    context it adds the conditioning splat of `coeff3` around its origin,
    mapped in the same way."""
    cov = gp.cov
    s = kernel_spatial_scale
    if isinstance(s, torch.Tensor):
        seed = (seed + _level_word(s)) & rng.MASK32
        sv = s[:, None]
    else:
        sv = s
    radius = torch.full((), cov.splat_radius_iso(), dtype=torch.float32,
                        device=p.device)

    def to_space(v):
        v = cov.pos_world_to_local(v, sv) if not cov.is_stationary else \
            cov.pos_world_to_local(v)
        return frame_to_local(tg, bt, rdi, v) if ray_frame else v

    def to_world(g):
        if ray_frame:
            g = frame_to_world(tg, bt, rdi, g)
        return (cov.grad_local_to_world(g, sv) if not cov.is_stationary
                else cov.grad_local_to_world(g))

    if ray_frame:
        tg, bt, rdi = _ray_frame(cov, ray_dir)
    p_s = to_space(p)
    val, grad_s = _noise3d(cfg, cov, p_s, seed, radius, is_identity=True,
                           p_world=p)
    grad = to_world(grad_s)
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, radius,
                                    is_identity=True, p=p))
    val, grad = val / norm, grad / norm[..., None]
    if cfg.activate_conditioning and conditioning:
        dv, dg_s = cov.splat3_conditioning_combo(
            p_s - to_space(coeff3.ray_origin), coeff3.gradient_scale,
            coeff3.value_scale, is_identity=True, p=p)
        val, grad = val + dv, grad + to_world(dg_s)
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
    """Normalized 3D noise and its gradient at p [R, 3], in world space
    or, `cfg.isotropic_3d`, in isotropic(-ray) space (which needs the
    rays' directions), conditioned on `coeff3` with `conditioning`; a
    multi-resolution covariance blends two levels, each conditioned."""
    if not cfg.isotropic_3d:
        def fn(s):
            return eval_noise3d_world(cfg, gp, p, seed, s, coeff3,
                                      conditioning)
    else:
        def fn(s):
            return _iso_noise(cfg, gp, p, ray_dir, seed,
                              1.0 if s is None else s, coeff3, conditioning,
                              cfg.isotropic_ray_3d)
    if not cfg.multi_res(gp):
        return fn(None)
    _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
    v_lo, g_lo = fn(s_lo)
    v_hi, g_hi = fn(s_hi)
    return (r_lo * v_lo + r_hi * v_hi,
            r_lo[:, None] * g_lo + r_hi[:, None] * g_hi)


def sampling_scheme(cfg, gp, p):
    """The 1D sampling scheme at p [R, 3]: UNI where the noise amplitude
    vanishes, the config's scheme elsewhere."""
    amp = gp.cov.amplitude(p)
    return torch.where(amp < 1e-6, SCHEME_UNI, cfg.scheme).to(torch.int64)


def _noise1d(cfg, cov, t, seed, kernel_radius, p_world=None):
    """3-cell x K splat sum along the iso-ray axis at coordinates t [R]
    with seeds [R] (a brute-force nonstationary covariance scales its
    splats at the world point p_world [R, 3]); returns (val [R], dval/dt
    [R])."""
    dev = t.device
    K = cfg.impulse_count
    t_grid = t / kernel_radius
    base = torch.floor(t_grid)
    frac = t_grid - base
    offs = _offsets(_CELL_OFFSETS_1D, dev)
    cells = rng.u32(base.to(torch.int32)[:, None] + offs)  # [R, 3]
    key = (rng.xxhash32_2(cells, seed[:, None]) + 1) & rng.MASK32
    ctr = 2 * torch.arange(K, dtype=torch.int64, device=dev)  # [K]
    key = key[:, :, None]
    ti = rng.uniform(key, ctr)  # [R, 3, K]
    w = rng.bernoulli_pm1(rng.uniform(key, ctr + 1))
    d = (frac[:, None] - offs.to(torch.float32))[:, :, None] - ti
    inside = d * d < 1.0
    val, grad = cov.splat1_val_grad(kernel_radius * d, p_world)
    wm = torch.where(inside, w, 0.0)
    return (wm * val).sum(dim=(1, 2)), (wm * grad).sum(dim=(1, 2))


def _ray_frame(cov, ray_dir):
    """The iso-ray frame: (tangent, bitangent, ray direction in isotropic
    space, normalized)."""
    rdi = normalize(cov.pos_world_to_local(ray_dir))
    tg, bt = tangent_frame(rdi)
    return tg, bt, rdi


def _w2l(cov, v, s):
    """World -> isotropic at spatial scale s (1, or per point [R])."""
    if cov.is_stationary:
        return cov.pos_world_to_local(v)
    return cov.pos_world_to_local(v, _scale_arg(s))


def eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                            conditioning, kernel_spatial_scale=1.0,
                            multi_res_low_level=False, frame=None):
    """1D noise along the ray in iso-ray space at p [R, 3], at spatial
    scale s (1, or a multi-resolution level's [R]: the positions mapped at
    s, the seed offset by its level): [R, 4] of (value, gx, gy, gz), where
    gz is the noise's derivative along the ray and gx, gy carry only the
    correlationXY conditioning terms.  A multi-resolution level's
    conditioning splat is weighed by that level's ratio at the
    conditioning origin (`multi_res_low_level`: the lower's).  `frame`:
    the rays' iso-ray frame (`_ray_frame`) if the caller holds it."""
    cov = gp.cov
    s = kernel_spatial_scale
    tg, bt, rdi = frame or _ray_frame(cov, ray_dir)
    pz = dot(_w2l(cov, p, s), rdi)
    if isinstance(s, torch.Tensor):
        seed = (seed + _level_word(s)) & rng.MASK32
    R = cov.splat_radius_iso()
    val, gz = _noise1d(cfg, cov, pz, seed, R, p)
    norm = torch.sqrt(cov.variance1(cfg.impulse_density, R, p))
    val, gz = val / norm, gz / norm
    gx_c = torch.zeros_like(val)
    gy_c = torch.zeros_like(val)
    if cfg.activate_conditioning and conditioning:
        o = coeff1.ray_origin
        dt = pz - dot(_w2l(cov, o, s), rdi)
        cv, cg = cov.cov1_val_grad(dt, p, o)
        g1, g2 = cov.cov1_grad_grad2(dt, p, o)
        vs, gs = coeff1.value_scale, coeff1.gradient_scale
        if cfg.multi_res(gp):
            _, _, _, r_lo, r_hi = level_pair(gp, o)
            w = r_lo if multi_res_low_level else r_hi
            val = val + w * (vs * cv + s * gs[:, 2] * g1)
            gz = gz + w * (vs * cg + s * gs[:, 2] * g2)
            if cfg.correlation_xy:
                gx_c = w * s * gs[:, 0] * cov.cov1_grad2_for_3d_normal(
                    dt, p, o)
                gy_c = w * s * gs[:, 1] * cov.cov1_grad2_for_3d_normal(
                    dt, p, o)
        else:
            val = val + (vs * cv + gs[:, 2] * g1)
            gz = gz + (vs * cg + gs[:, 2] * g2)
            if cfg.correlation_xy:
                h = cov.cov1_grad2_for_3d_normal(dt, p, o)
                gx_c = gs[:, 0] * h
                gy_c = gs[:, 1] * h
    return torch.stack([val, gx_c, gy_c, gz], dim=-1)


def eval_value_noise1d(cfg, gp, coeff1, p, ray_dir, seed, conditioning,
                       frame=None):
    """The normalized 1D noise value at p [R, 3] (the blend of two levels
    for a multi-resolution covariance); `frame` as in
    eval_noise1d_normalized."""
    if not cfg.multi_res(gp):
        return eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                       conditioning, frame=frame)[:, 0]
    _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
    frame = frame or _ray_frame(gp.cov, ray_dir)
    v_lo = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                   conditioning, s_lo, True, frame)[:, 0]
    v_hi = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                   conditioning, s_hi, False, frame)[:, 0]
    return r_lo * v_lo + r_hi * v_hi


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


def _lateral_scale_1d(cov, p):
    """1 / s [R, 1] of the 1D noise's lateral Gaussians: the per-point 1D
    splat scale (the same along both tangents: the field is isotropic;
    None for a stationary covariance, whose scale 1 is left out)."""
    if cov.is_stationary:
        return None
    return (1.0 / cov.nonstat_splat_cov_1d(p, p))[:, None]


def eval_gradient_noise1d(cfg, gp, coeff1, p, t_segment, ray_dir, pss,
                          scene_seed, conditioning):
    """World-space gradient [R, 3] of the 1D GPIS noise at p.

    The along-ray component is the 1D noise derivative; the lateral ones
    are N(0, 1/2) draws from the ray's own stream (correlated with the
    segment start under Renewal+ with correlationXY), plus conditioning
    terms.  Rays with t_segment == 0 take the start-of-segment draw.  A
    multi-resolution covariance blends two levels, each with its own
    draws (counters 0 and 1, the end's at 2 and 3) in its own frame."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    tg, bt, rdi = _ray_frame(cov, ray_dir)
    key = _xy_seed(pss, scene_seed)
    corr = cfg.ctxt == CTXT_RENEWAL_PLUS and cfg.correlation_xy
    xs = _lateral_scale_1d(cov, p)

    def scaled(xy):
        return xy if xs is None else xy * xs

    def lateral(c_start, c_end):
        n0, n1 = rng.normal2(key, c_start)
        xy_start = torch.stack([n0, n1], dim=-1) / _SQRT2
        m0, m1 = rng.normal2(key, c_end)
        if corr:
            f, cvar = _xy_correlation_factor(t_segment)
            mu = (f * 2.0)[:, None] * xy_start
            xy_end = (torch.stack([m0, m1], dim=-1)
                      * torch.sqrt(torch.clamp(cvar, min=1e-12))[:, None]
                      + mu)
        else:
            xy_end = scaled(torch.stack([m0, m1], dim=-1) / _SQRT2)
        return torch.where((t_segment == 0.0)[:, None], scaled(xy_start),
                           xy_end)

    if not cfg.multi_res(gp):
        g_base = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                         conditioning)[:, 1:]
        xy = lateral(0, 1)
        g_ir = torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=-1) + g_base
        return cov.grad_local_to_world(frame_to_world(tg, bt, rdi, g_ir))
    _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
    out = 0.0
    for s, r, low, c0 in ((s_lo, r_lo, True, 0), (s_hi, r_hi, False, 1)):
        b = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                    conditioning, s, low)[:, 1:]
        xy = lateral(c0, c0 + 2)
        rdi_s = normalize(_w2l(cov, ray_dir, s))
        t_s, b_s = tangent_frame(rdi_s)
        g = frame_to_world(t_s, b_s, rdi_s, torch.cat(
            [xy, torch.zeros_like(xy[:, :1])], dim=-1) + b)
        out = out + r[:, None] * cov.grad_local_to_world(g, s[:, None])
    return out


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
    return gp.cov.amplitude(p) * nv + m, cfg.gp_id(gp, p, gp_id)


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
    segment start p [R, 3]: the value scale of the covariance kernel's
    splat and, under renewal+, the gradient scale that its first
    derivatives carry, in the sampling space.  A multi-resolution
    covariance divides them by the sum of its levels' weights (the
    gradient's over each level's scale, squared in world space); a
    brute-force one multiplies the gradient scale by its squared scale
    (ls in world space, the per-point splat scale in isotropic space)."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    amp = cov.amplitude(p)
    safe_amp = torch.where(amp == 0.0, 1.0, amp)
    m, gp_id = gp.mean_and_id(p)
    nv, ng = eval_noise3d(cfg, gp, p, seed, None, ray_dir, False)
    value_scale = (target_val - m) / safe_amp - nv
    multi_res = cfg.multi_res(gp)
    if multi_res:
        _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
        value_scale = value_scale / (r_lo + r_hi)
    gradient_scale = torch.zeros_like(p)
    if cfg.ctxt == CTXT_RENEWAL_PLUS:
        mg = gp.mean_grad_by_id(p, gp_id)
        delta = (target_grad - mg) / safe_amp[:, None] - ng
        iso = cfg.isotropic_3d
        if iso:
            delta = (cov.grad_world_to_local(delta) if cov.is_stationary
                     else cov.grad_world_to_local(delta, 1.0))
            if cfg.isotropic_ray_3d:
                tg, bt, rdi = _ray_frame(cov, ray_dir)
                delta = frame_to_local(tg, bt, rdi, delta)
        gradient_scale = mat_vec(cov.one_over_second_derivative(iso)[None],
                                 delta)
        if multi_res:
            gradient_scale = gradient_scale / (
                (r_lo / s_lo + r_hi / s_hi) if iso
                else (r_lo / (s_lo * s_lo) + r_hi / (s_hi * s_hi)))[:, None]
        elif not cov.is_stationary:
            sc_ = (cov.nonstat_splat_kernel_scale(p) if iso
                   else cov.lateral_scale(p))
            gradient_scale = gradient_scale * (sc_ * sc_)[:, None]
    ok = amp != 0.0
    return Coeffs(value_scale=torch.where(ok, value_scale, 0.0),
                  gradient_scale=torch.where(ok[:, None], gradient_scale,
                                             0.0),
                  ray_origin=p)


def conditioning_1d(cfg, gp, p, ray_dir, target_val, target_grad, pss,
                    scene_seed):
    """Coefficients [R] that make the fresh realization of each ray
    reproduce (target_val, target_grad) at the segment start p [R, 3]
    (target_val alone under renewal); a multi-resolution covariance
    divides them by the sum of its levels' squared weights, a
    nonstationary one scales the gradient's by its squared 1D splat
    scales."""
    cov = gp.cov
    seed = compute_seed(cfg, pss, scene_seed)
    amp = cov.amplitude(p)
    safe_amp = torch.where(amp == 0.0, 1.0, amp)
    m, gp_id = gp.mean_and_id(p)
    nv = eval_value_noise1d(cfg, gp, None, p, ray_dir, seed, False)
    value_scale = (target_val - m) / safe_amp - nv
    multi_res = cfg.multi_res(gp)
    if multi_res:
        _, _, _, r_lo, r_hi = level_pair(gp, p)
        value_scale = value_scale / (r_lo * r_lo + r_hi * r_hi)
    gradient_scale = torch.zeros_like(p)
    if cfg.ctxt == CTXT_RENEWAL_PLUS:
        mg = gp.mean_grad_by_id(p, gp_id)
        ng = eval_gradient_noise1d(cfg, gp, None, p, torch.zeros_like(amp),
                                   ray_dir, pss, scene_seed, False)
        delta = (target_grad - mg) / safe_amp[:, None] - ng
        tg, bt, rdi = _ray_frame(cov, ray_dir)
        gs_iso = frame_to_local(tg, bt, rdi, (
            cov.grad_world_to_local(delta) if cov.is_stationary
            else cov.grad_world_to_local(delta, 1.0)))
        gradient_scale = -2.0 * gs_iso
        if not cov.is_stationary:
            s1 = cov.nonstat_splat_cov_1d(p, p)
            gradient_scale = gradient_scale * (s1 * s1)[:, None]
        if multi_res:
            gradient_scale = gradient_scale / (
                r_lo * r_lo + r_hi * r_hi)[:, None]
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
    ltw = cov.local_to_world_inv_transpose()
    if ltw.dim() == 2:
        lm = (ltw[None, :, 0:1] * mtx_ray[:, 0:1] + ltw[None, :, 1:2]
              * mtx_ray[:, 1:2] + ltw[None, :, 2:3] * mtx_ray[:, 2:3])
    else:
        lm = ltw[:, None] * mtx_ray
    mtx_pt = amp[:, None, None] * lm
    if not cfg.multi_res(gp):
        gc = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                     True)[:, 1:]
    else:
        _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
        g_lo = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                       True, s_lo, True)[:, 1:]
        g_hi = eval_noise1d_normalized(cfg, gp, coeff1, p, ray_dir, seed,
                                       True, s_hi, False)[:, 1:]
        gc = (g_lo * r_lo[:, None] / s_lo[:, None]
              + g_hi * r_hi[:, None] / s_hi[:, None])
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
    cov = gp.cov
    gc, g_ir, plane_n, stretch, isect_dist = _nee_shared(
        cfg, gp, coeff1, ray_dir, normal, p, pss, scene_seed)
    corr = cfg.ctxt == CTXT_RENEWAL_PLUS and cfg.correlation_xy
    key = _xy_seed(pss, scene_seed)
    # the 1D splat scales sx, sy (1 for a stationary covariance, which
    # leaves them out)
    sxy = None if cov.is_stationary else cov.nonstat_splat_cov_1d(p, p)
    ns = None
    if cfg.multi_res(gp):
        _, s_lo, s_hi, r_lo, r_hi = level_pair(gp, p)
        a, b = r_lo / s_lo, r_hi / s_hi
        ns = 1.0 / torch.sqrt(a * a + b * b)
        sxy = sxy * ns
    if not corr:
        ex, ey = g_ir[:, 0] - gc[:, 0], g_ir[:, 1] - gc[:, 1]
        if sxy is None:
            samp_x, samp_y = ex * _SQRT2, ey * _SQRT2
            pdf_area = (torch.exp(-0.5 * samp_x ** 2)
                        * torch.exp(-0.5 * samp_y ** 2) / (2.0 * math.pi)
                        * 2.0)
        else:
            samp_x, samp_y = ex * _SQRT2 * sxy, ey * _SQRT2 * sxy
            pdf_area = (torch.exp(-0.5 * samp_x ** 2)
                        * torch.exp(-0.5 * samp_y ** 2) / (2.0 * math.pi)
                        * 2.0 * sxy * sxy)
    else:
        n0, n1 = rng.normal2(key, 0)
        f, cvar = _xy_correlation_factor(t_segment)
        cs = torch.sqrt(torch.clamp(cvar, min=1e-12))
        if ns is None:
            samp_x = (g_ir[:, 0] - gc[:, 0] - f * 2.0 * (n0 / _SQRT2)) / cs
            samp_y = (g_ir[:, 1] - gc[:, 1] - f * 2.0 * (n1 / _SQRT2)) / cs
            pdf_area = (torch.exp(-0.5 * samp_x ** 2)
                        * torch.exp(-0.5 * samp_y ** 2) / (2.0 * math.pi)
                        / torch.clamp(cvar, min=1e-12))
        else:
            m0, m1 = rng.normal2(key, 1)
            mu_x = f * 2.0 * ((n0 / _SQRT2) * r_lo / s_lo
                              + (m0 / _SQRT2) * r_hi / s_hi)
            mu_y = f * 2.0 * ((n1 / _SQRT2) * r_lo / s_lo
                              + (m1 / _SQRT2) * r_hi / s_hi)
            samp_x = (g_ir[:, 0] - gc[:, 0] - mu_x) / cs * ns
            samp_y = (g_ir[:, 1] - gc[:, 1] - mu_y) / cs * ns
            pdf_area = (torch.exp(-0.5 * samp_x ** 2)
                        * torch.exp(-0.5 * samp_y ** 2)
                        / (2.0 * math.pi * torch.clamp(cvar, min=1e-12))
                        * ns * ns)
    cos_theta = dot(normal, plane_n).abs()
    pdf_normal = (pdf_area * isect_dist ** 2
                  / torch.clamp(cos_theta, min=1e-12) / stretch)
    pdf_omega = pdf_normal / torch.clamp(4.0 * dot(normal, -ray_dir),
                                         min=1e-12)
    return torch.where(isect_dist < 0.0, 0.0, pdf_omega)
