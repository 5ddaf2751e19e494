"""The march-step evaluators: value_at(t) along a ray batch, with the raw
lattice sum in kernel K1, K2 or K3 (tungsten_tpu/ops/sparse_conv_fast.py's
`make_value_at` and `make_value_at_1d`):

- K1 (scalar cell radius and form): stationary covariances in world,
  isotropic and isotropic-ray space, and the two levels of a
  multi-resolution nonstationary covariance in isotropic(-ray) space
  (each level's scale in the positions), as one [2R] launch;
- K2 (per-point radius and form scale): the two levels of a
  multi-resolution covariance in world space, as one [2R] launch, and a
  brute-force nonstationary covariance (`multiResolutionGrid: false`),
  whose per-point splat scale divides the form;
- K3: 1D sampling of a stationary covariance (`make_value_at_1d`).

Everything that does not change along a ray (seeds, the splat quadratic
form, the cell radius, the variance normalization, the iso-ray
parametrization, the isotropic-ray frame and the conditioning constants)
is computed once per batch, so each step is one kernel plus a few
elementwise ops on [R] tensors.  Under the multi-resolution grid the two
levels around ls(p) change along the ray, so each step computes them,
with their radii, quadratic-form scales and variances.  Under a renewal
context each step adds the conditioning splat around each ray's
conditioning origin (per level at its scale).  Under
`surf_vol_phase_separate` the gp id is the variance threshold's.
Every step is differentiable in t, the rays, the covariance's parameters
and the conditioning coefficients: K1's backward is K1b, K2's is K2b and
K3's is K3b.  A full anisoMtx splat form in world space goes to K1 and K2
as its six unique entries (`noise3d.form6`), differentiable in l, and its
backward is K1b's or K2b's full instance; in isotropic(-ray) space the
anisoMtx reaches the sum through the positions alone.
"""
from __future__ import annotations

import torch

from ..kernels import noise1d, noise3d
from ..utils import rng
from .covariance import apply_form
from ..utils.vecmath import dot, frame_to_local, normalize, tangent_frame
from . import sparse_conv as sc


def _form(m):
    """The splat form as K1 and K2 take it: its diagonal [3], or the six
    unique entries [6] of a full [3, 3] (anisoMtx in world space)."""
    return m if m.dim() == 1 else noise3d.form6(m)


def _iso_space(cov, ray_frame, ro, rd, scale=1.0):
    """Each ray in isotropic space at spatial scale `scale` (and, with
    `ray_frame`, rotated into its frame): (origin [R, 3], direction [R, 3],
    a map of world points [R, 3] into the same space)."""
    def w2l(v):
        v = cov.pos_world_to_local(v)
        return v if isinstance(scale, float) and scale == 1.0 else v / scale
    rd_iso = w2l(rd)
    if not ray_frame:
        return w2l(ro), rd_iso, w2l
    rdi = normalize(rd_iso)
    tg, bt = tangent_frame(rdi)

    def to_space(v):
        return frame_to_local(tg, bt, rdi, w2l(v))
    return to_space(ro), frame_to_local(tg, bt, rdi, rd_iso), to_space


def _cond_splat(m_cond, full, dd, qm, coeff3):
    """The conditioning splat (value_scale + d0 . gradient_scale)
    exp(-q0) at offsets dd [R, 3] from the conditioning origins in the
    sampling space, its form scaled by qm (1, or per point [R])."""
    mdd = apply_form(m_cond, dd, full)
    q0 = dot(mdd, dd)
    d0 = -2.0 * mdd
    if not isinstance(qm, float):
        q0, d0 = qm * q0, qm[:, None] * d0
    gsc = coeff3.gradient_scale
    return (coeff3.value_scale + d0[:, 0] * gsc[:, 0] + d0[:, 1] * gsc[:, 1]
            + d0[:, 2] * gsc[:, 2]) * torch.exp(-q0)


def make_value_at(cfg, gp, ro, rd, pss, scene_seed, coeff3=None):
    """value_at(t [R]) -> (f [R], gp_id [R]) for the rays ro + t * rd
    (`coeff3`: the rays' 3D conditioning coefficients, [R] Coeffs, read
    under a renewal context)."""
    cov = gp.cov
    seed0 = sc.compute_seed(cfg, pss, scene_seed)
    if not cov.is_stationary:
        if not cov.use_multi_res_grid:
            return _make_value_at_brute_force(cfg, gp, ro, rd, seed0, coeff3)
        if cfg.isotropic_3d:
            return _make_value_at_multi_res_iso(cfg, gp, ro, rd, seed0,
                                                coeff3)
        return _make_value_at_multi_res(cfg, gp, ro, rd, seed0, coeff3)
    if cfg.isotropic_3d:
        # isotropic(-ray) space: world -> isotropic (then each ray's frame
        # (tg, bt, rdi)); K1 sums there with the identity splat form and
        # the cell radius kernel_scale, constants of the covariance
        ro_s, rd_s, to_space = _iso_space(cov, cfg.isotropic_ray_3d, ro, rd)
        kr_f = cov.splat_radius_iso()
        kr = torch.full((), kr_f, dtype=torch.float32, device=ro.device)
        m = cov.splat_form(is_identity=True)
        host = (kr_f, 0.5, 0.5, 0.5)
        norm = torch.sqrt(cov.variance3(cfg.impulse_density, kr_f,
                                        is_identity=True))
    else:
        ro_s, rd_s = ro, rd
        kr = cov.splat_radius()
        # K1 takes kr and the splat form (its diagonal, or a full anisoMtx
        # form's six entries) as tensors, differentiable in l, and by
        # value (one host read for all of them per batch)
        m = _form(cov.splat_form())
        host = noise3d.host_params(kr, m)
        norm = torch.sqrt(cov.variance3(cfg.impulse_density, kr))
    K = cfg.impulse_count
    use_cond = cfg.activate_conditioning
    if use_cond:
        # the conditioning splat exp(-q0) around each ray's conditioning
        # origin, in the same sampling space
        o_s = (to_space(coeff3.ray_origin) if cfg.isotropic_3d
               else coeff3.ray_origin)
        m_cond = cov.cond_form(cfg.isotropic_3d)
        full = cov.full_form(cfg.isotropic_3d)

    def value_at(t):
        p = ro + t[:, None] * rd
        ps = ro_s + t[:, None] * rd_s if cfg.isotropic_3d else p
        total = noise3d.noise3d_sum_s_diff(ps, seed0, kr, m, K, host)
        val = total / norm
        if use_cond:
            val = val + _cond_splat(m_cond, full, ps - o_s, 1.0, coeff3)
        mean, gp_id = gp.mean_and_id(p)
        return cov.amplitude(p) * val + mean, cfg.gp_id(gp, p, gp_id)

    return value_at


def _make_value_at_multi_res(cfg, gp, ro, rd, seed0, coeff3):
    """value_at(t) of a multi-resolution nonstationary covariance: at each
    point the normalized lattice sums of the levels lvl and lvl + 1 around
    ls(p), each at its scale s (seed offset by its level, cell radius
    kr_unit * s, quadratic form over s^2) and, under a renewal context,
    each with the conditioning splat at its scale, blended by r_lo and
    r_hi.  Both levels go to K2 as one [2R] batch, differentiable in p
    (through t), in l (through the cell radii and the splat form) and in
    the levels' scales."""
    cov = gp.cov
    # the base's unit-scale splat form (its diagonal or a full anisoMtx
    # form's six entries: a tensor, differentiable in l, and its values,
    # read on the host once per batch) and cell radius
    m3 = cov.base.splat_form()
    full = m3.dim() == 2
    m = _form(m3)
    host = tuple(m.detach().tolist())
    kr_unit = cov.base.splat_radius()
    dens = cfg.impulse_density
    K = cfg.impulse_count
    seed0 = seed0[None]
    use_cond = cfg.activate_conditioning
    if use_cond:
        m_cond = cov.base.cond_form()

    def value_at(t):
        p = ro + t[:, None] * rd
        lvl_lo, s_lo, s_hi, r_lo, r_hi = sc.level_pair(gp, p)
        lvl = lvl_lo.to(torch.int64)
        seed = (seed0 + torch.stack([lvl, lvl + 1])) & rng.MASK32
        s = torch.stack([s_lo, s_hi])  # [2, R]
        kr = kr_unit * s
        qm = 1.0 / (s * s)
        total = noise3d.noise3d_sum_diff(
            p.repeat(2, 1), seed.reshape(-1), kr.reshape(-1),
            qm.reshape(-1), m, K, host)
        vals = total.reshape(s.shape) / torch.sqrt(cov.variance3(dens, kr, s))
        if use_cond:
            dd = p - coeff3.ray_origin
            vals = vals + torch.stack([
                _cond_splat(m_cond, full, dd, qm[j], coeff3)
                for j in range(2)])
        val = r_lo * vals[0] + r_hi * vals[1]
        mean, gp_id = gp.mean_and_id(p)
        return cov.amplitude(p) * val + mean, cfg.gp_id(gp, p, gp_id)

    return value_at


def _make_value_at_multi_res_iso(cfg, gp, ro, rd, seed0, coeff3):
    """value_at(t) of a multi-resolution nonstationary covariance sampled
    in isotropic(-ray) space: each level's positions are the rays' there
    over its scale s, with the identity splat at the cell radius
    kernel_scale, so both levels go to K1 (scalar kr and form) as one [2R]
    batch, seeds offset by their levels; under a renewal context each
    level adds the conditioning splat at its scale.  l and the levels'
    scales reach the sum through the positions (K1b's dp)."""
    cov = gp.cov
    ro_s, rd_s, to_space = _iso_space(cov, cfg.isotropic_ray_3d, ro, rd)
    kr_f = cov.splat_radius_iso()
    kr = torch.full((), kr_f, dtype=torch.float32, device=ro.device)
    m_id = cov.base.splat_form(is_identity=True)
    host = (kr_f, 0.5, 0.5, 0.5)
    norm = torch.sqrt(cov.variance3(cfg.impulse_density, kr_f,
                                    is_identity=True))
    K = cfg.impulse_count
    seed0 = seed0[None]
    use_cond = cfg.activate_conditioning
    if use_cond:
        o_s = to_space(coeff3.ray_origin)
        m_cond = cov.cond_form(True)

    def value_at(t):
        p = ro + t[:, None] * rd
        ps = ro_s + t[:, None] * rd_s
        lvl_lo, s_lo, s_hi, r_lo, r_hi = sc.level_pair(gp, p)
        lvl = lvl_lo.to(torch.int64)
        seed = (seed0 + torch.stack([lvl, lvl + 1])) & rng.MASK32
        inv = torch.stack([1.0 / s_lo, 1.0 / s_hi])[..., None]  # [2, R, 1]
        pl = ps[None] * inv
        total = noise3d.noise3d_sum_s_diff(pl.reshape(-1, 3),
                                           seed.reshape(-1), kr, m_id, K,
                                           host)
        vals = total.reshape(2, -1) / norm
        if use_cond:
            vals = vals + torch.stack([
                _cond_splat(m_cond, False, pl[j] - o_s * inv[j], 1.0,
                            coeff3) for j in range(2)])
        val = r_lo * vals[0] + r_hi * vals[1]
        mean, gp_id = gp.mean_and_id(p)
        return cov.amplitude(p) * val + mean, cfg.gp_id(gp, p, gp_id)

    return value_at


def _make_value_at_brute_force(cfg, gp, ro, rd, seed0, coeff3):
    """value_at(t) of a brute-force nonstationary covariance
    (`multiResolutionGrid: false`): one lattice at the scale max(ls) whose
    splat forms are divided per point by the squared splat scale ls(p) /
    max(ls).  K2 takes it as a per-point quadratic-form scale qm with the
    cell radius kr_unit * max(ls) in world space (seed offset by the
    level of max(ls)), or kernel_scale in isotropic(-ray) space at
    positions over max(ls) (no offset); the variance is the base's at
    max(ls) times the splat scale cubed.  Under a renewal context the
    conditioning splat takes the same qm.  The cell radius (world space:
    differentiable in l), the form and qm go to K2 as tensors, so the
    backward is K2b."""
    cov = gp.cov
    dev = ro.device
    dens = cfg.impulse_density
    K = cfg.impulse_count
    ml = torch.tensor(float(cov.max_ls), dtype=torch.float32, device=dev)
    iso = cfg.isotropic_3d
    if iso:
        ro_s, rd_s, to_space = _iso_space(cov.base, cfg.isotropic_ray_3d, ro,
                                          rd, ml)
        kr = torch.full((), cov.splat_radius_iso(), dtype=torch.float32,
                        device=dev)
        m = cov.base.splat_form(is_identity=True)
        seed = seed0
    else:
        ro_s, rd_s = ro, rd
        kr = cov.base.splat_radius() * ml
        m = _form(cov.base.splat_form())
        seed = (seed0 + sc._level_word(ml)) & rng.MASK32
    host = tuple(m.detach().tolist())
    base_var = cov.base.variance3(dens, kr, ml, is_identity=iso)
    use_cond = cfg.activate_conditioning
    if use_cond:
        o_s = to_space(coeff3.ray_origin) if iso else coeff3.ray_origin
        m_cond = cov.base.cond_form(iso)
        full = cov.full_form(iso)

    def value_at(t):
        p = ro + t[:, None] * rd
        ps = ro_s + t[:, None] * rd_s
        ls = cov.nonstat_splat_kernel_scale(p)
        inv_ls2 = 1.0 / torch.clamp(ls * ls, min=1e-12)
        qm = inv_ls2 if iso else inv_ls2 / (ml * ml)
        total = noise3d.noise3d_sum_diff(ps.contiguous(), seed,
                                         kr.expand(ls.shape).contiguous(),
                                         qm.contiguous(), m, K, host)
        val = total / torch.sqrt(base_var * (ls * ls * ls))
        if use_cond:
            val = val + _cond_splat(m_cond, full, ps - o_s, qm, coeff3)
        mean, gp_id = gp.mean_and_id(p)
        return cov.amplitude(p) * val + mean, cfg.gp_id(gp, p, gp_id)

    return value_at


def make_value_at_1d(cfg, gp, coeff1, ro, rd, pss, scene_seed):
    """value_at(t [R]) -> (f [R], gp_id [R]) for 1D (along-ray) sampling.

    The 1D noise lives on a 3-cell lattice along the iso-ray axis, whose
    coordinate pz0 + t * dpz is affine in t, so a step is K3 on [R]
    coordinates plus the renewal conditioning splat around each ray's
    conditioning origin (coeff1, [R] Coeffs).  Differentiable in t, the
    rays, the covariance's parameters (through pz0, dpz and the amplitude)
    and the conditioning coefficients: K3's backward is K3b."""
    cov = gp.cov
    # K3's word type, converted once per batch rather than once per step
    seed0 = sc.compute_seed(cfg, pss, scene_seed).to(torch.int32)
    rd_iso = cov.pos_world_to_local(rd)
    rdi = normalize(rd_iso)
    pz0 = dot(cov.pos_world_to_local(ro), rdi)
    dpz = dot(rd_iso, rdi)
    kr = cov.splat_radius_iso()
    inv_norm = 1.0 / torch.sqrt(cov.variance1(cfg.impulse_density, kr))
    K = cfg.impulse_count
    use_cond = cfg.activate_conditioning
    if use_cond:
        oz = dot(cov.pos_world_to_local(coeff1.ray_origin), rdi)
        vsc = coeff1.value_scale
        gsz = coeff1.gradient_scale[:, 2]

    def value_at(t):
        pw = ro + t[:, None] * rd
        pz = pz0 + t * dpz
        val = noise1d.noise1d_sum_diff(pz, seed0, kr, K) * inv_norm
        if use_cond:
            dtc = pz - oz
            cv, _ = cov.cov1_val_grad(dtc)
            g1, _ = cov.cov1_grad_grad2(dtc)
            val = val + vsc * cv + gsz * g1
        mean, gp_id = gp.mean_and_id(pw)
        return cov.amplitude(pw) * val + mean, cfg.gp_id(gp, pw, gp_id)

    return value_at
