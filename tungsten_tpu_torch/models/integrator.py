"""Wavefront path tracer (the path-tracer walk of
tungsten_tpu/models/integrator.py): a batch of rays advances one event per
iteration (intersect -> GPIS march -> NEE -> scatter) under active-ray masks.

Surface and volume NEE, with both MIS strategies (light sampling and
material sampling), share one shadow walk over a [2R] ray batch per bounce.
NEE sees the next segment's realization (pss with bounce + 1).  Emissive
hits count only after specular chains, since NEE already carries the
material-sampling half.  Forward (boundary) hops do not consume bounces.
A mirror phase function is a Dirac lobe: on a 1D-sampled medium NEE
samples the normal the light direction needs and weighs it with the pdf of
sampling that normal (`sparse_conv.nee_pdf`), gated by the crossing's 1D
sampling scheme; on a 3D-sampled one its vertices take no NEE, as in the
JAX package.  A mirror BSDF on a primitive is a Dirac lobe that NEE
skips and the walk samples.

A loop ends early when no ray is left to advance, and a medium or shadow
hop is skipped when no ray is in it: every result there is masked, so the
image is the same as running every iteration.

The render is differentiable in the scene's parameters that require grad
(the GP hyperparameters) by the JAX package's detached-sampling estimator:
discrete events (crossings, visibility, sampled directions) and sampling
densities carry no gradient, while crossing positions (media.py's IFT
reattachment), the sampled normals, the geometric factor of area-light
sampling and the BSDF and phase values do; each weight whose density was
detached is multiplied by `_reattach_ratio`, which is 1 in value.  A
render in which nothing requires grad computes no ratio and records no
graph.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import sparse_conv as sc
from ..utils import rng, sobol
from ..utils.vecmath import (dot, frame_to_local, frame_to_world,
                             safe_normalize, tangent_frame)
from . import bsdfs as bs
from . import media as md
from . import phase as ph
from . import primitives as pr
from .camera import Camera

INF = pr.INF
EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class Scene:
    prims: pr.PrimitiveSoA
    bsdfs: bs.BsdfTable
    media: tuple  # tuple[md.Medium]
    camera: Camera
    lights: torch.Tensor  # [L] prim indices
    scene_seed: int  # a uint32 word
    max_bounces: int = 64
    min_bounces: int = 0
    enable_light_sampling: bool = True
    enable_volume_light_sampling: bool = True
    cam_medium: int = -1
    shadow_hops: int = 3


def _power_heuristic(a, b):
    return a * a / torch.clamp(a * a + b * b, min=1e-20)


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _reattach_ratio(f):
    """f / f.detach() where |f| > 1e-12, else 1: exactly 1 in value, and
    grad log f in gradient.  A weight whose sampling density was detached
    (the pdf cancelled analytically, or an area-form geometric factor)
    times this ratio regains the integrand's dependence on the parameters
    without changing the estimate."""
    fd = f.detach()
    ok = fd.abs() > 1e-12
    return torch.where(ok, f / torch.where(ok, fd, 1.0), 1.0)


@torch.no_grad()
def shadow_walk(scene, ro, rd, dist, light_prim, med_idx, med_state, pss,
                u_jitter, active):
    """Visibility [N, 3] toward a light through forward-lobed surfaces and
    binary GPIS transmittance: a discrete event, so it records no graph."""
    N = ro.shape[0]
    thr = torch.ones(N, 3, dtype=torch.float32, device=ro.device)
    zeros = torch.zeros(N, dtype=torch.float32, device=ro.device)
    cur_o, remaining, cur_med, alive = ro, dist, med_idx, active
    state = med_state
    for hop in range(scene.shadow_hops):
        if not bool(alive.any()):
            break
        isect = pr.intersect(scene.prims, cur_o, rd, EPS,
                             remaining * (1.0 - 1e-3))
        hit = isect["hit"] & alive
        is_light_prim = isect["prim"] == light_prim
        fwd = bs.is_forward(scene.bsdfs, scene.prims.bsdf[isect["prim"]])
        blocked = hit & ~is_light_prim & ~fwd
        thr = _where3(blocked, 0.0, thr)
        alive = alive & ~blocked
        seg_far = torch.where(hit & fwd & ~is_light_prim, isect["t"],
                              remaining)
        for mi, medium in enumerate(scene.media):
            in_m = alive & (cur_med == mi)
            if not bool(in_m.any()):
                continue
            tr = md.transmittance(medium, scene.scene_seed, cur_o, rd, zeros,
                                  seg_far, state, pss, u_jitter, in_m)
            thr = thr * tr
            alive = alive & (torch.where(in_m, tr.amax(dim=-1), 1.0) > 0.0)
        if hop == scene.shadow_hops - 1:
            break
        adv = alive & hit & fwd & ~is_light_prim
        int_m = scene.prims.int_medium[isect["prim"]]
        ext_m = scene.prims.ext_medium[isect["prim"]]
        new_med = torch.where(isect["back_side"], ext_m, int_m)
        cur_med = torch.where(adv & ((int_m >= 0) | (ext_m >= 0)), new_med,
                              cur_med)
        cur_o = _where3(adv, cur_o + isect["t"][:, None] * rd, cur_o)
        remaining = torch.where(adv, remaining - isect["t"], remaining)
        # a continued segment starts blank, and its seed ticks per hop
        state = state.reset_where(adv)
        pss = torch.where(adv[:, None], _next_bounce(pss), pss)
        alive = alive & adv
    return thr


def _seg_in(in_m, t_seg):
    """The segment lengths of the vertices in a medium, 0 elsewhere.

    Elsewhere t_seg holds the surface distance or INF, where correlationXY's
    factor exp(-t^2 / 4) (0.5 - t^2 / 4) is 0 * inf = NaN; that lane's pdf
    is masked out, but its backward would pass 0 * NaN into the gradient
    (the JAX package's d(image)/d(sigma, l) of config 3b is NaN so).  The
    masked lanes' values change, no selected one does."""
    return torch.where(in_m, t_seg, 0.0)


def _next_bounce(pss):
    """pss [R, 4] with the bounce word advanced by one."""
    return torch.cat([pss[:, :3], pss[:, 3:] + 1], dim=1)


def next_event(scene, p_vtx, is_vol, rd, aniso, scheme, t_seg, normal, tfr,
               bfr, wi_local, bsdf_idx, med_idx, med_state, pss_next, draw,
               bounce, gate, ad=False):
    """One-light NEE with both MIS strategies for surface and volume
    vertices, in one [2R] shadow walk.  scheme and t_seg are the 1D
    sampling scheme and segment length of each volume vertex.  Returns
    radiance [R, 3].

    Detached sampling: visibility, the occlusion query of strategy 2, the
    pdfs and the MIS weights carry no gradient; the BSDF and phase values
    do, and with `ad` (a parameter requires grad) each strategy's weight
    is reattached by a ratio that is 1 in value."""
    R = p_vtx.shape[0]
    nl = scene.lights.shape[0]
    if nl == 0:
        return torch.zeros(R, 3, dtype=torch.float32, device=p_vtx.device)
    prims = scene.prims

    ul = draw(bounce, 40)
    li_sel = torch.clamp((ul * nl).to(torch.int64), max=nl - 1)
    light = scene.lights[li_sel]
    light_e = prims.emission[light]

    # ---- strategy 1: light sampling --------------------------------------
    d1, ldist, lpdf, lvalid = pr.sample_direct(prims, light, p_vtx,
                                               draw(bounce, 41),
                                               draw(bounce, 42))
    # area form (every ported light is a quad): the sampled light point is
    # held fixed and the direction to it, with the geometric factor
    # |n_l . d| / r^2 that the solid-angle pdf cancelled, follows the
    # vertex
    dv = (p_vtx + d1 * ldist[:, None]).detach() - p_vtx
    r2q = torch.clamp(dot(dv, dv), min=1e-12)
    d1 = dv / torch.sqrt(r2q)[:, None]
    ratio1 = (_reattach_ratio(dot(prims.n[light], d1).abs() / r2q) if ad
              else None)

    wo_local = frame_to_local(tfr, bfr, normal, d1)
    f_surf = bs.eval_bsdf(scene.bsdfs, bsdf_idx, wi_local, wo_local)
    pdf_surf = bs.pdf_bsdf(scene.bsdfs, bsdf_idx, wi_local, wo_local)
    # null, mirror and forward are Dirac: light sampling cannot reach them
    pure_spec = (bs.is_pure_specular(scene.bsdfs, bsdf_idx)
                 | bs.is_forward(scene.bsdfs, bsdf_idx)
                 | bs.is_null(scene.bsdfs, bsdf_idx))
    f_vol = torch.zeros_like(f_surf)
    pdf_vol = torch.zeros_like(pdf_surf)
    aniso_shadow = aniso
    vol_lvalid = torch.ones_like(is_vol)
    disable_mis = torch.zeros_like(is_vol)
    for mi, medium in enumerate(scene.media):
        in_m = is_vol & (med_idx == mi)
        spec = ph.phase_is_specular(medium, scene.bsdfs)
        # a Dirac phase: light-sampled through the 1D realization's normal
        # plane on a 1D medium, not at all on a 3D one
        if spec and medium.cfg.one_d:
            half_n = safe_normalize(-rd + d1)
            npdf = sc.nee_pdf(medium.cfg, medium.gp, med_state.coeff1, rd,
                              half_n, p_vtx, _seg_in(in_m, t_seg), pss_next,
                              scene.scene_seed)
            f_m = scene.bsdfs.albedo[medium.phase_bsdf] * npdf[:, None]
            pdf_m = npdf
            g_ov = sc.nee_grad(medium.cfg, medium.gp, med_state.coeff1, rd,
                               half_n, p_vtx, pss_next, scene.scene_seed)
            aniso_shadow = _where3(in_m, g_ov, aniso_shadow)
            vol_lvalid = vol_lvalid & torch.where(
                in_m, scheme != sc.SCHEME_UNI, True)
            disable_mis = disable_mis | (in_m & (scheme == sc.SCHEME_NEE))
        elif spec:
            f_m = torch.zeros_like(f_surf)
            pdf_m = torch.zeros_like(pdf_surf)
            vol_lvalid = vol_lvalid & ~in_m
        else:
            f_m = ph.eval_phase(medium, scene.bsdfs, rd, d1, aniso)
            pdf_m = ph.pdf_phase(medium, scene.bsdfs, rd, d1, aniso)
        f_vol = _where3(in_m, f_m, f_vol)
        pdf_vol = torch.where(in_m, pdf_m, pdf_vol)
    f1 = _where3(is_vol, f_vol, f_surf)
    mat_pdf1 = torch.where(is_vol, pdf_vol, pdf_surf)
    valid1 = gate & lvalid & (f1.amax(dim=-1) > 0.0)
    valid1 = valid1 & torch.where(is_vol, vol_lvalid, ~pure_spec)
    o1 = p_vtx + _where3(is_vol, 0.0, normal * torch.sign(wo_local[:, 2:3])
                         * EPS)

    # ---- strategy 2: material sampling -----------------------------------
    u = torch.stack([draw(bounce, s) for s in range(44, 49)], dim=-1)
    s_surf = bs.sample_bsdf(scene.bsdfs, bsdf_idx, wi_local, u)
    d2 = frame_to_world(tfr, bfr, normal, s_surf["wo"])
    w2, pdf2 = s_surf["weight"], s_surf["pdf"]
    valid2 = gate & ~is_vol & s_surf["valid"] & ~s_surf["specular"]
    for mi, medium in enumerate(scene.media):
        in_m = is_vol & (med_idx == mi)
        psamp = ph.sample_phase(medium, scene.bsdfs, rd, aniso, u)
        d2 = _where3(in_m, psamp["w"], d2)
        w2 = _where3(in_m, psamp["weight"], w2)
        v_m = psamp["valid"]
        spec = ph.phase_is_specular(medium, scene.bsdfs)
        if spec and medium.cfg.one_d:
            spdf = sc.nee_pdf(medium.cfg, medium.gp, med_state.coeff1, rd,
                              safe_normalize(-rd + psamp["w"]), p_vtx,
                              _seg_in(in_m, t_seg), pss_next,
                              scene.scene_seed)
            pdf2 = torch.where(in_m, spdf, pdf2)
            # UNI: the main walk collects direct hits; NEE: light sampling
            # alone
            v_m = v_m & (scheme == sc.SCHEME_MIS)
        elif spec:
            v_m = torch.zeros_like(v_m)
        else:
            pdf2 = torch.where(in_m, psamp["pdf"], pdf2)
        valid2 = valid2 | (gate & in_m & v_m)
    o2 = p_vtx + _where3(is_vol, 0.0, normal
                         * torch.sign(s_surf["wo"][:, 2:3]) * EPS)
    isect2 = pr.intersect(prims, o2.detach(), d2.detach(), EPS, INF)
    # front-side hits only: a primitive emits from its front side
    hit_light2 = (valid2 & isect2["hit"] & (isect2["prim"] == light)
                  & ~isect2["back_side"])
    t2 = torch.where(hit_light2, isect2["t"], 1.0)
    ld_pdf2 = pr.direct_pdf(prims, light, d2, t2)

    # ---- one combined shadow walk ----------------------------------------
    # surface NEE starts a blank segment; volume NEE keeps the state, with
    # the light-sampled normal in place of the sampled one for strategy 1
    blank = med_state.reset_where(torch.ones_like(is_vol))
    state1 = md.select(is_vol, dataclasses.replace(
        med_state, last_aniso=aniso_shadow), blank)
    state2 = md.select(is_vol, med_state, blank)
    uj = draw(bounce, 43)
    tr = shadow_walk(
        scene, torch.cat([o1, o2]), torch.cat([d1, d2]),
        torch.cat([torch.where(valid1, ldist, 1.0), t2]),
        torch.cat([light, light]), torch.cat([med_idx, med_idx]),
        md.cat_states(state1, state2), torch.cat([pss_next, pss_next]),
        torch.cat([uj, uj]), torch.cat([valid1, hit_light2]))
    tr1, tr2 = tr[:R], tr[R:]

    mis1 = torch.where(disable_mis, 1.0, _power_heuristic(lpdf, mat_pdf1))
    w_est1 = (tr1 * (mis1 / torch.clamp(lpdf, min=1e-9)
                     * float(nl))[:, None]).detach()
    if ad:
        w_est1 = w_est1 * ratio1[:, None]
        # strategy 2's weight is f / pdf with the pdf cancelled: its value
        # at the (held) sampled direction restores d f / d theta
        f2 = _where3(is_vol, 0.0, bs.eval_bsdf(scene.bsdfs, bsdf_idx,
                                               wi_local,
                                               s_surf["wo"].detach()))
        for mi, medium in enumerate(scene.media):
            if not ph.phase_is_specular(medium, scene.bsdfs):
                f2 = _where3(is_vol & (med_idx == mi),
                             ph.eval_phase(medium, scene.bsdfs, rd,
                                           d2.detach(), aniso), f2)
        w2 = w2 * _reattach_ratio(f2)
    c1 = _where3(valid1 & (tr1.amax(dim=-1) > 0), f1 * light_e * w_est1, 0.0)
    mis2 = _power_heuristic(pdf2, ld_pdf2)
    w_est2 = (tr2 * (mis2 * float(nl))[:, None]).detach()
    c2 = _where3(hit_light2 & (tr2.amax(dim=-1) > 0), w2 * light_e * w_est2,
                 0.0)
    return c1 + c2


def _make_draw(key, key_pix, qmc, spp):
    """draw(bounce [R], slot) -> a uniform [R] per ray.  Without `qmc`,
    the hash stream of the ray's key; with Sobol points (qmc [DIMS], the
    point of every ray, or [N, DIMS], row s the point of sample s, each ray
    taking row spp), the first QMC_BOUNCES bounces take the point's
    dimension bounce * SLOTS + slot, rotated (Cranley-Patterson) by an
    offset fixed per pixel and dimension from key_pix, and deeper bounces
    the hash stream (the JAX package's `_make_draw`)."""
    def draw(bounce, slot):
        h = rng.uniform(key, (bounce * 64 + slot) & rng.MASK32)
        if qmc is None:
            return h
        off = rng.uniform(key_pix, (bounce * sobol.SLOTS + slot) & rng.MASK32)
        dim = torch.clamp(bounce, max=sobol.QMC_BOUNCES - 1) * sobol.SLOTS \
            + slot
        q = qmc[spp, dim] if qmc.dim() == 2 else qmc[dim]
        return torch.where(bounce < sobol.QMC_BOUNCES,
                           torch.fmod(q + off, 1.0), h)

    return draw


def trace(scene, px, py, spp_idx, want_aovs=False, qmc=None):
    """One sample for each ray of the flat batch px, py [R] (int64) at
    sample index spp_idx (an int, or an [R] tensor: several samples in one
    batch give the same values as one batch each).  Returns radiance [R, 3],
    differentiable in the scene's parameters that require grad (the
    detached-sampling estimator: discrete events and sampling densities
    are held, the integrand follows the parameters).

    With `want_aovs`, returns (radiance, aovs): the feature buffers at each
    path's first scattering vertex, depth [R], normal [R, 3], albedo [R, 3]
    and NEE visibility [R] (0 where the path scatters nowhere).  `qmc`
    draws the first bounces low-discrepancy from utils/sobol.py's points:
    [DIMS], the point of the sample spp_idx (an int then), or [N, DIMS],
    the points of samples 0 .. N - 1 (`_make_draw`).  Neither option
    changes the radiance computed without them."""
    R = px.shape[0]
    dev = px.device
    # the reattachment ratios are 1 in value: a render without gradient
    # skips them
    ad = torch.is_grad_enabled() and md.requires_grad(scene)
    spp = torch.as_tensor(spp_idx, dtype=torch.int64, device=dev).expand(R)
    key = rng.xxhash32_4(px, py, spp, scene.scene_seed ^ 0x5F356495)
    key_pix = None
    if qmc is not None:
        key_pix = rng.xxhash32_4(px, py, 0x51CB0113,
                                 scene.scene_seed ^ 0xC9A01E77)
        qmc = torch.as_tensor(qmc, dtype=torch.float32, device=dev)
    draw = _make_draw(key, key_pix, qmc, spp)

    bounce = torch.zeros(R, dtype=torch.int64, device=dev)
    uf = torch.stack([draw(bounce, 0), draw(bounce, 1)], dim=-1)
    ro, rd = scene.camera.sample_ray(px, py, uf)

    throughput = torch.ones(R, 3, dtype=torch.float32, device=dev)
    emission = torch.zeros(R, 3, dtype=torch.float32, device=dev)
    emissive = any(m.gp.emission_field is not None for m in scene.media)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    was_specular = torch.ones(R, dtype=torch.bool, device=dev)
    med_idx = torch.full((R,), scene.cam_medium, dtype=torch.int64,
                         device=dev)
    med_state = md.MediumState.make(R, dev)
    zeros = torch.zeros(R, dtype=torch.float32, device=dev)
    prims = scene.prims
    if want_aovs:
        aov_depth, aov_vis = zeros, zeros
        aov_normal = aov_albedo = torch.zeros_like(throughput)
        aov_seen = torch.zeros_like(active)

    # forward hops don't consume bounces
    for _ in range(scene.max_bounces + 4):
        if not bool(active.any()):
            break
        pss = torch.stack([px, py, spp, bounce], dim=-1)
        isect = pr.intersect(prims, ro, rd, EPS, INF)
        did_hit = isect["hit"]
        far = torch.where(did_hit, isect["t"], INF)

        # ---- medium distance sampling ------------------------------------
        vol_event = torch.zeros_like(active)
        failed = torch.zeros_like(active)
        med_t = far
        med_aniso = med_state.last_aniso
        med_weight = torch.ones_like(throughput)
        med_emis = torch.zeros_like(throughput)
        scheme = torch.zeros_like(bounce)
        for mi, medium in enumerate(scene.media):
            in_m = active & (med_idx == mi)
            if not bool(in_m.any()):
                continue
            res, new_state = md.sample_distance(
                medium, scene.scene_seed, ro, rd, zeros, far, med_state, pss,
                draw(bounce, 4), in_m)
            med_state = md.select(in_m, new_state, med_state)
            vol_event = vol_event | (in_m & ~res["exited"] & ~res["failed"])
            med_t = torch.where(in_m & ~res["exited"], res["t"], med_t)
            med_aniso = _where3(in_m, res["aniso"], med_aniso)
            med_weight = _where3(in_m, res["weight"], med_weight)
            med_emis = _where3(in_m, res["emission"], med_emis)
            scheme = torch.where(in_m, res["scheme"], scheme)
            failed = failed | (in_m & res["failed"])

        active = active & ~failed
        if emissive:
            # volume emission, before the scatter weight
            emission = emission + _where3(active, throughput * med_emis, 0.0)
        throughput = throughput * _where3(vol_event, med_weight, 1.0)
        escaped = active & ~vol_event & ~did_hit
        active = active & ~escaped
        surf_event = active & ~vol_event & did_hit
        pss_next = _next_bounce(pss)

        # ---- event data ---------------------------------------------------
        vol_p = ro + torch.where(vol_event, med_t, 0.0)[:, None] * rd
        hit_prim = isect["prim"]
        hit_p = ro + torch.where(did_hit, isect["t"], 0.0)[:, None] * rd
        g_normal = isect["normal"]
        backside = dot(g_normal, rd) > 0.0
        sh_normal = _where3(backside, -g_normal, g_normal)
        bsdf_idx = prims.bsdf[hit_prim]
        tfr, bfr = tangent_frame(sh_normal)
        wi_local = frame_to_local(tfr, bfr, sh_normal, -rd)

        # emissive surfaces emit from their front side only
        prim_em = prims.emission[hit_prim]
        em_gate = (surf_event & ~backside & (prim_em.amax(dim=-1) > 0.0)
                   & (bounce >= scene.min_bounces)
                   & (was_specular | (not scene.enable_light_sampling)))
        emission = emission + _where3(em_gate, prim_em * throughput, 0.0)

        # ---- combined NEE -------------------------------------------------
        # (every volume vertex qualifies: low_order_scattering is the only
        # setting the parser accepts)
        last = bounce < scene.max_bounces - 1
        surf_gate = surf_event & last & scene.enable_light_sampling
        vol_gate = vol_event & last & scene.enable_volume_light_sampling
        gate = surf_gate | vol_gate
        p_vtx = _where3(vol_event, vol_p, hit_p)
        c = next_event(scene, p_vtx, vol_event, rd, med_aniso, scheme, med_t,
                       sh_normal, tfr, bfr, wi_local, bsdf_idx, med_idx,
                       med_state, pss_next, draw, bounce, gate, ad)
        emission = emission + _where3(gate, throughput * c, 0.0)

        if want_aovs:
            first = (surf_event | vol_event) & ~aov_seen
            aov_depth = torch.where(first, torch.where(
                vol_event, med_t, torch.where(did_hit, isect["t"], 0.0)),
                aov_depth)
            aov_normal = _where3(first, _where3(
                vol_event, safe_normalize(med_aniso), sh_normal), aov_normal)
            aov_albedo = _where3(first, _where3(
                vol_event, med_weight, scene.bsdfs.albedo[bsdf_idx]),
                aov_albedo)
            aov_vis = torch.where(first, (c.sum(dim=-1) > 0.0).to(
                torch.float32), aov_vis)
            aov_seen = aov_seen | first

        # ---- volume scattering --------------------------------------------
        new_rd = rd
        phase_ok = torch.ones_like(active)
        for mi, medium in enumerate(scene.media):
            in_m = vol_event & (med_idx == mi)
            u = torch.stack([draw(bounce, s) for s in range(8, 13)], dim=-1)
            psamp = ph.sample_phase(medium, scene.bsdfs, rd, med_aniso, u)
            new_rd = _where3(in_m, psamp["w"], new_rd)
            w_m = psamp["weight"]
            if ad and not ph.phase_is_specular(medium, scene.bsdfs):
                # the weight has the pdf cancelled: the phase's value at the
                # held direction restores its dependence on the normal
                w_m = w_m * _reattach_ratio(ph.eval_phase(
                    medium, scene.bsdfs, rd, psamp["w"].detach(), med_aniso))
            throughput = throughput * _where3(in_m, w_m, 1.0)
            phase_ok = phase_ok & torch.where(in_m, psamp["valid"], True)
            # the JAX package's ~(enable_volume_light_sampling &
            # (medium_bounces > 0 | low_order_scattering)), with
            # low_order_scattering true (the only setting the parser takes)
            was_specular = torch.where(
                in_m, not scene.enable_volume_light_sampling, was_specular)
        active = active & (phase_ok | ~vol_event)
        ro = _where3(vol_event, vol_p, ro)
        rd = _where3(vol_event, new_rd, rd)

        # ---- surface scattering -------------------------------------------
        u = torch.stack([draw(bounce, s) for s in range(16, 21)], dim=-1)
        s = bs.sample_bsdf(scene.bsdfs, bsdf_idx, wi_local, u)
        active = active & ~(surf_event & ~s["valid"])
        surf_scatter = surf_event & s["valid"]
        is_fwd = bs.is_forward(scene.bsdfs, bsdf_idx)
        wo_world = _where3(surf_scatter & is_fwd, rd,
                           frame_to_world(tfr, bfr, sh_normal, s["wo"]))
        s_w = s["weight"]
        if ad:
            s_w = s_w * torch.where(s["specular"][:, None], 1.0,
                                    _reattach_ratio(bs.eval_bsdf(
                                        scene.bsdfs, bsdf_idx, wi_local,
                                        s["wo"].detach())))
        throughput = throughput * _where3(surf_scatter, s_w, 1.0)
        # a passthrough keeps wasSpecular from the last real scatter
        passthrough = is_fwd | ((s["wo"] + wi_local).abs().sum(dim=-1)
                                < 1e-6)
        was_specular = torch.where(surf_scatter & ~passthrough,
                                   s["specular"], was_specular)

        geom_back = dot(wo_world, g_normal) < 0.0
        int_m = prims.int_medium[hit_prim]
        ext_m = prims.ext_medium[hit_prim]
        new_med = torch.where(geom_back, int_m, ext_m)
        crossed = geom_back != (dot(-rd, g_normal) < 0.0)
        med_idx = torch.where(surf_scatter & ((int_m >= 0) | (ext_m >= 0)),
                              new_med, med_idx)
        med_state = med_state.reset_where(surf_scatter & crossed)
        ro = _where3(surf_scatter, hit_p + wo_world * EPS, ro)
        rd = _where3(surf_scatter, wo_world, rd)

        # ---- bookkeeping --------------------------------------------------
        thr_max = throughput.abs().amax(dim=-1)
        active = active & (thr_max > 0.0)
        rr = active & (bounce > 2) & (thr_max < 0.1)
        survive = draw(bounce, 30) < thr_max
        throughput = _where3(rr & survive,
                             throughput / torch.clamp(thr_max, min=1e-9)[
                                 :, None], throughput)
        active = active & (~rr | survive)
        consumed = vol_event | (surf_scatter & ~is_fwd)
        bounce = bounce + (active & consumed).to(torch.int64)
        active = active & (bounce < scene.max_bounces)
        active = active & torch.isfinite(throughput.sum(dim=-1)
                                         + rd.sum(dim=-1))
    emission = torch.where(torch.isfinite(emission), emission, 0.0)
    if want_aovs:
        return emission, {"depth": aov_depth, "normal": aov_normal,
                          "albedo": aov_albedo, "visibility": aov_vis}
    return emission


def _pixels(scene, rows):
    """(px, py) [n] int64 of the rows range(*rows), row-major."""
    W = scene.camera.res_x
    r0, r1 = rows if rows is not None else (0, scene.camera.res_y)
    dev = scene.lights.device
    py, px = torch.meshgrid(torch.arange(r0, r1, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def render_pass(scene, spp_idx, rows=None, qmc=None):
    """One sample (or one per entry of an [S] tensor of sample indices)
    for every pixel of the rows range(*rows) (all rows by default);
    returns [rows, W, 3] (summed over the S samples).  A pixel's value
    depends on its own words only, so a band of rows renders what the
    whole frame renders there.  `qmc`: Sobol points (see trace)."""
    W = scene.camera.res_x
    px, py = _pixels(scene, rows)
    spp = torch.as_tensor(spp_idx, dtype=torch.int64,
                          device=px.device).reshape(-1)
    n = px.numel()
    c = trace(scene, px.repeat(len(spp)), py.repeat(len(spp)),
              spp.repeat_interleave(n), qmc=qmc)
    return c.reshape(len(spp), n // W, W, 3).sum(dim=0)


def render_aovs(scene, spp_idx):
    """One sample per pixel and its feature buffers: (image [H, W, 3],
    {"depth": [H, W], "normal": [H, W, 3], "albedo": [H, W, 3],
    "visibility": [H, W]}), as the JAX package's render_aovs."""
    H, W = scene.camera.res_y, scene.camera.res_x
    px, py = _pixels(scene, None)
    c, aovs = trace(scene, px, py, spp_idx, want_aovs=True)
    return c.reshape(H, W, 3), {k: v.reshape(H, W, *v.shape[1:])
                                for k, v in aovs.items()}
