"""The function-space GPIS medium batched over rays: the renewal and
renewal+ march of tungsten_tpu/models/fs_medium.py (`_sample_chunk_fast`,
`_find_crossing`, `_sample_grad_at`, `sample_distance_fs_one` and the CSG
union `sample_distance_fs_one_csg`).

Each ray's segment is cut into chunks of `sample_points` stratified points
(one chunk when step_size is 0).  A chunk draws one joint realization of
the chunk's values and of the along-ray derivative at its end, conditioned
on what the ray carries at the chunk's start (its value and along-ray
derivative under renewal+, its value under renewal; a first segment that
starts at a surface conditions on a sampled positive start value); the
march stops at the first sign change, and after it the 3D gradient at the
crossing (or at the segment's end) is drawn conditioned on the chunk's
values up to the crossing and on the crossing's value and derivative.  A
CSG union samples both children independently (the right one on its own
hash stream), marches the pointwise min, keeps each child's carry and
gradient, and returns the gradient of the child that attains the min.

The Global and None contexts draw each chunk by the general sampler
(`sample_chunk_general`, the JAX package's `_sample_chunk`): under Global
the chunk's n values are conditioned on the ray's ring of FS_RING rows
(the values at earlier chunk ends and the value and along-ray derivative
at earlier crossings; rows not yet filled move FAR, where they covary
with nothing), under None they are the prior's, drawn by the constrained
sampler so that the first value is positive.  The ring grows by each
chunk's end value inside the loop and by the crossing's two rows after
it.  The JAX package samples the 3D gradient in every chunk of these
contexts and keeps the last chunk's; its stream does not depend on the
chunk, so here it is drawn once, after the loop, from the last chunk.
With `skip_space` > 0 each segment first skips the probes of a block of
SKIP_PROBES points at which the GP is below 0 with a probability under
skip_space (`skip_space_advance`).  A GP conditioned on a mesh
(ops/gp.py GlobalCond) conditions every solve on its mesh rows.

The JAX package vmaps a `lax.while_loop` over rays; here the chunk loop
runs over the batch of rays still marching, gathered once per chunk (one
host sync per chunk, at most MAX_CHUNKS chunks, none per ray).  The dense
problems, [R, n + 1]-square per renewal chunk, the ring's [R, FS_RING]
and the chunk's [R, n] under Global and None, and [R, n + 2]-square per
gradient, are solved through K8's eigendecompositions (ops/gp.py,
kernels/psd.py).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import gp as gpmod
from ..ops import sparse_conv as sc
from ..utils import rng
from ..utils.vecmath import dot, frame_to_world, tangent_frame

MAX_CHUNKS = 64
SKIP_PROBES = 128  # the free-flight skip's probe block
# the skip's total length and rays, accumulated on the device by every
# segment that skips (read by a caller that reports them)
SKIPPED = {"length": 0.0, "rays": 0}
FAR_ROW = 1.0e5  # masked conditioning rows move here (zero covariance)
CSG_SALT = 0x9E3779B9  # the right child's hash stream
_GRAD_CHUNK = 0xD00D  # the chunk word of the gradient's stream


def chunk_key(pss, scene_seed, chunk, salt=0):
    """The stream of one chunk of each ray: pss [R, 4] words, the scene
    seed, the chunk index (a Python int) and a CSG child's salt."""
    k = (rng.xxhash32_4(pss[:, 0], pss[:, 1], pss[:, 2], pss[:, 3])
         + rng.xxhash32(scene_seed) + rng.xxhash32(chunk)) & rng.MASK32
    return k ^ salt if salt else k


def csg_children(gp):
    """(left, right) GPs of a CSG union."""
    return (dataclasses.replace(gp, csg_right=None, mean_additional=None),
            gp.csg_right)


def _rows_of(ro, rd, n):
    """Direction rows [R, n, 3] along each ray."""
    return rd[:, None, :].expand(ro.shape[0], n, 3)


def _stratified(ro, rd, t0, dt, n, u_offset):
    """n stratified distances ts [R, n] from t0 [R] at step dt [R]
    (jittered by u_offset [R]) and their points [R, n, 3]."""
    i = torch.arange(n, dtype=torch.float32, device=ro.device)
    frac = torch.clamp((i - u_offset[:, None]) / (n - 1), 0.0, 1.0)
    ts = (t0 + dt * 0.1)[:, None] + (dt * n - dt * 0.1)[:, None] * frac
    ts[:, 0] = t0 + dt * 0.1
    ts[:, n - 1] = t0 + dt * n
    return ts, ro[:, None] + ts[..., None] * rd[:, None]


def sample_chunk_general(gp, ctxt, scene_seed, ro, rd, t0, dt, n, ring, pss,
                         chunk, u_offset):
    """One chunk of n points from t0 [R] per ray under the Global context
    (ring: (pts [R, K, 3], values [R, K], kinds [R, K], count [R]), the
    conditioning rows) or the None context (the prior, its first value
    constrained to be positive).  Returns (ts [R, n], values [R, n],
    ids [R, n])."""
    R, dev = ro.shape[0], ro.device
    ts, pts = _stratified(ro, rd, t0, dt, n, u_offset)
    dts = torch.full((n,), gpmod.D_NONE, dtype=torch.int64, device=dev)
    dirs = _rows_of(ro, rd, n)
    key = chunk_key(pss, scene_seed, chunk)
    if ctxt == sc.CTXT_GLOBAL:
        # a ring with no valid row conditions on rows that covary with
        # nothing: the prior, to the bit (zero cross covariances)
        r_pts, r_vals, r_dts, r_n = ring
        K = r_vals.shape[1]
        kidx = torch.arange(K, device=dev)
        keep = kidx[None] < r_n[:, None]
        far = FAR_ROW * (2.0 + kidx.to(torch.float32))[None, :, None] \
            + ro[:, None]
        mean, root, ids = gpmod.conditional_mvn(
            gp, pts, dts, dirs, torch.where(keep[..., None], r_pts, far),
            torch.where(keep, r_dts, gpmod.D_NONE), _rows_of(ro, rd, K),
            torch.where(keep, r_vals, 0.0))
        return ts, gpmod.sample_mvn(mean, root, key, 11), ids
    mean, root, ids = gpmod.prior_mvn(gp, pts, dts, dirs)
    vals, _ = gpmod.sample_mvn_constrained(
        mean, root, key, 11, 0.0, 3e38,
        torch.arange(n, device=dev) == 0)
    return ts, vals, ids


def ring_push(ring, pt, val, kind, enable):
    """Append the row (pt [R, 3], val [R], kind) to each ring where enable
    [R], the oldest row evicted from a full ring."""
    r_pts, r_vals, r_dts, r_n = ring
    K = r_vals.shape[1]
    full = (r_n >= K) & enable
    r_pts = torch.where(full[:, None, None], torch.roll(r_pts, -1, 1), r_pts)
    r_vals = torch.where(full[:, None], torch.roll(r_vals, -1, 1), r_vals)
    r_dts = torch.where(full[:, None], torch.roll(r_dts, -1, 1), r_dts)
    slot = torch.clamp(r_n, max=K - 1)
    at = (torch.arange(K, device=r_n.device)[None] == slot[:, None]) \
        & enable[:, None]
    r_pts = torch.where(at[..., None], pt[:, None], r_pts)
    r_vals = torch.where(at, val[:, None], r_vals)
    r_dts = torch.where(at, kind, r_dts)
    return r_pts, r_vals, r_dts, torch.where(enable,
                                             torch.clamp(r_n + 1, max=K), r_n)


def skip_space_advance(gp, skip_space, step_size, ro, rd, near, far):
    """near [R] moved past the probes near + i step (i = 1 ... SKIP_PROBES,
    step the medium's step_size or 0.01) before the first at which P(f <
    0) >= skip_space or that reaches far, at most to far."""
    step = float(step_size) if float(step_size) > 0 else 0.01
    i = torch.arange(1, SKIP_PROBES + 1, dtype=torch.float32,
                     device=ro.device)
    ts = near[:, None] + i * step
    ps = ro[:, None] + ts[..., None] * rd[:, None]
    cdf = gpmod.gp_cdf(gp, ps.reshape(-1, 3)).reshape(ts.shape)
    stop = (cdf >= skip_space) | (ts >= far[:, None])
    first = torch.where(stop, torch.arange(SKIP_PROBES, device=ro.device),
                        SKIP_PROBES).amin(dim=1)
    out = torch.minimum(near + first.to(torch.float32) * step, far)
    SKIPPED["length"] = SKIPPED["length"] + (out - near).sum()
    SKIPPED["rays"] += ro.shape[0]
    return out


def sample_chunk(gp, renewal_plus, scene_seed, ro, rd, t0, dt, n, carry_val,
                 carry_grad, have_carry, pss, chunk, u_offset, salt=0):
    """One chunk of n points from t0 [R] per ray (step dt [R], stratified
    by u_offset [R]), as one joint solve: the conditioning rows are the
    value and along-ray derivative at t0 (masked by the context and the
    carry), the queries the n values and the derivative at the chunk's end.
    Returns (ts [R, n], values [R, n], end derivative [R], ids [R, n])."""
    R, dev = ro.shape[0], ro.device
    ts, pts = _stratified(ro, rd, t0, dt, n, u_offset)
    key = chunk_key(pss, scene_seed, chunk, salt)
    p0 = ro + t0[:, None] * rd

    # rows: [p0 value, p0 derivative | n point values, end derivative]
    rows = torch.cat([p0[:, None], p0[:, None], pts, pts[:, -1:]], dim=1)
    kinds = torch.tensor([gpmod.D_NONE, gpmod.D_FIRST] + [gpmod.D_NONE] * n
                         + [gpmod.D_FIRST], device=dev)
    dirs = _rows_of(ro, rd, n + 3)
    C = gpmod.cov_matrix(gp.cov, rows, kinds, dirs, rows, kinds, dirs)
    mv, ids = gpmod.mean_vector(gp, rows, kinds, dirs)
    s11, s12, s22 = C[:, :2, :2], C[:, :2, 2:], C[:, 2:, 2:]
    m1, m2 = mv[:, :2], mv[:, 2:]
    kvv = C[:, 0, 0]

    # no carry yet: the first chunk conditions on a sampled positive start
    # value, a later one falls back to the prior (both rows masked)
    first = ~have_carry & (chunk == 0)
    later = ~have_carry & (chunk > 0)
    v0 = torch.clamp(gpmod.sample_truncated_normal(
        m1[:, 0], torch.sqrt(torch.clamp(kvv, min=1e-20)), 0.0, key, 7),
        min=0.0)
    y = torch.stack([torch.where(first, v0, carry_val), carry_grad], dim=-1)
    keep = torch.stack([~later, have_carry if renewal_plus
                        else torch.zeros_like(have_carry)], dim=-1)
    scale = torch.clamp(kvv, min=1e-12)
    eye = torch.eye(2, dtype=torch.float32, device=dev)
    s11m = torch.where(keep[:, :, None] & keep[:, None, :], s11,
                       eye * scale[:, None, None])
    s12m = torch.where(keep[:, :, None], s12, 0.0)
    ym = torch.where(keep, y - m1, 0.0)
    # closed-form 2x2 solve with relative jitter
    a_ = s11m[:, 0, 0] + 1e-6 * scale
    b_ = s11m[:, 0, 1]
    c_ = s11m[:, 1, 1] + 1e-6 * scale
    det = torch.maximum(a_ * c_ - b_ * b_, 1e-20 * scale * scale)
    inv = torch.stack([torch.stack([c_, -b_], dim=-1),
                       torch.stack([-b_, a_], dim=-1)], dim=-2) / det[
                           :, None, None]
    solved = torch.matmul(inv, s12m)  # [R, 2, n + 1]
    mean = m2 + torch.matmul(solved.transpose(1, 2), ym[..., None])[..., 0]
    s2 = s22 - torch.matmul(s12m.transpose(1, 2), solved)
    root = gpmod.sqrt_psd((0.5 * (s2 + s2.transpose(1, 2))).contiguous())
    joint = gpmod.sample_mvn(mean, root, key, 11)
    return ts, joint[:, :n], joint[:, n], ids[:, 2:n + 2]


def _at(x, i):
    return x.gather(1, i[:, None])[:, 0]


def find_crossing(ts, vals, skip_first):
    """First sign change of vals [R, n] (after the first step where
    skip_first): (crossed [R], idx [R], t [R], off [R]), with idx 0 where
    nothing crossed."""
    n = vals.shape[1]
    s = torch.where(vals < 0, -1, 1)
    ar = torch.arange(n - 1, device=vals.device)
    flips = (s[:, 1:] != s[:, :-1]) & (ar >= skip_first.long()[:, None])
    crossed = flips.any(dim=1)
    idx = torch.where(flips, ar, n - 1).amin(dim=1)
    idx = torch.where(crossed, idx, 0)
    v0, v1 = _at(vals, idx), _at(vals, idx + 1)
    off = v0 / torch.where(v0 == v1, 1.0, v0 - v1)
    t0, t1 = _at(ts, idx), _at(ts, idx + 1)
    return crossed, idx, t0 + (t1 - t0) * off, off


def _interp(vals, idx, off):
    v0 = _at(vals, idx)
    return v0 + (_at(vals, idx + 1) - v0) * off


def _slope(ts, vals, idx):
    """d/dt toward +t at the bracket: (v_i - v_i+1) / (t_i - t_i+1)."""
    dtl = _at(ts, idx) - _at(ts, idx + 1)
    return (_at(vals, idx) - _at(vals, idx + 1)) / torch.where(dtl == 0, 1.0,
                                                             dtl)


def sample_grad_at(gp, scene_seed, ro, rd, ts, vals, idx, t_cross, off,
                   crossed, pss, end_deriv, salt=0):
    """The conditioned 3D gradient [R, 3] at the crossing, or at the
    segment's end where nothing crossed: conditioned on the chunk's values
    before the crossing (the rows after it move FAR), the crossing's value
    and its along-ray derivative (end_deriv where nothing crossed, the
    value row then FAR); the along-ray component is pinned to that
    derivative and the two tangential ones are drawn.  Without end_deriv
    (the Global and None contexts), a ray that crossed nothing conditions
    on its chunk's values alone and draws all three components."""
    R, n = ts.shape
    dev = ro.device
    v_cross = _interp(vals, idx, off)
    dv_cross = _slope(ts, vals, idx)
    ip = ro + torch.where(crossed, t_cross, ts[:, -1])[:, None] * rd
    ar = torch.arange(n, device=dev)
    keep = torch.where(crossed[:, None], ar[None] < idx[:, None], True)
    row_pts = torch.where(
        keep[..., None], ro[:, None] + ts[..., None] * rd[:, None],
        ro[:, None] + FAR_ROW * (2.0 + ar.to(torch.float32))[None, :, None])
    row_vals = torch.where(keep, vals, 0.0)
    have_ed = end_deriv is not None
    if not have_ed:
        end_deriv = torch.zeros_like(v_cross)
    extra_vals = torch.stack([torch.where(crossed, v_cross, 0.0),
                              torch.where(crossed, dv_cross, end_deriv)],
                             dim=-1)
    far_pts = ro[:, None] + FAR_ROW * torch.tensor(
        [[1.002], [1.004]], dtype=torch.float32, device=dev)
    extra_keep = torch.stack([crossed, torch.ones_like(crossed) if have_ed
                              else crossed], dim=-1)
    extra_pts = torch.where(extra_keep[..., None], ip[:, None], far_pts)
    cond_pts = torch.cat([row_pts, extra_pts], dim=1)
    cond_dts = torch.tensor([gpmod.D_NONE] * (n + 1) + [gpmod.D_FIRST],
                            device=dev)
    cond_vals = torch.cat([row_vals, extra_vals], dim=1)
    tg, bt = tangent_frame(rd)
    qry_pts = ip[:, None].expand(R, 3, 3)
    qry_dts = torch.full((3,), gpmod.D_FIRST, device=dev)
    qry_dirs = torch.stack([tg, bt, rd], dim=1)
    mean, root, _ = gpmod.conditional_mvn(
        gp, qry_pts, qry_dts, qry_dirs, cond_pts, cond_dts,
        _rows_of(ro, rd, n + 2), cond_vals)
    g = gpmod.sample_mvn(mean, root,
                         chunk_key(pss, scene_seed, _GRAD_CHUNK, salt), 23)
    gz = torch.where(crossed, dv_cross, end_deriv if have_ed else g[:, 2])
    return frame_to_world(tg, bt, rd, torch.stack([g[:, 0], g[:, 1], gz],
                                                  dim=-1))


def _march_general(med, scene_seed, ro, rd, near, far, first_scatter, ring,
                   pss, u_offset, want_grad):
    """The Global and None contexts' chunk loop over rays that are all
    active (see `sample_distance_fs`); ring: the rays' Global-context rows
    (None under the None context)."""
    gp, n = med.gp, med.sample_points
    R, dev = ro.shape[0], ro.device
    dt_full = torch.clamp(far - near, min=1e-6) / n
    step = med.step_size
    dt = torch.where((step > 0) & (step < dt_full), step, dt_full)
    is_global = med.cfg.ctxt == sc.CTXT_GLOBAL
    t0 = near.clone()
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    t_hit = far.clone()
    cv = torch.zeros(R, dtype=torch.float32, device=dev)
    gp_id = torch.zeros(R, dtype=torch.int64, device=dev)
    ts = torch.zeros(R, n, dtype=torch.float32, device=dev)
    vals = torch.zeros(R, n, dtype=torch.float32, device=dev)
    idx = torch.zeros(R, dtype=torch.int64, device=dev)
    off = torch.zeros(R, dtype=torch.float32, device=dev)
    if is_global:
        ring = [x.clone() for x in ring]

    run = torch.arange(R, device=dev)
    for chunk in range(MAX_CHUNKS):
        if run.numel() == 0:
            break
        ring_r = tuple(x[run] for x in ring) if is_global else None
        ts_r, v, ids = sample_chunk_general(
            gp, med.cfg.ctxt, scene_seed, ro[run], rd[run], t0[run],
            dt[run], n, ring_r, pss[run], chunk, u_offset[run])
        skip_first = ~first_scatter[run] & (chunk == 0)
        crossed, i, t_cross, o = find_crossing(ts_r, v, skip_first)
        far_r = far[run]
        t_end = ts_r[:, -1]
        t0[run] = t_end
        hit[run] = crossed
        t_hit[run] = torch.where(crossed, t_cross, far_r)
        cv[run] = torch.where(crossed, _interp(v, i, o), v[:, -1])
        gp_id[run] = torch.where(crossed, _at(ids, i), ids[:, -1])
        ts[run], vals[run], idx[run], off[run] = ts_r, v, i, o
        if is_global:
            # each chunk that crosses nothing leaves its end value
            p_end = ro[run] + t_end[:, None] * rd[run]
            new = ring_push(ring_r, p_end, v[:, -1], gpmod.D_NONE, ~crossed)
            for dst, src in zip(ring, new):
                dst[run] = src
        run = run[~crossed & (t_end < far_r - 1e-6)]  # one host sync

    out = {"hit": hit, "t": t_hit, "gp_id": gp_id, "vals": [cv]}
    if is_global:
        out["ring"] = ring
    if want_grad:
        grad = sample_grad_at(gp, scene_seed, ro, rd, ts, vals, idx, t_hit,
                              off, hit, pss, None)
        out["grads"] = [grad]
        out["grad"] = grad
        if is_global:
            # a crossing leaves its value (0) and its along-ray derivative
            ip = ro + t_hit[:, None] * rd
            ring = ring_push(ring, ip, torch.zeros_like(t_hit),
                             gpmod.D_NONE, hit)
            out["ring"] = ring_push(ring, ip, dot(grad, rd), gpmod.D_FIRST,
                                    hit)
    return out


def _march(med, scene_seed, ro, rd, near, far, first_scatter, carries,
           have_carry, pss, u_offset, want_grad, ring=None):
    """The chunk loop over rays that are all active; see
    `sample_distance_fs`."""
    if med.skip_space > 0.0 and med.gp.csg_right is None:
        near = skip_space_advance(med.gp, med.skip_space, med.step_size, ro,
                                  rd, near, far)
    if med.cfg.ctxt not in (sc.CTXT_RENEWAL, sc.CTXT_RENEWAL_PLUS):
        return _march_general(med, scene_seed, ro, rd, near, far,
                              first_scatter, ring, pss, u_offset, want_grad)
    gps = ((med.gp,) if med.gp.csg_right is None
           else csg_children(med.gp))
    salts = (0, CSG_SALT)[:len(gps)]
    n = med.sample_points
    R, dev = ro.shape[0], ro.device
    dt_full = torch.clamp(far - near, min=1e-6) / n
    step = med.step_size
    dt = torch.where((step > 0) & (step < dt_full), step, dt_full)
    renewal_plus = med.cfg.ctxt == sc.CTXT_RENEWAL_PLUS

    t0 = near.clone()
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    t_hit = far.clone()
    cv = [c[0].clone() for c in carries]
    cg = [c[1].clone() for c in carries]
    have = have_carry.clone()
    gp_id = torch.zeros(R, dtype=torch.int64, device=dev)
    ts = torch.zeros(R, n, dtype=torch.float32, device=dev)
    vals = [torch.zeros(R, n, dtype=torch.float32, device=dev) for _ in gps]
    ed = [torch.zeros(R, dtype=torch.float32, device=dev) for _ in gps]
    idx = torch.zeros(R, dtype=torch.int64, device=dev)
    off = torch.zeros(R, dtype=torch.float32, device=dev)

    run = torch.arange(R, device=dev)
    for chunk in range(MAX_CHUNKS):
        if run.numel() == 0:
            break
        draws = [sample_chunk(gp, renewal_plus, scene_seed, ro[run], rd[run],
                              t0[run], dt[run], n, cv[c][run], cg[c][run],
                              have[run], pss[run], chunk, u_offset[run], salt)
                 for c, (gp, salt) in enumerate(zip(gps, salts))]
        ts_r = draws[0][0]
        if len(draws) == 1:
            v, ids = draws[0][1], draws[0][3]
        else:
            v = torch.minimum(draws[0][1], draws[1][1])
            ids = torch.where(draws[0][1] <= draws[1][1], 0, 1)
        skip_first = ~first_scatter[run] & (chunk == 0)
        crossed, i, t_cross, o = find_crossing(ts_r, v, skip_first)
        far_r = far[run]
        t_end = ts_r[:, -1]
        t0[run] = t_end
        hit[run] = crossed
        t_hit[run] = torch.where(crossed, t_cross, far_r)
        for c, (_, vals_c, ed_c, _) in enumerate(draws):
            cv[c][run] = torch.where(crossed, _interp(vals_c, i, o),
                                     vals_c[:, -1])
            cg[c][run] = torch.where(crossed, _slope(ts_r, vals_c, i), ed_c)
            vals[c][run] = vals_c
            ed[c][run] = ed_c
        have[run] = True
        gp_id[run] = torch.where(crossed, _at(ids, i), ids[:, -1])
        ts[run] = ts_r
        idx[run] = i
        off[run] = o
        run = run[~crossed & (t_end < far_r - 1e-6)]  # one host sync

    out = {"hit": hit, "t": t_hit, "gp_id": gp_id, "vals": cv}
    if want_grad:
        out["grads"] = [
            sample_grad_at(gp, scene_seed, ro, rd, ts, vals[c], idx, t_hit,
                           off, hit, pss, ed[c], salt)
            for c, (gp, salt) in enumerate(zip(gps, salts))]
        out["grad"] = (out["grads"][0] if len(gps) == 1 else torch.where(
            (gp_id == 0)[:, None], out["grads"][0], out["grads"][1]))
    return out


def sample_distance_fs(med, scene_seed, ro, rd, near, far, first_scatter,
                       carries, have_carry, pss, u_offset, active,
                       want_grad=True, ring=None):
    """The function-space march of the active rays [R].

    carries: one (value [R], along-ray derivative [R]) per child (one, or
    the CSG union's left and right) that each ray carries into the
    segment; have_carry [R]: whether it carries one; ring: the rays'
    Global-context rows (pts [R, K, 3], values [R, K], kinds [R, K], count
    [R]).  Returns hit, t (far where nothing was hit), gp_id, vals (each
    child's value at the stop point), under Global the rays' updated ring
    and, with want_grad, grads (each child's sampled 3D gradient there)
    and grad (the attaining child's); inactive rays get no hit, t = far,
    their carried values, their ring and gradient (1, 0, 0)."""
    R, dev = ro.shape[0], ro.device
    out = {"hit": torch.zeros(R, dtype=torch.bool, device=dev),
           "t": far.clone(),
           "gp_id": torch.zeros(R, dtype=torch.int64, device=dev),
           "vals": [c[0].clone() for c in carries]}
    is_global = med.cfg.ctxt == sc.CTXT_GLOBAL
    if is_global:
        out["ring"] = [x.clone() for x in ring]
    if want_grad:
        unit = torch.zeros(R, 3, dtype=torch.float32, device=dev)
        unit[:, 0] = 1.0
        out["grads"] = [unit.clone() for _ in carries]
        out["grad"] = unit
    idx = torch.nonzero(active).squeeze(1)
    if not idx.numel():
        return out
    res = _march(med, scene_seed, ro[idx], rd[idx], near[idx], far[idx],
                 first_scatter[idx], [(v[idx], g[idx]) for v, g in carries],
                 have_carry[idx], pss[idx], u_offset[idx], want_grad,
                 tuple(x[idx] for x in ring) if is_global else None)
    for k in ("hit", "t", "gp_id"):
        out[k][idx] = res[k]
    if want_grad:
        out["grad"][idx] = res["grad"]
    for k in ("vals", "grads", "ring"):
        for dst, src in zip(out.get(k, ()), res.get(k, ())):
            dst[idx] = src
    return out
