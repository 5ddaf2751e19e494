"""GPIS media batched over rays: the sparse-convolution, weight-space and
function-space branches of tungsten_tpu/models/media.py.

`sample_distance` marches each ray to the first sign change of its GP
realization, refines the crossing and samples the surface normal there;
`transmittance` runs the same search for binary visibility.

Sparse-conv noise: the march is a Python loop over steps for the whole
batch, with the raw noise sum in K1 (3D, stationary), K2 (3D, the two
multi-resolution levels of a nonstationary covariance) or K3 (1D
sampling).  The normal at a crossing comes from the general evaluator
(ops/sparse_conv.py), which blends the same two levels.  It stops
when no ray is still marching, which reads `marching.any()` on the host
once per step.  The JAX package's `[S, R]` step blocking only fills TPU
lanes; with one step per iteration the evaluated steps are the same.
Per-path realizations under a renewal context (3D: renewal and renewal+,
1D: renewal+) are first conditioned at the segment start on the value and
normal the path carries (`_precondition`).

Weight space: each ray's RFF realization is keyed by its (pixel, sample,
bounce) words; K5 marches it in fixed steps (step_size > 0) or K4
sphere-traces it (step_size == 0), one launch per search that synthesises
the basis on chip and returns the crossing with the value and gradient
there; see kernels/ws_trace.py.  Only the active rays are gathered into
these calls (the results of the others are masked anyway).

A weight-space GP outside the kernels' scope (a mean other than spherical
or homogeneous, a CSG union's additional mean, a nonstationary covariance)
takes the JAX package's plain path there: each ray's realization built as
[R, n] tensors, then the fixed-step `march` over `ws.evaluate` or
`ws.sphere_trace_segment` (`_ws_fallback`).

Function space (models/fs_medium.py): each active ray draws its segment
in chunks of jointly conditioned points and samples the normal at the
first sign change by a dense conditional solve; a CSG union marches the
min of two children and carries each child's value and gradient
(MediumState.fs_val2, fs_grad2 for the right one).  Under the Global
context each ray keeps a ring of its last FS_RING conditioning rows
(MediumState.fs_pts, fs_vals, fs_dts, fs_n) across its segments.  Its
eigensolves are K8 (kernels/psd.py).  Visibility skips the normal's
solve.

Gradients (the JAX package's detached-sampling estimator): the marches
and visibility record no graph; a sparse-conv crossing is reattached to
the GP hyperparameters by the implicit function theorem and its normal is
sampled at the reattached point.  The lattice sum's backward is K1b on
the 3D stationary path, K2b on the two multi-resolution levels of a
nonstationary covariance (whose level blend and fields stay in the graph)
and K3b on the 1D path; the renewal conditioning at a segment start
keeps the graph of the value and normal the path carries.  A weight-space
crossing is found by K5/K4 on detached parameters and reattached by the
same IFT through its realization, rebuilt in the graph for the hit rays
only (`_ws_reattach`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ws_trace as wst
from . import fs_medium as fs
from . import ndf
from ..ops import sparse_conv as sc
from ..ops import sparse_conv_fast as fast
from ..ops import weight_space as ws
from ..utils import rng
from ..utils.vecmath import (dot, frame_to_local, frame_to_world, mat_vec,
                             safe_normalize, tangent_frame)

GPIS_SPARSE_CONV = "sparse_conv_noise"
GPIS_WEIGHT_SPACE = "weight_space"
GPIS_FUNCTION_SPACE = "function_space"

# normal methods: the GP's conditioned gradient, and the microfacet
# normals around the mean's gradient.  `finite_differences` is declared
# by the JAX package but never branched on: it samples the conditioned
# normal, and so does the port.
NORMAL_CONDITIONED = "conditioned_gaussian"
NORMAL_FD = "finite_differences"
NORMAL_BECKMANN = "beckmann"
NORMAL_GGX = "ggx"
NORMAL_METHODS = (NORMAL_CONDITIONED, NORMAL_FD, NORMAL_BECKMANN, NORMAL_GGX)

FS_RING = 16  # the Global context's conditioning rows per ray


@dataclasses.dataclass(frozen=True)
class Medium:
    """A sparse-conv, weight-space or function-space GPIS medium with a
    BRDF phase function.  `cfg` carries the realization seeding of the
    first two and the correlation context of all three."""
    sigma_a: torch.Tensor  # [3]
    sigma_s: torch.Tensor  # [3]
    density: torch.Tensor  # scalar
    step_size: torch.Tensor  # scalar
    cfg: sc.SparseConvConfig
    gp: sc.GP
    bounds: torch.Tensor | None  # [2, 3] world AABB of the bounding prims
    phase_bsdf: int  # BsdfTable row of the phase function's BSDF
    min_step: int = 8
    max_march_steps: int = 8192
    kind: str = GPIS_SPARSE_CONV
    basis_functions: int = 300  # weight space: RFF basis size n
    ws_sphere_trace: bool = False  # weight space with step_size == 0
    sample_points: int = 32  # function space: points per chunk
    skip_space: float = 0.0  # function space: the cdf free-flight skip
    # "brdf" (the phase_bsdf row) or "isotropic" (the JAX package's
    # isotropic phase, which its image-level gradient checks put in place)
    phase_kind: str = "brdf"
    normal_method: str = NORMAL_CONDITIONED

    @property
    def sigma_t(self):
        return (self.sigma_a + self.sigma_s) * self.density


@dataclasses.dataclass(frozen=True)
class MediumState:
    """Per-ray medium memory: whether the segment starts at a surface
    (first_scatter), the last sampled normal and the field value at the
    last segment end (the targets of renewal conditioning), the path length
    through media so far (info_t), the 1D sampling scheme at the last
    crossing, the 1D and 3D conditioning coefficients of the current
    segment, a function-space CSG union's right child's value and
    gradient (fs_val2, fs_grad2; last_val and last_aniso then carry the
    left child's), the Global context's ring of function-space
    conditioning rows (fs_pts, fs_vals, fs_dts and the count fs_n; FS_RING
    rows, read when the state is made) and the id of the GP (mean) that
    supplied the last crossing (last_gp_id, which the microfacet normals
    read)."""
    first_scatter: torch.Tensor  # [R] bool
    last_gp_id: torch.Tensor  # [R] int64
    last_aniso: torch.Tensor  # [R, 3]
    last_val: torch.Tensor  # [R]
    info_t: torch.Tensor  # [R]
    scheme: torch.Tensor  # [R] int64
    coeff1: sc.Coeffs
    coeff3: sc.Coeffs
    fs_val2: torch.Tensor  # [R]
    fs_grad2: torch.Tensor  # [R, 3]
    fs_pts: torch.Tensor  # [R, K, 3]
    fs_vals: torch.Tensor  # [R, K]
    fs_dts: torch.Tensor  # [R, K] int64
    fs_n: torch.Tensor  # [R] int64

    @staticmethod
    def make(n, device):
        aniso = torch.zeros(n, 3, dtype=torch.float32, device=device)
        aniso[:, 0] = 1.0
        zeros = torch.zeros(n, dtype=torch.float32, device=device)
        izeros = torch.zeros(n, dtype=torch.int64, device=device)
        return MediumState(
            first_scatter=torch.ones(n, dtype=torch.bool, device=device),
            last_gp_id=izeros, last_aniso=aniso, last_val=zeros,
            info_t=zeros, scheme=izeros,
            coeff1=sc.Coeffs.zeros(n, device),
            coeff3=sc.Coeffs.zeros(n, device),
            fs_val2=zeros, fs_grad2=aniso,
            fs_pts=torch.zeros(n, FS_RING, 3, dtype=torch.float32,
                               device=device),
            fs_vals=torch.zeros(n, FS_RING, dtype=torch.float32,
                                device=device),
            fs_dts=torch.zeros(n, FS_RING, dtype=torch.int64, device=device),
            fs_n=izeros)

    @property
    def ring(self):
        return self.fs_pts, self.fs_vals, self.fs_dts, self.fs_n

    def reset_where(self, mask):
        """Fresh state on rays that cross a boundary; the path length
        through media is kept."""
        fresh = dataclasses.replace(
            MediumState.make(mask.shape[0], mask.device), info_t=self.info_t)
        return select(mask, fresh, self)


def _map_fields(fn, a, b):
    """fn over the tensor leaves of two MediumStates or two Coeffs."""
    return type(a)(**{
        f.name: (_map_fields(fn, getattr(a, f.name), getattr(b, f.name))
                 if dataclasses.is_dataclass(getattr(a, f.name))
                 else fn(getattr(a, f.name), getattr(b, f.name)))
        for f in dataclasses.fields(a)})


def select(mask, a, b):
    """Field-wise where(mask, a, b) over two MediumStates or two Coeffs."""
    def pick(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)),
                           x, y)
    return _map_fields(pick, a, b)


def cat_states(a, b):
    return _map_fields(lambda x, y: torch.cat([x, y]), a, b)


def _clamp_far_to_bounds(med, ro, rd, near, far):
    """Clamp the march to the exit of the medium's bounding box, so a ray
    that leaks past the boundary geometry does not march 2000 units."""
    if med.bounds is None:
        return far
    lo, hi = med.bounds[0], med.bounds[1]
    inv = 1.0 / torch.where(rd.abs() < 1e-9,
                            torch.where(rd < 0, -1e-9, 1e-9), rd)
    ta = (lo - ro) * inv
    tb = (hi - ro) * inv
    t_exit = torch.maximum(ta, tb).amin(dim=-1)
    margin = torch.clamp(med.step_size, min=1e-3) * 2.0
    return torch.minimum(far, torch.maximum(t_exit, near) + margin)


def make_value_at(med, scene_seed, ro, rd, pss, state):
    """value_at(t [R]) -> (f [R], gp_id [R]) along each ray: the march
    evaluators of ops/sparse_conv_fast.py, or for 1D sampling of a
    nonstationary covariance the general evaluator (as in the JAX
    package, whose 1D fast path takes stationary covariances only)."""
    cfg, gp = med.cfg, med.gp
    if cfg.one_d and not gp.cov.is_stationary:
        # sc.eval_value with the rays' seeds and iso-ray frame made once
        seed = sc.compute_seed(cfg, pss, scene_seed)
        frame = sc._ray_frame(gp.cov, rd)

        def value_at(t):
            p = ro + t[:, None] * rd
            nv = sc.eval_value_noise1d(cfg, gp, state.coeff1, p, rd, seed,
                                       True, frame)
            m, gp_id = gp.mean_and_id(p)
            return gp.cov.amplitude(p) * nv + m, cfg.gp_id(gp, p, gp_id)
        return value_at
    if cfg.one_d:
        return fast.make_value_at_1d(cfg, gp, state.coeff1, ro, rd, pss,
                                     scene_seed)
    return fast.make_value_at(cfg, gp, ro, rd, pss, scene_seed,
                              coeff3=state.coeff3)


def _precondition(med, scene_seed, ro, rd, near, state, pss, active):
    """Condition each fresh per-path realization at its segment start on
    the value and normal the path carries (rays that start at a surface
    keep their coefficients): coeff1 for 1D sampling, coeff3 for 3D."""
    if med.kind != GPIS_SPARSE_CONV or not med.cfg.activate_conditioning:
        return state
    c3, c1 = sc.conditioning(med.cfg, med.gp, state.coeff3, state.coeff1,
                             ro + near[:, None] * rd, rd, state.last_val,
                             state.last_aniso, pss, scene_seed)
    need = active & ~state.first_scatter
    if med.cfg.one_d:
        return dataclasses.replace(state,
                                   coeff1=select(need, c1, state.coeff1))
    return dataclasses.replace(state, coeff3=select(need, c3, state.coeff3))


def march(med, value_at, near, far, state, u_jitter, active, refine=True):
    """Fixed-step sign-change march to the first crossing.

    The first step after an interior scatter is absorbed (it sets the
    starting sign and cannot flip); a flip records the bracket
    (t_hi, f_lo, f_hi), which 6 Illinois false-position steps refine.
    Returns (hit [R], t [R])."""
    step = torch.clamp(torch.minimum(med.step_size,
                                     (far - near) / med.min_step), min=1e-6)
    f0, _ = value_at(near)
    sign0 = torch.where(f0 < 0, -1, 1)
    t = near + step * u_jitter
    pf = f0
    first = True
    crossed = torch.zeros_like(active)
    t_hi, f_hi, f_lo = far, torch.zeros_like(f0), f0
    marching = active & (t < far)
    for _ in range(med.max_march_steps):
        if not bool(marching.any()):
            break
        f, _ = value_at(t)
        signs = torch.where(f < 0, -1, 1)
        absorb = ~state.first_scatter if first else torch.zeros_like(active)
        sign0 = torch.where(absorb, signs, sign0)
        flip = (signs != sign0) & (t < far) & ~absorb & marching
        crossed = crossed | flip
        t_hi = torch.where(flip, t, t_hi)
        f_hi = torch.where(flip, f, f_hi)
        f_lo = torch.where(flip, pf, f_lo)
        pf = torch.where(marching, f, pf)
        t_next = t + step
        t = torch.where(marching, t_next, t)
        marching = marching & ~flip & (t_next < far)
        first = False

    if not refine:
        return crossed & active, torch.where(crossed, t_hi, far)

    lo = torch.maximum(t_hi - step, near)
    hi, flo, fhi = t_hi, f_lo, f_hi
    for _ in range(6):
        denom = flo - fhi
        tiny = denom.abs() < 1e-30
        mid_s = lo + flo * (hi - lo) / torch.where(tiny, 1.0, denom)
        mid = torch.where(tiny | (mid_s <= lo) | (mid_s >= hi),
                          0.5 * (lo + hi), mid_s)
        fm, _ = value_at(torch.where(crossed, mid, near))
        start_side = torch.where(fm < 0, -1, 1) == sign0
        lo = torch.where(crossed & start_side, mid, lo)
        hi = torch.where(crossed & ~start_side, mid, hi)
        flo, fhi = (torch.where(start_side, fm, flo * 0.5),
                    torch.where(start_side, fhi * 0.5, fm))
    t_hit = torch.where(crossed, hi, far)
    return crossed & active, torch.where(active, t_hit, far)


def _ws_key(med, pss):
    """Each ray's realization key from its words pss [R, 4] (a single
    realization takes the words of pixel 0, sample 0)."""
    cfg = med.cfg
    if cfg.use_single_realization:
        pss, is_global = torch.zeros_like(pss), True
    else:
        is_global = cfg.ctxt == sc.CTXT_GLOBAL
    return ws.realization_key(pss, cfg.global_seed, is_global)


def _ws_search(med, ro, rd, near, far, first_scatter, pss, u_jitter,
               refine=True, evaluate=True):
    """The first crossing of weight-space rays (all active): K5's march for
    step_size > 0, K4's sphere trace for step_size == 0, or the plain
    fallback where the GP is outside the kernels' scope.  Returns a dict:
    hit, t (far where nothing was hit) and, if `evaluate`, the
    realization's value, gradient and gp_id at ro + t rd."""
    if not wst.supports(med.gp):
        return _ws_fallback(med, ro, rd, near, far, first_scatter, pss,
                            u_jitter, refine, evaluate)
    key = _ws_key(med, pss)
    n = med.basis_functions
    if med.ws_sphere_trace:
        # a segment that starts at an interior scatter skips its surface
        near_st = near + torch.where(first_scatter, 0.0, 2e-3)
        res = wst.sphere_trace_batch(med.gp, n, key, ro, rd, near_st, far,
                                     evaluate=evaluate)
    else:
        step = torch.clamp(torch.minimum(med.step_size,
                                         (far - near) / med.min_step),
                           min=1e-6)
        res = wst.fixed_march_batch(med.gp, n, key, ro, rd, near, far, step,
                                    u_jitter, ~first_scatter,
                                    max_steps=med.max_march_steps,
                                    refine=refine, evaluate=evaluate)
    # the kernels' scope has no additional mean: every value is GP 0's
    res["gp_id"] = torch.zeros(ro.shape[0], dtype=torch.int64,
                               device=ro.device)
    return res


@dataclasses.dataclass(frozen=True)
class _MarchState:
    first_scatter: torch.Tensor


def _ws_fallback(med, ro, rd, near, far, first_scatter, pss, u_jitter,
                 refine=True, evaluate=True):
    """`_ws_search` in plain PyTorch for any weight-space GP, as the JAX
    package runs it outside its kernels' scope: each ray's realization
    (its basis drawn by the covariance's own spectral draw) as [R, n]
    tensors, then `ws.sphere_trace_segment` (step_size == 0) or the
    fixed-step `march` over `ws.evaluate`; the end point's value, gradient
    and gp_id by `ws.evaluate` and `ws.evaluate_gradient`."""
    real = wst.realization(med.gp, med.basis_functions, _ws_key(med, pss))
    if med.ws_sphere_trace:
        near_st = near + torch.where(first_scatter, 0.0, 2e-3)
        hit, t = ws.sphere_trace_segment(real, med.gp, ro, rd, near_st, far)
    else:
        def value_at(tt):
            return ws.evaluate(real, med.gp, ro + tt[:, None] * rd)
        hit, t = march(med, value_at, near, far, _MarchState(first_scatter),
                       u_jitter, torch.ones_like(first_scatter), refine)
    res = {"hit": hit, "t": t}
    if evaluate:
        ip = ro + t[:, None] * rd
        res["val"], res["gp_id"] = ws.evaluate(real, med.gp, ip)
        res["grad"] = ws.evaluate_gradient(real, med.gp, ip)
    return res


def sample_gradient(med, scene_seed, p, pss, rd=None, t_segment=None,
                    coeff1=None, coeff3=None):
    """The conditioned-Gaussian normal of a sparse-conv medium: the GP
    gradient at p [R, 3]; a 1D-sampled one takes the rays' directions,
    distances from the segment start and conditioning coefficients, an
    isotropic-ray 3D one the directions and a conditioned 3D one its
    coefficients (a weight-space medium's comes with its search,
    `_ws_search`)."""
    return sc.eval_gradient(med.cfg, med.gp, p, pss, scene_seed, ray_dir=rd,
                            t_segment=t_segment, coeff1=coeff1,
                            coeff3=coeff3)


def microfacet_normal(med, scene_seed, p, rd, pss, gp_id):
    """The `beckmann` or `ggx` normal at p [R, 3]: a visible normal of the
    distribution with roughness min(compute_beckmann_roughness(p), 10)
    around the gradient of the mean with id gp_id, for the incoming
    direction -rd, from the uniforms 0 and 1 of each ray's own stream."""
    n_mean = safe_normalize(med.gp.mean_grad_by_id(p, gp_id))
    t, b = tangent_frame(n_mean)
    wi = frame_to_local(t, b, n_mean, -rd)
    wi = torch.stack([wi[:, 0], wi[:, 1],
                      torch.clamp(wi[:, 2].abs(), min=1e-4)], dim=-1)
    alpha = torch.clamp(med.gp.cov.compute_beckmann_roughness(p),
                        max=10.0).expand(p.shape[:-1])
    key = rng.xxhash32_4(pss[:, 0], pss[:, 1], pss[:, 2],
                         pss[:, 3] ^ 0x9D2C5680) ^ (scene_seed & rng.MASK32)
    u1, u2 = rng.uniform(key, 0), rng.uniform(key, 1)
    sample = (ndf.sample_vndf_beckmann if med.normal_method == NORMAL_BECKMANN
              else ndf.sample_vndf_ggx)
    return frame_to_world(t, b, n_mean, sample(wi, alpha, u1, u2))


def _far_eff(med, ro, rd, near, far):
    # Ray::infinity clamp, then the bounding box
    far = torch.where(far < 1e30, far, near + 2000.0)
    return _clamp_far_to_bounds(med, ro, rd, near, far)


def _crossing_ws(med, scene_seed, ro, rd, near, far, state, pss, u_jitter,
                 active):
    """(hit, t, normal, value at t, gp_id) of the weight-space search,
    computed on the active rays only; inactive rays get no hit, t = far,
    their last normal and their last value."""
    hit = torch.zeros_like(active)
    t = far.clone()
    grad = state.last_aniso.clone()
    val = state.last_val.clone()
    gp_id = torch.zeros(active.shape, dtype=torch.int64, device=ro.device)
    idx = torch.nonzero(active).squeeze(1)
    if idx.numel():
        res = _ws_search(med, ro[idx], rd[idx], near[idx], far[idx],
                         state.first_scatter[idx], pss[idx], u_jitter[idx])
        val[idx], grad[idx] = res["val"], res["grad"]
        hit[idx], t[idx], gp_id[idx] = res["hit"], res["t"], res["gp_id"]
    return hit, t, grad, val, gp_id


def detach(tree):
    """A dataclass tree (a Medium, a GP, a covariance) with every tensor
    detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: detach(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _ws_reattach(med, ro, rd, t, hit, grad_k, pss):
    """The weight-space crossing t [R] and normal [R, 3] of the search,
    reattached to the medium's parameters and the rays.

    On the hit rays the realization is rebuilt from its key with sigma and
    l in the graph (`ws.noise_at`: f = sqrt(cov(p, p)) S + mean) at the
    detached p = ro + t rd.  t takes the IFT step of `_reattach_crossing`
    with dfdt = grad_k . rd, the t-derivative of the realization that the
    kernel's gradient grad_k already gives (grazing crossings, |dfdt| <=
    1e-3, stay detached).  The normal is the realization's gradient at the
    reattached point p_r, with the noise gradient carried there to first
    order by its held Hessian (gn + H (p_r - p), exact in the first
    derivative), so one pass over the basis serves the value and the
    normal.  The primals stay the kernel's (t exactly, the normal as
    grad_k + (g - g.detach())), so a render with gradient has the plain
    render's values."""
    idx = torch.nonzero(hit).squeeze(1)
    if not idx.numel():
        return t, grad_k
    gp = med.gp
    ro_h, rd_h, t_h = ro[idx], rd[idx], t[idx]
    p = ro_h + t_h[:, None] * rd_h
    s, gn, hs = ws.noise_at(gp.cov, med.basis_functions,
                            _ws_key(med, pss[idx]), p)
    mean, _ = gp.mean_and_id(p)
    f = torch.sqrt(gp.cov.cov(p, p)) * s + mean
    dfdt = dot(grad_k[idx], rd_h).detach()
    ift_ok = dfdt.abs() > 1e-3
    corr = (f - f.detach()) / torch.where(ift_ok, dfdt, 1.0)
    t_r = t_h - torch.where(ift_ok, corr, 0.0)
    p_r = ro_h + t_r[:, None] * rd_h
    # the gradient of the mean that supplies the value there (a CSG
    # union's right child's where its mean is the smaller)
    _, gp_id = gp.mean_and_id(p_r)
    g = (torch.sqrt(gp.cov.cov(p_r, p_r))[:, None]
         * (gn + mat_vec(hs, p_r - p)) + gp.mean_grad_by_id(p_r, gp_id))
    t_out = t.detach().clone()
    t_out[idx] = t_r
    grad = grad_k.detach().clone()
    grad[idx] = grad_k[idx] + (g - g.detach())
    return t_out, grad


def requires_grad(*trees):
    """Whether a tensor in these tensors, tuples and trees of dataclasses
    requires grad."""
    for x in trees:
        if isinstance(x, torch.Tensor):
            if x.requires_grad:
                return True
        elif isinstance(x, tuple):
            if requires_grad(*x):
                return True
        elif dataclasses.is_dataclass(x) and requires_grad(
                *(getattr(x, f.name) for f in dataclasses.fields(x))):
            return True
    return False


def _reattach_crossing(value_at, t, hit, f_at_t):
    """The march's crossing t [R] with the parameters' gradient reattached
    by the implicit function theorem: f(t*, theta) = 0 gives dt*/dtheta =
    -(df/dtheta) / (df/dt), taken as one Newton step around the detached
    root, t - (f - f.detach()) / dfdt, whose value is t.

    dfdt is the derivative in t of the realization's value at the detached
    t, with the parameters held (amplitude, normalization, mean, 1D
    conditioning and the multi-resolution level blend included); through
    the lattice sum it is K1b's or K2b's d/dp . rd or K3b's d/dpz times
    dpz/dt.  Grazing
    crossings (|dfdt| <= 1e-3) and rays without a crossing are detached."""
    tt = t.detach().requires_grad_()
    dfdt, = torch.autograd.grad(value_at(tt)[0].sum(), tt)
    ift_ok = hit & (dfdt.abs() > 1e-3)
    corr = (f_at_t - f_at_t.detach()) / torch.where(ift_ok, dfdt, 1.0)
    return t - torch.where(ift_ok, corr, 0.0)


def _fs_march(med, scene_seed, ro, rd, near, far, state, pss, u_jitter,
              active, want_grad=True):
    """models/fs_medium.py's march with the carries the state holds: the
    value and along-ray derivative of the last normal (a CSG union's left
    child), and fs_val2, fs_grad2 (its right child)."""
    carries = [(state.last_val, dot(state.last_aniso, rd))]
    if med.gp.csg_right is not None:
        carries.append((state.fs_val2, dot(state.fs_grad2, rd)))
    return fs.sample_distance_fs(med, scene_seed, ro, rd, near, far,
                                 state.first_scatter, carries,
                                 ~state.first_scatter, pss, u_jitter, active,
                                 want_grad, state.ring)


def _sample_distance_fs(med, scene_seed, ro, rd, near, far, state, pss,
                        u_jitter, active):
    """sample_distance of a function-space medium (the JAX package's
    `_sample_distance_fs`): the sampled normal is the attaining child's;
    a plain GP carries its sanitized normal and, where it hit, the value 0,
    a CSG union each child's own value and gradient."""
    if torch.is_grad_enabled() and requires_grad(med, ro, rd):
        raise NotImplementedError(
            "the function-space medium is forward-only: its chunked march "
            "has no gradient in the JAX package either (jax.grad fails on "
            "its lax.while_loop)")
    res = _fs_march(med, scene_seed, ro, rd, near, far, state, pss,
                    u_jitter, active)
    hit, t, grad = res["hit"], res["t"], res["grad"]
    grad_ok = torch.isfinite(grad.sum(dim=-1))
    wrong_side = hit & (dot(grad, rd) > 0.0)
    zero_grad = hit & (dot(grad, grad) < 1e-7)
    failed = active & (wrong_side | zero_grad | ~grad_ok)
    fallback = torch.zeros_like(grad)
    fallback[:, 0] = 1.0
    grad = torch.where((grad_ok & ~zero_grad)[:, None], grad, fallback)
    sig_s = med.sigma_s * med.density
    sig_t = torch.clamp(med.sigma_t, min=1e-9)
    weight = torch.where(hit[:, None], (sig_s / sig_t).expand(ro.shape), 1.0)
    ip = ro + t[:, None] * rd
    weight = weight * torch.where(hit[:, None], med.gp.color(ip), 1.0)
    emission = torch.where(hit[:, None], med.gp.emission(ip), 0.0)
    is_csg = med.gp.csg_right is not None
    carry_grad = res["grads"][0] if is_csg else grad
    carry_val = (res["vals"][0] if is_csg
                 else torch.where(hit, 0.0, res["vals"][0]))
    a3 = active[:, None]
    new_state = dataclasses.replace(
        state,
        first_scatter=torch.where(active, False, state.first_scatter),
        last_gp_id=torch.where(active & hit, res["gp_id"],
                               state.last_gp_id),
        last_aniso=torch.where(a3, carry_grad, state.last_aniso),
        last_val=torch.where(active, carry_val, state.last_val),
        info_t=torch.where(active, state.info_t + t - near, state.info_t),
        scheme=torch.where(active, sc.SCHEME_UNI, state.scheme))
    if is_csg:
        new_state = dataclasses.replace(
            new_state,
            fs_val2=torch.where(active, res["vals"][1], state.fs_val2),
            fs_grad2=torch.where(a3, res["grads"][1], state.fs_grad2))
    if "ring" in res:
        r_pts, r_vals, r_dts, r_n = res["ring"]
        new_state = dataclasses.replace(
            new_state, fs_pts=torch.where(a3[..., None], r_pts, state.fs_pts),
            fs_vals=torch.where(a3, r_vals, state.fs_vals),
            fs_dts=torch.where(a3, r_dts, state.fs_dts),
            fs_n=torch.where(active, r_n, state.fs_n))
    return ({"exited": ~hit, "t": t, "weight": weight, "aniso": grad,
             "emission": emission, "gp_id": res["gp_id"],
             "scheme": torch.zeros_like(res["gp_id"]), "failed": failed},
            new_state)


def sample_distance(med, scene_seed, ro, rd, near, far, state, pss,
                    u_jitter, active):
    """Batched Medium::sampleDistance.

    Returns (result, new state).  result: exited [R] (no crossing), t [R],
    weight [R, 3], aniso [R, 3] (the sampled normal), gp_id [R], scheme [R]
    (the 1D sampling scheme at the crossing) and failed [R] (wrong-sided,
    zero or non-finite normal: the path dies).

    Differentiable in the medium's parameters (and ro, rd) by the
    detached-sampling estimator of the JAX package: the march is a discrete
    search and records no graph; the crossing is reattached by the
    implicit function theorem (`_reattach_crossing`) and the normal is
    sampled at the reattached point, so it carries d(normal)/dtheta.  The
    weight-space search (K5/K4) runs on the detached medium and rays, and
    `_ws_reattach` reattaches its crossing and normal.  The
    function-space medium (models/fs_medium.py) is forward-only, as in the
    JAX package: it raises when a parameter or ray requires grad."""
    far_eff = _far_eff(med, ro, rd, near, far)
    if med.kind == GPIS_FUNCTION_SPACE:
        return _sample_distance_fs(med, scene_seed, ro, rd, near, far_eff,
                                   state, pss, u_jitter, active)
    if med.kind == GPIS_WEIGHT_SPACE:
        hit, t, grad, end_val, gp_id = _crossing_ws(
            detach(med), scene_seed, ro.detach(), rd.detach(), near.detach(),
            far_eff.detach(), state, pss, u_jitter, active)
        if torch.is_grad_enabled() and requires_grad(med, ro, rd):
            t, grad = _ws_reattach(med, ro, rd, t, hit, grad, pss)
    else:
        state = _precondition(med, scene_seed, ro, rd, near, state, pss,
                              active)
        value_at = make_value_at(med, scene_seed, ro, rd, pss, state)
        with torch.no_grad():
            hit, t = march(med, value_at, near, far_eff, state, u_jitter,
                           active)
        f_at_t, gp_id = value_at(t)
        if f_at_t.requires_grad:
            t = _reattach_crossing(value_at, t, hit, f_at_t)
        end_val = f_at_t.detach()
        if med.normal_method in (NORMAL_BECKMANN, NORMAL_GGX):
            grad = None  # the microfacet normal below replaces it
        else:
            grad = sample_gradient(med, scene_seed, ro + t[:, None] * rd,
                                   pss, rd=rd, t_segment=t - near,
                                   coeff1=state.coeff1, coeff3=state.coeff3)

    ip = ro + t[:, None] * rd
    if med.normal_method in (NORMAL_BECKMANN, NORMAL_GGX):
        # the JAX package reads the gp id of the path's previous crossing
        grad = microfacet_normal(med, scene_seed, ip, rd, pss,
                                 state.last_gp_id)
    grad_ok = torch.isfinite(grad.sum(dim=-1))
    wrong_side = hit & (dot(grad, rd) > 0.0)
    zero_grad = hit & (dot(grad, grad) < 1e-7)
    failed = active & (wrong_side | zero_grad | ~grad_ok)

    # the GP's color scales the scatter weight; its emission is the
    # volume emission at the scatter point
    sig_s = med.sigma_s * med.density
    sig_t = torch.clamp(med.sigma_t, min=1e-9)
    weight = torch.where(hit[:, None],
                         med.gp.color(ip) * (sig_s / sig_t), 1.0)
    emission = torch.where(hit[:, None], med.gp.emission(ip), 0.0)
    scheme = torch.where(
        hit, sc.sampling_scheme(med.cfg, med.gp, ip), sc.SCHEME_UNI)
    new_state = dataclasses.replace(
        state,
        first_scatter=torch.where(active, False, state.first_scatter),
        last_gp_id=torch.where(active & hit, gp_id, state.last_gp_id),
        last_aniso=torch.where(active[:, None], grad, state.last_aniso),
        last_val=torch.where(active, torch.where(hit, 0.0, end_val),
                             state.last_val),
        info_t=torch.where(active, state.info_t + t - near, state.info_t),
        scheme=torch.where(active, scheme, state.scheme))
    return ({"exited": ~hit, "t": t, "weight": weight, "aniso": grad,
             "emission": emission, "gp_id": gp_id, "scheme": scheme,
             "failed": failed}, new_state)


@torch.no_grad()
def transmittance(med, scene_seed, ro, rd, near, far, state, pss, u_jitter,
                  active):
    """Binary visibility [R, 3] on the realization (1 where the segment
    crosses no surface, and on inactive rays): a discrete event, so it
    records no graph."""
    far_eff = _far_eff(med, ro, rd, near, far)
    if med.kind == GPIS_FUNCTION_SPACE:
        # the crossing alone: no gradient solve
        hit = _fs_march(med, scene_seed, ro, rd, near, far_eff, state, pss,
                        u_jitter, active, want_grad=False)["hit"]
    elif med.kind == GPIS_WEIGHT_SPACE:
        hit = torch.zeros_like(active)
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel():
            hit[idx] = _ws_search(
                med, ro[idx], rd[idx], near[idx], far_eff[idx],
                state.first_scatter[idx], pss[idx], u_jitter[idx],
                refine=False, evaluate=False)["hit"]
    else:
        state = _precondition(med, scene_seed, ro, rd, near, state, pss,
                              active)
        value_at = make_value_at(med, scene_seed, ro, rd, pss, state)
        hit, _ = march(med, value_at, near, far_eff, state, u_jitter, active,
                       refine=False)
    vis = torch.where(active & hit, 0.0, 1.0)
    return vis[:, None].expand(-1, 3)
