"""K5 and K4: the weight-space fixed-step march and range-bound sphere
trace (tungsten_tpu/ops/ws_trace_pallas.py), each one kernel launch per
search.

`fixed_march_batch` (step_size > 0, K5) and `sphere_trace_batch`
(step_size == 0, K4) take each ray's realization key, its origin,
direction and interval, and the medium (its GP and basis size n), and
return the first crossing of the ray with its own RFF realization, with
the realization's value and gradient at the end point.  On CUDA tensors
each call is one launch of a kernel of csrc/ws_trace.cu, the counterparts
of the Pallas `_march_kernel` (K5) and `_trace_kernel` (K4): the kernel
synthesises the ray's basis from its keys, keeps it in shared memory for
the whole search, runs the step loop (and K5's Illinois refinement) and
evaluates the end point, so no [R, n] tensor is made and the host never
waits inside a call.  A CPU tensor takes the plain twin
(`fixed_march_batch_ref`, `sphere_trace_batch_ref`): the realization
synthesised as [R, n] tensors (`realization`), the Pallas kernels' step
body re-dispatched a chunk at a time until no ray is left
(`march_chunk_ref`, `trace_chunk_ref`; one `any()` per chunk), the
refinement and `ws.evaluate` / `ws.evaluate_gradient` at the end point.
`march_over` / `trace_over` run that twin on a given realization.

Each stationary covariance that the JAX package sends to its kernels
(`supports`) draws its basis in its own way; the kernels take its tag
(`COV_TAGS`) and run that tag's template instance of csrc/ws_trace.cu,
and the twins draw with the covariance's own `sample_spectral_3d`.

`MARCH_LAUNCHES` and `TRACE_LAUNCHES` count kernel launches, in all and
per tag (`LAUNCHES_BY_TAG`).  The library is built with nvcc at first use
(kernels/nvcc.py).

State and aux columns of the chunk twins are those of the Pallas kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from ..ops import covariance as cv
from ..ops import weight_space as ws
from ..ops.means import HomogeneousMean, SphericalMean
from ..utils import rng
from ..utils.vecmath import dot
from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ws_trace.cu"

MARCH_CHUNK = 32  # K5 steps per dispatch of the twin, as the Pallas kernel
TRACE_CHUNK = 16  # K4 iterations per dispatch of the twin, as Pallas
TRACE_MIN_STEP = 1e-3  # K4 converges once its step is this short
TRACE_MAX_ITERS = 256  # K4 iterations of one ray at most

# K5 state [k, done, crossed, t_hi, f_lo, f_hi, sign0, f_prev]
M_K, M_DONE, M_CROSS, M_THI, M_FLO, M_FHI, M_SIGN, M_FPREV = range(8)
# K5 aux [A, B, far, t1, step, absorb, -, -]
MA_A, MA_B, MA_FAR, MA_T1, MA_STEP, MA_ABS = range(6)
# K4 state [t, step, done, hit, sign0, it, -, -]; aux [A, B, far, -...]
C_T, C_STEP, C_DONE, C_HIT, C_SIGN, C_IT = range(6)
# the kernels' output columns [R, 8]: steps counts the march steps (K5) or
# iterations (K4) the ray took
O_HIT, O_T, O_SIGN, O_VAL, O_GX, O_GY, O_GZ, O_STEPS = range(8)

# the kernels' covariance tags (csrc/ws_trace.cu's enum), by class, and
# the name of the constant each draw reads (params[13])
COV_TAGS = {cv.SquaredExponentialCov: 0, cv.RationalQuadraticCov: 1,
            cv.MaternCov: 2, cv.GaborAnisoCov: 3, cv.GaborIsoCov: 3,
            cv.PeriodicCov: 4, cv.ThinPlateCov: 5}
TAG_NAMES = ("se", "rq", "matern", "gabor", "periodic", "thin_plate")
_COV_CONST = {cv.RationalQuadraticCov: "a", cv.MaternCov: "nu",
              cv.PeriodicCov: "period", cv.ThinPlateCov: "R"}

MARCH_LAUNCHES = 0
TRACE_LAUNCHES = 0
# (kernel name, tag name) -> launches
LAUNCHES_BY_TAG = {}
_FNS = {}


def build():
    """Compile (if needed) and load both kernels; returns nvcc's output
    (register and spill report), or "" when the library was built."""
    lib, log = compile_library(SOURCE)
    if not _FNS:
        dll = ctypes.CDLL(str(lib))
        i, p = ctypes.c_int, ctypes.c_void_p
        for name, n_ptr, n_int in (("ws_march", 11, 8), ("ws_trace", 8, 7)):
            fn = getattr(dll, name)
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return log


def supports(gp):
    """The kernels' scope, as the JAX package's: a stationary covariance
    (each has a tag), a spherical or homogeneous mean and no additional
    CSG mean."""
    return (type(gp.cov) in COV_TAGS and gp.mean_additional is None
            and isinstance(gp.mean, (SphericalMean, HomogeneousMean)))


def cov_tag(cov):
    """The kernels' tag of the covariance."""
    return COV_TAGS[type(cov)]


def realization(gp, n, key):
    """The RFF realizations of stream keys [R] (words) as [R, n] tensors,
    in the profiler range "ws_realization"."""
    with torch.profiler.record_function("ws_realization"):
        return ws.realization_from_key(gp.cov, n, key)


def search_params(gp, n, device):
    """The medium's constants as the kernels take them, [14] float32: l,
    sqrt(aniso) [3], sqrt(cov(0, 0)), sqrt(2/n), the spherical mean's
    center [3] and radius, the homogeneous mean's offset, the mean's
    Lipschitz constant, TRACE_MIN_STEP and the covariance's constant
    (RQ's a, Matern's nu, Periodic's period, ThinPlate's R; l and aniso
    are 1 where the covariance has none)."""
    f32 = dict(dtype=torch.float32, device=device)
    cov, mean = gp.cov, gp.mean
    origin = torch.zeros(3, **f32)
    zero = torch.zeros(1, **f32)
    one = torch.ones(1, **f32)
    if isinstance(mean, SphericalMean):
        center, radius, m_off = mean.center, mean.radius, zero
    else:
        center, radius, m_off = torch.zeros(3, **f32), zero, mean.offset
    const = _COV_CONST.get(type(cov))
    vals = (getattr(cov, "l", one),
            torch.sqrt(getattr(cov, "aniso", torch.ones(3, **f32))),
            torch.sqrt(cov.cov(origin, origin)),
            ws.sqrt_2_over_n(n, device), center, radius, m_off,
            torch.full((1,), float(mean.lipschitz()), **f32),
            torch.full((1,), TRACE_MIN_STEP, **f32),
            one if const is None else getattr(cov, const))
    # made on the device: a copy from the host would wait for it
    return torch.cat([v.to(**f32).reshape(-1) for v in vals])


def _check(key, ro, rd, per_ray):
    R = key.shape[0]
    if key.dtype != torch.int64 or key.dim() != 1:
        raise ValueError(f"key must be int64 [R], got {key.dtype} "
                         f"{tuple(key.shape)}")
    for name, x, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           *((k, v, (R,)) for k, v in per_ray.items())):
        want = torch.bool if name == "absorb" else torch.float32
        if x.dtype != want or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {want} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != key.device:
            raise ValueError("all inputs must be on one device")
    if key.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu tensors, not "
                         f"{key.device}")
    if R >= 2 ** 30:  # the ray counter runs past R by the warps in flight
        raise ValueError("the kernels take fewer than 2^30 rays")


def pack_keys(key):
    """The realization and weight keys of stream keys [R] (words in int64)
    as the kernels take them: uint32 words in int32 [R, 2] (a cast that
    wraps)."""
    return torch.stack([key, (key + ws.WEIGHT_KEY_OFFSET) & rng.MASK32],
                       dim=-1).to(torch.int32)


def _launch(name, gp, n, key, ro, rd, per_ray, ints):
    """Launches kernel `name`'s instance for the GP's covariance on rays
    [R]; returns its output [R, 8]."""
    _check(key, ro, rd, per_ray)
    if not supports(gp):
        raise ValueError("the GP is outside the kernels' scope (see "
                         "`supports`)")
    if not _FNS:
        build()
    dev = key.device
    keys = pack_keys(key)
    args = [x.contiguous() for x in (ro, rd, *per_ray.values())]
    params = search_params(gp, n, dev)
    out = torch.empty((key.shape[0], 8), dtype=torch.float32, device=dev)
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)  # the counter
    err = _FNS[name](keys.data_ptr(), *(x.data_ptr() for x in args),
                     params.data_ptr(), out.data_ptr(), next_ray.data_ptr(),
                     key.shape[0], n, *ints, cov_tag(gp.cov), dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    tag = (name, TAG_NAMES[cov_tag(gp.cov)])
    LAUNCHES_BY_TAG[tag] = LAUNCHES_BY_TAG.get(tag, 0) + 1
    return out


def _result(out, evaluate):
    res = {"hit": out[:, O_HIT] > 0.5, "t": out[:, O_T],
           "sign0": out[:, O_SIGN], "steps": out[:, O_STEPS]}
    if evaluate:
        res["val"], res["grad"] = out[:, O_VAL], out[:, O_GX:O_GZ + 1]
    return res


def march_cap(max_steps):
    """The most steps a ray takes: max_steps rounded up to whole chunks."""
    return -(-max_steps // MARCH_CHUNK) * MARCH_CHUNK


def fixed_march_batch(gp, n, key, ro, rd, near, far, step, u_jitter, absorb,
                      max_steps, refine=True, evaluate=True):
    """K5: the fixed-step sign-change march of every ray [R] over its
    realization (stream key `key` [R], words in int64; n basis functions),
    then 6 Illinois false-position steps inside [t_hi - step, t_hi] unless
    `refine` is False.

    f0 at `near` fixes sign0, the first step sits at near + step *
    u_jitter, the first step after an interior scatter (`absorb`) sets the
    sign and cannot flip, flips count only before `far`, and no ray takes
    more than `max_steps` steps (rounded up to whole chunks).  Returns
    dict(hit [R], t [R] (far where nothing was hit), sign0 [R], steps [R]
    and, if `evaluate`, val [R] and grad [R, 3] of the realization at
    ro + t rd)."""
    global MARCH_LAUNCHES
    if key.device.type == "cpu":
        return fixed_march_batch_ref(gp, n, key, ro, rd, near, far, step,
                                     u_jitter, absorb, max_steps, refine,
                                     evaluate)
    out = _launch("ws_march", gp, n, key, ro, rd,
                  {"near": near, "far": far, "step": step,
                   "u_jitter": u_jitter, "absorb": absorb},
                  (march_cap(max_steps), isinstance(gp.mean, SphericalMean),
                   bool(refine), bool(evaluate)))
    MARCH_LAUNCHES += 1
    return _result(out, evaluate)


def sphere_trace_batch(gp, n, key, ro, rd, near, far, evaluate=True):
    """K4: the adaptive range-bound sphere trace of every ray [R] over
    [near, far] on its realization (stream key `key` [R]; n basis
    functions), at most TRACE_MAX_ITERS iterations.  Returns the dict of
    `fixed_march_batch` (steps: iterations)."""
    global TRACE_LAUNCHES
    if key.device.type == "cpu":
        return sphere_trace_batch_ref(gp, n, key, ro, rd, near, far,
                                      evaluate)
    out = _launch("ws_trace", gp, n, key, ro, rd, {"near": near, "far": far},
                  (TRACE_MAX_ITERS, isinstance(gp.mean, SphericalMean),
                   bool(evaluate)))
    TRACE_LAUNCHES += 1
    return _result(out, evaluate)


def fixed_march_batch_ref(gp, n, key, ro, rd, near, far, step, u_jitter,
                          absorb, max_steps, refine=True, evaluate=True):
    """Plain PyTorch twin of K5 (`fixed_march_batch`)."""
    return march_over(realization(gp, n, key), gp, ro, rd, near, far, step,
                      u_jitter, absorb, max_steps, refine, evaluate)


def sphere_trace_batch_ref(gp, n, key, ro, rd, near, far, evaluate=True):
    """Plain PyTorch twin of K4 (`sphere_trace_batch`)."""
    return trace_over(realization(gp, n, key), gp, ro, rd, near, far,
                      evaluate)


def _mean_at(spherical, A, B, t, radius, m_off):
    if not spherical:
        return m_off.expand(t.shape)
    return torch.sqrt(torch.clamp(A + t * (2.0 * B + t), min=0.0)) - radius


def _nsum(amp, phase, f64):
    """sum_i amp_i cos(phase_i) over the basis [R, n] -> [R]: in float32,
    or (f64, K5 beside the squared exponential) in float64 rounded once to
    float32, as the kernel sums it."""
    terms = amp * torch.cos(phase)
    if f64:
        return terms.double().sum(dim=1).float()
    return terms.sum(dim=1)


def march_chunk_ref(a, slope, amp, aux, state, params, spherical,
                    f64=False):
    """The Pallas K5's step body, MARCH_CHUNK times over the whole batch:
    a, slope, amp [R, n]; aux, state [R, 8]; params [8] (scale, radius,
    mean offset, -...); returns the new state [R, 8].  `f64`: the sums over
    the basis as `_nsum` takes them."""
    params = params.reshape(-1)
    scale, radius, m_off = params[0], params[1], params[2]
    A, B, far, t1, step = aux[:, :5].unbind(-1)
    absorb = aux[:, MA_ABS] > 0.5
    S = state
    for _ in range(MARCH_CHUNK):
        k, done, crossed, t_hi, f_lo, f_hi, sign0, f_prev = S.unbind(-1)
        done = done > 0.5
        tc = t1 + step * k
        nsum = _nsum(amp, a + slope * tc[:, None], f64)
        f = scale * nsum + _mean_at(spherical, A, B, tc, radius, m_off)
        sgn = torch.where(f < 0.0, -1.0, 1.0)
        first_abs = absorb & (k < 0.5)
        sign0 = torch.where(first_abs, sgn, sign0)
        flip = (sgn != sign0) & (tc < far) & ~first_abs
        newly = ~done & flip
        exited = tc >= far
        adv = ~done & ~flip & ~exited
        S = torch.stack([
            k + torch.where(adv, 1.0, 0.0),
            torch.where(done | flip | exited, 1.0, 0.0),
            torch.where(newly, 1.0, crossed),
            torch.where(newly, tc, t_hi),
            torch.where(newly, f_prev, f_lo),
            torch.where(newly, f, f_hi),
            sign0,
            torch.where(adv, f, f_prev)], dim=-1)
    return S


def trace_chunk_ref(a, slope, amp, aux, state, params, spherical):
    """The Pallas K4's iteration body, TRACE_CHUNK times over the whole
    batch; params [8] (scale, min_step, mean Lipschitz, radius, mean
    offset, -...)."""
    params = params.reshape(-1)
    scale, min_step, lip_m, radius, m_off = params[:5].unbind()
    A, B, far = aux[:, :3].unbind(-1)
    S = state
    for _ in range(TRACE_CHUNK):
        t, step, done, hit, sign0, iters, s6, s7 = S.unbind(-1)
        upd = done < 0.5
        th0 = a + slope * t[:, None]
        th1 = a + slope * (t + step)[:, None]
        cmin, cmax = ws.cos_interval(torch.minimum(th0, th1),
                                     torch.maximum(th0, th1))
        term_lo = torch.minimum(amp * cmin, amp * cmax)
        term_hi = torch.maximum(amp * cmin, amp * cmax)
        n_lo = scale * term_lo.sum(dim=1)
        n_hi = scale * term_hi.sum(dim=1)
        m_mid = _mean_at(spherical, A, B, t + 0.5 * step, radius, m_off)
        half = 0.5 * step * lip_m
        lo_b = n_lo + m_mid - half
        hi_b = n_hi + m_mid + half
        no_cross = torch.where(sign0 > 0, lo_b > 0.0, hi_b < 0.0)
        converged = ~no_cross & (step <= min_step)
        t_new = torch.where(no_cross, t + step, t)
        step_new = torch.where(no_cross, step * 1.6, step * 0.5)
        step_new = torch.maximum(step_new, min_step * 0.5)
        exited = t_new >= far
        step_new = torch.minimum(step_new, far - t_new + 1e-6)
        S = torch.stack([
            torch.where(upd, t_new, t),
            torch.where(upd, step_new, step),
            torch.where(upd & (converged | exited), 1.0, done),
            torch.where(upd & converged, 1.0, hit),
            sign0,
            iters + torch.where(upd, 1.0, 0.0),
            s6, s7], dim=-1)
    return S


@dataclasses.dataclass(frozen=True)
class HoistedParams:
    """Each ray's basis as affine phases a + slope * t [R, n], amp =
    weights * sqrt(2/n) [R, n], and the mean's constants: the spherical
    mean is sqrt(A + t (2B + t)) - radius, the homogeneous one m_off."""
    a: torch.Tensor
    slope: torch.Tensor
    amp: torch.Tensor
    scale: torch.Tensor  # sqrt(cov(0, 0))
    spherical: bool
    A: torch.Tensor  # [R] |ro - center|^2
    B: torch.Tensor  # [R] (ro - center) . rd
    radius: torch.Tensor
    m_off: torch.Tensor
    f64: bool = False  # K5's sums in float64 (beside the SE)

    def value_of(self, t):
        """f at t [R] along each ray."""
        nsum = _nsum(self.amp, self.a + self.slope * t[:, None], self.f64)
        return self.scale * nsum + _mean_at(self.spherical, self.A, self.B, t,
                                            self.radius, self.m_off)


def _hoisted_params(real, gp, ro, rd):
    """HoistedParams of the realizations `real` along rays ro, rd [R, 3]."""
    b = real.basis
    dev = ro.device
    spherical = isinstance(gp.mean, SphericalMean)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if spherical:
        oc = ro - gp.mean.center
        # the sums written out, in the kernels' order
        A, B = dot(oc, oc), dot(oc, rd)
        radius, m_off = gp.mean.radius.to(torch.float32), zero
    else:
        A = B = torch.zeros(ro.shape[0], dtype=torch.float32, device=dev)
        radius, m_off = zero, gp.mean.offset.to(torch.float32)
    origin = torch.zeros(3, dtype=torch.float32, device=dev)
    return HoistedParams(
        a=(b.freqs * ws.project(b.dirs, ro) + b.offsets).contiguous(),
        slope=(b.freqs * ws.project(b.dirs, rd)).contiguous(),
        amp=(real.weights * ws.sqrt_2_over_n(b.n, dev)).contiguous(),
        scale=torch.sqrt(gp.cov.cov(origin, origin)), spherical=spherical,
        A=A, B=B, radius=radius, m_off=m_off,
        f64=not isinstance(gp.cov, cv.SquaredExponentialCov))


def _params(*vals):
    """[8] float32 on the device of the first tensor, zero-padded."""
    dev = next(v.device for v in vals if isinstance(v, torch.Tensor))
    v = [torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
         for x in vals]
    v += [torch.zeros((), dtype=torch.float32, device=dev)] * (8 - len(v))
    return torch.stack(v)


def march_inputs(real, gp, ro, rd, near, far, step, u_jitter, absorb):
    """The chunk twin's inputs for rays [R] at their start: (hoisted basis,
    aux [R, 8], state [R, 8], params [8]).  f0 at `near` fixes sign0."""
    R = ro.shape[0]
    h = _hoisted_params(real, gp, ro, rd)
    f0 = h.value_of(near)
    sign0 = torch.where(f0 < 0.0, -1.0, 1.0)
    t1 = near + step * u_jitter
    zeros = torch.zeros(R, dtype=torch.float32, device=ro.device)
    aux = torch.stack([h.A, h.B, far, t1, step, absorb.to(torch.float32),
                       zeros, zeros], dim=-1).contiguous()
    state = torch.stack([zeros, zeros, zeros, far, f0, zeros, sign0, f0],
                        dim=-1).contiguous()
    return h, aux, state, _params(h.scale, h.radius, h.m_off)


def trace_inputs(real, gp, ro, rd, near, far):
    """The chunk twin's inputs for rays [R] at their start: (hoisted basis,
    aux [R, 8], state [R, 8], params [8]).  The first step is 5% of
    [near, far]."""
    R = ro.shape[0]
    h = _hoisted_params(real, gp, ro, rd)
    f0, _ = ws.evaluate(real, gp, ro + near[:, None] * rd)
    sign0 = torch.where(f0 < 0.0, -1.0, 1.0)
    zeros = torch.zeros(R, dtype=torch.float32, device=ro.device)
    aux = torch.stack([h.A, h.B, far] + [zeros] * 5, dim=-1).contiguous()
    step0 = torch.clamp((far - near) * 0.05, min=TRACE_MIN_STEP)
    state = torch.stack([near, step0, zeros, zeros, sign0, zeros, zeros,
                         zeros], dim=-1).contiguous()
    params = _params(h.scale, TRACE_MIN_STEP, gp.mean.lipschitz(), h.radius,
                     h.m_off)
    return h, aux, state, params


def _end_point(res, real, gp, ro, rd, evaluate):
    """Adds the value and gradient of `real` at ro + t rd to res, summed
    over the basis as the kernels sum them (in float64 beside the squared
    exponential)."""
    if evaluate:
        ip = ro + res["t"][:, None] * rd
        f64 = not isinstance(gp.cov, cv.SquaredExponentialCov)
        res["val"], _ = ws.evaluate(real, gp, ip, f64)
        res["grad"] = ws.evaluate_gradient(real, gp, ip, f64)
    return res


def march_over(real, gp, ro, rd, near, far, step, u_jitter, absorb,
               max_steps, refine=True, evaluate=True):
    """`fixed_march_batch` on the realizations `real`: the chunk twin
    re-dispatched until no ray is left (one host sync per chunk), then the
    refinement and the end point in tensor code."""
    h, aux, S, params = march_inputs(real, gp, ro, rd, near, far, step,
                                     u_jitter, absorb)
    for _ in range(march_cap(max_steps) // MARCH_CHUNK):
        if not bool((S[:, M_DONE] < 0.5).any()):
            break
        S = march_chunk_ref(h.a, h.slope, h.amp, aux, S, params, h.spherical,
                            h.f64)
    crossed = S[:, M_CROSS] > 0.5
    t_hi = S[:, M_THI]
    sign0 = S[:, M_SIGN]
    res = {"hit": crossed, "sign0": sign0, "steps": S[:, M_K] + S[:, M_DONE]}
    if not refine:
        res["t"] = torch.where(crossed, t_hi, far)
        return _end_point(res, real, gp, ro, rd, evaluate)

    lo = torch.maximum(t_hi - step, near)
    hi, flo, fhi = t_hi, S[:, M_FLO], S[:, M_FHI]
    for _ in range(6):
        denom = flo - fhi
        tiny = denom.abs() < 1e-30
        mid_s = lo + flo * (hi - lo) / torch.where(tiny, 1.0, denom)
        mid = torch.where(tiny | (mid_s <= lo) | (mid_s >= hi),
                          0.5 * (lo + hi), mid_s)
        fm = h.value_of(torch.where(crossed, mid, near))
        start_side = torch.where(fm < 0, -1.0, 1.0) == sign0
        lo = torch.where(crossed & start_side, mid, lo)
        hi = torch.where(crossed & ~start_side, mid, hi)
        flo, fhi = (torch.where(start_side, fm, flo * 0.5),
                    torch.where(start_side, fhi * 0.5, fm))
    res["t"] = torch.where(crossed, hi, far)
    return _end_point(res, real, gp, ro, rd, evaluate)


def trace_over(real, gp, ro, rd, near, far, evaluate=True):
    """`sphere_trace_batch` on the realizations `real`, the chunk twin
    re-dispatched until no ray is left."""
    h, aux, S, params = trace_inputs(real, gp, ro, rd, near, far)
    for _ in range(-(-TRACE_MAX_ITERS // TRACE_CHUNK)):
        if not bool((S[:, C_DONE] < 0.5).any()):
            break
        S = trace_chunk_ref(h.a, h.slope, h.amp, aux, S, params, h.spherical)
    hit = S[:, C_HIT] > 0.5
    res = {"hit": hit, "t": torch.where(hit, S[:, C_T], far),
           "sign0": S[:, C_SIGN], "steps": S[:, C_IT]}
    return _end_point(res, real, gp, ro, rd, evaluate)
