"""Weight-space GP: random Fourier feature (RFF) realizations, batched over
rays (tungsten_tpu/ops/weight_space.py).

A realization is
f(p) = sqrt(cov(p, p)) sqrt(2/n) sum_i w_i cos(freq_i dir_i . p + offset_i)
       + mean(p)
with (dir_i, freq_i) drawn from the covariance's spectral density and
w_i ~ N(0, 1).  The basis is a pure function of the ray's (pixel, sample,
bounce) words through the counter RNG, so it is re-synthesized wherever it
is needed instead of stored.  Every ray carries its own realization: dirs
[R, n, 3], freqs, offsets and weights [R, n].

Projections onto the basis directions are written out as three products
and two sums in full float32 (the JAX package asks for
precision="highest"); no TF32 enters.

`noise_at` is the realization's noise sum under autograd for the
weight-space gradient: differentiable in the points and in the length
scale l, which enters only through the frequencies (|omega| = |z
sqrt(aniso)| / l), it sums over the basis in chunks of rays and keeps only
per-ray sums for its backward, so no [R, n] tensor outlives a chunk.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import rng
from ..utils.vecmath import dot

_TWO_PI = 6.2831855  # float32(2 pi)
WEIGHT_KEY_OFFSET = 0x9E3779B9  # the weights' stream key is key + this
_PI = 3.1415927  # float32(pi)


@dataclasses.dataclass(frozen=True)
class WeightSpaceBasis:
    dirs: torch.Tensor  # [R, n, 3] unit
    freqs: torch.Tensor  # [R, n]
    offsets: torch.Tensor  # [R, n]

    @property
    def n(self):
        return self.dirs.shape[-2]


@dataclasses.dataclass(frozen=True)
class WeightSpaceRealization:
    basis: WeightSpaceBasis
    weights: torch.Tensor  # [R, n] ~ N(0, 1)


def sqrt_2_over_n(n, device):
    """sqrt(2/n) rounded as float32 arithmetic rounds it (made on the
    device, with no copy from the host)."""
    return torch.sqrt(torch.full((), 2.0 / n, dtype=torch.float32,
                                 device=device))


def project(dirs, v):
    """dirs [R, n, 3] . v [R, 3] -> [R, n]."""
    return (dirs[..., 0] * v[:, None, 0] + dirs[..., 1] * v[:, None, 1]
            + dirs[..., 2] * v[:, None, 2])


def sample_basis(cov, n, key, spectral_loc=None):
    """n spectral samples for each stream key [R] (words), drawn by the
    covariance's own `sample_spectral_3d` (a nonstationary one at the
    points spectral_loc [R, 3] if given)."""
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    k = key[:, None]
    offsets = rng.uniform(k, 1_000_000 + ctr) * (2.0 * math.pi)
    loc = None if spectral_loc is None else spectral_loc[:, None, :]
    omega = cov.sample_spectral_3d(k, ctr, loc)  # [R, n, 3]
    freqs = torch.sqrt(torch.clamp(dot(omega, omega), min=1e-20))
    dirs = omega / freqs[..., None]
    return WeightSpaceBasis(dirs=dirs, freqs=freqs, offsets=offsets)


def sample_weights(n, key):
    """n N(0, 1) weights for each stream key [R]: Box-Muller pairs at
    counters 2,000,000 + i."""
    idx = torch.arange((n + 1) // 2, dtype=torch.int64, device=key.device)
    a, b = rng.normal2(key[:, None], 2_000_000 + idx)
    return torch.stack([a, b], dim=-1).reshape(key.shape[0], -1)[:, :n]


def realization_key(pss, global_seed, is_global_ctxt):
    """Stream key [R] from the (pixel.x, pixel.y, spp, bounce) words pss
    [R, 4]; the Global context strips the bounce."""
    w = torch.zeros_like(pss[:, 3]) if is_global_ctxt else pss[:, 3]
    h = rng.xxhash32_4(pss[:, 0], pss[:, 1], pss[:, 2], w)
    return (h + global_seed) & rng.MASK32


def realization_from_key(cov, n, key):
    """The realizations of stream keys [R]: the basis from `key`, the
    weights from key + WEIGHT_KEY_OFFSET."""
    basis = sample_basis(cov, n, key)
    weights = sample_weights(n, (key + WEIGHT_KEY_OFFSET) & rng.MASK32)
    return WeightSpaceRealization(basis=basis, weights=weights)


def sample_realization(cov, n, pss, global_seed, is_global_ctxt):
    return realization_from_key(
        cov, n, realization_key(pss, global_seed, is_global_ctxt))


def _sum(terms, dim, f64):
    """terms summed over `dim` in float32, or (f64) in float64 and rounded
    once to float32."""
    if f64:
        return terms.double().sum(dim=dim).float()
    return terms.sum(dim=dim)


def evaluate(real, gp, p, f64=False):
    """f at one point per ray, p [R, 3]; returns (val [R], gp_id [R]).
    With `f64` the sum over the basis runs in float64 and is rounded once
    to float32 (K5/K4's end point beside the squared exponential)."""
    b = real.basis
    scale = torch.sqrt(gp.cov.cov(p, p))
    phase = project(b.dirs, p) * b.freqs + b.offsets
    s = _sum(real.weights * torch.cos(phase), -1, f64) \
        * sqrt_2_over_n(b.n, p.device)
    m, gp_id = gp.mean_and_id(p)
    return scale * s + m, gp_id


def evaluate_many(real, gp, pts):
    """f at S points per ray, pts [R, S, 3]; returns (val [R, S], gp_id
    [R, S])."""
    b = real.basis
    scale = torch.sqrt(gp.cov.cov(pts, pts))
    phase = (torch.matmul(pts, (b.dirs * b.freqs[..., None]).transpose(1, 2))
             + b.offsets[:, None, :])
    s = torch.matmul(torch.cos(phase), real.weights[..., None])[..., 0] \
        * sqrt_2_over_n(b.n, pts.device)
    m, gp_id = gp.mean_and_id(pts)
    return scale * s + m, gp_id


def evaluate_gradient(real, gp, p, f64=False):
    """Analytic gradient of f at p [R, 3] -> [R, 3] (`f64` as evaluate's)."""
    b = real.basis
    scale = torch.sqrt(gp.cov.cov(p, p))
    phase = project(b.dirs, p) * b.freqs + b.offsets
    coeff = -torch.sin(phase) * b.freqs * real.weights
    if f64:
        g = _sum(coeff[..., None] * b.dirs, 1, True)
    else:
        g = torch.einsum("rn,rnd->rd", coeff, b.dirs)
    g = g * sqrt_2_over_n(b.n, p.device)
    _, gp_id = gp.mean_and_id(p)
    return scale[:, None] * g + gp.mean_grad_by_id(p, gp_id)


def lipschitz(real, gp):
    """A Lipschitz bound of each ray's realization -> [R]."""
    b = real.basis
    dev = b.freqs.device
    l = (real.weights * b.freqs).abs().sum(dim=-1) * sqrt_2_over_n(b.n, dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    return torch.sqrt(gp.cov.cov(zero, zero)) * l + gp.mean.lipschitz()


def cos_interval(lo, hi):
    """Exact range (cmin, cmax) of cos over the phase interval [lo, hi],
    elementwise: the max is 1 iff the interval holds an even multiple of pi,
    the min -1 iff it holds an odd one; otherwise both sit at the ends.  The
    floors divide by float32(2 pi) (not a reciprocal), as the kernels do."""
    c_lo = torch.cos(lo)
    c_hi = torch.cos(hi)
    cmin = torch.minimum(c_lo, c_hi)
    cmax = torch.maximum(c_lo, c_hi)
    k_even = (torch.floor(hi / _TWO_PI) - torch.floor(lo / _TWO_PI)) >= 1.0
    k_odd = (torch.floor((hi - _PI) / _TWO_PI)
             - torch.floor((lo - _PI) / _TWO_PI)) >= 1.0
    wide = (hi - lo) >= _TWO_PI
    cmax = torch.where(k_even | wide, 1.0, cmax)
    cmin = torch.where(k_odd | wide, -1.0, cmin)
    return cmin, cmax


def range_bound_segment(real, gp, ro, rd, t0, t1):
    """Interval bound (lo [R], hi [R]) of f over the segments [t0, t1] of
    the rays: each basis term by the exact cos interval of its affine
    phase range, the amplitude sqrt(cov) and the mean at the midpoint, the
    mean +- its Lipschitz constant times the half-length."""
    b = real.basis
    a = b.freqs * project(b.dirs, ro) + b.offsets
    slope = b.freqs * project(b.dirs, rd)
    th0 = a + slope * t0[:, None]
    th1 = a + slope * t1[:, None]
    cmin, cmax = cos_interval(torch.minimum(th0, th1),
                              torch.maximum(th0, th1))
    amp = real.weights * sqrt_2_over_n(b.n, ro.device)
    term_lo = torch.minimum(amp * cmin, amp * cmax)
    term_hi = torch.maximum(amp * cmin, amp * cmax)
    pm = ro + (0.5 * (t0 + t1))[:, None] * rd
    scale = torch.sqrt(gp.cov.cov(pm, pm))
    n_lo = scale * term_lo.sum(dim=-1)
    n_hi = scale * term_hi.sum(dim=-1)
    m_mid, _ = gp.mean_and_id(pm)
    half = 0.5 * (t1 - t0) * gp.mean.lipschitz()
    return n_lo + m_mid - half, n_hi + m_mid + half


def sphere_trace_segment(real, gp, ro, rd, near, far, min_step=1e-3,
                         max_iters=256):
    """The adaptive range-bound root search of every ray over [near, far]:
    the step grows x1.6 while the segment's bound excludes zero and halves
    otherwise; a hit when a sign-ambiguous step is at most min_step.
    Returns (hit [R], t [R], far where nothing was hit).  One host check
    per iteration ends the loop once every ray is done."""
    f0, _ = evaluate(real, gp, ro + near[:, None] * rd)
    sign0 = torch.where(f0 < 0.0, -1.0, 1.0)
    t = near
    step = torch.clamp((far - near) * 0.05, min=min_step)
    done = torch.zeros_like(near, dtype=torch.bool)
    hit = torch.zeros_like(done)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        lo, hi = range_bound_segment(real, gp, ro, rd, t, t + step)
        no_cross = torch.where(sign0 > 0, lo > 0.0, hi < 0.0)
        converged = ~no_cross & (step <= min_step)
        t_new = torch.where(no_cross, t + step, t)
        step_new = torch.where(no_cross, step * 1.6, step * 0.5)
        step_new = torch.clamp(step_new, min=min_step * 0.5)
        exited = t_new >= far
        upd = ~done
        t = torch.where(upd, t_new, t)
        step = torch.where(upd, torch.minimum(step_new, far - t_new + 1e-6),
                           step)
        hit = hit | (upd & converged)
        done = done | converged | exited
    return hit, torch.where(hit, t, far)


# (ray, basis function) pairs per chunk of `noise_at`
NOISE_CHUNK = 1 << 24


def _noise_sums(cov, n, key, p):
    """Per-ray sums over the basis of the realizations of keys [c] at
    p [c, 3], with c = sqrt(2/n) and u = (dirs . p) freqs, phi = u +
    offsets: S = c sum w cos(phi) (the noise), gn = c sum -w sin(phi) freqs
    dirs (its gradient), hs = c sum -w cos(phi) freqs^2 dirs dirs^T (its
    Hessian, [c, 3, 3]), a = c sum w sin(phi) u and b = c sum w cos(phi)
    u freqs dirs (the sums that d/dl needs)."""
    real = realization_from_key(cov, n, key)
    bs = real.basis
    c2n = sqrt_2_over_n(n, p.device)
    u = project(bs.dirs, p) * bs.freqs
    phase = u + bs.offsets
    wc = real.weights * torch.cos(phase)
    sn = torch.sin(phase)
    coeff = -sn * bs.freqs * real.weights
    gn = torch.einsum("rn,rnd->rd", coeff, bs.dirs) * c2n
    hs = torch.einsum("rn,rni,rnj->rij", -wc * bs.freqs * bs.freqs,
                      bs.dirs, bs.dirs) * c2n
    a = (real.weights * sn * u).sum(dim=-1) * c2n
    b = torch.einsum("rn,rnd->rd", wc * u * bs.freqs, bs.dirs) * c2n
    return wc.sum(dim=-1) * c2n, gn, hs, a, b


class _Noise(torch.autograd.Function):
    """S, gn and hs of `_noise_sums` over all rays, differentiable in p and
    l (hs is held: it only carries a point's motion to first order)."""

    @staticmethod
    def forward(ctx, p, l, cov, n, key):
        rays = max(1, NOISE_CHUNK // n)
        parts = [_noise_sums(cov, n, key[i:i + rays], p[i:i + rays])
                 for i in range(0, p.shape[0], rays)]
        s, gn, hs, a, b = (torch.cat(x) for x in zip(*parts))
        ctx.save_for_backward(gn, hs, a, b, l)
        ctx.mark_non_differentiable(hs)
        return s, gn, hs

    @staticmethod
    def backward(ctx, g_s, g_gn, _):
        gn, hs, a, b, l = ctx.saved_tensors
        # dS/dp = gn, dgn/dp = hs; phi depends on l through u = (dirs . p)
        # f1 / l: dS/dl = a / l, dgn/dl = (b - gn) / l
        dp = g_s[:, None] * gn + torch.einsum("rij,rj->ri", hs, g_gn)
        dl = ((g_s * a).sum() + dot(g_gn, b - gn).sum()) / l
        return dp, dl, None, None, None


def noise_at(cov, n, key, p):
    """The noise part of the realizations of stream keys [R] at p [R, 3]:
    (S [R], its gradient gn [R, 3], its Hessian [R, 3, 3], held), with S
    and gn differentiable in p and in cov.l.  The basis comes from the
    covariance with its parameters detached; f = sqrt(cov(p, p)) S +
    mean(p), and the gradient sqrt(cov(p, p)) gn + grad mean(p)."""
    if cov.aniso.requires_grad:
        raise NotImplementedError("the weight-space gradient in the "
                                  "anisotropy")
    held = dataclasses.replace(cov, sigma=cov.sigma.detach(),
                               l=cov.l.detach())
    return _Noise.apply(p, cov.l, held, n, key)
