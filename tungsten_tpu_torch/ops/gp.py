"""Function-space GP: exact conditioning by dense covariance solves, batched
over rays (tungsten_tpu/ops/gp.py without the global conditioning, which
the parser refuses).

An observation row is (point [3], derivative kind in {D_NONE, D_FIRST},
direction [3]): a value of the field or its directional derivative.  The
covariance between two rows is the kernel's value, its first directional
derivatives or its mixed second derivative.  For the squared exponential
they are written in closed form where the JAX package nests jax.jvp: with
d = a - b, A = diag(aniso) and k = cov(a, b) = sigma^2 exp(-d.A.d / 2 l^2),

    d/da k . u = -k (A d . u) / l^2,    d/db k . u = k (A d . u) / l^2,
    d2/da db k (u, v) = k ((A u . v) / l^2 - (A d . u)(A d . v) / l^4).

Any other covariance takes them as the JAX package does, by forward mode
over its `cov` (`torch.func.jvp`, nested for the mixed derivative).

Every function takes a leading batch axis [R, ...] (one problem per ray);
the eigendecompositions behind `sqrt_psd` and `pseudo_inverse` are K8 on
CUDA tensors and torch.linalg.eigh on CPU tensors (kernels/psd.py).  The
sampling root is the symmetric V sqrt(W) V^T, where the JAX package takes
V sqrt(W): any B with B B^T = C samples the same distribution, and the
symmetric root is unique, so the kernel and its twin draw the same
realization from the same z.
"""
from __future__ import annotations

import math

import torch

from ..kernels.psd import pseudo_inverse, sqrt_psd  # noqa: F401 (ops API)
from ..utils import rng
from ..utils.vecmath import dot
from .covariance import SquaredExponentialCov

D_NONE = 0
D_FIRST = 1

def _first(dts):
    return dts == D_FIRST


def _jvp_entries(cov, pa, dira, pb, dirb):
    """(k, d/da k . u, d/db k . v, d2/da db k (u, v)) of any covariance by
    forward mode, the directions broadcast to their points' shapes."""
    # (forward mode writes its tangents into the primals' layout: no
    # broadcast views)
    pa, pb = pa.contiguous(), pb.contiguous()
    dira = dira.expand(pa.shape).contiguous()
    dirb = dirb.expand(pb.shape).contiguous()
    jvp = torch.func.jvp

    def da_fn(b):
        return jvp(lambda a: cov.cov(a, b), (pa,), (dira,))[1]

    v00, v10 = jvp(lambda a: cov.cov(a, pb), (pa,), (dira,))
    _, v01 = jvp(lambda b: cov.cov(pa, b), (pb,), (dirb,))
    _, v11 = jvp(da_fn, (pb,), (dirb,))
    return v00, v10, v01, v11


def cov_entry(cov, pa, da, dira, pb, db, dirb):
    """Covariance between rows a and b: the points, kinds and directions
    broadcast ([..., 3] and [...])."""
    if not isinstance(cov, SquaredExponentialCov):
        k, v10, v01, v11 = _jvp_entries(cov, pa, dira, pb, dirb)
        fa, fb = _first(da), _first(db)
        return torch.where(fa & fb, v11, torch.where(
            fa, v10, torch.where(fb, v01, k)))
    d = pa - pb
    ad = d * cov.aniso
    inv_l2 = 1.0 / (cov.l * cov.l)
    k = cov.cov(pa, pb)
    ada, adb = dot(ad, dira), dot(ad, dirb)
    v10 = -k * ada * inv_l2
    v01 = k * adb * inv_l2
    v11 = k * (dot(dira * cov.aniso, dirb) * inv_l2
               - ada * adb * (inv_l2 * inv_l2))
    fa, fb = _first(da), _first(db)
    return torch.where(fa & fb, v11, torch.where(
        fa, v10, torch.where(fb, v01, k)))


def cov_matrix(cov, pts_a, dts_a, dirs_a, pts_b, dts_b, dirs_b):
    """Dense cross-covariance [R, Na, Nb] of rows a (pts [R, Na, 3], kinds
    [R, Na] or [Na], dirs [R, Na, 3]) and rows b."""
    return cov_entry(cov, pts_a[:, :, None], dts_a[..., :, None],
                     dirs_a[:, :, None], pts_b[:, None], dts_b[..., None, :],
                     dirs_b[:, None])


def mean_vector(gp, pts, dts, dirs):
    """The mean's value or directional derivative per row: (mean [R, N],
    ids [R, N])."""
    m, ids = gp.mean_and_id(pts)
    dm = dot(gp.mean_grad_by_id(pts, ids), dirs)
    return torch.where(_first(dts), dm, m), ids


def psd_solve(a, b):
    """a^+ b for symmetric PSD a [R, n, n] and b [R, n, k]."""
    return torch.matmul(pseudo_inverse(a), b)


def _sym(s):
    return 0.5 * (s + s.transpose(-1, -2))


def conditional_mvn(gp, pts, dts, dirs, cond_pts, cond_dts, cond_dirs,
                    cond_vals):
    """The GP at query rows conditioned on rows with values cond_vals
    [R, Nc] by the Schur complement: (mean [R, N], root of the covariance
    [R, N, N], ids [R, N])."""
    cov = gp.cov
    s11 = cov_matrix(cov, cond_pts, cond_dts, cond_dirs, cond_pts, cond_dts,
                     cond_dirs)
    s12 = cov_matrix(cov, cond_pts, cond_dts, cond_dirs, pts, dts, dirs)
    m2, ids = mean_vector(gp, pts, dts, dirs)
    m1, _ = mean_vector(gp, cond_pts, cond_dts, cond_dirs)
    s22 = cov_matrix(cov, pts, dts, dirs, pts, dts, dirs)
    solved = psd_solve(s11, s12).transpose(-1, -2)  # [R, N, Nc]
    mean = m2 + torch.matmul(solved, (cond_vals - m1)[..., None])[..., 0]
    s2 = s22 - torch.matmul(solved, s12)
    return mean, sqrt_psd(_sym(s2).contiguous()), ids


def prior_mvn(gp, pts, dts, dirs):
    """The unconditioned GP at query rows: (mean, root, ids)."""
    m, ids = mean_vector(gp, pts, dts, dirs)
    s = cov_matrix(gp.cov, pts, dts, dirs, pts, dts, dirs)
    return m, sqrt_psd(_sym(s).contiguous()), ids


def z_counters(ctr, n, device):
    """The Box-Muller pair counters ctr * ceil(n / 2) + i, i < ceil(n / 2),
    of a realization of n entries."""
    half = (n + 1) // 2
    idx = torch.arange(half, dtype=torch.int64, device=device)
    return (ctr * half + idx) & rng.MASK32


def normals(key, ctr, n):
    """The z stream of one realization of n entries per ray: the Box-Muller
    pairs at z_counters of stream key [R]; [R, n]."""
    a, b = rng.normal2(key[:, None], z_counters(ctr, n, key.device))
    return torch.stack([a, b], dim=-1).reshape(key.shape[0], -1)[:, :n]


def sample_mvn(mean, cov_sqrt, key, ctr):
    """One realization mean + cov_sqrt z per ray (mean [R, n], cov_sqrt
    [R, n, n], key [R] words, ctr a Python int)."""
    z = normals(key, ctr, mean.shape[-1])
    return mean + torch.matmul(cov_sqrt, z[..., None])[..., 0]


_SQRT2 = math.sqrt(2.0)


def sample_truncated_normal(mean, sigma, a, key, ctr):
    """x >= a from N(mean, sigma^2) by the inverse CDF, with the uniform at
    counter ctr of stream key [R]."""
    u = rng.uniform(key, ctr)
    alpha = (a - mean) / torch.clamp(sigma, min=1e-12)
    phi_a = 0.5 * (1.0 + torch.erf(alpha / _SQRT2))
    uu = torch.clamp(phi_a + u * (1.0 - phi_a), 1e-7, 1.0 - 1e-7)
    return mean + sigma * _SQRT2 * torch.special.erfinv(2.0 * uu - 1.0)
