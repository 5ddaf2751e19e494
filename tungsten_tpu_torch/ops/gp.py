"""Function-space GP: exact conditioning by dense covariance solves, batched
over rays (tungsten_tpu/ops/gp.py), with the global conditioning on a mesh
point set (`GlobalCond`), the constrained sampler of the None context and
the cdf of the free-flight skip.

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

A GP conditioned on a mesh (`GlobalCond`, the scene's `conditioning_data`)
holds the 2V x 2V pseudo-inverse of its V vertices' value and normal rows,
solved once at scene load in float64 (`build_global_cond`; V <= 1024, so
not K8's size).  Every covariance block and mean vector of such a GP is
then the conditioned one (`mean_cov_gc`): the products with the cross
covariances to the mesh rows [R, 2V, N] are plain matrix products, formed
for groups of rays so that their memory stays bounded, and summed in
float64: near the mesh the conditioned covariance is the small difference
of two large terms, and float32 sums over the 2V rows leave noise at the
pseudo-inverse's cut, which the later solves amplify.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class GlobalCond:
    """A GP's conditioning on a mesh point set: one value row (0) and one
    normal-derivative row (1) per unique vertex, and what the conditioning
    solve leaves: alpha = K11^+ (values - mean) and K11^+ itself."""
    pts: torch.Tensor  # [M, 3]
    dts: torch.Tensor  # [M] int64
    dirs: torch.Tensor  # [M, 3]
    values: torch.Tensor  # [M]
    alpha: torch.Tensor  # [M]
    k11_pinv: torch.Tensor  # [M, M]


def build_global_cond(gp, verts, normals, eps_scale=1e-6):
    """GlobalCond of the GP on vertices verts [V, 3] with unit normals
    [V, 3]: K11 of the 2V rows in float32, its pseudo-inverse (eigenvalues
    with |w| <= eps_scale max|w| dropped) by torch.linalg.eigh in float64
    on their device, alpha in float64; both stored in float32."""
    V, dev = verts.shape[0], verts.device
    pts = torch.cat([verts, verts])
    dts = torch.cat([torch.full((V,), D_NONE, dtype=torch.int64, device=dev),
                     torch.full((V,), D_FIRST, dtype=torch.int64,
                                device=dev)])
    dirs = torch.cat([normals, normals])
    values = torch.cat([torch.zeros(V, dtype=torch.float32, device=dev),
                        torch.ones(V, dtype=torch.float32, device=dev)])
    k11 = cov_matrix(gp.cov, pts[None], dts, dirs[None], pts[None], dts,
                     dirs[None])[0]
    w, v = torch.linalg.eigh(_sym(k11).double())
    eps = eps_scale * w.abs().amax()
    w_inv = torch.where(w.abs() <= eps, 0.0,
                        1.0 / torch.where(w == 0, 1.0, w))
    pinv = torch.matmul(v * w_inv[None, :], v.T)
    m1, _ = mean_vector(gp, pts[None], dts, dirs[None])
    alpha = torch.matmul(pinv, (values - m1[0]).double())
    return GlobalCond(pts=pts, dts=dts, dirs=dirs, values=values,
                      alpha=alpha.float(), k11_pinv=pinv.float())


# cross-covariance entries [rays, 2V, N] formed at once by mean_cov_gc
GC_ENTRIES = 1 << 26


def mean_cov_gc(gp, pts, dts, dirs):
    """The mean vector [R, N], covariance [R, N, N] and ids [R, N] of the GP
    at query rows, conditioned on its mesh rows when it has them
    (gp.global_cond): m + k1x^T alpha and K - k1x^T K11^+ k1x, in groups
    of rays of at most GC_ENTRIES cross-covariance entries."""
    m, ids = mean_vector(gp, pts, dts, dirs)
    K = cov_matrix(gp.cov, pts, dts, dirs, pts, dts, dirs)
    gc = gp.global_cond
    if gc is None:
        return m, K, ids
    R, N = pts.shape[0], pts.shape[1]
    M = gc.pts.shape[0]
    step = max(1, GC_ENTRIES // (M * N))
    dts_b = dts.expand(R, N)
    alpha, pinv = gc.alpha.double(), gc.k11_pinv.double()
    ms, Ks = [], []
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        k1x = cov_matrix(gp.cov, gc.pts[None], gc.dts, gc.dirs[None],
                         pts[r0:r1], dts_b[r0:r1], dirs[r0:r1]).double()
        k1x_t = k1x.transpose(1, 2)
        ms.append(m[r0:r1] + torch.matmul(k1x_t, alpha).float())
        Ks.append(K[r0:r1] - torch.matmul(
            k1x_t, torch.matmul(pinv, k1x)).float())
    return torch.cat(ms), torch.cat(Ks), ids


def conditional_mvn(gp, pts, dts, dirs, cond_pts, cond_dts, cond_dirs,
                    cond_vals):
    """The GP at query rows conditioned on rows with values cond_vals
    [R, Nc] by the Schur complement (on the mesh-conditioned GP when it
    has mesh rows): (mean [R, N], root of the covariance [R, N, N], ids
    [R, N])."""
    cov = gp.cov
    if gp.global_cond is None:
        s11 = cov_matrix(cov, cond_pts, cond_dts, cond_dirs, cond_pts,
                         cond_dts, cond_dirs)
        s12 = cov_matrix(cov, cond_pts, cond_dts, cond_dirs, pts, dts, dirs)
        m2, ids = mean_vector(gp, pts, dts, dirs)
        m1, _ = mean_vector(gp, cond_pts, cond_dts, cond_dirs)
        s22 = cov_matrix(cov, pts, dts, dirs, pts, dts, dirs)
    else:
        R, nc = pts.shape[0], cond_pts.shape[1]
        all_dts = torch.cat([cond_dts.expand(R, nc),
                             dts.expand(R, pts.shape[1])], dim=1)
        m_all, K_all, ids_all = mean_cov_gc(
            gp, torch.cat([cond_pts, pts], dim=1), all_dts,
            torch.cat([cond_dirs, dirs], dim=1))
        s11 = K_all[:, :nc, :nc].contiguous()
        s12 = K_all[:, :nc, nc:]
        s22 = K_all[:, nc:, nc:]
        m1, m2 = m_all[:, :nc], m_all[:, nc:]
        ids = ids_all[:, nc:]
    solved = psd_solve(s11, s12).transpose(-1, -2)  # [R, N, Nc]
    mean = m2 + torch.matmul(solved, (cond_vals - m1)[..., None])[..., 0]
    s2 = s22 - torch.matmul(solved, s12)
    return mean, sqrt_psd(_sym(s2).contiguous()), ids


def prior_mvn(gp, pts, dts, dirs):
    """The GP at query rows, unconditioned but for its mesh rows: (mean,
    root, ids)."""
    m, s, ids = mean_cov_gc(gp, pts, dts, dirs)
    return m, sqrt_psd(_sym(s).contiguous()), ids


def gp_cdf(gp, p):
    """P(f(p) < 0) at points p [R, 3] (the free-flight skip's criterion),
    on the mesh-conditioned GP when it has mesh rows."""
    if gp.global_cond is not None:
        zeros = torch.zeros(p.shape[0], 1, dtype=torch.int64,
                            device=p.device)
        mv, K, _ = mean_cov_gc(gp, p[:, None], zeros,
                               torch.zeros_like(p)[:, None])
        m, var = mv[:, 0], K[:, 0, 0]
    else:
        var = gp.cov.cov(p, p)
        m, _ = gp.mean_and_id(p)
    return 0.5 * (1.0 + torch.erf((0.0 - m) / torch.sqrt(
        torch.clamp(var, min=1e-20)) / _SQRT2_F32))


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
_SQRT2_F32 = float(torch.sqrt(torch.tensor(2.0, dtype=torch.float32)))


def sample_mvn_constrained(mean, cov_sqrt, key, ctr, lo, hi, cmask,
                           max_tries=16):
    """A realization under box constraints lo <= x <= hi on the entries
    cmask [n] marks: max_tries candidates drawn at counters ctr + (1 + i)
    7919, the first that passes taken, the last one if none does.
    Returns (values [R, n], whether one passed [R])."""
    R, n = mean.shape
    z = torch.stack([normals(key, (ctr + (1 + i) * 7919) & rng.MASK32, n)
                     for i in range(max_tries)], dim=-1)  # [R, n, tries]
    cands = mean[..., None] + torch.matmul(cov_sqrt, z)
    ok = (((cands >= lo) & (cands <= hi)) | ~cmask[None, :, None]).all(dim=1)
    tries = torch.arange(max_tries, device=mean.device)
    first = torch.where(ok, tries, max_tries).amin(dim=1)
    any_ok = ok.any(dim=1)
    pick = torch.where(any_ok, first, max_tries - 1)
    vals = cands.gather(2, pick[:, None, None].expand(R, n, 1))[..., 0]
    return vals, any_ok


def sample_truncated_normal(mean, sigma, a, key, ctr):
    """x >= a from N(mean, sigma^2) by the inverse CDF, with the uniform at
    counter ctr of stream key [R]."""
    u = rng.uniform(key, ctr)
    alpha = (a - mean) / torch.clamp(sigma, min=1e-12)
    phi_a = 0.5 * (1.0 + torch.erf(alpha / _SQRT2))
    uu = torch.clamp(phi_a + u * (1.0 - phi_a), 1e-7, 1.0 - 1e-7)
    return mean + sigma * _SQRT2 * torch.special.erfinv(2.0 * uu - 1.0)
