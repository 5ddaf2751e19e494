"""The squared-exponential covariance, its sparse-convolution splats in
world space, in isotropic space and along the iso-ray axis, the
conditioning splat of renewal contexts, and its spectral density (the part
of tungsten_tpu/ops/covariance.py::SquaredExponentialCov that stationary
world-space and isotropic-ray sampling, 1D sampling and weight-space
realizations reach).

cov(a, b) = sigma^2 exp(-|a - b|^2_aniso / (2 l^2)); the splat kernel has
length l_conv = l sqrt(2)/2 so that splat * splat reproduces cov.  Only the
diagonal anisotropy is ported (no `anisoMtx`), so the splat's quadratic
form and the world <-> isotropic transforms are diagonal: each is written
as a product with the [3] diagonal, which rounds as the JAX package's 3x3
products with zeros off the diagonal do.  A stationary covariance samples
at spatial scale 1; a level of the multi-resolution grid (ops/nonstationary.py)
samples at its level scale s, passed as the JAX package's `local_scale`
(splat radius) and `global_scale` (quadratic form, variance) arguments,
scalars or one per point.  At their default 1 they change no bit.  The
nonstationary 1D splat scale (`nonstat_splat_cov_1d`) is 1, so the 1D code
leaves it out.
In isotropic space (`is_identity`) the splat is exp(-|ab|^2 / 2) with
cell radius `kernel_scale`: its form is the identity over 2 and its
variance has det_sqrt 1.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import rng
from ..utils.vecmath import dot, inverse3, mat_vec

_SQRT2_OVER_2 = math.sqrt(2.0) / 2.0
# sqrt(pi) as float32 computes it (a Python float holding that value, so
# that no constant is copied to the card per call)
_SQRT_PI_F32 = float(np.sqrt(np.float32(math.pi)))
_PI = math.pi


def _gauss3(key, ctr):
    """The three N(0, 1) variates of spectral sample `ctr`: the Box-Muller
    pair at counter 3 ctr and the first of the pair at 3 ctr + 1 ->
    [..., 3]."""
    n0, n1 = rng.normal2(key, 3 * ctr)
    n2, _ = rng.normal2(key, 3 * ctr + 1)
    return torch.stack([n0, n1, n2], dim=-1)


def apply_form(m, v, full):
    """M v for a quadratic form M over v [..., 3]: the diagonal of M
    (elementwise) or, `full`, a [..., 3, 3] matrix, its products written
    out."""
    if not full:
        return v * m
    return (m[..., :, 0] * v[..., 0:1] + m[..., :, 1] * v[..., 1:2]
            + m[..., :, 2] * v[..., 2:3])


def conditioning_combo(m, full, ab, coeff, value_scale):
    """value_scale * K + coeff . dK/dcenter of the kernel exp(-ab^T M ab)
    at ab [R, 3] and its gradient in the query, for the form M (its
    diagonal [..., 3], or `full`, [..., 3, 3]): (val [R], grad [R, 3])."""
    mab = apply_form(m, ab, full)
    f = torch.exp(-dot(ab, mab))
    d = -2.0 * mab
    val = (value_scale + dot(d, coeff)) * f
    hess = d[:, :, None] * d[:, None, :] - 2.0 * (
        m if full else torch.diag_embed(m))
    grad = (d * value_scale[:, None] + mat_vec(hess, coeff)) * f[:, None]
    return val, grad


def _beckmann_roughness(cov):
    """sqrt(2 sigma^2 aniso_x / l^2), the closed form of the SE and RQ."""
    return torch.sqrt(2.0 * (cov.sigma * cov.sigma * cov.aniso[0]
                             / (cov.l * cov.l)))


def _r(pa, pb, floor):
    """|pa - pb| with its square floored at `floor`."""
    d = pa - pb
    return torch.sqrt(torch.clamp(dot(d, d), min=floor))


@dataclasses.dataclass(frozen=True)
class SquaredExponentialCov:
    sigma: torch.Tensor  # scalar
    l: torch.Tensor  # scalar
    aniso: torch.Tensor  # [3]
    kernel_scale: float = 3.0  # splat cutoff radius, in splat lengths
    # a full [3, 3] anisotropy of the sparse-conv splat (`anisoMtx`); the
    # covariance and its spectral draw use `aniso` alone, as in the JAX
    # package
    aniso_mtx: torch.Tensor | None = None

    is_stationary = True

    @property
    def use_aniso_mtx(self):
        return self.aniso_mtx is not None

    # anisoMtx: local_to_world = l_conv aniso_mtx, world_to_local its
    # inverse, and the splat's quadratic form W2L^T W2L a full [3, 3]
    @property
    def local_to_world(self):
        return self.l * _SQRT2_OVER_2 * self.aniso_mtx

    @property
    def world_to_local(self):
        return inverse3(self.local_to_world[None])[0]

    @property
    def inv_cov_world(self):
        w2l = self.world_to_local
        return torch.matmul(w2l.T, w2l)

    @property
    def l_aniso(self):
        return self.l * _SQRT2_OVER_2 * self.aniso

    def amplitude(self, p):
        return self.sigma.expand(p.shape[:-1])

    @property
    def l_aniso_inv(self):
        """1 / l_aniso with a zero length giving 0: the diagonal of
        world_to_local."""
        la = self.l_aniso
        return torch.where(la == 0.0, 0.0,
                           1.0 / torch.where(la == 0.0, 1.0, la))

    def splat_radius(self, local_scale=1.0):
        """Cell radius of the world-space splat lattice at level scale
        `local_scale`."""
        if self.use_aniso_mtx:
            return (self.kernel_scale * local_scale
                    * torch.max(self.local_to_world.sum(dim=1)))
        return self.kernel_scale * local_scale * torch.max(self.l_aniso)

    def splat_radius_iso(self):
        """Cell radius of the isotropic-space lattice (the 1D and the
        isotropic-ray 3D sampling spaces): `kernel_scale`, a Python float
        holding a float32 value."""
        return float(np.float32(self.kernel_scale))

    # world <-> isotropic space: local_to_world = diag(l_aniso), or the
    # full l_conv anisoMtx, whose products are written out
    def pos_world_to_local(self, v):
        if self.use_aniso_mtx:
            return apply_form(self.world_to_local, v, True)
        return self.l_aniso_inv * v

    def grad_world_to_local(self, g):
        if self.use_aniso_mtx:
            return apply_form(self.local_to_world.T, g, True)
        return self.l_aniso * g

    def grad_local_to_world(self, g):
        if self.use_aniso_mtx:
            return apply_form(self.world_to_local.T, g, True)
        return self.l_aniso_inv * g

    def local_to_world_inv_transpose(self):
        """The iso -> world gradient transform: its diagonal [3], or with
        anisoMtx the full [3, 3] world_to_local^T."""
        if self.use_aniso_mtx:
            return self.world_to_local.T
        return self.l_aniso_inv

    # the fields of a nonstationary covariance, constant here
    def unscaled_variance(self, p):
        return torch.ones(p.shape[:-1], dtype=torch.float32,
                          device=p.device)

    lateral_scale = unscaled_variance
    nonstat_splat_kernel_scale = unscaled_variance

    def splat_form(self, global_scale=1.0, is_identity=False):
        """Diagonal [3] of the quadratic form M of the splat exp(-ab^T M ab)
        at spatial scale s = `global_scale`: M = diag(1 / l_aniso^2) / s^2 / 2,
        with a zero length giving 0, or I / 2 in isotropic space.  A
        per-point s has a trailing axis of size 1.  With anisoMtx, M =
        W2L^T W2L / s^2 / 2 in full: [3, 3] (a per-point s: [..., 1, 1])."""
        if is_identity:
            return torch.full((3,), 0.5, dtype=torch.float32,
                              device=self.l.device)
        if self.use_aniso_mtx:
            if isinstance(global_scale, torch.Tensor) and global_scale.dim():
                global_scale = global_scale[..., None]
            return self.inv_cov_world / (global_scale * global_scale) * 0.5
        inv = self.l_aniso_inv
        return inv * inv / (global_scale * global_scale) * 0.5

    def full_form(self, is_identity=False):
        """Whether splat_form is a full [3, 3] (anisoMtx in world space)."""
        return self.use_aniso_mtx and not is_identity

    def splat3_val_grad(self, ab, global_scale=1.0, is_identity=False,
                        p=None):
        """Splat value and its gradient wrt the query; ab = query - center,
        [..., 3] (`p`, the query point, is read by a nonstationary
        covariance's per-point splat scale)."""
        mab = apply_form(self.splat_form(global_scale, is_identity), ab,
                         self.full_form(is_identity))
        f = torch.exp(-dot(ab, mab))
        return f, -2.0 * mab * f[..., None]

    def cond_form(self, is_identity=False, global_scale=1.0):
        """The conditioning splat's form at spatial scale `global_scale`:
        the covariance kernel's, half the splat's (JAX `_inv_cov_mtx` with
        is_cov)."""
        return self.splat_form(global_scale, is_identity) * 0.5

    def splat3_conditioning_combo(self, ab, coeff, value_scale,
                                  is_identity=False, global_scale=1.0,
                                  p=None):
        """value_scale * K + sum_i coeff_i dK/dcenter_i of the covariance
        kernel K at ab = query - conditioning origin [R, 3] (at spatial
        scale `global_scale`, per point with a trailing axis of size 1),
        with its gradient in the query: (val [R], grad [R, 3])."""
        return conditioning_combo(self.cond_form(is_identity, global_scale),
                                  self.full_form(is_identity), ab, coeff,
                                  value_scale)

    def one_over_second_derivative(self, is_identity=False):
        """Inverse [3, 3] of the covariance splat's Hessian at 0: -2 I in
        isotropic space, -2 diag(l_aniso^2) in world space."""
        if is_identity:
            m = torch.eye(3, dtype=torch.float32, device=self.l.device)
        elif self.use_aniso_mtx:
            m = self.inv_cov_world
        else:
            inv = self.l_aniso_inv
            m = torch.diag(inv * inv)
        return inverse3((-2.0 * (m * 0.25))[None])[0]

    # 1D kernels along the iso-ray axis; dt = query - center in iso units
    # (the points after dt are read by a nonstationary covariance)
    @staticmethod
    def splat1_val_grad(dt, *points):
        """1D splat exp(-dt^2 / 2) and its derivative in the query."""
        f = torch.exp(-0.5 * dt * dt)
        return f, -dt * f

    @staticmethod
    def cov1_val_grad(dt, *points):
        """1D covariance kernel exp(-dt^2 / 4) (the splat at scale sqrt 2)
        and its derivative in the query."""
        f = torch.exp(-0.25 * dt * dt)
        return f, -0.5 * dt * f

    @staticmethod
    def cov1_grad_grad2(dt, *points):
        """First and second derivatives of the 1D covariance kernel."""
        f = torch.exp(-0.25 * dt * dt)
        g1 = -0.5 * dt
        return g1 * f, (g1 * g1 - 0.5) * f

    @staticmethod
    def cov1_grad2_for_3d_normal(dt, *points):
        """The lateral second derivative that correlationXY uses."""
        return -0.5 * torch.exp(-0.25 * dt * dt)

    def variance1(self, impulse_density, kernel_radius, p=None):
        """Analytic variance of the raw 1D noise (a scalar)."""
        return impulse_density / kernel_radius * _SQRT_PI_F32

    def variance3(self, impulse_density, kernel_radius, global_scale=1.0,
                  is_identity=False, p=None):
        """Analytic variance of the raw 3D noise at cell radius
        `kernel_radius` and spatial scale `global_scale` (scalars, or one
        of each per point); det_sqrt is 1 in isotropic space."""
        dens = impulse_density / (kernel_radius * kernel_radius
                                  * kernel_radius)
        if is_identity:
            return dens * (math.pi ** 1.5) * 1.0
        if self.use_aniso_mtx:
            det_sqrt = (1.0 / torch.sqrt(torch.linalg.det(self.inv_cov_world))
                        * (global_scale * global_scale * global_scale))
            return dens * (math.pi ** 1.5) * det_sqrt
        la = self.l_aniso
        det_sqrt = la[0] * la[1] * la[2] * (global_scale * global_scale
                                            * global_scale)
        return dens * (math.pi ** 1.5) * det_sqrt

    def cov_r2(self, r2):
        return self.sigma * self.sigma * torch.exp(
            -r2 / (2.0 * (self.l * self.l)))

    def cov(self, pa, pb):
        """cov(pa, pb) over [..., 3] points."""
        d = pa - pb
        return self.cov_r2(dot(d * self.aniso, d))

    def variance(self, p):
        return (self.sigma * self.sigma).expand(p.shape[:-1])

    def compute_beckmann_roughness(self, p):
        """sqrt(2 E[f_x'^2]): the roughness of the Beckmann and GGX
        normals."""
        return _beckmann_roughness(self)

    def sample_spectral_3d(self, key, ctr, p=None):
        """omega ~ the spectral density, Gaussian with standard deviation
        sqrt(aniso) / l per axis: stream `key` [...], counter words ctr [...]
        -> [..., 3]."""
        return _gauss3(key, ctr) / self.l * torch.sqrt(self.aniso)


@dataclasses.dataclass(frozen=True)
class RationalQuadraticCov:
    """cov = sigma^2 (1 + r^2 / (2 a l^2))^-a with r^2 = d.diag(aniso).d; its
    spectral draw scales a Gaussian by a Gamma(a) precision (weight and
    function space; the JAX package's sparse-conv path has no splat for
    it)."""
    sigma: torch.Tensor
    l: torch.Tensor
    a: torch.Tensor
    aniso: torch.Tensor
    kernel_scale: float = 3.0

    is_stationary = True

    def cov_r2(self, r2):
        return self.sigma * self.sigma * torch.pow(
            1.0 + r2 / (2 * self.a * (self.l * self.l)), -self.a)

    def cov(self, pa, pb):
        d = pa - pb
        return self.cov_r2(dot(d * self.aniso, d))

    def variance(self, p):
        return (self.sigma * self.sigma).expand(p.shape[:-1])

    def amplitude(self, p):
        return self.sigma.expand(p.shape[:-1])

    def compute_beckmann_roughness(self, p):
        return _beckmann_roughness(self)

    def sample_spectral_3d(self, key, ctr, p=None):
        """tau ~ Gamma(a) / (a l^2) by Marsaglia-Tsang with four proposals
        (the first accepted one, else the mode d): proposal i takes the
        normal at counter 16 + 16 ctr + i and the uniform at 97 + 16 ctr +
        i; omega = N(0, I) sqrt(tau).  An a <= 1/3 gives NaN, as in the
        JAX package."""
        shape = self.a
        d = shape - 1.0 / 3.0
        c = 1.0 / torch.sqrt(9.0 * d)
        accepted = val = None
        for i in range(4):
            n, _ = rng.normal2(key, (16 + 16 * ctr + i) & rng.MASK32)
            u = rng.uniform(key, (97 + 16 * ctr + i) & rng.MASK32)
            x = 1.0 + c * n
            v = x * (x * x)
            vf = torch.clamp(v, min=1e-9)
            ok = (v > 0) & (torch.log(u) < 0.5 * (n * n) + d - d * v
                            + d * torch.log(vf))
            cand = d * vf
            if val is None:
                val, accepted = cand, ok
            else:
                val = torch.where(accepted, val, cand)
                accepted = accepted | ok
        val = torch.where(accepted, val, d)
        mean_rate = 1.0 / (self.l * self.l)
        tau = val * (mean_rate / shape)
        l_eff = 1.0 / torch.sqrt(tau)
        return _gauss3(key, ctr) / l_eff[..., None]


@dataclasses.dataclass(frozen=True)
class MaternCov:
    """The Matern covariance in its closed forms for nu = 0.5, 1.5 and 2.5,
    blended by exp(-(nu - k)^2 1e6) weights as the JAX package blends them
    (any other nu gives 0/0 = NaN there: the parser refuses it), and its
    spectral draw, a Gaussian over sqrt(chi2 / (2 nu)) with chi2 drawn as
    an exponential."""
    sigma: torch.Tensor
    l: torch.Tensor
    nu: torch.Tensor
    aniso: torch.Tensor
    kernel_scale: float = 3.0

    is_stationary = True

    def cov_r2(self, r2):
        r = torch.sqrt(torch.clamp(r2, min=1e-20))
        s2 = self.sigma * self.sigma
        x = r / self.l
        sq3, sq5 = math.sqrt(3.0), math.sqrt(5.0)
        m05 = s2 * torch.exp(-x)
        m15 = s2 * (1 + sq3 * x) * torch.exp(-sq3 * x)
        m25 = s2 * (1 + sq5 * x + 5.0 * (x * x) / 3.0) * torch.exp(-sq5 * x)
        w = [torch.exp(-((self.nu - k) * (self.nu - k)) * 1e6)
             for k in (0.5, 1.5, 2.5)]
        return (w[0] * m05 + w[1] * m15 + w[2] * m25) / (w[0] + w[1] + w[2])

    def cov(self, pa, pb):
        d = pa - pb
        return self.cov_r2(dot(d * self.aniso, d))

    def variance(self, p):
        return (self.sigma * self.sigma).expand(p.shape[:-1])

    def amplitude(self, p):
        return self.sigma.expand(p.shape[:-1])

    def sample_spectral_3d(self, key, ctr, p=None):
        """omega = N(0, I) sqrt(2 nu / chi2) / l, chi2 = -2 nu log(1 - u)
        with u the uniform at counter 5 ctr + 1."""
        u = rng.uniform(key, (5 * ctr + 1) & rng.MASK32)
        chi2 = -2.0 * self.nu * torch.log1p(-u)
        return (_gauss3(key, ctr) * torch.sqrt(
            2.0 * self.nu / torch.clamp(chi2, min=1e-6))[..., None]
            / self.l)


def _hessian_at_zero(fn, device):
    """The Hessian [3, 3] of a scalar function of one point at 0, by
    forward over reverse mode."""
    zero = torch.zeros(3, dtype=torch.float32, device=device)
    return torch.func.jacfwd(torch.func.grad(fn))(zero)


class _GaborCommon:
    """What the two Gabor covariances share: a constant amplitude, the
    unit-normal spectral draw and the roughness from the splat's
    curvature at 0 (weight and function space; the JAX package's
    sparse-conv fast path has no quadratic splat form for them)."""
    is_stationary = True

    def amplitude(self, p):
        return self.sigma.expand(p.shape[:-1])

    def variance(self, p):
        return (self.sigma * self.sigma).expand(p.shape[:-1])

    def compute_beckmann_roughness(self, p):
        h = _hessian_at_zero(self.splat3_val, self.sigma.device)
        return torch.sqrt(torch.clamp(2.0 * h[0, 0].abs(), min=1e-12))

    def sample_spectral_3d(self, key, ctr, p=None):
        return _gauss3(key, ctr)


@dataclasses.dataclass(frozen=True)
class GaborAnisoCov(_GaborCommon):
    """exp(-pi a^2 |x|^2) cos(2 pi f omega . x) splats; cov is the Gabor
    noise's autocovariance, sigma^2 exp(-pi a^2 |d|^2 / 2) cos(2 pi f
    omega . d)."""
    sigma: torch.Tensor
    a: torch.Tensor  # 1 / a_inv
    f: torch.Tensor  # 1 / f_inv
    omega: torch.Tensor  # [3] unit
    kernel_scale: float = 3.0

    def splat3_val(self, ab):
        return (torch.exp(-_PI * (self.a * self.a) * dot(ab, ab))
                * torch.cos(2.0 * _PI * self.f * dot(self.omega, ab)))

    def cov(self, pa, pb):
        d = pa - pb
        return (self.sigma * self.sigma
                * torch.exp(-0.5 * _PI * (self.a * self.a) * dot(d, d))
                * torch.cos(2.0 * _PI * self.f * dot(self.omega, d)))


@dataclasses.dataclass(frozen=True)
class GaborIsoCov(_GaborCommon):
    """exp(-pi a^2 r^2) 2f sin(2 pi f r) / r splats; cov = sigma^2
    exp(-pi a^2 r^2 / 2) sinc(2 f r)."""
    sigma: torch.Tensor
    a: torch.Tensor
    f: torch.Tensor
    kernel_scale: float = 3.0

    def splat3_val(self, ab):
        r2 = dot(ab, ab)
        r = torch.sqrt(r2 + 1e-12)
        return (torch.exp(-_PI * (self.a * self.a) * r2) * 2.0 * self.f
                * torch.sinc(2.0 * self.f * r) * 2.0 * _PI * self.f)

    def cov(self, pa, pb):
        r = _r(pa, pb, 1e-12)
        return (self.sigma * self.sigma
                * torch.exp(-0.5 * _PI * (self.a * self.a) * r * r)
                * torch.sinc(2.0 * self.f * r))


@dataclasses.dataclass(frozen=True)
class PeriodicCov:
    """sigma^2 exp(-2 sin^2(pi r / period) / l^2); its spectral draw is a
    unit direction at the fundamental 2 pi / period.  Like ThinPlateCov and
    DotProductCov it has no amplitude, as in the JAX package, whose
    sparse-conv and weight-space media then fail: function space only."""
    sigma: torch.Tensor
    l: torch.Tensor
    period: torch.Tensor

    is_stationary = True

    def cov(self, pa, pb):
        s = torch.sin(_PI * _r(pa, pb, 1e-20) / self.period)
        return self.sigma * self.sigma * torch.exp(
            -2.0 * (s * s) / (self.l * self.l))

    def compute_beckmann_roughness(self, p):
        return 2.0 * _PI / (self.period * self.l) * self.sigma

    def sample_spectral_3d(self, key, ctr, p=None):
        g = _gauss3(key, ctr)
        norm = torch.sqrt(dot(g, g))
        g = g / torch.clamp(norm, min=1e-9)[..., None]
        return g * 2.0 * _PI / self.period


@dataclasses.dataclass(frozen=True)
class ThinPlateCov:
    """sigma^2 (2 r^3 - 3 R r^2 + R^3) / 12 with r capped at R; its spectral
    draw is N(0, I) / R."""
    sigma: torch.Tensor
    R: torch.Tensor

    is_stationary = True

    def cov(self, pa, pb):
        r = torch.minimum(_r(pa, pb, 1e-20), self.R)
        return self.sigma * self.sigma * (
            2 * (r * (r * r)) - 3 * self.R * (r * r)
            + self.R * (self.R * self.R)) / 12.0

    def compute_beckmann_roughness(self, p):
        return self.sigma * torch.sqrt(self.R / 2.0)

    def sample_spectral_3d(self, key, ctr, p=None):
        return _gauss3(key, ctr) / self.R


@dataclasses.dataclass(frozen=True)
class DotProductCov:
    """The nonstationary linear kernel sigma^2 (a . b + c)."""
    sigma: torch.Tensor
    c: torch.Tensor

    is_stationary = False

    def cov(self, pa, pb):
        return self.sigma * self.sigma * (dot(pa, pb) + self.c)

    def compute_beckmann_roughness(self, p):
        return self.sigma * math.sqrt(2.0)

    def sample_spectral_3d(self, key, ctr, p=None):
        return _gauss3(key, ctr)
