"""The squared-exponential covariance, its sparse-convolution splat in
world space and its spectral density (the part of
tungsten_tpu/ops/covariance.py::SquaredExponentialCov that stationary
world-space sampling and weight-space realizations reach).

cov(a, b) = sigma^2 exp(-|a - b|^2_aniso / (2 l^2)); the splat kernel has
length l_conv = l sqrt(2)/2 so that splat * splat reproduces cov.  Only the
diagonal anisotropy is ported (no `anisoMtx`), so the splat's quadratic
form is diagonal.  A stationary covariance samples world space at spatial
scale 1, which the JAX package's `global_scale` arguments reduce to here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import rng
from ..utils.vecmath import dot

_SQRT2_OVER_2 = math.sqrt(2.0) / 2.0


@dataclasses.dataclass(frozen=True)
class SquaredExponentialCov:
    sigma: torch.Tensor  # scalar
    l: torch.Tensor  # scalar
    aniso: torch.Tensor  # [3]
    kernel_scale: float = 3.0  # splat cutoff radius, in splat lengths

    @property
    def l_aniso(self):
        return self.l * _SQRT2_OVER_2 * self.aniso

    def amplitude(self, p):
        return self.sigma.expand(p.shape[:-1])

    def splat_radius(self):
        """Cell radius of the splat lattice."""
        return self.kernel_scale * torch.max(self.l_aniso)

    def splat_form(self):
        """Diagonal [3] of the quadratic form M of the splat exp(-ab^T M ab):
        M = diag(1 / l_aniso^2) / 2, with a zero length giving 0."""
        la = self.l_aniso
        inv = torch.where(la == 0.0, 0.0, 1.0 / torch.where(la == 0.0, 1.0,
                                                            la))
        return inv * inv * 0.5

    def splat3_val_grad(self, ab):
        """Splat value and its gradient wrt the query; ab = query - center,
        [..., 3]."""
        mab = ab * self.splat_form()
        f = torch.exp(-dot(ab, mab))
        return f, -2.0 * mab * f[..., None]

    def variance3(self, impulse_density, kernel_radius):
        """Analytic variance of the raw 3D noise (a scalar here: the JAX
        package broadcasts the same value over the points)."""
        dens = impulse_density / (kernel_radius * kernel_radius
                                  * kernel_radius)
        la = self.l_aniso
        return dens * (math.pi ** 1.5) * (la[0] * la[1] * la[2])

    def cov(self, pa, pb):
        """cov(pa, pb) over [..., 3] points."""
        d = pa - pb
        r2 = dot(d * self.aniso, d)
        return self.sigma * self.sigma * torch.exp(
            -r2 / (2.0 * (self.l * self.l)))

    def sample_spectral_3d(self, key, ctr):
        """omega ~ the spectral density, Gaussian with standard deviation
        sqrt(aniso) / l per axis: stream `key` [...], counter words ctr [...]
        -> [..., 3]."""
        n0, n1 = rng.normal2(key, 3 * ctr)
        n2, _ = rng.normal2(key, 3 * ctr + 1)
        g = torch.stack([n0, n1, n2], dim=-1)
        return g / self.l * torch.sqrt(self.aniso)
