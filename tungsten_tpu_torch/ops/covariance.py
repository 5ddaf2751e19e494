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


@dataclasses.dataclass(frozen=True)
class SquaredExponentialCov:
    sigma: torch.Tensor  # scalar
    l: torch.Tensor  # scalar
    aniso: torch.Tensor  # [3]
    kernel_scale: float = 3.0  # splat cutoff radius, in splat lengths

    is_stationary = True

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
        return self.kernel_scale * local_scale * torch.max(self.l_aniso)

    def splat_radius_iso(self):
        """Cell radius of the isotropic-space lattice (the 1D and the
        isotropic-ray 3D sampling spaces): `kernel_scale`, a Python float
        holding a float32 value."""
        return float(np.float32(self.kernel_scale))

    # world <-> isotropic space (diagonal local_to_world = diag(l_aniso))
    def pos_world_to_local(self, v):
        return self.l_aniso_inv * v

    def grad_world_to_local(self, g):
        return self.l_aniso * g

    def grad_local_to_world(self, g):
        return self.l_aniso_inv * g

    def local_to_world_inv_transpose(self):
        """Diagonal [3] of the iso -> world gradient transform."""
        return self.l_aniso_inv

    def splat_form(self, global_scale=1.0, is_identity=False):
        """Diagonal [3] of the quadratic form M of the splat exp(-ab^T M ab)
        at spatial scale s = `global_scale`: M = diag(1 / l_aniso^2) / s^2 / 2,
        with a zero length giving 0, or I / 2 in isotropic space.  A
        per-point s has a trailing axis of size 1."""
        if is_identity:
            return torch.full((3,), 0.5, dtype=torch.float32,
                              device=self.l.device)
        inv = self.l_aniso_inv
        return inv * inv / (global_scale * global_scale) * 0.5

    def splat3_val_grad(self, ab, global_scale=1.0, is_identity=False):
        """Splat value and its gradient wrt the query; ab = query - center,
        [..., 3]."""
        mab = ab * self.splat_form(global_scale, is_identity)
        f = torch.exp(-dot(ab, mab))
        return f, -2.0 * mab * f[..., None]

    def cond_form(self, is_identity=False):
        """Diagonal [3] of the conditioning splat's form: the covariance
        kernel's, half the splat's (JAX `_inv_cov_mtx` with is_cov)."""
        return self.splat_form(1.0, is_identity) * 0.5

    def splat3_conditioning_combo(self, ab, coeff, value_scale,
                                  is_identity=False):
        """value_scale * K + sum_i coeff_i dK/dcenter_i of the covariance
        kernel K at ab = query - conditioning origin [R, 3], with its
        gradient in the query: (val [R], grad [R, 3])."""
        m = self.cond_form(is_identity)
        mab = ab * m
        f = torch.exp(-dot(ab, mab))
        d = -2.0 * mab
        val = (value_scale + dot(d, coeff)) * f
        hess = d[:, :, None] * d[:, None, :] - 2.0 * torch.diag(m)
        grad = (d * value_scale[:, None] + mat_vec(hess, coeff)) * f[:, None]
        return val, grad

    def one_over_second_derivative(self, is_identity=False):
        """Inverse [3, 3] of the covariance splat's Hessian at 0: -2 I in
        isotropic space, -2 diag(l_aniso^2) in world space."""
        if is_identity:
            m = torch.eye(3, dtype=torch.float32, device=self.l.device)
        else:
            inv = self.l_aniso_inv
            m = torch.diag(inv * inv)
        return inverse3((-2.0 * (m * 0.25))[None])[0]

    # 1D kernels along the iso-ray axis; dt = query - center in iso units
    @staticmethod
    def splat1_val_grad(dt):
        """1D splat exp(-dt^2 / 2) and its derivative in the query."""
        f = torch.exp(-0.5 * dt * dt)
        return f, -dt * f

    @staticmethod
    def cov1_val_grad(dt):
        """1D covariance kernel exp(-dt^2 / 4) (the splat at scale sqrt 2)
        and its derivative in the query."""
        f = torch.exp(-0.25 * dt * dt)
        return f, -0.5 * dt * f

    @staticmethod
    def cov1_grad_grad2(dt):
        """First and second derivatives of the 1D covariance kernel."""
        f = torch.exp(-0.25 * dt * dt)
        g1 = -0.5 * dt
        return g1 * f, (g1 * g1 - 0.5) * f

    @staticmethod
    def cov1_grad2_for_3d_normal(dt):
        """The lateral second derivative that correlationXY uses."""
        return -0.5 * torch.exp(-0.25 * dt * dt)

    def variance1(self, impulse_density, kernel_radius):
        """Analytic variance of the raw 1D noise (a scalar)."""
        sqrt_pi = torch.sqrt(torch.tensor(math.pi, dtype=torch.float32,
                                          device=impulse_density.device))
        return impulse_density / kernel_radius * sqrt_pi

    def variance3(self, impulse_density, kernel_radius, global_scale=1.0,
                  is_identity=False):
        """Analytic variance of the raw 3D noise at cell radius
        `kernel_radius` and spatial scale `global_scale` (scalars, or one
        of each per point); det_sqrt is 1 in isotropic space."""
        dens = impulse_density / (kernel_radius * kernel_radius
                                  * kernel_radius)
        if is_identity:
            return dens * (math.pi ** 1.5) * 1.0
        la = self.l_aniso
        det_sqrt = la[0] * la[1] * la[2] * (global_scale * global_scale
                                            * global_scale)
        return dens * (math.pi ** 1.5) * det_sqrt

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
