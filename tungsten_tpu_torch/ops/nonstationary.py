"""Nonstationary covariances (tungsten_tpu/ops/nonstationary.py).

ProceduralNonstationaryCov: a stationary `base` whose amplitude is scaled
by the field sigma(p) ("var", also a dense grid: the `nonstationary` scene
type) and whose length scale follows the field ls(p) ("ls").  On a
sparse-convolution medium it runs in multi-resolution mode (below); in
weight and function space it is the isotropic Paciorek covariance
sigma(a) sigma(b) (l_a l_b)^(3/2) / avg^(3/2) k(|d|^2 / avg), avg =
(l_a^2 + l_b^2) / 2, whose spectral draw is the base's over ls(p).

MeanGradNonstationaryCov: the anisotropic Paciorek covariance of local
matrices F diag(aniso) F^T whose first axis follows the mean's gradient.
NeuralNonstationaryCov: the Paciorek covariance of a small sin-activated
MLP's softplus outputs (sigma(p), ls(p)).  Both are weight- and
function-space covariances, as in the JAX package.

In multi-resolution mode the per-point splat scale is 1: the noise at p
blends two lattice levels around ls(p) (sparse_conv.kernel_scale_level_ratio),
and each level samples the base covariance's splat at its level scale.  So
the splat radius, quadratic form, variance and transforms here are the
base's at that scale.  Brute-force mode (`multiResolutionGrid: false`,
ls(p) folded into each splat) is not ported: the parser refuses it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.vecmath import dot, safe_normalize, tangent_frame
from .fields import Field
from .means import _mlp


def _paciorek(sa, sb, la, lb, pa, pb, base):
    """sa sb (la lb)^(3/2) / avg^(3/2) base(|d|^2 / avg), avg = (la^2 +
    lb^2) / 2: the isotropic Paciorek form."""
    a2 = la * la
    b2 = lb * lb
    avg = torch.clamp(0.5 * (a2 + b2), min=1e-12)
    aniso_fac = torch.pow(a2 * b2, 0.75) / torch.pow(avg, 1.5)
    d = pa - pb
    return sa * sb * aniso_fac * base.cov_r2(dot(d, d) / avg)


@dataclasses.dataclass(frozen=True)
class ProceduralNonstationaryCov:
    base: object  # a stationary covariance
    var_field: Field  # sigma(p)
    ls_field: Field  # ls(p): sets the multi-resolution levels
    use_multi_res_grid: bool = True
    max_ls: float = 1.0  # the largest ls (sparseConvNoiseMaxLateralScale)
    kernel_scale: float = 3.0

    is_stationary = False

    @staticmethod
    def create(base, device, var_field=None, ls_field=None,
               use_multi_res_grid=True):
        """A missing field is the constant 1."""
        max_ls = ls_field.max_val() if ls_field is not None else 1.0
        return ProceduralNonstationaryCov(
            base=base, var_field=var_field or Field.constant(1.0, device),
            ls_field=ls_field or Field.constant(1.0, device),
            use_multi_res_grid=use_multi_res_grid, max_ls=float(max_ls),
            kernel_scale=getattr(base, "kernel_scale", 3.0))

    def variance(self, p):
        v = self.var_field(p)
        return (v * v) * self.base.variance(p)

    def cov(self, pa, pb):
        return _paciorek(self.var_field(pa), self.var_field(pb),
                         self.ls_field(pa), self.ls_field(pb), pa, pb,
                         self.base)

    def compute_beckmann_roughness(self, p):
        return self.base.compute_beckmann_roughness(p) * self.var_field(p)

    def sample_spectral_3d(self, key, ctr, p=None):
        s = self.base.sample_spectral_3d(key, ctr, p)
        if p is None:
            return s
        return s / self.ls_field(p)[..., None]

    # pointwise fields
    def amplitude(self, p):
        return self.var_field(p) * self.base.amplitude(p)

    def unscaled_variance(self, p):
        return self.var_field(p)

    def lateral_scale(self, p):
        return self.ls_field(p)

    # the base's world <-> isotropic transforms at a level scale
    def pos_world_to_local(self, v, local_scale=1.0):
        return self.base.pos_world_to_local(v) / local_scale

    def grad_world_to_local(self, g, local_scale=1.0):
        return self.base.grad_world_to_local(g) * local_scale

    def grad_local_to_world(self, g, local_scale=1.0):
        return self.base.grad_local_to_world(g) / local_scale

    def local_to_world_inv_transpose(self):
        return self.base.local_to_world_inv_transpose()

    # splats at a level scale (the multi-resolution splat scale is 1)
    def splat_radius(self, local_scale=1.0):
        return self.base.splat_radius(local_scale)

    def splat_form(self, global_scale=1.0):
        return self.base.splat_form(global_scale)

    def splat3_val_grad(self, ab, global_scale=1.0):
        return self.base.splat3_val_grad(ab, global_scale)

    def variance3(self, impulse_density, kernel_radius, global_scale=1.0):
        return self.base.variance3(impulse_density, kernel_radius,
                                   global_scale)


def _aniso_from_normal(n, aniso):
    """F diag(aniso) F^T [..., 3, 3] with F's columns (n, t, b), n the
    normalized mean gradient and (t, b) its tangent frame."""
    n = safe_normalize(n)
    t, b = tangent_frame(n)
    F = torch.stack([n, t, b], dim=-1)
    return torch.matmul(F * aniso, F.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class MeanGradNonstationaryCov:
    base: object  # a stationary covariance
    mean: object  # its gradient orients the local matrices
    aniso: torch.Tensor  # [3] eigenvalues along (gradient, t, b)

    is_stationary = False

    def local_aniso(self, p):
        return _aniso_from_normal(self.mean.grad(p), self.aniso)

    def cov(self, pa, pb):
        A = self.local_aniso(pa)
        B = self.local_aniso(pb)
        avg = 0.5 * (A + B)
        det_a = torch.linalg.det(A)
        det_b = torch.linalg.det(B)
        det_avg = torch.clamp(torch.linalg.det(avg), min=1e-20)
        aniso_fac = (torch.pow(torch.clamp(det_a * det_b, min=1e-20), 0.25)
                     / torch.sqrt(det_avg))
        d = pa - pb
        dsq = dot(d, torch.linalg.solve(avg, d[..., None])[..., 0])
        return aniso_fac * self.base.cov_r2(dsq)

    def amplitude(self, p):
        return self.base.amplitude(p)

    def variance(self, p):
        return self.base.variance(p)

    def compute_beckmann_roughness(self, p):
        return self.base.compute_beckmann_roughness(p)

    def sample_spectral_3d(self, key, ctr, p=None):
        s = self.base.sample_spectral_3d(key, ctr, None)
        if p is None:
            return s
        # the stationary frequency warped by the local aniso^(-1/2)
        evals, evecs = torch.linalg.eigh(self.local_aniso(p))
        w = s / torch.sqrt(torch.clamp(evals, min=1e-9))
        return torch.matmul(evecs, w[..., None])[..., 0]


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


@dataclasses.dataclass(frozen=True)
class NeuralNonstationaryCov:
    base: object  # a stationary covariance
    weights: tuple  # ((W [in, out], b [out]), ...): outputs (sigma, ls)
    transform: torch.Tensor  # [4, 4]

    is_stationary = False

    def sigma_ls(self, p):
        out = _softplus(_mlp(self.weights, self.transform, p))
        return out[..., 0], out[..., 1]

    def cov(self, pa, pb):
        sa, la = self.sigma_ls(pa)
        sb, lb = self.sigma_ls(pb)
        return _paciorek(sa, sb, la, lb, pa, pb, self.base)

    def amplitude(self, p):
        return self.sigma_ls(p)[0] * self.base.amplitude(p)

    def variance(self, p):
        s, _ = self.sigma_ls(p)
        return s * s * self.base.variance(p)

    def compute_beckmann_roughness(self, p):
        return self.base.compute_beckmann_roughness(p) * self.sigma_ls(p)[0]

    def sample_spectral_3d(self, key, ctr, p=None):
        s = self.base.sample_spectral_3d(key, ctr, None)
        if p is None:
            return s
        return s / self.sigma_ls(p)[1][..., None]
