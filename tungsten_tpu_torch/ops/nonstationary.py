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

On a sparse-convolution medium it samples in one of two modes.  In
multi-resolution mode the per-point splat scale is 1: the noise at p
blends two lattice levels around ls(p) (sparse_conv.level_pair), and each
level samples the base covariance's splat at its level scale.  In
brute-force mode (`multiResolutionGrid: false`) the sampling space is the
base's scaled by max(ls), and each splat's form is divided by the square
of the per-point splat scale ls(p) / max(ls) (its 1D splats by the scale
itself), as is the noise's variance.  The methods below take the JAX
package's formulas, which reduce to the base's to the bit where the
scale is 1.
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

    def nonstat_splat_kernel_scale(self, p):
        """The per-point splat scale: 1 in multi-resolution mode, ls(p) /
        max(ls) in brute-force mode."""
        if self.use_multi_res_grid:
            return torch.ones(p.shape[:-1], dtype=torch.float32,
                              device=p.device)
        return self.ls_field(p) / self.max_ls

    def nonstat_splat_cov_1d(self, pq, pc):
        """The 1D covariance kernel's scale between two points."""
        a = self.nonstat_splat_kernel_scale(pq)
        b = self.nonstat_splat_kernel_scale(pc)
        return torch.sqrt(0.5 * (a * a + b * b))

    def _scale(self, local_scale):
        """The transforms' scale: the level's, or max(ls) in brute-force
        mode."""
        return local_scale if self.use_multi_res_grid else self.max_ls

    def _inv_ls2(self, p):
        """max(ls_splat(p)^2, 1e-12) [R], the divisor of the splat forms,
        or None in multi-resolution mode (where it is 1)."""
        if self.use_multi_res_grid or p is None:
            return None
        ls = self.nonstat_splat_kernel_scale(p)
        return torch.clamp(ls * ls, min=1e-12)

    # the base's world <-> isotropic transforms at a level scale
    def pos_world_to_local(self, v, local_scale=1.0):
        return self.base.pos_world_to_local(v) / self._scale(local_scale)

    def grad_world_to_local(self, g, local_scale=1.0):
        return self.base.grad_world_to_local(g) * self._scale(local_scale)

    def grad_local_to_world(self, g, local_scale=1.0):
        return self.base.grad_local_to_world(g) / self._scale(local_scale)

    def local_to_world_inv_transpose(self):
        return self.base.local_to_world_inv_transpose() / self._scale(1.0)

    @property
    def world_to_local(self):
        return self.base.world_to_local

    # splats at a level scale, divided by the per-point splat scale
    def splat_radius(self, local_scale=1.0):
        return self.base.splat_radius(
            local_scale * (1.0 if self.use_multi_res_grid else self.max_ls))

    def splat_radius_iso(self):
        return self.base.splat_radius_iso()

    def full_form(self, is_identity=False):
        return self.base.full_form(is_identity)

    def splat_form(self, global_scale=1.0, is_identity=False):
        return self.base.splat_form(global_scale, is_identity)

    def cond_form(self, is_identity=False, global_scale=1.0):
        return self.base.cond_form(is_identity, global_scale)

    @staticmethod
    def _per_point(m, full, ls2, lead):
        """The form m (full: [..., 3, 3], else its diagonal [..., 3])
        divided per point by ls_splat^2 (ls2, [R]) for queries with `lead`
        leading axes after the ray's."""
        return m / ls2.reshape(ls2.shape + (1,) * (lead + (2 if full
                                                         else 1)))

    def splat3_val_grad(self, ab, global_scale=1.0, is_identity=False,
                        p=None):
        inv = self._inv_ls2(p)
        if inv is None:
            return self.base.splat3_val_grad(ab, global_scale, is_identity)
        full = self.full_form(is_identity)
        m = self._per_point(self.splat_form(global_scale, is_identity), full,
                            inv, ab.dim() - 2)
        from .covariance import apply_form
        mab = apply_form(m, ab, full)
        f = torch.exp(-dot(ab, mab))
        return f, -2.0 * mab * f[..., None]

    def splat3_conditioning_combo(self, ab, coeff, value_scale,
                                  is_identity=False, global_scale=1.0,
                                  p=None):
        from .covariance import conditioning_combo
        m = self.cond_form(is_identity, global_scale)
        inv = self._inv_ls2(p)
        if inv is not None:
            m = self._per_point(m, self.full_form(is_identity), inv, 0)
        return conditioning_combo(m, self.full_form(is_identity), ab, coeff,
                                  value_scale)

    def one_over_second_derivative(self, is_identity=False):
        return self.base.one_over_second_derivative(is_identity)

    def variance3(self, impulse_density, kernel_radius, global_scale=1.0,
                  is_identity=False, p=None):
        v = self.base.variance3(impulse_density, kernel_radius, global_scale,
                                is_identity)
        if self.use_multi_res_grid or p is None:
            return v
        ls = self.nonstat_splat_kernel_scale(p)
        return v * (ls * ls * ls)

    def variance1(self, impulse_density, kernel_radius, p=None):
        v = self.base.variance1(impulse_density, kernel_radius)
        if self.use_multi_res_grid or p is None:
            return v
        return v * self.nonstat_splat_kernel_scale(p)

    # 1D kernels along the iso-ray axis, at the per-point splat scales
    def splat1_val_grad(self, dt, pc):
        ls = self.nonstat_splat_kernel_scale(pc)
        if dt.dim() > ls.dim():
            ls = ls.reshape(ls.shape + (1,) * (dt.dim() - ls.dim()))
        q = dt / ls
        f = torch.exp(-0.5 * (q * q))
        return f, -dt / (ls * ls) * f

    def cov1_val_grad(self, dt, pq, pc):
        sc_ = self.nonstat_splat_cov_1d(pq, pc)
        q = dt / sc_
        f = torch.exp(-0.25 * (q * q))
        return f, -0.5 * dt / (sc_ * sc_) * f

    def cov1_grad_grad2(self, dt, pq, pc):
        sc_ = self.nonstat_splat_cov_1d(pq, pc)
        q = dt / sc_
        f = torch.exp(-0.25 * (q * q))
        g1 = -0.5 * dt / (sc_ * sc_)
        return g1 * f, (g1 * g1 - 0.5 / (sc_ * sc_)) * f

    def cov1_grad2_for_3d_normal(self, dt, pq, pc):
        sc_ = self.nonstat_splat_cov_1d(pq, pc)
        q = dt / sc_
        return -0.5 / (sc_ * sc_) * torch.exp(-0.25 * (q * q))


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
