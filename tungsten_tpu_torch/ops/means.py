"""GP mean functions: the deterministic SDF part of the implicit surface
(tungsten_tpu/ops/means.py).

Each mean has mean(p) and grad(p) over [..., 3] points and a Lipschitz
bound.  The procedural, tabulated and neural means take their gradient by
reverse mode (`torch.func.grad` of the summed mean, which is per point),
as the JAX package takes it with jax.grad.  `mean_and_id` and
`mean_grad_by_id` are the pointwise min of a mean and a CSG union's
additional mean, with the id (0 or 1) of the one that supplies the value.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.vecmath import dot, length, safe_normalize
from . import sdf


def _autograd(mean_fn, p):
    return torch.func.grad(lambda q: mean_fn(q).sum())(p)


def _homogeneous(m, p):
    """The affine map m [4, 4] applied to points p [..., 3] (with w = 1),
    its products written out."""
    return (m[:3, 0] * p[..., 0:1] + m[:3, 1] * p[..., 1:2]
            + m[:3, 2] * p[..., 2:3] + m[:3, 3] * 1.0)


@dataclasses.dataclass(frozen=True)
class HomogeneousMean:
    offset: torch.Tensor  # scalar

    def mean(self, p):
        return self.offset.expand(p.shape[:-1])

    def grad(self, p):
        return torch.zeros_like(p)

    def lipschitz(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class SphericalMean:
    center: torch.Tensor  # [3]
    radius: torch.Tensor  # scalar

    def mean(self, p):
        return length(p - self.center) - self.radius

    def grad(self, p):
        return safe_normalize(p - self.center)

    def lipschitz(self):
        return 1.0


@dataclasses.dataclass(frozen=True)
class LinearMean:
    """The plane max((p - ref) . dir * scale, min), dir normalized."""
    ref: torch.Tensor  # [3]
    dir: torch.Tensor  # [3] unit
    scale: torch.Tensor
    min: torch.Tensor

    def mean(self, p):
        return torch.maximum(dot(p - self.ref, self.dir) * self.scale,
                             self.min)

    def grad(self, p):
        active = dot(p - self.ref, self.dir) * self.scale >= self.min
        return torch.where(active[..., None], self.dir * self.scale, 0.0)

    def lipschitz(self):
        return self.scale


@dataclasses.dataclass(frozen=True)
class ProceduralMean:
    """max(sdf(T p) * scale + offset, min) for an analytic SDF of
    ops/sdf.py and a world -> SDF-local transform T [4, 4]."""
    transform: torch.Tensor
    offset: torch.Tensor
    scale: torch.Tensor
    min: torch.Tensor
    fn_name: str = "knob"

    def mean(self, p):
        f = sdf.FUNCTIONS[self.fn_name]
        return torch.maximum(
            f(_homogeneous(self.transform, p)) * self.scale + self.offset,
            self.min)

    def grad(self, p):
        return _autograd(self.mean, p)

    def lipschitz(self):
        return self.scale


@dataclasses.dataclass(frozen=True)
class TabulatedMean:
    """A dense grid values [nx, ny, nz] over [bounds_min, bounds_max],
    trilinear, times scale plus offset (also the baked mesh SDF of the
    `mesh` mean type)."""
    values: torch.Tensor
    bounds_min: torch.Tensor
    bounds_max: torch.Tensor
    offset: torch.Tensor
    scale: torch.Tensor
    interp: str = "linear"

    def _sample(self, p):
        return trilinear(self.values, self.bounds_min, self.bounds_max, p)

    def mean(self, p):
        return self._sample(p) * self.scale + self.offset

    def grad(self, p):
        return _autograd(self.mean, p)

    def lipschitz(self):
        return self.scale


def trilinear(grid, bounds_min, bounds_max, p, vector=False):
    """Trilinear lookup of grid [nx, ny, nz] (or [nx, ny, nz, 3] with
    `vector`) at p [..., 3], clamped to the grid, with the JAX package's
    corner order and rounding."""
    shape = torch.tensor(grid.shape[:3], dtype=torch.float32,
                         device=p.device)
    uvw = (p - bounds_min) / (bounds_max - bounds_min)
    g = uvw * (shape - 1.0)
    g = torch.minimum(torch.clamp(g, min=0.0), shape - 1.0 - 1e-4)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0
    v = 0.0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = ((f[..., 0] if cx else 1 - f[..., 0])
                     * (f[..., 1] if cy else 1 - f[..., 1])
                     * (f[..., 2] if cz else 1 - f[..., 2]))
                val = grid[i0[..., 0] + cx, i0[..., 1] + cy, i0[..., 2] + cz]
                v = v + (w[..., None] if vector else w) * val
    return v


def _mlp(weights, transform, p):
    """The sin-activated MLP of the neural mean and covariance on the
    transformed points: [..., outputs]."""
    h = _homogeneous(transform, p)
    n = len(weights)
    for i, (w, b) in enumerate(weights):
        h = torch.matmul(h, w) + b
        if i < n - 1:
            h = torch.sin(h)
    return h


@dataclasses.dataclass(frozen=True)
class NeuralMean:
    """A small sin-activated MLP SDF: weights ((W [in, out], b [out]),
    ...), its first output times scale plus offset."""
    weights: tuple
    transform: torch.Tensor
    offset: torch.Tensor
    scale: torch.Tensor

    def mean(self, p):
        return (_mlp(self.weights, self.transform, p)[..., 0] * self.scale
                + self.offset)

    def grad(self, p):
        return _autograd(self.mean, p)

    def lipschitz(self):
        return self.scale


def mean_and_id(mean, mean_additional, p):
    """The pointwise min of `mean` and `mean_additional` (None: `mean`
    alone) and the id of the one that supplies it (1 for the additional
    mean), int64."""
    m0 = mean.mean(p)
    zeros = torch.zeros(p.shape[:-1], dtype=torch.int64, device=p.device)
    if mean_additional is None:
        return m0, zeros
    m1 = mean_additional.mean(p)
    take1 = m1 < m0
    return torch.where(take1, m1, m0), take1.to(torch.int64)


def mean_grad_by_id(mean, mean_additional, p, gp_id):
    """The gradient of the mean with id gp_id at p."""
    g0 = mean.grad(p)
    if mean_additional is None:
        return g0
    return torch.where((gp_id == 1)[..., None], mean_additional.grad(p), g0)
