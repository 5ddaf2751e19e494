"""GP mean functions: the deterministic SDF part of the implicit surface
(the spherical and homogeneous means of tungsten_tpu/ops/means.py)."""
from __future__ import annotations

import dataclasses

import torch

from ..utils.vecmath import length, safe_normalize


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
