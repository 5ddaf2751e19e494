"""The procedural nonstationary covariance in multi-resolution mode (the part
of tungsten_tpu/ops/nonstationary.py::ProceduralNonstationaryCov that the
hero scene reaches): a stationary squared-exponential `base` whose
amplitude is scaled by the field sigma(p) ("var") and whose length scale is
carried by the multi-resolution grid, driven by the field ls(p) ("ls").

In multi-resolution mode the per-point splat scale is 1: the noise at p
blends two lattice levels around ls(p) (sparse_conv.kernel_scale_level_ratio),
and each level samples the base covariance's splat at its level scale.  So
the splat radius, quadratic form, variance and transforms here are the
base's at that scale.  Brute-force mode (`multiResolutionGrid: false`,
ls(p) folded into each splat) is not ported: the parser refuses it.
"""
from __future__ import annotations

import dataclasses

from .covariance import SquaredExponentialCov
from .fields import Field


@dataclasses.dataclass(frozen=True)
class ProceduralNonstationaryCov:
    base: SquaredExponentialCov
    var_field: Field  # sigma(p)
    ls_field: Field  # ls(p): sets the multi-resolution levels
    max_ls: float = 1.0  # the largest ls (sparseConvNoiseMaxLateralScale)

    is_stationary = False

    @staticmethod
    def create(base, device, var_field=None, ls_field=None):
        """A missing field is the constant 1."""
        max_ls = ls_field.max_val() if ls_field is not None else 1.0
        return ProceduralNonstationaryCov(
            base=base, var_field=var_field or Field.constant(1.0, device),
            ls_field=ls_field or Field.constant(1.0, device),
            max_ls=float(max_ls))

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
