"""Procedural scalar fields that drive a nonstationary covariance: the
constant field and the four log-space ramps of
tungsten_tpu/ops/fields.py::Field (`bottom_top`, `left_right`, `front_back`,
`bottom_top_left_right`).

A ramp is sqrt(exp(lerp(log(min^2), log(max^2), u))) with u the clamped,
rescaled coordinate, computed in float32 with the JAX package's operations
in its order.  Not ported: the `sandstone` and `rust` fbm looks and the
`sdf` and `grid` kinds; asking for one raises NotImplementedError naming it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

RAMPS = ("bottom_top", "left_right", "front_back", "bottom_top_left_right")
# the world axis each one-axis ramp follows
_AXIS = {"bottom_top": 1, "left_right": 0, "front_back": 2}


def _unsupported(what):
    return NotImplementedError(f"{what} is not ported to tungsten_tpu_torch")


@dataclasses.dataclass(frozen=True)
class Field:
    """One scalar field; field(p [..., 3]) -> [...]."""
    value: torch.Tensor  # scalar: the constant
    mn: torch.Tensor  # scalars: the ramp's ends and its coordinate range
    mx: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    mn2: torch.Tensor  # the second (left_right) ramp of bottom_top_left_right
    mx2: torch.Tensor
    start2: torch.Tensor
    end2: torch.Tensor
    kind: str = "constant"  # "constant" or "noise"
    noise: str = "bottom_top"  # which ramp, for kind "noise"

    @staticmethod
    def constant(v, device):
        def f(x):
            return torch.tensor(np.float32(x), device=device)
        z = f(0.0)
        return Field(value=f(v), mn=z, mx=z, start=z, end=z, mn2=z, mx2=z,
                     start2=z, end2=z)

    @staticmethod
    def ramp(noise, device, mn=1.0, mx=500.0, start=0.0, end=1.0, mn2=1.0,
             mx2=500.0, start2=0.0, end2=1.0):
        if noise not in RAMPS:
            raise _unsupported(f"procedural noise field {noise!r}")

        def f(x):
            return torch.tensor(np.float32(x), device=device)
        return dataclasses.replace(
            Field.constant(0.0, device), kind="noise", noise=noise,
            mn=f(mn), mx=f(mx), start=f(start), end=f(end), mn2=f(mn2),
            mx2=f(mx2), start2=f(start2), end2=f(end2))

    @staticmethod
    def _ramp(coord, mn, mx, scale, off):
        u = torch.clamp(coord * scale + off, 0.0, 1.0)
        lo, hi = torch.log(mn * mn), torch.log(mx * mx)
        return torch.sqrt(torch.exp(lo + (hi - lo) * u))

    def __call__(self, p):
        if self.kind == "constant":
            return self.value.expand(p.shape[:-1])
        scale = 1.0 / (self.end - self.start)
        off = -self.start * scale
        if self.noise in _AXIS:
            return self._ramp(p[..., _AXIS[self.noise]], self.mn, self.mx,
                              scale, off)
        scale2 = 1.0 / (self.end2 - self.start2)
        off2 = -self.start2 * scale2
        return (self._ramp(p[..., 1], self.mn, self.mx, scale, off)
                * self._ramp(p[..., 0], self.mn2, self.mx2, scale2, off2))

    def max_val(self):
        """The field's largest value, a Python float (the bound the JAX
        package keeps as the covariance's `max_ls`)."""
        if self.kind == "constant":
            return float(self.value)
        def top(a, b):
            return np.maximum(np.float32(float(a)), np.float32(float(b)))
        v = top(self.mn, self.mx)
        if self.noise == "bottom_top_left_right":
            v = v * top(self.mn2, self.mx2)
        return float(v)


def parse_field(doc, device):
    """JSON -> Field, or None when the document has none."""
    if doc is None:
        return None
    if isinstance(doc, (int, float)):
        return Field.constant(float(doc), device)
    if not isinstance(doc, dict):
        raise _unsupported(f"procedural field {doc!r}")
    t = doc.get("type", "constant")
    if t == "constant":
        return Field.constant(doc.get("value", 1.0), device)
    if t != "noise":
        raise _unsupported(f"procedural field type {t!r}")
    return Field.ramp(
        doc.get("noise", "bottom_top"), device, mn=doc.get("min", 1.0),
        mx=doc.get("max", 500.0), start=doc.get("start", 0.0),
        end=doc.get("end", 1.0), mn2=doc.get("min2", 1.0),
        mx2=doc.get("max2", 500.0), start2=doc.get("start2", 0.0),
        end2=doc.get("end2", 1.0))
