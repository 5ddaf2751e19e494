"""Procedural fields: the scalar fields that drive a nonstationary
covariance and the vector (RGB) fields of a GP's scatter color and volume
emission (tungsten_tpu/ops/fields.py::Field).

Kinds: `constant`; `noise`, the four log-space ramps (`bottom_top`,
`left_right`, `front_back`, `bottom_top_left_right`: sqrt(exp(lerp(
log(min^2), log(max^2), u))) with u the clamped, rescaled coordinate) and
the fbm looks `sandstone` and `rust` over the hash-lattice value noise;
`sdf`, an analytic SDF of ops/sdf.py times scale plus offset; `grid`, a
dense grid [nx, ny, nz] (or [nx, ny, nz, 3]) with trilinear lookup.  All in
float32 with the JAX package's operations in its order; a vector field of
a scalar kind repeats its value over the three channels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import rng
from ..utils.vecmath import dot
from . import sdf as sdflib
from .means import trilinear

RAMPS = ("bottom_top", "left_right", "front_back", "bottom_top_left_right")
NOISES = RAMPS + ("sandstone", "rust")
# the world axis each one-axis ramp follows
_AXIS = {"bottom_top": 1, "left_right": 0, "front_back": 2}


def _unsupported(what):
    return NotImplementedError(f"{what} is not ported to tungsten_tpu_torch")


def _hash_grad(ix, iy, iz):
    """A lattice vector in [-0.5, 0.5]^3 keyed by its cell (float
    coordinates holding integers)."""
    h = rng.xxhash32_3(rng.u32(ix.to(torch.int32)), rng.u32(iy.to(torch.int32)),
                       rng.u32(iz.to(torch.int32)))
    return torch.stack([rng.uniform(h, 0) - 0.5, rng.uniform(h, 1) - 0.5,
                        rng.uniform(h, 2) - 0.5], dim=-1)


def value_noise(p):
    """Gradient lattice noise in roughly [-1, 1]."""
    base = torch.floor(p)
    f = p - base
    w = f * f * (3.0 - 2.0 * f)
    acc = 0.0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                g = _hash_grad(base[..., 0] + cx, base[..., 1] + cy,
                               base[..., 2] + cz)
                d = f - torch.tensor([cx, cy, cz], dtype=torch.float32,
                                     device=p.device)
                wx = w[..., 0] if cx else 1 - w[..., 0]
                wy = w[..., 1] if cy else 1 - w[..., 1]
                wz = w[..., 2] if cz else 1 - w[..., 2]
                acc = acc + wx * wy * wz * dot(g, d)
    return acc * 4.0


def fbm(p, octaves=2):
    """Gain 0.65, lacunarity 2.1042, over p * 5."""
    gain, lac = 0.65, 2.1042
    p = p * 5.0
    total = value_noise(p)
    freq, amp = 0.5, gain
    for _ in range(octaves):
        total = total + value_noise(p * freq) * amp
        freq = freq * lac
        amp = amp * gain
    return (total + 2.0) / 4.0


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@dataclasses.dataclass(frozen=True)
class Field:
    """One field; field(p [..., 3]) -> [...] (or [..., 3] if is_vector)."""
    value: torch.Tensor  # the constant: a scalar, or [3] for a vector
    mn: torch.Tensor  # scalars: the ramp's ends and its coordinate range
    mx: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    mn2: torch.Tensor  # the second (left_right) ramp of bottom_top_left_right
    mx2: torch.Tensor
    start2: torch.Tensor
    end2: torch.Tensor
    grid: torch.Tensor | None = None  # kind "grid": the values
    bounds_min: torch.Tensor | None = None
    bounds_max: torch.Tensor | None = None
    offset: torch.Tensor | None = None  # kind "sdf"
    scale: torch.Tensor | None = None
    kind: str = "constant"  # "constant", "noise", "sdf" or "grid"
    noise: str = "bottom_top"  # which noise, for kind "noise"
    sdf_fn: str = "knob"
    is_vector: bool = False

    @staticmethod
    def constant(v, device, is_vector=False):
        def f(x):
            return torch.tensor(np.float32(x), device=device)
        z = f(0.0)
        return Field(value=torch.tensor(np.asarray(v, np.float32),
                                        device=device),
                     mn=z, mx=z, start=z, end=z, mn2=z, mx2=z, start2=z,
                     end2=z, is_vector=is_vector)

    @staticmethod
    def ramp(noise, device, mn=1.0, mx=500.0, start=0.0, end=1.0, mn2=1.0,
             mx2=500.0, start2=0.0, end2=1.0, is_vector=False):
        if noise not in NOISES:
            # the JAX package raises ValueError(noise) when it evaluates it
            raise ValueError(f"procedural noise field {noise!r}")

        def f(x):
            return torch.tensor(np.float32(x), device=device)
        return dataclasses.replace(
            Field.constant(0.0, device, is_vector), kind="noise",
            noise=noise, mn=f(mn), mx=f(mx), start=f(start), end=f(end),
            mn2=f(mn2), mx2=f(mx2), start2=f(start2), end2=f(end2))

    @staticmethod
    def sdf(device, fn="knob", offset=0.0, scale=1.0):
        if fn not in sdflib.FUNCTIONS:
            raise KeyError(fn)
        return dataclasses.replace(
            Field.constant(0.0, device), kind="sdf", sdf_fn=fn,
            offset=torch.tensor(np.float32(offset), device=device),
            scale=torch.tensor(np.float32(scale), device=device))

    @staticmethod
    def regular_grid(values, bounds_min, bounds_max, device,
                     is_vector=False):
        def f(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)
        return dataclasses.replace(
            Field.constant(0.0, device, is_vector), kind="grid",
            grid=f(values), bounds_min=f(bounds_min),
            bounds_max=f(bounds_max))

    @staticmethod
    def _ramp(coord, mn, mx, scale, off):
        u = torch.clamp(coord * scale + off, 0.0, 1.0)
        lo, hi = torch.log(mn * mn), torch.log(mx * mx)
        return torch.sqrt(torch.exp(lo + (hi - lo) * u))

    def _noise(self, p):
        scale = 1.0 / (self.end - self.start)
        off = -self.start * scale
        if self.noise in _AXIS:
            return self._ramp(p[..., _AXIS[self.noise]], self.mn, self.mx,
                              scale, off)
        if self.noise == "bottom_top_left_right":
            scale2 = 1.0 / (self.end2 - self.start2)
            off2 = -self.start2 * scale2
            return (self._ramp(p[..., 1], self.mn, self.mx, scale, off)
                    * self._ramp(p[..., 0], self.mn2, self.mx2, scale2,
                                 off2))
        if self.noise == "sandstone":
            ps = p * 0.3
            f = fbm(ps + fbm(ps + fbm(ps)[..., None])[..., None])
            c = torch.sqrt(torch.clamp(f * 1.9 * 1.2, min=0.0)) - 0.35
            return self.mn + (self.mx - self.mn) * torch.clamp(c, 0.0, 1.0)
        ps = p * 2.0  # rust
        f = _smoothstep(0.4, 0.6, fbm(ps + fbm(ps * 0.1)[..., None] * 0.4)
                        - fbm(ps * 25.0) * 0.1)
        return self.mn + (self.mx - self.mn) * torch.clamp(f, 0.0, 1.0)

    def __call__(self, p):
        if self.kind == "constant":
            if self.is_vector:
                return self.value.expand(p.shape)
            return self.value.expand(p.shape[:-1])
        if self.kind == "sdf":
            return (sdflib.FUNCTIONS[self.sdf_fn](p) * self.scale
                    + self.offset)
        if self.kind == "grid":
            return trilinear(self.grid, self.bounds_min, self.bounds_max, p,
                             vector=self.is_vector and self.grid.dim() == 4)
        v = self._noise(p)
        if self.is_vector:
            return v[..., None].repeat_interleave(3, dim=-1)
        return v

    def max_val(self):
        """The bound the JAX package keeps as a covariance's `max_ls`: the
        largest value of a constant, ramp or grid, 1 for the other kinds (a
        Python float)."""
        if self.kind == "constant":
            return float(np.max(self.value.detach().cpu().numpy()))
        if self.kind == "grid":
            return float(np.max(self.grid.detach().cpu().numpy()))
        if self.kind != "noise" or self.noise not in RAMPS:
            return 1.0

        def top(a, b):
            return np.maximum(np.float32(float(a)), np.float32(float(b)))
        v = top(self.mn, self.mx)
        if self.noise == "bottom_top_left_right":
            v = v * top(self.mn2, self.mx2)
        return float(v)


def parse_field(doc, device, is_vector=False):
    """JSON -> Field, or None when the document has none."""
    if doc is None:
        return None
    if isinstance(doc, (int, float, list)):
        return Field.constant(doc, device, is_vector)
    t = doc.get("type", "constant")
    if t == "constant":
        return Field.constant(doc.get("value", 1.0), device, is_vector)
    if t == "noise":
        return Field.ramp(
            doc.get("noise", "bottom_top"), device, mn=doc.get("min", 1.0),
            mx=doc.get("max", 500.0), start=doc.get("start", 0.0),
            end=doc.get("end", 1.0), mn2=doc.get("min2", 1.0),
            mx2=doc.get("max2", 500.0), start2=doc.get("start2", 0.0),
            end2=doc.get("end2", 1.0), is_vector=is_vector)
    if t == "sdf":
        return Field.sdf(device, fn=doc.get("func", "knob"),
                         offset=doc.get("offset", 0.0),
                         scale=doc.get("scale", 1.0))
    raise _unsupported(f"procedural field type {t!r}")
