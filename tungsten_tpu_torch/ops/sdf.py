"""The analytic SDFs of the procedural mean and the `sdf` field (knob,
knob_inner, knob_outer, two_spheres, plane): tungsten_tpu/ops/sdf.py in
PyTorch, with its constants and operation order.  Differentiable by
autograd, which is how the procedural mean takes its gradient."""
from __future__ import annotations

import math

import torch

from ..utils.vecmath import length


def _c(p, v):
    return torch.tensor(v, dtype=torch.float32, device=p.device)


def _rot_x(p, deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([x, c * y - s * z, s * y + c * z], dim=-1)


def sd_sphere(p, r):
    return length(p) - r


def sd_torus(p, t0, t1):
    qx = torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - t0
    return torch.sqrt(qx ** 2 + p[..., 1] ** 2) - t1


def sd_cone(p, c0, c1):
    q = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    return c0 * q + c1 * p[..., 2]


def _relu(x):
    """max(x, 0) whose gradient is the incoming one times the mask, as
    jax.numpy.maximum's is: a NaN from the sqrt at 0 below stays NaN
    (torch.clamp's gradient would zero it), so the gradient is NaN where
    the JAX package's is."""
    return x * (x > 0.0)


def sd_capped_cylinder(p, h, r):
    dx = torch.abs(torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2)) - h
    dy = torch.abs(p[..., 1]) - r
    return (torch.clamp(torch.maximum(dx, dy), max=0.0)
            + torch.sqrt(_relu(dx) ** 2 + _relu(dy) ** 2))


def sd_tri_prism(p, h0, h1):
    q = torch.abs(p)
    return torch.maximum(
        q[..., 2] - h1,
        torch.maximum(q[..., 0] * 0.866025 + p[..., 1] * 0.5, -p[..., 1])
        - h0 * 0.5)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def op_smooth_union(d1, d2, k):
    h = _clip01(0.5 + 0.5 * (d2 - d1) / k)
    return d2 + (d1 - d2) * h - k * h * (1.0 - h)


def op_smooth_sub(d1, d2, k):
    h = _clip01(0.5 - 0.5 * (d2 + d1) / k)
    return d2 + (-d1 - d2) * h + k * h * (1.0 - h)


def _sd_base(p):
    pi3 = math.pi / 3.0
    base = op_smooth_union(
        sd_cone(_rot_x(p + _c(p, [0.0, 0.9, 0.0]), -90), pi3, pi3),
        sd_cone(_rot_x(p - _c(p, [0.0, 0.9, 0.0]), 90), pi3, pi3),
        0.02)
    base = torch.maximum(base, sd_capped_cylinder(p, 1.1, 0.25)) * 0.7
    base = torch.maximum(-sd_capped_cylinder(p, 0.6, 0.3), base)
    base = torch.maximum(
        -sd_tri_prism(_rot_x(p + _c(p, [0.0, 0.0, -1.0]), 90), 1.2, 0.3),
        base)
    return base


def _knob_parts(p):
    sphere = sd_sphere(p, 1.0)
    cutout = sd_sphere(p - _c(p, [0.0, 0.5, 0.5]), 0.7)
    cutout_etch = sd_torus(_rot_x(p - _c(p, [0.0, 0.2, 0.2]), -45), 1.0,
                           0.05)
    inner = sd_sphere(p, 0.75)
    base = _sd_base(p - _c(p, [0.0, -0.775, 0.0]))
    return sphere, cutout, cutout_etch, inner, base


def knob(p):
    scale = 0.8
    p = p / scale
    sphere, cutout, cutout_etch, inner, base = _knob_parts(p)
    d = op_smooth_sub(cutout, sphere, 0.1)
    d = torch.minimum(d, inner)
    d = torch.maximum(-cutout_etch, d)
    d = torch.minimum(op_smooth_sub(sphere, base, 0.1), d)
    return d * scale


def knob_inner(p):
    scale = 0.8
    return sd_sphere(p / scale, 0.75) * scale


def knob_outer(p):
    scale = 0.8
    p = p / scale
    sphere, cutout, cutout_etch, inner, base = _knob_parts(p)
    d = op_smooth_sub(cutout, sphere, 0.1)
    d = torch.maximum(d, -inner)
    d = torch.maximum(-cutout_etch, d)
    d = torch.minimum(op_smooth_sub(sphere, base, 0.1), d)
    return d * scale


def two_spheres(p):
    return torch.minimum(length(p - _c(p, [0.0, 10.0, 0.0])) - 9.5,
                         length(p - _c(p, [0.0, -10.0, 0.0])) - 9.5)


def plane(p):
    return p[..., 1]


FUNCTIONS = {
    "knob": knob,
    "knob_inner": knob_inner,
    "knob_outer": knob_outer,
    "two_spheres": two_spheres,
    "plane": plane,
}
