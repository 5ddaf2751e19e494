"""K3: the 3-cell x K-impulse 1D sparse-convolution noise sum along the
iso-ray axis (the SE splat exp(-0.5 (kr d)^2)), and K3b: its backward.

`noise1d_sum` is the wrapper of the CUDA kernel in csrc/noise1d.cu, the
counterpart of tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_1d;
`noise1d_sum_bwd` (K3b) wraps the kernel that takes the place of
::_noise1d_sum_bwd (the JAX package's XLA re-trace of the sum under
jax.vjp): the partial of K3's sum in pz per point, and its partial in kr
(through kr and inv_r) summed over points in the same launch.  A CUDA tensor
launches the kernel; a CPU tensor takes the plain twin (`noise1d_sum_ref`,
`noise1d_sum_bwd_ref`), which computes the same sums with the same
operations in the same order in PyTorch.  The cell coordinate is
pz * inv_r with inv_r the float32 reciprocal of kr, as the TPU kernel
computes it.

`noise1d_sum_diff` is K3 under autograd: differentiable in pz and, when kr
is a tensor, in kr (through kr and inv_r = 1 / kr, as JAX's
`noise1d_sum`); the backward is K3b on CUDA tensors and its twin on CPU
tensors.

The kernels are built at first use with nvcc into
`tungsten_tpu_torch/_build/` (see kernels/nvcc.py).  `LAUNCHES` (K3) and
`K3B_LAUNCHES` count kernel launches and `MOST_POINTS` records the most
points one K3 launch took, so a run can show that its main path went
through the kernels and within which sizes.  K3b sums over points through
a float64 scratch and a ticket per stream (kernels/grid_sum.py).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..utils import rng
from . import grid_sum
from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "noise1d.cu"

LAUNCHES = 0
K3B_LAUNCHES = 0
MOST_POINTS = 0
_FN = None
_FN3B = None
_GRID3B = None

_OFFSETS = (-1, 0, 1)  # cells in the kernel's loop order
_TWIN_CHUNK = 1 << 16


def build():
    """Compile (if this source, these flags and this nvcc have no library
    yet) and load the kernel.

    Returns nvcc's output (register and spill report), or "" when the
    library was already built."""
    global _FN, _FN3B, _GRID3B
    lib, log = compile_library(SOURCE)
    if _FN is None:
        dll = ctypes.CDLL(str(lib))
        fn = dll.noise1d_sum
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn3b = dll.noise1d_sum_bwd
        fn3b.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                         + [ctypes.c_float] * 2
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn3b.restype = ctypes.c_int
        grid3b = dll.noise1d_sum_bwd_grid
        grid3b.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        grid3b.restype = ctypes.c_int
        _FN, _FN3B, _GRID3B = fn, fn3b, grid3b
    return log


def reciprocal(kr):
    """(kr, 1 / kr) as the float32 values the TPU kernel gets, held in
    Python floats (exactly)."""
    kr32 = np.float32(kr)
    return float(kr32), float(np.float32(1.0) / kr32)


def _check(pz, seed, g=None):
    if pz.dtype != torch.float32 or pz.dim() != 1:
        raise ValueError(f"pz must be float32 [N], got {pz.dtype} "
                         f"{tuple(pz.shape)}")
    if seed.dtype not in (torch.int64, torch.int32) \
            or tuple(seed.shape) != tuple(pz.shape):
        raise ValueError(f"seed must be int64/int32 [{pz.shape[0]}], got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != pz.device:
        raise ValueError("pz and seed must be on one device")
    if g is not None and (g.dtype != torch.float32
                          or tuple(g.shape) != tuple(pz.shape)
                          or g.device != pz.device):
        raise ValueError(f"g must be float32 [{pz.shape[0]}] on {pz.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if torch.is_grad_enabled() and pz.requires_grad:
        raise NotImplementedError(
            "K3's raw launch records no graph: noise1d_sum_diff is K3 under "
            "autograd")


def noise1d_sum(pz, seed, kr, impulse_count):
    """Raw 1D lattice sum at iso-ray coordinates pz [N] with per-point
    seeds [N] (uint32 words held in int64 or int32); kr: the cell radius
    (a Python float).  Returns [N] float32 and records no graph (see
    `noise1d_sum_diff`)."""
    global LAUNCHES, MOST_POINTS
    if pz.device.type == "cpu":
        return noise1d_sum_ref(pz, seed, kr, impulse_count)
    _check(pz, seed)
    if pz.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu tensors, not {pz.device}")
    if not pz.is_contiguous():
        raise ValueError("pz must be contiguous")
    n = pz.shape[0]
    if n >= 2 ** 30:
        raise ValueError(f"K3 takes fewer than {2 ** 30} points")
    if _FN is None:
        build()
    kr32, inv_r = reciprocal(kr)
    seed32 = seed.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=pz.device)
    err = _FN(pz.data_ptr(), seed32.data_ptr(), out.data_ptr(), n, kr32,
              inv_r, int(impulse_count), pz.device.index,
              torch.cuda.current_stream(pz.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    LAUNCHES += 1
    MOST_POINTS = max(MOST_POINTS, n)
    return out


def noise1d_sum_bwd(pz, seed, kr, impulse_count, g):
    """K3b: the partials of K3's sum at iso-ray coordinates pz [N] with
    seeds [N], each scaled by the point's cotangent g [N] (float32); kr: the
    cell radius (a Python float).  Returns (dpz [N], the partial in kr,
    through kr and inv_r = 1 / kr, summed over points: a float32 scalar):
    one launch."""
    global K3B_LAUNCHES
    if pz.device.type == "cpu":
        return noise1d_sum_bwd_ref(pz, seed, kr, impulse_count, g)
    _check(pz, seed, g)
    if pz.device.type != "cuda":
        raise ValueError(f"K3b runs on cuda or cpu tensors, not {pz.device}")
    if not (pz.is_contiguous() and g.is_contiguous()):
        raise ValueError("pz and g must be contiguous")
    n = pz.shape[0]
    if n >= 2 ** 30:
        raise ValueError(f"K3b takes fewer than {2 ** 30} points")
    if _FN3B is None:
        build()
    blocks, scratch, ticket, stream = grid_sum.buffers(
        _GRID3B, n, impulse_count, pz.device, 2, "K3b")
    kr32, inv_r = reciprocal(kr)
    seed32 = seed.to(torch.int32).contiguous()
    dpz = torch.empty(n, dtype=torch.float32, device=pz.device)
    dkr = torch.empty((), dtype=torch.float32, device=pz.device)
    err = _FN3B(pz.data_ptr(), seed32.data_ptr(), g.data_ptr(),
                dpz.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                dkr.data_ptr(), n, blocks, kr32, inv_r, int(impulse_count),
                pz.device.index, stream)
    if err != 0:
        raise RuntimeError(f"K3b launch failed: CUDA error {err}")
    K3B_LAUNCHES += 1
    return dpz, dkr


class _LatticeSum1D(torch.autograd.Function):
    """K3 forward, K3b (or its twin on CPU tensors) backward."""

    @staticmethod
    def forward(ctx, pz, kr_t, seed, kr, impulse_count):
        # the uint32 words as int32 once, so that the backward is one launch
        seed = seed.to(torch.int32)
        ctx.save_for_backward(pz, seed)
        ctx.kr, ctx.impulse_count = kr, impulse_count
        return noise1d_sum(pz, seed, kr, impulse_count)

    @staticmethod
    def backward(ctx, g):
        pz, seed = ctx.saved_tensors
        dpz, dkr = noise1d_sum_bwd(pz, seed, ctx.kr, ctx.impulse_count,
                                   g.contiguous())
        return dpz, dkr if ctx.needs_input_grad[1] else None, None, None, None


def noise1d_sum_diff(pz, seed, kr, impulse_count):
    """K3's sum at iso-ray coordinates pz [N] with seeds [N], differentiable
    in pz and in the cell radius kr: a Python float, or a scalar tensor
    (read on the host once per call) that may require grad.  When nothing
    requires grad (or grad mode is off) this is K3's raw launch and records
    no graph."""
    kr_t = kr if isinstance(kr, torch.Tensor) else None
    kr_f = float(kr.detach()) if kr_t is not None else float(kr)
    if torch.is_grad_enabled() and (
            pz.requires_grad or (kr_t is not None and kr_t.requires_grad)):
        return _LatticeSum1D.apply(pz, kr_t, seed, kr_f, impulse_count)
    return noise1d_sum(pz, seed, kr_f, impulse_count)


def noise1d_sum_ref(pz, seed, kr, impulse_count):
    """Plain PyTorch twin of K3 (and of the JAX package's
    `_lattice_sum_1d`).

    Each term is computed with the kernel's operations in its order; the
    3 x K terms are vectorised and then added one by one in the kernel's
    (cell, k) order, so the sum rounds as the kernel's does."""
    _check(pz, seed)
    out = torch.empty(pz.shape[0], dtype=torch.float32, device=pz.device)
    for s in range(0, pz.shape[0], _TWIN_CHUNK):
        out[s:s + _TWIN_CHUNK] = _twin_chunk(
            pz[s:s + _TWIN_CHUNK], rng.u32(seed[s:s + _TWIN_CHUNK]), kr,
            impulse_count)
    return out


def noise1d_sum_bwd_ref(pz, seed, kr, impulse_count, g,
                        sum_dtype=torch.float64):
    """Plain PyTorch twin of K3b: the same partials in closed form (not
    autograd through the forward twin), chunked, each in-reach term and
    each of the two sums per point computed with the kernel's operations in
    its order; the per-point partials in kr and inv_r summed over points in
    sum_dtype (float64 as in the kernel, in another order; float32 only as
    a control of the sum's precision), and inv_r = 1 / kr adds its sum
    times -1 / kr^2 to the partial in kr."""
    _check(pz, seed, g)
    n = pz.shape[0]
    dpz = torch.empty(n, dtype=torch.float32, device=pz.device)
    part = torch.empty(n, 2, dtype=torch.float32, device=pz.device)
    for s in range(0, n, _TWIN_CHUNK):
        c = slice(s, s + _TWIN_CHUNK)
        dpz[c], part[c] = _twin_bwd_chunk(pz[c], rng.u32(seed[c]), kr,
                                          impulse_count, g[c])
    d = part.sum(dim=0, dtype=sum_dtype)
    inv_r = reciprocal(kr)[1]
    return dpz, (d[0] - d[1] * (inv_r * inv_r)).to(torch.float32)


def _twin_offsets(pz, seed, kr, K):
    """The 3 x K impulses of one chunk: (kr and inv_r as float32 scalar
    tensors, d = the point's offset from each impulse in cell units
    [N, 3 K] in the kernel's (cell, k) order, their +-1 weights [N, 3 K])."""
    dev = pz.device
    kr32, inv_r = (torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in reciprocal(kr))
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)  # [3]

    tg = pz * inv_r
    b = torch.floor(tg)
    fr = tg - b
    cell = rng.u32(b.to(torch.int32)[:, None] + offs)  # [N, 3]
    h = (rng.xxhash32_2(cell, seed[:, None]) + 1) & rng.MASK32  # [N, 3]
    ctr = 2 * torch.arange(K, device=dev)  # [K]
    ti = rng.uniform(h[:, :, None], ctr)  # [N, 3, K]
    w = torch.where(rng.uniform(h[:, :, None], ctr + 1) < 0.5, -1.0, 1.0)
    d = (fr[:, None] - offs.to(torch.float32))[:, :, None] - ti
    return kr32, inv_r, d.reshape(len(pz), -1), w.reshape(len(pz), -1)


def _twin_chunk(pz, seed, kr, K):
    kr32, _, d, w = _twin_offsets(pz, seed, kr, K)
    dt = kr32 * d
    terms = torch.where(d * d < 1.0, w * torch.exp(-0.5 * dt * dt), 0.0)
    total = torch.zeros(len(pz), dtype=torch.float32, device=pz.device)
    for j in range(terms.shape[1]):
        total = total + terms[:, j]
    return total


def _twin_bwd_chunk(pz, seed, kr, K, ct):
    """K3b over one chunk: (dpz [N], partials [N, 2]); ct: the cotangents
    [N]."""
    kr32, inv_r, d, w = _twin_offsets(pz, seed, kr, K)
    dt = kr32 * d
    c = torch.where(d * d < 1.0, w * torch.exp(-0.5 * dt * dt) * -dt, 0.0)
    # [2, N, 3 K]: the terms of S and T, summed one by one in the kernel's
    # (cell, k) order
    terms = torch.stack([c, c * d])
    acc = torch.zeros(2, len(pz), dtype=torch.float32, device=pz.device)
    for j in range(terms.shape[2]):
        acc = acc + terms[:, :, j]
    s, t = acc
    dpz = ct * s * kr32 * inv_r
    part = torch.stack([ct * t, ct * s * kr32 * pz], dim=-1)
    return dpz, part
