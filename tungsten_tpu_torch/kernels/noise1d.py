"""K3: the 3-cell x K-impulse 1D sparse-convolution noise sum along the
iso-ray axis (the SE splat exp(-0.5 (kr d)^2)).

`noise1d_sum` is the wrapper of the CUDA kernel in csrc/noise1d.cu, the
counterpart of tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_1d.
A CUDA tensor launches the kernel; a CPU tensor takes the plain twin
`noise1d_sum_ref`, which computes the same sum with the same operations in
the same order in PyTorch.  The cell coordinate is pz * inv_r with inv_r
the float32 reciprocal of kr, as the TPU kernel computes it.

The kernel is built at first use with nvcc into `tungsten_tpu_torch/_build/`
(see kernels/nvcc.py).  `LAUNCHES` counts kernel launches and `MOST_POINTS`
records the most points one launch took, so a run can show that its main
path went through the kernel and within which sizes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..utils import rng
from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "noise1d.cu"

LAUNCHES = 0
MOST_POINTS = 0
_FN = None

_OFFSETS = (-1, 0, 1)  # cells in the kernel's loop order
_TWIN_CHUNK = 1 << 16


def build():
    """Compile (if this source, these flags and this nvcc have no library
    yet) and load the kernel.

    Returns nvcc's output (register and spill report), or "" when the
    library was already built."""
    global _FN
    lib, log = compile_library(SOURCE)
    if _FN is None:
        fn = ctypes.CDLL(str(lib)).noise1d_sum
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return log


def reciprocal(kr):
    """(kr, 1 / kr) as the float32 values the TPU kernel gets, held in
    Python floats (exactly)."""
    kr32 = np.float32(kr)
    return float(kr32), float(np.float32(1.0) / kr32)


def _check(pz, seed):
    if pz.dtype != torch.float32 or pz.dim() != 1:
        raise ValueError(f"pz must be float32 [N], got {pz.dtype} "
                         f"{tuple(pz.shape)}")
    if seed.dtype not in (torch.int64, torch.int32) \
            or tuple(seed.shape) != tuple(pz.shape):
        raise ValueError(f"seed must be int64/int32 [{pz.shape[0]}], got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != pz.device:
        raise ValueError("pz and seed must be on one device")
    if pz.requires_grad:
        raise NotImplementedError("K3 has no backward yet")


def noise1d_sum(pz, seed, kr, impulse_count):
    """Raw 1D lattice sum at iso-ray coordinates pz [N] with per-point
    seeds [N] (uint32 words held in int64 or int32); kr: the cell radius
    (a Python float).  Returns [N] float32."""
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


def _twin_chunk(pz, seed, kr, K):
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
    dt = kr32 * d
    terms = torch.where(d * d < 1.0, w * torch.exp(-0.5 * dt * dt),
                        0.0).reshape(len(pz), -1)
    total = torch.zeros(len(pz), dtype=torch.float32, device=dev)
    for j in range(terms.shape[1]):
        total = total + terms[:, j]
    return total
