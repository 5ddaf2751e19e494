"""K1: the 27-cell x K-impulse sparse-convolution noise sum (scalar kr, m6).

`noise3d_sum_s` is the wrapper of the CUDA kernel in csrc/noise3d.cu, the
counterpart of tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_scalar.
A CUDA tensor launches the kernel; a CPU tensor takes the plain twin
`noise3d_sum_s_ref`, which computes the same sum with the same operations
in the same order in PyTorch.

The kernel is built at first use with nvcc into `tungsten_tpu_torch/_build/`
(a shared library with a plain C interface, loaded with ctypes; see
kernels/nvcc.py), once per content of the source, nvcc flags and nvcc
version.  `LAUNCHES` counts kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import rng
from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "noise3d.cu"

LAUNCHES = 0
_FN = None

# (dx, dy, dz) in the kernel's loop order
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
_TWIN_CHUNK = 1 << 16


def build():
    """Compile (if this source, these flags and this nvcc have no library
    yet) and load the kernel.

    Returns nvcc's output (register and spill report), or "" when the
    library was already built."""
    global _FN
    lib, log = compile_library(SOURCE)
    if _FN is None:
        fn = ctypes.CDLL(str(lib)).noise3d_sum_s
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return log


def _check(p, seed):
    if p.dtype != torch.float32 or p.dim() != 2 or p.shape[1] != 3:
        raise ValueError(f"p must be float32 [N, 3], got {p.dtype} "
                         f"{tuple(p.shape)}")
    if seed.dtype not in (torch.int64, torch.int32) \
            or tuple(seed.shape) != (p.shape[0],):
        raise ValueError(f"seed must be int64/int32 [{p.shape[0]}], got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != p.device:
        raise ValueError("p and seed must be on one device")
    if p.requires_grad:
        raise NotImplementedError("K1 has no backward yet")


def noise3d_sum_s(p, seed, kr, m6q, impulse_count):
    """Raw lattice sum at points p [N, 3] with per-point seeds [N].

    kr: cell radius; m6q: the 6 unique entries (xx, yy, zz, xy, xz, yz) of
    the splat quadratic form with qm folded in.  Returns [N] float32."""
    global LAUNCHES
    if p.device.type == "cpu":
        return noise3d_sum_s_ref(p, seed, kr, m6q, impulse_count)
    _check(p, seed)
    if p.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {p.device}")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    n = p.shape[0]
    if n >= 2 ** 31 // 3:
        raise ValueError(f"K1 takes fewer than {2 ** 31 // 3} points")
    if _FN is None:
        build()
    seed32 = seed.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=p.device)
    m = [float(v) for v in m6q]
    err = _FN(p.data_ptr(), seed32.data_ptr(), out.data_ptr(), n, float(kr),
              *m, int(impulse_count), p.device.index,
              torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def noise3d_sum_s_ref(p, seed, kr, m6q, impulse_count):
    """Plain PyTorch twin of K1 (and of the JAX package's `_lattice_sum`).

    Each term is computed with the kernel's operations in its order; the
    27 x K terms are vectorised and then added one by one in the kernel's
    (dx, dy, dz, k) order, so the sum rounds as the kernel's does."""
    _check(p, seed)
    out = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    for s in range(0, p.shape[0], _TWIN_CHUNK):
        out[s:s + _TWIN_CHUNK] = _twin_chunk(
            p[s:s + _TWIN_CHUNK], rng.u32(seed[s:s + _TWIN_CHUNK]), kr, m6q,
            impulse_count)
    return out


def _twin_chunk(p, seed, kr, m6q, K):
    dev = p.device
    kr = torch.tensor(float(kr), dtype=torch.float32, device=dev)
    m00, m11, m22, m01, m02, m12 = (float(v) for v in m6q)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)  # [27, 3]

    g = p * (1.0 / kr)
    b = torch.floor(g)
    f = g - b
    cell = rng.u32(b.to(torch.int32)[:, None, :] + offs)  # [N, 27, 3]
    h = (rng.xxhash32_4(cell[..., 2], cell[..., 1], cell[..., 0],
                        seed[:, None]) + 1) & rng.MASK32  # [N, 27]
    ctr = (4 * torch.arange(K, device=dev)[:, None]
           + torch.arange(4, device=dev))  # [K, 4]
    u = rng.uniform(h[:, :, None, None], ctr)  # [N, 27, K, 4]
    q0 = f[:, None, :] - offs.to(torch.float32)  # [N, 27, 3]
    dd = q0[:, :, None, :] - u[..., :3]  # [N, 27, K, 3]
    ddx, ddy, ddz = dd.unbind(-1)
    r2 = ddx * ddx + ddy * ddy + ddz * ddz
    abx, aby, abz = kr * ddx, kr * ddy, kr * ddz
    q = (m00 * abx * abx + m11 * aby * aby + m22 * abz * abz
         + 2.0 * (m01 * abx * aby + m02 * abx * abz + m12 * aby * abz))
    w = torch.where(u[..., 3] < 0.5, -1.0, 1.0)
    terms = torch.where(r2 < 1.0, w * torch.exp(-q), 0.0).reshape(len(p), -1)
    total = torch.zeros(len(p), dtype=torch.float32, device=dev)
    for j in range(terms.shape[1]):
        total = total + terms[:, j]
    return total
