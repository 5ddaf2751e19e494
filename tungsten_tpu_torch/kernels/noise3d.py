"""K1 and K2: the 27-cell x K-impulse sparse-convolution noise sum.

`noise3d_sum_s` (K1: scalar kr, qm folded into m6) and `noise3d_sum` (K2:
per-point kr and qm, the multi-resolution levels of a nonstationary
covariance) wrap the CUDA kernels in csrc/noise3d.cu, the counterparts of
tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_scalar and
::_noise_kernel.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain twin (`noise3d_sum_s_ref`, `noise3d_sum_ref`), which computes the
same sum with the same operations in the same order in PyTorch.

The kernels are built at first use with nvcc into
`tungsten_tpu_torch/_build/` (one shared library with a plain C interface,
loaded with ctypes; see kernels/nvcc.py), once per content of the source,
nvcc flags and nvcc version.  `LAUNCHES` (K1) and `K2_LAUNCHES` count
kernel launches, so a run can show that its main path went through the
kernel; `K2_MOST_POINTS` records the most points one K2 launch took.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import rng
from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "noise3d.cu"

LAUNCHES = 0
K2_LAUNCHES = 0
K2_MOST_POINTS = 0
_FN = None
_FN2 = None

# (dx, dy, dz) in the kernel's loop order
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
_TWIN_CHUNK = 1 << 16


def build():
    """Compile (if this source, these flags and this nvcc have no library
    yet) and load the kernel.

    Returns nvcc's output (register and spill report), or "" when the
    library was already built."""
    global _FN, _FN2
    lib, log = compile_library(SOURCE)
    if _FN is None:
        dll = ctypes.CDLL(str(lib))
        fn = dll.noise3d_sum_s
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn2 = dll.noise3d_sum
        fn2.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                        + [ctypes.c_float] * 6
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn2.restype = ctypes.c_int
        _FN, _FN2 = fn, fn2
    return log


def _check(p, seed, name="K1", kr=None, qm=None):
    if p.dtype != torch.float32 or p.dim() != 2 or p.shape[1] != 3:
        raise ValueError(f"p must be float32 [N, 3], got {p.dtype} "
                         f"{tuple(p.shape)}")
    for what, x, dtypes in (("seed", seed, (torch.int64, torch.int32)),
                            ("kr", kr, (torch.float32,)),
                            ("qm", qm, (torch.float32,))):
        if x is None:
            continue
        if x.dtype not in dtypes or tuple(x.shape) != (p.shape[0],):
            raise ValueError(f"{what} must be {dtypes} [{p.shape[0]}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != p.device:
            raise ValueError(f"p and {what} must be on one device")
    if p.requires_grad or (kr is not None and (kr.requires_grad
                                               or qm.requires_grad)):
        raise NotImplementedError(f"{name} has no backward yet")


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


def noise3d_sum(p, seed, kr, qm, m6, impulse_count):
    """Raw lattice sum at points p [N, 3] with per-point seeds [N] (uint32
    words held in int64 or int32), cell radii kr [N] and quadratic-form
    scales qm [N] (float32).

    m6: the 6 unique entries (xx, yy, zz, xy, xz, yz) of the unit-scale
    splat quadratic form, not folded with qm.  Returns [N] float32."""
    global K2_LAUNCHES, K2_MOST_POINTS
    if p.device.type == "cpu":
        return noise3d_sum_ref(p, seed, kr, qm, m6, impulse_count)
    _check(p, seed, "K2", kr, qm)
    if p.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {p.device}")
    if not (p.is_contiguous() and kr.is_contiguous() and qm.is_contiguous()):
        raise ValueError("p, kr and qm must be contiguous")
    n = p.shape[0]
    if n >= 2 ** 31 // 3:
        raise ValueError(f"K2 takes fewer than {2 ** 31 // 3} points")
    if _FN2 is None:
        build()
    # the uint32 words as int32, wrapping (a cast, not a clamp)
    seed32 = seed.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=p.device)
    err = _FN2(p.data_ptr(), seed32.data_ptr(), kr.data_ptr(), qm.data_ptr(),
               out.data_ptr(), n, *(float(v) for v in m6),
               int(impulse_count), p.device.index,
               torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    K2_LAUNCHES += 1
    K2_MOST_POINTS = max(K2_MOST_POINTS, n)
    return out


def noise3d_sum_s_ref(p, seed, kr, m6q, impulse_count):
    """Plain PyTorch twin of K1 (and of the JAX package's `_lattice_sum`).

    Each term is computed with the kernel's operations in its order; the
    27 x K terms are vectorised and then added one by one in the kernel's
    (dx, dy, dz, k) order, so the sum rounds as the kernel's does."""
    _check(p, seed)
    kr = torch.tensor(float(kr), dtype=torch.float32, device=p.device)
    out = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    for s in range(0, p.shape[0], _TWIN_CHUNK):
        out[s:s + _TWIN_CHUNK] = _twin_chunk(
            p[s:s + _TWIN_CHUNK], rng.u32(seed[s:s + _TWIN_CHUNK]), kr, None,
            m6q, impulse_count)
    return out


def noise3d_sum_ref(p, seed, kr, qm, m6, impulse_count):
    """Plain PyTorch twin of K2: K1's twin with a per-point radius (and its
    reciprocal) and each quadratic form scaled by the point's qm."""
    _check(p, seed, "K2", kr, qm)
    out = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    for s in range(0, p.shape[0], _TWIN_CHUNK):
        c = slice(s, s + _TWIN_CHUNK)
        out[c] = _twin_chunk(p[c], rng.u32(seed[c]), kr[c], qm[c], m6,
                             impulse_count)
    return out


def _twin_chunk(p, seed, kr, qm, m6q, K):
    """The sum over one chunk; kr is a scalar tensor (K1) or [N] (K2, with
    qm [N]; None for K1)."""
    dev = p.device
    m00, m11, m22, m01, m02, m12 = (float(v) for v in m6q)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)  # [27, 3]

    if kr.dim():
        kr = kr[:, None]
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
    kr = kr[..., None]  # against [N, 27, K]
    abx, aby, abz = kr * ddx, kr * ddy, kr * ddz
    q = (m00 * abx * abx + m11 * aby * aby + m22 * abz * abz
         + 2.0 * (m01 * abx * aby + m02 * abx * abz + m12 * aby * abz))
    if qm is not None:
        q = qm[:, None, None] * q
    w = torch.where(u[..., 3] < 0.5, -1.0, 1.0)
    terms = torch.where(r2 < 1.0, w * torch.exp(-q), 0.0).reshape(len(p), -1)
    total = torch.zeros(len(p), dtype=torch.float32, device=dev)
    for j in range(terms.shape[1]):
        total = total + terms[:, j]
    return total
