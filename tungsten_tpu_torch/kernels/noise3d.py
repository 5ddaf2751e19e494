"""K1 and K2: the 27-cell x K-impulse sparse-convolution noise sum, and
K1b and K2b: their backwards.

`noise3d_sum_s` (K1: scalar kr, qm folded into m6) and `noise3d_sum` (K2:
per-point kr and qm, the multi-resolution levels of a nonstationary
covariance) wrap the CUDA kernels in csrc/noise3d.cu, the counterparts of
tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_scalar and
::_noise_kernel.  `noise3d_sum_s_bwd` (K1b) wraps the kernel that takes the
place of ::_noise3d_sum_s_bwd (the JAX package's XLA re-trace of the sum
under jax.vjp): the partials of K1's sum in p, and in kr and the splat
form summed over points in the same launch.  `noise3d_sum_bwd` (K2b) does
the same for K2, in place of ::_noise3d_sum_bwd: the partials in p, the
per-point kr and qm and the splat form.  Each backward takes the form as
its diagonal (m00, m11, m22: the off-diagonal entries are 0) or as all six
unique entries (m00, m11, m22, m01, m02, m12: an anisoMtx in world space),
and launches the kernel's diagonal or full instance for it.  A CUDA tensor
launches the kernel; a CPU tensor
takes the plain twin (`noise3d_sum_s_ref`, `noise3d_sum_ref`,
`noise3d_sum_s_bwd_ref`, `noise3d_sum_bwd_ref`), which computes the same
sums with the same operations in the same order in PyTorch.

`noise3d_sum_s_diff` is K1 under autograd: kr and the splat form (its
diagonal [3] or its unique entries [6], `form6`) are tensors (read on the
host once per batch, `host_params`), and the backward is K1b on CUDA
tensors and its twin on CPU tensors.
`noise3d_sum_diff` is K2 under autograd in the same way, with the
per-point kr and qm differentiable and backward K2b.  The raw launches
record no graph and refuse inputs that require grad.

The kernels are built at first use with nvcc into
`tungsten_tpu_torch/_build/` (one shared library with a plain C interface,
loaded with ctypes; see kernels/nvcc.py), once per content of the source,
nvcc flags and nvcc version.  `LAUNCHES` (K1), `K1B_LAUNCHES`,
`K2_LAUNCHES` and `K2B_LAUNCHES` count kernel launches (the backwards'
diagonal instances; `K1B_FULL_LAUNCHES` and `K2B_FULL_LAUNCHES` their full
instances), so a run can show that its main path went through the
kernel; `K2_MOST_POINTS` and `K2B_MOST_POINTS` record the most points one
K2 or K2b launch took.  K1b
sums over points through a float64 scratch and a ticket per stream
(kernels/grid_sum.py).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import rng
from . import grid_sum
from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "noise3d.cu"

LAUNCHES = 0
K1B_LAUNCHES = 0
K2_LAUNCHES = 0
K2_MOST_POINTS = 0
K2B_LAUNCHES = 0
K2B_MOST_POINTS = 0
K1B_FULL_LAUNCHES = 0
K2B_FULL_LAUNCHES = 0
_FN = None
_FN1B = None
_GRID1B = None
_FN2 = None
_FN2B = None

# (dx, dy, dz) in the kernel's loop order
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
_TWIN_CHUNK = 1 << 16


def build():
    """Compile (if this source, these flags and this nvcc have no library
    yet) and load the kernel.

    Returns nvcc's output (register and spill report), or "" when the
    library was already built."""
    global _FN, _FN1B, _GRID1B, _FN2, _FN2B
    lib, log = compile_library(SOURCE)
    if _FN is None:
        dll = ctypes.CDLL(str(lib))
        fn = dll.noise3d_sum_s
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn1b = dll.noise3d_sum_s_bwd
        fn1b.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                         + [ctypes.c_float] * 7 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
        fn1b.restype = ctypes.c_int
        grid1b = dll.noise3d_sum_s_bwd_grid
        grid1b.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        grid1b.restype = ctypes.c_int
        fn2 = dll.noise3d_sum
        fn2.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                        + [ctypes.c_float] * 6
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn2.restype = ctypes.c_int
        fn2b = dll.noise3d_sum_bwd
        fn2b.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                         + [ctypes.c_float] * 6 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
        fn2b.restype = ctypes.c_int
        _FN, _FN1B, _GRID1B, _FN2, _FN2B = fn, fn1b, grid1b, fn2, fn2b
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
    if torch.is_grad_enabled() and (
            p.requires_grad or (kr is not None and (kr.requires_grad
                                                    or qm.requires_grad))):
        under = {"K1": "noise3d_sum_s_diff", "K2": "noise3d_sum_diff"}
        raise NotImplementedError(
            f"{name}'s raw launch records no graph"
            + (f": {under[name]} is {name} under autograd" if name in under
               else ""))


def noise3d_sum_s(p, seed, kr, m6q, impulse_count):
    """Raw lattice sum at points p [N, 3] with per-point seeds [N].

    kr: cell radius; m6q: the 6 unique entries (xx, yy, zz, xy, xz, yz) of
    the splat quadratic form with qm folded in; Python floats.  Returns [N]
    float32 and records no graph (see `noise3d_sum_s_diff`)."""
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


def _form(m):
    """(the splat form's six unique entries as floats, whether it is full)
    from its diagonal (m00, m11, m22) or its six entries (m00, m11, m22,
    m01, m02, m12)."""
    m = tuple(float(v) for v in m)
    if len(m) not in (3, 6):
        raise ValueError(f"the splat form takes 3 or 6 entries, got {len(m)}")
    return (m + (0.0, 0.0, 0.0))[:6], len(m) == 6


def form6(m):
    """The six unique entries (m00, m11, m22, m01, m02, m12) [6] of a
    symmetric [3, 3] splat form, differentiable (the upper triangle)."""
    return torch.stack([m[0, 0], m[1, 1], m[2, 2], m[0, 1], m[0, 2],
                        m[1, 2]])


def noise3d_sum_s_bwd(p, seed, kr, m, impulse_count, g):
    """K1b: the partials of K1's sum at points p [N, 3] with seeds [N], each
    scaled by the point's cotangent g [N] (float32).

    kr and m, the qm-folded splat form as its diagonal (m00, m11, m22) or
    its six unique entries (m00, m11, m22, m01, m02, m12), are Python
    floats.  Returns (dp [N, 3], the partials in (kr, *m) summed over
    points [4] or [7]): one launch of the diagonal or the full instance."""
    global K1B_LAUNCHES, K1B_FULL_LAUNCHES
    if p.device.type == "cpu":
        return noise3d_sum_s_bwd_ref(p, seed, kr, m, impulse_count, g)
    _check(p, seed)
    if p.device.type != "cuda":
        raise ValueError(f"K1b runs on cuda or cpu tensors, not {p.device}")
    n = p.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n,) or \
            g.device != p.device:
        raise ValueError(f"g must be float32 [{n}] on {p.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError("p and g must be contiguous")
    if n >= 2 ** 31 // 3:
        raise ValueError(f"K1b takes fewer than {2 ** 31 // 3} points")
    m6, full = _form(m)
    if _FN1B is None:
        build()
    parts = 7 if full else 4
    blocks, scratch, ticket, stream = grid_sum.buffers(
        lambda *a: _GRID1B(a[0], a[1], int(full), *a[2:]), n, impulse_count,
        p.device, parts, "K1b")
    seed32 = seed.to(torch.int32).contiguous()
    dp = torch.empty(n, 3, dtype=torch.float32, device=p.device)
    sums = torch.empty(parts, dtype=torch.float32, device=p.device)
    err = _FN1B(p.data_ptr(), seed32.data_ptr(), g.data_ptr(), dp.data_ptr(),
                scratch.data_ptr(), ticket.data_ptr(), sums.data_ptr(), n,
                blocks, float(kr), *m6, int(full), int(impulse_count),
                p.device.index, stream)
    if err != 0:
        raise RuntimeError(f"K1b launch failed: CUDA error {err}")
    if full:
        K1B_FULL_LAUNCHES += 1
    else:
        K1B_LAUNCHES += 1
    return dp, sums


def host_params(kr, m):
    """(kr, *m) as Python floats, K1's by-value arguments, from the cell
    radius kr (a scalar tensor) and the splat form's diagonal [3] or unique
    entries [6] m: one host read, made once per ray batch."""
    return tuple(torch.cat([kr.detach().reshape(1), m.detach()]).tolist())


class _LatticeSumS(torch.autograd.Function):
    """K1 forward, K1b (or its twin on CPU tensors) backward."""

    @staticmethod
    def forward(ctx, p, kr, m3, seed, host, impulse_count):
        # the uint32 words as int32 once, so that the backward is one launch
        seed = seed.to(torch.int32)
        ctx.save_for_backward(p, seed)
        ctx.host, ctx.impulse_count = host, impulse_count
        return noise3d_sum_s(p, seed, host[0], _form(host[1:])[0],
                             impulse_count)

    @staticmethod
    def backward(ctx, g):
        p, seed = ctx.saved_tensors
        dp, d = noise3d_sum_s_bwd(p, seed, ctx.host[0], ctx.host[1:],
                                  ctx.impulse_count, g.contiguous())
        return dp, d[0], d[1:], None, None, None


def noise3d_sum_s_diff(p, seed, kr, m, impulse_count, host):
    """K1's sum at points p [N, 3] with seeds [N], differentiable in p, the
    cell radius kr (scalar tensor) and the qm-folded splat form m: its
    diagonal [3] (the off-diagonal entries are 0) or its six unique
    entries [6] (`form6`).

    host: `host_params(kr, m)`, read once per batch.  When nothing requires
    grad (or grad mode is off) this is K1's raw launch and records no
    graph."""
    if torch.is_grad_enabled() and (p.requires_grad or kr.requires_grad
                                    or m.requires_grad):
        return _LatticeSumS.apply(p, kr, m, seed, host, impulse_count)
    return noise3d_sum_s(p, seed, host[0], _form(host[1:])[0], impulse_count)


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


def noise3d_sum_bwd(p, seed, kr, qm, m, impulse_count, g):
    """K2b: the partials of K2's sum at points p [N, 3] with seeds [N], cell
    radii kr [N] and quadratic-form scales qm [N], each scaled by the
    point's cotangent g [N] (float32).

    m, the unit-scale splat form as its diagonal (m00, m11, m22) or its six
    unique entries, are Python floats.  Returns (dp [N, 3], the per-point
    partials [N, 5] in (kr, qm, m00, m11, m22), or [N, 8] in (kr, qm, m00,
    m11, m22, m01, m02, m12) for the full form); the partials in m are
    their sums over points."""
    global K2B_LAUNCHES, K2B_MOST_POINTS, K2B_FULL_LAUNCHES
    if p.device.type == "cpu":
        return noise3d_sum_bwd_ref(p, seed, kr, qm, m, impulse_count, g)
    _check(p, seed, "K2b", kr, qm)
    if p.device.type != "cuda":
        raise ValueError(f"K2b runs on cuda or cpu tensors, not {p.device}")
    n = p.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n,) or \
            g.device != p.device:
        raise ValueError(f"g must be float32 [{n}] on {p.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if not all(x.is_contiguous() for x in (p, kr, qm, g)):
        raise ValueError("p, kr, qm and g must be contiguous")
    m6, full = _form(m)
    parts = 8 if full else 5
    if n >= 2 ** 31 // parts:
        raise ValueError(f"K2b takes fewer than {2 ** 31 // parts} points")
    if _FN2B is None:
        build()
    seed32 = seed.to(torch.int32).contiguous()
    dp = torch.empty(n, 3, dtype=torch.float32, device=p.device)
    part = torch.empty(n, parts, dtype=torch.float32, device=p.device)
    err = _FN2B(p.data_ptr(), seed32.data_ptr(), kr.data_ptr(),
                qm.data_ptr(), g.data_ptr(), dp.data_ptr(), part.data_ptr(),
                n, *m6, int(full), int(impulse_count), p.device.index,
                torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2b launch failed: CUDA error {err}")
    if full:
        K2B_FULL_LAUNCHES += 1
    else:
        K2B_LAUNCHES += 1
    K2B_MOST_POINTS = max(K2B_MOST_POINTS, n)
    return dp, part


class _LatticeSum(torch.autograd.Function):
    """K2 forward, K2b (or its twin on CPU tensors) backward."""

    @staticmethod
    def forward(ctx, p, kr, qm, m, seed, host, impulse_count):
        ctx.save_for_backward(p, kr, qm, seed)
        ctx.host, ctx.impulse_count = host, impulse_count
        return noise3d_sum(p, seed, kr, qm, _form(host)[0], impulse_count)

    @staticmethod
    def backward(ctx, g):
        p, kr, qm, seed = ctx.saved_tensors
        dp, part = noise3d_sum_bwd(p, seed, kr, qm, ctx.host,
                                   ctx.impulse_count, g.contiguous())
        # the m partials' sum over points, in float64 so its order hardly
        # matters; kr and qm keep theirs per point
        dm = part[:, 2:].sum(dim=0, dtype=torch.float64).to(torch.float32)
        return dp, part[:, 0], part[:, 1], dm, None, None, None


def noise3d_sum_diff(p, seed, kr, qm, m, impulse_count, host):
    """K2's sum at points p [N, 3] with seeds [N], differentiable in p, the
    cell radii kr [N], the quadratic-form scales qm [N] and the unit-scale
    splat form m: its diagonal [3] (the off-diagonal entries are 0) or its
    six unique entries [6] (`form6`).

    host: m's values as Python floats, read once per batch.  When nothing
    requires grad (or grad mode is off) this is K2's raw launch and records
    no graph."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (p, kr, qm, m)):
        return _LatticeSum.apply(p, kr, qm, m, seed, host, impulse_count)
    return noise3d_sum(p, seed, kr, qm, _form(host)[0], impulse_count)


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


def noise3d_sum_s_bwd_ref(p, seed, kr, m, impulse_count, g,
                          sum_dtype=torch.float64):
    """Plain PyTorch twin of K1b: the same partials in closed form (not
    autograd through the forward twin), chunked, each in-reach term and
    each of the nine sums per point (twelve for the full form) computed
    with the kernel's operations in its order; the per-point partials in
    (kr, *m) summed over points in sum_dtype (float64 as in the kernel, in
    another order; float32 only as a control of the sums' precision),
    returned as float32 [4] (the diagonal m) or [7] (the full m)."""
    _check(p, seed)
    n = p.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n,):
        raise ValueError(f"g must be float32 [{n}], got {g.dtype} "
                         f"{tuple(g.shape)}")
    krt = torch.tensor(float(kr), dtype=torch.float32, device=p.device)
    m6, full = _form(m)
    dp = torch.empty(n, 3, dtype=torch.float32, device=p.device)
    part = torch.empty(n, 7 if full else 4, dtype=torch.float32,
                       device=p.device)
    for s in range(0, n, _TWIN_CHUNK):
        c = slice(s, s + _TWIN_CHUNK)
        dp[c], part[c] = _twin_bwd_chunk(p[c], rng.u32(seed[c]), krt, None,
                                         m6, full, impulse_count, g[c])
    return dp, part.sum(dim=0, dtype=sum_dtype).to(torch.float32)


def noise3d_sum_bwd_ref(p, seed, kr, qm, m, impulse_count, g):
    """Plain PyTorch twin of K2b: K1b's twin with a per-point radius (and
    its reciprocal) and quadratic-form scale, whose partials stay per
    point ([N, 5], or [N, 8] for the full form)."""
    _check(p, seed, "K2b", kr, qm)
    n = p.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n,):
        raise ValueError(f"g must be float32 [{n}], got {g.dtype} "
                         f"{tuple(g.shape)}")
    m6, full = _form(m)
    dp = torch.empty(n, 3, dtype=torch.float32, device=p.device)
    part = torch.empty(n, 8 if full else 5, dtype=torch.float32,
                       device=p.device)
    for s in range(0, n, _TWIN_CHUNK):
        c = slice(s, s + _TWIN_CHUNK)
        dp[c], part[c] = _twin_bwd_chunk(p[c], rng.u32(seed[c]), kr[c],
                                         qm[c], m6, full, impulse_count,
                                         g[c])
    return dp, part


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


def _twin_offsets(p, seed, kr, K):
    """The 27 x K impulse offsets of one chunk: (g = p / kr [N, 3], dd =
    the point's offset from each impulse in cell units [N, 27, K, 3], the
    impulses' fourth variates [N, 27, K]); kr is a scalar tensor or [N, 1].
    """
    dev = p.device
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
    return g, dd, u[..., 3]


def _twin_chunk(p, seed, kr, qm, m6q, K):
    """The sum over one chunk; kr is a scalar tensor (K1) or [N] (K2, with
    qm [N]; None for K1)."""
    m00, m11, m22, m01, m02, m12 = (float(v) for v in m6q)
    if kr.dim():
        kr = kr[:, None]
    _, dd, uw = _twin_offsets(p, seed, kr, K)
    ddx, ddy, ddz = dd.unbind(-1)
    r2 = ddx * ddx + ddy * ddy + ddz * ddz
    kr = kr[..., None]  # against [N, 27, K]
    abx, aby, abz = kr * ddx, kr * ddy, kr * ddz
    q = (m00 * abx * abx + m11 * aby * aby + m22 * abz * abz
         + 2.0 * (m01 * abx * aby + m02 * abx * abz + m12 * aby * abz))
    if qm is not None:
        q = qm[:, None, None] * q
    w = torch.where(uw < 0.5, -1.0, 1.0)
    terms = torch.where(r2 < 1.0, w * torch.exp(-q), 0.0).reshape(len(p), -1)
    total = torch.zeros(len(p), dtype=torch.float32, device=p.device)
    for j in range(terms.shape[1]):
        total = total + terms[:, j]
    return total


def _twin_bwd_chunk(p, seed, kr, qm, m6, full, K, ct):
    """K1b over one chunk, (dp [N, 3], partials [N, 4] or, full, [N, 7]),
    with kr a scalar tensor and qm None; K2b, (dp, partials [N, 5] or [N,
    8]), with kr and qm [N].  m6 is six floats (the off-diagonal three 0
    and unread unless `full`), ct the cotangents [N]."""
    krc = kr[:, None] if kr.dim() else kr
    g, dd, uw = _twin_offsets(p, seed, krc, K)
    ddx, ddy, ddz = dd.unbind(-1)
    r2 = ddx * ddx + ddy * ddy + ddz * ddz
    krc = krc[..., None]  # against [N, 27, K]
    abx, aby, abz = krc * ddx, krc * ddy, krc * ddz
    m00, m11, m22, m01, m02, m12 = m6
    q = m00 * abx * abx + m11 * aby * aby + m22 * abz * abz
    if full:
        q = q + 2.0 * (m01 * abx * aby + m02 * abx * abz + m12 * aby * abz)
    if qm is not None:
        q = qm[:, None, None] * q
    w = torch.where(uw < 0.5, -1.0, 1.0)
    e = torch.where(r2 < 1.0, w * torch.exp(-q), 0.0)
    ex, ey, ez = e * abx, e * aby, e * abz
    # [9 or 12, N, 27 K]: the terms of S, T and Q per axis (and of the cross
    # sums P), summed one by one in the kernel's (dx, dy, dz, k) order
    terms = [ex, ey, ez, ex * ddx, ey * ddy, ez * ddz, ex * abx, ey * aby,
             ez * abz]
    if full:
        terms += [ex * aby, ex * abz, ey * abz]
    terms = torch.stack(terms).reshape(len(terms), len(p), -1)
    acc = torch.zeros(terms.shape[:2], dtype=torch.float32, device=p.device)
    for j in range(terms.shape[2]):
        acc = acc + terms[:, :, j]
    sx, sy, sz, tx, ty, tz, qx, qy, qz = acc[:9]
    inv_r = 1.0 / kr
    gx, gy, gz = g.unbind(-1)
    if qm is None:
        c2x, c2y, c2z = -2.0 * m00, -2.0 * m11, -2.0 * m22
    else:
        c2x, c2y, c2z = (-2.0 * qm * m00, -2.0 * qm * m11,
                         -2.0 * qm * m22)
    if not full:
        dp = torch.stack([ct * (c2x * sx) * kr * inv_r,
                          ct * (c2y * sy) * kr * inv_r,
                          ct * (c2z * sz) * kr * inv_r], dim=-1)
        dkr = ct * (c2x * (tx - sx * gx) + c2y * (ty - sy * gy)
                    + c2z * (tz - sz * gz))
        if qm is None:
            return dp, torch.stack([dkr, -ct * qx, -ct * qy, -ct * qz],
                                   dim=-1)
        cq = -ct * qm
        return dp, torch.stack([dkr, -ct * (m00 * qx + m11 * qy + m22 * qz),
                                cq * qx, cq * qy, cq * qz], dim=-1)
    pxy, pxz, pyz = acc[9:]
    if qm is None:
        c2xy, c2xz, c2yz = -2.0 * m01, -2.0 * m02, -2.0 * m12
    else:
        c2xy, c2xz, c2yz = -2.0 * qm * m01, -2.0 * qm * m02, -2.0 * qm * m12
    dp = torch.stack([
        ct * (c2x * sx + c2xy * sy + c2xz * sz) * kr * inv_r,
        ct * (c2xy * sx + c2y * sy + c2yz * sz) * kr * inv_r,
        ct * (c2xz * sx + c2yz * sy + c2z * sz) * kr * inv_r], dim=-1)
    dkr = ct * (c2x * (tx - sx * gx) + c2y * (ty - sy * gy)
                + c2z * (tz - sz * gz)
                + c2xy * (2.0 * pxy * inv_r - (sx * gy + sy * gx))
                + c2xz * (2.0 * pxz * inv_r - (sx * gz + sz * gx))
                + c2yz * (2.0 * pyz * inv_r - (sy * gz + sz * gy)))
    if qm is None:
        return dp, torch.stack([dkr, -ct * qx, -ct * qy, -ct * qz,
                                -ct * (2.0 * pxy), -ct * (2.0 * pxz),
                                -ct * (2.0 * pyz)], dim=-1)
    cq = -ct * qm
    dqm = -ct * (m00 * qx + m11 * qy + m22 * qz
                 + 2.0 * (m01 * pxy + m02 * pxz + m12 * pyz))
    return dp, torch.stack([dkr, dqm, cq * qx, cq * qy, cq * qz,
                            cq * (2.0 * pxy), cq * (2.0 * pxz),
                            cq * (2.0 * pyz)], dim=-1)
