"""K8: eigh of a batch of small symmetric float32 matrices, and the
symmetric PSD root and pseudo-inverse that the function-space medium forms
from it.

`eigh(a)` wraps the CUDA kernel in csrc/psd.cu (cyclic parallel Jacobi, one
thread block per matrix), which takes the place of tungsten_tpu/ops/gp.py's
`jnp.linalg.eigh` in `_sqrt_psd` and `pseudo_inverse` (an XLA call, not a
Pallas kernel).  A CUDA tensor launches the kernel; a CPU tensor takes the
plain twin `eigh_ref`, `torch.linalg.eigh` of the symmetrized input.  Both
return (w [..., n] ascending, v [..., n, n] with the eigenvectors as
columns); the eigenvectors' signs differ between the two, so what is
compared is what is formed from them: `sqrt_psd` (the symmetric root
V sqrt(max(W, 1e-12)) V^T, which is unique) and `pseudo_inverse` (V W^+ V^T
with the eigenvalues |w| <= 1e-6 max|w| dropped), both by torch.matmul.

The kernel is built at first use with nvcc into `tungsten_tpu_torch/_build/`
(see kernels/nvcc.py).  `LAUNCHES` counts kernel launches (and
`LAUNCHES_BY_N` them by matrix size) and `MOST_MATRICES` records the
largest batch one launch took, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .nvcc import compile_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "psd.cu"
MAX_N = 64  # the kernel's shared-memory tile (csrc/psd.cu)
MAX_SWEEPS = 15

LAUNCHES = 0
LAUNCHES_BY_N = {}
MOST_MATRICES = 0
_FN = None


def build():
    """Compile (if this source, these flags and this nvcc have no library
    yet) and load the kernel.

    Returns nvcc's output (register and spill report), or "" when the
    library was already built."""
    global _FN
    lib, log = compile_library(SOURCE)
    if _FN is None:
        fn = ctypes.CDLL(str(lib)).psd_eigh
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return log


def eigh_ref(a):
    """The plain twin: torch.linalg.eigh of 0.5 (a + a^T), on one intra-op
    thread: MKL's threaded eigensolver is slower than one thread on these
    small matrices, and where several processes share the CPU's cores (a
    test run's workers) its threads spin-wait for minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.linalg.eigh(0.5 * (a + a.transpose(-1, -2)))
    finally:
        torch.set_num_threads(threads)


def eigh(a, sweeps=False):
    """(w [..., n] ascending, v [..., n, n]) of the symmetric part of a
    [..., n, n] (float32, n <= 64).  On a CUDA tensor, one launch of K8
    (with `sweeps`, also the sweeps each matrix took, int32 [...]); on a
    CPU tensor, the twin (no sweeps)."""
    global LAUNCHES, MOST_MATRICES
    if a.device.type == "cpu":
        if sweeps:
            raise ValueError("the twin counts no sweeps")
        return eigh_ref(a)
    if a.device.type != "cuda":
        raise ValueError(f"K8 runs on cuda or cpu tensors, not {a.device}")
    if a.dtype != torch.float32 or a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"a must be float32 [..., n, n], got {a.dtype} "
                         f"{tuple(a.shape)}")
    n = a.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K8 takes 1 <= n <= {MAX_N}, got {n}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if torch.is_grad_enabled() and a.requires_grad:
        raise NotImplementedError("K8 records no graph")
    batch = a.numel() // (n * n)
    if batch >= 2 ** 31:
        raise ValueError(f"K8 takes fewer than 2^31 matrices, got {batch}")
    if _FN is None:
        build()
    w = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    v = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    count = torch.empty(a.shape[:-2], dtype=torch.int32, device=a.device)
    err = _FN(a.data_ptr(), w.data_ptr(), v.data_ptr(), count.data_ptr(),
              batch, n, a.device.index,
              torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K8 launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_N[n] = LAUNCHES_BY_N.get(n, 0) + 1
    MOST_MATRICES = max(MOST_MATRICES, batch)
    return (w, v, count) if sweeps else (w, v)


def _form(w, v, scale):
    """v diag(scale(w)) v^T."""
    return torch.matmul(v * scale(w)[..., None, :], v.transpose(-1, -2))


def sqrt_psd(a, eigh_fn=None):
    """The symmetric root V sqrt(max(W, 1e-12)) V^T of symmetric PSD a
    [..., n, n] (eigh_fn: `eigh` unless given)."""
    w, v = (eigh_fn or eigh)(a)
    return _form(w, v, lambda w: torch.sqrt(torch.clamp(w, min=1e-12)))


def pseudo_inverse(a, eps_scale=1e-6, eigh_fn=None):
    """Symmetric pseudo-inverse of a [..., n, n]: eigenvalues with |w| <=
    eps_scale max|w| are dropped (tungsten_tpu/ops/gp.py's eigh branch)."""
    w, v = (eigh_fn or eigh)(a)
    eps = eps_scale * w.abs().amax(dim=-1, keepdim=True)
    return _form(w, v, lambda w: torch.where(
        w.abs() <= eps, 0.0, 1.0 / torch.where(w == 0, 1.0, w)))
