"""Times the diagonal instances of K1b and K2b (csrc/noise3d.cu) against
another version of the same source on one card, in turns: this version,
the other, the other, this version, ROUNDS times, each the kernel's mean
device time over 20 launches (torch.profiler, as chip_smoke.py times K1b
and K2b) on the inputs of chip_smoke.py's K1b and K2b phases (config 1's
cell radius and splat form at K1B_POINTS; the hero's levels and form at
K2B_POINTS).

    git show REV:tungsten_tpu_torch/csrc/noise3d.cu > DIR/noise3d.cu
    cp tungsten_tpu_torch/csrc/grid_sum.cuh DIR/
    python -m tungsten_tpu_torch.tools.lattice_ab --other DIR/noise3d.cu

The other source is one whose K1b and K2b take the diagonal form alone
(csrc/noise3d.cu before the full-form instances), with
csrc/grid_sum.cuh beside it.  Both versions' outputs must be bit-equal.
Prints one line per timing, and last a JSON summary: each case's times
and their quartiles per version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

K1B_POINTS = (65536, 1 << 20)
K2B_POINTS = (262144,)
ROUNDS = 10
ROOT = Path(__file__).resolve().parents[2]


def _load(path, full_api):
    """(K1b, its grid query, K2b) of the library built from `path`, each a
    callable that takes the diagonal interface's arguments (`full_api`:
    the library's entry points also take the off-diagonal entries and the
    full flag, given as 0)."""
    from ..kernels.nvcc import compile_library
    lib, _ = compile_library(Path(path))
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k1b, grid, k2b = (dll.noise3d_sum_s_bwd, dll.noise3d_sum_s_bwd_grid,
                      dll.noise3d_sum_bwd)
    extra = [f] * 3 + [i] if full_api else []
    k1b.argtypes = [p] * 7 + [i] * 2 + [f] * 4 + extra + [i, i, p]
    grid.argtypes = [i] * (4 if full_api else 3) + [ctypes.POINTER(i)]
    k2b.argtypes = [p] * 7 + [i] + [f] * 3 + extra + [i, i, p]
    for fn in (k1b, grid, k2b):
        fn.restype = i
    if full_api:
        return ((lambda *a: k1b(*a[:13], 0.0, 0.0, 0.0, 0, *a[13:])),
                (lambda n, K, d, b: grid(n, K, 0, d, b)),
                (lambda *a: k2b(*a[:11], 0.0, 0.0, 0.0, 0, *a[11:])))
    return k1b, grid, k2b


def _k1b_runner(fns, args):
    """A closure that launches K1b once on args (chip_smoke.k1b_inputs with
    the cell radius and form diagonal), and the output it writes."""
    from ..kernels import grid_sum
    k1b, grid, _ = fns
    p, seed, g, kr, m3, K = args
    n, dev = p.shape[0], p.device
    blocks, scratch, ticket, stream = grid_sum.buffers(grid, n, K, dev, 4,
                                                       "K1b")
    seed32 = seed.to(torch.int32).contiguous()
    dp = torch.empty(n, 3, dtype=torch.float32, device=dev)
    sums = torch.empty(4, dtype=torch.float32, device=dev)

    def run():
        err = k1b(p.data_ptr(), seed32.data_ptr(), g.data_ptr(),
                  dp.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                  sums.data_ptr(), n, blocks, kr, *m3, K, dev.index, stream)
        if err:
            raise RuntimeError(f"K1b launch failed: CUDA error {err}")
    return run, (dp, sums)


def _k2b_runner(fns, args):
    """A closure that launches K2b once on args (chip_smoke.k2_inputs with
    a cotangent and the form diagonal), and the output it writes."""
    _, _, k2b = fns
    p, seed, kr, qm, g, m3, K = args
    n, dev = p.shape[0], p.device
    seed32 = seed.to(torch.int32).contiguous()
    dp = torch.empty(n, 3, dtype=torch.float32, device=dev)
    part = torch.empty(n, 5, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = k2b(p.data_ptr(), seed32.data_ptr(), kr.data_ptr(),
                  qm.data_ptr(), g.data_ptr(), dp.data_ptr(), part.data_ptr(),
                  n, *m3, K, dev.index, stream)
        if err:
            raise RuntimeError(f"K2b launch failed: CUDA error {err}")
    return run, (dp, part)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other noise3d.cu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ..kernels import noise3d
    from ..scene.parse import load_scene
    dev = torch.device("cuda")
    print(cs.card(), flush=True)
    versions = {"this": _load(noise3d.SOURCE, True),
                "other": _load(args.other, False)}
    label = {"this": "csrc/noise3d.cu", "other": os.path.basename(args.other)}
    cov = load_scene(cs.SCENE, device=dev)[0].media[0].gp.cov
    host = noise3d.host_params(cov.splat_radius(), cov.splat_form())
    base = load_scene(cs.HERO_SCENE, device=dev)[0].media[0].gp.cov.base
    m3 = tuple(base.splat_form().tolist())
    cases = []
    for n in K1B_POINTS:
        p, sd, g = cs.k1b_inputs(n, dev)
        cases.append((f"K1b N={n}", "noise3d_sum_s_bwd_kernel", _k1b_runner,
                      (p, sd, g, host[0], host[1:], 3)))
    for n in K2B_POINTS:
        p, sd, kr, qm = cs.k2_inputs(base, n, dev)
        g = torch.randn(n, generator=torch.Generator().manual_seed(7)).to(dev)
        cases.append((f"K2b N={n}", "noise3d_sum_bwd_kernel", _k2b_runner,
                      (p, sd, kr, qm, g, m3, 3)))
    out = {}
    for what, kernel, make, a in cases:
        runs = {k: make(fns, a) for k, fns in versions.items()}
        for run, _ in runs.values():
            run()
        torch.cuda.synchronize()
        outs = [o for _, o in runs.values()]
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            raise RuntimeError(f"{what}: the two versions' outputs differ")
        times = {k: [] for k in runs}
        for k in ("this", "other", "other", "this") * ROUNDS:
            ms = cs.kernel_device_ms(runs[k][0], kernel)
            times[k].append(ms)
            print(f"{what} {label[k]}: {ms:.4f} ms of device time (mean of "
                  "20, torch.profiler); outputs bit-equal", flush=True)
        out[what] = {k: {"ms": v, "quartiles": np.percentile(
            v, (25, 50, 75)).tolist()} for k, v in times.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
