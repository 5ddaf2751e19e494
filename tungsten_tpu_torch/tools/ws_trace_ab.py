"""Times K5 and K4 (csrc/ws_trace.cu) against another version of the same
source on one card, in turns: this version, the other, the other, this
version, each a median of CUDA-event timings of one whole search of
config 4a's rays (chip_smoke.ws_args) at n = 1024.

    python -m tungsten_tpu_torch.tools.ws_trace_ab --other OLD.cu \\
        [--other-api v5] [--rays 131072] [--reps 20]

`--other-api v5` loads a source whose entry points take no covariance tag
(the squared exponential alone, as csrc/ws_trace.cu was before the tags).
The other version runs the squared exponential; this one each covariance
of `--covs`.  Prints one line per timing and a JSON summary last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _load(path, tagged):
    from ..kernels.nvcc import compile_library
    lib, _ = compile_library(Path(path))
    dll = ctypes.CDLL(str(lib))
    fns = {}
    i, p = ctypes.c_int, ctypes.c_void_p
    for name, n_ptr, n_int in (("ws_march", 11, 7), ("ws_trace", 8, 6)):
        fn = getattr(dll, name)
        fn.argtypes = [p] * n_ptr + [i] * (n_int + int(tagged)) + [p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _runner(fns, tagged, args, name):
    """A closure that launches `name` ("K5" or "K4") once on args."""
    from ..kernels import ws_trace as wst
    gp, n, key, ro, rd, near, far = args[:7]
    dev = key.device
    keys = wst.pack_keys(key)
    params = wst.search_params(gp, n, dev)
    out = torch.empty((key.shape[0], 8), dtype=torch.float32, device=dev)
    nxt = torch.empty(1, dtype=torch.int32, device=dev)
    tag = [wst.cov_tag(gp.cov)] if tagged else []
    stream = torch.cuda.current_stream(dev).cuda_stream
    if name == "K5":
        step, uj, absorb, max_steps = args[7:]
        per_ray = [x.contiguous() for x in (ro, rd, near, far, step, uj,
                                            absorb)]
        ints = [wst.march_cap(max_steps), 1, 1, 1]
        fn = fns["ws_march"]
    else:
        per_ray = [x.contiguous() for x in (ro, rd, near, far)]
        ints = [wst.TRACE_MAX_ITERS, 1, 1]
        fn = fns["ws_trace"]

    def run():
        err = fn(keys.data_ptr(), *(x.data_ptr() for x in per_ray),
                 params.data_ptr(), out.data_ptr(), nxt.data_ptr(),
                 key.shape[0], n, *ints, *tag, dev.index, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other ws_trace.cu")
    ap.add_argument("--other-api", choices=("tagged", "v5"), default="v5")
    ap.add_argument("--rays", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--covs", default="se,rq,matern")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ..kernels import ws_trace as wst
    from ..scene.parse import scene_from_dict
    dev = torch.device("cuda")
    print(cs.card(), flush=True)
    mine = _load(wst.SOURCE, True)
    other = _load(args.other, args.other_api == "tagged")
    covs = {"se": None, **cs.WS_TAG_COVS}
    out = {}
    for cov_name in args.covs.split(","):
        med = scene_from_dict(cs.ws_doc(cov=covs[cov_name]),
                              device=dev)[0].media[0]
        for name in ("K5", "K4"):
            a = cs.ws_args(med, args.rays, args.rays, dev, name)
            runs = {"this": _runner(mine, True, a, name)}
            if cov_name == "se":
                runs["other"] = _runner(other, args.other_api == "tagged", a,
                                        name)
            order = (["this", "other", "other", "this"] if "other" in runs
                     else ["this", "this"])
            times = {k: [] for k in runs}
            label = {"this": "csrc/ws_trace.cu",
                     "other": os.path.basename(args.other)}
            for k in order:
                ms = cs.median_ms(runs[k], reps=args.reps)
                times[k].append(ms)
                print(f"{name} ({cov_name}) {label[k]}: {ms:.4f} ms per "
                      f"search of {args.rays} rays (median of {args.reps}, "
                      "CUDA events)", flush=True)
            out[f"{name} {cov_name}"] = times
    print(json.dumps(out))


if __name__ == "__main__":
    main()
