"""Batch HDR image manipulation — analog of the reference's hdrmanip tool
(src/hdrmanip/hdrmanip.cpp): tonemap/exposure conversion, format conversion
(PFM <-> PNG), merging (average) of multiple renders, and error metrics
(mse/rmse) between two images.

    python -m tungsten_tpu_torch.tools.hdrmanip convert in.pfm out.png \
        [--exposure 1.0 --tonemap filmic]
    python -m tungsten_tpu_torch.tools.hdrmanip merge out.pfm a.pfm b.pfm ...
    python -m tungsten_tpu_torch.tools.hdrmanip compare ref.pfm test.pfm

A copy of tungsten_tpu/tools/hdrmanip.py over the port's io/image.py.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..io.image import (read_pfm, tonemap_filmic, tonemap_gamma,
                        tonemap_reinhard, write_pfm, write_png)


def _load(path):
    if path.endswith(".pfm"):
        return np.asarray(read_pfm(path), np.float32)
    raise SystemExit(f"unsupported input format: {path} (use .pfm)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--exposure", type=float, default=1.0)
    c.add_argument("--tonemap", default="gamma",
                   choices=["linear", "gamma", "reinhard", "filmic"])

    m = sub.add_parser("merge")
    m.add_argument("output")
    m.add_argument("inputs", nargs="+")
    m.add_argument("--weights", default=None,
                   help="comma-separated per-input weights (default: equal)")

    p = sub.add_parser("compare")
    p.add_argument("ref")
    p.add_argument("test")

    args = ap.parse_args(argv)

    if args.cmd == "convert":
        img = _load(args.input) * args.exposure
        if args.output.endswith(".pfm"):
            write_pfm(args.output, img)
        else:
            fn = {"linear": lambda x: np.clip(x, 0, 1),
                  "gamma": tonemap_gamma, "reinhard": tonemap_reinhard,
                  "filmic": tonemap_filmic}[args.tonemap]
            write_png(args.output, fn(img), tonemap=False)
        print(f"wrote {args.output}")
    elif args.cmd == "merge":
        imgs = [_load(p) for p in args.inputs]
        w = (np.asarray([float(v) for v in args.weights.split(",")])
             if args.weights else np.ones(len(imgs)))
        w = w / w.sum()
        out = sum(wi * im for wi, im in zip(w, imgs))
        write_pfm(args.output, out)
        print(f"wrote {args.output} (merged {len(imgs)})")
    elif args.cmd == "compare":
        a, b = _load(args.ref), _load(args.test)
        d = (a - b).astype(np.float64)
        mse = float(np.mean(d * d))
        rel = float(np.mean(d * d / (a.astype(np.float64) ** 2 + 1e-3)))
        print(json.dumps({"mse": mse, "rmse": mse ** 0.5, "rel_mse": rel,
                          "max_abs": float(np.max(np.abs(d)))}))


if __name__ == "__main__":
    main()
