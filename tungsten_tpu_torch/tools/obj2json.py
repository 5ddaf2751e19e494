"""OBJ -> scene JSON converter — analog of the reference's obj2json tool
(src/obj2json/obj2json.cpp): wraps a Wavefront OBJ in a minimal renderable
scene (mesh primitive + lambert BSDFs from the MTL diffuse colors + a
default camera and sky light).

    python -m tungsten_tpu_torch.tools.obj2json model.obj scene.json

A copy of tungsten_tpu/tools/obj2json.py (standard library only).
"""
from __future__ import annotations

import argparse
import json
import os


def parse_mtl(path):
    mats, cur = {}, None
    if not os.path.isfile(path):
        return mats
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "newmtl":
                cur = t[1]
                mats[cur] = [0.8, 0.8, 0.8]
            elif t[0] == "Kd" and cur:
                mats[cur] = [float(v) for v in t[1:4]]
    return mats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("obj")
    ap.add_argument("output")
    ap.add_argument("--fov", type=float, default=60.0)
    args = ap.parse_args(argv)

    mats = {}
    with open(args.obj) as f:
        for line in f:
            t = line.split()
            if t and t[0] == "mtllib":
                mats.update(parse_mtl(
                    os.path.join(os.path.dirname(args.obj), t[1])))

    bsdfs = [{"name": name or "default", "type": "lambert", "albedo": kd}
             for name, kd in (mats.items() or [("default",
                                                [0.8, 0.8, 0.8])])]
    if not bsdfs:
        bsdfs = [{"name": "default", "type": "lambert",
                  "albedo": [0.8, 0.8, 0.8]}]

    doc = {
        "bsdfs": bsdfs,
        "primitives": [
            {"type": "mesh", "file": os.path.relpath(
                args.obj, os.path.dirname(os.path.abspath(args.output))),
             "smooth": True, "bsdf": bsdfs[0]["name"]},
            {"type": "skydome", "temperature": 5777.0, "gamma_scale": 1.0,
             "turbidity": 3.0, "intensity": 2.0, "sample": True},
        ],
        "camera": {
            "type": "pinhole", "fov": args.fov,
            "resolution": [800, 600],
            "transform": {"position": [0, 1, 4], "look_at": [0, 0.5, 0],
                          "up": [0, 1, 0]},
        },
        "integrator": {"type": "path_tracer", "max_bounces": 16},
        "renderer": {"spp": 32, "output_file":
                     os.path.splitext(os.path.basename(args.output))[0]
                     + ".png"},
    }
    with open(args.output, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
