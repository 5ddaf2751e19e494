"""Scene packager — analog of the reference's scenemanip tool
(src/scenemanip/scenemanip.cpp): packs a scene JSON plus every resource it
references (meshes, textures, grids, binary fields) into one zip archive,
or unpacks such an archive.

    python -m tungsten_tpu_torch.tools.scenemanip pack scene.json out.zip
    python -m tungsten_tpu_torch.tools.scenemanip unpack archive.zip outdir/
    python -m tungsten_tpu_torch.tools.scenemanip list scene.json

A copy of tungsten_tpu/tools/scenemanip.py (standard library only).
"""
from __future__ import annotations

import argparse
import json
import os
import zipfile

RESOURCE_KEYS = {"file", "grid_file", "conditioning_data", "path",
                 "mean_file", "variance_file", "aniso_file", "albedo",
                 "emission", "network", "bitmap"}


def collect_resources(doc, base):
    """Walk the scene graph for string fields that resolve to files."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, str) and (k in RESOURCE_KEYS
                                           or "file" in k):
                    p = os.path.join(base, v)
                    if os.path.isfile(p):
                        found.append((v, p))
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(doc)
    # dedup, keep order
    seen, out = set(), []
    for rel, p in found:
        if rel not in seen:
            seen.add(rel)
            out.append((rel, p))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    pk = sub.add_parser("pack")
    pk.add_argument("scene")
    pk.add_argument("output")
    up = sub.add_parser("unpack")
    up.add_argument("archive")
    up.add_argument("outdir")
    ls = sub.add_parser("list")
    ls.add_argument("scene")
    args = ap.parse_args(argv)

    if args.cmd in ("pack", "list"):
        with open(args.scene) as f:
            doc = json.load(f)
        base = os.path.dirname(os.path.abspath(args.scene))
        res = collect_resources(doc, base)
        if args.cmd == "list":
            for rel, _ in res:
                print(rel)
            return
        with zipfile.ZipFile(args.output, "w", zipfile.ZIP_DEFLATED) as z:
            z.write(args.scene, os.path.basename(args.scene))
            for rel, p in res:
                z.write(p, rel)
        print(f"wrote {args.output} ({1 + len(res)} files)")
    else:
        with zipfile.ZipFile(args.archive) as z:
            z.extractall(args.outdir)
            print(f"extracted {len(z.namelist())} files to {args.outdir}")


if __name__ == "__main__":
    main()
