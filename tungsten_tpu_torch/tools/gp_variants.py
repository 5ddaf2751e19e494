"""Writes the GP layer's variant scenes: the repo's scene files with a
covariance, mean or normal method swapped for one beside theirs.

    python -m tungsten_tpu_torch.tools.gp_variants OUT_DIR

writes OUT_DIR/<name>.json for each variant (and the sphere mesh
OUT_DIR/sphere.wo3 that the mesh mean reads) and prints each file with
its samples per pixel; render one with tungsten_tpu_torch.render, e.g.
`--res 16x16 --device cpu` on the CPU.  chip_smoke.py renders the same
variants on the card.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from ..io import meshio

SCENES = Path(__file__).resolve().parents[2] / "scenes"


def _load(name):
    with open(SCENES / name) as f:
        return json.load(f)


def _edit(doc, fn):
    """A copy of `doc` with fn(medium 0, its GP) applied."""
    doc = json.loads(json.dumps(doc))
    fn(doc["media"][0], doc["media"][0]["gaussian_process"])
    return doc


def _cov(cov):
    return lambda m, g: g.update(covariance=cov)


def variant_docs(out_dir):
    """{name: (label, scene dict, spp)} of the variants; writes the sphere
    mesh the mesh mean reads into out_dir (a path in its scene dict)."""
    box = _load("gpis-sphere-box.json")
    ws = _load("gpis-weight-space.json")
    fs = _load("gpis-function-space.json")
    sphere = meshio.make_sphere(0.45, 12)
    mesh_path = os.path.join(os.path.abspath(out_dir), "sphere.wo3")
    meshio.save_wo3(mesh_path, sphere["pos"], sphere["tris"],
                    normal=sphere["normal"])
    se = box["media"][0]["gaussian_process"]["covariance"]
    rq = {"type": "rational_quadratic", "sigma": 0.06, "lengthScale": 0.12,
          "a": 1.5}
    matern = {"type": "matern", "sigma": 0.06, "lengthScale": 0.12,
              "v": 1.5}
    step0 = lambda m, g: m.update(step_size=0.0)  # noqa: E731
    return {
        "ws-rq": ("config 4a, rq", _edit(ws, _cov(rq)), 8),
        "ws-rq-trace": ("config 4a, rq, step_size 0",
                        _edit(_edit(ws, _cov(rq)), step0), 8),
        "ws-matern": ("config 4a, matern", _edit(ws, _cov(matern)), 8),
        "ws-matern-trace": ("config 4a, matern, step_size 0",
                            _edit(_edit(ws, _cov(matern)), step0), 8),
        "fs-matern": ("config 4b, Matern nu = 2.5", _edit(fs, _cov(
            {"type": "matern", "sigma": 0.06, "lengthScale": 0.12,
             "v": 2.5})), 8),
        "box-knob": ("config 1, procedural knob mean", _edit(
            box, lambda m, g: g.update(mean={
                "type": "procedural", "func": "knob",
                "transform": {"position": [0.0, 0.9, 0.0], "scale": 0.45}})),
            4),
        "box-mesh": ("config 1, mesh mean", _edit(
            box, lambda m, g: g.update(mean={
                "type": "mesh", "file": mesh_path, "grid_res": 48,
                "transform": {"position": [0.0, 0.9, 0.0]}})), 4),
        "box-ggx": ("config 1, GGX normals", _edit(
            box, lambda m, g: m.update(normal_method="ggx")), 4),
        "box-csg": ("config 1, CSG union", _edit(
            box, lambda m, g: m.update(gaussian_process={
                "type": "csg", "left": g, "right": {
                    "mean": {"type": "spherical", "center": [0.3, 1.1, 0.2],
                             "radius": 0.25}, "covariance": se}})), 4),
        "ws-linear": ("config 4a, linear mean (the plain fallback)", _edit(
            ws, lambda m, g: g.update(mean={
                "type": "linear", "reference_point": [0.0, 0.9, 0.0],
                "direction": [0.2, 1.0, 0.1]})), 8),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, (label, doc, spp) in variant_docs(args.out_dir).items():
        path = os.path.join(args.out_dir, name + ".json")
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)
        print(f"{path}  ({label}, {spp} spp)")


if __name__ == "__main__":
    main()
