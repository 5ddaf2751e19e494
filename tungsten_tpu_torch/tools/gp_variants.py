"""Writes the GP layer's variant scenes: the repo's scene files with a
covariance, mean, normal method, sampling space, correlation context or
material swapped for one beside theirs.

    python -m tungsten_tpu_torch.tools.gp_variants OUT_DIR

writes OUT_DIR/<name>.json for each variant (and the sphere meshes
OUT_DIR/sphere.wo3, which the mesh mean reads, and
OUT_DIR/sphere-cond.wo3, the same sphere at the function-space scene's
mean, which fs-conditioned conditions on) and prints each file with its
samples per pixel; render one with tungsten_tpu_torch.render, e.g.
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


def _mirror_wall(doc):
    """`doc` with a mirror BSDF on its back wall."""
    doc = json.loads(json.dumps(doc))
    doc["bsdfs"].append({"name": "mirror", "type": "mirror",
                         "albedo": [0.9, 0.9, 0.9]})
    for p in doc["primitives"]:
        if p.get("name") == "backWall":
            p["bsdf"] = "mirror"
    return doc


# a full splat anisotropy for the anisoMtx variants
ANISO_MTX = [[1.0, 0.2, 0.0], [0.1, 0.8, 0.3], [0.0, 0.1, 1.2]]


def variant_docs(out_dir):
    """{name: (label, scene dict, spp)} of the variants; writes the sphere
    meshes the mesh mean and the mesh conditioning read into out_dir
    (paths in their scene dicts)."""
    box = _load("gpis-sphere-box.json")
    ws = _load("gpis-weight-space.json")
    fs = _load("gpis-function-space.json")
    hero = _load("gpis-hero.json")
    m1d = _load("gpis-mirror-1d.json")
    sphere = meshio.make_sphere(0.45, 12)
    mesh_path = os.path.join(os.path.abspath(out_dir), "sphere.wo3")
    meshio.save_wo3(mesh_path, sphere["pos"], sphere["tris"],
                    normal=sphere["normal"])
    cond_path = os.path.join(os.path.abspath(out_dir), "sphere-cond.wo3")
    meshio.save_wo3(cond_path, sphere["pos"] + [0.0, 0.9, 0.0],
                    sphere["tris"], normal=sphere["normal"])
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
        "fs-global": ("config 4b, Global context", _edit(
            fs, lambda m, g: m.update(correlation_context="global")), 8),
        "fs-none": ("config 4b, None context", _edit(
            fs, lambda m, g: m.update(correlation_context="none")), 8),
        "fs-skip": ("config 4b, skip_space 0.01", _edit(
            fs, lambda m, g: m.update(skip_space=0.01)), 8),
        "fs-conditioned": ("config 4b, Global context conditioned on a "
                           "sphere mesh", _edit(fs, lambda m, g: (
                               m.update(correlation_context="global"),
                               g.update(conditioning_data=cond_path))), 8),
        "hero-bruteforce": ("config 5, brute-force nonstationary", _edit(
            hero, lambda m, g: g["covariance"].update(
                multiResolutionGrid=False)), 1),
        "hero-iso": ("config 5, isotropic-ray 3D sampling", _edit(
            hero, lambda m, g: m.update(isotropic_3D_sampling=True)), 1),
        "hero-renewal": ("config 5, renewal+ conditioning", _edit(
            hero, lambda m, g: m.update(correlation_context="renewal+")),
            1),
        "hero-1d": ("config 5, 1D sampling (multi-resolution)", _edit(
            hero, lambda m, g: m.update({"1D_sampling": True})), 1),
        "hero-surfvol": ("config 5, surf/vol phase ids, GGX normals", _edit(
            hero, lambda m, g: m.update(
                surf_vol_phase_separate=True, surf_vol_phase_amp_thresh=0.95,
                normal_method="ggx")), 1),
        "box-iso": ("config 1, isotropic-ray 3D sampling", _edit(
            box, lambda m, g: m.update(isotropic_3D_sampling=True)), 4),
        "box-iso-aniso": ("config 1, isotropic-ray 3D sampling, anisoMtx",
                          _edit(box, lambda m, g: (
                              m.update(isotropic_3D_sampling=True),
                              g["covariance"].update(anisoMtx=ANISO_MTX)))
                          , 4),
        "box-aniso": ("config 1, anisoMtx in world space", _edit(
            box, lambda m, g: g["covariance"].update(anisoMtx=ANISO_MTX)),
            4),
        "box-mirror-phase": ("config 1, mirror phase function", _edit(
            box, lambda m, g: m["phase_function"].update(
                bsdf={"type": "mirror", "albedo": [0.9, 0.9, 0.9]})), 4),
        "box-mirror-surface": ("config 1, mirror back wall",
                               _mirror_wall(box), 4),
        "m1d-renewal": ("config 3, renewal conditioning", _edit(
            m1d, lambda m, g: m.update(correlation_context="renewal")), 16),
        "m1d-aniso": ("config 3, anisoMtx", _edit(
            m1d, lambda m, g: g["covariance"].update(anisoMtx=ANISO_MTX)),
            16),
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
