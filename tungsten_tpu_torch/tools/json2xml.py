"""Scene JSON -> Mitsuba XML exporter — analog of the reference's json2xml
tool (src/json2xml/json2xml.cpp): converts the subset of the scene graph
that has a Mitsuba equivalent (camera, lambert/dielectric/conductor BSDFs,
quad/cube/sphere/mesh primitives, constant emitters).

    python -m tungsten_tpu_torch.tools.json2xml scene.json scene.xml

A copy of tungsten_tpu/tools/json2xml.py (standard library only).
"""
from __future__ import annotations

import argparse
import json
from xml.etree import ElementTree as ET
from xml.dom import minidom


def _rgb(parent, name, v):
    if isinstance(v, (int, float)):
        v = [v, v, v]
    ET.SubElement(parent, "rgb", name=name,
                  value=f"{v[0]}, {v[1]}, {v[2]}")


_BSDF_MAP = {"lambert": "diffuse", "oren_nayar": "roughdiffuse",
             "dielectric": "dielectric", "rough_dielectric":
             "roughdielectric", "conductor": "conductor",
             "rough_conductor": "roughconductor", "mirror": "conductor",
             "plastic": "plastic", "rough_plastic": "roughplastic",
             "null": "null"}


def convert(doc):
    scene = ET.Element("scene", version="3.0.0")
    ET.SubElement(scene, "integrator", type="path")

    for bi, b in enumerate(doc.get("bsdfs", [])):
        t = _BSDF_MAP.get(b.get("type", "lambert"), "diffuse")
        el = ET.SubElement(scene, "bsdf", type=t,
                           id=b.get("name", f"bsdf{bi}"))
        if "albedo" in b and t in ("diffuse", "roughdiffuse", "plastic",
                                   "roughplastic"):
            _rgb(el, "reflectance" if "diffuse" in t else
                 "diffuse_reflectance", b["albedo"])
        if "roughness" in b and "rough" in t:
            ET.SubElement(el, "float", name="alpha",
                          value=str(b["roughness"]))
        if "ior" in b and "dielectric" in t:
            ET.SubElement(el, "float", name="int_ior", value=str(b["ior"]))

    shape_map = {"quad": "rectangle", "cube": "cube", "sphere": "sphere",
                 "disk": "disk", "mesh": "obj"}
    for p in doc.get("primitives", []):
        t = shape_map.get(p.get("type", ""))
        if t is None:
            continue
        el = ET.SubElement(scene, "shape", type=t)
        if t == "obj" and "file" in p:
            ET.SubElement(el, "string", name="filename", value=p["file"])
        bref = p.get("bsdf")
        if isinstance(bref, str):
            ET.SubElement(el, "ref", id=bref)
        if "emission" in p:
            em = ET.SubElement(el, "emitter", type="area")
            _rgb(em, "radiance", p["emission"])
        tf = p.get("transform", {})
        if tf:
            tr = ET.SubElement(el, "transform", name="to_world")
            if "scale" in tf:
                s = tf["scale"]
                s = [s, s, s] if isinstance(s, (int, float)) else s
                ET.SubElement(tr, "scale", x=str(s[0]), y=str(s[1]),
                              z=str(s[2]))
            if "position" in tf:
                pos = tf["position"]
                ET.SubElement(tr, "translate", x=str(pos[0]), y=str(pos[1]),
                              z=str(pos[2]))

    cam = doc.get("camera", {})
    sensor = ET.SubElement(scene, "sensor", type="perspective")
    ET.SubElement(sensor, "float", name="fov",
                  value=str(cam.get("fov", 60.0)))
    tf = cam.get("transform", {})
    if "position" in tf and "look_at" in tf:
        tr = ET.SubElement(sensor, "transform", name="to_world")
        pos, at = tf["position"], tf["look_at"]
        up = tf.get("up", [0, 1, 0])
        ET.SubElement(tr, "lookat",
                      origin=f"{pos[0]}, {pos[1]}, {pos[2]}",
                      target=f"{at[0]}, {at[1]}, {at[2]}",
                      up=f"{up[0]}, {up[1]}, {up[2]}")
    film = ET.SubElement(sensor, "film", type="hdrfilm")
    res = cam.get("resolution", [512, 512])
    res = [res, res] if isinstance(res, int) else res
    ET.SubElement(film, "integer", name="width", value=str(res[0]))
    ET.SubElement(film, "integer", name="height", value=str(res[1]))
    sampler = ET.SubElement(sensor, "sampler", type="independent")
    ET.SubElement(sampler, "integer", name="sample_count",
                  value=str(doc.get("renderer", {}).get("spp", 32)))
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    with open(args.scene) as f:
        doc = json.load(f)
    xml = minidom.parseString(
        ET.tostring(convert(doc))).toprettyxml(indent="  ")
    with open(args.output, "w") as f:
        f.write(xml)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
