"""The port's tools (tungsten_tpu_torch/tools/) against the JAX
package's on the inputs of tests/test_tools.py.

Tolerances: hdrmanip, scenemanip, obj2json and json2xml (copies over the
port's image I/O): the same files, byte for byte, and the same printed
metrics.  nl_means (PyTorch, a scan over the window's offsets of shifted
images, as the JAX version's): within 1e-5 * (1 + |x|) of JAX's, with and
without the variance and feature buffers (the box filter's cumulative
sums add in another order than XLA's).
"""
import json

import numpy as np
import pytest

from tungsten_tpu.io.image import write_pfm
from tungsten_tpu.tools import denoiser as jdenoiser
from tungsten_tpu.tools import hdrmanip as jhdrmanip
from tungsten_tpu.tools import json2xml as jjson2xml
from tungsten_tpu.tools import obj2json as jobj2json
from tungsten_tpu.tools import scenemanip as jscenemanip
from tungsten_tpu_torch.io.image import read_pfm
from tungsten_tpu_torch.tools import denoiser, hdrmanip, json2xml, obj2json
from tungsten_tpu_torch.tools import scenemanip


def _noisy(seed=0, n=16):
    rng = np.random.default_rng(seed)
    clean = np.zeros((n, n, 3), np.float32)
    clean[:, n // 2:] = 1.0
    return clean, clean + rng.normal(0, 0.25, clean.shape).astype(np.float32)


@pytest.mark.parametrize("features", [False, True])
def test_nl_means_matches_the_jax_packages(features):
    clean, noisy = _noisy()
    kw = {"variance": np.full((16, 16, 3), 0.25 ** 2, np.float32),
          "radius": 3, "patch": 1}
    if features:
        rng = np.random.default_rng(1)
        kw.update(normal=rng.normal(size=(16, 16, 3)).astype(np.float32),
                  albedo=rng.random((16, 16, 3)).astype(np.float32),
                  depth=rng.random((16, 16)).astype(np.float32) * 3.0)
    got = denoiser.nl_means(noisy, device="cpu", **kw)
    ref = jdenoiser.nl_means(noisy, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if not features:  # random feature buffers hold the weights down
        assert np.mean((got - clean) ** 2) < 0.5 * np.mean(
            (noisy - clean) ** 2)


def test_denoiser_cli(tmp_path):
    img = np.random.default_rng(1).random((16, 16, 3)).astype(np.float32)
    pin, pout = str(tmp_path / "in.pfm"), str(tmp_path / "out.pfm")
    write_pfm(pin, img)
    denoiser.main([pin, pout, "--radius", "2", "--device", "cpu"])
    out = read_pfm(pout)
    np.testing.assert_allclose(out, jdenoiser.nl_means(img, radius=2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cmd", ["merge", "compare", "convert"])
def test_hdrmanip_matches_the_jax_packages(tmp_path, capsys, cmd):
    a = np.full((8, 8, 3), 1.0, np.float32)
    b = np.random.default_rng(2).random((8, 8, 3)).astype(np.float32) * 3.0
    pa, pb = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    write_pfm(pa, a)
    write_pfm(pb, b)
    outs = []
    for name, mod in (("t", hdrmanip), ("j", jhdrmanip)):
        if cmd == "merge":
            path = str(tmp_path / f"{name}.pfm")
            mod.main(["merge", path, pa, pb, "--weights", "1,3"])
        elif cmd == "compare":
            path = None
            mod.main(["compare", pa, pb])
        else:
            path = str(tmp_path / f"{name}.png")
            mod.main(["convert", pb, path, "--tonemap", "reinhard",
                      "--exposure", "0.5"])
        text = capsys.readouterr().out.strip().splitlines()[-1]
        outs.append((text.replace(str(tmp_path), ""),
                     None if path is None else open(path, "rb").read()))
    assert outs[0][1] == outs[1][1]
    if cmd == "compare":
        assert json.loads(outs[0][0]) == json.loads(outs[1][0])


def test_scenemanip_pack_roundtrip_matches_the_jax_packages(tmp_path):
    res = tmp_path / "tex.bin"
    res.write_bytes(b"\x00" * 16)
    scene = {"primitives": [{"type": "mesh", "file": "tex.bin"}]}
    sp = tmp_path / "s.json"
    sp.write_text(json.dumps(scene))
    for name, mod in (("t", scenemanip), ("j", jscenemanip)):
        zp = str(tmp_path / f"{name}.zip")
        mod.main(["pack", str(sp), zp])
        outdir = tmp_path / f"out_{name}"
        mod.main(["unpack", zp, str(outdir)])
        assert (outdir / "tex.bin").read_bytes() == b"\x00" * 16
        assert json.loads((outdir / "s.json").read_text()) == scene
    import zipfile
    with zipfile.ZipFile(tmp_path / "t.zip") as t, \
            zipfile.ZipFile(tmp_path / "j.zip") as j:
        assert [(i.filename, t.read(i)) for i in t.infolist()] == \
            [(i.filename, j.read(i)) for i in j.infolist()]


def test_obj2json_and_json2xml_match_the_jax_packages(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("mtllib tri.mtl\nusemtl red\n"
                   "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (tmp_path / "tri.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\n")
    for name, o2j, j2x in (("t", obj2json, json2xml),
                           ("j", jobj2json, jjson2xml)):
        (tmp_path / name).mkdir()
        o2j.main([str(obj), str(tmp_path / name / "scene.json")])
        j2x.main([str(tmp_path / name / "scene.json"),
                  str(tmp_path / name / "scene.xml")])
    for ext in ("json", "xml"):
        assert (tmp_path / "t" / f"scene.{ext}").read_bytes() == \
            (tmp_path / "j" / f"scene.{ext}").read_bytes()
    txt = (tmp_path / "t" / "scene.xml").read_text()
    assert "<scene" in txt and "perspective" in txt
