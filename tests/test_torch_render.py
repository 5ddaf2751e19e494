"""The port's scene loading and render of BASELINE config 1 against the JAX
package, and the port's independence from JAX.

Tolerances:
- `load_scene` and `convert.scene_from_numpy(<JAX scene>)`: equal leaf by
  leaf (same dtype, bit-equal values).
- Samples batched into one ray batch: bit-equal to one batch per sample.
- A 16x16, 2-spp render by both (JAX on its default CPU path with
  march_block=1, the port on K1's twin): at least 97% of pixels within
  1e-3 * (1 + |ref|), and image means within 1%.  A pixel may differ when
  one ray's crossing decision flips on an ulp; measured: every pixel within
  tolerance here.
- PNG and PFM files: byte-equal to the JAX package's writer.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.io import image as jimage
from tungsten_tpu.models.camera import Camera as JCamera
from tungsten_tpu.models.integrator import render_pass as jrender_pass
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


def test_load_scene_equals_converted_jax_scene():
    jscene, _ = jload_scene(SCENE)
    tscene, rdoc = tload_scene(SCENE, device="cpu")
    assert rdoc["spp"] == 4
    assert tscene.camera.res_x == 128 and tscene.media[0].bounds is not None
    _assert_trees_equal(
        convert.flatten(tscene),
        convert.flatten(convert.scene_from_numpy(convert.flatten(jscene),
                                                 device="cpu")))


def test_unported_types_raise():
    from tungsten_tpu_torch.scene.parse import scene_from_dict
    with pytest.raises(NotImplementedError, match="conductor"):
        scene_from_dict({"bsdfs": [{"type": "conductor"}]}, device="cpu")
    with pytest.raises(NotImplementedError, match="sphere"):
        scene_from_dict({"primitives": [{"type": "sphere"}]}, device="cpu")


def test_render_16x16_matches_jax():
    jscene, _ = jload_scene(SCENE)
    jscene = dataclasses.replace(
        jscene, max_bounces=2,
        camera=JCamera.create(transform=np.asarray(jscene.camera.transform),
                              fov_deg=35.0, res=(16, 16)),
        media=tuple(dataclasses.replace(m, march_block=1)
                    for m in jscene.media))
    f = jax.jit(jrender_pass)
    ref = sum(np.asarray(f(jscene, jnp.int32(s))) for s in range(2))
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    got = trender.render(tscene, 2, device="cpu").numpy()
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert ok.mean() >= 0.97, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())
    assert ref.mean() > 0.05


def test_samples_in_one_batch_equal_one_batch_each():
    from tungsten_tpu_torch.models.integrator import render_pass
    tscene, _ = tload_scene(SCENE, res_override=(8, 8), device="cpu")
    both = render_pass(tscene, torch.tensor([0, 1]))
    each = render_pass(tscene, 0) + render_pass(tscene, 1)
    np.testing.assert_array_equal(both.numpy(), each.numpy())


def test_render_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tscene, _ = tload_scene(SCENE, res_override=(4, 4), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render(tscene, 1, device="cuda")


def test_cli_renders_without_importing_jax(tmp_path):
    out = tmp_path / "box.png"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['render', {SCENE!r}, '--spp', '1', '--res', '8x8',\n"
        f"            '-o', {str(out)!r}, '--device', 'cpu']\n"
        "runpy.run_module('tungsten_tpu_torch.render', run_name='__main__')\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "assert 'tungsten_tpu' not in sys.modules, 'the port imported the "
        "JAX package'\n"
        "print('no jax')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no jax" in res.stdout
    img = timage.read_pfm(str(tmp_path / "box.pfm"))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert out.stat().st_size > 0


@pytest.mark.parametrize("shape", [(5, 7, 3), (16, 16, 3)])
def test_image_files_equal_the_jax_packages(tmp_path, shape):
    """The port's PNG and PFM bytes equal tungsten_tpu.io.image's, and each
    reader reads the other's PFM exactly (HDR, zero and negative values
    included)."""
    img = np.random.default_rng(3).normal(0.5, 1.0, shape).astype(np.float32)
    for name, writer in (("port", timage), ("jax", jimage)):
        writer.write_png(str(tmp_path / f"{name}.png"), img)
        writer.write_pfm(str(tmp_path / f"{name}.pfm"), img)
    for ext in ("png", "pfm"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    np.testing.assert_array_equal(timage.read_pfm(str(tmp_path / "jax.pfm")),
                                  img)
    np.testing.assert_array_equal(jimage.read_pfm(str(tmp_path / "port.pfm")),
                                  img)
