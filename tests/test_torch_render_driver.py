"""The port's render driver (render.py: checkpoint/resume, AOVs, adaptive
sampling, Sobol sampling, dump-pixel, tone curves and EXR output, the
render server) against the JAX package's on the CPU.

Config 1, depth 2: 8x8 for the comparisons with JAX, 4x4 through the CLI.

Tolerances:
- scene_hash, sobol_point (i < 8), the PNG of each tone curve and the EXR
  file (half and float) of the same float image: equal to the JAX
  package's, bit for bit and byte for byte.  /status: the same keys.
- Sobol: the port's render.render(sampler="sobol") of 2 samples (one ray
  batch, each ray drawing its sample's row of the points) against
  the sum of JAX's trace(..., qmc=sobol_point(s)) over the same samples,
  and the feature buffers of trace(..., want_aovs=True) against JAX's on
  the same Sobol draws: every pixel within 1e-3 * (1 + |ref|), visibility
  (a 0/1 shadow decision) on at most 1% of pixels otherwise.  The JAX
  side is one compile of trace(want_aovs=True, qmc=q) (at XLA's backend
  optimization level 0), whose radiance is render_pass(scene, s, qmc)'s;
  render_aovs is trace(want_aovs=True) without qmc, reshaped.
- A render with the AOV code (render_aovs' image) and a render through
  the CLI with and without `--aovs`: bit-equal to the plain render.
- Adaptive: given the same even and odd buffers, the pixel mask equals
  the JAX package's render_adaptive's exactly; the port's render_adaptive
  (16x4, 2 base samples, 2 extra) against JAX's render_adaptive fed the
  port's per-sample images and traced values (captured from the port's
  run): film and counts within 1e-3 * (1 + |ref|).
- dump_pixel (16 points): t equal, f within 1e-4 * (1 + |f|) of JAX's.
- Resume: 2 samples with a checkpoint, then 2 more with `--resume`,
  against 4 uninterrupted: within 1e-6 * (1 + |x|) (the samples are summed
  in other ray batches); a checkpoint of another scene starts fresh.
"""
import dataclasses
import glob
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tungsten_tpu.models.integrator as jint
import tungsten_tpu.render as jrender
from tungsten_tpu.io import exr as jexr
from tungsten_tpu.io import image as jimage
from tungsten_tpu.models.camera import Camera as JCamera
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu.server import RenderServer as JRenderServer
from tungsten_tpu.utils.sobol import sobol_point as jsobol_point
from tungsten_tpu_torch import convert
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.io import exr as texr
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.models import integrator as tint
from tungsten_tpu_torch.server import RenderServer
from tungsten_tpu_torch.utils import sobol as tsobol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
OPT = {"xla_backend_optimization_level": 0}
N = 8  # the side of the images compared with JAX


def _jscene(res):
    jscene, _ = jload_scene(SCENE)
    return dataclasses.replace(
        jscene, max_bounces=2,
        camera=JCamera.create(transform=np.asarray(jscene.camera.transform),
                              fov_deg=35.0, res=res),
        media=tuple(dataclasses.replace(m, march_block=1)
                    for m in jscene.media))


def _tscene(res):
    return convert.scene_from_numpy(convert.flatten(_jscene(res)),
                                    device="cpu")


def _within(got, ref, rtol):
    return np.abs(got - ref) <= rtol * (1.0 + np.abs(ref))


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "scenes", "*.json"))), ids=os.path.basename)
def test_scene_hash_equals_the_jax_packages(path):
    assert trender.scene_hash(path) == jrender.scene_hash(path)


@pytest.mark.parametrize("curve", trender.TONEMAPS)
def test_png_of_each_curve_equals_the_jax_packages(tmp_path, curve):
    img = np.random.default_rng(4).normal(0.5, 1.0, (6, 9, 3)) \
        .astype(np.float32)
    timage.write_png(str(tmp_path / "t.png"), img, curve=curve)
    jimage.write_png(str(tmp_path / "j.png"), img, curve=curve)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


@pytest.mark.parametrize("half", [True, False])
def test_exr_equals_the_jax_packages(tmp_path, half):
    img = np.abs(np.random.default_rng(5).normal(0.5, 2.0, (7, 5, 3))) \
        .astype(np.float32)
    texr.write_exr(str(tmp_path / "t.exr"), img, half=half)
    jexr.write_exr(str(tmp_path / "j.exr"), img, half=half)
    assert (tmp_path / "t.exr").read_bytes() == \
        (tmp_path / "j.exr").read_bytes()
    back = texr.read_exr(str(tmp_path / "t.exr"))
    np.testing.assert_array_equal(
        back[..., :3], img.astype(np.float16).astype(np.float32)
        if half else img)


def test_sobol_points_equal_the_jax_packages():
    for i in list(range(8)) + [3, 0, 5]:  # in order, then seeking
        np.testing.assert_array_equal(tsobol.sobol_point(i),
                                      jsobol_point(i))


def test_server_status_keys_equal_the_jax_packages():
    keys = []
    for cls in (RenderServer, JRenderServer):
        srv = cls(port=0)
        try:
            srv.update(film=np.full((4, 4, 3), 0.5, np.float32),
                       state="rendering", spp_done=1, spp_total=2)
            keys.append(sorted(json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/status").read())))
        finally:
            srv.shutdown()
    assert keys[0] == keys[1]


@pytest.fixture(scope="module")
def jax_qmc_aovs():
    """JAX's trace(want_aovs=True, qmc=q) over the N x N frame at samples
    0 and 1 with their Sobol points: [(radiance [N, N, 3], {aov: [N, N,
    ...]})]."""
    jscene = _jscene((N, N))
    px, py = jnp.meshgrid(jnp.arange(N, dtype=jnp.int32),
                          jnp.arange(N, dtype=jnp.int32))

    def f(s, q):
        c, aovs = jint.trace(jscene, px.reshape(-1), py.reshape(-1), s,
                             want_aovs=True, qmc=q)
        return c.reshape(N, N, 3), {k: v.reshape((N, N) + v.shape[1:])
                                    for k, v in aovs.items()}

    q0 = jnp.asarray(jsobol_point(0))
    g = jax.jit(f).lower(jnp.int32(0), q0).compile(compiler_options=OPT)
    return [jax.tree_util.tree_map(np.asarray, g(
        jnp.int32(s), jnp.asarray(jsobol_point(s)))) for s in range(2)]


def test_sobol_render_matches_jax(jax_qmc_aovs):
    got = trender.render(_tscene((N, N)), 2, sampler="sobol",
                         device="cpu").numpy()
    ref = jax_qmc_aovs[0][0] + jax_qmc_aovs[1][0]
    assert got.shape == ref.shape and ref.mean() > 0.01
    assert _within(got, ref, 1e-3).all()


@pytest.mark.parametrize("name", ["depth", "normal", "albedo",
                                  "visibility"])
def test_aovs_match_jax(jax_qmc_aovs, name, aovs_port):
    ref = jax_qmc_aovs[0][1][name]
    got = aovs_port[name]
    assert got.shape == ref.shape and np.isfinite(got).all()
    ok = _within(got, ref, 1e-3)
    if name == "visibility":
        assert ok.mean() >= 0.99
    else:
        assert ok.all()
    if name != "visibility":
        assert np.abs(ref).max() > 0.1


@pytest.fixture(scope="module")
def aovs_port():
    """The port's trace(want_aovs=True) at sample 0 with its Sobol point,
    as [N, N, ...] numpy buffers."""
    scene = _tscene((N, N))
    px, py = tint._pixels(scene, None)
    _, aovs = tint.trace(scene, px, py, 0, want_aovs=True,
                         qmc=torch.from_numpy(tsobol.sobol_point(0)))
    return {k: v.reshape((N, N) + v.shape[1:]).numpy()
            for k, v in aovs.items()}


def test_aov_code_leaves_the_plain_render_bit_equal():
    scene = _tscene((4, 4))
    img, aovs = tint.render_aovs(scene, 0)
    plain = tint.render_pass(scene, 0)
    assert torch.equal(img, plain)
    assert aovs["depth"].shape == (4, 4) and aovs["normal"].shape == (
        4, 4, 3)
    # the Sobol draws leave the hash draws of bounces past QMC_BOUNCES
    key, spp = torch.tensor([12345]), torch.tensor([1])
    point = torch.from_numpy(tsobol.sobol_point(1))
    draw_q = tint._make_draw(key, key, point, spp)
    draw_h = tint._make_draw(key, key, None, spp)
    deep = torch.tensor([tsobol.QMC_BOUNCES + 1])
    assert torch.equal(draw_q(deep, 5), draw_h(deep, 5))
    # a table of points draws row spp: sample 1's point
    table = torch.from_numpy(np.stack([tsobol.sobol_point(i)
                                       for i in range(3)]))
    first = torch.tensor([0])
    assert torch.equal(tint._make_draw(key, key, table, spp)(first, 7),
                       draw_q(first, 7))


def _jax_adaptive(monkeypatch, images, traced, base, extra):
    """JAX's render_adaptive with render_pass giving images[s] and trace
    giving traced[s] at the pixels it asks for (NaN at a pixel the port
    did not trace)."""
    H, W = images[0].shape[:2]
    stack = jnp.asarray(np.stack(images))
    monkeypatch.setattr(jrender, "render_pass", lambda sc, s: stack[s])
    tstack = jnp.asarray(np.stack(traced))
    monkeypatch.setattr(jint, "trace",
                        lambda sc, x, y, s: tstack[s - base][y, x])
    film, counts = jrender.render_adaptive(_jscene((W, H)), base, extra)
    return np.asarray(film), np.asarray(counts)


def test_adaptive_mask_equals_the_jax_packages(monkeypatch):
    rng = np.random.default_rng(6)
    H, W, base = 24, 20, 4
    smooth = rng.random((H, W, 3)).astype(np.float32)
    images = [smooth.copy() for _ in range(base)]
    for ty, tx in ((1, 1), (4, 3), (5, 0)):  # 3 noisy tiles of 30
        for s in range(base):
            images[s][4 * ty:4 * ty + 4, 4 * tx:4 * tx + 4] += rng.random(
                (4, 4, 3)).astype(np.float32) * (s % 2)
    traced = [np.ones((H, W, 3), np.float32)]
    _, counts = _jax_adaptive(monkeypatch, images, traced, base, 1)
    even = images[0] + images[2]
    odd = images[1] + images[3]
    mask = trender.adaptive_mask(even, odd, base)
    assert 0 < mask.sum() < H * W
    np.testing.assert_array_equal(mask, counts > base)


def test_render_adaptive_matches_the_jax_packages(monkeypatch):
    W, H = 16, 4  # a row of four 4x4 tiles
    scene = _tscene((W, H))
    base, extra = 2, 2
    passes, traced = {}, {}
    real_pass, real_trace = trender.render_pass, trender.trace

    def pass_rec(sc, s, *a):
        passes[s] = real_pass(sc, s, *a)
        return passes[s]

    def trace_rec(sc, px, py, s):
        c = real_trace(sc, px, py, s)
        t = torch.full((H, W, 3), float("nan"))
        t[py, px] = c
        traced[s] = t.numpy()
        return c

    monkeypatch.setattr(trender, "render_pass", pass_rec)
    monkeypatch.setattr(trender, "trace", trace_rec)
    film, counts = trender.render_adaptive(scene, base, extra, device="cpu")
    monkeypatch.undo()
    counts = counts.numpy()
    assert sorted(passes) == [0, 1] and sorted(traced) == [2, 3]
    assert (counts == base + extra).any()
    jfilm, jcounts = _jax_adaptive(
        monkeypatch, [passes[s].numpy() for s in range(base)],
        [traced[s] for s in range(base, base + extra)], base, extra)
    np.testing.assert_array_equal(counts, jcounts)
    assert np.isfinite(film.numpy()).all()
    assert _within(film.numpy(), jfilm, 1e-3).all()


def test_dump_pixel_matches_the_jax_packages():
    got = trender.dump_pixel(_tscene((N, N)), 4, 3, n=16)
    ref = jrender.dump_pixel(_jscene((N, N)), 4, 3, n=16)
    assert got["t"] == ref["t"]
    assert _within(np.asarray(got["f"]), np.asarray(ref["f"]), 1e-4).all()
    assert np.isfinite(got["f"]).all()


def _cli(tmp_path, name, *args, spp=1):
    out = str(tmp_path / name)
    srv = trender.main([SCENE, "--spp", str(spp), "--res", "4x4",
                        "--device", "cpu", "-o", out, *args])
    return out, srv


def test_cli_aovs_serve_profile_leave_the_image_bit_equal(tmp_path, capsys):
    plain, _ = _cli(tmp_path, "plain.png")
    out, srv = _cli(tmp_path, "full.png", "--aovs", "--serve", "0",
                    "--profile", str(tmp_path / "prof"))
    try:
        base = f"http://127.0.0.1:{srv.port}"
        st = json.loads(urllib.request.urlopen(base + "/status").read())
        assert st["spp_done"] == 1 and st["state"] == "done"
        png = urllib.request.urlopen(base + "/framebuffer").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert "spp 1/1" in urllib.request.urlopen(
            base + "/log").read().decode()
    finally:
        srv.shutdown()
    img = timage.read_pfm(str(tmp_path / "plain.pfm"))
    np.testing.assert_array_equal(timage.read_pfm(str(tmp_path /
                                                      "full.pfm")), img)
    for k in ("depth", "normal", "albedo", "visibility"):
        a = timage.read_pfm(str(tmp_path / f"full.{k}.pfm"))
        assert a.shape == (4, 4, 3) and np.isfinite(a).all()
        assert (tmp_path / f"full.{k}.png").stat().st_size > 0
    assert (tmp_path / "prof" / "render_trace.json").stat().st_size > 0
    # -o *.exr with a tone curve: the EXR holds the same image, the PNG the
    # JAX writer's bytes
    _cli(tmp_path, "img.exr", "--tonemap", "filmic")
    np.testing.assert_array_equal(
        texr.read_exr(str(tmp_path / "img.exr"))[..., :3],
        img.astype(np.float16).astype(np.float32))
    jimage.write_png(str(tmp_path / "j.png"), img, curve="filmic")
    assert (tmp_path / "img.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    assert "serving render status" in capsys.readouterr().out


def test_cli_resume_continues_the_samples(tmp_path, capsys):
    _cli(tmp_path, "r.png", "--checkpoint-interval", "2", spp=2)
    with np.load(tmp_path / "r.ckpt.npz") as d:
        assert int(d["spp"]) == 2
        assert str(d["scene_hash"]) == trender.scene_hash(SCENE)
    _cli(tmp_path, "r.png", "--resume", "--checkpoint-interval", "2",
         spp=2)
    assert "resumed at spp=2" in capsys.readouterr().out
    with np.load(tmp_path / "r.ckpt.npz") as d:
        assert int(d["spp"]) == 4
    _cli(tmp_path, "full.png", spp=4)
    got = timage.read_pfm(str(tmp_path / "r.pfm"))
    ref = timage.read_pfm(str(tmp_path / "full.pfm"))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # a checkpoint of another scene: starts fresh
    with np.load(tmp_path / "r.ckpt.npz") as d:
        np.savez(tmp_path / "r.ckpt.npz", film=d["film"] * 0 + 100.0,
                 spp=d["spp"], scene_hash="0123456789abcdef")
    _cli(tmp_path, "r.png", "--resume", spp=1)
    assert "scene hash mismatch; starting fresh" in capsys.readouterr().out
    assert timage.read_pfm(str(tmp_path / "r.pfm")).max() < 100.0


def test_ray_batches_end_on_checkpoint_boundaries():
    scene = _tscene((2, 2))
    done = []
    trender.render(scene, 5, spp_start=1, device="cpu",
                   checkpoint_interval=3, progress=lambda d, f: done.append(d))
    assert done == [3, 6]


def test_cli_adaptive_sobol_and_dump_pixel(tmp_path, capsys):
    _cli(tmp_path, "a.png", "--adaptive", "1", spp=2)
    a = timage.read_pfm(str(tmp_path / "a.pfm"))
    assert a.shape == (4, 4, 3) and np.isfinite(a).all()
    _cli(tmp_path, "s.png", "--sampler", "sobol", spp=2)
    s = timage.read_pfm(str(tmp_path / "s.pfm"))
    assert np.isfinite(s).all() and s.mean() > 0.0
    _cli(tmp_path, "d.png", "--data-dump-pixel", "2,1")
    with open(tmp_path / "d.dump_2_1.json") as f:
        data = json.load(f)
    assert len(data["t"]) == len(data["f"]) == 512
    assert np.isfinite(data["f"]).all()
    assert "spp 3/3" in capsys.readouterr().out


def test_cli_refuses_unported_options_and_a_missing_card(tmp_path,
                                                         monkeypatch):
    for name in ("bdpt", "bidirectional_path_tracer", "kelemen_mlt"):
        with pytest.raises(NotImplementedError, match="item 18"):
            _cli(tmp_path, "x.png", "--integrator", name)
    with pytest.raises(NotImplementedError, match="--adaptive with"):
        _cli(tmp_path, "x.png", "--adaptive", "2", "--sharded")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.main([SCENE, "--res", "4x4", "-o", str(tmp_path / "y.png"),
                      "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render(_tscene((2, 2)), 1, device="cuda")
