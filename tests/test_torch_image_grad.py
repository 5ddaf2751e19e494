"""Image-level checks of the port's config 2 (`scenes/gpis-ensemble.json`)
and config 4a (`scenes/gpis-weight-space.json`) gradients against the
JAX package on the CPU.  Each compiles JAX's whole path tracer under
jax.grad, which takes ~45-100 s on one core (at XLA's backend
optimization level 0, as in tests/test_torch_grad.py); the module-level
checks are in tests/test_torch_ensemble.py and tests/test_torch_grad_ws.py.

Tolerances:
- Config 2, a 16x16, 2-spp, depth-2 render (JAX on its default CPU path
  with march_block 1, the port's march on K1's twin): every pixel within
  1e-3 (1 + |ref|); fwd_bwd's image equals the port's plain render bit for
  bit, and its d sum(image) / d(sigma, l) is within 1e-2 relative of
  jax.grad (one JAX compile gives the image and the gradient).
- Config 4a with 64 basis functions on both sides, d sum(image) /
  d(sigma, l) of an 8x8, 2-sample, depth-2 pass within 1e-2 relative of
  jax.grad of JAX's trace (its default CPU search, whose crossings differ
  from the twins' by the bisection's rounding).  At sample 0 alone no ray
  of this frame scatters.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models.integrator import trace as jtrace
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch import render as trender

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENS_SCENE = os.path.join(ROOT, "scenes", "gpis-ensemble.json")
WS_SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
RES = 16


def _compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jset_params(scene, sigma, l):
    cov = dataclasses.replace(scene.media[0].gp.cov, sigma=sigma, l=l)
    med = dataclasses.replace(scene.media[0],
                              gp=dataclasses.replace(scene.media[0].gp,
                                                     cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


def _march_block_1(jscene):
    return dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))


def _jax_pass(jscene, res):
    """JAX's res x res pass of samples 0 and 1 and jax.grad of its sum in
    (sigma, l), from one compile: (image, dsigma, dl)."""
    px, py = jnp.meshgrid(jnp.arange(res, dtype=jnp.int32),
                          jnp.arange(res, dtype=jnp.int32))
    px, py = jnp.tile(px.reshape(-1), 2), jnp.tile(py.reshape(-1), 2)
    spp = jnp.repeat(jnp.arange(2, dtype=jnp.int32), res * res)

    def total(sigma, l):
        c = jtrace(_jset_params(jscene, sigma, l), px, py, spp)
        img = c.reshape(2, res, res, 3).sum(axis=0)
        return jnp.sum(img), img

    cov = jscene.media[0].gp.cov
    (js, jl), img = _compiled(jax.grad(total, argnums=(0, 1), has_aux=True),
                              cov.sigma, cov.l)(cov.sigma, cov.l)
    return np.asarray(img), float(js), float(jl)


@pytest.fixture(scope="module")
def ensemble():
    """Config 2 at RES x RES: (the port's scene converted from JAX's, JAX's
    image and gradient, the port's plain render)."""
    jscene = _march_block_1(jload_scene(ENS_SCENE,
                                        res_override=(RES, RES))[0])
    assert jscene.max_bounces == 2
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    return (tscene, _jax_pass(jscene, RES),
            trender.render(tscene, 2, device="cpu"))


def test_config_2_render_16x16_matches_jax(ensemble):
    _, (ref, _, _), got = ensemble
    got = got.numpy()
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    assert (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all()
    assert ref.mean() > 0.05


def test_config_2_image_grad_matches_jax(ensemble):
    tscene, (_, js, jl), plain = ensemble
    img, (gs, gl) = entry.fwd_bwd(tscene, torch.tensor([0, 1]))
    assert torch.equal(img, plain)
    assert abs(js) > 1e-2 and abs(jl) > 1e-2
    np.testing.assert_allclose([float(gs), float(gl)], [js, jl], rtol=1e-2)


def test_config_4a_image_grad_matches_jax():
    with open(WS_SCENE) as f:
        doc = json.load(f)
    doc["media"][0]["basis_functions"] = 64
    doc["camera"]["resolution"] = [8, 8]
    jscene = _march_block_1(jscene_from_dict(doc)[0])
    assert jscene.max_bounces == 2
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    _, js, jl = _jax_pass(jscene, 8)
    img, (gs, gl) = entry.fwd_bwd(tscene, torch.tensor([0, 1]))
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert abs(js) > 1e-2 and abs(jl) > 1e-2
    np.testing.assert_allclose([float(gs), float(gl)], [js, jl], rtol=1e-2)
