"""The gradient in (sigma, l) through the mirror paths beside the 1D mirror
phase against the JAX package on the CPU: a mirror BRDF phase on config
1's 3D-sampled medium and a mirror BSDF on its back wall
(tools/gp_variants.py's box-mirror-phase and box-mirror-surface), where
the integrator itself carries the gradient: the reflected direction turns
with the reattached normal of the medium's crossing
(tungsten_tpu_torch/models/integrator.py, as
tungsten_tpu/models/integrator.py:304-314, 701-726).

Both lobes go into one scene (MIRRORS: the mirror phase and the mirror
wall), at depth 3, so that a path reflected off the medium reaches a
vertex that samples the light (at the scenes' own depth 2 it ends there,
and the phase's image gradient is 0 in both packages).

Tolerances: d sum(image) / d(sigma, l) of an 8x8, 1-spp pass
(entry.fwd_bwd) within 1e-2 relative of jax.grad of the JAX package's
trace, as tests/test_torch_grad.py holds config 1's image gradient (JAX
marches config 1's single realization with its general evaluator, the
port with K1's twin; their roundings differ).  JAX's trace is compiled at
XLA's backend optimization level 0.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grad_common as common
from tungsten_tpu.models.integrator import trace as jtrace
from tungsten_tpu_torch import entry
from tungsten_tpu_torch.scene.parse import scene_from_dict
from tungsten_tpu_torch.tools.gp_variants import variant_docs

RES = 8


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    docs = {k: v[1] for k, v in variant_docs(
        str(tmp_path_factory.mktemp("mirror_grad"))).items()
        if k.startswith("box-mirror")}
    both = json.loads(json.dumps(docs["box-mirror-surface"]))
    both["media"][0]["phase_function"]["bsdf"] = {
        "type": "mirror", "albedo": [0.9, 0.9, 0.9]}
    both["integrator"]["max_bounces"] = 3
    both["camera"]["resolution"] = [RES, RES]
    docs["mirrors"] = both
    return docs


def test_image_grad_through_both_mirrors_matches_jax(docs):
    jscene, tscene = common.scenes(docs["mirrors"])
    assert jscene.max_bounces == 3
    px, py = jnp.meshgrid(jnp.arange(RES, dtype=jnp.int32),
                          jnp.arange(RES, dtype=jnp.int32))
    px, py = px.reshape(-1), py.reshape(-1)

    def loss(sigma, l):
        return jnp.sum(jtrace(common.jset_params(jscene, sigma, l), px, py,
                              jnp.int32(0)))

    cov = common.jparams(jscene)
    jg = common.compiled(jax.grad(loss, argnums=(0, 1)), cov.sigma, cov.l)(
        cov.sigma, cov.l)
    img, (gs, gl) = entry.fwd_bwd(tscene, 0)
    assert img.shape == (RES, RES, 3) and bool(torch.isfinite(img).all())
    jg = [float(x) for x in jg]
    assert all(abs(x) > 1.0 for x in jg), jg
    np.testing.assert_allclose([float(gs), float(gl)], jg, rtol=1e-2)


@pytest.mark.parametrize("name", ["box-mirror-surface", "box-mirror-phase"])
def test_train_step_through_each_mirror_is_finite_and_nonzero(docs, name):
    """A training step of each variant at 8x8, 1 spp, at depth 3 (the
    phase's gradient needs the bounce after the reflection): finite and
    nonzero, where it was refused by name."""
    doc = json.loads(json.dumps(docs[name]))
    doc["integrator"]["max_bounces"] = 3
    doc["camera"]["resolution"] = [RES, RES]
    scene, _ = scene_from_dict(doc, device="cpu")
    _, _, loss, (gs, gl) = entry.train_step(
        scene, torch.zeros(RES, RES, 3), torch.arange(1))
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g)) and float(g) != 0.0
               for g in (gs, gl)), (float(gs), float(gl))
