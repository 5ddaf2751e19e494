"""The port's mirror paths beside the 1D mirror phase (tools/gp_variants.py's
box-mirror-surface: a mirror BSDF on config 1's back wall;
box-mirror-phase: a mirror BRDF phase on config 1's 3D-sampled medium)
against tungsten_tpu/models/integrator.py on the CPU.

A mirror surface is a Dirac lobe that the walk samples and NEE skips; a
mirror phase on a 3D-sampled medium takes no NEE (the JAX package's
light sampling needs the 1D realization's normal plane), so its
vertices scatter only.  Each scene renders 8x8 pixels at 2 spp in both
packages (JAX's path tracer jitted on the CPU, as tests/test_torch_render.py
runs it), and the port's pixels agree with JAX's within 1e-3 (1 + |ref|)
on at least 97% of the pixels and in their mean within 1%: config 1's
single realization is marched by the general evaluator in JAX and by
K1's twin in the port, whose roundings differ (tests/test_torch_render.py
holds config 1 itself so).  The gradient of both is ported
(tests/test_torch_grad_mirror.py).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models.integrator import render_pass as jrender_pass
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.models import bsdfs as tbs
from tungsten_tpu_torch.models import phase as tph
from tungsten_tpu_torch.scene.parse import scene_from_dict
from tungsten_tpu_torch.tools.gp_variants import variant_docs

NAMES = ("box-mirror-surface", "box-mirror-phase")


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    out = {}
    for k, v in variant_docs(str(tmp_path_factory.mktemp("mirror"))).items():
        if k in NAMES:
            doc = json.loads(json.dumps(v[1]))
            doc["camera"]["resolution"] = [8, 8]
            out[k] = doc
    return out


def test_the_scenes_parse_as_the_jax_package_parses_them(docs):
    for name, doc in docs.items():
        jscene, _ = jscene_from_dict(doc)
        tscene, _ = scene_from_dict(doc, device="cpu")
        a = convert.flatten(tscene)
        b = convert.flatten(convert.scene_from_numpy(convert.flatten(jscene),
                                                     device="cpu"))
        assert a.keys() == b.keys()
        for k, va in a.items():
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, b[k], err_msg=k)
            else:
                assert va == b[k], k
    surf, _ = scene_from_dict(docs["box-mirror-surface"], device="cpu")
    assert tbs.MIRROR in {surf.bsdfs.kinds[b]
                          for b in surf.prims.bsdf.tolist()}
    phase, _ = scene_from_dict(docs["box-mirror-phase"], device="cpu")
    med = phase.media[0]
    assert tph.phase_is_specular(med, phase.bsdfs) and not med.cfg.one_d


@pytest.mark.parametrize("name", NAMES)
def test_render_8x8_matches_jax(docs, name):
    jscene, _ = jscene_from_dict(docs[name])
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    f = jax.jit(jrender_pass)
    ref = sum(np.asarray(f(jscene, jnp.int32(s))) for s in range(2))
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    got = trender.render(tscene, 2, device="cpu").numpy()
    assert got.shape == (8, 8, 3) and np.isfinite(got).all()
    assert ref.mean() > 0.05
    ok = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert ok.mean() >= 0.97, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())


@pytest.mark.parametrize("name", NAMES)
def test_the_gradient_is_refused_by_name(docs, name):
    """The gradient through the mirror paths is ported
    (tests/test_torch_grad_mirror.py holds it to JAX): fwd_bwd runs and is
    finite.  What stays refused on them is a GP type whose gradient JAX
    cannot take: with the knob mean, fwd_bwd and train_step raise by name
    (ROADMAP queue 3)."""
    scene, _ = scene_from_dict(docs[name], device="cpu")
    _, grads = entry.fwd_bwd(scene, 0)
    assert all(bool(torch.isfinite(g)) for g in grads)
    doc = json.loads(json.dumps(docs[name]))
    doc["media"][0]["gaussian_process"]["mean"] = {"type": "procedural",
                                                   "func": "knob"}
    scene, _ = scene_from_dict(doc, device="cpu")
    with pytest.raises(NotImplementedError, match="knob mean.*queue 3"):
        entry.fwd_bwd(scene, 0)
    with pytest.raises(NotImplementedError, match="knob mean"):
        entry.train_step(scene, torch.zeros(8, 8, 3), torch.arange(1))
