"""The media's normal methods and the new means on the sparse-convolution
medium, on the CPU: the GGX and Beckmann visible-normal samplers
(models/ndf.py), the microfacet normals of `media.sample_distance`
(`beckmann`, `ggx`), `finite_differences` (the conditioned normal, as
the JAX package runs it), the conditioned normal under a full `anisoMtx`
splat, and a 16x16, 2-spp render of BASELINE config 1
(scenes/gpis-sphere-box.json) as a CSG union of a procedural knob and a
sphere (the additional mean) with GGX normals, a scatter color and a
volume emission, against the JAX package (its default CPU path,
march_block 1).  Inputs are made with numpy from a seed.

Tolerances:
- The samplers: rtol 1e-5, atol 1e-5 (sqrt, log, cos, sin in float32).
- sample_distance: at most 2 of 96 rays differ in hit, t within 1e-4 and
  normals within rtol 1e-3, atol 1e-3 where both hit, gp ids and failed
  flags equal there.
- The render: at least 97% of pixels within 1e-3 (1 + |ref|), image
  means within 1%.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models import ndf as jndf
from tungsten_tpu.models.camera import Camera as JCamera
from tungsten_tpu.models.integrator import render_pass as jrender_pass
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.models import ndf as tndf
from tungsten_tpu_torch.scene.parse import scene_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
WS_SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
KNOB = {"type": "procedural", "func": "knob",
        "transform": {"position": [0.0, 0.85, 0.0], "scale": 0.45}}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
def test_vndf_samplers_match_jax(dist):
    r = np.random.default_rng(1)
    R = 256
    wi = r.normal(size=(R, 3)).astype(np.float32)
    wi[:, 2] = np.abs(wi[:, 2]) + 1e-3
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    alpha = r.uniform(0.05, 2.0, R).astype(np.float32)
    u1, u2 = (r.uniform(size=R).astype(np.float32) for _ in range(2))
    jfn = {"ggx": jndf.sample_vndf_ggx, "beckmann": jndf.sample_vndf_beckmann}
    tfn = {"ggx": tndf.sample_vndf_ggx, "beckmann": tndf.sample_vndf_beckmann}
    want = np.asarray(jfn[dist](*(jnp.asarray(x) for x in (wi, alpha, u1,
                                                           u2))))
    got = tfn[dist](*(_t(x) for x in (wi, alpha, u1, u2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _doc(normal=None, gp=None, path=SCENE, res=None):
    with open(path) as f:
        doc = json.load(f)
    med = doc["media"][0]
    if normal is not None:
        med["normal_method"] = normal
    if gp is not None:
        gp = json.loads(json.dumps(gp))
        for child in ("left", "right"):
            if child in gp:
                gp[child].setdefault("covariance",
                                     med["gaussian_process"]["covariance"])
        med["gaussian_process"] = gp
    if res is not None:
        doc["camera"]["resolution"] = list(res)
    return doc


CSG = {"type": "csg",
       "left": {"mean": dict(KNOB, color=[0.9, 0.6, 0.3],
                             emission=[0.05, 0.02, 0.0])},
       "right": {"mean": {"type": "spherical", "center": [0.3, 1.1, 0.2],
                          "radius": 0.2}}}


# config 1's GP with a full anisotropy matrix (`anisoMtx`): its splat's
# quadratic form is a full 3x3 (K1 takes the off-diagonal entries)
ANISO = {"mean": {"type": "spherical", "center": [0.0, 0.9, 0.0],
                  "radius": 0.45},
         "covariance": {"type": "squared_exponential", "sigma": 0.06,
                        "lengthScale": 0.12,
                        "anisoMtx": [[1.0, 0.3, 0.0], [0.2, 1.2, 0.1],
                                     [0.0, 0.25, 0.8]]}}


def _rays(r, R):
    center = np.array([0.0, 0.9, 0.0], np.float32)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    ro = (center + u * r.uniform(0.6, 0.8, (R, 1))).astype(np.float32)
    tgt = center + r.normal(size=(R, 3)) * 0.15
    rd = (tgt - ro) / np.linalg.norm(tgt - ro, axis=-1, keepdims=True)
    return ro, rd.astype(np.float32)


@pytest.mark.parametrize("normal, path, gp", [
    ("ggx", SCENE, CSG), ("beckmann", SCENE, None), ("ggx", WS_SCENE, None),
    ("finite_differences", SCENE, None), ("conditioned_gaussian", SCENE,
                                          ANISO)])
def test_sample_distance_normals_match_jax(normal, path, gp):
    jscene, _ = jscene_from_dict(_doc(normal, gp, path))
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    jmed, tmed = jscene.media[0], tscene.media[0]
    assert tmed.normal_method == normal
    R = 96
    r = np.random.default_rng(2)
    ro, rd = _rays(r, R)
    pss = r.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(np.uint32)
    uj = r.uniform(size=R).astype(np.float32)
    gid = (np.arange(R) % 3 == 0).astype(np.int32)  # previous crossings' ids
    jstate = dataclasses.replace(jmd.MediumState.make(R),
                                 last_gp_id=jnp.asarray(gid))
    tstate = dataclasses.replace(tmd.MediumState.make(R, "cpu"),
                                 last_gp_id=_t(gid).long())
    far = np.full(R, 3.0e38, np.float32)
    jres, jnew = jax.jit(lambda *a: jmd.sample_distance(
        jmed, jscene.scene_seed, *a))(
        jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(R), jnp.asarray(far),
        jstate, jnp.asarray(pss), jnp.asarray(uj), jnp.ones(R, bool))
    tres, tnew = tmd.sample_distance(
        tmed, tscene.scene_seed, _t(ro), _t(rd), torch.zeros(R), _t(far),
        tstate, _t(pss.astype(np.int64)), _t(uj),
        torch.ones(R, dtype=torch.bool))
    jhit, thit = ~np.asarray(jres["exited"]), ~tres["exited"].numpy()
    assert thit.sum() > R // 4
    assert (jhit != thit).sum() <= 2
    both = jhit & thit
    np.testing.assert_allclose(tres["t"].numpy()[both],
                               np.asarray(jres["t"])[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres["aniso"].numpy()[both],
                               np.asarray(jres["aniso"])[both], rtol=1e-3,
                               atol=1e-3)
    for k in ("gp_id", "failed"):
        np.testing.assert_array_equal(tres[k].numpy()[both],
                                      np.asarray(jres[k])[both])
    np.testing.assert_array_equal(tnew.last_gp_id.numpy(),
                                  np.asarray(jnew.last_gp_id))
    if normal in ("ggx", "beckmann"):  # unit microfacet normals
        n = np.linalg.norm(tres["aniso"].numpy()[both], axis=-1)
        np.testing.assert_allclose(n, 1.0, rtol=1e-5)


def test_finite_differences_is_the_conditioned_normal():
    """The JAX package declares `finite_differences` but never branches on
    it: the port samples the conditioned normal there too, bit for bit."""
    a, _ = scene_from_dict(_doc("finite_differences", res=(6, 6)),
                           device="cpu")
    b, _ = scene_from_dict(_doc(None, res=(6, 6)), device="cpu")
    np.testing.assert_array_equal(trender.render(a, 1, device="cpu").numpy(),
                                  trender.render(b, 1, device="cpu").numpy())


def test_render_16x16_csg_knob_ggx_color_emission_matches_jax():
    jscene, _ = jscene_from_dict(_doc("ggx", CSG))
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


@pytest.mark.parametrize("normal", ["beckmann", "ggx"])
def test_microfacet_normals_over_matern_are_refused(normal):
    """JAX's MaternCov has no compute_beckmann_roughness: its weight-space
    medium raises; the port refuses the scene by name."""
    doc = _doc(normal, path=WS_SCENE)
    doc["media"][0]["gaussian_process"]["covariance"] = {
        "type": "matern", "sigma": 0.06, "lengthScale": 0.12}
    doc["media"][0]["basis_functions"] = 16
    with pytest.raises(NotImplementedError, match="Matern"):
        scene_from_dict(doc, device="cpu")
    jscene, _ = jscene_from_dict(doc)
    R = 4
    with pytest.raises(AttributeError, match="compute_beckmann_roughness"):
        jax.jit(lambda *a: jmd.sample_distance(
            jscene.media[0], jscene.scene_seed, *a))(
            jnp.zeros((R, 3)) + jnp.asarray([0.0, 0.9, 0.7]),
            jnp.tile(jnp.asarray([0.0, 0.0, -1.0]), (R, 1)), jnp.zeros(R),
            jnp.full(R, 2.0), jmd.MediumState.make(R),
            jnp.zeros((R, 4), jnp.uint32), jnp.zeros(R), jnp.ones(R, bool))


@pytest.mark.parametrize("cov, what", [
    ({"type": "rational_quadratic"}, "RationalQuadraticCov"),
    ({"type": "gabor_iso"}, "GaborIsoCov"),
    ({"type": "mg_nonstationary"}, "MeanGradNonstationaryCov"),
])
def test_sparse_conv_refuses_what_jax_fast_path_cannot_run(cov, what):
    """The JAX package's sparse-conv fast path (K1's) has no quadratic
    splat form (`_inv_cov_mtx`) or sampling scale for these: it raises."""
    from tungsten_tpu.ops import sparse_conv_fast as jfast
    doc = _doc()
    doc["media"][0]["gaussian_process"]["covariance"] = cov
    with pytest.raises(NotImplementedError, match=what):
        scene_from_dict(doc, device="cpu")
    jscene, _ = jscene_from_dict(doc)
    med = jscene.media[0]
    R = 4
    with pytest.raises(AttributeError):
        st = jmd.MediumState.make(R)
        jfast.make_value_at(med.cfg, med.gp, st.coeff3, jnp.zeros((R, 3)),
                            jnp.ones((R, 3)), jnp.zeros((R, 4), jnp.uint32),
                            0)(jnp.zeros(R))
