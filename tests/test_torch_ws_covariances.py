"""Weight space over every covariance the JAX package renders there, on the
CPU: K5's and K4's twins for each covariance tag (kernels/ws_trace.py;
each synthesises its basis with the covariance's own spectral draw)
against the JAX package's batch functions in Pallas interpret mode, the
plain fallback (`media._ws_fallback`, for means outside the kernels'
scope, a CSG union's additional mean and nonstationary covariances)
against the JAX package's vmapped path, a 16x16, 2-spp render of a
fallback variant, and the refusals of what the JAX package cannot render
in weight space.  Inputs are made with numpy from a seed; n = 64.

Tolerances:
- Batch functions per tag: hit masks equal but for at most 2 of 96 rays
  (a crossing decided within rounding of 0: the port synthesises its own
  basis, whose phases differ from JAX's by ulps), t within 2e-3 on rays
  both hit, the bounds of tests/test_weight_space.py.
- Media (the fallback; the kernel path for RQ and Matern): at most 2 rays
  differ in hit or visibility, t within 1e-4 where both hit, and the
  normals there within rtol 1e-3, atol 1e-3 on all but at most 2 rays;
  gp ids equal.
- The render: at least 97% of pixels within 1e-3 (1 + |ref|) and image
  means within 1%.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models.camera import Camera as JCamera
from tungsten_tpu.models.integrator import render_pass as jrender_pass
from tungsten_tpu.ops import weight_space as jws
from tungsten_tpu.ops import ws_trace_pallas as jwst
from tungsten_tpu.scene.parse import parse_cov as jparse_cov
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.kernels import ws_trace as twst
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import weight_space as tws
from tungsten_tpu_torch.scene.parse import scene_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
N = 64
SEED = 42  # the scene's seed

# one covariance per kernel tag (and both Gabor kernels)
TAGS = {
    "se": {"type": "squared_exponential", "sigma": 0.06,
           "lengthScale": 0.12},
    "rq": {"type": "rational_quadratic", "sigma": 0.06, "lengthScale": 0.12,
           "a": 1.5},
    "matern": {"type": "matern", "sigma": 0.06, "lengthScale": 0.12,
               "v": 1.5},
    "gabor_aniso": {"type": "gabor_aniso", "sigma": 0.06, "a_inv": 0.3,
                    "f_inv": 0.3, "omega": [1.0, 0.5, 0.2]},
    "gabor_iso": {"type": "gabor_iso", "sigma": 0.06, "a_inv": 0.3,
                  "f_inv": 0.3},
    "periodic": {"type": "periodic", "sigma": 0.06, "lengthScale": 0.5,
                 "period": 0.5},
    "thin_plate": {"type": "thin_plate", "sigma": 0.06, "R": 0.5},
}
# GPs outside the kernels' scope (the plain fallback)
FALLBACK = {
    "linear": {"mean": {"type": "linear", "reference_point": [0, 0.9, 0],
                        "direction": [0.3, 1.0, 0.2], "scale": 0.8}},
    "procedural": {"mean": {"type": "procedural", "func": "knob",
                            "transform": {"position": [0, 0.9, 0],
                                          "scale": 0.5}}},
    "csg": {"type": "csg",
            "left": {"mean": {"type": "spherical", "center": [0, 0.9, 0],
                              "radius": 0.3}},
            "right": {"mean": {"type": "spherical",
                               "center": [0.25, 0.9, 0], "radius": 0.25}}},
    "nonstationary": {"covariance": {
        "type": "proc_nonstationary",
        "cov": {"type": "squared_exponential", "sigma": 0.06,
                "lengthScale": 0.12},
        "var": {"type": "noise", "noise": "bottom_top", "min": 0.5,
                "max": 2.0, "start": 0.4, "end": 1.4},
        "ls": {"type": "noise", "noise": "left_right", "min": 0.6,
               "max": 1.5, "start": -0.5, "end": 0.5}}},
}


def _doc(gp=None, cov=None, step_size=0.02, res=None, n=N):
    with open(SCENE) as f:
        doc = json.load(f)
    med = doc["media"][0]
    med["basis_functions"] = n
    med["step_size"] = step_size
    if gp is not None:
        base = med["gaussian_process"]
        med["gaussian_process"] = (gp if gp.get("type") == "csg"
                                   else {**base, **gp})
        for child in ("left", "right"):
            if child in gp:
                gp[child].setdefault("covariance", base["covariance"])
    if cov is not None:
        med["gaussian_process"]["covariance"] = cov
    if res is not None:
        doc["camera"]["resolution"] = list(res)
    return doc


@functools.lru_cache(maxsize=None)
def _scenes(key, step_size=0.02):
    """(JAX scene, the port's scene converted from it) of config 4a with
    a tag's covariance or a fallback GP."""
    doc = (_doc(cov=TAGS[key], step_size=step_size) if key in TAGS
           else _doc(gp=json.loads(json.dumps(FALLBACK[key])),
                     step_size=step_size))
    jscene, _ = jscene_from_dict(doc)
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


@functools.lru_cache(maxsize=None)
def _gps(tag):
    """(JAX GP, the port's) of config 4a's mean with a tag's covariance: the
    kernels' inputs.  (Periodic and ThinPlate have no amplitude, so no
    medium of the JAX package renders them in weight space; its kernels
    take them all the same.)"""
    jscene, _ = _scenes("se")
    jgp = dataclasses.replace(jscene.media[0].gp,
                              cov=jparse_cov(TAGS[tag]))
    return jgp, convert.gp_from_numpy(convert.flatten(jgp), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(r, R):
    center = np.array([0.0, 0.9, 0.0], np.float32)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    rad = np.where(np.arange(R) % 2 == 0, r.uniform(0.0, 0.3, R),
                   r.uniform(0.5, 0.7, R))
    ro = (center + u * rad[:, None]).astype(np.float32)
    rd = r.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _pss(r, R):
    return r.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("tag", sorted(TAGS))
def test_supported_by_the_kernels(tag):
    jgp, tgp = _gps(tag)
    assert twst.supports(tgp) and jwst.supports(jgp)


@pytest.mark.parametrize("kernel", ["march", "trace"])
@pytest.mark.parametrize("tag", sorted(TAGS))
def test_batch_twins_match_pallas_per_tag(tag, kernel):
    """The port's K5/K4 batch functions on CPU tensors (the twins, with
    the port's own synthesis from the rays' keys) against JAX's
    fixed_march_batch / sphere_trace_batch on JAX's realizations of the
    same words, in interpret mode."""
    jgp, tgp = _gps(tag)
    R = 96
    r = np.random.default_rng(11)
    pss = _pss(r, R)
    ro, rd = _rays(r, R)
    near = np.zeros(R, np.float32)
    far = r.uniform(0.3, 1.4, R).astype(np.float32)
    jreal = jax.jit(jax.vmap(lambda p: jws.sample_realization(
        jgp.cov, N, p, SEED, False)))(jnp.asarray(pss))
    key = tws.realization_key(_t(pss.astype(np.int64)), SEED, False)
    if kernel == "march":
        step = np.full(R, 0.02, np.float32)
        uj = r.uniform(size=R).astype(np.float32)
        absorb = np.arange(R) % 3 == 0
        want = jwst.fixed_march_batch(jreal, jgp, ro, rd, near, far, step,
                                      uj, absorb, max_steps=2048,
                                      interpret=True)
        jhit, jt = want["hit"], want["t"]
        got = twst.fixed_march_batch(tgp, N, key, *(_t(x) for x in (
            ro, rd, near, far, step, uj, absorb)), max_steps=2048)
    else:
        jhit, jt = jwst.sphere_trace_batch(jreal, jgp, ro, rd, near, far,
                                           interpret=True)
        got = twst.sphere_trace_batch(tgp, N, key, _t(ro), _t(rd), _t(near),
                                      _t(far))
    jhit, jt = np.asarray(jhit), np.asarray(jt)
    thit = got["hit"].numpy()
    assert 5 < jhit.sum() < R - 5
    assert (thit != jhit).sum() <= 2
    both = thit & jhit
    np.testing.assert_allclose(got["t"].numpy()[both], jt[both], rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("key", ["matern", "csg"])
def test_evaluate_many_matches_jax(key):
    """f at S points per ray in one contraction (`ws.evaluate_many`) against
    JAX's, and against the port's one-point `evaluate`."""
    jscene, tscene = _scenes(key)
    jgp, tgp = jscene.media[0].gp, tscene.media[0].gp
    r = np.random.default_rng(17)
    pss = _pss(r, 6)
    pts = (np.array([0.0, 0.9, 0.0]) + r.normal(size=(6, 5, 3)) * 0.3
           ).astype(np.float32)
    jreal = jax.vmap(lambda p: jws.sample_realization(
        jgp.cov, N, p, SEED, False))(jnp.asarray(pss))
    want, jid = jax.vmap(lambda rr, q: jws.evaluate_many(rr, jgp, q))(
        jreal, jnp.asarray(pts))
    treal = tws.sample_realization(tgp.cov, N, _t(pss.astype(np.int64)),
                                   SEED, False)
    got, tid = tws.evaluate_many(treal, tgp, _t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    one = torch.stack([tws.evaluate(treal, tgp, _t(pts[:, k]))[0]
                       for k in range(pts.shape[1])], dim=1)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-4,
                               atol=1e-5)


def _media_case(R=96):
    r = np.random.default_rng(13)
    ro, rd = _rays(r, R)
    first = np.arange(R) % 4 < 2
    pss = _pss(r, R)
    uj = r.uniform(size=R).astype(np.float32)
    active = np.arange(R) % 17 != 0
    jstate = dataclasses.replace(jmd.MediumState.make(R),
                                 first_scatter=jnp.asarray(first))
    tstate = dataclasses.replace(tmd.MediumState.make(R, "cpu"),
                                 first_scatter=_t(first))
    return ro, rd, first, pss, uj, active, jstate, tstate


@pytest.mark.parametrize("step_size", [0.02, 0.0])
@pytest.mark.parametrize("key", ["rq", "matern", "linear", "csg",
                                 "nonstationary", "procedural"])
def test_media_match_jax(monkeypatch, key, step_size):
    """sample_distance and transmittance: the kernel path's twins for RQ
    and Matern (JAX with its Pallas kernels in interpret mode), the plain
    fallback for the others (JAX on its vmapped path, as it runs them)."""
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jscene, tscene = _scenes(key, step_size)
    jmed, tmed = jscene.media[0], tscene.media[0]
    assert twst.supports(tmed.gp) == (key in TAGS)
    ro, rd, first, pss, uj, active, jstate, tstate = _media_case()
    R = len(ro)
    far = np.full(R, 3.0e38, np.float32)
    jargs = (jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(R))
    targs = (_t(ro), _t(rd), torch.zeros(R))
    jtail = (jstate, jnp.asarray(pss), jnp.asarray(uj), jnp.asarray(active))
    ttail = (tstate, _t(pss.astype(np.int64)), _t(uj), _t(active))
    jres, _ = jax.jit(lambda *a: jmd.sample_distance(
        jmed, jscene.scene_seed, *a))(*jargs, jnp.asarray(far), *jtail)
    tres, _ = tmd.sample_distance(tmed, tscene.scene_seed, *targs, _t(far),
                                  *ttail)
    jhit, thit = ~np.asarray(jres["exited"]), ~tres["exited"].numpy()
    assert thit.sum() > R // 4
    assert (jhit != thit).sum() <= 2
    both = jhit & thit
    np.testing.assert_allclose(tres["t"].numpy()[both],
                               np.asarray(jres["t"])[both], rtol=0, atol=1e-4)
    # the normal where both hit: all but at most 2 rays within rtol 1e-3,
    # atol 1e-3 (Matern's heavy-tailed frequencies, up to ~1e4 here, turn
    # the crossing's ulps into differences of the normal on a ray or two)
    close = np.isclose(tres["aniso"].numpy()[both],
                       np.asarray(jres["aniso"])[both], rtol=1e-3,
                       atol=1e-3, equal_nan=True).all(axis=-1)
    assert (~close).sum() <= 2
    np.testing.assert_array_equal(tres["gp_id"].numpy()[both],
                                  np.asarray(jres["gp_id"])[both])
    if key == "csg":
        assert 0 < tres["gp_id"].numpy()[both].sum() < both.sum()
    seg = np.full(R, 0.8, np.float32)
    jtr = np.asarray(jax.jit(lambda *a: jmd.transmittance(
        jmed, jscene.scene_seed, *a))(*jargs, jnp.asarray(seg), *jtail))
    ttr = tmd.transmittance(tmed, tscene.scene_seed, *targs, _t(seg),
                            *ttail).numpy()
    assert (np.asarray(jtr[:, 0] > 0) != (ttr[:, 0] > 0)).sum() <= 2


def test_render_16x16_of_a_fallback_variant_matches_jax():
    """A CSG union of two spheres (the additional mean sends it to the
    plain fallback) with a scatter color: 16x16, 2 spp."""
    gp = json.loads(json.dumps(FALLBACK["csg"]))
    gp["left"]["mean"]["color"] = [0.9, 0.6, 0.3]
    jscene, _ = jscene_from_dict(_doc(gp=gp))
    jscene = dataclasses.replace(
        jscene, max_bounces=2,
        camera=JCamera.create(transform=np.asarray(jscene.camera.transform),
                              fov_deg=35.0, res=(16, 16)),
        media=tuple(dataclasses.replace(m, march_block=1)
                    for m in jscene.media))
    f = jax.jit(jrender_pass)
    ref = sum(np.asarray(f(jscene, jnp.int32(s))) for s in range(2))
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    assert tscene.media[0].gp.mean_additional is not None
    got = trender.render(tscene, 2, device="cpu").numpy()
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert ok.mean() >= 0.97, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())


@pytest.mark.parametrize("cov, jax_error, what", [
    ({"type": "dot_product"}, "amplitude", "DotProductCov"),
    ({"type": "periodic"}, "amplitude", "PeriodicCov"),
    ({"type": "thin_plate"}, "amplitude", "ThinPlateCov"),
    ({"type": "rational_quadratic", "a": 0.3}, None, "a = 0.3"),
    ({"type": "matern", "v": 1.0}, None, "nu = 1.0"),
])
def test_what_jax_cannot_render_is_refused(cov, jax_error, what):
    """Each refusal beside the JAX package's own failure on one ray batch:
    an AttributeError, or NaN where the realization is drawn."""
    doc = _doc(cov=cov)
    with pytest.raises(NotImplementedError, match=what):
        scene_from_dict(doc, device="cpu")
    jscene, _ = jscene_from_dict(doc)
    ro, rd, first, pss, uj, active, jstate, _ = _media_case(8)
    run = jax.jit(lambda *a: jmd.sample_distance(
        jscene.media[0], jscene.scene_seed, *a))
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(8),
            jnp.full(8, 3.0e38), jstate, jnp.asarray(pss), jnp.asarray(uj),
            jnp.asarray(active))
    if jax_error is not None:
        with pytest.raises(AttributeError, match=jax_error):
            run(*args)
    else:
        res, _ = run(*args)
        assert not np.isfinite(np.asarray(res["aniso"])).all()
