"""The port's function-space medium (BASELINE config 4b,
scenes/gpis-function-space.json) and its CSG union (scenes/gpis-csg.json)
against tungsten_tpu/models/media.py, ray for ray, on the CPU.

The JAX package samples each chunk with the root V sqrt(W) of its
covariance, the port with the symmetric root V sqrt(W) V^T (ops/gp.py):
both are valid, but only the same root draws the same realization from the
same z.  So the per-ray tests run JAX with its `gp._sqrt_psd` replaced,
inside the test, by the symmetric root; the JAX package is not edited.  64
rays are fanned at each scene's blob from outside the medium (half of them
at a surface, half inside the medium carrying a value and a normal into a
renewal+ segment). Gates, from the spread measured on these rays (in
brackets): the hit flags and transmittance flags agree on at least 95% of
the rays (all), t within 2e-3 where both hit (2.4e-4), the normals' dot
product at least 0.99 there (0.9998), the values each ray carries on (its
end value, the CSG right child's too) within VALUE_RTOL = 2e-2 sigma
(1.9e-3 sigma on the plain scene; 1.0e-2 sigma on one CSG ray, the left
child's value interpolated at a crossing of the min; every other ray within
1.7e-3), the failed flags and, on the CSG scene, gp_id equal where both
hit.  JAX's transmittance is 1 - hit of the same march, so the port's
visibility is held to JAX's hit flags.  Unpatched, JAX draws other
realizations; over 1,024 rays the port's hit fraction and mean t lie within
3 standard errors of JAX's.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.ops import gp as jgp
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.scene.parse import load_scene, scene_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {"fs": os.path.join(ROOT, "scenes", "gpis-function-space.json"),
          "csg": os.path.join(ROOT, "scenes", "gpis-csg.json")}
VALUE_RTOL = 2e-2


def sym_root(a, jitter=1e-5):
    w, v = jnp.linalg.eigh(a)
    return (v * jnp.sqrt(jnp.maximum(w, 1e-12))[None, :]) @ v.T


def _rays(R, seed):
    """Rays from outside the bounding cube toward the blobs: ro, rd, near,
    far, pss, u_jitter, and the state (first_scatter, last_val,
    last_aniso, fs_val2, fs_grad2) as numpy."""
    r = np.random.default_rng(seed)
    origin = np.array([0.0, 0.9, 2.0], np.float32)
    tgt = np.stack([r.uniform(-0.8, 0.8, R), 0.9 + r.uniform(-0.5, 0.5, R),
                    np.zeros(R)], -1)
    rd = (tgt - origin) / np.linalg.norm(tgt - origin, axis=-1,
                                         keepdims=True)
    near = np.full(R, 1.2, np.float32)
    first = np.arange(R) % 2 == 0
    # the others start inside the medium, carrying a positive value and a
    # normal that faces the ray (the state after a scatter)
    near[~first] = r.uniform(0.9, 1.3, (~first).sum())
    g = -rd + 0.3 * r.normal(size=(R, 3))
    g2 = -rd + 0.3 * r.normal(size=(R, 3))
    state = (first, r.uniform(0.0, 0.03, R).astype(np.float32),
             g.astype(np.float32), r.uniform(0.0, 0.03, R).astype(
                 np.float32), g2.astype(np.float32))
    pss = np.stack([np.arange(R), np.arange(R) % 7, np.full(R, seed),
                    np.ones(R)], -1).astype(np.uint32)
    return (np.tile(origin, (R, 1)), rd.astype(np.float32), near,
            np.full(R, 3.2, np.float32), pss,
            r.uniform(size=R).astype(np.float32), state)


def _run_jax(jscene, rays):
    ro, rd, near, far, pss, uj, (first, lv, la, v2, g2) = rays
    R = ro.shape[0]
    med = jscene.media[0]

    @jax.jit
    def run(ro, rd, near, far, pss, uj, first, lv, la, v2, g2):
        st = dataclasses.replace(jmd.MediumState.make(R), first_scatter=first,
                                 last_val=lv, last_aniso=la, fs_val2=v2,
                                 fs_grad2=g2)
        return jmd.sample_distance(med, jscene.scene_seed, ro, rd, near, far,
                                   st, pss, uj, jnp.ones(R, bool))

    res, new = jax.device_get(run(ro, rd, near, far, pss, uj, first, lv, la,
                                  v2, g2))
    # (JAX's transmittance is 1 - hit of this same march)
    return {"hit": ~np.asarray(res["exited"]), "t": np.asarray(res["t"]),
            "aniso": np.asarray(res["aniso"]),
            "gp_id": np.asarray(res["gp_id"]),
            "failed": np.asarray(res["failed"]),
            "last_val": np.asarray(new.last_val),
            "fs_val2": np.asarray(new.fs_val2),
            "vis": np.where(np.asarray(res["exited"]), 1.0, 0.0)}


def _run_port(tscene, rays):
    ro, rd, near, far, pss, uj, (first, lv, la, v2, g2) = rays
    R = ro.shape[0]
    med = tscene.media[0]

    def t(x):
        return torch.from_numpy(np.asarray(x))

    st = dataclasses.replace(tmd.MediumState.make(R, "cpu"),
                             first_scatter=t(first), last_val=t(lv),
                             last_aniso=t(la), fs_val2=t(v2), fs_grad2=t(g2))
    args = (t(ro), t(rd), t(near), t(far), st, t(pss.astype(np.int64)),
            t(uj), torch.ones(R, dtype=torch.bool))
    res, new = tmd.sample_distance(med, tscene.scene_seed, *args)
    vis = tmd.transmittance(med, tscene.scene_seed, *args)
    return {"hit": (~res["exited"]).numpy(), "t": res["t"].numpy(),
            "aniso": res["aniso"].numpy(), "gp_id": res["gp_id"].numpy(),
            "failed": res["failed"].numpy(),
            "last_val": new.last_val.numpy(), "fs_val2": new.fs_val2.numpy(),
            "vis": vis[:, 0].numpy()}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, path in SCENES.items():
        jscene, _ = jload_scene(path)
        out[name] = (jscene, convert.scene_from_numpy(
            convert.flatten(jscene), device="cpu"))
    return out


@pytest.fixture(scope="module")
def per_ray(scenes):
    """JAX (symmetric root) and the port on 64 rays of each scene."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgp, "_sqrt_psd", sym_root)
        for name, (jscene, tscene) in scenes.items():
            rays = _rays(64, 3)
            out[name] = (_run_jax(jscene, rays), _run_port(tscene, rays),
                         float(jscene.media[0].gp.cov.sigma), jscene)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_distance_matches_jax_ray_for_ray(per_ray, name):
    j, p, sigma, jscene = per_ray[name]
    assert (j["hit"] == p["hit"]).mean() >= 0.95
    assert (j["vis"] == p["vis"]).mean() >= 0.95
    assert 8 <= j["hit"].sum() <= 56  # the fan both hits and misses
    both = j["hit"] & p["hit"]
    assert np.abs(j["t"][both] - p["t"][both]).max() <= 2e-3
    na = j["aniso"] / np.linalg.norm(j["aniso"], axis=-1, keepdims=True)
    nb = p["aniso"] / np.linalg.norm(p["aniso"], axis=-1, keepdims=True)
    assert (na * nb).sum(-1)[both].min() >= 0.99
    assert np.abs(j["last_val"] - p["last_val"]).max() <= VALUE_RTOL * sigma
    assert (j["failed"] == p["failed"]).all()
    if name == "csg":
        right = jscene.media[0].gp.csg_right
        assert np.abs(j["fs_val2"] - p["fs_val2"]).max() <= VALUE_RTOL * \
            float(right.cov.sigma)
        assert (j["gp_id"][both] == p["gp_id"][both]).all()
        assert set(np.unique(p["gp_id"][both])) == {0, 1}  # both lobes hit


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hit_statistics_match_unpatched_jax(scenes, name):
    """JAX's own root V sqrt(W) draws other realizations of the same law:
    the hit fraction and the mean t of 1,024 rays agree within 3 standard
    errors."""
    jscene, tscene = scenes[name]
    rays = _rays(1024, 11)
    j, p = _run_jax(jscene, rays), _run_port(tscene, rays)
    n = len(j["hit"])
    pj, pp = j["hit"].mean(), p["hit"].mean()
    se = np.sqrt(pj * (1 - pj) / n + pp * (1 - pp) / n)
    assert abs(pj - pp) <= 3 * se, (pj, pp, se)
    tj, tp = j["t"][j["hit"]], p["t"][p["hit"]]
    se_t = np.sqrt(tj.var() / len(tj) + tp.var() / len(tp))
    assert abs(tj.mean() - tp.mean()) <= 3 * se_t, (tj.mean(), tp.mean())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_renders_through_the_cli_on_the_cpu(tmp_path, name):
    out = str(tmp_path / f"{name}.png")
    trender.main([SCENES[name], "--spp", "1", "--res", "8x8", "-o", out,
                  "--device", "cpu"])
    from tungsten_tpu_torch.io.image import read_pfm
    img = read_pfm(out[:-4] + ".pfm")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


def test_the_gradient_is_refused_by_name():
    scene, _ = load_scene(SCENES["fs"], res_override=(4, 4), device="cpu")
    with pytest.raises(NotImplementedError, match="function-space"):
        entry.fwd_bwd(scene, 0)
    with pytest.raises(NotImplementedError, match="function-space"):
        entry.train_step(scene, torch.zeros(4, 4, 3), torch.arange(1))
    sigma = scene.media[0].gp.cov.sigma.clone().requires_grad_()
    med = convert.set_params(scene, sigma,
                             scene.media[0].gp.cov.l).media[0]
    R = 4
    with pytest.raises(NotImplementedError, match="forward-only"):
        tmd.sample_distance(
            med, scene.scene_seed, torch.zeros(R, 3),
            torch.tensor([[0.0, 0.0, -1.0]] * R), torch.zeros(R),
            torch.ones(R), tmd.MediumState.make(R, "cpu"),
            torch.zeros(R, 4, dtype=torch.int64), torch.full((R,), 0.5),
            torch.ones(R, dtype=torch.bool))


def _doc(path, **medium):
    import json
    with open(path) as f:
        doc = json.load(f)
    doc["media"][0].update(medium)
    return doc


@pytest.mark.parametrize("medium, what", [
    ({"correlation_context": "global"}, "CSG union under the Global"),
    ({"correlation_context": "bogus"}, "correlation_context"),
    ({"normal_method": "bogus"}, "normal_method"),
    ({"sample_points": 64}, "sample_points 64"),
    ({"type": "homogeneous"}, "medium type"),
    ({"transmittance": {"type": "linear"}}, "transmittance"),
])
def test_unported_options_are_refused_by_name(medium, what):
    # (a CSG union on a sparse-conv or weight-space medium is ported: the
    # right child's mean is the additional mean there)
    path = SCENES["csg" if "CSG" in what else "fs"]
    with pytest.raises(NotImplementedError, match=what):
        scene_from_dict(_doc(path, **medium), device="cpu")


def test_nested_csg_is_refused_by_name():
    doc = _doc(SCENES["csg"])
    gp = doc["media"][0]["gaussian_process"]
    gp["left"] = {"type": "csg", "left": gp["left"], "right": gp["right"]}
    with pytest.raises(NotImplementedError, match="nested CSG"):
        scene_from_dict(doc, device="cpu")


def test_cli_gradient_is_refused():
    with pytest.raises(NotImplementedError, match="function-space"):
        entry.main(["--scene", SCENES["csg"], "--device", "cpu", "--res",
                    "4x4", "--steps", "1", "--spp", "1"])
