"""The port's BASELINE config 2 (`scenes/gpis-ensemble.json`: ensemble
GPIS, 3D sampling in isotropic-ray space, renewal+ conditioning of each
path's 3D realization) against the JAX package on the CPU, forward and
gradient.  Inputs are made with numpy from a seed and handed to both
packages.

Tolerances (JAX on its default CPU path, the vmapped general evaluator,
with march_block 1; the port's march on K1's twin):
- `conditioning_3d` (renewal and renewal+, isotropic-ray and world space):
  within rtol 1e-5, atol 1e-5 of JAX's; `eval_noise3d` conditioned on those
  coefficients within rtol 1e-5, atol 1e-5 (value) and atol 1e-4
  (gradient, whose components reach ~40).
- `sparse_conv_fast.make_value_at` with conditioning (K1's twin) against
  JAX's `sparse_conv_fast.make_value_at` on its XLA twin (isotropic-ray
  space), and against the port's `eval_value` (both spaces): within atol
  1e-5 (the K1 tolerance).
- sample_distance over two segments (the second conditioned at its start
  on the first's crossing and normal): hit masks equal on all but 2 rays,
  t within 1e-4 and normals within rtol 1e-3, atol 1e-3 where both hit.
- `load_scene` equals the converted JAX scene leaf by leaf.
- The 32-ray, two-segment medium-level gradient d sum(t1 + t2) /
  d(sigma, l) within 1e-3 relative of jax.grad, and within rtol 0.15,
  atol 0.5 of the port's central FD at eps 5e-4, each over the lanes
  whose t1 and t2 FD resolves (`fd_lanes`: central differences at eps and
  eps / 4 agree): a lane whose march takes another bracket or refinement
  path across the stencil jumps by up to ~1e-2 in t2, which FD turns into
  slopes of ~10 that no derivative has.
- `entry.train_step` in groups of samples (render.MAX_RAYS patched small)
  equals one batch within rtol 1e-6.
JAX's functions are compiled at XLA's backend optimization level 0.  The
16x16 render and its image-level gradient are in
tests/test_torch_image_grad.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_fast as jfast
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.models.integrator import render_pass
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops import sparse_conv_fast as tfast
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-ensemble.json")
SCENE_SEED = 9
RES = 16  # the camera of the JAX scene the tests convert
FD_EPS = 5e-4


def _compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene at RES x RES, march_block 1, depth 2; the port's scene
    converted from it)."""
    jscene, _ = jload_scene(SCENE, res_override=(RES, RES))
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    assert jscene.max_bounces == 2
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _variant(scenes, ctxt, iso):
    """(JAX cfg, JAX gp, port cfg, port gp) of config 2's medium under the
    context `ctxt`, in isotropic-ray space or world space."""
    jmed, tmed = scenes[0].media[0], scenes[1].media[0]
    jcfg = dataclasses.replace(jmed.cfg, ctxt=ctxt, isotropic_3d=iso)
    tcfg = dataclasses.replace(tmed.cfg, ctxt=ctxt, isotropic_3d=iso)
    return jcfg, jmed.gp, tcfg, tmed.gp


def _points(R=96, seed=4):
    r = np.random.default_rng(seed)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    p = (np.array([0.0, 0.9, 0.0]) + u * r.uniform(0.3, 0.6, (R, 1)))
    rd = r.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tv = r.normal(scale=0.02, size=R)
    tg = r.normal(size=(R, 3))
    pss = r.integers(0, 64, (R, 4))
    return (p.astype(np.float32), rd.astype(np.float32),
            tv.astype(np.float32), tg.astype(np.float32),
            pss.astype(np.uint32))


@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("ctxt", ["renewal+", "renewal"])
def test_conditioning_3d_and_noise_match_jax(scenes, ctxt, iso):
    jcfg, jgp, tcfg, tgp = _variant(scenes, ctxt, iso)
    p, rd, tv, tg, pss = _points()

    def jrun(p, rd, tv, tg, pss):
        c3 = jax.vmap(lambda p_i, d, v, g, s: jsc.conditioning_3d(
            jcfg, jgp, p_i, d, v, g, s, SCENE_SEED))(p, rd, tv, tg, pss)
        seed = jax.vmap(lambda s: jsc.compute_seed(jcfg, s, SCENE_SEED))(pss)
        # the noise at points off the conditioning origins
        q = p + 0.05 * rd
        nv, ng = jax.vmap(lambda c, q_i, d, s: jsc.eval_noise3d(
            jcfg, jgp, c, q_i, d, s, True))(c3, q, rd, seed)
        return c3, nv, ng

    jc3, jnv, jng = jax.jit(jrun)(p, rd, tv, tg, pss)
    tc3 = tsc.conditioning_3d(tcfg, tgp, _t(p), _t(rd), _t(tv), _t(tg),
                              _t(pss.astype(np.int64)), SCENE_SEED)
    for k in ("value_scale", "gradient_scale", "ray_origin"):
        np.testing.assert_allclose(getattr(tc3, k).numpy(),
                                   np.asarray(getattr(jc3, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert np.abs(np.asarray(jc3.value_scale)).max() > 0.1
    if ctxt == "renewal+":
        assert np.abs(np.asarray(jc3.gradient_scale)).max() > 0.01
    seed = tsc.compute_seed(tcfg, _t(pss.astype(np.int64)), SCENE_SEED)
    tnv, tng = tsc.eval_noise3d(tcfg, tgp, _t(p + 0.05 * rd), seed, tc3,
                                _t(rd), True)
    np.testing.assert_allclose(tnv.numpy(), np.asarray(jnv), rtol=1e-5,
                               atol=1e-5)
    # the gradient's components reach ~40 (the world gradient of noise at
    # length scale 0.12): atol 1e-4 is ~2.5e-6 of that
    np.testing.assert_allclose(tng.numpy(), np.asarray(jng), rtol=1e-5,
                               atol=1e-4)


def test_make_value_at_with_conditioning_matches_jax_fast(monkeypatch,
                                                          scenes):
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "0")  # JAX's XLA twin
    jcfg, jgp, tcfg, tgp = _variant(scenes, "renewal+", True)
    p, rd, tv, tg, pss = _points(seed=5)
    jc3 = jax.jit(jax.vmap(lambda p_i, d, v, g, s: jsc.conditioning_3d(
        jcfg, jgp, p_i, d, v, g, s, SCENE_SEED)))(p, rd, tv, tg, pss)
    tc3 = convert.coeffs_from_numpy(jc3, device="cpu")
    ts = np.linspace(0.0, 0.3, 4, dtype=np.float32)

    def jval(p, rd, pss, t):
        va = jfast.make_value_at(jcfg, jgp, jc3, p, rd, pss, SCENE_SEED)
        return va(jnp.full(p.shape[0], t))[0]

    jv = _compiled(jval, p, rd, pss, ts[0])
    want = np.stack([np.asarray(jv(p, rd, pss, t)) for t in ts])
    va = tfast.make_value_at(tcfg, tgp, _t(p), _t(rd),
                             _t(pss.astype(np.int64)), SCENE_SEED,
                             coeff3=tc3)
    got = np.stack([va(torch.full((p.shape[0],), float(t)))[0].numpy()
                    for t in ts])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the conditioning splat is in the values: at t = 0 each ray sits on
    # its conditioning origin, where the realization takes the target value
    np.testing.assert_allclose(got[0], tv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("iso", [True, False])
def test_make_value_at_equals_the_general_evaluator(scenes, iso):
    """The march's value (K1's twin, the conditioning splat per step) equals
    eval_value's (held to JAX above) in both sampling spaces."""
    _, _, tcfg, tgp = _variant(scenes, "renewal+", iso)
    p, rd, tv, tg, pss = (_t(a) for a in _points(seed=6))
    pss = pss.to(torch.int64)
    c3 = tsc.conditioning_3d(tcfg, tgp, p, rd, tv, tg, pss, SCENE_SEED)
    va = tfast.make_value_at(tcfg, tgp, p, rd, pss, SCENE_SEED, coeff3=c3)
    for t in (0.0, 0.07, 0.2):
        tt = torch.full((p.shape[0],), t)
        want, _ = tsc.eval_value(tcfg, tgp, p + tt[:, None] * rd, pss,
                                 SCENE_SEED, ray_dir=rd, coeff3=c3)
        np.testing.assert_allclose(va(tt)[0].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


def _two_segment_rays(R=32):
    """The rays of the medium-level gradient test: a fan from the camera
    into the GPIS sphere; the second segment goes on in the same direction
    from the first crossing, conditioned there."""
    ths = np.linspace(-0.12, 0.12, R, dtype=np.float32)
    ro = np.tile(np.array([[0.0, 1.0, 3.8]], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) - 0.02,
                   -np.cos(ths)], axis=-1).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.uint32)
    uj, near, far = (np.full(R, v, np.float32) for v in (0.5, 2.0, 4.5))
    return ro, rd, pss, uj, near, far


def _port_two_segments(med, scene_seed, ro, rd, pss, uj, near, far):
    R = ro.shape[0]
    pss = pss.astype(np.int64)
    res1, st = tmd.sample_distance(
        med, scene_seed, _t(ro), _t(rd), _t(near), _t(far),
        tmd.MediumState.make(R, "cpu"), _t(pss), _t(uj),
        torch.ones(R, dtype=torch.bool))
    ro2 = _t(ro) + res1["t"][:, None] * _t(rd)
    pss2 = _t(pss) + torch.tensor([0, 0, 0, 1])
    res2, st2 = tmd.sample_distance(
        med, scene_seed, ro2, _t(rd), torch.zeros(R), torch.full((R,), 3.0),
        st, pss2, _t(uj), ~res1["exited"])
    return res1, res2, st2


def _jax_two_segments(med, scene_seed, ro, rd, pss, uj, near, far):
    R = ro.shape[0]
    res1, st = jmd.sample_distance(
        med, scene_seed, ro, rd, near, far, jmd.MediumState.make(R), pss, uj,
        jnp.ones(R, bool))
    ro2 = ro + res1["t"][:, None] * rd
    pss2 = pss + jnp.asarray([0, 0, 0, 1], jnp.uint32)
    res2, st2 = jmd.sample_distance(
        med, scene_seed, ro2, rd, jnp.zeros(R), jnp.full(R, 3.0), st, pss2,
        uj, ~res1["exited"])
    return res1, res2, st2


def _jset_params(scene, sigma, l):
    cov = dataclasses.replace(scene.media[0].gp.cov, sigma=sigma, l=l)
    med = dataclasses.replace(scene.media[0],
                              gp=dataclasses.replace(scene.media[0].gp,
                                                     cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


@pytest.fixture(scope="module")
def jax_two_segments(scenes):
    """JAX's two segments on the medium-level rays: the values and, as the
    aux output of one compile, jax.grad of sum(t1 + t2) over the rays that
    hit twice at the unperturbed parameters (the port then restricts the
    sum to the lanes that hit twice at every FD evaluation, a subset whose
    gradient it recomputes)."""
    jscene = scenes[0]
    ro, rd, pss, uj, near, far = (jnp.asarray(a)
                                  for a in _two_segment_rays())

    def run(sigma, l, mask):
        med = _jset_params(jscene, sigma, l).media[0]
        r1, r2, st2 = _jax_two_segments(med, jscene.scene_seed, ro, rd, pss,
                                        uj, near, far)
        return jnp.sum(jnp.where(mask, r1["t"] + r2["t"], 0.0)), (r1, r2,
                                                                  st2)

    cov = jscene.media[0].gp.cov
    mask = jnp.ones(ro.shape[0], bool)
    f = _compiled(jax.grad(run, argnums=(0, 1), has_aux=True), cov.sigma,
                  cov.l, mask)
    return f, cov


def test_sample_distance_two_segments_matches_jax(scenes, jax_two_segments):
    f, cov = jax_two_segments
    _, (jr1, jr2, jst) = f(cov.sigma, cov.l, jnp.ones(32, bool))
    tr1, tr2, tst = _port_two_segments(scenes[1].media[0],
                                       scenes[1].scene_seed,
                                       *_two_segment_rays())
    for jr, tr in ((jr1, tr1), (jr2, tr2)):
        jhit = ~np.asarray(jr["exited"])
        thit = ~tr["exited"].numpy()
        assert (jhit != thit).sum() <= 2
        both = jhit & thit
        assert both.sum() >= 16
        np.testing.assert_allclose(tr["t"].detach().numpy()[both],
                                   np.asarray(jr["t"])[both], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(tr["aniso"].detach().numpy()[both],
                                   np.asarray(jr["aniso"])[both], rtol=1e-3,
                                   atol=1e-3)
    # the second segment was conditioned at its start
    both = ~np.asarray(jr1["exited"]) & ~tr1["exited"].numpy()
    for k in ("value_scale", "gradient_scale", "ray_origin"):
        np.testing.assert_allclose(
            getattr(tst.coeff3, k).detach().numpy()[both],
            np.asarray(getattr(jst.coeff3, k))[both], rtol=1e-3, atol=1e-3,
            err_msg=k)
    assert np.abs(tst.coeff3.gradient_scale.detach().numpy()[both]).max() \
        > 0.01


def test_medium_level_grad_matches_jax_and_fd(scenes, jax_two_segments):
    tscene = scenes[1]
    rays = _two_segment_rays()
    R = rays[0].shape[0]

    def port(sigma, l):
        med = convert.set_params(tscene, sigma, l).media[0]
        r1, r2, _ = _port_two_segments(med, tscene.scene_seed, *rays)
        return r1, r2

    sigma0, l0 = (float(x) for x in entry.params(tscene))
    sigma = torch.tensor(sigma0, requires_grad=True)
    l = torch.tensor(l0, requires_grad=True)
    r1, r2 = port(sigma, l)
    f, cov = jax_two_segments
    for i, leaf in enumerate((sigma, l)):
        lanes, fd = fd_lanes(port, (sigma0, l0), i, FD_EPS)
        assert int(lanes.sum()) >= R // 4
        ad = float(torch.autograd.grad(
            torch.where(lanes, r1["t"] + r2["t"], 0.0).sum(), leaf,
            retain_graph=True)[0])
        jg, _ = f(cov.sigma, cov.l, jnp.asarray(lanes.numpy()))
        assert ad != 0.0
        np.testing.assert_allclose(ad, float(jg[i]), rtol=1e-3)
        np.testing.assert_allclose(ad, fd, rtol=0.15, atol=0.5)


def fd_lanes(port, params, i, eps):
    """(lanes, central FD of sum(t1 + t2) over them) in parameter i at step
    eps: the lanes that hit in both segments at every evaluation and whose
    t1 and t2 have central differences at eps and eps / 4 within 10% (+
    0.05) of each other.  A lane whose march decides its crossing
    differently across the stencil (another bracket, another refinement
    path) has no derivative that FD can resolve there."""
    def run(d):
        x = list(params)
        x[i] += d
        with torch.no_grad():
            a, b = port(torch.tensor(x[0]), torch.tensor(x[1]))
        return a["t"], b["t"], ~a["exited"] & ~b["exited"]

    c, (p, m), (p4, m4) = run(0.0), (run(eps), run(-eps)), (
        run(eps / 4), run(-eps / 4))
    lanes = c[2] & p[2] & m[2] & p4[2] & m4[2]
    for k in range(2):
        f1 = (p[k] - m[k]) / (2 * eps)
        f4 = (p4[k] - m4[k]) / (eps / 2)
        lanes &= (f1 - f4).abs() <= 0.1 * f1.abs() + 0.05
    fd = torch.where(lanes, p[0] + p[1] - m[0] - m[1], 0.0).sum() / (2 * eps)
    return lanes, float(fd)


def test_load_scene_equals_converted_jax_scene():
    jscene, _ = jload_scene(SCENE)
    tscene, rdoc = tload_scene(SCENE, device="cpu")
    assert rdoc["spp"] == 16 and tscene.camera.res_x == 256
    assert tscene.media[0].cfg.isotropic_3d
    a = convert.flatten(tscene)
    b = convert.flatten(convert.scene_from_numpy(convert.flatten(jscene),
                                                 device="cpu"))
    assert a.keys() == b.keys()
    for k, va in a.items():
        if isinstance(va, np.ndarray):
            assert va.dtype == b[k].dtype, k
            np.testing.assert_array_equal(va, b[k], err_msg=k)
        else:
            assert va == b[k], k


def test_grouped_train_step_equals_one_batch(monkeypatch):
    tscene, _ = tload_scene(SCENE, res_override=(2, 2), device="cpu")
    spp_idx = torch.arange(4)
    target = torch.full((2, 2, 3), 0.1)
    one = entry.train_step(tscene, target, spp_idx)
    calls = []

    def counted(scene, spp, rows=None):
        calls.append(torch.as_tensor(spp).numel())
        return render_pass(scene, spp, rows)

    monkeypatch.setattr(trender, "MAX_RAYS", 8)  # 2 samples a group
    monkeypatch.setattr(entry, "render_pass", counted)
    grouped = entry.train_step(tscene, target, spp_idx)
    assert calls == [2, 2, 2, 2]  # each group without, then with a graph
    for a, b in zip(grouped[:3] + grouped[3], one[:3] + one[3]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    assert all(float(g) != 0.0 for g in one[3])
