"""The port's hero slice (BASELINE config 5, `scenes/gpis-hero.json`:
multi-resolution procedural-nonstationary sparse-conv noise under the
Global context) against the JAX package, on the same numpy-seeded inputs.

Tolerances:
- fields, the covariance's amplitude, lateral scale, variance3 and
  transforms: rtol 1e-5 (log and exp round differently in XLA and
  PyTorch on the CPU).
- kernel_scale_level_ratio: the level scales exactly on points more than
  1e-4 of a level from a level boundary, the blend ratios rtol 1e-5 on
  points more than 0.02 of a level from one (nearer, a ratio tends to 0 and
  the last bit of ls, 4e-7 absolute, is a large part of it).
- K2's twin vs `sparse_conv_pallas.noise3d_sum(..., interpret=True)` with
  per-point kr and qm: rtol 1e-5, atol 1e-6 (the Pallas-vs-XLA tolerance
  of tests/test_pallas.py).
- the multi-resolution make_value_at vs JAX's (TUNGSTEN_TPU_PALLAS=1, K2
  in interpret mode) and vs eval_value: rtol 3e-4, atol 3e-5, the JAX
  package's own fast-vs-general tolerance for this branch
  (tests/test_sparse_conv_fast.py); gp ids exact.
- eval_value / eval_gradient vs the vmapped JAX functions: rtol 1e-4,
  atol 1e-5 (the 27 x K sums reduce in another order).
- sample_distance and transmittance: the same hit masks as JAX's default
  CPU path (the vmapped general evaluator, march_block=1).
- a 16x12 (non-square), 2-spp render vs the JAX CPU render: every pixel
  within 1e-3 * (1 + |ref|) (measured: within 2.7e-7, with JAX's fast
  path and K2 in interpret mode within 3.6e-7).
- a row-tiled render: equal to the untiled one bit for bit.
K2 on the card is held to its twin in tests/test_torch_kernels_cuda.py.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models.integrator import render_pass as jrender_pass
from tungsten_tpu.ops import fields as jfields
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_fast as jfast
from tungsten_tpu.ops import sparse_conv_pallas as jscp
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.kernels import noise3d
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import fields as tfields
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops import sparse_conv_fast as tfast
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene
from tungsten_tpu_torch.scene.parse import scene_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-hero.json")
CENTER = np.array([0.0, 0.9, 0.0], np.float32)
N = 300  # rays and points; one shape, so K2's interpret mode compiles once


@functools.lru_cache(maxsize=None)
def _scenes():
    """The hero as JAX loads it (march_block=1, so both march the same
    steps) and as the port converts it."""
    jscene, _ = jload_scene(SCENE)
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


def _points(n, seed, half=1.0):
    """n points in a cube of half-size `half` around the GPIS sphere."""
    r = np.random.default_rng(seed)
    return (CENTER + r.uniform(-half, half, (n, 3))).astype(np.float32)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = _points(n, seed + 100, 0.7)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    pss = r.integers(0, 2 ** 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    t = r.uniform(0.0, 1.0, n).astype(np.float32)
    return ro, rd, pss, t


def _t(a):
    return torch.from_numpy(np.array(a))


def test_load_scene_equals_converted_jax_scene():
    jscene, _ = jload_scene(SCENE)
    tscene, rdoc = tload_scene(SCENE, device="cpu")
    assert (tscene.camera.res_x, tscene.camera.res_y) == (1920, 1080)
    cov = tscene.media[0].gp.cov
    assert not cov.is_stationary and cov.max_ls == np.float32(3.2)
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


@pytest.mark.parametrize("doc", [
    "var", "ls",
    {"type": "noise", "noise": "front_back", "min": 0.3, "max": 2.0,
     "start": -0.5, "end": 0.5},
    {"type": "noise", "noise": "bottom_top_left_right", "min": 0.5,
     "max": 1.5, "min2": 2.0, "max2": 0.7, "start2": -1.0, "end2": 0.8},
    {"type": "constant", "value": 0.7}, 1.3])
def test_fields_match_jax(doc):
    if isinstance(doc, str):
        with open(SCENE) as fh:
            cov = json.load(fh)["media"][0]["gaussian_process"]["covariance"]
        doc = cov[doc]
    p = _points(4096, 1, 2.0)  # past both ends of every ramp
    jf, tf = jfields.parse_field(doc), tfields.parse_field(doc, "cpu")
    np.testing.assert_allclose(tf(_t(p)).numpy(), np.asarray(jf(p)),
                               rtol=1e-5, atol=0)
    assert tf.max_val() == jf.max_val()


def test_covariance_matches_jax():
    jscene, tscene = _scenes()
    jcov, tcov = jscene.media[0].gp.cov, tscene.media[0].gp.cov
    p = _points(N, 2)
    r = np.random.default_rng(2)
    s = np.float32(2.5) ** r.integers(-1, 3, N).astype(np.float32)
    kr_unit = np.float32(jcov.base.splat_radius(False, 1.0))
    kr = kr_unit * s
    v = r.normal(size=(N, 3)).astype(np.float32)
    dens = jscene.media[0].cfg.impulse_density
    for name in ("amplitude", "lateral_scale", "unscaled_variance"):
        np.testing.assert_allclose(getattr(tcov, name)(_t(p)).numpy(),
                                   np.asarray(getattr(jcov, name)(p)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        tcov.variance3(_t(dens), _t(kr), _t(s)).numpy(),
        np.asarray(jcov.variance3(p, dens, kr, False, s)), rtol=1e-5)
    np.testing.assert_allclose(tcov.splat_radius(_t(s)).numpy(),
                               np.asarray(jcov.splat_radius(False, s)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        np.diag(tcov.local_to_world_inv_transpose().numpy()),
        np.asarray(jcov.local_to_world_inv_transpose(p)), rtol=1e-5)
    for name in ("pos_world_to_local", "grad_world_to_local",
                 "grad_local_to_world"):
        np.testing.assert_allclose(
            getattr(tcov, name)(_t(v), _t(s)[:, None]).numpy(),
            np.asarray(jax.vmap(lambda v_i, s_i: getattr(jcov, name)(
                v_i, s_i))(v, s)), rtol=1e-5, err_msg=name)


def test_level_pair_matches_kernel_scale_level_ratio():
    jscene, tscene = _scenes()
    jmed, tmed = jscene.media[0], tscene.media[0]
    p = _points(4096, 3, 1.2)
    want = [np.asarray(x) for x in jsc.kernel_scale_level_ratio(
        jmed.cfg, jmed.gp, p)]
    lvl, *got = tsc.level_pair(tmed.gp, _t(p))
    got = [x.numpy() for x in got]
    ls = tmed.gp.cov.lateral_scale(_t(p)).numpy()
    x = np.log(ls.astype(np.float64)) / np.log(2.5)
    dist = np.abs(x - np.round(x))  # to the nearest boundary, in levels
    assert (dist > 1e-4).mean() > 0.99
    assert set(np.unique(lvl.numpy())) == {-1.0, 0.0, 1.0}
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a[dist > 1e-4], b[dist > 1e-4])
    # near a boundary one ratio tends to 0, and ls's last bit (an absolute
    # error of ~4e-7 there) is a large part of it
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a[dist > 0.02], b[dist > 0.02],
                                   rtol=1e-5)
    np.testing.assert_allclose(got[2] ** 2 + got[3] ** 2, 1.0, rtol=1e-5)


def _k2_inputs(n, seed=4):
    """Points, seeds and per-point kr, qm as the hero draws them: s in
    {0.4, 1, 2.5, 6.25}, seeds offset by the level with uint32 wrap (some
    seeds lie just below 2^32 or at 0 before the offset)."""
    _, tscene = _scenes()
    base = tscene.media[0].gp.cov.base
    r = np.random.default_rng(seed)
    p = _points(n, seed, 1.0)
    lvl = r.integers(-1, 3, n)
    s = np.float32(2.5) ** lvl.astype(np.float32)
    word = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    word[: n // 4] = 2 ** 32 - 1 - r.integers(0, 2, n // 4)
    word[n // 4: n // 2] = 0
    seed = ((word.astype(np.int64) + lvl) % 2 ** 32).astype(np.uint32)
    kr = float(base.splat_radius()) * s
    qm = (np.float32(1.0) / (s * s)).astype(np.float32)
    m6 = base.splat_form().tolist() + [0.0, 0.0, 0.0]
    return p, seed, kr.astype(np.float32), qm, m6


@pytest.mark.parametrize("K", [1, 3])
def test_k2_twin_matches_pallas_interpret(K):
    p, seed, kr, qm, m6 = _k2_inputs(N)
    want = np.asarray(jscp.noise3d_sum(
        jnp.asarray(p), jnp.asarray(seed), jnp.asarray(kr),
        jnp.asarray(m6, jnp.float32), qm=jnp.asarray(qm), impulse_count=K,
        interpret=True))
    got = noise3d.noise3d_sum(_t(p), _t(seed.astype(np.int64)), _t(kr),
                              _t(qm), m6, K)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_k2_wrapper_takes_the_twin_on_cpu_and_checks_inputs():
    p, seed, kr, qm, m6 = _k2_inputs(64)
    pt, st, krt, qmt = _t(p), _t(seed.astype(np.int64)), _t(kr), _t(qm)
    before = noise3d.K2_LAUNCHES
    out = noise3d.noise3d_sum(pt, st, krt, qmt, m6, 3)
    assert noise3d.K2_LAUNCHES == before  # the twin is not a launch
    np.testing.assert_array_equal(
        out.numpy(), noise3d.noise3d_sum_ref(pt, st, krt, qmt, m6,
                                             3).numpy())
    # the int32 words the kernel reads wrap, they do not saturate
    words = torch.tensor([2 ** 32 - 1, 2 ** 31, 5])
    assert words.to(torch.int32).tolist() == [-1, -2 ** 31, 5]
    for bad in ((pt, st, krt.double(), qmt), (pt, st, krt, qmt[:10]),
                (pt, st[:10], krt, qmt)):
        with pytest.raises(ValueError):
            noise3d.noise3d_sum(*bad, m6, 3)
    with pytest.raises(NotImplementedError):
        noise3d.noise3d_sum(pt, st, krt.requires_grad_(), qmt, m6, 3)


def test_make_value_at_multi_res_matches_jax_and_eval_value(monkeypatch):
    jscene, tscene = _scenes()
    jmed, tmed = jscene.media[0], tscene.media[0]
    ro, rd, pss, t = _rays(N, 5)
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jv, jid = jfast.make_value_at(
        jmed.cfg, jmed.gp, None, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(pss), jnp.uint32(9))(jnp.asarray(t))
    tpss = _t(pss.astype(np.int64))
    before = noise3d.LAUNCHES
    tv, tid = tfast.make_value_at(tmed.cfg, tmed.gp, _t(ro), _t(rd), tpss,
                                  9)(_t(t))
    assert noise3d.LAUNCHES == before
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    gv, gid = tsc.eval_value(tmed.cfg, tmed.gp, _t(ro + t[:, None] * rd),
                             tpss, 9)
    np.testing.assert_allclose(tv.numpy(), gv.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_array_equal(tid.numpy(), gid.numpy())


def test_eval_value_and_gradient_match_vmapped_jax():
    jscene, tscene = _scenes()
    jmed, tmed = jscene.media[0], tscene.media[0]
    ro, rd, pss, t = _rays(64, 6)
    p = ro + t[:, None] * rd
    zero = jsc.Coeffs.zero()

    def jboth(p_i, rd_i, pss_i):
        args = (jmed.cfg, jmed.gp, zero, zero, p_i, 0.0, rd_i, pss_i,
                jnp.uint32(9), 0.0)
        return jsc.eval_value(*args), jsc.eval_gradient(*args)

    (jv, jid), jg = jax.vmap(jboth)(jnp.asarray(p), jnp.asarray(rd),
                                    jnp.asarray(pss))
    tpss = _t(pss.astype(np.int64))
    tv, tid = tsc.eval_value(tmed.cfg, tmed.gp, _t(p), tpss, 9)
    tg = tsc.eval_gradient(tmed.cfg, tmed.gp, _t(p), tpss, 9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_global_context_shares_one_realization_across_bounces():
    jscene, tscene = _scenes()
    jcfg, tcfg = jscene.media[0].cfg, tscene.media[0].cfg
    assert tcfg.ctxt == tsc.CTXT_GLOBAL and not tcfg.activate_conditioning
    _, _, pss, _ = _rays(64, 7)
    seeds = []
    for bounce in (0, 1):
        pss[:, 3] = bounce
        want = np.asarray(jsc.compute_seed(jcfg, jnp.asarray(pss),
                                           jnp.uint32(9)))
        got = tsc.compute_seed(tcfg, _t(pss.astype(np.int64)), 9).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        seeds.append(got)
    np.testing.assert_array_equal(seeds[0], seeds[1])


def test_media_match_jax():
    """sample_distance and transmittance on 128 rays from inside the
    bounding cube, half of them starting at a surface."""
    jscene, tscene = _scenes()
    jmed, tmed = jscene.media[0], tscene.media[0]
    n = 128
    ro, rd, pss, _ = _rays(n, 8)
    r = np.random.default_rng(8)
    uj = r.uniform(size=n).astype(np.float32)
    first = np.arange(n) % 2 == 0
    active = np.arange(n) % 13 != 0
    far = np.full(n, 3.0e38, np.float32)
    seg = np.full(n, 0.8, np.float32)

    @jax.jit
    def jrun(ro, rd, far, seg, first, pss, uj, active):
        st = dataclasses.replace(jmd.MediumState.make(n), first_scatter=first)
        res, _ = jmd.sample_distance(jmed, jscene.scene_seed, ro, rd,
                                     jnp.zeros(n), far, st, pss, uj, active)
        tr = jmd.transmittance(jmed, jscene.scene_seed, ro, rd, jnp.zeros(n),
                               seg, st, pss, uj, active)
        return res["exited"], res["t"], tr

    jexit, jt, jtr = (np.asarray(x) for x in jrun(*(jnp.asarray(x) for x in (
        ro, rd, far, seg, first, pss, uj, active))))
    st = dataclasses.replace(tmd.MediumState.make(n, "cpu"),
                             first_scatter=_t(first))
    args = (_t(ro), _t(rd), torch.zeros(n))
    rest = (st, _t(pss.astype(np.int64)), _t(uj), _t(active))
    tres, _ = tmd.sample_distance(tmed, tscene.scene_seed, *args, _t(far),
                                  *rest)
    ttr = tmd.transmittance(tmed, tscene.scene_seed, *args, _t(seg),
                            *rest).numpy()
    thit = ~tres["exited"].numpy()
    assert n // 4 < thit.sum() < n - n // 10
    np.testing.assert_array_equal(thit, ~jexit)
    np.testing.assert_allclose(tres["t"].numpy()[thit], jt[thit], atol=1e-4,
                               rtol=0)
    assert 0 < (ttr[:, 0] > 0).sum() < n
    np.testing.assert_array_equal(ttr[:, 0] > 0, jtr[:, 0] > 0)


@functools.lru_cache(maxsize=None)
def _port_render_16x12():
    _, tscene = _scenes()
    tscene = dataclasses.replace(tscene, camera=dataclasses.replace(
        tscene.camera, res_x=16, res_y=12))
    return tscene, trender.render(tscene, 2, device="cpu").numpy()


def test_render_16x12_matches_jax():
    jscene, _ = jload_scene(SCENE, res_override=(16, 12))
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    f = jax.jit(jrender_pass)
    ref = sum(np.asarray(f(jscene, jnp.int32(s))) for s in range(2))
    _, got = _port_render_16x12()
    assert got.shape == (12, 16, 3) and np.isfinite(got).all()
    assert ref.mean() > 0.05
    np.testing.assert_array_less(np.abs(got - ref),
                                 1e-3 * (1.0 + np.abs(ref)) + 1e-12)


def test_tiled_render_equals_untiled(monkeypatch):
    tscene, untiled = _port_render_16x12()
    # 80 rays per batch: bands of 5 rows (the last of 2), one sample at a
    # time
    monkeypatch.setattr(trender, "MAX_RAYS", 80)
    bands = []
    orig = trender.render_pass

    def spy(scene, spp_idx, rows=None):
        bands.append(rows)
        return orig(scene, spp_idx, rows)

    monkeypatch.setattr(trender, "render_pass", spy)
    tiled = trender.render(tscene, 2, device="cpu").numpy()
    assert bands == [(0, 5), (5, 10), (10, 12)] * 2
    np.testing.assert_array_equal(tiled, untiled)


@pytest.mark.parametrize("edit, what", [
    (lambda m, c: m.update(transmittance={"type": "linear"}),
     "transmittance"),
    (lambda m, c: m.update(correlation_context="bogus"),
     "correlation_context"),
    (lambda m, c: m.update(phase_function={"type": "isotropic"}),
     "phase function"),
    (lambda m, c: c.update(cov={"type": "rational_quadratic"}),
     "RationalQuadraticCov"),
    (lambda m, c: m.update(type="homogeneous"), "medium type"),
])
def test_parser_refuses_what_the_slice_does_not_port(edit, what):
    with open(SCENE) as fh:
        doc = json.load(fh)
    med = doc["media"][0]
    edit(med, med["gaussian_process"]["covariance"])
    with pytest.raises(NotImplementedError, match=what):
        scene_from_dict(doc, device="cpu")


def test_hero_cli_renders_without_importing_jax(tmp_path):
    out = tmp_path / "hero.png"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['render', {SCENE!r}, '--spp', '1', '--res', '4x3',\n"
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
    img = timage.read_pfm(str(tmp_path / "hero.pfm"))
    assert img.shape == (3, 4, 3) and np.isfinite(img).all()
