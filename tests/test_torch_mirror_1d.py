"""The port's mirror-1d slice (BASELINE configs 3 and 3b: 1D sparse-conv
sampling, renewal+ conditioning, mirror NEE/MIS) against the JAX package,
on the same numpy-seeded inputs.

Tolerances:
- K3's twin vs `sparse_conv_pallas.noise1d_sum(..., interpret=True)`:
  equal bits when the twin uses XLA's exp; with PyTorch's exp (which
  rounds differently from XLA's on the CPU) rtol 1e-5, atol 1e-6
  (measured 4.8e-7 on sums of up to 9 terms).
- make_value_at_1d vs `sparse_conv_fast.make_value_at_1d` with
  TUNGSTEN_TPU_PALLAS=1 (K3 in interpret mode) and nonzero conditioning
  coefficients: rtol 1e-5, atol 1e-6 (measured 1.5e-7); gp ids exact.
- eval_gradient_noise1d, eval_value (1D), conditioning_1d, nee_grad and
  nee_pdf (batched) vs the vmapped JAX functions, correlationXY off and on:
  rtol 1e-4,
  atol 1e-5 (the 3 x K sums reduce in another order, exp and the 3x3
  inverse round differently: nee_pdf inverts by the adjugate, JAX by LU;
  measured at most 7% of that bound, 3.8e-6 on gradients).
- The mirror BSDF and `sampling_scheme`: exact (lambert's sampled
  directions within rtol 1e-6, atol 1e-7: cos and sin round differently).
- `media.sample_distance` and `transmittance` of config 3's medium on rays
  with mixed first_scatter and carried state, JAX on its fast 1D path
  (TUNGSTEN_TPU_FAST_MARCH=1, TUNGSTEN_TPU_PALLAS=1, march_block=1, the
  path whose rounding the port follows): equal hit masks; t, the normals
  and the new conditioning coefficients within 1e-5 * (1 + |x|) (measured
  3.7e-6 on the normals, 3.6e-7 on t); equal transmittance.
- `load_scene` and `convert.scene_from_numpy(<JAX scene>)`: equal leaf by
  leaf, for both scenes.
The 16x16 renders of both scenes are held to JAX's in
tests/test_torch_mirror_1d_render.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import bsdfs as jbs
from tungsten_tpu.models import media as jmd
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_fast as jfast
from tungsten_tpu.ops import sparse_conv_pallas as jscp
from tungsten_tpu.ops.covariance import SquaredExponentialCov as JSE
from tungsten_tpu.ops.means import SphericalMean as JSphere
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert
from tungsten_tpu_torch.kernels import noise1d
from tungsten_tpu_torch.models import bsdfs as tbs
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.models import phase as tph
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops import sparse_conv_fast as tfast
from tungsten_tpu_torch.ops.covariance import SquaredExponentialCov
from tungsten_tpu_torch.ops.means import SphericalMean
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {False: os.path.join(ROOT, "scenes", "gpis-mirror-1d.json"),
          True: os.path.join(ROOT, "scenes", "gpis-mirror-1d-corrxy.json")}
SIGMA, L, ANISO = 0.06, 0.12, (1.0, 1.7, 0.6)
CENTER, RADIUS = (0.0, 0.9, 0.0), 0.45
SCENE_SEED = 9
N = 256


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _gps(sigma=SIGMA):
    jgp = jsc.GP(mean=JSphere.create(center=CENTER, radius=RADIUS),
                 cov=JSE.create(sigma=sigma, l=L, aniso=ANISO))
    tgp = tsc.GP(mean=SphericalMean(center=_f32(CENTER), radius=_f32(RADIUS)),
                 cov=SquaredExponentialCov(sigma=_f32(sigma), l=_f32(L),
                                           aniso=_f32(ANISO)))
    return jgp, tgp


def _cfgs(corr_xy, single=False):
    kw = dict(global_seed=42, impulse_density=3.0, ctxt=jsc.CTXT_RENEWAL_PLUS,
              use_single_realization=single, one_d=True,
              scheme=jsc.SCHEME_MIS, correlation_xy=corr_xy)
    return (jsc.SparseConvConfig.create(**kw),
            tsc.SparseConvConfig.create(device="cpu", **kw))


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(n, seed):
    """Rays around the GPIS sphere, their words, distances along them and
    conditioning coefficients with origins behind them."""
    r = np.random.default_rng(seed)
    ro = (r.uniform(-0.7, 0.7, (n, 3)) + CENTER).astype(np.float32)
    rd = _unit(r, n)
    pss = r.integers(0, 50, (n, 4)).astype(np.uint32)
    t = r.uniform(0.0, 1.0, n).astype(np.float32)
    coeffs = (r.normal(0.0, 0.5, n).astype(np.float32),
              r.normal(0.0, 0.3, (n, 3)).astype(np.float32),
              (ro - rd * r.uniform(0.0, 0.3, (n, 1))).astype(np.float32))
    return ro, rd, pss, t, coeffs


def _jcoeffs(c):
    return jsc.Coeffs(value_scale=jnp.asarray(c[0]),
                      gradient_scale=jnp.asarray(c[1]),
                      ray_origin=jnp.asarray(c[2]))


def _tcoeffs(c):
    return tsc.Coeffs(*(torch.from_numpy(x) for x in c))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pss(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# K3 and the march evaluator
# ---------------------------------------------------------------------------

def _k3_inputs(n=4096):
    r = np.random.default_rng(21)
    pz = r.uniform(-4.0, 4.0, n).astype(np.float32)
    seed = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return pz, seed


@pytest.mark.parametrize("exp", ["xla", "torch"])
@pytest.mark.parametrize("K", [1, 3])
def test_k3_twin_matches_pallas_interpret(K, exp, monkeypatch):
    pz, seed = _k3_inputs()
    assert (pz < 0).any()  # negative cells are included
    want = np.asarray(jscp.noise1d_sum(jnp.asarray(pz), jnp.asarray(seed),
                                       3.0, impulse_count=K, interpret=True))
    if exp == "xla":
        monkeypatch.setattr(torch, "exp", lambda x: torch.from_numpy(
            np.array(jnp.exp(jnp.asarray(x.numpy())))))
    got = noise1d.noise1d_sum(torch.from_numpy(pz),
                              torch.from_numpy(seed.astype(np.int64)), 3.0,
                              K).numpy()
    if exp == "xla":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_k3_wrapper_takes_the_twin_on_cpu_and_checks_inputs():
    pz, seed = _k3_inputs(64)
    pz, seed = torch.from_numpy(pz), torch.from_numpy(seed.astype(np.int64))
    before = noise1d.LAUNCHES
    out = noise1d.noise1d_sum(pz, seed, 3.0, 3)
    assert noise1d.LAUNCHES == before  # the twin is not a kernel launch
    np.testing.assert_array_equal(
        out.numpy(), noise1d.noise1d_sum_ref(pz, seed, 3.0, 3).numpy())
    assert noise1d.reciprocal(3.0) == (3.0, float(np.float32(1) / 3))
    with pytest.raises(ValueError):
        noise1d.noise1d_sum(pz.double(), seed, 3.0, 3)
    with pytest.raises(ValueError):
        noise1d.noise1d_sum(pz, seed[:10], 3.0, 3)
    with pytest.raises(NotImplementedError):
        noise1d.noise1d_sum(pz.requires_grad_(), seed, 3.0, 3)


@pytest.mark.parametrize("corr_xy", [False, True])
def test_make_value_at_1d_matches_jax(corr_xy, monkeypatch):
    jgp, tgp = _gps()
    jcfg, tcfg = _cfgs(corr_xy)
    ro, rd, pss, t, coeffs = _rays(N, seed=5)
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jva = jfast.make_value_at_1d(jcfg, jgp, _jcoeffs(coeffs), jnp.asarray(ro),
                                 jnp.asarray(rd), jnp.asarray(pss),
                                 jnp.uint32(SCENE_SEED))
    jv, jid = jva(jnp.asarray(t))
    tva = tfast.make_value_at_1d(tcfg, tgp, _tcoeffs(coeffs), _t(ro), _t(rd),
                                 _pss(pss), SCENE_SEED)
    tv, tid = tva(_t(t))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


# ---------------------------------------------------------------------------
# Gradient, conditioning and mirror NEE (per-ray JAX functions, vmapped)
# ---------------------------------------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("corr_xy", [False, True])
def test_gradient_and_conditioning_match_vmapped_jax(corr_xy):
    jgp, tgp = _gps()
    jcfg, tcfg = _cfgs(corr_xy)
    ro, rd, pss, t, coeffs = _rays(64, seed=6)
    p = ro + t[:, None] * rd
    t_seg = np.where(np.arange(64) % 4 == 0, 0.0, t).astype(np.float32)
    r = np.random.default_rng(7)
    target_val = r.normal(0.0, 0.05, 64).astype(np.float32)
    target_grad = _unit(r, 64)
    seed = jnp.uint32(SCENE_SEED)

    jg = jax.vmap(lambda c, p_i, ts, d, s: jsc.eval_gradient_noise1d(
        jcfg, jgp, c, p_i, ts, ts, d, s, seed, True))(
        _jcoeffs(coeffs), jnp.asarray(p), jnp.asarray(t_seg), jnp.asarray(rd),
        jnp.asarray(pss))
    tg = tsc.eval_gradient_noise1d(tcfg, tgp, _tcoeffs(coeffs), _t(p),
                                   _t(t_seg), _t(rd), _pss(pss), SCENE_SEED,
                                   True)
    _close(tg, jg)
    jzero = jsc.Coeffs.zero()
    jv, jid = jax.vmap(lambda c, p_i, d, s: jsc.eval_value(
        jcfg, jgp, jzero, c, p_i, 0.0, d, s, seed, 0.0))(
        _jcoeffs(coeffs), jnp.asarray(p), jnp.asarray(rd), jnp.asarray(pss))
    tv, tid = tsc.eval_value(tcfg, tgp, _t(p), _pss(pss), SCENE_SEED,
                             ray_dir=_t(rd), coeff1=_tcoeffs(coeffs))
    _close(tv, jv)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    # the start-of-segment draw differs from the others
    assert not np.allclose(tg.numpy()[t_seg == 0], tg.numpy()[t_seg != 0][
        :int((t_seg == 0).sum())])

    jc = jax.vmap(lambda p_i, d, v, g, s: jsc.conditioning_1d(
        jcfg, jgp, p_i, d, v, g, s, seed, 0.0))(
        jnp.asarray(p), jnp.asarray(rd), jnp.asarray(target_val),
        jnp.asarray(target_grad), jnp.asarray(pss))
    tc = tsc.conditioning_1d(tcfg, tgp, _t(p), _t(rd), _t(target_val),
                             _t(target_grad), _pss(pss), SCENE_SEED)
    for f in ("value_scale", "gradient_scale", "ray_origin"):
        _close(getattr(tc, f), getattr(jc, f))
    assert (tc.gradient_scale.numpy()[:, :2] != 0).any() == corr_xy


@pytest.mark.parametrize("corr_xy", [False, True])
def test_nee_grad_and_pdf_match_vmapped_jax(corr_xy):
    jgp, tgp = _gps()
    jcfg, tcfg = _cfgs(corr_xy)
    ro, rd, pss, t, coeffs = _rays(64, seed=8)
    p = ro + t[:, None] * rd
    t_seg = np.where(np.arange(64) % 4 == 0, 0.0, t).astype(np.float32)
    r = np.random.default_rng(9)
    # half vectors between the reversed ray and a light direction
    normal = -rd + _unit(r, 64)
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)
              ).astype(np.float32)
    seed = jnp.uint32(SCENE_SEED)
    jargs = (_jcoeffs(coeffs), jnp.asarray(rd), jnp.asarray(normal),
             jnp.asarray(p), jnp.asarray(pss))
    targs = (_tcoeffs(coeffs), _t(rd), _t(normal), _t(p), _pss(pss))

    jgr = jax.vmap(lambda c, d, n, p_i, s: jsc.nee_grad(
        jcfg, jgp, c, d, n, p_i, s, seed, 0.0))(*jargs)
    _close(tsc.nee_grad(tcfg, tgp, *targs, SCENE_SEED), jgr)

    jpdf = np.asarray(jax.vmap(lambda c, d, n, p_i, s, ts: jsc.nee_pdf(
        jcfg, jgp, c, d, n, p_i, ts, s, seed, 0.0))(
        *jargs, jnp.asarray(t_seg)))
    tpdf = tsc.nee_pdf(tcfg, tgp, *targs[:4], _t(t_seg), targs[4],
                       SCENE_SEED)
    _close(tpdf, jpdf)
    # some planes lie behind (pdf 0), others give a positive pdf
    assert (jpdf == 0).any() and (jpdf > 0).sum() > 4


def test_mirror_bsdf_and_sampling_scheme_match_jax():
    rows = [{"kind": k, "albedo": a} for k, a in (
        (tbs.LAMBERT, (0.5, 0.6, 0.7)), (tbs.MIRROR, (0.9, 0.8, 0.7)),
        (tbs.NULL, (1.0, 1.0, 1.0)), (tbs.FORWARD, (1.0, 1.0, 1.0)))]
    jt = jbs.build_table(rows)
    tt = tbs.build_table(rows, "cpu")
    r = np.random.default_rng(10)
    n = 64
    bi = (np.arange(n) % 4).astype(np.int32)
    wi, wo = _unit(r, n), _unit(r, n)
    u = r.uniform(size=(n, 5)).astype(np.float32)
    js = jax.vmap(lambda b, w, uu: jbs.sample_bsdf(jt, b, w, uu))(
        jnp.asarray(bi), jnp.asarray(wi), jnp.asarray(u))
    ts = tbs.sample_bsdf(tt, _t(bi.astype(np.int64)), _t(wi), _t(u))
    mirror = bi == 1  # the mirror row
    for k in ("wo", "weight", "pdf", "specular", "valid"):
        got, want = ts[k].numpy(), np.asarray(js[k])
        # cosine-hemisphere directions round as cos/sin do in each library
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_array_equal(got[mirror], want[mirror], err_msg=k)
    for fn in ("eval_bsdf", "pdf_bsdf"):
        jv = jax.vmap(lambda b, a, c: getattr(jbs, fn)(jt, b, a, c))(
            jnp.asarray(bi), jnp.asarray(wi), jnp.asarray(wo))
        tv = getattr(tbs, fn)(tt, _t(bi.astype(np.int64)), _t(wi), _t(wo))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=fn)
    np.testing.assert_array_equal(
        tbs.is_pure_specular(tt, _t(bi.astype(np.int64))).numpy(),
        np.asarray(jax.vmap(lambda b: jbs.is_pure_specular(jt, b))(
            jnp.asarray(bi))))

    p = _rays(32, seed=11)[0]
    for sigma, single in ((SIGMA, False), (0.0, False), (SIGMA, True)):
        jgp, tgp = _gps(sigma)
        jcfg, tcfg = _cfgs(False, single)
        want = np.asarray(jax.vmap(lambda q: jsc.sampling_scheme(
            jcfg, jgp, q))(jnp.asarray(p)))
        got = tsc.sampling_scheme(tcfg, tgp, _t(p)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == jsc.SCHEME_MIS).all() == (sigma > 0 and not single)


# ---------------------------------------------------------------------------
# The medium, the scene and the render
# ---------------------------------------------------------------------------

def _jscene(corr_xy, res=None):
    jscene, _ = jload_scene(SCENES[corr_xy], res_override=res)
    return dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))


def _medium_inputs():
    """256 rays from inside and outside the GPIS sphere; a quarter start at
    a surface with carried coefficients, the others inside the medium with
    a carried value, normal and path length."""
    r = np.random.default_rng(3)
    u = _unit(r, N)
    rad = np.where(np.arange(N) % 2 == 0, r.uniform(0.0, 0.35, N),
                   r.uniform(0.55, 0.7, N))
    ro = (np.asarray(CENTER) + u * rad[:, None]).astype(np.float32)
    rd = _unit(r, N)
    first = np.arange(N) % 4 == 0
    pss = r.integers(0, 64, (N, 4)).astype(np.uint32)
    uj = r.uniform(size=N).astype(np.float32)
    active = np.ones(N, bool)
    active[::17] = False
    state = dict(first_scatter=first,
                 last_val=r.normal(0.0, 0.02, N).astype(np.float32),
                 last_aniso=_unit(r, N),
                 info_t=r.uniform(0.0, 2.0, N).astype(np.float32))
    coeffs = (r.normal(0.0, 0.5, N).astype(np.float32),
              r.normal(0.0, 0.2, (N, 3)).astype(np.float32),
              (ro - rd * 0.1).astype(np.float32))
    return ro, rd, pss, uj, active, state, coeffs


def _states(state, coeffs):
    js = dataclasses.replace(
        jmd.MediumState.make(N), coeff1=_jcoeffs(coeffs),
        **{k: jnp.asarray(v) for k, v in state.items()})
    ts = dataclasses.replace(
        tmd.MediumState.make(N, "cpu"), coeff1=_tcoeffs(coeffs),
        **{k: _t(v) for k, v in state.items()})
    return js, ts


def _near(got, want):
    """Within 1e-5 * (1 + |want|) elementwise."""
    want = np.asarray(want)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= 1e-5, err.max()


@pytest.mark.parametrize("corr_xy", [False, True])
def test_medium_matches_jax_fast_path(corr_xy, monkeypatch):
    monkeypatch.setenv("TUNGSTEN_TPU_FAST_MARCH", "1")
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jscene = _jscene(corr_xy)
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    jmed, tmed = jscene.media[0], tscene.media[0]
    ro, rd, pss, uj, active, state, coeffs = _medium_inputs()
    js, ts = _states(state, coeffs)
    far = np.full(N, 3.0e38, np.float32)
    jargs = (jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(N), jnp.asarray(far),
             js, jnp.asarray(pss), jnp.asarray(uj), jnp.asarray(active))
    targs = (_t(ro), _t(rd), torch.zeros(N), _t(far), ts, _pss(pss), _t(uj),
             _t(active))

    jres, jst = jax.jit(lambda *a: jmd.sample_distance(
        jmed, jscene.scene_seed, *a))(*jargs)
    tres, tst = tmd.sample_distance(tmed, tscene.scene_seed, *targs)
    jhit, thit = ~np.asarray(jres["exited"]), ~tres["exited"].numpy()
    assert thit.sum() > N // 4 and (~thit[active]).sum() > N // 10
    np.testing.assert_array_equal(thit, jhit)
    _near(tres["t"].numpy()[thit], jres["t"][thit])
    _near(tres["aniso"].numpy()[active], jres["aniso"][active])
    for k in ("failed", "scheme"):
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
    for f in ("value_scale", "gradient_scale", "ray_origin"):
        _near(getattr(tst.coeff1, f).numpy(), getattr(jst.coeff1, f))
    for f in ("last_val", "info_t"):
        _near(getattr(tst, f).numpy(), getattr(jst, f))

    # shadow segments of length 0.8
    jargs = jargs[:3] + (jnp.full(N, 0.8, jnp.float32),) + jargs[4:]
    targs = targs[:3] + (torch.full((N,), 0.8),) + targs[4:]
    jtr = np.asarray(jax.jit(lambda *a: jmd.transmittance(
        jmed, jscene.scene_seed, *a))(*jargs))
    ttr = tmd.transmittance(tmed, tscene.scene_seed, *targs).numpy()
    assert 0 < (ttr[:, 0] > 0).sum() < N
    np.testing.assert_array_equal(ttr, jtr)


@pytest.mark.parametrize("corr_xy", [False, True])
def test_load_scene_equals_converted_jax_scene(corr_xy):
    jscene, _ = jload_scene(SCENES[corr_xy])
    tscene, rdoc = tload_scene(SCENES[corr_xy], device="cpu")
    assert rdoc["spp"] == 16 and tscene.camera.res_x == 128
    med = tscene.media[0]
    assert med.cfg.one_d and med.cfg.scheme == tsc.SCHEME_MIS
    assert med.cfg.correlation_xy == corr_xy
    assert tph.phase_is_specular(med, tscene.bsdfs)
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


def test_parser_refuses_what_the_slice_leaves_out():
    from tungsten_tpu_torch.scene.parse import scene_from_dict
    import json
    with open(SCENES[False]) as f:
        doc = json.load(f)
    for field, value, what in (
            ("correlation_context", "bogus", "correlation_context"),
            ("transmittance", {"type": "linear"}, "transmittance"),
            ("1D_sampling_scheme", "bogus", "scheme")):
        d = json.loads(json.dumps(doc))
        d["media"][0][field] = value
        with pytest.raises(NotImplementedError, match=what):
            scene_from_dict(d, device="cpu")
    d = json.loads(json.dumps(doc))
    d["media"][0]["phase_function"] = {"type": "isotropic"}
    with pytest.raises(NotImplementedError, match="phase function"):
        scene_from_dict(d, device="cpu")
    d = json.loads(json.dumps(doc))
    d["primitives"][0]["bsdf"] = {"type": "conductor"}
    with pytest.raises(NotImplementedError, match="conductor"):
        scene_from_dict(d, device="cpu")


def test_loaders_on_cuda_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tload_scene(SCENES[False])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.scene_from_numpy(convert.flatten(_jscene(False)))
