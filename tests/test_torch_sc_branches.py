"""The port's sparse-convolution branches beside the ones BASELINE runs
(tungsten_tpu_torch/ops/sparse_conv.py, sparse_conv_fast.py,
nonstationary.py, covariance.py) against tungsten_tpu/ops/sparse_conv.py
and sparse_conv_fast.py on the CPU: brute-force nonstationary noise
(`multiResolutionGrid: false`), isotropic-ray and plain isotropic 3D
sampling of the multi-resolution and brute-force nonstationary fields,
their renewal+ conditioning, the multi-resolution 1D branches (value,
gradient, conditioning, the mirror NEE), renewal conditioning of 1D
realizations, anisoMtx under 1D and isotropic sampling, and the
surface/volume phase id.

The scenes are tools/gp_variants.py's, parsed by the JAX package and
carried across (`convert.scene_from_numpy`); the port's own parse of each
gives the same tree.  Inputs are seeded numpy points along seeded rays
inside each scene's medium.  The seeds and the gp ids are equal (hash
streams, bit for bit); floats within rtol 1e-5 and atol 1e-6 times the
quantity's scale (the largest entry of JAX's values, gradients,
coefficients or pdfs; a value is amplitude x noise + the mean, whose ulp
it carries near the surface), the Pallas-vs-twin tolerance (the gradient
under an anisoMtx within atol 1e-5 times its scale: the matrix's inverse
is an LU solve in JAX and the adjugate here; measured up to 7.4e-6
absolute on gradients up to 2.9): the lattice sums
are the same terms added in other orders, and the isotropic frames, level
blends and conditioning splats round differently.  JAX's march-step
evaluator runs as its tests run it on the CPU, its lattice sum through
the XLA twin (TUNGSTEN_TPU_PALLAS=0).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_fast as jfast
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops import sparse_conv_fast as tfast
from tungsten_tpu_torch.scene.parse import scene_from_dict
from tungsten_tpu_torch.tools.gp_variants import variant_docs

RTOL, ATOL = 1e-5, 1e-6
# the gradient under an anisoMtx: its world <-> isotropic transforms are
# the matrix's inverse, by LU in the JAX package and by the adjugate here
ATOL_MTX = 1e-5
SEED = 9
R = 48
THREE_D = ("hero-bruteforce", "hero-iso", "hero-renewal", "hero-surfvol",
           "box-iso", "box-iso-aniso")
ONE_D = ("hero-1d", "m1d-renewal", "m1d-aniso")


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    return {k: v[1] for k, v in variant_docs(
        str(tmp_path_factory.mktemp("sc_variants"))).items()}


def _scenes(doc, **medium):
    doc = json.loads(json.dumps(doc))
    doc["media"][0].update(medium)
    jscene, _ = jscene_from_dict(doc)
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    return jscene, tscene, doc


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(seed, center=(0.0, 0.9, 0.0), spread=0.5):
    """Rays through the medium, points at t along them, pss words and
    conditioning targets (value, gradient) at the rays' starts."""
    r = np.random.default_rng(seed)
    ro = (np.asarray(center) + r.uniform(-spread, spread, (R, 3))).astype(
        np.float32)
    rd = r.normal(size=(R, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    t = r.uniform(0.0, 0.3, R).astype(np.float32)
    pss = np.stack([r.integers(0, 64, R), r.integers(0, 64, R),
                    r.integers(0, 4, R), r.integers(0, 3, R)],
                   -1).astype(np.uint32)
    tv = r.uniform(0.0, 0.05, R).astype(np.float32)
    tg = (-rd + 0.3 * r.normal(size=(R, 3))).astype(np.float32)
    return ro, rd, t, pss, tv, tg


def _coeffs(jmed, ro, rd, pss, tv, tg):
    """JAX's conditioning coefficients at the rays' starts."""
    z = jsc.Coeffs.zero()
    return jax.vmap(lambda p, d, v, g, s: jsc.conditioning(
        jmed.cfg, jmed.gp, z, z, p, d, v, g, s, jnp.uint32(SEED),
        jnp.float32(0.0)))(ro, rd, tv, tg, pss)


def _close(got, want, scale, what, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > RTOL * np.abs(want) + atol * scale
    assert not bad.any(), (what, np.abs(got - want).max(),
                           np.argwhere(bad)[:4])


def _cond_ctxt(name):
    return {"hero-1d": {"correlation_context": "renewal+",
                        "1D_gradient_correlationXY": True},
            "hero-bruteforce": {"correlation_context": "renewal+"},
            "hero-iso": {"correlation_context": "renewal+"}}.get(name, {})


@pytest.mark.parametrize("name", THREE_D + ONE_D)
def test_port_parse_equals_converted_jax_scene(docs, name):
    jscene, tscene, doc = _scenes(docs[name])
    a = convert.flatten(scene_from_dict(doc, device="cpu")[0])
    b = convert.flatten(tscene)
    assert a.keys() == b.keys()
    for k, va in a.items():
        if isinstance(va, np.ndarray):
            np.testing.assert_allclose(va, b[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            assert va == b[k], k


@pytest.mark.parametrize("name", THREE_D + ONE_D)
def test_conditioning_and_evaluators_match_jax(docs, name):
    """The conditioning coefficients at the rays' starts (where the
    context conditions: the 3D variants' under their own or a renewal+
    context, the 1D ones as given), then eval_value, eval_gradient and
    the gp id at points along the rays."""
    jscene, tscene, _ = _scenes(docs[name], **_cond_ctxt(name))
    jmed, tmed = jscene.media[0], tscene.media[0]
    ro, rd, t, pss, tv, tg = _rays(3)
    tpss = _t(pss.astype(np.int64))
    zero = tsc.Coeffs.zeros(R, "cpu")
    j3, j1 = _coeffs(jmed, ro, rd, pss, tv, tg)
    t3, t1 = tsc.conditioning(tmed.cfg, tmed.gp, zero, zero, _t(ro), _t(rd),
                              _t(tv), _t(tg), tpss, SEED)
    jc = j1 if tmed.cfg.one_d else j3
    tc = t1 if tmed.cfg.one_d else t3
    if tmed.cfg.activate_conditioning:
        for f in ("value_scale", "gradient_scale"):
            _close(getattr(tc, f).numpy(), getattr(jc, f), 1.0, f)
    c3 = convert.coeffs_from_numpy(j3, device="cpu")
    c1 = convert.coeffs_from_numpy(j1, device="cpu")
    p = ro + t[:, None] * rd

    def jboth(c3_i, c1_i, p_i, t_i, rd_i, pss_i):
        args = (jmed.cfg, jmed.gp, c3_i, c1_i, p_i, t_i, rd_i, pss_i,
                jnp.uint32(SEED), jnp.float32(0.0))
        return jsc.eval_value(*args), jsc.eval_gradient(*args)

    (jv, jid), jg = jax.vmap(jboth)(j3, j1, p, t, rd, pss)
    tv_, tid = tsc.eval_value(tmed.cfg, tmed.gp, _t(p), tpss, SEED,
                              ray_dir=_t(rd), coeff1=c1, coeff3=c3)
    tg_ = tsc.eval_gradient(tmed.cfg, tmed.gp, _t(p), tpss, SEED,
                            ray_dir=_t(rd), t_segment=_t(t), coeff1=c1,
                            coeff3=c3)
    _close(tv_.numpy(), jv, float(np.abs(np.asarray(jv)).max()), "value")
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    gscale = float(np.abs(np.asarray(jg)).max())
    _close(tg_.numpy(), jg, gscale, "gradient",
           ATOL_MTX if "aniso" in name else ATOL)
    if name == "hero-surfvol":
        assert set(np.unique(tid.numpy())) == {0, 1}


@pytest.mark.parametrize("name, medium", [
    (n, m) for n in THREE_D for m in ({}, {"correlation_context": "renewal+"})
    if not (m and n == "hero-renewal")] + [
    ("m1d-renewal", {}), ("m1d-aniso", {})])
def test_march_evaluator_matches_jax(docs, name, medium, monkeypatch):
    """The march's value_at (K1, K2 or K3 through their twins here) against
    JAX's fast path (its lattice sums through the XLA twin), with the
    conditioning splat where the context conditions, and the gp ids."""
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "0")
    jscene, tscene, _ = _scenes(docs[name], **medium)
    jmed, tmed = jscene.media[0], tscene.media[0]
    ro, rd, t, pss, tv, tg = _rays(5)
    j3, j1 = _coeffs(jmed, ro, rd, pss, tv, tg)
    tpss = _t(pss.astype(np.int64))
    if tmed.cfg.one_d:
        jf = jfast.make_value_at_1d(jmed.cfg, jmed.gp, j1, jnp.asarray(ro),
                                    jnp.asarray(rd), jnp.asarray(pss),
                                    jnp.uint32(SEED))
        tf = tfast.make_value_at_1d(tmed.cfg, tmed.gp,
                                    convert.coeffs_from_numpy(j1, "cpu"),
                                    _t(ro), _t(rd), tpss, SEED)
    else:
        jf = jfast.make_value_at(jmed.cfg, jmed.gp, j3, jnp.asarray(ro),
                                 jnp.asarray(rd), jnp.asarray(pss),
                                 jnp.uint32(SEED))
        tf = tfast.make_value_at(tmed.cfg, tmed.gp, _t(ro), _t(rd), tpss,
                                 SEED, coeff3=convert.coeffs_from_numpy(
                                     j3, "cpu"))
    jv, jid = jf(jnp.asarray(t))
    tv_, tid = tf(_t(t))
    _close(tv_.numpy(), jv, float(np.abs(np.asarray(jv)).max()),
           "value_at")
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


def test_plain_isotropic_sampling_matches_jax(docs):
    """isotropic_ray_3d false (reachable only by replacing the config's
    field, in both packages): the general evaluator and the march's."""
    for name in ("box-iso", "hero-iso", "hero-bruteforce"):
        jscene, tscene, _ = _scenes(docs[name], isotropic_3D_sampling=True)
        jmed = dataclasses.replace(jscene.media[0], cfg=dataclasses.replace(
            jscene.media[0].cfg, isotropic_ray_3d=False))
        tmed = dataclasses.replace(tscene.media[0], cfg=dataclasses.replace(
            tscene.media[0].cfg, isotropic_ray_3d=False))
        ro, rd, t, pss, _, _ = _rays(7)
        p = ro + t[:, None] * rd
        z = jsc.Coeffs.zero()
        jv, _ = jax.vmap(lambda p_i, rd_i, pss_i: jsc.eval_value(
            jmed.cfg, jmed.gp, z, z, p_i, 0.0, rd_i, pss_i,
            jnp.uint32(SEED), 0.0))(p, rd, pss)
        tpss = _t(pss.astype(np.int64))
        tv_, _ = tsc.eval_value(tmed.cfg, tmed.gp, _t(p), tpss, SEED,
                                ray_dir=_t(rd))
        _close(tv_.numpy(), jv, float(np.abs(np.asarray(jv)).max()),
               f"{name} value")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TUNGSTEN_TPU_PALLAS", "0")
            jf = jfast.make_value_at(jmed.cfg, jmed.gp, None,
                                     jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(pss), jnp.uint32(SEED))
            jf_v, _ = jf(jnp.asarray(t))
        tf_v, _ = tfast.make_value_at(tmed.cfg, tmed.gp, _t(ro), _t(rd),
                                      tpss, SEED)(_t(t))
        _close(tf_v.numpy(), jf_v, float(np.abs(np.asarray(jf_v)).max()),
               f"{name} value_at")


@pytest.mark.parametrize("corr_xy", [False, True])
def test_multi_res_1d_mirror_nee_matches_jax(docs, corr_xy):
    """nee_grad and nee_pdf of a multi-resolution 1D realization, renewal+
    conditioned, against JAX's."""
    jscene, tscene, _ = _scenes(
        docs["hero-1d"], correlation_context="renewal+",
        **{"1D_gradient_correlationXY": corr_xy})
    jmed, tmed = jscene.media[0], tscene.media[0]
    ro, rd, t, pss, tv, tg = _rays(11)
    _, j1 = _coeffs(jmed, ro, rd, pss, tv, tg)
    c1 = convert.coeffs_from_numpy(j1, "cpu")
    r = np.random.default_rng(12)
    n = (-rd + 0.4 * r.normal(size=(R, 3))).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    p = ro + t[:, None] * rd
    jg, jp = jax.vmap(lambda c, d, n_i, p_i, t_i, s: (
        jsc.nee_grad(jmed.cfg, jmed.gp, c, d, n_i, p_i, s, jnp.uint32(SEED),
                     0.0),
        jsc.nee_pdf(jmed.cfg, jmed.gp, c, d, n_i, p_i, t_i, s,
                    jnp.uint32(SEED), 0.0)))(j1, rd, n, p, t, pss)
    tpss = _t(pss.astype(np.int64))
    tg_ = tsc.nee_grad(tmed.cfg, tmed.gp, c1, _t(rd), _t(n), _t(p), tpss,
                       SEED)
    tp = tsc.nee_pdf(tmed.cfg, tmed.gp, c1, _t(rd), _t(n), _t(p), _t(t),
                     tpss, SEED)
    _close(tg_.numpy(), jg, float(np.abs(np.asarray(jg)).max()), "nee_grad")
    _close(tp.numpy(), jp, float(np.abs(np.asarray(jp)).max()), "nee_pdf")
    assert (np.asarray(jp) > 0).any()


@pytest.mark.parametrize("name", THREE_D + ONE_D)
def test_renders_through_the_cli_on_the_cpu(docs, name, tmp_path):
    from tungsten_tpu_torch import render as trender
    from tungsten_tpu_torch.io.image import read_pfm
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(docs[name]))
    out = str(tmp_path / f"{name}.png")
    trender.main([str(path), "--spp", "1", "--res", "8x6", "-o", out,
                  "--device", "cpu"])
    img = read_pfm(out[:-4] + ".pfm")
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


@pytest.mark.parametrize("name", [n for n in THREE_D + ONE_D
                                  if n != "box-iso"])
def test_the_gradient_is_refused_by_name(docs, name):
    """The gradient through these branches is ported
    (tests/test_torch_grad_sampling.py holds it to JAX); what stays
    refused on them is a GP type whose gradient JAX cannot take: with the
    knob mean in place of the variant's, fwd_bwd raises by name before
    rendering (ROADMAP queue 3)."""
    doc = json.loads(json.dumps(docs[name]))
    doc["media"][0]["gaussian_process"]["mean"] = {"type": "procedural",
                                                   "func": "knob"}
    scene, _ = scene_from_dict(doc, device="cpu")
    with pytest.raises(NotImplementedError, match="knob mean.*queue 3"):
        entry.fwd_bwd(scene, 0)
