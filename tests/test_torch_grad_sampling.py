"""The gradient in (sigma, l) through the sparse-convolution sampling
branches beside BASELINE's (tungsten_tpu_torch/ops/sparse_conv_fast.py on
K1/K1b, K2/K2b and K3/K3b, and the general 1D evaluator) against the JAX
package on the CPU: K1b's and K2b's full splat form (an anisoMtx in world
space), brute-force, isotropic, plain isotropic and conditioned
nonstationary noise, renewal conditioning of 1D realizations, 1D
multi-resolution noise and the surface/volume phase id.

Tolerances:
- The full-form twins of K1b and K2b (under autograd: K1 and K2 take the
  form's six entries) against jax.vjp of the JAX package's _ref_sum, the
  XLA re-trace that its custom VJPs differentiate: dp, dkr, dqm and all of
  dm6 within rtol 1e-5, atol 1e-6 times the largest |entry| of the
  quantity (the 27 x K terms are added in another order than XLA's).
- A march step's value_at under autograd (the rays' conditioning
  coefficients made from (sigma, l) in the graph where the context
  conditions) against JAX's value_at on its CPU path (the general
  evaluator, an independent reference, compiled as the medium-level
  gradient's side is) under jax.jvp and jax.jacfwd: each ray's value and
  its partials in t, sigma and l within 1e-5 * (1 + s), s the quantity's
  largest |entry| over the rays.
- The medium-level gradient (tests/torch_grad_common.py): within 1e-3 of
  jax.grad, and within rtol 0.15, atol 0.5 of central FD on the lanes FD
  resolves.
JAX's sample_distance runs on its CPU path (the general evaluator).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grad_common as common
from tungsten_tpu.models import media as jmd
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_pallas as scp
from tungsten_tpu_torch.kernels import noise3d
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.tools.gp_variants import ANISO_MTX, variant_docs
from tungsten_tpu_torch import convert

SEED = 9
R = 48


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    docs = {k: v[1] for k, v in variant_docs(
        str(tmp_path_factory.mktemp("grad_variants"))).items()}
    # the hero over an anisoMtx base: K2 (and K2b) on the full form
    hero = json.loads(json.dumps(docs["hero-bruteforce"]))
    cov = hero["media"][0]["gaussian_process"]["covariance"]
    cov["multiResolutionGrid"] = True
    cov["cov"]["anisoMtx"] = ANISO_MTX
    docs["hero-aniso"] = hero
    return docs


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _full_form_inputs(n=512, seed=3):
    r = np.random.default_rng(seed)
    p = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    sd = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    g = r.normal(size=n).astype(np.float32)
    a = r.normal(size=(3, 3)) * 0.3 + np.eye(3)
    m = (a @ a.T).astype(np.float32)
    m6 = np.array([m[0, 0], m[1, 1], m[2, 2], m[0, 1], m[0, 2], m[1, 2]],
                  np.float32)
    kr = r.uniform(0.3, 0.5, n).astype(np.float32)
    qm = (1.0 / r.choice([0.4, 1.0, 2.5], n) ** 2).astype(np.float32)
    return p, sd, g, m6, kr, qm


def _near(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("kernel", ["K1b", "K2b"])
def test_full_form_backward_twins_match_jax_vjp(kernel):
    p, sd, g, m6, kr_v, qm_v = _full_form_inputs()
    seed = jnp.asarray(sd.astype(np.uint32))
    tp = _t(p).requires_grad_()
    tm = _t(m6).requires_grad_()
    host = tuple(float(v) for v in m6)
    tseed = _t(sd.astype(np.int64))
    if kernel == "K1b":
        kr = np.float32(0.37)
        _, vjp = jax.vjp(lambda p_, k, m: scp._ref_sum(p_, seed, k, None, m,
                                                       3),
                         jnp.asarray(p), jnp.asarray(kr), jnp.asarray(m6))
        want = vjp(jnp.asarray(g))
        tkr = torch.tensor(kr, requires_grad=True)
        before = noise3d.K1B_FULL_LAUNCHES
        out = noise3d.noise3d_sum_s_diff(tp, tseed, tkr, tm, 3,
                                         (float(kr), *host))
        got = torch.autograd.grad(out, (tp, tkr, tm), _t(g))
        assert noise3d.K1B_FULL_LAUNCHES == before  # CPU tensors: the twin
        names = ("dp", "dkr", "dm6")
    else:
        _, vjp = jax.vjp(lambda p_, k, q, m: scp._ref_sum(p_, seed, k, q, m,
                                                          3),
                         jnp.asarray(p), jnp.asarray(kr_v), jnp.asarray(qm_v),
                         jnp.asarray(m6))
        want = vjp(jnp.asarray(g))
        tkr, tqm = (_t(x).requires_grad_() for x in (kr_v, qm_v))
        out = noise3d.noise3d_sum_diff(tp, tseed, tkr, tqm, tm, 3, host)
        got = torch.autograd.grad(out, (tp, tkr, tqm, tm), _t(g))
        names = ("dp", "dkr", "dqm", "dm6")
    for name, a, b in zip(names, got, want):
        assert np.abs(np.asarray(b)).max() > 0.1, name
        _near(a.numpy(), b, f"{kernel} {name}")
    # the off-diagonal partials are not zero: the full instance's own sums
    assert np.abs(got[-1].numpy()[3:]).min() > 1e-3


# (variant, medium-option overrides, cfg-field overrides): the branches of
# sparse_conv_fast.make_value_at and make_value_at_1d, and the general 1D
# evaluator
VALUE_CASES = [
    ("box-aniso", {}, {}),
    ("box-iso", {}, {"isotropic_ray_3d": False}),
    ("box-iso-aniso", {}, {}),
    ("hero-aniso", {}, {}),
    ("hero-bruteforce", {}, {}),
    ("hero-bruteforce", {"isotropic_3D_sampling": True}, {}),
    ("hero-bruteforce", {"correlation_context": "renewal+"}, {}),
    ("hero-iso", {}, {}),
    ("hero-iso", {"correlation_context": "renewal+"}, {}),
    ("hero-renewal", {}, {}),
    ("hero-surfvol", {}, {}),
    ("m1d-renewal", {}, {}),
    ("m1d-aniso", {}, {}),
    ("hero-1d", {"correlation_context": "renewal+"}, {}),
]


def _case_id(case):
    name, medium, fields = case
    return "-".join([name, *(str(v) for v in medium.values()),
                     *(f"{k}={v}" for k, v in fields.items())])


def _rays(seed):
    r = np.random.default_rng(seed)
    ro = (np.asarray([0.0, 0.9, 0.0]) + r.uniform(-0.5, 0.5, (R, 3))).astype(
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


@pytest.mark.parametrize("case", VALUE_CASES, ids=_case_id)
def test_value_at_under_autograd_matches_jax(docs, case):
    name, medium, fields = case
    jscene, tscene = common.scenes(docs[name], **medium)
    jmed, tmed = jscene.media[0], tscene.media[0]
    if fields:
        jmed = dataclasses.replace(jmed, cfg=dataclasses.replace(
            jmed.cfg, **fields))
        tmed = dataclasses.replace(tmed, cfg=dataclasses.replace(
            tmed.cfg, **fields))
    ro, rd, t, pss, tv, tg = _rays(5)
    cov = common.jparams(jscene)

    def jval(t_, sigma, l):
        med = dataclasses.replace(jmed, gp=common.jset_params(
            dataclasses.replace(jscene, media=(jmed,)), sigma,
            l).media[0].gp)
        z = jsc.Coeffs.zero()
        c3, c1 = jax.vmap(lambda p_, d, v, g, s: jsc.conditioning(
            med.cfg, med.gp, z, z, p_, d, v, g, s, jnp.uint32(SEED),
            jnp.float32(0.0)))(ro, rd, tv, tg, pss)
        state = dataclasses.replace(jmd.MediumState.make(R), coeff3=c3,
                                    coeff1=c1)
        return jmd.make_value_at(med, jnp.uint32(SEED), jnp.asarray(ro),
                                 jnp.asarray(rd), jnp.zeros(R), state,
                                 jnp.asarray(pss))(t_)[0]

    def jall(t_, s_, l_):
        v, d_t = jax.jvp(lambda x: jval(x, s_, l_), (t_,),
                         (jnp.ones(R, jnp.float32),))
        return (v, d_t, *jax.jacfwd(lambda a, b: jval(t_, a, b),
                                    argnums=(0, 1))(s_, l_))
    jt = jnp.asarray(t)
    jv, jdt, jds, jdl = common.compiled(jall, jt, cov.sigma, cov.l)(
        jt, cov.sigma, cov.l)
    want = [np.asarray(x) for x in (jv, jdt, jds, jdl)]

    sigma, l = common.leaves(tscene)
    tt = _t(t).requires_grad_()
    med = dataclasses.replace(tmed, gp=convert.set_params(
        dataclasses.replace(tscene, media=(tmed,)), sigma, l).media[0].gp)
    zero = tsc.Coeffs.zeros(R, "cpu")
    tpss = _t(pss.astype(np.int64))
    c3, c1 = tsc.conditioning(med.cfg, med.gp, zero, zero, _t(ro), _t(rd),
                              _t(tv), _t(tg), tpss, SEED)
    state = dataclasses.replace(tmd.MediumState.make(R, "cpu"), coeff3=c3,
                                coeff1=c1)
    tv_, _ = tmd.make_value_at(med, SEED, _t(ro), _t(rd), tpss, state)(tt)
    dt, = torch.autograd.grad(tv_.sum(), tt, retain_graph=True)
    dps = torch.stack([torch.stack(torch.autograd.grad(
        tv_[i], (sigma, l), retain_graph=True)) for i in range(R)])
    got = [tv_.detach(), dt, dps[:, 0], dps[:, 1]]
    for what, a, b in zip(("value", "d/dt", "d/dsigma", "d/dl"), got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = float(np.abs(b).max())
        assert np.isfinite(a).all() and scale > 0.0, what
        assert np.abs(a - b).max() <= 1e-5 * (1.0 + scale), (
            what, np.abs(a - b).max(), scale)


# (variant, segments): every sparse-conv sampling variant's medium-level
# gradient; the conditioned ones in two segments (the second conditioned
# at its start)
MEDIUM_CASES = [("box-aniso", 1), ("box-iso", 1), ("box-iso-aniso", 1),
                ("hero-bruteforce", 1), ("hero-iso", 1), ("hero-renewal", 2),
                ("hero-1d", 1), ("hero-surfvol", 1), ("m1d-renewal", 2),
                ("m1d-aniso", 2)]


@pytest.mark.parametrize("name, segments", MEDIUM_CASES)
def test_medium_level_grad_matches_jax_and_fd(docs, name, segments):
    jscene, tscene = common.scenes(docs[name])
    family = name.split("-")[0]
    out = common.medium_grads(jscene, tscene, family, segments)
    assert max(out["lanes"]) > 0, out
