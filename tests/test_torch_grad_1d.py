"""The port's hyperparameter gradient of BASELINE configs 3 and 3b (the
mirror-1d GPIS: 1D sparse-conv sampling, renewal+ conditioning, mirror
NEE/MIS) against the JAX package on the CPU: K3's backward, the 1D
evaluators under autograd, sample_distance's IFT reattachment over one and
two segments, and the whole detached-sampling estimator.

Tolerances:
- K3 under autograd (its backward on CPU tensors is K3b's plain twin, a
  closed form) against jax.vjp of the JAX package's noise1d_sum in Pallas
  interpret mode, whose backward is the XLA re-trace _noise1d_sum_bwd: the
  sum within atol 1e-5, dpz within rtol 1e-4, atol 1e-5, and the partial
  in kernel_r (through kr and inv_r = 1 / kr) within 1e-4 relative (the
  3 x K terms are summed in another order than XLA's).
- The 1D gradient evaluator, renewal+ conditioning and the mirror NEE's
  nee_grad and nee_pdf under autograd: the vector-Jacobian product of a
  fixed projection of their outputs in (sigma, l), the points and the
  conditioning targets, against jax.vjp of the vmapped JAX functions,
  within rtol 1e-3, atol 1e-4 of the largest partial (the forward values
  agree within 1e-4 in tests/test_torch_mirror_1d.py; nee_pdf inverts its
  3x3 frame by the adjugate where JAX factors it).
- sample_distance on the 48 rays of tests/test_grad_e2e.py::
  test_medium_level_grad_matches_fd_1d, over the lanes that hit at every
  FD evaluation: d sum(t) / d(sigma, l) of one segment, and of two
  segments (the second from each crossing along the mirror direction of
  the sampled normal, with the state the first returned: renewal+
  conditioning, and correlationXY in 3b), loss sum(t1 + t2) plus a fixed
  projection of the second normal, each within 1e-3 relative of jax.grad
  on JAX's fast 1D path (TUNGSTEN_TPU_FAST_MARCH=1 TUNGSTEN_TPU_PALLAS=1,
  K3 in interpret mode, march_block=1, whose rounding the port follows);
  the one-segment gradient within rtol 0.15, atol 0.5 of the port's own
  central FD at eps 2e-3 (that test's limits and eps).
- d sum(image) / d(sigma, l) of config 3's 16x16, 1-spp, depth-2 pass
  (entry.fwd_bwd) within 1e-2 relative of jax.grad of the JAX package's
  trace on its default CPU path.  On the same pass, entry.train_step's
  loss and gradient against a zero target, times the 3 * 16 * 16 values
  it averages, within 1e-2 relative of the JAX summed L2.  A training
  step's render has the plain render's value bit for bit, the plain
  render runs no backward twin, and the step is sigma - 1e-3 * dsigma,
  l - 1e-3 * dl exactly.
The JAX side is compiled at XLA's backend optimization level 0, which
halves its compile and changes its results by rounding only.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models.integrator import trace as jtrace
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_pallas as jscp
from tungsten_tpu.ops.covariance import SquaredExponentialCov as JSE
from tungsten_tpu.ops.means import SphericalMean as JSphere
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch.kernels import noise1d
from tungsten_tpu_torch.models import integrator as tint
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.models.integrator import render_pass
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops.covariance import SquaredExponentialCov
from tungsten_tpu_torch.ops.means import SphericalMean
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {False: os.path.join(ROOT, "scenes", "gpis-mirror-1d.json"),
          True: os.path.join(ROOT, "scenes", "gpis-mirror-1d-corrxy.json")}
WS = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
# a fixed direction the second normal is projected on
PROJ = np.array([0.3, -0.5, 0.8], np.float32)


def _compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jscene(corr_xy, res=None):
    jscene, _ = jload_scene(SCENES[corr_xy], res_override=res)
    return dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))


def _jset_params(scene, sigma, l):
    cov = dataclasses.replace(scene.media[0].gp.cov, sigma=sigma, l=l)
    med = dataclasses.replace(scene.media[0],
                              gp=dataclasses.replace(scene.media[0].gp,
                                                     cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


def _leaves(tscene):
    return tuple(x.detach().clone().requires_grad_()
                 for x in entry.params(tscene))


# ---------------------------------------------------------------------------
# K3 and K3b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3])
def test_k3_backward_matches_jax_vjp(K):
    r = np.random.default_rng(17)
    n = 4096
    pz = r.uniform(-6.0, 6.0, n).astype(np.float32)
    seed = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    g = r.normal(size=n).astype(np.float32)
    kr0 = np.float32(3.0)

    out, vjp = jax.vjp(
        lambda p, kr: jscp.noise1d_sum(p, jnp.asarray(seed), kr,
                                       impulse_count=K, interpret=True),
        jnp.asarray(pz), jnp.asarray(kr0))
    jdp, jdkr = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    tseed = torch.from_numpy(seed.astype(np.int64))
    tp = torch.from_numpy(pz).requires_grad_()
    kr = torch.tensor(kr0).requires_grad_()
    before = noise1d.K3B_LAUNCHES
    tout = noise1d.noise1d_sum_diff(tp, tseed, kr, K)
    tout.backward(torch.from_numpy(g))
    assert noise1d.K3B_LAUNCHES == before  # CPU tensors: the twin
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    assert np.abs(jdp).max() > 1.0 and abs(float(jdkr)) > 1.0
    np.testing.assert_allclose(tp.grad.numpy(), jdp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(kr.grad), float(jdkr), rtol=1e-4)

    # a Python-float radius: the same dpz, and the twin's own pair (dpz,
    # the partial in kr summed over points), the autograd one bit for bit
    tp2 = torch.from_numpy(pz).requires_grad_()
    noise1d.noise1d_sum_diff(tp2, tseed, float(kr0), K).backward(
        torch.from_numpy(g))
    assert torch.equal(tp2.grad, tp.grad)
    dpz, dkr = noise1d.noise1d_sum_bwd(torch.from_numpy(pz), tseed,
                                       float(kr0), K, torch.from_numpy(g))
    assert torch.equal(dpz, tp.grad) and dkr.shape == ()
    assert dkr.dtype == torch.float32 and torch.equal(dkr, kr.grad)


def test_k3_without_grad_is_the_raw_launch():
    r = np.random.default_rng(4)
    pz = torch.from_numpy(r.uniform(-3.0, 3.0, 256).astype(np.float32))
    seed = torch.from_numpy(r.integers(0, 2 ** 32, 256, dtype=np.uint64)
                            .astype(np.int64))
    raw = noise1d.noise1d_sum(pz, seed, 3.0, 3)
    kr = torch.tensor(3.0, requires_grad=True)
    with torch.no_grad():
        out = noise1d.noise1d_sum_diff(pz.clone().requires_grad_(), seed, kr,
                                       3)
    assert not out.requires_grad and torch.equal(out, raw)
    out = noise1d.noise1d_sum_diff(pz, seed, 3.0, 3)
    assert out.grad_fn is None and torch.equal(out, raw)
    with pytest.raises(NotImplementedError, match="noise1d_sum_diff"):
        noise1d.noise1d_sum(pz.clone().requires_grad_(), seed, 3.0, 3)
    with pytest.raises(ValueError):
        noise1d.noise1d_sum_bwd(pz, seed, 3.0, 3, torch.ones(255))


# ---------------------------------------------------------------------------
# The 1D evaluators, renewal+ conditioning and the mirror NEE under autograd
# ---------------------------------------------------------------------------

SIGMA, L, ANISO = 0.06, 0.12, (1.0, 1.7, 0.6)
CENTER, RADIUS = (0.0, 0.9, 0.0), 0.45
SCENE_SEED = 9


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _evaluator_inputs(n=64):
    """Points on rays around the GPIS sphere, their words, segment lengths,
    conditioning coefficients and targets, light half vectors, and the
    fixed projections of each output."""
    r = np.random.default_rng(23)
    ro = (r.uniform(-0.7, 0.7, (n, 3)) + CENTER).astype(np.float32)
    rd = _unit(r, n)
    t = r.uniform(0.0, 1.0, n).astype(np.float32)
    p = (ro + t[:, None] * rd).astype(np.float32)
    pss = r.integers(0, 50, (n, 4)).astype(np.uint32)
    t_seg = np.where(np.arange(n) % 4 == 0, 0.0, t).astype(np.float32)
    coeffs = (r.normal(0.0, 0.5, n).astype(np.float32),
              r.normal(0.0, 0.3, (n, 3)).astype(np.float32),
              (ro - rd * r.uniform(0.0, 0.3, (n, 1))).astype(np.float32))
    target = (r.normal(0.0, 0.05, n).astype(np.float32), _unit(r, n))
    normal = -rd + _unit(r, n)
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)
              ).astype(np.float32)
    proj = r.normal(size=(5, n, 3)).astype(np.float32)
    return p, rd, pss, t_seg, coeffs, target, normal, proj


@pytest.mark.parametrize("corr_xy", [False, True])
def test_evaluators_under_autograd_match_jax_vjp(corr_xy):
    p, rd, pss, t_seg, coeffs, target, normal, proj = _evaluator_inputs()
    kw = dict(global_seed=42, impulse_density=3.0, ctxt=jsc.CTXT_RENEWAL_PLUS,
              one_d=True, scheme=jsc.SCHEME_MIS, correlation_xy=corr_xy)
    jcfg = jsc.SparseConvConfig.create(**kw)
    tcfg = tsc.SparseConvConfig.create(device="cpu", **kw)
    seed = jnp.uint32(SCENE_SEED)

    def jf(sigma, l, p, vs, gs, tv, tg):
        gp = jsc.GP(mean=JSphere.create(center=CENTER, radius=RADIUS),
                    cov=dataclasses.replace(JSE.create(sigma=SIGMA, l=L,
                                                       aniso=ANISO),
                                            sigma=sigma, l=l))
        c = jsc.Coeffs(value_scale=vs, gradient_scale=gs,
                       ray_origin=jnp.asarray(coeffs[2]))
        args = (c, p, jnp.asarray(t_seg), jnp.asarray(rd),
                jnp.asarray(pss), jnp.asarray(normal))
        g = jax.vmap(lambda c, p_i, ts, d, s, n: jsc.eval_gradient_noise1d(
            jcfg, gp, c, p_i, ts, ts, d, s, seed, True))(*args)
        cond = jax.vmap(lambda p_i, d, v, gr, s: jsc.conditioning_1d(
            jcfg, gp, p_i, d, v, gr, s, seed, 0.0))(
            p, jnp.asarray(rd), tv, tg, jnp.asarray(pss))
        ng = jax.vmap(lambda c, p_i, ts, d, s, n: jsc.nee_grad(
            jcfg, gp, c, d, n, p_i, s, seed, 0.0))(*args)
        npdf = jax.vmap(lambda c, p_i, ts, d, s, n: jsc.nee_pdf(
            jcfg, gp, c, d, n, p_i, ts, s, seed, 0.0))(*args)
        return (jnp.sum(g * proj[0]) + jnp.sum(cond.value_scale * proj[1, :, 0])
                + jnp.sum(cond.gradient_scale * proj[2])
                + jnp.sum(ng * proj[3]) + jnp.sum(npdf * proj[4, :, 0]))

    jargs = [jnp.float32(SIGMA), jnp.float32(L), jnp.asarray(p),
             jnp.asarray(coeffs[0]), jnp.asarray(coeffs[1]),
             jnp.asarray(target[0]), jnp.asarray(target[1])]
    jv, jg = _compiled(jax.value_and_grad(jf, argnums=tuple(range(7))),
                       *jargs)(*jargs)

    targs = [torch.tensor(SIGMA), torch.tensor(L), torch.from_numpy(p),
             torch.from_numpy(coeffs[0]), torch.from_numpy(coeffs[1]),
             torch.from_numpy(target[0]), torch.from_numpy(target[1])]
    targs = [x.clone().requires_grad_() for x in targs]
    sigma, l, tp, vs, gs, tv, tg = targs
    gp = tsc.GP(mean=SphericalMean(center=torch.tensor(CENTER),
                                   radius=torch.tensor(RADIUS)),
                cov=SquaredExponentialCov(sigma=sigma, l=l,
                                          aniso=torch.tensor(ANISO)))
    c = tsc.Coeffs(value_scale=vs, gradient_scale=gs,
                   ray_origin=torch.from_numpy(coeffs[2]))
    tpss = torch.from_numpy(pss.astype(np.int64))
    trd, tn = torch.from_numpy(rd), torch.from_numpy(normal)
    tproj = torch.from_numpy(proj)
    g = tsc.eval_gradient_noise1d(tcfg, gp, c, tp, torch.from_numpy(t_seg),
                                  trd, tpss, SCENE_SEED, True)
    cond = tsc.conditioning_1d(tcfg, gp, tp, trd, tv, tg, tpss, SCENE_SEED)
    ng = tsc.nee_grad(tcfg, gp, c, trd, tn, tp, tpss, SCENE_SEED)
    npdf = tsc.nee_pdf(tcfg, gp, c, trd, tn, tp, torch.from_numpy(t_seg),
                       tpss, SCENE_SEED)
    v = ((g * tproj[0]).sum() + (cond.value_scale * tproj[1, :, 0]).sum()
         + (cond.gradient_scale * tproj[2]).sum() + (ng * tproj[3]).sum()
         + (npdf * tproj[4, :, 0]).sum())
    grads = torch.autograd.grad(v, targs)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-4)
    for got, want in zip(grads, jg):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# sample_distance over one and two segments
# ---------------------------------------------------------------------------

def _rays(R=48):
    """The rays, words and segment of test_medium_level_grad_matches_fd_1d,
    as numpy arrays."""
    ths = np.linspace(-0.15, 0.15, R, dtype=np.float32)
    ro = np.tile(np.array([[0.0, 0.9, 3.0]], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) - 0.01,
                   -np.cos(ths)], axis=-1).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.uint32)
    uj, near, far = (np.full(R, v, np.float32) for v in (0.5, 1.2, 4.5))
    return ro, rd, pss, uj, near, far


def _two_segments(ops, med, scene_seed, ro, rd, near, far, state, pss, uj,
                  active, two):
    """sample_distance, then (with `two`) a second one from each crossing
    along the mirror direction of the sampled normal, with the state the
    first returned and the next bounce's words.  `ops` holds the framework's
    sample_distance, sum, norm and concatenate."""
    res, st = ops["sample"](med, scene_seed, ro, rd, near, far, state, pss,
                            uj, active)
    if not two:
        return res, None
    n = res["aniso"] / ops["norm"](res["aniso"])
    rd2 = rd - 2.0 * ops["sum"](rd * n) * n
    ro2 = ro + res["t"][:, None] * rd
    pss2 = ops["cat"]([pss[:, :3], pss[:, 3:] + 1])
    res2, _ = ops["sample"](med, scene_seed, ro2, rd2, near * 0.0, far, st,
                            pss2, uj, active & ~res["exited"])
    return res, res2


TORCH_OPS = dict(
    sample=tmd.sample_distance, cat=lambda xs: torch.cat(xs, dim=1),
    sum=lambda x: x.sum(dim=-1, keepdim=True),
    norm=lambda x: torch.linalg.norm(x, dim=-1, keepdim=True))
JAX_OPS = dict(
    sample=jmd.sample_distance, cat=lambda xs: jnp.concatenate(xs, axis=1),
    sum=lambda x: jnp.sum(x, axis=-1, keepdims=True),
    norm=lambda x: jnp.linalg.norm(x, axis=-1, keepdims=True))


@pytest.mark.parametrize("corr_xy", [False, True])
def test_medium_level_grad_matches_jax_and_fd(corr_xy, monkeypatch):
    monkeypatch.setenv("TUNGSTEN_TPU_FAST_MARCH", "1")
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jscene = _jscene(corr_xy)
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    ro, rd, pss, uj, near, far = _rays()
    R = ro.shape[0]
    t = torch.from_numpy

    def port(sigma, l, two=False):
        med = convert.set_params(tscene, sigma, l).media[0]
        return _two_segments(
            TORCH_OPS, med, tscene.scene_seed, t(ro), t(rd), t(near), t(far),
            tmd.MediumState.make(R, "cpu"), t(pss.astype(np.int64)), t(uj),
            torch.ones(R, dtype=torch.bool), two)

    sigma0, l0 = (float(x) for x in entry.params(tscene))
    eps = 2e-3
    with torch.no_grad():
        stable = torch.ones(R, dtype=torch.bool)
        for ds, dl in [(0, 0), (eps, 0), (-eps, 0), (0, eps), (0, -eps)]:
            stable &= ~port(torch.tensor(sigma0 + ds),
                            torch.tensor(l0 + dl))[0]["exited"]
        hit2 = stable & ~port(torch.tensor(sigma0), torch.tensor(l0),
                              True)[1]["exited"]

        def f(sigma, l):
            return float(torch.where(stable, port(
                torch.tensor(sigma), torch.tensor(l))[0]["t"], 0.0).sum())
        fd_s = (f(sigma0 + eps, l0) - f(sigma0 - eps, l0)) / (2 * eps)
        fd_l = (f(sigma0, l0 + eps) - f(sigma0, l0 - eps)) / (2 * eps)
    assert int(stable.sum()) >= R // 2 and int(hit2.sum()) > 0

    def losses(res, res2, m1, m2, where, total, dot):
        """(one segment's loss, two segments' loss) over the lanes m1 that
        are stable in FD and those of them, m2, that cross again."""
        t1 = total(where(m1, res["t"], 0.0))
        return t1, (t1 + total(where(m2, res2["t"], 0.0))
                    + total(where(m1, dot(res2["aniso"]), 0.0)))

    sigma, l = _leaves(tscene)
    one, two = losses(*port(sigma, l, True), stable, hit2, torch.where,
                      torch.sum, lambda a: (a * t(PROJ)).sum(dim=-1))
    g1 = [float(x) for x in torch.autograd.grad(one, (sigma, l),
                                                retain_graph=True)]
    g2 = [float(x) for x in torch.autograd.grad(two, (sigma, l))]
    m1, m2 = jnp.asarray(stable.numpy()), jnp.asarray(hit2.numpy())

    def jlosses(sigma, l):
        med = _jset_params(jscene, sigma, l).media[0]
        res = _two_segments(
            JAX_OPS, med, jscene.scene_seed, jnp.asarray(ro), jnp.asarray(rd),
            jnp.asarray(near), jnp.asarray(far), jmd.MediumState.make(R),
            jnp.asarray(pss), jnp.asarray(uj), jnp.ones(R, bool), True)
        return jnp.stack(losses(*res, m1, m2, jnp.where, jnp.sum,
                                lambda a: jnp.sum(a * PROJ, axis=-1)))

    cov = jscene.media[0].gp.cov
    js, jl = (np.asarray(x) for x in _compiled(
        jax.jacrev(jlosses, argnums=(0, 1)), cov.sigma, cov.l)(cov.sigma,
                                                               cov.l))
    assert all(abs(x) > 0.0 for x in g1 + g2)
    np.testing.assert_allclose(g1, [js[0], jl[0]], rtol=1e-3)
    np.testing.assert_allclose(g2, [js[1], jl[1]], rtol=1e-3)
    np.testing.assert_allclose(g1[0], fd_s, rtol=0.15, atol=0.5)
    np.testing.assert_allclose(g1[1], fd_l, rtol=0.15, atol=0.5)


# ---------------------------------------------------------------------------
# The image gradient and the training step of config 3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_image_grads():
    """Config 3's 16x16, 1-spp, depth-2 pass in JAX on its default CPU
    path, compiled once for both image-level tests: the values of
    sum(image) and of the summed L2 sum((image - 0) ** 2), and their
    jax.grad in (sigma, l) (one jacrev of the two)."""
    jscene = _jscene(False, res=(16, 16))
    assert jscene.max_bounces == 2
    px, py = jnp.meshgrid(jnp.arange(16, dtype=jnp.int32),
                          jnp.arange(16, dtype=jnp.int32))
    px, py = px.reshape(-1), py.reshape(-1)

    def losses(sigma, l):
        img = jtrace(_jset_params(jscene, sigma, l), px, py,
                     jnp.int32(0)).reshape(16, 16, 3)
        v = jnp.stack([jnp.sum(img), jnp.sum(img ** 2)])
        return v, v

    cov = jscene.media[0].gp.cov
    (js, jl), v = _compiled(jax.jacrev(losses, argnums=(0, 1), has_aux=True),
                            cov.sigma, cov.l)(cov.sigma, cov.l)
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    return tscene, np.asarray(v), np.asarray(js), np.asarray(jl)


def test_image_grad_matches_jax(jax_image_grads):
    tscene, v, js, jl = jax_image_grads
    img, (gs, gl) = entry.fwd_bwd(tscene, 0)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert abs(js[0]) > 1.0 and abs(jl[0]) > 1.0
    np.testing.assert_allclose(float(img.sum()), v[0], rtol=1e-3)
    np.testing.assert_allclose([float(gs), float(gl)], [js[0], jl[0]],
                               rtol=1e-2)


def test_grad_render_has_the_plain_value_and_train_step(jax_image_grads):
    tscene, v, js, jl = jax_image_grads
    calls = []
    twin = noise1d.noise1d_sum_bwd_ref

    def counted(*args):
        calls.append(1)
        return twin(*args)

    noise1d.noise1d_sum_bwd_ref = counted
    try:
        plain = render_pass(tscene, 0)
        assert not plain.requires_grad and not calls
        target = torch.zeros_like(plain)
        s1, l1, loss, (gs, gl) = entry.train_step(tscene, target, 0)
        assert calls  # the backward went through K3's backward
    finally:
        noise1d.noise1d_sum_bwd_ref = twin
    # the graph's render has the plain render's value: the same loss, bit
    # for bit
    assert float(loss) == float(((plain - target) ** 2).mean())
    for x in (loss, s1, l1, gs, gl):
        assert bool(torch.isfinite(x))
    # train_step's mean is the summed L2 over 3 * 16 * 16 values at 1 spp
    n = plain.numel()
    assert abs(js[1]) > 1.0 and abs(jl[1]) > 1.0
    np.testing.assert_allclose(float(loss) * n, v[1], rtol=1e-2)
    np.testing.assert_allclose([float(gs) * n, float(gl) * n],
                               [js[1], jl[1]], rtol=1e-2)
    sigma, l = (x.detach() for x in entry.params(tscene))
    assert float(s1) == float(sigma - 1e-3 * gs)
    assert float(l1) == float(l - 1e-3 * gl)


def test_config_3b_gradient_is_finite_where_the_reference_is_nan(
        monkeypatch):
    """Config 3b's NEE evaluates the mirror pdf on every lane and masks the
    lanes that are no volume vertex; there the segment length is the
    surface distance or INF, where correlationXY's factor is NaN, and the
    backward of the mask passes 0 * NaN.  The JAX package's image gradient
    is NaN so; the port sets those lanes' lengths to 0 (integrator
    `_seg_in`), which changes no selected value."""
    scene, _ = tload_scene(SCENES[True], res_override=(16, 16), device="cpu")
    img, grads = entry.fwd_bwd(scene, 0)
    assert all(math.isfinite(float(g)) and float(g) != 0.0 for g in grads)
    monkeypatch.setattr(tint, "_seg_in", lambda in_m, t_seg: t_seg)
    img_nan, grads_nan = entry.fwd_bwd(scene, 0)
    assert torch.equal(img, img_nan)
    assert all(math.isnan(float(g)) for g in grads_nan)


def test_cli_takes_the_mirror_scene(capsys):
    entry.main(["--scene", SCENES[True], "--device", "cpu", "--res", "4x4",
                "--steps", "1"])
    out = capsys.readouterr().out
    assert "gpis-mirror-1d-corrxy.json: 4x4, 16 spp in one batch of 256 " \
           "rays, max_bounces 2" in out
    assert "step 0: loss " in out


def test_unported_gradient_refuses_by_name():
    """The gradient entry points now differentiate the weight-space medium
    too (tests/test_torch_grad_ws.py holds it to JAX): fwd_bwd and the CLI
    give a finite, nonzero gradient, where they refused it by name."""
    ws, _ = tload_scene(WS, res_override=(2, 2), device="cpu")
    _, grads = entry.fwd_bwd(ws, torch.arange(4))
    assert all(bool(torch.isfinite(g)) and float(g) != 0.0 for g in grads)
    # the CLI raises on a non-finite or zero gradient
    entry.main(["--scene", WS, "--device", "cpu", "--res", "2x2", "--spp",
                "4", "--steps", "1"])
