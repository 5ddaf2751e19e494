"""The port's hyperparameter gradient of BASELINE config 5, the hero
(`scenes/gpis-hero.json`: multi-resolution procedural-nonstationary
sparse-conv noise under the Global context), against the JAX package on the
CPU: K2's backward, the two-level value_at under autograd, sample_distance's
IFT reattachment and the whole detached-sampling estimator.  (sigma, l) are
those of the covariance's stationary base.

Tolerances:
- K2 under autograd (its backward on CPU tensors is K2b's plain twin, a
  closed form) against jax.vjp of the JAX package's _ref_sum with per-point
  kr and qm, the XLA re-trace its custom VJP _noise3d_sum_bwd
  differentiates: the sum within atol 1e-5; dp and the per-point dkr and
  dqm within rtol 1e-4, atol 1e-5, and the 3 diagonal entries of dm6 (sums
  over points) likewise (the 27 x K terms are summed in another order than
  XLA's).  The port's splat form is diagonal: its off-diagonal entries are
  constant zeros and carry no gradient.
- The multi-resolution value_at under autograd against jax.vjp of JAX's
  (TUNGSTEN_TPU_PALLAS=1: K2 in Pallas interpret mode, its backward the
  XLA re-trace) on the same cotangent: d/dt per ray and d/d(sigma, l)
  within rtol 1e-3, atol 1e-3 of the largest partial.
- sample_distance's gradient of sum_i w_i t_i in (sigma, l) on 32 rays from
  (0, 1, 3.8), fanned over +-0.10 rad at rd_y = -0.03, near 2, far 4.5, over
  the lanes that hit at every FD evaluation: within 1e-3 relative of
  jax.grad (JAX's default CPU path, march_block=1), and within rtol 0.15,
  atol 0.5 of the port's own central FD at eps 5e-4.  The weights w_i = +-1
  (`WEIGHTS`) are the signs of each ray's d t_i / d sigma as JAX alone gave
  them (jax.jacrev of the 32 t), fixed before any port number was read:
  the plain sum's d/d sigma, 0.43, lies under FD's noise of about +-1 (the
  Illinois end points round at ~1e-5 per ray), while the signed sum's is
  30.08.  With these weights JAX's own central FD, (28.45, -37.26) at eps
  5e-4, agrees with its jax.grad, (30.08, -35.63), within the limits above
  (at eps 1e-3 its d/dl, -44.97, does not: a crossing moves off its
  smooth branch).
- d sum(image) / d(sigma, l) of an 8x6, 1-spp, depth-2 pass (entry.fwd_bwd)
  within 1e-2 relative of the JAX package's trace under jax.jvp (one
  compiled forward-mode pass, run once per parameter, serves both
  image-level tests: it compiles in less time than jacrev or jacfwd).  On the same pass,
  entry.train_step's loss and gradient against a zero target, times the
  3 * 8 * 6 values it averages, within 1e-2 relative of JAX's summed L2 and
  its gradient.  A training step's render has the plain render's value bit
  for bit, the plain render runs no backward twin, and the step is
  sigma - 1e-3 * dsigma, l - 1e-3 * dl exactly.
- A train_step on a frame of more than render.MAX_RAYS pixels (patched
  small) renders in row bands, one sample at a time, and equals the single
  batch's: the loss and the gradient within 1e-6 relative.
The JAX side is compiled at XLA's backend optimization level 0, which
shortens its compile and changes its results by rounding only; JAX's
value_at runs eagerly (compiled, its unrolled sum and interpret-mode
kernel take minutes).
"""
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models.integrator import trace as jtrace
from tungsten_tpu.ops import sparse_conv_fast as jfast
from tungsten_tpu.ops import sparse_conv_pallas as jscp
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.kernels import noise3d
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.models.integrator import render_pass
from tungsten_tpu_torch.ops import sparse_conv_fast as tfast
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERO = os.path.join(ROOT, "scenes", "gpis-hero.json")
CENTER = np.array([0.0, 0.9, 0.0], np.float32)
WEIGHTS = np.array([1.0 if c == "+" else -1.0
                    for c in "--+---+-++---+------+++++++--++-"], np.float32)
FD_EPS = 5e-4


def _compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def _jscene(res=None):
    """The hero for the JAX side (march_block 1, optionally at `res`)."""
    jscene, _ = jload_scene(HERO, res_override=res)
    return dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))


def _jset_params(scene, sigma, l):
    """The JAX scene with (sigma, l) of medium 0's base covariance
    replaced, as convert.set_params does on the port's."""
    med = scene.media[0]
    cov = med.gp.cov
    cov = dataclasses.replace(cov, base=dataclasses.replace(
        cov.base, sigma=sigma, l=l))
    med = dataclasses.replace(med, gp=dataclasses.replace(med.gp, cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


def _tscene(jscene):
    return convert.scene_from_numpy(convert.flatten(jscene), device="cpu")


def _leaves(tscene):
    return tuple(x.detach().clone().requires_grad_()
                 for x in entry.params(tscene))


def _t(a):
    return torch.from_numpy(np.array(a))


def _k2_inputs(n, seed):
    """Points around the GPIS sphere with per-point levels as the hero
    draws them (s in {0.4, 1, 2.5, 6.25}, kr = kr_unit * s, qm = 1 / s^2),
    seeds, the base's splat-form diagonal and a cotangent, in numpy."""
    base = _tscene(_jscene()).media[0].gp.cov.base
    r = np.random.default_rng(seed)
    p = (CENTER + r.uniform(-1.0, 1.0, (n, 3))).astype(np.float32)
    s = np.float32(2.5) ** r.integers(-1, 3, n).astype(np.float32)
    sd = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    kr = (np.float32(float(base.splat_radius())) * s).astype(np.float32)
    qm = (np.float32(1.0) / (s * s)).astype(np.float32)
    g = r.normal(size=n).astype(np.float32)
    return p, sd, kr, qm, base.splat_form().numpy(), g


@pytest.mark.parametrize("K", [1, 3])
def test_k2_backward_matches_jax_vjp(K):
    p, sd, kr0, qm0, m30, g = _k2_inputs(400, 11 + K)
    m6 = np.concatenate([m30, np.zeros(3, np.float32)])
    out, vjp = jax.vjp(
        lambda p, kr, qm, m6: jscp._ref_sum(p, jnp.asarray(sd), kr, qm, m6,
                                            K),
        *(jnp.asarray(x) for x in (p, kr0, qm0, m6)))
    jdp, jdkr, jdqm, jdm6 = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    tp, kr, qm, m3 = (_t(x).requires_grad_() for x in (p, kr0, qm0, m30))
    seed = _t(sd.astype(np.int64))
    before = noise3d.K2B_LAUNCHES, noise3d.K2_LAUNCHES
    tout = noise3d.noise3d_sum_diff(tp, seed, kr, qm, m3, K,
                                    tuple(m30.tolist()))
    tout.backward(_t(g))
    # CPU tensors: the twins
    assert (noise3d.K2B_LAUNCHES, noise3d.K2_LAUNCHES) == before
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    assert np.abs(jdp).max() > 1.0 and np.abs(jdkr).max() > 1.0
    for got, want in ((tp.grad, jdp), (kr.grad, jdkr), (qm.grad, jdqm),
                      (m3.grad, jdm6[:3])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the twin's per-point partials are those autograd summed
    dp, part = noise3d.noise3d_sum_bwd_ref(
        tp.detach(), seed, kr.detach(), qm.detach(), m30.tolist(), K, _t(g))
    assert torch.equal(dp, tp.grad) and torch.equal(part[:, 0], kr.grad)
    assert torch.equal(part[:, 1], qm.grad)


def test_k2_diff_without_grad_is_the_raw_sum_and_raw_refuses_grad():
    p, sd, kr0, qm0, m30, _ = _k2_inputs(200, 3)
    seed = _t(sd.astype(np.int64))
    args = (_t(p), seed, _t(kr0), _t(qm0))
    m6 = m30.tolist() + [0.0, 0.0, 0.0]
    raw = noise3d.noise3d_sum(*args, m6, 3)
    plain = noise3d.noise3d_sum_diff(*args, _t(m30), 3, tuple(m30.tolist()))
    assert not plain.requires_grad and torch.equal(plain, raw)
    leaves = [x.clone().requires_grad_() for x in (args[0], args[2])]
    with torch.no_grad():
        held = noise3d.noise3d_sum_diff(leaves[0], seed, leaves[1], args[3],
                                        _t(m30), 3, tuple(m30.tolist()))
    assert not held.requires_grad and torch.equal(held, raw)
    with pytest.raises(NotImplementedError, match="noise3d_sum_diff"):
        noise3d.noise3d_sum(leaves[0], seed, args[2], args[3], m6, 3)


def test_multi_res_value_at_grad_matches_jax_vjp(monkeypatch):
    jscene = _jscene()
    tscene = _tscene(jscene)
    jmed, tmed = jscene.media[0], tscene.media[0]
    n = 32
    r = np.random.default_rng(21)
    ro = (CENTER + r.uniform(-0.7, 0.7, (n, 3))).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    pss = r.integers(0, 2 ** 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    t = r.uniform(0.0, 1.0, n).astype(np.float32)
    c = r.normal(size=n).astype(np.float32)
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jcov = jmed.gp.cov.base

    def jval(t, sigma, l):
        gp = _jset_params(jscene, sigma, l).media[0].gp
        return jfast.make_value_at(jmed.cfg, gp, None, jnp.asarray(ro),
                                   jnp.asarray(rd), jnp.asarray(pss),
                                   jnp.uint32(9))(t)[0]

    jv, vjp = jax.vjp(jval, jnp.asarray(t), jcov.sigma, jcov.l)
    jdt, jds, jdl = (np.asarray(x) for x in vjp(jnp.asarray(c)))

    sigma, l = _leaves(tscene)
    tt = _t(t).requires_grad_()
    gp = convert.set_params(tscene, sigma, l).media[0].gp
    tv, _ = tfast.make_value_at(tmed.cfg, gp, _t(ro), _t(rd),
                                _t(pss.astype(np.int64)), 9)(tt)
    dt, ds, dl = torch.autograd.grad((tv * _t(c)).sum(), (tt, sigma, l))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=3e-4, atol=3e-5)
    assert abs(float(jds)) > 1.0 and abs(float(jdl)) > 1.0
    np.testing.assert_allclose(dt.numpy(), jdt, rtol=1e-3,
                               atol=1e-3 * np.abs(jdt).max())
    np.testing.assert_allclose([float(ds), float(dl)], [jds, jdl], rtol=1e-3)


def _medium_rays(R=32):
    ths = np.linspace(-0.10, 0.10, R, dtype=np.float32)
    ro = np.tile(np.array([[0.0, 1.0, 3.8]], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) - 0.03,
                   -np.cos(ths)], axis=-1).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.uint32)
    uj, near, far = (np.full(R, v, np.float32) for v in (0.5, 2.0, 4.5))
    return ro, rd, pss, uj, near, far


def test_medium_level_grad_matches_jax_and_fd():
    jscene = _jscene()
    tscene = _tscene(jscene)
    ro, rd, pss, uj, near, far = _medium_rays()
    R = ro.shape[0]

    def port_t(sigma, l):
        med = convert.set_params(tscene, sigma, l).media[0]
        res, _ = tmd.sample_distance(
            med, tscene.scene_seed, _t(ro), _t(rd), _t(near), _t(far),
            tmd.MediumState.make(R, "cpu"), _t(pss.astype(np.int64)),
            _t(uj), torch.ones(R, dtype=torch.bool))
        return res

    sigma0, l0 = (float(x) for x in entry.params(tscene))
    eps = FD_EPS
    with torch.no_grad():
        stable = torch.ones(R, dtype=torch.bool)
        for ds, dl in [(0, 0), (eps, 0), (-eps, 0), (0, eps), (0, -eps)]:
            stable &= ~port_t(torch.tensor(sigma0 + ds),
                              torch.tensor(l0 + dl))["exited"]
        w = torch.where(stable, _t(WEIGHTS), 0.0)

        def f(sigma, l):
            return float((w * port_t(torch.tensor(sigma),
                                     torch.tensor(l))["t"]).sum())
        fd_s = (f(sigma0 + eps, l0) - f(sigma0 - eps, l0)) / (2 * eps)
        fd_l = (f(sigma0, l0 + eps) - f(sigma0, l0 - eps)) / (2 * eps)
    assert int(stable.sum()) >= R // 2

    sigma, l = _leaves(tscene)
    before = noise3d.K2B_LAUNCHES
    gs, gl = (float(x) for x in torch.autograd.grad(
        (w * port_t(sigma, l)["t"]).sum(), (sigma, l)))
    assert noise3d.K2B_LAUNCHES == before  # CPU tensors: the twin

    jw = jnp.asarray(w.numpy())

    def jloss(sigma, l):
        res, _ = jmd.sample_distance(
            _jset_params(jscene, sigma, l).media[0], jscene.scene_seed,
            jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near),
            jnp.asarray(far), jmd.MediumState.make(R), jnp.asarray(pss),
            jnp.asarray(uj), jnp.ones(R, bool))
        return jnp.sum(jw * res["t"])

    cov = jscene.media[0].gp.cov.base
    jg = _compiled(jax.grad(jloss, argnums=(0, 1)), cov.sigma, cov.l)(
        cov.sigma, cov.l)
    assert abs(gs) > 1.0 and abs(gl) > 1.0
    np.testing.assert_allclose([gs, gl], [float(jg[0]), float(jg[1])],
                               rtol=1e-3)
    np.testing.assert_allclose(gs, fd_s, rtol=0.15, atol=0.5)
    np.testing.assert_allclose(gl, fd_l, rtol=0.15, atol=0.5)


@pytest.fixture(scope="module")
def jax_image_grads():
    """An 8x6, 1-spp, depth-2 hero pass in JAX, compiled once for both
    image-level tests: the values of sum(image) and of dryrun_multichip's
    loss_rows, sum((image - 0) ** 2), and their derivatives in (sigma, l)
    (one jax.jvp of the two, run along sigma and along l)."""
    W, H = 8, 6
    jscene = _jscene(res=(W, H))
    assert jscene.max_bounces == 2
    px, py = jnp.meshgrid(jnp.arange(W, dtype=jnp.int32),
                          jnp.arange(H, dtype=jnp.int32))
    px, py = px.reshape(-1), py.reshape(-1)

    def losses(sigma, l):
        img = jtrace(_jset_params(jscene, sigma, l), px, py,
                     jnp.int32(0)).reshape(H, W, 3)
        return jnp.stack([jnp.sum(img), jnp.sum(img ** 2)])

    def along(sigma, l, d_sigma, d_l):
        return jax.jvp(losses, (sigma, l), (d_sigma, d_l))

    cov = jscene.media[0].gp.cov.base
    one, zero = jnp.float32(1.0), jnp.float32(0.0)
    f = _compiled(along, cov.sigma, cov.l, one, zero)
    v, js = f(cov.sigma, cov.l, one, zero)
    _, jl = f(cov.sigma, cov.l, zero, one)
    return _tscene(jscene), np.asarray(v), np.asarray(js), np.asarray(jl)


def test_image_grad_matches_jax(jax_image_grads):
    tscene, v, js, jl = jax_image_grads
    img, (gs, gl) = entry.fwd_bwd(tscene, 0)
    assert img.shape == (6, 8, 3) and bool(torch.isfinite(img).all())
    np.testing.assert_allclose(float(img.sum()), v[0], rtol=1e-4)
    assert abs(js[0]) > 1.0 and abs(jl[0]) > 1.0
    np.testing.assert_allclose([float(gs), float(gl)], [js[0], jl[0]],
                               rtol=1e-2)


def test_train_step_matches_jax_through_k2s_backward(jax_image_grads,
                                                      monkeypatch):
    tscene, v, js, jl = jax_image_grads
    calls = []
    twin = noise3d.noise3d_sum_bwd_ref

    def counted(*args):
        calls.append(1)
        return twin(*args)

    monkeypatch.setattr(noise3d, "noise3d_sum_bwd_ref", counted)
    plain = render_pass(tscene, 0)
    assert not plain.requires_grad and not calls
    target = torch.zeros_like(plain)
    s1, l1, loss, (gs, gl) = entry.train_step(tscene, target, 0)
    assert calls  # the backward went through K2's backward
    # the graph's render has the plain render's value: the same loss, bit
    # for bit
    assert float(loss) == float(((plain - target) ** 2).mean())
    for x in (loss, s1, l1, gs, gl):
        assert bool(torch.isfinite(x))
    n = plain.numel()  # train_step's mean is the summed L2 over n at 1 spp
    assert abs(js[1]) > 1.0 and abs(jl[1]) > 1.0
    np.testing.assert_allclose(float(loss) * n, v[1], rtol=1e-2)
    np.testing.assert_allclose([float(gs) * n, float(gl) * n],
                               [js[1], jl[1]], rtol=1e-2)
    sigma, l = (x.detach() for x in entry.params(tscene))
    assert float(s1) == float(sigma - 1e-3 * gs)
    assert float(l1) == float(l - 1e-3 * gl)


def test_banded_train_step_equals_single_batch(monkeypatch):
    tscene, _ = tload_scene(HERO, res_override=(4, 4), device="cpu")
    target = torch.full((4, 4, 3), 0.1)
    spp_idx = torch.arange(2)
    single = entry.train_step(tscene, target, spp_idx)
    # 8 rays per batch: bands of 2 rows, one sample at a time
    monkeypatch.setattr(trender, "MAX_RAYS", 8)
    calls = []

    def spy(scene, spp_idx, rows=None):
        calls.append((spp_idx, rows))
        return render_pass(scene, spp_idx, rows)

    monkeypatch.setattr(entry, "render_pass", spy)
    banded = entry.train_step(tscene, target, spp_idx)
    assert calls == [(s, rows) for rows in ((0, 2), (2, 4)) for s in (0, 1)]
    for a, b in zip((single[2], *single[3]), (banded[2], *banded[3])):
        assert float(a) != 0.0
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)


def test_cli_trains_the_hero_in_bands(monkeypatch, capsys):
    monkeypatch.setattr(trender, "MAX_RAYS", 8)
    entry.main(["--scene", HERO, "--device", "cpu", "--res", "4x6",
                "--spp", "1", "--steps", "1"])
    out = capsys.readouterr().out
    assert ("gpis-hero.json: 4x6, 1 spp in 3 bands of 2 rows, one sample "
            "at a time, max_bounces 2") in out
    line = next(x for x in out.splitlines() if x.startswith("step 0: "))
    words = line.split()
    for key in ("loss", "dsigma", "dl"):
        x = float(words[words.index(key) + 1])
        assert math.isfinite(x) and (key == "loss" or x != 0.0)
