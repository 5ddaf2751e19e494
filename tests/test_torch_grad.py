"""The port's hyperparameter gradient of BASELINE config 1 against the JAX
package on the CPU: K1's backward, sample_distance's IFT reattachment and
the whole detached-sampling estimator.

Tolerances:
- K1 under autograd (its backward on CPU tensors is K1b's plain twin, a
  closed form) against jax.vjp of the JAX package's _ref_sum, the XLA
  re-trace of the lattice sum that its custom VJP _noise3d_sum_s_bwd
  differentiates (and whose value the Pallas kernel computes): the sum
  within atol 1e-5; dp, dkr and the 3 diagonal entries of dm6 within
  rtol 1e-4, atol 1e-5 (the 27 x K terms are summed in another order than
  XLA's).  The port's
  splat form is diagonal: its off-diagonal entries are constant zeros and
  carry no gradient.
- sample_distance's d sum(t) / d(sigma, l) on the 32 rays of
  tests/test_grad_e2e.py::test_medium_level_grad_matches_fd, over the lanes
  that hit at every FD evaluation: within 1e-3 relative of jax.grad on the
  CPU, and within rtol 0.15, atol 0.5 of the port's own central FD at eps
  4e-3 (that test's limits).
- d sum(image) / d(sigma, l) of a 16x16, 1-spp, depth-2 render pass
  (entry.fwd_bwd) within 1e-2 relative of gradcheck.py's jax.grad of
  trace.  On the same pass, entry.train_step's loss and gradient against a
  zero target, times the 3 * 16 * 16 values it averages, within 1e-2
  relative of jax.grad of dryrun_multichip's loss_rows (its sum of squared
  error).
- The reattachment ratio is exactly 1 in value, its gradient is grad log f
  and it has no NaN at f = 0.  A training step's render (its parameters
  require grad) has the value of the plain render: its loss equals the
  plain render's, bit for bit; the plain render runs no backward twin; its
  step is sigma - 1e-3 * dsigma, l - 1e-3 * dl exactly.
- The JAX side runs with march_block=1 (its CPU path), as in
  tests/test_torch_media.py, and its sample_distance and trace are
  compiled at XLA's backend optimization level 0, which halves their
  compile and changes their results by rounding only.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models.camera import Camera as JCamera
from tungsten_tpu.models.integrator import trace as jtrace
from tungsten_tpu.ops import sparse_conv_pallas as scp
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch.kernels import noise1d, noise3d
from tungsten_tpu_torch.models import integrator as tint
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.models.integrator import render_pass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
WS_SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")


def _compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jscene(res=None):
    """Config 1 for the JAX side: march_block 1, and with `res` the camera
    of gradcheck.py's small scene (35 degrees, res x res, max_bounces 2)."""
    jscene, _ = jload_scene(SCENE)
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    if res is not None:
        jscene = dataclasses.replace(
            jscene, max_bounces=2,
            camera=JCamera.create(
                transform=np.asarray(jscene.camera.transform), fov_deg=35.0,
                res=(res, res)))
    return jscene


def _jset_params(scene, sigma, l):
    cov = dataclasses.replace(scene.media[0].gp.cov, sigma=sigma, l=l)
    med = dataclasses.replace(scene.media[0],
                              gp=dataclasses.replace(scene.media[0].gp,
                                                     cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


def _leaves(tscene):
    return tuple(x.detach().clone().requires_grad_()
                 for x in entry.params(tscene))


def test_k1_backward_matches_jax_vjp():
    tscene = convert.scene_from_numpy(convert.flatten(_jscene()),
                                      device="cpu")
    cov = tscene.media[0].gp.cov
    kr0, m30 = cov.splat_radius().detach(), cov.splat_form().detach()
    K = tscene.media[0].cfg.impulse_count
    r = np.random.default_rng(7)
    n = 512
    p = r.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    seed = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    g = r.normal(size=n).astype(np.float32)
    m6 = np.concatenate([m30.numpy(), np.zeros(3, np.float32)])

    out, vjp = jax.vjp(
        lambda p, kr, m6: scp._ref_sum(p, jnp.asarray(seed, jnp.uint32), kr,
                                       jnp.float32(1.0), m6, K),
        jnp.asarray(p), jnp.asarray(kr0.numpy()), jnp.asarray(m6))
    jdp, jdkr, jdm6 = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    tp = torch.from_numpy(p).requires_grad_()
    kr = kr0.clone().requires_grad_()
    m3 = m30.clone().requires_grad_()
    before = noise3d.K1B_LAUNCHES
    tout = noise3d.noise3d_sum_s_diff(
        tp, torch.from_numpy(seed.astype(np.int64)), kr, m3, K,
        noise3d.host_params(kr, m3))
    tout.backward(torch.from_numpy(g))
    assert noise3d.K1B_LAUNCHES == before  # CPU tensors: the twin
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    assert np.abs(jdp).max() > 1.0 and abs(float(jdkr)) > 1.0
    np.testing.assert_allclose(tp.grad.numpy(), jdp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kr.grad.numpy(), jdkr, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m3.grad.numpy(), jdm6[:3], rtol=1e-4,
                               atol=1e-5)


def _rays(R=32):
    """The rays, state and words of test_medium_level_grad_matches_fd, as
    numpy arrays."""
    ths = np.linspace(-0.12, 0.12, R, dtype=np.float32)
    ro = np.tile(np.array([[0.0, 1.0, 3.8]], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) - 0.02,
                   -np.cos(ths)], axis=-1).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.uint32)
    uj, near, far = (np.full(R, v, np.float32) for v in (0.5, 2.0, 4.5))
    return ro, rd, pss, uj, near, far


def test_medium_level_grad_matches_jax_and_fd():
    jscene = _jscene()
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    ro, rd, pss, uj, near, far = _rays()
    R = ro.shape[0]
    t = torch.from_numpy

    def port_t(sigma, l):
        med = convert.set_params(tscene, sigma, l).media[0]
        res, _ = tmd.sample_distance(
            med, tscene.scene_seed, t(ro), t(rd), t(near), t(far),
            tmd.MediumState.make(R, "cpu"), t(pss.astype(np.int64)), t(uj),
            torch.ones(R, dtype=torch.bool))
        return res

    sigma0, l0 = (float(x) for x in entry.params(tscene))
    eps = 4e-3
    with torch.no_grad():
        stable = torch.ones(R, dtype=torch.bool)
        for ds, dl in [(0, 0), (eps, 0), (-eps, 0), (0, eps), (0, -eps)]:
            stable &= ~port_t(torch.tensor(sigma0 + ds),
                              torch.tensor(l0 + dl))["exited"]

        def f(sigma, l):
            return float(torch.where(stable, port_t(
                torch.tensor(sigma), torch.tensor(l))["t"], 0.0).sum())
        fd_s = (f(sigma0 + eps, l0) - f(sigma0 - eps, l0)) / (2 * eps)
        fd_l = (f(sigma0, l0 + eps) - f(sigma0, l0 - eps)) / (2 * eps)
    assert int(stable.sum()) >= R // 2

    sigma, l = _leaves(tscene)
    loss = torch.where(stable, port_t(sigma, l)["t"], 0.0).sum()
    gs, gl = torch.autograd.grad(loss, (sigma, l))
    gs, gl = float(gs), float(gl)

    jmask = jnp.asarray(stable.numpy())

    def jloss(sigma, l):
        res, _ = jmd.sample_distance(
            _jset_params(jscene, sigma, l).media[0], jscene.scene_seed,
            jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near),
            jnp.asarray(far), jmd.MediumState.make(R), jnp.asarray(pss),
            jnp.asarray(uj), jnp.ones(R, bool))
        return jnp.sum(jnp.where(jmask, res["t"], 0.0))

    cov = jscene.media[0].gp.cov
    jg = _compiled(jax.grad(jloss, argnums=(0, 1)), cov.sigma, cov.l)(
        cov.sigma, cov.l)
    assert abs(gs) > 0.0 and abs(gl) > 0.0
    np.testing.assert_allclose([gs, gl], [float(jg[0]), float(jg[1])],
                               rtol=1e-3)
    np.testing.assert_allclose(gs, fd_s, rtol=0.15, atol=0.5)
    np.testing.assert_allclose(gl, fd_l, rtol=0.15, atol=0.5)


@pytest.fixture(scope="module")
def jax_image_grads():
    """gradcheck.py's 16x16, 1-spp, depth-2 pass in JAX, compiled once for
    both image-level tests: the values of sum(image) and of
    dryrun_multichip's loss_rows, sum((image - 0) ** 2), and their jax.grad
    in (sigma, l) (one jacrev of the two)."""
    jscene = _jscene(res=16)
    px, py = jnp.meshgrid(jnp.arange(16, dtype=jnp.int32),
                          jnp.arange(16, dtype=jnp.int32))
    px, py = px.reshape(-1), py.reshape(-1)
    target = jnp.zeros((16, 16, 3), jnp.float32)

    def losses(sigma, l):
        img = jtrace(_jset_params(jscene, sigma, l), px, py,
                     jnp.int32(0)).reshape(16, 16, 3)
        v = jnp.stack([jnp.sum(img), jnp.sum((img - target) ** 2)])
        return v, v

    cov = jscene.media[0].gp.cov
    (js, jl), v = _compiled(jax.jacrev(losses, argnums=(0, 1), has_aux=True),
                            cov.sigma, cov.l)(cov.sigma, cov.l)
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    return tscene, np.asarray(v), np.asarray(js), np.asarray(jl)


def test_image_grad_matches_jax(jax_image_grads):
    tscene, _, js, jl = jax_image_grads
    img, (gs, gl) = entry.fwd_bwd(tscene, 0)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert abs(js[0]) > 1.0 and abs(jl[0]) > 1.0
    np.testing.assert_allclose([float(gs), float(gl)], [js[0], jl[0]],
                               rtol=1e-2)


def test_reattach_ratio():
    x = torch.tensor([2.0, -0.5, 0.0, 1e-13], requires_grad=True)
    f = x * x * x
    ratio = tint._reattach_ratio(f)
    assert torch.equal(ratio.detach(), torch.ones(4))
    (g,) = torch.autograd.grad(ratio.sum(), x)
    assert bool(torch.isfinite(g).all())
    # grad log f = 3 / x where |f| > 1e-12; 0 elsewhere
    np.testing.assert_allclose(g.numpy(), [1.5, -6.0, 0.0, 0.0], rtol=1e-6)


def test_grad_render_has_the_plain_value_and_train_step(jax_image_grads):
    tscene, v, js, jl = jax_image_grads
    calls = []
    twin = noise3d.noise3d_sum_s_bwd_ref

    def counted(*args):
        calls.append(1)
        return twin(*args)

    noise3d.noise3d_sum_s_bwd_ref = counted
    try:
        plain = render_pass(tscene, 0)
        assert not plain.requires_grad and not calls
        target = torch.zeros_like(plain)
        s1, l1, loss, (gs, gl) = entry.train_step(tscene, target, 0)
        assert calls  # the backward went through K1's backward
    finally:
        noise3d.noise3d_sum_s_bwd_ref = twin
    # the graph's render has the plain render's value: the same loss, bit
    # for bit
    assert float(loss) == float(((plain - target) ** 2).mean())
    for x in (loss, s1, l1, gs, gl):
        assert bool(torch.isfinite(x))
    # train_step's mean is step_shard's sum over 3 * 16 * 16 values at 1 spp
    n = plain.numel()
    assert abs(js[1]) > 1.0 and abs(jl[1]) > 1.0
    np.testing.assert_allclose(float(loss) * n, v[1], rtol=1e-2)
    np.testing.assert_allclose([float(gs) * n, float(gl) * n],
                               [js[1], jl[1]], rtol=1e-2)
    sigma, l = (x.detach() for x in entry.params(tscene))
    assert float(s1) == float(sigma - 1e-3 * gs)
    assert float(l1) == float(l - 1e-3 * gl)


def test_unported_backwards_refuse_by_name():
    p = torch.zeros(4, 3, requires_grad=True)
    seed = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="noise3d_sum_diff"):
        noise3d.noise3d_sum(p, seed, torch.ones(4), torch.ones(4),
                            [1.0] * 3 + [0.0] * 3, 3)
    with pytest.raises(NotImplementedError, match="noise1d_sum_diff"):
        noise1d.noise1d_sum(torch.zeros(4, requires_grad=True), seed, 3.0, 3)
    with pytest.raises(NotImplementedError, match="noise3d_sum_s_diff"):
        noise3d.noise3d_sum_s(p, seed, 0.25, [1.0] * 3 + [0.0] * 3, 3)
    # the weight-space gradient is ported: finite and nonzero
    from tungsten_tpu_torch.scene.parse import load_scene
    ws, _ = load_scene(WS_SCENE, res_override=(4, 4), device="cpu")
    ws = dataclasses.replace(ws, media=(dataclasses.replace(
        ws.media[0], basis_functions=64),))
    sigma, l = _leaves(ws)
    img = render_pass(convert.set_params(ws, sigma, l), torch.tensor([0, 1]))
    grads = torch.autograd.grad(img.sum(), (sigma, l))
    assert all(bool(torch.isfinite(g)) and float(g) != 0.0 for g in grads)
