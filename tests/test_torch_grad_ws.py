"""The port's hyperparameter gradient of BASELINE config 4a (weight space,
`scenes/gpis-weight-space.json`) against the JAX package on the CPU, with
64 basis functions on both sides.

The search (K5 for step_size 0.02, K4 for step_size 0) runs on detached
parameters; the crossing is reattached by the IFT through the realization,
rebuilt in the graph for the hit rays (models/media.py `_ws_reattach`,
ops/weight_space.py `noise_at`).

Tolerances:
- sample_distance's d sum(t) / d(sigma, l) on the 32 rays of
  tests/test_grad_e2e.py::test_medium_level_grad_matches_fd, over the
  lanes that hit at every FD evaluation: within 1e-3 relative of jax.grad
  (JAX's search in its Pallas kernels in interpret mode, the algorithm the
  port's twins follow), and within rtol 0.15, atol 0.5 of the port's own
  central FD at eps 1e-3.  The phases scale as 1 / l, so a larger eps
  leaves the realization's linear regime.
- `noise_at`'s backward against autograd through `ws.evaluate` /
  `ws.evaluate_gradient` of `realization_from_key`: rtol 1e-4, atol 1e-5.
- fwd_bwd's image equals the plain render's bit for bit, for both step
  sizes; a train_step's gradient is finite and nonzero.
- JAX's sample_distance is compiled at XLA's backend optimization level
  0, as in tests/test_torch_grad.py.
The 8x8 image-level gradient is in tests/test_torch_image_grad.py.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import weight_space as tws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
N_BASIS = 64
FD_EPS = 1e-3


def _compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _scenes(step_size=0.02, res=None):
    """(JAX scene, the port's scene converted from it) of config 4a with
    N_BASIS basis functions (march_block 1 on the JAX side)."""
    with open(SCENE) as f:
        doc = json.load(f)
    doc["media"][0]["basis_functions"] = N_BASIS
    doc["media"][0]["step_size"] = step_size
    if res is not None:
        doc["camera"]["resolution"] = [res, res]
    jscene, _ = jscene_from_dict(doc)
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


def _jset_params(scene, sigma, l):
    cov = dataclasses.replace(scene.media[0].gp.cov, sigma=sigma, l=l)
    med = dataclasses.replace(scene.media[0],
                              gp=dataclasses.replace(scene.media[0].gp,
                                                     cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


def _leaves(tscene):
    return tuple(x.detach().clone().requires_grad_()
                 for x in entry.params(tscene))


def _rays(R=32):
    """The rays of test_medium_level_grad_matches_fd, as numpy arrays."""
    ths = np.linspace(-0.12, 0.12, R, dtype=np.float32)
    ro = np.tile(np.array([[0.0, 1.0, 3.8]], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) - 0.02,
                   -np.cos(ths)], axis=-1).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.uint32)
    uj, near, far = (np.full(R, v, np.float32) for v in (0.5, 2.0, 4.5))
    return ro, rd, pss, uj, near, far


def test_noise_at_backward_matches_autograd_of_evaluate():
    """noise_at's analytic backward (d/dp and d/dl of the noise sum and its
    gradient) equals autograd through the realization built in the graph,
    and its hold of the Hessian carries the gradient to a moved point."""
    _, tscene = _scenes()
    med = tscene.media[0]
    r = np.random.default_rng(11)
    R = 40
    p0 = torch.from_numpy(r.uniform(-1.0, 2.0, (R, 3)).astype(np.float32))
    key = torch.from_numpy(r.integers(0, 2 ** 32, R, dtype=np.uint64)
                           .astype(np.int64))
    gv = torch.from_numpy(r.normal(size=R).astype(np.float32))
    gg = torch.from_numpy(r.normal(size=(R, 3)).astype(np.float32))
    sigma, l = _leaves(tscene)
    cov = dataclasses.replace(med.gp.cov, sigma=sigma, l=l)
    gp = dataclasses.replace(med.gp, cov=cov)

    p = p0.clone().requires_grad_()
    real = tws.realization_from_key(cov, N_BASIS, key)
    f, _ = tws.evaluate(real, gp, p)
    g = tws.evaluate_gradient(real, gp, p)
    want = torch.autograd.grad((f * gv).sum() + (g * gg).sum(), (p, sigma, l))

    p = p0.clone().requires_grad_()
    s, gn, hs = tws.noise_at(cov, N_BASIS, key, p)
    scale = torch.sqrt(cov.cov(p, p))
    f2 = scale * s + gp.mean.mean(p)
    g2 = scale[:, None] * gn + gp.mean.grad(p)
    got = torch.autograd.grad((f2 * gv).sum() + (g2 * gg).sum(),
                              (p, sigma, l))
    np.testing.assert_allclose(f2.detach(), f.detach(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g2.detach(), g.detach(), rtol=1e-5, atol=1e-5)
    assert abs(float(want[2])) > 1.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    # the held Hessian is the Jacobian of the noise gradient
    def jac(fn):
        return torch.autograd.functional.jacobian(
            lambda q: fn(q).sum(0), p0).permute(1, 0, 2)
    want_h = jac(lambda q: tws.evaluate_gradient(real, gp, q)) - jac(
        gp.mean.grad)
    np.testing.assert_allclose(
        (scale.detach()[:, None, None] * hs).numpy(), want_h.numpy(),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("step_size", [0.02, 0.0])
def test_medium_level_grad_matches_jax_and_fd(monkeypatch, step_size):
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jscene, tscene = _scenes(step_size)
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
    eps = FD_EPS
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
    res = port_t(sigma, l)
    loss = torch.where(stable, res["t"], 0.0).sum()
    gs, gl = torch.autograd.grad(loss, (sigma, l))
    gs, gl = float(gs), float(gl)
    with torch.no_grad():
        plain = port_t(*(x.detach() for x in (sigma, l)))
    assert torch.equal(res["t"].detach(), plain["t"])
    assert torch.equal(res["aniso"].detach(), plain["aniso"])

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


@pytest.mark.parametrize("step_size", [0.02, 0.0])
def test_fwd_bwd_image_equals_the_plain_render_and_train_step(step_size):
    _, tscene = _scenes(step_size, res=8)
    img, (gs, gl) = entry.fwd_bwd(tscene, torch.tensor([0, 1]))
    plain = trender.render(tscene, 2, device="cpu")
    assert torch.equal(img, plain)
    assert all(np.isfinite(float(g)) and float(g) != 0.0 for g in (gs, gl))
    sigma, l, loss, (ds, dl) = entry.train_step(
        tscene, torch.zeros(8, 8, 3), torch.tensor([0, 1]))
    np.testing.assert_allclose(float(loss), float(((plain / 2) ** 2).mean()),
                               rtol=1e-6)
    assert all(np.isfinite(float(g)) and float(g) != 0.0 for g in (ds, dl))
    s0, l0 = (x.detach() for x in entry.params(tscene))
    assert float(sigma) == float(s0 - 1e-3 * ds)
    assert float(l) == float(l0 - 1e-3 * dl)
