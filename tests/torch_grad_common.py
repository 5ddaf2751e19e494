"""What tests/test_torch_grad_sampling.py, test_torch_grad_gp_layer.py and
test_torch_grad_mirror.py share: a variant scene (tools/gp_variants.py)
on both sides, and the medium-level gradient of the port against JAX's
jax.grad and the port's own central FD.

The medium-level gradient takes the rays of the JAX package's
tests/test_grad_e2e.py::test_medium_level_grad_matches_fd for the scene's
family (SPECS) through sample_distance, in one segment or, where the
context conditions, in two (the second from each first crossing on along
the ray, conditioned at its start on the first crossing's value and
normal).  The losses, whose gradients in (sigma, l) are held:
- sum(s (t1 + t2)) over the lanes whose central FD resolves in sigma, s
  the sign of the lane's own FD (so that the lanes' partials add), and
- the same in l over the lanes whose FD resolves in l
  (tungsten_tpu_torch/utils/fd.py `fd_lanes` at two steps: every
  evaluation hits, the differences at eps and eps / 4 agree within 10% +
  0.05, and t moves at each step), each against jax.grad within 1e-3
  relative and against the port's central FD at eps / 4 within rtol
  0.15, atol 0.5 (the limits of tests/test_grad_e2e.py); a variant whose
  FD resolves no lane is held to JAX alone;
- sum(v . n1), the first crossing's normal against fixed unit vectors v
  over the hit lanes, against jax.grad within 1e-3 relative;
- with `fields`, sum(v . (w1 + e1)), the first crossing's scatter weight
  (the GP's color there) and volume emission, likewise.
Where the normal's or the fields' sum over lanes cancels, "relative" is
to a tenth of the sum of its lanes' |partials| (the port's, one backward
a lane) when that is the larger: a sum that cancels to 1e-3 of its terms
keeps their rounding.
JAX's side is compiled once per scene (one jacrev of the losses, at
XLA's backend optimization level 0, as tests/test_torch_grad.py does).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.utils.fd import fd_lanes

R = 32
# per scene family: (origin, half-angle of the fan, y of the direction,
# near, FD steps in sigma and l)
SPECS = {"box": ((0.0, 1.0, 3.8), 0.12, -0.02, 2.0, (4e-3, 4e-3)),
         "hero": ((0.0, 1.0, 3.8), 0.10, -0.03, 2.0, (5e-4, 5e-4)),
         "m1d": ((0.0, 0.9, 3.0), 0.15, -0.01, 1.2, (2e-3, 2e-3)),
         "ws": ((0.0, 1.0, 3.8), 0.12, -0.02, 2.0, (1e-3, 1e-4))}
FAR, SECOND_FAR = 4.5, 3.0
JAX_RTOL = 1e-3
LANE_SHARE = 0.1
FD_RTOL, FD_ATOL = 0.15, 0.5


def compiled(f, *args):
    """jax.jit(f) compiled for args at XLA's backend optimization level 0."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def scenes(doc, basis_functions=None, **medium):
    """(JAX scene with march_block 1, the port's scene converted from it)
    of scene dict `doc`, medium 0 updated with `medium` (and, for a
    weight-space medium, cut to `basis_functions`)."""
    doc = json.loads(json.dumps(doc))
    doc["media"][0].update(medium)
    if basis_functions is not None:
        doc["media"][0]["basis_functions"] = basis_functions
    jscene, _ = jscene_from_dict(doc)
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


def jparams(jscene):
    cov = jscene.media[0].gp.cov
    return cov if cov.is_stationary else cov.base


def jset_params(scene, sigma, l):
    """The JAX scene with (sigma, l) of medium 0's covariance (of its base,
    when nonstationary) replaced, as convert.set_params does."""
    med = scene.media[0]
    cov = med.gp.cov
    if cov.is_stationary:
        cov = dataclasses.replace(cov, sigma=sigma, l=l)
    else:
        cov = dataclasses.replace(cov, base=dataclasses.replace(
            cov.base, sigma=sigma, l=l))
    med = dataclasses.replace(med, gp=dataclasses.replace(med.gp, cov=cov))
    return dataclasses.replace(scene, media=(med,) + scene.media[1:])


def leaves(tscene):
    return tuple(x.detach().clone().requires_grad_()
                 for x in entry.params(tscene))


def rays(family):
    """(ro, rd, pss, uj, near, far, v) of the family's fan, numpy; v are
    the fixed unit vectors of the normal loss."""
    origin, half, dy, near = SPECS[family][:4]
    ths = np.linspace(-half, half, R, dtype=np.float32)
    ro = np.tile(np.array([origin], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) + dy,
                   -np.cos(ths)], axis=-1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.uint32)
    v = np.random.default_rng(17).normal(size=(R, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    uj, near_, far = (np.full(R, x, np.float32) for x in (0.5, near, FAR))
    return ro, rd, pss, uj, near_, far, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_run(tscene, sigma, l, fan, segments):
    """The port's sample_distance over the fan: [first result] or [first,
    second]."""
    ro, rd, pss, uj, near, far, _ = (_t(a) for a in fan)
    pss = pss.to(torch.int64)
    med = convert.set_params(tscene, sigma, l).media[0]
    r1, st = tmd.sample_distance(med, tscene.scene_seed, ro, rd, near, far,
                                 tmd.MediumState.make(R, "cpu"), pss, uj,
                                 torch.ones(R, dtype=torch.bool))
    if segments == 1:
        return [r1]
    r2, _ = tmd.sample_distance(
        med, tscene.scene_seed, ro + r1["t"][:, None] * rd, rd,
        torch.zeros(R), torch.full((R,), SECOND_FAR), st,
        pss + torch.tensor([0, 0, 0, 1]), uj, ~r1["exited"])
    return [r1, r2]


def jax_run(jscene, sigma, l, fan, segments):
    ro, rd, pss, uj, near, far, _ = (jnp.asarray(a) for a in fan)
    med = jset_params(jscene, sigma, l).media[0]
    r1, st = jmd.sample_distance(med, jscene.scene_seed, ro, rd, near, far,
                                 jmd.MediumState.make(R), pss, uj,
                                 jnp.ones(R, bool))
    if segments == 1:
        return [r1]
    r2, _ = jmd.sample_distance(
        med, jscene.scene_seed, ro + r1["t"][:, None] * rd, rd,
        jnp.zeros(R), jnp.full(R, SECOND_FAR), st,
        pss + jnp.asarray([0, 0, 0, 1], jnp.uint32), uj, ~r1["exited"])
    return [r1, r2]


def _losses(res, w_s, w_l, v, where, stack):
    t = sum(r["t"] for r in res)
    hit = ~res[0]["exited"]
    n_term = (res[0]["aniso"] * v).sum(-1)
    f_term = ((res[0]["weight"] + res[0]["emission"]) * v).sum(-1)
    return stack([(w_s * t).sum(), (w_l * t).sum(),
                  where(hit, n_term, 0.0).sum(),
                  where(hit, f_term, 0.0).sum()])


def medium_grads(jscene, tscene, family, segments=1, fields=False,
                 fd=True):
    """The losses' gradients (module docstring) of the port and of JAX,
    and the FD of the first two: {"port": [4, 2], "jax": [4, 2],
    "fd": (sigma's, l's), "lanes": (sigma's, l's), "hits": first-segment
    hits}.  Asserts the port against JAX and (with `fd`) FD."""
    fan = rays(family)
    eps_s, eps_l = SPECS[family][4]
    params = tuple(float(x) for x in entry.params(tscene))

    def run(sigma, l):
        return port_run(tscene, sigma, l, fan, segments)

    lanes_s, fd_s = fd_lanes(run, params, 0, eps_s, n_steps=2)
    lanes_l, fd_l = fd_lanes(run, params, 1, eps_l, n_steps=2)
    sigma, l = leaves(tscene)
    res = run(sigma, l)
    hit = torch.ones(R, dtype=torch.bool)
    for r in res:
        hit &= ~r["exited"]
    # each lane's t weighed by the sign of its own FD, so that the lanes'
    # partials add rather than cancel
    w_s = torch.where(lanes_s & hit, torch.sign(fd_s), 0.0)
    w_l = torch.where(lanes_l & hit, torch.sign(fd_l), 0.0)
    fd_s, fd_l = float((w_s * fd_s).sum()), float((w_l * fd_l).sum())
    losses = _losses(res, w_s, w_l, _t(fan[-1]), torch.where, torch.stack)
    port = np.array([[float(g) if g is not None else 0.0
                      for g in torch.autograd.grad(
                          losses[k], (sigma, l), retain_graph=True,
                          allow_unused=True)] for k in range(4)])

    def lane_sums(k):
        """The sum over the loss's lanes of their own |partials|, which
        scales the limit where the loss's sum over lanes cancels."""
        v = _t(fan[-1])
        y = ((res[0]["aniso"] * v).sum(-1) if k == 2
             else ((res[0]["weight"] + res[0]["emission"]) * v).sum(-1))
        mag = np.zeros(2)
        for i in range(R):
            if bool(~res[0]["exited"][i]) and y[i].requires_grad:
                mag += np.abs([float(g) for g in torch.autograd.grad(
                    y[i], (sigma, l), retain_graph=True)])
        return mag

    def jlosses(sigma, l, m_s, m_l):
        jres = jax_run(jscene, sigma, l, fan, segments)
        return _losses(jres, m_s, m_l, jnp.asarray(fan[-1]), jnp.where,
                       jnp.stack)

    cov = jparams(jscene)
    m_s, m_l = jnp.asarray(w_s.numpy()), jnp.asarray(w_l.numpy())
    jac = compiled(jax.jacrev(jlosses, argnums=(0, 1)), cov.sigma, cov.l,
                   m_s, m_l)(cov.sigma, cov.l, m_s, m_l)
    jg = np.stack([np.asarray(jac[0]), np.asarray(jac[1])], axis=-1)
    hits = int((~res[0]["exited"]).sum())
    out = {"port": port, "jax": jg, "fd": (fd_s, fd_l),
           "lanes": (int((w_s != 0).sum()), int((w_l != 0).sum())),
           "hits": hits}
    assert hits >= R // 2, out
    assert np.isfinite(port).all() and np.isfinite(jg).all(), out
    # the t losses in their own parameter, and the normal loss in both
    held = [(i, i) for i in range(2) if out["lanes"][i]] + [(2, 0), (2, 1)]
    if fields:
        held += [(3, 0), (3, 1)]
    for k, i in held:
        assert port[k, i] != 0.0, (k, i, out)
        err = abs(port[k, i] - jg[k, i])
        if err > JAX_RTOL * abs(jg[k, i]):
            out[f"lane_sums {k}"] = mag = (lane_sums(k) if k >= 2
                                           else np.zeros(2))
            assert err <= JAX_RTOL * LANE_SHARE * mag[i], (k, i, out)
    for i in range(2):
        if fd and out["lanes"][i]:
            np.testing.assert_allclose(port[i, i], out["fd"][i], rtol=FD_RTOL,
                                       atol=FD_ATOL,
                                       err_msg=f"FD, parameter {i}: {out}")
    return out
