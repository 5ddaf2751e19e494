"""The gradient in (sigma, l) through the GP layer's means, fields,
microfacet normals and the weight-space covariances beside the SE, against
the JAX package on the CPU (tungsten_tpu_torch/ops/means.py, fields.py,
models/media.py `microfacet_normal` and `_ws_reattach`,
ops/weight_space.py `noise_at`), and the GP types whose gradient JAX
itself cannot take, which the port refuses by name.

Tolerances:
- The medium-level gradient (tests/torch_grad_common.py: the reattached t
  over the lanes central FD resolves, the normal and, for the fields, the
  scatter weight and emission): within 1e-3 of jax.grad, and within rtol
  0.15, atol 0.5 of central FD.  The weight-space variants run with 64
  basis functions on both sides and JAX's search in its Pallas kernels in
  interpret mode (TUNGSTEN_TPU_PALLAS=1), whose algorithm the port's
  twins follow, as tests/test_torch_grad_ws.py does.
- `noise_at`'s analytic backward (dS/dl = a / l, which holds when the
  spectral draw scales as 1 / l) for the RQ and Matérn covariances
  against autograd through the realization rebuilt in the graph: rtol
  1e-4, atol 1e-5 (tests/test_torch_grad_ws.py's limits for the SE).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grad_common as common
from tungsten_tpu.scene.parse import parse_mean as jparse_mean
from tungsten_tpu_torch import entry
from tungsten_tpu_torch.ops import weight_space as tws
from tungsten_tpu_torch.scene.parse import scene_from_dict
from tungsten_tpu_torch.tools.gp_variants import variant_docs

N_BASIS = 64
GABOR = {"gabor_aniso": {"type": "gabor_aniso", "sigma": 0.06, "a_inv": 0.3,
                         "f_inv": 0.2, "omega": [1.0, 0.0, 0.0]},
         "gabor_iso": {"type": "gabor_iso", "sigma": 0.06, "a_inv": 0.3,
                       "f_inv": 0.2}}


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    docs = {k: v[1] for k, v in variant_docs(
        str(tmp_path_factory.mktemp("gp_layer_variants"))).items()}

    def edit(name, fn):
        doc = json.loads(json.dumps(docs[name]))
        fn(doc["media"][0], doc["media"][0]["gaussian_process"])
        return doc
    # the GP's color and emission fields, on config 1's spherical mean
    docs["box-fields"] = edit("box-knob", lambda m, g: g.update(mean={
        "type": "spherical", "center": [0.0, 0.9, 0.0], "radius": 0.45,
        "color": {"type": "noise", "noise": "rust"},
        "emission": {"type": "noise", "noise": "rust", "min": 0.1,
                     "max": 2.0}}))
    docs["box-beckmann"] = edit("box-ggx", lambda m, g: m.update(
        normal_method="beckmann"))
    # the CSG union's additional mean on a weight-space medium
    docs["ws-csg"] = edit("ws-linear", lambda m, g: m.update(
        gaussian_process={"type": "csg", "left": {
            "mean": {"type": "spherical", "center": [0.0, 0.9, 0.0],
                     "radius": 0.45}, "covariance": g["covariance"]},
            "right": {"mean": {"type": "spherical",
                               "center": [0.3, 1.1, 0.2], "radius": 0.25},
                      "covariance": g["covariance"]}}))
    return docs


# (variant, segments, the fields' loss held, FD held): K4's sphere trace
# (step_size 0) stops off the root and the IFT is taken there, as JAX
# takes it, so its FD is not held (ROADMAP queue 3, config 4a's K4)
MEDIUM_CASES = [("box-mesh", 1, False, True), ("box-csg", 1, False, True),
                ("box-fields", 1, True, True), ("box-ggx", 1, False, True),
                ("box-beckmann", 1, False, True), ("ws-rq", 2, False, True),
                ("ws-matern", 2, False, True),
                ("ws-rq-trace", 1, False, False),
                ("ws-linear", 1, False, True), ("ws-csg", 1, False, True)]


@pytest.mark.parametrize("name, segments, fields, fd", MEDIUM_CASES)
def test_medium_level_grad_matches_jax_and_fd(docs, name, segments, fields,
                                              fd, monkeypatch):
    ws = name.startswith("ws")
    if ws:
        monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jscene, tscene = common.scenes(docs[name],
                                   basis_functions=N_BASIS if ws else None)
    out = common.medium_grads(jscene, tscene, "ws" if ws else "box",
                              segments, fields, fd)
    assert max(out["lanes"]) > 0 or not fd, out


@pytest.mark.parametrize("cov", ["rq", "matern"])
def test_noise_at_backward_matches_autograd_per_covariance(docs, cov):
    """`_Noise.backward` takes the phase's l-dependence as u ~ 1 / l: the
    RQ's Gamma precision is drawn at l = 1 and scaled by 1 / l^2, the
    Matérn's chi-square does not see l, so both draws are omega(l) =
    omega(1) / l, and the analytic backward equals autograd through
    `ws.evaluate` of the realization built with l in the graph."""
    _, tscene = common.scenes(docs[f"ws-{cov}"], basis_functions=N_BASIS)
    med = tscene.media[0]
    r = np.random.default_rng(12)
    n = 40
    p0 = torch.from_numpy(r.uniform(-1.0, 2.0, (n, 3)).astype(np.float32))
    key = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                           .astype(np.int64))
    gv = torch.from_numpy(r.normal(size=n).astype(np.float32))
    gg = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    sigma, l = common.leaves(tscene)
    c = dataclasses.replace(med.gp.cov, sigma=sigma, l=l)
    gp = dataclasses.replace(med.gp, cov=c)
    # the draw at 2 l is the draw at l over 2, word for word
    with torch.no_grad():
        b1 = tws.sample_basis(c, N_BASIS, key)
        b2 = tws.sample_basis(dataclasses.replace(c, l=2.0 * l), N_BASIS,
                              key)
    np.testing.assert_allclose((2.0 * b2.freqs).numpy(), b1.freqs.numpy(),
                               rtol=1e-6)

    p = p0.clone().requires_grad_()
    real = tws.realization_from_key(c, N_BASIS, key)
    f, _ = tws.evaluate(real, gp, p)
    g = tws.evaluate_gradient(real, gp, p)
    want = torch.autograd.grad((f * gv).sum() + (g * gg).sum(), (p, sigma, l))
    p = p0.clone().requires_grad_()
    s, gn, _ = tws.noise_at(c, N_BASIS, key, p)
    scale = torch.sqrt(c.cov(p, p))
    f2 = scale * s + gp.mean.mean(p)
    g2 = scale[:, None] * gn + gp.mean.grad(p)
    got = torch.autograd.grad((f2 * gv).sum() + (g2 * gg).sum(),
                              (p, sigma, l))
    assert abs(float(want[2])) > 1.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", sorted(GABOR))
def test_gabor_gradient_fails_in_jax_and_is_refused_by_name(docs, kind):
    """The Gabor covariances have no length scale: the JAX package's
    set_params (gradcheck.py, `dataclasses.replace(cov, sigma=, l=)`)
    raises on them, so the port's gradient entry points refuse them by
    name (ROADMAP queue 3)."""
    doc = json.loads(json.dumps(docs["ws-rq"]))
    doc["media"][0]["gaussian_process"]["covariance"] = GABOR[kind]
    doc["media"][0]["basis_functions"] = N_BASIS
    jscene, _ = common.scenes(doc)
    cov = jscene.media[0].gp.cov
    with pytest.raises(TypeError, match="'l'"):
        common.jset_params(jscene, cov.sigma, cov.sigma)
    scene, _ = scene_from_dict(doc, device="cpu")
    with pytest.raises(NotImplementedError, match="Gabor.*no length scale"):
        entry.fwd_bwd(scene, 0)
    with pytest.raises(NotImplementedError, match="Gabor"):
        entry.train_step(scene, torch.zeros(8, 8, 3), torch.arange(1))


@pytest.mark.parametrize("func", ["knob", "knob_outer"])
def test_knob_gradient_is_nan_in_jax_and_refused_by_name(docs, func):
    """The knob SDF's capped cylinder takes sqrt(relu(dx)^2 + relu(dy)^2),
    whose gradient at 0 (inside the cylinder, both distances negative) is
    inf * 0 = NaN in jax.grad, and the maximum that masks it passes the NaN
    on: the crossing's t, which moves the mean's point, takes it (ROADMAP
    queue 3).  The port refuses the knob means' gradient by name; knob_inner
    (a sphere) is not refused."""
    inside = jnp.asarray([0.1, -0.62, 0.05])  # in the base's cylinder

    def grad(fn):
        mean = jparse_mean({"type": "procedural", "func": fn})
        return np.asarray(jax.grad(mean.mean)(inside))
    assert np.isnan(grad(func)).all()
    assert np.isfinite(grad("knob_inner")).all()
    sdoc = json.loads(json.dumps(docs["box-knob"]))
    sdoc["media"][0]["gaussian_process"]["mean"]["func"] = func
    scene, _ = scene_from_dict(sdoc, device="cpu")
    with pytest.raises(NotImplementedError, match="knob mean.*NaN"):
        entry.fwd_bwd(scene, 0)
    sdoc["media"][0]["gaussian_process"]["mean"]["func"] = "knob_inner"
    scene, _ = scene_from_dict(sdoc, device="cpu")
    entry._check_gradient_scope(scene)
