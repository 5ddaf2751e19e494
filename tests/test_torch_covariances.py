"""The port's covariances (ops/covariance.py, ops/gp.py) against the JAX
package on the CPU: every covariance type's value, variance, roughness
and spectral draw, and the function-space rows of any covariance by
forward mode.  Inputs are made with numpy from a seed and handed to both
packages.

Tolerances:
- The draws' hash words and uniforms (the counters each draw reads) and
  the basis offsets: bit for bit (the same integer and float32 ops).
- cov, variance, roughness, and the basis dirs, freqs and weights: rtol
  1e-5, atol 1e-6 (the two libraries' log1p, log, pow, cos and sin may
  differ by an ulp; every other op is the same).
- The rows of `gp.cov_entry` by torch.func.jvp against jax.jvp: rtol
  1e-4, atol 1e-6 (derivatives of float32 sums, through pow and sqrt).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.ops import covariance as jcv
from tungsten_tpu.ops import gp as jgp
from tungsten_tpu.ops import weight_space as jws
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch import convert
from tungsten_tpu_torch.ops import gp as tgp
from tungsten_tpu_torch.ops import weight_space as tws
from tungsten_tpu_torch.scene.parse import parse_cov
from tungsten_tpu_torch.utils import rng as trng

RTOL, ATOL = 1e-5, 1e-6

# every covariance type of the JAX package's parser, as a scene file
# writes it
COVS = {
    "se": {"type": "squared_exponential", "sigma": 0.7, "lengthScale": 0.3,
           "aniso": [1.0, 0.5, 2.0]},
    "se_mtx": {"type": "squared_exponential", "sigma": 0.7,
               "lengthScale": 0.3,
               "anisoMtx": [[1.0, 0.2, 0.0], [0.1, 0.8, 0.3],
                            [0.0, 0.2, 1.2]]},
    "rq": {"type": "rational_quadratic", "sigma": 0.6, "lengthScale": 0.4,
           "a": 1.5, "aniso": [1.0, 2.0, 0.5]},
    "rq_small_a": {"type": "rational_quadratic", "a": 0.45},
    "matern05": {"type": "matern", "sigma": 0.5, "lengthScale": 0.3,
                 "v": 0.5},
    "matern15": {"type": "matern", "sigma": 0.5, "lengthScale": 0.3},
    "matern25": {"type": "matern", "sigma": 0.5, "lengthScale": 0.3,
                 "v": 2.5, "aniso": [1.0, 1.5, 0.7]},
    "gabor_aniso": {"type": "gabor_aniso", "sigma": 0.8, "a_inv": 0.5,
                    "f_inv": 0.4, "omega": [1.0, 2.0, 0.5]},
    "gabor_iso": {"type": "gabor_iso", "sigma": 0.8, "a_inv": 0.5,
                  "f_inv": 0.4},
    "periodic": {"type": "periodic", "sigma": 0.9, "lengthScale": 0.6,
                 "period": 0.8},
    "thin_plate": {"type": "thin_plate", "sigma": 0.9, "R": 0.7},
    "dot_product": {"type": "dot_product", "sigma": 0.9, "c": 0.3},
}


def _jcov(name):
    from tungsten_tpu.scene.parse import parse_cov as jparse_cov
    return jparse_cov(COVS[name])


def _pair(name):
    """(JAX covariance, the port's parsed from the same document)."""
    return _jcov(name), parse_cov(COVS[name], "cpu")


def _points(seed, n=64):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 3)).astype(np.float32),
            r.normal(size=(n, 3)).astype(np.float32) * 0.4)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(COVS))
def test_parsed_equals_converted(name):
    """The parser's covariance holds the JAX package's numbers."""
    jc, tc = _pair(name)
    got = convert.flatten(tc)
    want = convert.flatten(convert.gp_from_numpy(convert.flatten(jc),
                                                 device="cpu"))
    assert got.keys() == want.keys()
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        else:
            assert v == want[k], k


@pytest.mark.parametrize("name", sorted(COVS))
def test_cov_matches_jax(name):
    jc, tc = _pair(name)
    a, d = _points(1)
    b = a + d
    want = np.asarray(jax.vmap(jc.cov)(jnp.asarray(a), jnp.asarray(b)))
    got = tc.cov(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    same = tc.cov(_t(a), _t(a)).numpy()
    np.testing.assert_allclose(
        same, np.asarray(jax.vmap(jc.cov)(jnp.asarray(a), jnp.asarray(a))),
        rtol=RTOL, atol=ATOL)
    for fn in ("variance", "amplitude"):
        if hasattr(jc, fn):
            np.testing.assert_allclose(
                getattr(tc, fn)(_t(a)).numpy(),
                np.asarray(getattr(jc, fn)(jnp.asarray(a))), rtol=RTOL,
                atol=ATOL)
        else:  # the port has what the JAX package has, no more
            assert not hasattr(tc, fn)


@pytest.mark.parametrize("name", sorted(COVS))
def test_roughness_matches_jax(name):
    jc, tc = _pair(name)
    if not hasattr(jc, "compute_beckmann_roughness"):
        assert not hasattr(tc, "compute_beckmann_roughness")
        return
    p = jnp.zeros(3)
    want = float(jc.compute_beckmann_roughness(p))
    got = float(tc.compute_beckmann_roughness(torch.zeros(3)))
    if name == "gabor_iso":
        # both take the curvature of sinc through r = sqrt(r^2 + 1e-12)
        # at 0, rounding noise times 1e6: only its clamp at 10 (the media
        # clamp the roughness there) is defined
        assert want > 10.0 and got > 10.0
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _keys(seed, R=16):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, R, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", sorted(set(COVS) - {"dot_product"}))
def test_basis_matches_jax(name):
    """Each covariance's own spectral draw: the basis of 16 keys x 40
    basis functions against JAX's sample_basis, and the weights."""
    jc, tc = _pair(name)
    keys = _keys(3)
    n = 40
    jb = jax.jit(jax.vmap(lambda k: jws.sample_basis(jc, n, k)))(
        jnp.asarray(keys))
    tb = tws.sample_basis(tc, n, _t(keys.astype(np.int64)))
    np.testing.assert_array_equal(tb.offsets.numpy(), np.asarray(jb.offsets))
    for got, want in ((tb.dirs, jb.dirs), (tb.freqs, jb.freqs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    jw = jax.vmap(lambda k: jws.sample_weights(n, k))(jnp.asarray(keys))
    tw = tws.sample_weights(n, _t(keys.astype(np.int64)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("counter", ["rq_normal", "rq_uniform",
                                     "matern_uniform"])
def test_draw_streams_bit_exact(counter):
    """The hash words and uniforms the RQ and Matern draws read (RQ's
    proposal k at 16 + 16 i + k and 97 + 16 i + k, Matern's at 5 i + 1)
    equal JAX's for every counter of 64 basis functions."""
    keys = _keys(4, 8)
    i = np.arange(64, dtype=np.uint32)
    ctr = {"rq_normal": [2 * (16 + 16 * i + k) for k in range(4)],
           "rq_uniform": [97 + 16 * i + k for k in range(4)],
           "matern_uniform": [5 * i + 1]}[counter]
    for c in ctr:
        c = c.astype(np.uint32)
        want = np.asarray(jax.vmap(lambda k: jrng.uniform(
            k, jnp.asarray(c)))(jnp.asarray(keys)))
        got = trng.uniform(_t(keys.astype(np.int64))[:, None],
                           _t(c.astype(np.int64))[None])
        np.testing.assert_array_equal(got.numpy(), want)


def test_rq_draw_is_nan_below_a_third_in_jax():
    """JAX's Marsaglia-Tsang draw has d = a - 1/3 <= 0 there: NaN (the
    parser refuses such a weight-space RQ)."""
    jc = jcv.RationalQuadraticCov.create(a=0.3)
    got = np.asarray(jc.sample_spectral_3d(jnp.uint32(7), jnp.uint32(3)))
    assert np.isnan(got).all()


@pytest.mark.parametrize("nu", [1.0, 2.0])
def test_matern_is_nan_off_the_half_integers_in_jax(nu):
    """JAX's Matern blends nu = 0.5, 1.5, 2.5 only: 0/0 elsewhere."""
    jc = jcv.MaternCov.create(nu=nu)
    assert np.isnan(float(jc.cov(jnp.zeros(3), jnp.full(3, 0.1))))


@pytest.mark.parametrize("name", ["rq", "matern25", "gabor_aniso",
                                  "gabor_iso", "periodic", "thin_plate",
                                  "dot_product", "se_mtx"])
def test_cov_rows_by_forward_mode_match_jax(name):
    """Value, first directional derivatives and the mixed second derivative
    (K8's function-space rows) against jax.jvp of the same kernel."""
    jc, tc = _pair(name)
    r = np.random.default_rng(5)
    pa = r.normal(size=(6, 3)).astype(np.float32) * 0.3
    pb = r.normal(size=(5, 3)).astype(np.float32) * 0.3
    da = r.integers(0, 2, 6).astype(np.int32)
    db = r.integers(0, 2, 5).astype(np.int32)
    ua = r.normal(size=(6, 3)).astype(np.float32)
    ub = r.normal(size=(5, 3)).astype(np.float32)
    want = np.asarray(jgp.cov_matrix(jgp.make_cov_fn(
        type("G", (), {"cov": jc})()), jnp.asarray(pa), jnp.asarray(da),
        jnp.asarray(ua), jnp.asarray(pb), jnp.asarray(db), jnp.asarray(ub)))
    got = tgp.cov_matrix(tc, _t(pa)[None], _t(da).long(), _t(ua)[None],
                         _t(pb)[None], _t(db).long(), _t(ub)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=ATOL)


def _scene_doc(name):
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "scenes", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("edit, what", [
    (lambda m, g: g.update(covariance=COVS["gabor_aniso"]), "GaborAnisoCov"),
    (lambda m, g: g.update(covariance=COVS["gabor_iso"]), "GaborIsoCov"),
    (lambda m, g: g.update(mean={"type": "procedural", "func": "knob"}),
     "knob mean"),
])
def test_gradient_of_the_new_types_is_refused(edit, what):
    """The gradient entry points raise by name on the GP types whose
    gradient JAX's own jax.grad cannot take (the Gabor covariances have no
    length scale; the knob SDF's gradient is NaN inside its base: ROADMAP
    queue 3), before rendering.  (The RQ covariance, the linear mean and
    the ggx normal, refused here before, take the gradient now:
    tests/test_torch_grad_gp_layer.py.)"""
    from tungsten_tpu_torch import entry
    from tungsten_tpu_torch.scene.parse import scene_from_dict
    doc = _scene_doc("gpis-weight-space.json")
    edit(doc["media"][0], doc["media"][0]["gaussian_process"])
    scene, _ = scene_from_dict(doc, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        entry.fwd_bwd(scene, 0)


@pytest.mark.parametrize("option", ["isotropic_3D_sampling", "1D_sampling"])
def test_aniso_mtx_with_1d_or_isotropic_sampling_is_refused(option):
    """The gradient of anisoMtx with 1D or isotropic sampling is ported
    (tests/test_torch_grad_sampling.py); what stays refused there is a
    mean whose gradient JAX cannot take: with the knob mean it raises by
    name (ROADMAP queue 3), and with config 1's sphere it is finite."""
    from tungsten_tpu_torch import entry
    from tungsten_tpu_torch.scene.parse import scene_from_dict
    doc = _scene_doc("gpis-sphere-box.json")
    doc["camera"]["resolution"] = [4, 4]
    med = doc["media"][0]
    med[option] = True
    med["gaussian_process"]["covariance"] = COVS["se_mtx"]
    scene, _ = scene_from_dict(doc, device="cpu")
    _, grads = entry.fwd_bwd(scene, torch.arange(2))
    assert all(bool(torch.isfinite(g)) for g in grads)
    med["gaussian_process"]["mean"] = {"type": "procedural",
                                       "func": "knob_outer"}
    scene, _ = scene_from_dict(doc, device="cpu")
    with pytest.raises(NotImplementedError, match="knob mean"):
        entry.fwd_bwd(scene, 0)
