"""The port's nonstationary covariances outside the hero's multi-resolution
noise (ops/nonstationary.py): the procedural and grid (`nonstationary`)
types' Paciorek covariance in weight and function space, the
mean-gradient and neural ones, their spectral draws at a point, and the
grid variance read inline or from a .npz, against the JAX package on the
CPU.  Inputs are made with numpy from a seed.

Tolerances: rtol 1e-5, atol 1e-6 for values, roughness and draws; the
mean-gradient covariance, which solves 3x3 systems and takes
determinants (LU in both libraries, other orders), rtol 1e-4, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.scene.parse import parse_cov as jparse_cov
from tungsten_tpu_torch import convert
from tungsten_tpu_torch.ops import weight_space as tws
from tungsten_tpu_torch.scene.parse import parse_cov

RTOL, ATOL = 1e-5, 1e-6
SE = {"type": "squared_exponential", "sigma": 0.4, "lengthScale": 0.3}
RQ = {"type": "rational_quadratic", "sigma": 0.4, "lengthScale": 0.3,
      "a": 2.0}
_GRID = np.random.default_rng(0).uniform(0.5, 2.0, (4, 5, 6))
COVS = {
    "proc_se": {"type": "proc_nonstationary", "cov": SE,
                "var": {"type": "noise", "noise": "bottom_top", "min": 0.5,
                        "max": 2.0, "start": -1.0, "end": 1.0},
                "ls": {"type": "noise", "noise": "left_right", "min": 0.5,
                       "max": 1.5, "start": -1.0, "end": 1.0}},
    "proc_rq_sandstone": {"type": "proc_nonstationary", "cov": RQ,
                          "var": {"type": "noise", "noise": "sandstone",
                                  "min": 0.5, "max": 1.5},
                          "ls": 1.3},
    "grid_inline": {"type": "nonstationary", "cov": SE, "scale": 0.5,
                    "offset": 0.2,
                    "grid": {"data": _GRID.tolist(),
                             "bounds_min": [-1, -1, -1],
                             "bounds_max": [1, 1, 1]},
                    "multiResolutionGrid": True},
    "mg_se": {"type": "mg_nonstationary", "cov": SE,
              "mean": {"type": "spherical", "center": [0.1, 0.0, 0.0],
                       "radius": 0.5},
              "aniso": [1.0, 0.4, 2.0]},
    "mg_procedural": {"type": "mg_nonstationary", "cov": RQ,
                      "mean": {"type": "procedural", "func": "knob"},
                      "aniso": [0.5, 1.0, 1.5]},
    "neural": {"type": "neural_nonstationary", "cov": SE,
               "network": {"layers": [
                   {"w": np.random.default_rng(1).normal(size=(3, 6))
                    .tolist(), "b": [0.1] * 6},
                   {"w": np.random.default_rng(2).normal(size=(6, 2))
                    .tolist(), "b": [0.2, -0.1]}]}},
}
TOL = {"mg_se": (1e-4, 1e-6), "mg_procedural": (1e-4, 1e-6)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(name):
    return jparse_cov(COVS[name]), parse_cov(COVS[name], "cpu")


def _points(seed, n=64):
    return (np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3))
            .astype(np.float32))


@pytest.mark.parametrize("name", sorted(COVS))
def test_parsed_equals_converted(name):
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
def test_cov_and_fields_match_jax(name):
    jc, tc = _pair(name)
    rtol, atol = TOL.get(name, (RTOL, ATOL))
    a, b = _points(3), _points(4)
    for x, y in ((a, b), (a, a)):
        want = np.asarray(jax.vmap(jc.cov)(jnp.asarray(x), jnp.asarray(y)))
        got = tc.cov(_t(x), _t(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    for fn in ("variance", "amplitude", "compute_beckmann_roughness"):
        want = np.asarray(jax.vmap(getattr(jc, fn))(jnp.asarray(a)))
        got = getattr(tc, fn)(_t(a)).numpy()
        np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(COVS))
def test_spectral_draw_at_a_point_matches_jax(name):
    """sample_basis at spectral_loc (the draw warped by the field or the
    local matrix at the point) and without it (the base's draw)."""
    jc, tc = _pair(name)
    from tungsten_tpu.ops import weight_space as jws
    keys = np.random.default_rng(5).integers(0, 2 ** 32, 6,
                                             dtype=np.uint64).astype(
                                                 np.uint32)
    locs = _points(6, 6)
    n = 24
    rtol, atol = TOL.get(name, (RTOL, ATOL))
    for loc in (None, locs):
        jb = jax.vmap(lambda k, p: jws.sample_basis(
            jc, n, k, None if loc is None else p))(jnp.asarray(keys),
                                                   jnp.asarray(locs))
        tb = tws.sample_basis(tc, n, _t(keys.astype(np.int64)),
                              None if loc is None else _t(locs))
        np.testing.assert_allclose(tb.freqs.numpy(), np.asarray(jb.freqs),
                                   rtol=rtol, atol=atol)
        if loc is not None and name.startswith("mg"):
            # V diag(evals^-1/2) s: the eigenvectors' signs are free (each
            # eigh picks its own), the norm (freqs) is not
            continue
        np.testing.assert_allclose(tb.dirs.numpy(), np.asarray(jb.dirs),
                                   rtol=rtol, atol=1e-5)


def test_grid_variance_from_npz_matches_inline(tmp_path):
    """The `nonstationary` type reads its grid from a .npz as from the
    scene file, and as the JAX package reads it."""
    np.savez(tmp_path / "var.npz", data=_GRID.astype(np.float32),
             bounds_min=np.full(3, -1.0), bounds_max=np.full(3, 1.0))
    doc = dict(COVS["grid_inline"], grid=str(tmp_path / "var.npz"))
    tc = parse_cov(doc, "cpu")
    jc = jparse_cov(doc)
    inline = parse_cov(COVS["grid_inline"], "cpu")
    p = _t(_points(7))
    np.testing.assert_array_equal(tc.var_field(p).numpy(),
                                  inline.var_field(p).numpy())
    np.testing.assert_allclose(
        tc.var_field(p).numpy(),
        np.asarray(jc.var_field(jnp.asarray(p.numpy()))), rtol=RTOL,
        atol=ATOL)


def test_vdb_grid_is_refused_as_in_jax():
    doc = dict(COVS["grid_inline"], grid="x.vdb")
    with pytest.raises(ValueError, match="vdb"):
        jparse_cov(doc)
    with pytest.raises(ValueError, match="vdb"):
        parse_cov(doc, "cpu")


@pytest.mark.parametrize("base", ["periodic", "thin_plate", "dot_product"])
def test_procedural_over_a_kernel_without_kernel_scale_is_refused(base):
    """JAX's ProceduralNonstationaryCov.create reads base.kernel_scale,
    which these kernels lack: it raises, and the port refuses by name."""
    doc = {"type": "proc_nonstationary", "cov": {"type": base}}
    with pytest.raises(AttributeError, match="kernel_scale"):
        jparse_cov(doc)
    with pytest.raises(NotImplementedError, match="kernel_scale"):
        parse_cov(doc, "cpu")
