"""The port's means, SDFs, fields, mesh readers and mesh SDF bake
(ops/means.py, ops/sdf.py, ops/fields.py, io/meshio.py, ops/mesh_sdf.py)
against the JAX package on the CPU.  Inputs are made with numpy from a
seed.

Tolerances:
- means and fields: rtol 1e-5, atol 1e-6; the means' gradients (reverse
  mode in both): rtol 1e-4, atol 1e-5; the additional mean's ids equal.
- the mesh readers: byte-equal files and equal arrays.
- the mesh SDF bake at 12^3 of a 5-ring sphere: within 1e-5 (float32
  sums over the triangles in other orders); the `mesh` mean within 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.io import meshio as jmeshio
from tungsten_tpu.ops import fields as jfields
from tungsten_tpu.ops import means as jmeans
from tungsten_tpu.ops import mesh_sdf as jmesh_sdf
from tungsten_tpu.ops import sdf as jsdf
from tungsten_tpu.scene.parse import parse_mean as jparse_mean
from tungsten_tpu_torch import convert
from tungsten_tpu_torch.io import meshio as tmeshio
from tungsten_tpu_torch.ops import fields as tfields
from tungsten_tpu_torch.ops import means as tmeans
from tungsten_tpu_torch.ops import mesh_sdf as tmesh_sdf
from tungsten_tpu_torch.ops import sdf as tsdf
from tungsten_tpu_torch.scene.parse import parse_mean

RTOL, ATOL = 1e-5, 1e-6

MEANS = {
    "linear": {"type": "linear", "reference_point": [0.1, 0.2, -0.3],
               "direction": [1.0, 2.0, 0.5], "scale": 1.5, "min": -0.4},
    "knob": {"type": "procedural", "func": "knob",
             "transform": {"position": [0.1, -0.1, 0.2], "scale": 0.9},
             "offset": 0.05, "scale": 1.2},
    "knob_inner": {"type": "procedural", "func": "knob_inner"},
    "knob_outer": {"type": "procedural", "func": "knob_outer"},
    "two_spheres": {"type": "procedural", "function": "two_spheres",
                    "min": -0.5},
    "plane": {"type": "procedural", "func": "plane"},
    "grid": {"type": "grid", "grid": {
        "data": np.random.default_rng(0).normal(size=(4, 5, 3)).tolist(),
        "bounds_min": [-1.0, -1.0, -1.0], "bounds_max": [1.0, 1.5, 1.0]},
             "offset": 0.1, "scale": 0.5},
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(seed, n=200):
    return (np.random.default_rng(seed).uniform(-1.3, 1.3, (n, 3))
            .astype(np.float32))


@pytest.mark.parametrize("name", sorted(MEANS))
def test_mean_and_grad_match_jax(name):
    jm = jparse_mean(MEANS[name])
    tm = parse_mean(MEANS[name], "cpu")
    p = _points(1)
    np.testing.assert_allclose(tm.mean(_t(p)).numpy(),
                               np.asarray(jm.mean(jnp.asarray(p))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.grad(_t(p)).numpy(),
                               np.asarray(jm.grad(jnp.asarray(p))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tm.lipschitz()), float(jm.lipschitz()))


def test_neural_mean_matches_jax():
    r = np.random.default_rng(2)
    w = [(r.normal(size=(3, 8)).astype(np.float32),
          r.normal(size=8).astype(np.float32)),
         (r.normal(size=(8, 1)).astype(np.float32) * 0.3,
          r.normal(size=1).astype(np.float32))]
    jm = jmeans.NeuralMean.create(w, offset=0.2, scale=0.7)
    tm = convert.gp_from_numpy(convert.flatten(jm), device="cpu")
    p = _points(3)
    np.testing.assert_allclose(tm.mean(_t(p)).numpy(),
                               np.asarray(jm.mean(jnp.asarray(p))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.grad(_t(p)).numpy(),
                               np.asarray(jm.grad(jnp.asarray(p))),
                               rtol=1e-4, atol=1e-5)


def test_additional_mean_min_and_ids():
    """The CSG union's min of two means, the supplying id and its
    gradient."""
    ja, jb = jparse_mean(MEANS["knob"]), jparse_mean(MEANS["linear"])
    ta, tb = parse_mean(MEANS["knob"], "cpu"), parse_mean(MEANS["linear"],
                                                          "cpu")
    p = _points(4)
    jm, jid = jmeans.mean_and_id(ja, jb, jnp.asarray(p))
    tm, tid = tmeans.mean_and_id(ta, tb, _t(p))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert 0 < int(tid.sum()) < len(p)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=ATOL)
    jg = jmeans.mean_grad_by_id(ja, jb, jnp.asarray(p), jid)
    tg = tmeans.mean_grad_by_id(ta, tb, _t(p), tid)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("fn", sorted(tsdf.FUNCTIONS))
def test_sdf_matches_jax(fn):
    p = _points(5)
    np.testing.assert_allclose(tsdf.FUNCTIONS[fn](_t(p)).numpy(),
                               np.asarray(jsdf.FUNCTIONS[fn](jnp.asarray(p))),
                               rtol=RTOL, atol=ATOL)


FIELDS = {
    "constant": (3.5, False),
    "constant_rgb": ([0.2, 0.5, 0.9], True),
    "bottom_top": ({"type": "noise", "noise": "bottom_top", "min": 0.5,
                    "max": 4.0, "start": -1.0, "end": 1.0}, False),
    "bottom_top_left_right": ({"type": "noise",
                               "noise": "bottom_top_left_right"}, False),
    "sandstone": ({"type": "noise", "noise": "sandstone", "min": 0.2,
                   "max": 0.9}, False),
    "rust": ({"type": "noise", "noise": "rust", "min": 0.1, "max": 2.0},
             False),
    "rust_rgb": ({"type": "noise", "noise": "rust"}, True),
    "sdf": ({"type": "sdf", "func": "two_spheres", "offset": 0.3,
             "scale": 2.0}, False),
}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_field_matches_jax(name):
    doc, is_vector = FIELDS[name]
    jf = jfields.parse_field(doc, is_vector=is_vector)
    tf = tfields.parse_field(doc, "cpu", is_vector=is_vector)
    p = _points(6) * 3.0
    want = np.asarray(jf(jnp.asarray(p)))
    got = tf(_t(p)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tf.max_val() == jf.max_val()


@pytest.mark.parametrize("vector", [False, True])
def test_regular_grid_field_matches_jax(vector):
    r = np.random.default_rng(7)
    data = r.uniform(0.5, 2.0, (5, 4, 6) + ((3,) if vector else ()))
    jf = jfields.Field.regular_grid(data, (-1, -1, -1), (1, 2, 1),
                                    is_vector=vector)
    tf = convert.gp_from_numpy(convert.flatten(jf), device="cpu")
    p = _points(8) * 1.2
    np.testing.assert_allclose(tf(_t(p)).numpy(),
                               np.asarray(jf(jnp.asarray(p))), rtol=RTOL,
                               atol=ATOL)
    assert tf.max_val() == jf.max_val()


def test_mesh_readers_byte_equal(tmp_path):
    """make_sphere + save_wo3 write the same bytes in both packages, and
    the port reads back JAX's file (and an OBJ) as JAX does."""
    jm, tm = jmeshio.make_sphere(0.7, 6), tmeshio.make_sphere(0.7, 6)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k])
    a, b = tmp_path / "j.wo3", tmp_path / "t.wo3"
    jmeshio.save_wo3(str(a), jm["pos"], jm["tris"], normal=jm["normal"])
    tmeshio.save_wo3(str(b), tm["pos"], tm["tris"], normal=tm["normal"])
    assert a.read_bytes() == b.read_bytes()
    got, want = tmeshio.load_mesh(str(a)), jmeshio.load_mesh(str(a))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 2 3\nf 1 3 4 2\n")
    got, want = tmeshio.load_mesh(str(obj)), jmeshio.load_mesh(str(obj))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_mesh_sdf_bake_matches_jax():
    m = jmeshio.make_sphere(0.6, 5)
    jg, jlo, jhi = jmesh_sdf.bake_mesh_sdf(m["pos"], m["tris"], res=12)
    tg, tlo, thi = tmesh_sdf.bake_mesh_sdf(m["pos"], m["tris"], res=12)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5)
    assert (tg < 0).any() and (tg > 0).any()


def test_mesh_mean_parses_as_jax(tmp_path):
    """The `mesh` mean type: the mesh baked at load into a TabulatedMean
    equal to JAX's (within the bake's tolerance)."""
    m = jmeshio.make_sphere(0.6, 5)
    jmeshio.save_wo3(str(tmp_path / "s.wo3"), m["pos"], m["tris"])
    doc = {"type": "mesh", "file": "s.wo3", "grid_res": 10,
           "transform": {"position": [0.0, 0.2, 0.0]}, "offset": 0.01}
    jm = jparse_mean(doc, base_dir=str(tmp_path))
    tm = parse_mean(doc, "cpu", base_dir=str(tmp_path))
    p = _points(9) * 0.6
    np.testing.assert_allclose(tm.mean(_t(p)).numpy(),
                               np.asarray(jm.mean(jnp.asarray(p))), rtol=0,
                               atol=2e-5)
