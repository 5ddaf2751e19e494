"""The port's weight-space (RFF) path against the JAX package on the CPU:
ops/weight_space.py, the K5/K4 twins and their batch glue
(kernels/ws_trace.py), the weight-space medium and a render of BASELINE
config 4a (`scenes/gpis-weight-space.json`).  Inputs are made with numpy
from a seed and handed to both packages.

Tolerances (measured on this CPU in brackets):
- `realization_key`: bit-exact.
- `sample_realization` (dirs, freqs, offsets, weights): rtol 1e-5, atol
  1e-6, for the ulps of log1p/cos/sin in the two libraries [max |diff|
  5.7e-6, on frequencies of up to ~60].
- `evaluate`, `evaluate_gradient`, `lipschitz` on one realization: rtol
  1e-5, atol 1e-6 [values 1.8e-7; gradients 3.9e-6 and Lipschitz bounds
  1.9e-6, both of magnitude ~10-100].
- `march_chunk_ref` / `trace_chunk_ref` against the Pallas kernels in
  interpret mode, three chunks on identical inputs (R = 128, n = 64):
  flag columns equal, float columns within rtol 1e-5, atol 1e-6, the
  Pallas-vs-twin tolerance of tests/test_pallas.py [no flag differs; floats
  within 3.6e-7 (K5) and 0 (K4)].
- The twins' batch glue on a given realization (`march_over` /
  `trace_over`) against the JAX batch functions (interpret mode): hit
  masks equal, t within 2e-3, the bounds of tests/test_weight_space.py
  [masks equal, t within 3.9e-7 and 0].
- Media `sample_distance` / `transmittance` against JAX with its kernels
  in interpret mode: at most 2 rays differ in hit or visibility, t within
  1e-4 and normals within rtol 1e-3, atol 1e-3 where both hit [no ray
  differs; t within 2.7e-7, normals within 4.2e-6].
- A 16x16, 2-spp render of config 4a with 64 basis functions, for
  step_size 0.02 (K5) and 0 (K4): at least 97% of pixels within
  1e-3 (1 + |ref|) and image means within 1% [every pixel, max |diff|
  8.3e-7].
A crossing may flip where |f| at the deciding step is within rounding of
0 (the n-term sums add in another order), hence the mask allowances.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.models.integrator import render_pass as jrender_pass
from tungsten_tpu.ops import weight_space as jws
from tungsten_tpu.ops import ws_trace_pallas as jwst
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.io.image import read_pfm
from tungsten_tpu_torch.kernels import ws_trace as twst
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import weight_space as tws
from tungsten_tpu_torch.scene.parse import load_scene as tload_scene
from tungsten_tpu_torch.scene.parse import scene_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
N_BASIS = 64
RTOL, ATOL = 1e-5, 1e-6


def _doc(step_size=0.02, n=N_BASIS, res=None):
    with open(SCENE) as f:
        doc = json.load(f)
    doc["media"][0]["basis_functions"] = n
    doc["media"][0]["step_size"] = step_size
    if res is not None:
        doc["camera"]["resolution"] = list(res)
    return doc


@functools.lru_cache(maxsize=None)
def _scenes(step_size=0.02, res=None):
    """(JAX scene, the port's scene converted from it)."""
    jscene, _ = jscene_from_dict(_doc(step_size, res=res))
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pss(r, R):
    return r.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(np.uint32)


def _jax_real(gp, pss, n=N_BASIS, seed=42):
    return jax.jit(jax.vmap(lambda p: jws.sample_realization(
        gp.cov, n, p, seed, False)))(jnp.asarray(pss))


def _torch_real(jreal):
    """The port's realization holding JAX's numbers."""
    b = jreal.basis
    return tws.WeightSpaceRealization(
        basis=tws.WeightSpaceBasis(dirs=_t(b.dirs), freqs=_t(b.freqs),
                                   offsets=_t(b.offsets)),
        weights=_t(jreal.weights))


def _rays(r, R):
    """Rays of config 4a's box: origins inside the bounding cube around the
    GPIS sphere (center (0, 0.9, 0), radius 0.45), random directions."""
    center = np.array([0.0, 0.9, 0.0], np.float32)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    rad = np.where(np.arange(R) % 2 == 0, r.uniform(0.0, 0.35, R),
                   r.uniform(0.55, 0.7, R))
    ro = (center + u * rad[:, None]).astype(np.float32)
    rd = r.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("is_global", [False, True])
def test_realization_key_bit_exact(is_global):
    pss = _pss(np.random.default_rng(1), 512)
    want = np.asarray(jax.vmap(lambda p: jws.realization_key(
        p, 0xDEADBEEF, is_global))(jnp.asarray(pss)))
    got = tws.realization_key(_t(pss.astype(np.int64)), 0xDEADBEEF,
                              is_global)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sample_realization_matches_jax():
    jscene, tscene = _scenes()
    pss = _pss(np.random.default_rng(2), 32)
    want = _jax_real(jscene.media[0].gp, pss)
    got = tws.sample_realization(tscene.media[0].gp.cov, N_BASIS,
                                 _t(pss.astype(np.int64)), 42, False)
    for g, w in ((got.basis.dirs, want.basis.dirs),
                 (got.basis.freqs, want.basis.freqs),
                 (got.basis.offsets, want.basis.offsets),
                 (got.weights, want.weights)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_evaluate_gradient_lipschitz_match_jax():
    jscene, tscene = _scenes()
    jgp, tgp = jscene.media[0].gp, tscene.media[0].gp
    r = np.random.default_rng(3)
    R = 48
    jreal = _jax_real(jgp, _pss(r, R))
    treal = _torch_real(jreal)
    p, _ = _rays(r, R)

    @jax.jit
    @jax.vmap
    def jrun(rr, q):
        v, gid = jws.evaluate(rr, jgp, q)
        return (v, gid, jws.evaluate_gradient(rr, jgp, q),
                jws.lipschitz(rr, jgp))

    jv, jid, jg, jl = jrun(jreal, p)
    tv, tid = tws.evaluate(treal, tgp, _t(p))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tws.evaluate_gradient(treal, tgp, _t(p)),
                               np.asarray(jg), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tws.lipschitz(treal, tgp).numpy(),
                               np.asarray(jl), rtol=RTOL, atol=ATOL)


def _chunk_inputs(kernel, R=128):
    """Identical inputs for one kernel, as the batch functions make them:
    config 4a's realizations along random rays, a sixth of the rays done
    and, for the march, a third absorbing."""
    jscene, tscene = _scenes()
    tgp = tscene.media[0].gp
    r = np.random.default_rng(4 if kernel == "march" else 5)
    treal = _torch_real(_jax_real(jscene.media[0].gp, _pss(r, R)))
    ro, rd = _rays(r, R)
    near = torch.zeros(R)
    far = torch.from_numpy(r.uniform(0.3, 1.5, R).astype(np.float32))
    done = torch.from_numpy(np.arange(R) % 6 == 5)
    if kernel == "march":
        step = torch.full((R,), 0.02)
        uj = torch.from_numpy(r.uniform(size=R).astype(np.float32))
        absorb = torch.from_numpy(np.arange(R) % 3 == 0)
        h, aux, state, params = twst.march_inputs(
            treal, tgp, _t(ro), _t(rd), near, far, step, uj, absorb)
        done_col = twst.M_DONE
    else:
        h, aux, state, params = twst.trace_inputs(treal, tgp, _t(ro), _t(rd),
                                                  near, far)
        done_col = twst.C_DONE
    state[:, done_col] = done.to(torch.float32)
    return h, aux, state, params


@pytest.mark.parametrize("kernel", ["march", "trace"])
def test_chunk_twin_matches_pallas_interpret(kernel):
    h, aux, state, params = _chunk_inputs(kernel)
    if kernel == "march":
        twin, pallas = twst.march_chunk_ref, jwst._march_chunk
        flags = (twst.M_DONE, twst.M_CROSS, twst.M_SIGN)
        done_col, hit_col = twst.M_DONE, twst.M_CROSS
    else:
        twin, pallas = twst.trace_chunk_ref, jwst._trace_chunk
        flags = (twst.C_DONE, twst.C_HIT, twst.C_SIGN)
        done_col, hit_col = twst.C_DONE, twst.C_HIT
    jargs = [jnp.asarray(x.numpy()) for x in (h.a, h.slope, h.amp, aux)]
    jparams = jnp.asarray(params.numpy()).reshape(1, 8)
    S = state
    for i in range(3):
        want = np.array(pallas(*jargs, jnp.asarray(S.numpy()), jparams,
                               h.spherical, True))
        got = twin(h.a, h.slope, h.amp, aux, S, params, h.spherical).numpy()
        np.testing.assert_array_equal(got[:, list(flags)],
                                      want[:, list(flags)])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        S = torch.from_numpy(want)
        if i == 0:  # a chunk leaves some rays running and finishes others
            assert 0 < (S[:, done_col] > 0.5).sum() < len(S)
    assert (S[:, hit_col] > 0.5).sum() > len(S) // 10


def _batch_inputs(R=128):
    jscene, tscene = _scenes()
    r = np.random.default_rng(6)
    pss = _pss(r, R)
    jreal = _jax_real(jscene.media[0].gp, pss)
    ro, rd = _rays(r, R)
    near = np.zeros(R, np.float32)
    far = r.uniform(0.3, 1.5, R).astype(np.float32)
    return jscene.media[0].gp, tscene.media[0].gp, jreal, ro, rd, near, far, r


def test_fixed_march_batch_matches_jax():
    jgp, tgp, jreal, ro, rd, near, far, r = _batch_inputs()
    R = len(ro)
    step = np.full(R, 0.02, np.float32)
    uj = r.uniform(size=R).astype(np.float32)
    absorb = np.arange(R) % 3 == 0
    # JAX masks the inactive rays; the port gathers the active ones, as the
    # medium does
    active = np.arange(R) % 7 != 3
    want = jwst.fixed_march_batch(jreal, jgp, ro, rd, near, far, step, uj,
                                  absorb, active=jnp.asarray(active),
                                  max_steps=2048, interpret=True)
    treal = _torch_real(jax.tree_util.tree_map(lambda x: x[active], jreal))
    got = twst.march_over(treal, tgp, *(_t(x[active]) for x in (
        ro, rd, near, far, step, uj, absorb)), max_steps=2048)
    hit = np.asarray(want["hit"])[active]
    assert 10 < hit.sum() < len(hit) - 10
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"])[active],
                               rtol=0, atol=2e-3)


def test_sphere_trace_batch_matches_jax():
    jgp, tgp, jreal, ro, rd, near, far, _ = _batch_inputs()
    R = len(ro)
    jhit, jt = jwst.sphere_trace_batch(jreal, jgp, ro, rd, near, far,
                                       interpret=True)
    got = twst.trace_over(_torch_real(jreal), tgp, _t(ro), _t(rd), _t(near),
                          _t(far))
    thit, tt = got["hit"], got["t"]
    assert 10 < np.asarray(jhit).sum() < R - 10
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=2e-3)


def _media_case(step_size, R=128):
    jscene, tscene = _scenes(step_size)
    r = np.random.default_rng(7)
    ro, rd = _rays(r, R)
    first = np.arange(R) % 4 < 2
    pss = _pss(r, R)
    uj = r.uniform(size=R).astype(np.float32)
    active = np.arange(R) % 17 != 0
    jstate = dataclasses.replace(jmd.MediumState.make(R),
                                 first_scatter=jnp.asarray(first))
    tstate = dataclasses.replace(tmd.MediumState.make(R, "cpu"),
                                 first_scatter=_t(first))
    return (jscene, tscene, ro, rd, first, pss, uj, active, jstate, tstate)


@pytest.mark.parametrize("step_size", [0.02, 0.0])
def test_media_match_jax(monkeypatch, step_size):
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    (jscene, tscene, ro, rd, first, pss, uj, active, jstate,
     tstate) = _media_case(step_size)
    R = len(ro)
    jmed, tmed = jscene.media[0], tscene.media[0]
    assert tmed.ws_sphere_trace == (step_size == 0.0)
    far = np.full(R, 3.0e38, np.float32)
    seg = np.full(R, 0.8, np.float32)
    jargs = (jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(R))
    targs = (_t(ro), _t(rd), torch.zeros(R))
    jtail = (jstate, jnp.asarray(pss), jnp.asarray(uj), jnp.asarray(active))
    ttail = (tstate, _t(pss.astype(np.int64)), _t(uj), _t(active))

    jres, _ = jax.jit(lambda *a: jmd.sample_distance(jmed, jscene.scene_seed,
                                                     *a))(
        *jargs, jnp.asarray(far), *jtail)
    tres, tstate2 = tmd.sample_distance(tmed, tscene.scene_seed, *targs,
                                        _t(far), *ttail)
    jhit, thit = ~np.asarray(jres["exited"]), ~tres["exited"].numpy()
    assert thit.sum() > R // 4 and (~thit[active]).sum() > R // 10
    assert (jhit != thit).sum() <= 2
    both = jhit & thit
    np.testing.assert_allclose(tres["t"].numpy()[both],
                               np.asarray(jres["t"])[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres["aniso"].numpy()[both],
                               np.asarray(jres["aniso"])[both], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(tres["failed"].numpy()[both],
                                  np.asarray(jres["failed"])[both])
    np.testing.assert_array_equal(tres["gp_id"].numpy()[both],
                                  np.asarray(jres["gp_id"])[both])
    np.testing.assert_array_equal(tstate2.first_scatter.numpy(),
                                  first & ~active)

    jtr = np.asarray(jax.jit(lambda *a: jmd.transmittance(
        jmed, jscene.scene_seed, *a))(*jargs, jnp.asarray(seg), *jtail))
    ttr = tmd.transmittance(tmed, tscene.scene_seed, *targs, _t(seg),
                            *ttail).numpy()
    jvis, tvis = jtr[:, 0] > 0, ttr[:, 0] > 0
    assert 0 < tvis.sum() < R
    assert (jvis != tvis).sum() <= 2
    assert tvis[~active].all()


@pytest.mark.parametrize("step_size", [0.02, 0.0])
def test_load_scene_equals_converted_jax_scene(tmp_path, step_size):
    path = tmp_path / "ws.json"
    path.write_text(json.dumps(_doc(step_size, n=1024)))
    tscene, rdoc = tload_scene(str(path), device="cpu")
    assert rdoc["spp"] == 8
    med = tscene.media[0]
    assert (med.kind, med.basis_functions, med.ws_sphere_trace) == (
        tmd.GPIS_WEIGHT_SPACE, 1024, step_size == 0.0)
    jscene, _ = jscene_from_dict(_doc(step_size, n=1024))
    a = convert.flatten(tscene)
    b = convert.flatten(convert.scene_from_numpy(convert.flatten(jscene),
                                                 device="cpu"))
    assert a.keys() == b.keys()
    for k, va in a.items():
        if isinstance(va, np.ndarray):
            assert va.dtype == b[k].dtype, k
            np.testing.assert_array_equal(va, b[k], err_msg=k)
        else:
            assert va == b[k], k


def test_unsupported_weight_space_gp_raises():
    # a linear mean takes the plain weight-space path now; a dot-product
    # covariance has no amplitude in the JAX package, which then fails
    doc = _doc()
    doc["media"][0]["gaussian_process"]["covariance"] = {
        "type": "dot_product"}
    with pytest.raises(NotImplementedError, match="DotProductCov"):
        scene_from_dict(doc, device="cpu")


@pytest.mark.parametrize("step_size", [0.02, 0.0])
def test_render_16x16_matches_jax(monkeypatch, step_size):
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", "1")
    jscene, tscene = _scenes(step_size, res=(16, 16))
    f = jax.jit(jrender_pass)
    ref = sum(np.asarray(f(jscene, jnp.int32(s))) for s in range(2))
    got = trender.render(tscene, 2, device="cpu").numpy()
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert ok.mean() >= 0.97, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())
    assert ref.mean() > 0.05


def test_cli_renders_weight_space_without_importing_jax(tmp_path):
    out = tmp_path / "ws.png"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['render', {SCENE!r}, '--spp', '1', '--res', '4x4',\n"
        f"            '-o', {str(out)!r}, '--device', 'cpu']\n"
        "runpy.run_module('tungsten_tpu_torch.render', run_name='__main__')\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "assert 'tungsten_tpu' not in sys.modules, 'the port imported the "
        "JAX package'\n"
        "print('no jax')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no jax" in res.stdout
    img = read_pfm(str(tmp_path / "ws.pfm"))
    assert img.shape == (4, 4, 3) and np.isfinite(img).all()
