"""The one-launch weight-space search (kernels/ws_trace.py: K5's
`fixed_march_batch`, K4's `sphere_trace_batch`) on the CPU: the basis
synthesis the kernels do per ray, their plain twins against the JAX
package's batch functions (Pallas in interpret mode), and the value and
normal the medium takes from the search against the JAX evaluators.
Inputs are made with numpy from a seed; n = 64 and n = 100 (not a
multiple of the 32 lanes of a warp).

Tolerances (measured on this CPU in brackets):
- `synth_hoisted_ref`, the kernels' per-ray uint32 synthesis written in
  numpy, against `_hoisted_params(sample_realization(...))`: the stream
  keys, hash words and uniforms and the phase offsets bit for bit (the same
  integer and float32 operations) [equal]; a, slope and amp within rtol
  1e-5, atol 1e-6 (numpy's and PyTorch's log1p, cos and sin may differ by
  an ulp) [max |diff| 5.7e-6 on |a| up to ~38, 3.8e-6 on slopes up to ~31,
  6.0e-8 on amp].
- The batch functions' CPU path against `fixed_march_batch` /
  `sphere_trace_batch` of tungsten_tpu/ops/ws_trace_pallas.py on the JAX
  realizations of the same words: hit masks and K5's sign0 equal, t within
  2e-3, the bounds of tests/test_weight_space.py [equal; t within 1.6e-7
  (K5) and 0 (K4)].
  The port synthesises its own realization, so its phases differ from
  JAX's by the ulps above.
- The medium's value and normal at ro + t rd (`media._crossing_ws`)
  against JAX's `evaluate` / `evaluate_gradient` at the same point: both
  within rtol 1e-5, atol 1e-5 (sums of n terms whose phases carry the
  synthesis ulps) [value 2.4e-7, normal 4.2e-6 on magnitudes up to ~2.4].
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.ops import weight_space as jws
from tungsten_tpu.ops import ws_trace_pallas as jwst
from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
from tungsten_tpu_torch import convert
from tungsten_tpu_torch.kernels import ws_trace as twst
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import weight_space as tws
from tungsten_tpu_torch.utils import rng as trng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
SEED = 42  # the scene's seed
RTOL, ATOL = 1e-5, 1e-6
NS = (64, 100)

_P2, _P3, _P4, _P5 = (np.uint32(c) for c in (2246822519, 3266489917,
                                              668265263, 374761393))
_F = np.float32
_TWO_PI = _F(2.0 * np.pi)


@functools.lru_cache(maxsize=None)
def _scenes(n, step_size=0.02):
    """(JAX scene, the port's scene converted from it) of config 4a with n
    basis functions."""
    with open(SCENE) as f:
        doc = json.load(f)
    doc["media"][0]["basis_functions"] = n
    doc["media"][0]["step_size"] = step_size
    jscene, _ = jscene_from_dict(doc)
    return jscene, convert.scene_from_numpy(convert.flatten(jscene),
                                            device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, R=128):
    """Words, rays inside config 4a's cube (half of them inside the GPIS
    sphere of radius 0.45 around (0, 0.9, 0)), the march interval, jitter
    and absorb flags."""
    r = np.random.default_rng(seed)
    pss = r.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(np.uint32)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    rad = np.where(np.arange(R) % 2 == 0, r.uniform(0.0, 0.35, R),
                   r.uniform(0.55, 0.7, R))
    ro = (np.array([0.0, 0.9, 0.0]) + u * rad[:, None]).astype(np.float32)
    rd = r.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.zeros(R, np.float32)
    far = r.uniform(0.3, 1.5, R).astype(np.float32)
    uj = r.uniform(size=R).astype(np.float32)
    absorb = np.arange(R) % 3 == 0
    return pss, ro, rd, near, far, uj, absorb


def _xxhash32_2(x, y):
    """xxhash32 of the uint32 words (x, y), as csrc/ws_trace.cu hashes
    (products and sums wrap modulo 2^32)."""
    with np.errstate(over="ignore"):
        h = y + _P5 + x * _P3
        h = ((h << np.uint32(17)) | (h >> np.uint32(15))) * _P4
        h = (h ^ (h >> np.uint32(15))) * _P2
        h = (h ^ (h >> np.uint32(13))) * _P3
        return h ^ (h >> np.uint32(16))


def _uniform(key, ctr):
    return (_xxhash32_2(key, ctr) >> np.uint32(8)).astype(_F) \
        * _F(1.0 / (1 << 24))


def _box_muller(key, c):
    """(radius, angle, u1, u2) of the Box-Muller pair normal2(key, c)."""
    c2 = np.uint32(2) * c
    u1, u2 = _uniform(key, c2), _uniform(key, c2 + np.uint32(1))
    return np.sqrt(_F(-2.0) * np.log1p(-u1)), _TWO_PI * u2, u1, u2


def synth_hoisted_ref(key, key2, ro, rd, params, n):
    """One ray's basis as csrc/ws_trace.cu synthesises it, in numpy uint32
    and float32: key, key2 uint32; ro, rd [3] float32; params the kernels'
    [14] constants (the squared exponential's draw).  Returns dict(a, slope, amp [n], uniforms [n, 7] (the
    variates behind omega's two pairs, the offset and the weight's pair),
    offset [n])."""
    l, sa, scale, sqrt2n = params[0], params[1:4], params[4], params[5]
    i = np.arange(n, dtype=np.uint32)
    r0, a0, u0, u1 = _box_muller(key, np.uint32(3) * i)
    r1, a1, u2, u3 = _box_muller(key, np.uint32(3) * i + np.uint32(1))
    g = np.stack([r0 * np.cos(a0), r0 * np.sin(a0), r1 * np.cos(a1)], -1)
    omega = g / l * sa
    freq = np.sqrt(np.maximum(omega[:, 0] * omega[:, 0]
                              + omega[:, 1] * omega[:, 1]
                              + omega[:, 2] * omega[:, 2], _F(1e-20)))
    dirs = omega / freq[:, None]
    u_off = _uniform(key, np.uint32(1_000_000) + i)
    offset = u_off * _TWO_PI
    rw, aw, u5, u6 = _box_muller(key2, np.uint32(2_000_000) + i // 2)
    w = np.where(i % 2 == 1, rw * np.sin(aw), rw * np.cos(aw))

    def proj(v):
        return dirs[:, 0] * v[0] + dirs[:, 1] * v[1] + dirs[:, 2] * v[2]

    return {"a": freq * proj(ro) + offset, "slope": freq * proj(rd),
            "amp": w * sqrt2n, "offset": offset, "scale": scale,
            "uniforms": np.stack([u0, u1, u2, u3, u_off, u5, u6], -1)}


@pytest.mark.parametrize("n", NS)
def test_synth_hoisted_ref_matches_sample_realization(n):
    _, tscene = _scenes(n)
    med = tscene.media[0]
    pss, ro, rd, *_ = _case(1, R=32)
    key = tmd._ws_key(med, _t(pss.astype(np.int64)))
    keys = twst.pack_keys(key).numpy().view(np.uint32)
    np.testing.assert_array_equal(keys[:, 0], key.numpy().astype(np.uint32))
    np.testing.assert_array_equal(keys[:, 1], (key.numpy() + 0x9E3779B9)
                                  .astype(np.uint32))
    params = twst.search_params(med.gp, n, "cpu").numpy()
    assert params.dtype == np.float32 and params.shape == (14,)
    real = tws.realization_from_key(med.gp.cov, n, key)
    h = twst._hoisted_params(real, med.gp, _t(ro), _t(rd))
    ctr = torch.arange(n, dtype=torch.int64)
    for r in range(len(pss)):
        want_u = torch.stack(
            [trng.uniform(key[r], 6 * ctr), trng.uniform(key[r], 6 * ctr + 1),
             trng.uniform(key[r], 6 * ctr + 2),
             trng.uniform(key[r], 6 * ctr + 3),
             trng.uniform(key[r], 1_000_000 + ctr),
             trng.uniform(keys[r, 1].item(), 4_000_000 + 2 * (ctr // 2)),
             trng.uniform(keys[r, 1].item(), 4_000_001 + 2 * (ctr // 2))],
            -1)
        got = synth_hoisted_ref(keys[r, 0], keys[r, 1], ro[r], rd[r], params,
                                n)
        np.testing.assert_array_equal(got["uniforms"], want_u.numpy())
        np.testing.assert_array_equal(got["offset"], real.basis.offsets[r])
        assert got["scale"] == h.scale.item()
        for name in ("a", "slope", "amp"):
            assert got[name].dtype == np.float32
            np.testing.assert_allclose(got[name], getattr(h, name)[r],
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def _jax_real(jgp, pss, n):
    return jax.jit(jax.vmap(lambda p: jws.sample_realization(
        jgp.cov, n, p, SEED, False)))(jnp.asarray(pss))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kernel", ["march", "trace"])
def test_batch_cpu_path_matches_jax_interpret(kernel, n):
    jscene, tscene = _scenes(n)
    jgp, med = jscene.media[0].gp, tscene.media[0]
    pss, ro, rd, near, far, uj, absorb = _case(2)
    R = len(ro)
    jreal = _jax_real(jgp, pss, n)
    key = tmd._ws_key(med, _t(pss.astype(np.int64)))
    before = (twst.MARCH_LAUNCHES, twst.TRACE_LAUNCHES)
    if kernel == "march":
        step = np.full(R, 0.02, np.float32)
        want = jwst.fixed_march_batch(jreal, jgp, ro, rd, near, far, step, uj,
                                      absorb, max_steps=2048, interpret=True)
        got = twst.fixed_march_batch(med.gp, n, key, *(_t(x) for x in (
            ro, rd, near, far, step, uj, absorb)), max_steps=2048)
        np.testing.assert_array_equal(got["sign0"].numpy(),
                                      np.asarray(want["sign0"]))
        jhit, jt = want["hit"], want["t"]
    else:
        jhit, jt = jwst.sphere_trace_batch(jreal, jgp, ro, rd, near, far,
                                           interpret=True)
        got = twst.sphere_trace_batch(med.gp, n, key, _t(ro), _t(rd),
                                      _t(near), _t(far))
    assert (twst.MARCH_LAUNCHES, twst.TRACE_LAUNCHES) == before
    assert 10 < np.asarray(jhit).sum() < R - 10
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(jhit))
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(jt), rtol=0,
                               atol=2e-3)
    assert (got["steps"] > 0).all()


@pytest.mark.parametrize("step_size", [0.02, 0.0])
def test_medium_value_and_normal_match_jax_evaluate(step_size):
    n = NS[1]
    jscene, tscene = _scenes(n, step_size)
    jgp, med = jscene.media[0].gp, tscene.media[0]
    pss, ro, rd, near, far, uj, _ = _case(3)
    R = len(ro)
    first = np.arange(R) % 4 < 2
    active = np.arange(R) % 9 != 0
    state = dataclasses.replace(tmd.MediumState.make(R, "cpu"),
                                first_scatter=_t(first))
    hit, t, grad, val, gp_id = tmd._crossing_ws(
        med, tscene.scene_seed, _t(ro), _t(rd), _t(near), _t(far), state,
        _t(pss.astype(np.int64)), _t(uj), _t(active))
    assert 10 < int(hit.sum()) < R - 10 and not hit[~_t(active)].any()
    assert (gp_id == 0).all()
    ip = ro + t.numpy()[:, None] * rd

    @jax.jit
    @jax.vmap
    def jeval(rr, p):
        v, _ = jws.evaluate(rr, jgp, p)
        return v, jws.evaluate_gradient(rr, jgp, p)

    jv, jg = jeval(_jax_real(jgp, pss, n), jnp.asarray(ip))
    np.testing.assert_allclose(val.numpy()[active], np.asarray(jv)[active],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy()[active], np.asarray(jg)[active],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["fixed_march_batch", "sphere_trace_batch"])
def test_cpu_tensors_take_the_twin_and_other_devices_raise(kernel):
    n = NS[0]
    _, tscene = _scenes(n)
    med = tscene.media[0]
    pss, ro, rd, near, far, uj, absorb = _case(4, R=16)
    key = tmd._ws_key(med, _t(pss.astype(np.int64)))
    args = [_t(x) for x in (ro, rd, near, far)]
    if kernel == "fixed_march_batch":
        args += [torch.full((16,), 0.02), _t(uj), _t(absorb), 64]
    fn, twin = getattr(twst, kernel), getattr(twst, kernel + "_ref")
    got, want = fn(med.gp, n, key, *args), twin(med.gp, n, key, *args)
    assert got.keys() == want.keys() == {"hit", "t", "sign0", "steps",
                                         "val", "grad"}
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(med.gp, n, key.to("meta"), *meta)
