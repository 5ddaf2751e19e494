"""The port's config-1 medium (sample_distance, transmittance) against
tungsten_tpu/models/media.py on 256 rays from inside and outside the GPIS
sphere, half of them starting at a surface and half inside the medium.

JAX runs its default CPU path (the vmapped general evaluator) with
march_block=1, so both march the same steps; the port marches with K1's
twin.  Tolerances: the hit masks agree on all but at most 2 rays (a value
within an ulp of 0 may flip a crossing), t agrees within 1e-4 where both
hit (measured: no mask differs, t within 1.6e-7), and there the sampled
normal agrees within rtol 1e-3, atol 1e-3 and the failed flags exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tungsten_tpu.models import media as jmd
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert
from tungsten_tpu_torch.models import media as tmd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
N = 256


def _setup():
    jscene, _ = jload_scene(SCENE)
    jscene = dataclasses.replace(jscene, media=tuple(
        dataclasses.replace(m, march_block=1) for m in jscene.media))
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    r = np.random.default_rng(3)
    center = np.array([0.0, 0.9, 0.0], np.float32)
    # half the origins inside the sphere (radius 0.45), half outside it
    # but inside the bounding cube
    u = r.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    rad = np.where(np.arange(N) % 2 == 0, r.uniform(0.0, 0.35, N),
                   r.uniform(0.55, 0.7, N))
    ro = (center + u * rad[:, None]).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    first = np.arange(N) % 4 < 2
    pss = r.integers(0, 64, (N, 4)).astype(np.uint32)
    uj = r.uniform(size=N).astype(np.float32)
    active = np.ones(N, bool)
    active[::17] = False
    far = np.full(N, 3.0e38, np.float32)
    return jscene, tscene, ro, rd, first, pss, uj, active, far


def _jax_state(first):
    st = jmd.MediumState.make(N)
    return dataclasses.replace(st, first_scatter=jnp.asarray(first))


def _torch_state(first):
    st = tmd.MediumState.make(N, "cpu")
    return dataclasses.replace(st, first_scatter=torch.from_numpy(first))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_sample_distance_matches_jax():
    jscene, tscene, ro, rd, first, pss, uj, active, far = _setup()
    jmed, tmed = jscene.media[0], tscene.media[0]

    @jax.jit
    def jrun(ro, rd, far, state, pss, uj, active):
        return jmd.sample_distance(jmed, jscene.scene_seed, ro, rd,
                                   jnp.zeros(N), far, state, pss, uj, active)

    jres, _ = jrun(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(far),
                   _jax_state(first), jnp.asarray(pss), jnp.asarray(uj),
                   jnp.asarray(active))
    tres, tstate = tmd.sample_distance(
        tmed, tscene.scene_seed, _t(ro), _t(rd), torch.zeros(N), _t(far),
        _torch_state(first), _t(pss.astype(np.int64)), _t(uj), _t(active))
    jhit = ~np.asarray(jres["exited"])
    thit = ~tres["exited"].numpy()
    assert thit.sum() > N // 4 and (~thit[active]).sum() > N // 10
    assert (jhit != thit).sum() <= 2
    both = jhit & thit
    np.testing.assert_allclose(tres["t"].numpy()[both],
                               np.asarray(jres["t"])[both], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tres["aniso"].numpy()[both],
                               np.asarray(jres["aniso"])[both], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(tres["failed"].numpy()[both],
                                  np.asarray(jres["failed"])[both])
    np.testing.assert_array_equal(tstate.first_scatter.numpy(),
                                  first & ~active)


def test_transmittance_matches_jax():
    jscene, tscene, ro, rd, first, pss, uj, active, far = _setup()
    jmed, tmed = jscene.media[0], tscene.media[0]
    seg = np.full(N, 0.8, np.float32)  # shadow segments of length 0.8

    @jax.jit
    def jrun(ro, rd, far, state, pss, uj, active):
        return jmd.transmittance(jmed, jscene.scene_seed, ro, rd,
                                 jnp.zeros(N), far, state, pss, uj, active)

    jtr = np.asarray(jrun(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seg),
                          _jax_state(first), jnp.asarray(pss),
                          jnp.asarray(uj), jnp.asarray(active)))
    ttr = tmd.transmittance(tmed, tscene.scene_seed, _t(ro), _t(rd),
                            torch.zeros(N), _t(seg), _torch_state(first),
                            _t(pss.astype(np.int64)), _t(uj),
                            _t(active)).numpy()
    assert ttr.shape == (N, 3)
    jvis, tvis = jtr[:, 0] > 0, ttr[:, 0] > 0
    assert 0 < tvis.sum() < N
    assert (jvis != tvis).sum() <= 2
    assert tvis[~active].all()
