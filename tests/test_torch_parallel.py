"""The port's row sharding over torch.distributed (parallel/mesh.py,
parallel/launch.py, entry.train_step_sharded, entry.dryrun_multichip)
against its own single-process render and step and against the JAX
package's shard_map versions on its 8-device CPU mesh.

Each sharded run is one `launch.spawn` of gloo ranks on the CPU (one
thread each), whose job lives in the port (parallel/jobs.py), so that no
rank imports JAX or this file.  Config 1 at 8 columns x 16 rows, 1 spp,
depth 2: 16 rows over 2 ranks (8 each) and over 3 (6, 6 and 4: the last
shard is padded for the gather, then cut).

Tolerances:
- The gathered film: the same on every rank, and bit for bit the
  single-process render.render (a pixel's value depends on its own words
  only).
- The sharded step: loss, new parameters and gradient within 1e-6
  relative of entry.train_step (the loss parts and gradients of the row
  shards are summed in another order), and bit for bit the same over two
  runs.
- The JAX side is `__graft_entry__.dryrun_multichip`'s step_shard form
  (summed L2, psum over the mesh) at the same size on the 8-device mesh,
  2 rows a device, with each shard's image as an output (the rows'
  `trace` that the JAX package's shard_render_pass runs), compiled once
  at XLA's backend optimization level 0.  The gathered film against that
  image: every pixel within 1e-3 * (1 + |ref|) (the port and JAX round
  the march's arithmetic differently; an ulp may flip a crossing, which
  this scene at this size does not show).  The sharded step's loss and
  step, times the 3 * H * W values its mean averages, within 1e-2
  relative of step_shard's: tests/test_torch_grad.py's train_step
  tolerance.
- dryrun_multichip(2) (16x16, as the JAX one) runs: finite loss, nonzero
  steps in sigma and l, the same on both ranks.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tungsten_tpu.models.camera import Camera as JCamera
from tungsten_tpu.models.integrator import trace as jtrace
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import entry
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.parallel import jobs, launch, mesh
from tungsten_tpu_torch.scene.parse import DEFAULT_SEED, load_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
RES = (8, 16)  # W, H
SEEDS = (DEFAULT_SEED, 1234, 99)  # rank r loads the scene with SEEDS[r]
OPT = {"xla_backend_optimization_level": 0}


def _jscene(res):
    jscene, _ = jload_scene(SCENE, seed=SEEDS[0])
    return dataclasses.replace(
        jscene, max_bounces=2,
        camera=JCamera.create(transform=np.asarray(jscene.camera.transform),
                              fov_deg=35.0, res=res),
        media=tuple(dataclasses.replace(m, march_block=1)
                    for m in jscene.media))


@pytest.fixture(scope="module")
def sharded():
    """{world: [each rank's jobs.sharded_checks]} for 2 and 3 ranks (two
    steps with 2 ranks, one with 3), and the single-process render and
    step on the same inputs."""
    runs = {world: launch.spawn(jobs.sharded_checks, world, SCENE, RES, 1,
                                "cpu", SEEDS[:world], 2 if world == 2 else 1,
                                threads=1)
            for world in (2, 3)}
    scene, _ = load_scene(SCENE, seed=SEEDS[0], res_override=RES,
                          device="cpu")
    film = trender.render(scene, 1, device="cpu").numpy()
    step = jobs.single_step(SCENE, RES, 1, "cpu")
    return runs, film, step


@pytest.mark.parametrize("H,world", [(16, 1), (16, 2), (16, 3), (1080, 2),
                                     (5, 8), (2, 3)])
def test_row_shards_cover_the_frame_in_order(H, world):
    shards = mesh.row_shards(H, world)
    assert len(shards) == world
    assert shards[0][0] == 0 and shards[-1][1] == H
    per = -(-H // world)
    for (a0, a1), (b0, b1) in zip(shards, shards[1:]):
        assert a1 == b0
    assert all(0 <= r1 - r0 <= per for r0, r1 in shards)


def test_outside_a_group_the_mesh_is_one_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_distributed("cpu") == (0, 1)
    assert mesh.rank_world() == (0, 1)
    scene, _ = load_scene(SCENE, res_override=(2, 2), device="cpu")
    assert mesh.broadcast_scene(scene) is scene
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t and torch.equal(t, torch.ones(3))
    assert mesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.rank_device("cuda") == torch.device("cuda", 1)
    assert mesh.rank_device("cuda:0") == torch.device("cuda", 0)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.rank_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2, device="cuda")


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_render_is_the_single_process_render(sharded, world):
    runs, film, _ = sharded
    assert [r["render"]["rows"] for r in runs[world]] == mesh.row_shards(
        RES[1], world)
    for r in runs[world]:
        assert r["render"]["film"].shape == (RES[1], RES[0], 3)
        np.testing.assert_array_equal(r["render"]["film"], film)
    assert film.mean() > 0.01


@pytest.mark.parametrize("world", [2, 3])
def test_broadcast_scene_takes_rank_0s(sharded, world):
    runs, _, _ = sharded
    ranks = runs[world]
    assert [r["render"]["loaded_seed"] for r in ranks] == list(
        SEEDS[:world])
    assert all(r["render"]["scene_seed"] == SEEDS[0] for r in ranks)
    assert len({r["render"]["digest"] for r in ranks}) == 1
    # rank 1 entered with another max_bounces: every rank refuses
    assert all("max_bounces" in (r["refused"] or "") for r in ranks)


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_import_neither_jax_nor_the_jax_package(sharded, world):
    runs, _, _ = sharded
    assert not any(r["jax"] for r in runs[world])


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_step_equals_train_step(sharded, world):
    runs, _, step = sharded
    loss, sigma, l, gs, gl = step
    assert np.isfinite(step).all() and gs != 0.0 and gl != 0.0
    for r in runs[world]:
        for got in r["steps"]["steps"]:
            np.testing.assert_allclose(got, step, rtol=1e-6)
        # every rank took the same step, and two runs the same, bit for bit
        assert r["steps"]["steps"] == runs[world][0]["steps"]["steps"]
        assert len(set(r["steps"]["steps"])) == 1
    assert len(runs[2][0]["steps"]["steps"]) == 2


@pytest.fixture(scope="module")
def jax_step():
    """__graft_entry__.dryrun_multichip's step_shard form at RES, 1 spp,
    on the 8-device mesh (2 rows a device), compiled once at XLA's backend
    optimization level 0, with each shard's image as an output beside
    the step: (sigma1 - sigma0, l1 - l0, summed loss, image [H, W, 3])."""
    from jax.experimental.shard_map import shard_map
    W, H = RES
    scene = _jscene(RES)
    cov = scene.media[0].gp.cov

    def rows_image(sigma, l, rows_shard):
        cov2 = dataclasses.replace(cov, sigma=sigma, l=l)
        gp2 = dataclasses.replace(scene.media[0].gp, cov=cov2)
        med2 = dataclasses.replace(scene.media[0], gp=gp2)
        scene2 = dataclasses.replace(scene, media=(med2,) + scene.media[1:])
        px, py = jnp.meshgrid(jnp.arange(W, dtype=jnp.int32), rows_shard)
        return jtrace(scene2, px.reshape(-1), py.reshape(-1),
                      jnp.int32(0)).reshape(rows_shard.shape[0], W, 3)

    def loss_rows(sigma, l, rows_shard, target_shard):
        img = rows_image(sigma, l, rows_shard)
        return jnp.sum((img - target_shard) ** 2), img

    def step_shard(sigma, l, rows_shard, target_shard):
        (loss, img), grads = jax.value_and_grad(
            loss_rows, argnums=(0, 1), has_aux=True)(
            sigma, l, rows_shard, target_shard)
        loss = jax.lax.psum(loss, "rays")
        gs = jax.lax.psum(grads[0], "rays")
        gl = jax.lax.psum(grads[1], "rays")
        return sigma - 1e-3 * gs, l - 1e-3 * gl, loss, img

    sharded = shard_map(step_shard, mesh=Mesh(jax.devices()[:8], ("rays",)),
                        in_specs=(P(), P(), P("rays"), P("rays")),
                        out_specs=(P(), P(), P(), P("rays")),
                        check_rep=False)
    args = (cov.sigma, cov.l, jnp.arange(H, dtype=jnp.int32),
            jnp.zeros((H, W, 3), jnp.float32))
    sigma1, l1, loss, img = jax.jit(sharded).lower(*args).compile(
        compiler_options=OPT)(*args)
    return (float(sigma1) - float(cov.sigma), float(l1) - float(cov.l),
            float(loss), np.asarray(img))


def test_sharded_render_matches_jax_shard_map_render(sharded, jax_step):
    _, film, _ = sharded
    ref = jax_step[3]
    assert ref.shape == film.shape
    np.testing.assert_allclose(film, ref, rtol=1e-3, atol=1e-3)


def test_sharded_step_matches_jax_step_shard(sharded, jax_step):
    jds, jdl, jloss, _ = jax_step
    n = 3 * RES[0] * RES[1]  # the mean's count: step_shard sums
    for world in (2, 3):
        loss, sigma, l, _, _ = sharded[0][world][0]["steps"]["steps"][0]
        sigma0, l0 = sharded[0][world][0]["steps"]["params"]
        np.testing.assert_allclose(
            [loss * n, (sigma - sigma0) * n, (l - l0) * n],
            [jloss, jds, jdl], rtol=1e-2)


def test_dryrun_multichip_two_ranks():
    loss, ds, dl = entry.dryrun_multichip(2, device="cpu")
    assert np.isfinite([loss, ds, dl]).all() and ds != 0.0 and dl != 0.0
