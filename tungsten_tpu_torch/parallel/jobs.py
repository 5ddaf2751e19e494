"""Rank jobs for parallel/launch.py's spawn: each runs in one rank of a
process group and returns plain Python and numpy values.  They live in the
package so that a spawned rank imports the port alone (`tests/` and
`chip_smoke.py` start them).
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
import time

import torch

from .. import entry, render
from ..kernels import noise3d
from ..scene.parse import load_scene
from . import mesh


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor_digest(scene):
    """sha256 of every tensor of the scene, in field order."""
    h = hashlib.sha256()
    mesh.map_tensors(scene, lambda t: h.update(
        t.detach().cpu().contiguous().numpy().tobytes()))
    return h.hexdigest()


def sharded_render(rank, world, scene_path, res, spp, device, seeds=None):
    """Load the scene (rank r with seeds[r] when given), take rank 0's by
    broadcast_scene, and render spp samples through
    render.render(sharded=True).  Returns the gathered film, the scene's
    seed as loaded and after the broadcast, a digest of its tensors after
    it, this rank's rows, the render's K1 and K2 launches, wall and peak
    device memory, the seconds of one gather of a shard of this size
    (after a barrier, so no rank waits for another's render)."""
    device = torch.device(device)
    kw = {"seed": seeds[rank]} if seeds else {}
    scene, _ = load_scene(scene_path, res_override=res, device=device, **kw)
    out = {"loaded_seed": scene.scene_seed}
    scene = mesh.broadcast_scene(scene)
    H = scene.camera.res_y
    r0, r1 = mesh.row_shards(H, world)[rank]
    out.update(scene_seed=scene.scene_seed, digest=_tensor_digest(scene),
               rows=(r0, r1))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    noise3d.LAUNCHES = noise3d.K2_LAUNCHES = 0
    _sync(device)
    t0 = time.perf_counter()
    film = render.render(scene, spp, sharded=True, device=device)
    _sync(device)
    out.update(wall=time.perf_counter() - t0, k1=noise3d.LAUNCHES,
               k2=noise3d.K2_LAUNCHES, film=film.cpu().numpy(),
               peak=(torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else 0))
    shard = torch.zeros(r1 - r0, scene.camera.res_x, 3, device=device)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    mesh.gather_rows(shard, H)
    _sync(device)
    out.update(gather_s=time.perf_counter() - t0)
    return out


def sharded_steps(rank, world, scene_path, res, spp, device, runs=2):
    """`runs` calls of entry.train_step_sharded on the scene at res, spp
    samples, a zero target, from the same parameters each time.  Returns
    [(loss, new sigma, new l, dsigma, dl)] as floats, and the K1 and K1b
    launches of the runs."""
    device = torch.device(device)
    scene, _ = load_scene(scene_path, res_override=res, device=device)
    scene = mesh.broadcast_scene(scene)
    H, W = scene.camera.res_y, scene.camera.res_x
    target = torch.zeros(H, W, 3, device=device)
    noise3d.LAUNCHES = noise3d.K1B_LAUNCHES = 0
    steps = []
    for _ in range(runs):
        sigma, l, loss, (gs, gl) = entry.train_step_sharded(
            scene, target, torch.arange(spp, device=device))
        steps.append(tuple(float(x) for x in (loss, sigma, l, gs, gl)))
    return {"steps": steps, "k1": noise3d.LAUNCHES,
            "k1b": noise3d.K1B_LAUNCHES,
            "params": tuple(float(x) for x in entry.params(scene))}


def single_step(scene_path, res, spp, device):
    """entry.train_step in this process on the same inputs as
    sharded_steps: (loss, new sigma, new l, dsigma, dl) as floats."""
    device = torch.device(device)
    scene, _ = load_scene(scene_path, res_override=res, device=device)
    H, W = scene.camera.res_y, scene.camera.res_x
    sigma, l, loss, (gs, gl) = entry.train_step(
        scene, torch.zeros(H, W, 3, device=device),
        torch.arange(spp, device=device))
    return tuple(float(x) for x in (loss, sigma, l, gs, gl))


def sharded_checks(rank, world, scene_path, res, spp, device, seeds, runs):
    """sharded_render and sharded_steps in one process per rank, and a
    broadcast_scene that rank 1 enters with another max_bounces, which
    every rank must refuse: {"render": ..., "steps": ..., "refused": the
    ValueError's message or None, "jax": whether the rank imported JAX or
    the JAX package}."""
    out = {"render": sharded_render(rank, world, scene_path, res, spp,
                                    device, seeds),
           "steps": sharded_steps(rank, world, scene_path, res, spp, device,
                                  runs)}
    scene, _ = load_scene(scene_path, res_override=res, device=device)
    if rank == 1:
        scene = dataclasses.replace(scene, max_bounces=scene.max_bounces + 1)
    try:
        mesh.broadcast_scene(scene)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["jax"] = "jax" in sys.modules or "tungsten_tpu" in sys.modules
    return out
