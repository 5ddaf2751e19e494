"""Pixel rows sharded over torch.distributed ranks, the film gathered on
every rank (the port's counterpart of tungsten_tpu/parallel/mesh.py, whose
1-axis `rays` mesh becomes the process group's ranks).

Each rank renders a contiguous range of image rows (`row_shards`) through
`integrator.render_pass(scene, s, rows=(r0, r1))`; the scene, a few
kilobytes of parameters, is replicated (`broadcast_scene` makes every rank
hold rank 0's).  `film_allreduce_pass` all-gathers the shards, so every
rank holds the whole frame.  A pixel's value depends on its own words only,
so the gathered frame is the single-process one bit for bit.  The
parameter gradients of a sharded training step are all-reduced (SUM) by
`all_reduce_sum` (`entry.train_step_sharded`).

A process joins its group through torchrun's environment (`MASTER_ADDR`,
`MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`; `init_distributed`) or
through `parallel/launch.py`, which spawns the ranks itself.  The backend
follows the device, `nccl` on the card and `gloo` on the CPU, unless the
caller names one: gloo ranks may also share one card, and gloo then
moves the CUDA tensors of each collective through the host itself.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..models.integrator import render_pass
from ..scene.parse import check_device

# the scene's and each medium's seed: JAX array leaves, Python ints here
SEED_WORDS = ("scene_seed", "global_seed")


def init_distributed(device="cuda", backend=None):
    """Join the process group that torchrun's environment describes;
    returns (rank, world).  One process (WORLD_SIZE unset or 1) joins no
    group.  The backend is `nccl` for a CUDA device and `gloo` for the
    CPU unless `backend` names one."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    if not dist.is_initialized():
        device = check_device(device)
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=world)
    return dist.get_rank(), dist.get_world_size()


def rank_world():
    """(rank, world) of this process: (0, 1) outside a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device="cuda"):
    """This rank's device: `cuda:LOCAL_RANK` for a CUDA device named
    without an index, else `device` itself."""
    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def row_shards(H, world):
    """Each rank's contiguous rows [(r0, r1)] of an H-row frame: ceil(H /
    world) rows each, the last ones shorter (or empty) when world does not
    divide H."""
    per = -(-H // world)
    return [(min(r * per, H), min((r + 1) * per, H)) for r in range(world)]


def _map_leaves(obj, fn, path="scene"):
    """A copy of a tree of frozen dataclasses and tuples with fn(path,
    leaf) in place of every other value (fields in declaration order)."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(getattr(obj, f.name), fn, f"{path}.{f.name}")
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_map_leaves(v, fn, f"{path}.{i}")
                     for i, v in enumerate(obj))
    return fn(path, obj)


def map_tensors(obj, fn):
    """A copy of a tree of frozen dataclasses and tuples with fn(t) in
    place of every tensor t."""
    return _map_leaves(obj, lambda _, v: fn(v) if isinstance(
        v, torch.Tensor) else v)


def broadcast_scene(scene, src=0):
    """The scene with every tensor replaced by rank src's, broadcast in
    the order of the dataclass fields (the multi-host scene broadcast of
    tungsten_tpu/parallel/mesh.py), and rank src's seed words (SEED_WORDS:
    uint32 words here, array leaves there, so broadcast there too).
    Raises ValueError if any other field, or a tensor's shape or dtype,
    differs between ranks.  Outside a process group: the scene itself.  A
    group of one rank runs each collective all the same."""
    if not dist.is_initialized():
        return scene
    meta, seeds = [], {}

    def describe(path, v):
        if isinstance(v, torch.Tensor):
            meta.append((path, ("tensor", tuple(v.shape), str(v.dtype))))
        elif path.rsplit(".", 1)[-1] in SEED_WORDS:
            meta.append((path, "seed word"))
            seeds[path] = v
        else:
            meta.append((path, v))
        return v

    _map_leaves(scene, describe)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (meta, seeds))
    for r, (other, _) in enumerate(every):
        for a, b in zip(other + [("(more fields)", None)],
                        every[src][0] + [("(more fields)", None)]):
            if a != b:
                raise ValueError(f"rank {r}'s scene differs from rank "
                                 f"{src}'s at {a[0]}: the ranks loaded "
                                 "different scenes")
    seeds = every[src][1]

    def bcast(path, v):
        if path in seeds:
            return seeds[path]
        if not isinstance(v, torch.Tensor):
            return v
        t = v.detach().clone().contiguous()
        dist.broadcast(t, src)
        return t

    return _map_leaves(scene, bcast)


def shard_render_pass(scene, spp_idx, qmc=None):
    """This rank's rows of render_pass(scene, spp_idx, qmc=qmc): [r1 - r0,
    W, 3] (summed over the samples of spp_idx, an int or an [S] tensor).
    A shard of more than render.MAX_RAYS pixels renders in render.render's
    bands of MAX_RAYS // W rows from its first row, one sample at a
    time."""
    from .. import render  # render imports this module
    rank, world = rank_world()
    H, W = scene.camera.res_y, scene.camera.res_x
    r0, r1 = row_shards(H, world)[rank]
    dev = scene.lights.device
    if (r1 - r0) * W <= render.MAX_RAYS:
        if r1 == r0:
            return torch.zeros(0, W, 3, dtype=torch.float32, device=dev)
        return render_pass(scene, spp_idx, (r0, r1), qmc)
    shard = torch.zeros(r1 - r0, W, 3, dtype=torch.float32, device=dev)
    rows = max(1, render.MAX_RAYS // W)
    for s in torch.as_tensor(spp_idx).reshape(-1).tolist():
        for b0 in range(r0, r1, rows):
            b1 = min(b0 + rows, r1)
            shard[b0 - r0:b1 - r0] += render_pass(scene, s, (b0, b1), qmc)
    return shard


def gather_rows(shard, H):
    """The whole [H, W, 3] frame from every rank's row shard (all-gather:
    each shard padded to the largest, then cut)."""
    if not dist.is_initialized():
        return shard
    world = dist.get_world_size()
    shards = row_shards(H, world)
    per = shards[0][1] - shards[0][0]
    padded = torch.zeros((per,) + tuple(shard.shape[1:]), dtype=shard.dtype,
                         device=shard.device)
    padded[:shard.shape[0]] = shard
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:r1 - r0] for p, (r0, r1) in zip(parts, shards)])


def film_allreduce_pass(scene, spp_idx, qmc=None):
    """render_pass(scene, spp_idx, qmc=qmc) [H, W, 3] on every rank: each
    renders its row shard (shard_render_pass), then the shards are
    all-gathered (the multi-host film reduction)."""
    return gather_rows(shard_render_pass(scene, spp_idx, qmc),
                       scene.camera.res_y)


def all_reduce_sum(t):
    """t summed over the ranks, in place (a no-op outside a group)."""
    if dist.is_initialized():
        dist.all_reduce(t)
    return t
