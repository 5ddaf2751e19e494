"""The hyperparameter gradient of BASELINE configs 1, 2, 3, 3b, 4a and 5
(the hero), the port's counterpart of the JAX package's
`__graft_entry__.py`: `python -m tungsten_tpu_torch.entry --device cuda
--steps 3 [--scene scenes/gpis-hero.json] [--spp 1]`.

`fwd_bwd(scene, spp_idx)` renders one pass and returns the image with
d sum(image) / d(sigma, l) of medium 0's covariance, as `entry()` does
there; `train_step(scene, target, spp_idx, lr)` is one step of
`dryrun_multichip`'s inverse rendering on one device: the L2 loss of the
pass against `target` (a mean where step_shard sums; see train_step), its
gradient in (sigma, l), and one SGD step on them (no all-reduce: one
device).  (sigma, l) are those of medium 0's covariance, of its stationary
base for the hero's procedural nonstationary covariance.
The render keeps its graph only from the parameters on, by the
detached-sampling estimator (models/integrator.py); on CUDA tensors the
lattice sum's backward is kernel K1b (the 3D sum of configs 1 and 2), K2b
(the hero's two multi-resolution levels) or K3b (the 1D sum of configs 3
and 3b).  A weight-space medium (config 4a) searches with K5 or K4 on
detached parameters and differentiates through its realization in
PyTorch (models/media.py `_ws_reattach`).

`train_step_sharded` is the same step over the ranks of a process group
(each rank's rows, the loss and gradient all-reduced: the psum of
`dryrun_multichip`'s shard_map step), and `dryrun_multichip(n)` runs one
such step of config 1 at 16x16 in n processes on the card (or, with
`device="cpu"`, in n gloo processes on the CPU).

The CLI loads `--scene` (config 1, `scenes/gpis-sphere-box.json`, by
default) at its own resolution (or `--res WxH`), spp (or `--spp`) and
depth (config 1: 128x128, 4 spp; config 2: 256x256, 16 spp; configs 3
and 3b: 128x128, 16 spp; config 4a: 128x128, 8 spp; the hero: 1920x1080,
32 spp; max_bounces 2 in all) and takes `--steps` steps against a zero
target, printing each step's loss, parameters and gradient.  A step of
at most `render.MAX_RAYS` rays renders all its samples in one ray batch;
a larger one in render.render's groups of samples or, above MAX_RAYS
pixels (the hero's), its row bands (see train_step).  With `--sharded`
under `python -m torch.distributed.run --nproc_per_node N -m
tungsten_tpu_torch.entry --sharded`, each step is train_step_sharded.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch

from . import convert, render
from .kernels import noise3d
from .models.integrator import render_pass
from .ops.covariance import GaborAnisoCov, GaborIsoCov
from .ops.means import ProceduralMean
from .scene.parse import check_device, load_scene

# the procedural SDF means with the knob's base, whose capped cylinder
# has a NaN gradient inside (ops/sdf.py sd_capped_cylinder)
NAN_SDFS = ("knob", "knob_outer")
SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "gpis-sphere-box.json")


def _check_gradient_scope(scene):
    """Raise by name on what the gradient does not reach: the
    function-space Global and None contexts, its skip_space and mesh
    conditioning (they run only on the function-space medium, which the
    JAX package cannot reverse-differentiate), and the GP types on which
    JAX's own jax.grad fails: the Gabor covariances, which have no length
    scale l (the JAX package's set_params fails on them), and the knob
    SDF means, whose gradient is NaN inside the knob's base (NAN_SDFS).
    Every other covariance, mean, field, normal method, sampling space,
    context and material of a sparse-conv or weight-space medium takes the
    gradient in (sigma, l); the anisotropy is not a parameter
    (ops/weight_space.py refuses its gradient)."""
    for med in scene.media:
        gp, cfg = med.gp, med.cfg
        what = None
        if med.kind == "function_space" and cfg.ctxt in ("global", "none"):
            what = f"the function-space {cfg.ctxt!r} context"
        elif gp.global_cond is not None:
            what = "mesh conditioning (conditioning_data)"
        elif med.kind == "function_space" and med.skip_space > 0.0:
            what = "the function-space skip_space"
        elif isinstance(gp.cov, (GaborAnisoCov, GaborIsoCov)):
            what = (f"a {type(gp.cov).__name__} (it has no length scale "
                    "l: the JAX package's set_params fails on it)")
        elif any(isinstance(m, ProceduralMean) and m.fn_name in NAN_SDFS
                 for m in (gp.mean, gp.mean_additional)):
            what = ("the procedural knob mean (its SDF's gradient is NaN "
                    "inside the knob's capped cylinder, 0 * inf, in "
                    "jax.grad too)")
        if what is not None:
            raise NotImplementedError(
                f"the gradient through {what} is refused by "
                "tungsten_tpu_torch (ROADMAP queue 3)")


def params(scene):
    """(sigma, l) of medium 0's covariance (of its stationary base when it
    is procedural nonstationary)."""
    _check_gradient_scope(scene)
    cov = scene.media[0].gp.cov
    if not cov.is_stationary:
        cov = cov.base
    return cov.sigma, cov.l


def _leaves(scene):
    """Fresh leaves holding (sigma, l), which require grad."""
    return tuple(x.detach().clone().requires_grad_() for x in params(scene))


def fwd_bwd(scene, spp_idx):
    """(image [H, W, 3], (d sum(image) / d sigma, d sum(image) / d l)) of
    one render pass at sample index spp_idx (an int or an [S] tensor)."""
    sigma, l = _leaves(scene)
    img = render_pass(convert.set_params(scene, sigma, l), spp_idx)
    grads = torch.autograd.grad(img.sum(), (sigma, l))
    return img.detach(), grads


def _loss_grad(scene, target, spp_idx, rows=None):
    """(sigma, l, loss, dsigma, dl): the leaves holding (sigma, l), and the
    part of train_step's loss that the rows range(*rows) of the image
    make (all rows by default), normalised by the WHOLE image's size, with
    its gradient in (sigma, l).  The parts of disjoint row ranges sum to
    the whole image's loss and gradient.  See train_step for the ray
    batches."""
    sigma, l = _leaves(scene)
    samples = torch.as_tensor(spp_idx).reshape(-1)
    spp = samples.numel()
    pscene = convert.set_params(scene, sigma, l)
    W = scene.camera.res_x
    r0, r1 = rows if rows is not None else (0, scene.camera.res_y)
    part = target[r0:r1]
    n = part.shape[0] * W
    if n == 0:  # a rank of more ranks than rows
        zero = torch.zeros((), device=sigma.device)
        return sigma.detach(), l.detach(), zero, zero, zero
    if n * spp <= render.MAX_RAYS:
        img = render_pass(pscene, spp_idx, (r0, r1)) / spp
        loss = ((img - part) ** 2).sum() / target.numel()
        gs, gl = torch.autograd.grad(loss, (sigma, l))
    elif n <= render.MAX_RAYS:
        per = render.MAX_RAYS // n
        groups = [samples[i:i + per] for i in range(0, spp, per)]
        with torch.no_grad():
            img = sum(render_pass(pscene, g, (r0, r1)) for g in groups) / spp
        resid = img - part
        loss = (resid ** 2).sum() / target.numel()
        d_img = resid * (2.0 / (target.numel() * spp))
        gs = gl = 0.0
        for g in groups:
            d_s, d_l = torch.autograd.grad(render_pass(pscene, g, (r0, r1)),
                                           (sigma, l), grad_outputs=d_img)
            gs, gl = gs + d_s, gl + d_l
    else:
        band_rows = max(1, render.MAX_RAYS // W)
        loss = gs = gl = 0.0
        for b0 in range(r0, r1, band_rows):
            b1 = min(b0 + band_rows, r1)
            band = 0.0
            for s in samples.tolist():
                band = band + render_pass(pscene, s, (b0, b1))
            band_loss = ((band / spp - target[b0:b1]) ** 2).sum() \
                / target.numel()
            d_s, d_l = torch.autograd.grad(band_loss, (sigma, l))
            loss, gs, gl = loss + band_loss.detach(), gs + d_s, gl + d_l
    return sigma.detach(), l.detach(), loss.detach(), gs, gl


def train_step(scene, target, spp_idx, lr=1e-3):
    """One SGD step on (sigma, l) against the L2 loss of a render pass:
    returns (new sigma, new l, loss, (dsigma, dl)), the first three as the
    JAX package's step_shard returns them.

    The loss differs from step_shard's by a known factor: it is the MEAN
    squared error of the pass's image (the mean of its samples) against
    target [H, W, 3], where step_shard takes the SUM over its 16x16 pixels
    at 1 spp.  At 1 spp, loss and gradient here are step_shard's divided by
    3 * H * W (tests/test_torch_grad.py holds them so).  The mean keeps the
    step of lr = 1e-3 small at any resolution: at 128x128 the sum's first
    step would move sigma by hundreds of times its value.

    A frame of more than `render.MAX_RAYS` pixels renders in
    render.render's bands of MAX_RAYS // W rows, one sample at a time; each
    band's part of the loss is backpropagated on its own and the bands'
    gradients are summed before the step, as dryrun_multichip sums its row
    shards.  A smaller frame whose samples make more than MAX_RAYS rays
    (config 2's 256x256 at 16 spp) renders in render.render's groups of
    MAX_RAYS // (H * W) samples: the loss, a square of the samples' mean,
    needs the whole image before any group's backward, so the groups are
    first rendered without a graph (a plain render has the values of one
    with gradient), then each is rendered again and backpropagated on its
    own with the loss's gradient in its image, and the groups' gradients
    are summed.  Either way the loss and gradient are the single batch's
    (to rounding), and the peak memory is one band's or group's graph."""
    sigma, l, loss, gs, gl = _loss_grad(scene, target, spp_idx)
    return sigma - lr * gs, l - lr * gl, loss, (gs, gl)


def train_step_sharded(scene, target, spp_idx, lr=1e-3):
    """train_step over the ranks of the process group (the port's
    counterpart of dryrun_multichip's shard_map step): each rank takes the
    loss part and gradient of its rows (parallel/mesh.row_shards), each
    normalised by the whole image's size, the three are all-reduced (SUM)
    and every rank takes the same SGD step.  The result is train_step's
    on the whole image, to the rounding of the sums' order."""
    from .parallel import mesh
    rank, world = mesh.rank_world()
    rows = mesh.row_shards(scene.camera.res_y, world)[rank]
    sigma, l, loss, gs, gl = _loss_grad(scene, target, spp_idx, rows)
    parts = mesh.all_reduce_sum(torch.stack([
        torch.as_tensor(x, dtype=torch.float32, device=sigma.device)
        for x in (loss, gs, gl)]))
    loss, gs, gl = parts.unbind()
    return sigma - lr * gs, l - lr * gl, loss, (gs, gl)


def _dryrun_rank(rank, world, device):
    """One rank of dryrun_multichip: config 1 at 16x16, depth 2, 1 spp,
    a zero target; returns (loss, new sigma - sigma, new l - l) as floats."""
    from .parallel import mesh
    device = mesh.rank_device(device)
    scene, _ = load_scene(SCENE, res_override=(16, 16), device=device)
    scene = mesh.broadcast_scene(scene)
    target = torch.zeros(16, 16, 3, device=device)
    sigma0, l0 = params(scene)
    sigma, l, loss, _ = train_step_sharded(scene, target, 0)
    return float(loss), float(sigma - sigma0), float(l - l0)


def dryrun_multichip(n_devices, device="cuda"):
    """The port's counterpart of the JAX package's dryrun_multichip: one
    inverse-rendering step (config 1 at 16x16, depth 2, 1 spp, against a
    zero target) sharded over n_devices processes, the loss and gradient
    all-reduced.  On "cuda": an nccl group with one card a rank
    (cuda:LOCAL_RANK) when the machine has n_devices cards or more, else
    a gloo group whose ranks share cuda:0 (or the card named); on the CPU
    a gloo group.  Raises unless the loss is finite and the step moved
    sigma and l; returns (loss, dsigma step, dl step) as rank 0 saw
    them."""
    from .parallel import launch
    device = check_device(device)
    if device.type != "cuda":
        backend, device = "gloo", str(device)
    elif device.index is None and n_devices <= torch.cuda.device_count():
        backend, device = "nccl", "cuda"
    else:
        backend, device = "gloo", str(torch.device("cuda", device.index or 0))
    if device.startswith("cuda"):
        noise3d.build()  # once, before the ranks start
    results = launch.spawn(_dryrun_rank, n_devices, device, backend=backend,
                           threads=1 if device == "cpu" else 0)
    loss, ds, dl = results[0]
    if any(r != results[0] for r in results):
        raise RuntimeError(f"the ranks took different steps: {results}")
    if not math.isfinite(loss):
        raise RuntimeError("dry-run loss is not finite")
    if not (math.isfinite(ds) and math.isfinite(dl)):
        raise RuntimeError("the step is not finite")
    if ds == 0.0:
        raise RuntimeError("dsigma == 0: hyperparameter gradient chain "
                           "severed")
    if dl == 0.0:
        raise RuntimeError("dl == 0: hyperparameter gradient chain severed")
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f} dsigma={ds:.2e} "
          f"dl={dl:.2e}")
    return loss, ds, dl


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Inverse-rendering steps on the GP hyperparameters of "
                    "a GPIS scene (BASELINE config 1, 2, 3, 3b, 4a or 5) "
                    "with tungsten_tpu_torch.")
    ap.add_argument("--scene", default=SCENE,
                    help="the scene file (default: config 1's "
                         "scenes/gpis-sphere-box.json)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--res", default=None, metavar="WxH",
                    help="override the camera resolution (the scene's "
                         "by default)")
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per pixel of a step (the scene's by "
                         "default)")
    ap.add_argument("--sharded", action="store_true",
                    help="split the rows over the ranks of "
                         "torch.distributed.run (nccl on cuda, gloo on cpu); "
                         "rank 0 prints")
    args = ap.parse_args(argv)

    rank = 0
    if args.sharded:
        from .parallel import mesh
        rank, _ = mesh.init_distributed(args.device)
        device = mesh.rank_device(args.device)
    else:
        device = check_device(args.device)
    step_fn = train_step_sharded if args.sharded else train_step
    res = None
    if args.res:
        w, h = args.res.lower().split("x")
        res = (int(w), int(h))
    scene, rdoc = load_scene(args.scene, res_override=res, device=device)
    if args.sharded:
        scene = mesh.broadcast_scene(scene)
    spp = args.spp or int(rdoc.get("spp", 4))
    spp_idx = torch.arange(spp, device=device)
    H, W = scene.camera.res_y, scene.camera.res_x
    target = torch.zeros(H, W, 3, device=device)
    if H * W * spp <= render.MAX_RAYS:
        batches = f"in one batch of {W * H * spp} rays"
    elif H * W <= render.MAX_RAYS:
        per = render.MAX_RAYS // (H * W)
        batches = (f"in {-(-spp // per)} groups of {per} samples, each "
                   "rendered twice (without and with a graph)")
    else:
        rows = max(1, render.MAX_RAYS // W)
        batches = (f"in {-(-H // rows)} bands of {rows} rows, one sample at "
                   "a time")
    if rank == 0:
        print(f"{os.path.basename(args.scene)}: {W}x{H}, {spp} spp "
              f"{batches}, max_bounces {scene.max_bounces}, on {device}",
              flush=True)
    for step in range(args.steps):
        t0 = time.perf_counter()
        sigma, l, loss, (gs, gl) = step_fn(scene, target, spp_idx)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        if not (bool(torch.isfinite(loss)) and all(
                math.isfinite(float(g)) and float(g) != 0.0
                for g in (gs, gl))):
            raise RuntimeError(f"step {step}: loss {float(loss)}, dsigma "
                               f"{float(gs)}, dl {float(gl)}: the "
                               "hyperparameter gradient is severed or not "
                               "finite")
        if rank == 0:
            print(f"step {step}: loss {float(loss):.6f} sigma "
                  f"{float(sigma):.6f} l {float(l):.6f} dsigma "
                  f"{float(gs):.6e} dl {float(gl):.6e} ({wall:.2f} s)",
                  flush=True)
        scene = convert.set_params(scene, sigma, l)
    if args.sharded and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
