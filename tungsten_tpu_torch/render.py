"""Render entry point:
`python -m tungsten_tpu_torch.render scene.json --spp N --res WxH -o out.png
--device cuda [options]`.

Loads a Tungsten JSON scene onto the device, renders `spp` samples per
pixel and writes the image as PNG (tonemapped) and PFM (linear), or as EXR
and PNG for `-o *.exr`.  Several samples run in one ray batch, up to
MAX_RAYS rays; a frame of more pixels than that renders in bands of
MAX_RAYS // W rows, one sample at a time (the JAX package's row tiling),
with the same image.  The device decides the path: on `cuda` the noise sums
run in the CUDA kernels, on `cpu` in their plain PyTorch twins; asking for
`cuda` without a card is an error.

The options of the JAX package's driver (tungsten_tpu/render.py):
`--checkpoint-interval N` writes `<output>.ckpt.npz` (film, spp,
scene_hash) every N samples, and `--resume` continues from it when the
scene file's hash matches; `--sharded` splits the rows over the ranks of
`python -m torch.distributed.run --nproc_per_node N -m
tungsten_tpu_torch.render ... --sharded` (parallel/mesh.py; rank 0 writes
the outputs); `--aovs` also writes depth, normal, albedo and visibility
buffers; `--adaptive EXTRA` adds EXTRA samples to the pixels of the tiles
whose twin-buffer error is high; `--sampler sobol` draws the first bounces
from a rotated Sobol sequence; `--data-dump-pixel X,Y` writes the field
along that pixel's primary ray instead of rendering; `--serve PORT`
exposes /status, /framebuffer and /log; `--tonemap` picks the PNG's tone
curve; `--profile DIR` writes a torch.profiler trace of the render loop.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from .io.image import CURVES, write_pfm, write_png
from .models import media as md
from .models.integrator import render_aovs, render_pass, trace
from .parallel import mesh
from .scene.parse import DEFAULT_SEED, check_device, load_scene
from .utils import sobol

MAX_RAYS = 1 << 18
TONEMAPS = tuple(CURVES)


def to_device(obj, device):
    """A copy of a tree of frozen dataclasses with every tensor on device."""
    return mesh.map_tensors(obj, lambda t: t.to(device))


def scene_hash(path):
    """The checkpoint guard: a hash of the scene file without its
    `renderer` block (the JAX package's scene_hash, the same digest)."""
    with open(path) as f:
        doc = json.load(f)
    doc.pop("renderer", None)
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


def render(scene, spp, spp_start=0, film=None, progress=None, sharded=False,
           sampler="independent", device="cuda", checkpoint_interval=0):
    """`film` (zeros by default) plus samples spp_start .. spp_start + spp
    - 1 of every pixel: [H, W, 3] float32 on `device`.
    progress(samples_done, film) is called after each ray batch, where
    samples_done counts from 0 (spp_start included).

    `sharded`: every rank of the process group renders its rows and holds
    the gathered film (parallel/mesh.py), bit for bit the single-process
    one.  `sampler`: "independent" (the hash sampler) or "sobol" (each
    sample's first bounces from its Sobol point, utils/sobol.py).
    `checkpoint_interval`:
    ray batches end on its multiples, so the film at each holds whole
    samples."""
    device = check_device(device)
    if sampler not in ("independent", "sobol"):
        raise ValueError(f"unknown sampler {sampler!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = to_device(scene, device)
    H, W = scene.camera.res_y, scene.camera.res_x
    film = (torch.zeros(H, W, 3, dtype=torch.float32, device=device)
            if film is None else torch.as_tensor(
                film, dtype=torch.float32, device=device).clone())
    banded = H * W > MAX_RAYS
    per_batch = 1 if banded else MAX_RAYS // (H * W)
    rows = max(1, MAX_RAYS // W)
    s, end = spp_start, spp_start + spp
    kw = {}
    if sampler == "sobol":  # row i: sample i's point
        kw["qmc"] = torch.from_numpy(np.stack([
            sobol.sobol_point(i) for i in range(end)])).to(device)
    while s < end:
        n = min(per_batch, end - s)
        if checkpoint_interval:
            n = min(n, checkpoint_interval - s % checkpoint_interval)
        if sharded:
            samples = s if n == 1 else torch.arange(s, s + n, device=device)
            film = film + mesh.film_allreduce_pass(scene, samples, **kw)
        elif banded:
            for r0 in range(0, H, rows):
                r1 = min(r0 + rows, H)
                film[r0:r1] += render_pass(scene, s, (r0, r1), **kw)
        else:
            film = film + render_pass(
                scene, torch.arange(s, s + n, device=device), **kw)
        s += n
        if progress is not None:
            progress(s, film)
    return film


def adaptive_mask(even, odd, base_spp):
    """[H, W] bool of the pixels that take the adaptive samples, from the
    even- and odd-sample sums [H, W, 3] (numpy), as the JAX package's
    render_adaptive selects them with its defaults: the twin buffers'
    relative error per 4x4 tile, clamped at its 0.95 quantile, above half
    the clamp, dilated by one tile."""
    tile, quantile = 4, 0.95
    H, W = even.shape[:2]
    ne, no = (base_spp + 1) // 2, base_spp // 2
    me = np.asarray(even) / max(ne, 1)
    mo = np.asarray(odd) / max(no, 1)
    err = np.abs(me - mo).sum(-1) / np.maximum((me + mo).sum(-1), 1e-3)
    th, tw = H // tile, W // tile
    tile_err = err[:th * tile, :tw * tile].reshape(th, tile, tw, tile) \
        .mean((1, 3))
    clamp = np.quantile(tile_err, quantile)
    tile_err = np.minimum(tile_err, clamp)
    sel = tile_err > 0.5 * clamp
    sel = (sel | np.roll(sel, 1, 0) | np.roll(sel, -1, 0)
           | np.roll(sel, 1, 1) | np.roll(sel, -1, 1))
    mask = np.zeros((H, W), bool)
    mask[:th * tile, :tw * tile] = np.repeat(np.repeat(sel, tile, 0), tile,
                                             1)
    return mask


def render_adaptive(scene, base_spp, extra_spp, progress=None,
                    device="cuda"):
    """Adaptive sampling (the JAX package's render_adaptive): base_spp
    samples fill twin buffers (even and odd samples), `adaptive_mask`
    picks the pixels, and those are compacted into one flat ray batch
    traced for extra_spp more samples.  Returns (film sum [H, W, 3],
    samples per pixel [H, W]), both on `device`."""
    device = check_device(device)
    scene = to_device(scene, device)
    H, W = scene.camera.res_y, scene.camera.res_x
    even = torch.zeros(H, W, 3, dtype=torch.float32, device=device)
    odd = torch.zeros_like(even)
    for s in range(base_spp):
        if s % 2 == 0:
            even = even + render_pass(scene, s)
        else:
            odd = odd + render_pass(scene, s)
        if progress is not None:
            progress(s + 1, even + odd)
    film = even + odd
    counts = torch.full((H, W), float(base_spp), device=device)
    if extra_spp <= 0:
        return film, counts
    ys, xs = np.nonzero(adaptive_mask(even.cpu().numpy(), odd.cpu().numpy(),
                                      base_spp))
    if len(xs) == 0:
        return film, counts
    px = torch.from_numpy(xs).to(device)
    py = torch.from_numpy(ys).to(device)
    add = torch.zeros(H * W, 3, dtype=torch.float32, device=device)
    for s in range(base_spp, base_spp + extra_spp):
        add.index_add_(0, py * W + px, trace(scene, px, py, s))
        if progress is not None:
            progress(s + 1, film)
    counts[py, px] += extra_spp
    return film + add.reshape(H, W, 3), counts


def dump_pixel(scene, px, py, spp=0, n=512):
    """The field value f at n points t in [0, 4] along pixel (px, py)'s
    primary ray (through its centre) in the camera's medium (medium 0
    when the camera is in none), as the JAX package's dump_pixel: {"t":
    [...], "f": [...]}.  Sparse-conv media only."""
    if not scene.media:
        return {"t": [], "f": []}
    medium = scene.media[scene.cam_medium if scene.cam_medium >= 0 else 0]
    if medium.kind != md.GPIS_SPARSE_CONV:
        raise NotImplementedError(f"dump_pixel of a {medium.kind} medium is "
                                  "not ported to tungsten_tpu_torch")
    dev = scene.lights.device
    ro, rd = scene.camera.sample_ray(
        torch.tensor([px], device=dev), torch.tensor([py], device=dev),
        torch.full((1, 2), 0.5, device=dev))
    pss = torch.tensor([[px, py, spp, 0]], device=dev).expand(n, 4)
    value_at = md.make_value_at(medium, scene.scene_seed, ro.expand(n, 3),
                                rd.expand(n, 3), pss,
                                md.MediumState.make(n, dev))
    # jnp.linspace(0, 4, n)'s float32 rounding on XLA: 4 * (i * (1 / (n -
    # 1))), then 4
    step = torch.tensor(1.0 / max(n - 1, 1), dtype=torch.float32,
                        device=dev)
    ts = torch.cat([torch.arange(n - 1, dtype=torch.float32, device=dev)
                    * step * 4.0, torch.full((1,), 4.0, device=dev)])
    f, _ = value_at(ts)
    return {"t": ts.tolist(), "f": f.tolist()}


def write_image(out, img, curve="gamma"):
    """img [H, W, 3] as `out`: EXR and a tonemapped PNG beside it for
    *.exr, else a PNG and a PFM beside it."""
    base = os.path.splitext(out)[0]
    if out.lower().endswith(".exr"):
        from .io.exr import write_exr
        write_exr(out, img)
        write_png(base + ".png", img, tonemap=True, curve=curve)
    else:
        write_png(out, img, tonemap=True, curve=curve)
        write_pfm(base + ".pfm", img)


def write_aovs(scene, spp, base):
    """The mean of min(8, spp) samples' feature buffers as
    `<base>.<name>.pfm` and `.png` (depth normalised by its largest value,
    normals mapped to [0, 1], albedo tonemapped), as the JAX driver writes
    them."""
    acc = None
    for s in range(min(8, spp)):
        _, a = render_aovs(scene, s)
        acc = a if acc is None else {k: acc[k] + a[k] for k in a}
    for k, v in acc.items():
        v = v.cpu().numpy() / min(8, spp)
        if v.ndim == 2:
            v = np.repeat(v[..., None], 3, axis=-1)
        if k == "depth":
            v = v / max(v.max(), 1e-6)
        if k == "normal":
            v = v * 0.5 + 0.5
        write_pfm(f"{base}.{k}.pfm", v.astype(np.float32))
        write_png(f"{base}.{k}.png", v, tonemap=(k == "albedo"))


def main(argv=None):
    """The CLI.  Returns the RenderServer of `--serve`, still serving its
    final state (a daemon thread; `shutdown()` ends it), else None."""
    ap = argparse.ArgumentParser(
        description="Render a Tungsten JSON scene with tungsten_tpu_torch.")
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--res", default=None, metavar="WxH",
                    help="override the camera resolution (e.g. 256x256)")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("-o", "--output", default=None,
                    help="PNG (and PFM beside it) or, for *.exr, EXR (and "
                         "PNG)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK with --sharded) or cpu")
    ap.add_argument("--checkpoint-interval", type=int, default=0,
                    help="write <output>.ckpt.npz every N spp")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <output>.ckpt.npz when its scene "
                         "hash matches")
    ap.add_argument("--sharded", action="store_true",
                    help="split the rows over the ranks of "
                         "torch.distributed.run (nccl on cuda, gloo on cpu)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render loop "
                         "into DIR")
    ap.add_argument("--aovs", action="store_true",
                    help="also write depth/normal/albedo/visibility buffers")
    ap.add_argument("--tonemap", default="gamma", choices=TONEMAPS)
    ap.add_argument("--integrator", default="path_tracer",
                    help="only path_tracer is ported")
    ap.add_argument("--sampler", default=None,
                    choices=["independent", "sobol"],
                    help="overrides the scene's sampler_type")
    ap.add_argument("--adaptive", type=int, default=0, metavar="EXTRA_SPP",
                    help="extra adaptive samples for high-variance tiles")
    ap.add_argument("--data-dump-pixel", default=None, metavar="X,Y",
                    help="dump the field along the primary ray to JSON")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="expose /status /framebuffer /log on PORT (0: any "
                         "free port)")
    args = ap.parse_args(argv)

    if args.integrator != "path_tracer":
        raise NotImplementedError(
            f"integrator {args.integrator!r} is not ported to "
            "tungsten_tpu_torch (ROADMAP queue 1, item 18)")
    if args.adaptive > 0 and args.sharded:
        raise NotImplementedError("--adaptive with --sharded is not ported "
                                  "to tungsten_tpu_torch")
    rank, world = 0, 1
    if args.sharded:
        rank, world = mesh.init_distributed(args.device)
        device = mesh.rank_device(args.device)
    else:
        device = check_device(args.device)
    res = None
    if args.res:
        w, h = args.res.lower().split("x")
        res = (int(w), int(h))
    scene, rdoc = load_scene(args.scene, seed=args.seed, res_override=res,
                             device=device)
    scene = mesh.broadcast_scene(scene)
    spp = args.spp or int(rdoc.get("spp", 32))
    out = args.output or rdoc.get("output_file",
                                  os.path.splitext(args.scene)[0] + ".png")
    H, W = scene.camera.res_y, scene.camera.res_x

    if args.data_dump_pixel:
        dx, dy = (int(v) for v in args.data_dump_pixel.split(","))
        data = dump_pixel(scene, dx, dy)
        path = os.path.splitext(out)[0] + f".dump_{dx}_{dy}.json"
        if rank == 0:
            with open(path, "w") as f:
                json.dump(data, f)
            print(f"wrote {path}")
        return

    srv = None
    if args.serve is not None and rank == 0:
        from .server import RenderServer
        srv = RenderServer(port=args.serve)
        print(f"serving render status on http://127.0.0.1:{srv.port}",
              flush=True)

    ckpt_path = os.path.splitext(out)[0] + ".ckpt.npz"
    shash = scene_hash(args.scene)
    film, spp_start = None, 0
    if args.resume and os.path.exists(ckpt_path):
        with np.load(ckpt_path, allow_pickle=False) as d:
            if str(d["scene_hash"]) == shash:
                film, spp_start = d["film"], int(d["spp"])
                if rank == 0:
                    print(f"resumed at spp={spp_start}")
            elif rank == 0:
                print("scene hash mismatch; starting fresh")
    sampler = args.sampler or rdoc.get("sampler_type", "independent")
    if sampler not in ("independent", "sobol"):
        sampler = "sobol"  # the reference's default sampler is Sobol

    total = spp_start + spp + (args.adaptive if spp_start == 0 else 0)
    t0 = time.perf_counter()

    def progress(done, f):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        el = time.perf_counter() - t0
        n_done = max(done - spp_start, 1)
        ksps = H * W * n_done / max(el, 1e-9) / 1e3
        # a pixel-sample casts ~2 + 2 * depth rays that march the field
        # (camera, each bounce's scatter and the [2R] NEE shadow walk)
        mrays = ksps * (2 + 2 * scene.max_bounces) / 1e3
        if rank == 0:
            print(f"spp {done}/{total}  ({el:.2f} s, "
                  f"{el / n_done:.3f} s/spp, {ksps:.2f} Ksamples/s, "
                  f"~{mrays:.2f} Mrays/s on {device}"
                  + (f" x {world} ranks" if world > 1 else "") + ")",
                  flush=True)
        if rank == 0 and args.checkpoint_interval and \
                done % args.checkpoint_interval == 0:
            np.savez(ckpt_path, film=f.cpu().numpy(), spp=done,
                     scene_hash=shash)
        if srv is not None:
            srv.update(film=(f / done).cpu().numpy(), state="rendering",
                       scene=args.scene, spp_done=done, spp_total=total,
                       ksamples_s=round(ksps, 2))
            srv.log(f"spp {done}/{total}")

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()
    if args.adaptive > 0 and spp_start == 0:
        film, counts = render_adaptive(scene, spp, args.adaptive,
                                       progress=progress, device=device)
        img = film / counts[..., None]
        done = int(counts.max())
    else:
        film = render(scene, spp, spp_start=spp_start, film=film,
                      progress=progress, sharded=args.sharded,
                      sampler=sampler, device=device,
                      checkpoint_interval=args.checkpoint_interval)
        done = spp_start + spp
        img = film / done
    img = img.cpu().numpy().astype(np.float32)
    if prof is not None:
        prof.stop()
        if rank == 0:
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile, "render_trace.json")
            prof.export_chrome_trace(path)
            print(f"wrote profiler trace to {path}")

    if rank == 0:
        write_image(out, img, args.tonemap)
        print(f"wrote {out}")
        if srv is not None:
            srv.update(film=img, state="done", spp_done=done)
        if args.aovs:
            base = os.path.splitext(out)[0]
            write_aovs(scene, spp, base)
            print(f"wrote AOVs {base}.{{depth,normal,albedo,visibility}}")
    if args.sharded and world > 1:
        torch.distributed.destroy_process_group()
    return srv


if __name__ == "__main__":
    main()
