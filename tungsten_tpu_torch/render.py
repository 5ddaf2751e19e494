"""Render entry point:
`python -m tungsten_tpu_torch.render scene.json --spp N --res WxH -o out.png
--device cuda`.

Loads a Tungsten JSON scene onto the device, renders `spp` samples per
pixel and writes the image as PNG (tonemapped) and PFM (linear).  Several
samples run in one ray batch, up to MAX_RAYS rays; a frame of more pixels
than that renders in bands of MAX_RAYS // W rows, one sample at a time
(the JAX package's row tiling), with the same image.  The device decides the
path: on `cuda` the noise sums run in the CUDA kernels, on `cpu` in their
plain PyTorch twins; asking for `cuda` without a card is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .io.image import write_pfm, write_png
from .models.integrator import render_pass
from .scene.parse import DEFAULT_SEED, check_device, load_scene

MAX_RAYS = 1 << 18


def to_device(obj, device):
    """A copy of a tree of frozen dataclasses with every tensor on device."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


def render(scene, spp, device="cuda", progress=None):
    """Sum of samples 0 .. spp - 1 for every pixel: [H, W, 3] float32 on
    `device`.  progress(samples_done, film) is called after each ray
    batch."""
    device = check_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = to_device(scene, device)
    H, W = scene.camera.res_y, scene.camera.res_x
    film = torch.zeros(H, W, 3, dtype=torch.float32, device=device)
    if H * W > MAX_RAYS:
        rows = max(1, MAX_RAYS // W)
        for s in range(spp):
            for r0 in range(0, H, rows):
                r1 = min(r0 + rows, H)
                film[r0:r1] += render_pass(scene, s, (r0, r1))
            if progress is not None:
                progress(s + 1, film)
        return film
    per_batch = MAX_RAYS // (H * W)
    s = 0
    while s < spp:
        n = min(per_batch, spp - s)
        film = film + render_pass(scene, torch.arange(s, s + n,
                                                      device=device))
        s += n
        if progress is not None:
            progress(s, film)
    return film


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render a Tungsten JSON scene with tungsten_tpu_torch.")
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--res", default=None, metavar="WxH",
                    help="override the camera resolution (e.g. 256x256)")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    res = None
    if args.res:
        w, h = args.res.lower().split("x")
        res = (int(w), int(h))
    scene, rdoc = load_scene(args.scene, seed=args.seed, res_override=res,
                             device=device)
    spp = args.spp or int(rdoc.get("spp", 32))
    out = args.output or os.path.splitext(args.scene)[0] + ".png"
    H, W = scene.camera.res_y, scene.camera.res_x

    t0 = time.perf_counter()

    def progress(done, film):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        el = time.perf_counter() - t0
        print(f"spp {done}/{spp}  ({el:.2f} s, "
              f"{H * W * done / max(el, 1e-9) / 1e3:.2f} Ksamples/s on "
              f"{device})", flush=True)

    film = render(scene, spp, device=device, progress=progress)
    img = (film / spp).cpu().numpy().astype(np.float32)
    write_png(out, img)
    write_pfm(os.path.splitext(out)[0] + ".pfm", img)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
