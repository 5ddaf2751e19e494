"""Offline NL-means / joint-feature denoiser (the port of
tungsten_tpu/tools/denoiser.py, the analog of the reference's denoiser
tool, src/denoiser/Denoiser.cpp, nlmeans/*): non-local means over the
color buffer with per-pixel variance modulation, weighted by the AOV
buffers (normal/albedo/depth) when given.  The filter is a scan over the
window's offsets of whole shifted images on the device, as in the JAX
version (no per-pixel loops).

Usage:
    python -m tungsten_tpu_torch.tools.denoiser in.pfm out.pfm \
        [--normal n.pfm --albedo a.pfm --depth d.pfm --variance v.pfm] \
        [--radius 7 --patch 1 --k 0.45] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..scene.parse import check_device


def _shift(img, dy, dx):
    """img [H, W, ...] shifted by (dy, dx) with edge clamp: the value at
    (y, x) is img's at (clamp(y + dy), clamp(x + dx)), so candidate
    patches never mix opposite image borders."""
    H, W = img.shape[0], img.shape[1]
    if dy == 0 and dx == 0:
        return img
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[ys][:, xs]


def _box(img, r):
    """Separable box filter of half-width r over H, W (edge-padded, by
    differences of cumulative sums)."""
    k = 2 * r + 1
    H, W = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(-r - 1, H + r, device=img.device), 0,
                     H - 1)
    c = torch.cumsum(img[ys], dim=0)
    img = (c[k:] - c[:-k]) / k
    xs = torch.clamp(torch.arange(-r - 1, W + r, device=img.device), 0,
                     W - 1)
    c = torch.cumsum(img[:, xs], dim=1)
    return (c[:, k:] - c[:, :-k]) / k


def nl_means(color, variance=None, normal=None, albedo=None, depth=None,
             radius=7, patch=1, k=0.45, feature_k=0.6, device="cuda"):
    """Joint NL-means.  color [H,W,3]; optional variance [H,W,(3)],
    normal/albedo [H,W,3], depth [H,W] (numpy or tensors).  Returns the
    filtered [H,W,3] as numpy, computed on `device`.

    Weight for offset (dy,dx):
      w = exp(-max(d2_patch, 0)) * prod_f exp(-d2_feature)
    with the variance-modulated patch distance of Rousselle et al. (the
    reference's nlmeans formulation): d2 = ((u-v)^2 - (Vu+min(Vu,Vv)))
                                           / (eps + k^2 (Vu+Vv)).
    """
    device = check_device(device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    color = t(color)
    H, W, _ = color.shape
    var = (torch.zeros(H, W, 3, device=device) if variance is None
           else t(variance).reshape(H, W, -1).expand(H, W, 3))
    feats = []
    if normal is not None:
        feats.append(t(normal))
    if albedo is not None:
        feats.append(t(albedo))
    if depth is not None:
        d = t(depth).reshape(H, W, 1)
        feats.append(d / torch.clamp(d.max(), min=1e-6))

    acc = torch.zeros_like(color)
    wsum = torch.zeros(H, W, device=device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            cs = _shift(color, dy, dx)
            vs = _shift(var, dy, dx)
            d2 = ((color - cs) ** 2 - (var + torch.minimum(var, vs))) \
                / (1e-4 + k * k * (var + vs))
            d2 = _box(torch.clamp(d2, min=0.0), patch).mean(dim=-1)
            w = torch.exp(-d2)
            for f in feats:
                fd2 = ((f - _shift(f, dy, dx)) ** 2).sum(dim=-1) / (
                    feature_k * feature_k)
                w = w * torch.exp(-torch.clamp(fd2, max=30.0))
            acc = acc + w[..., None] * cs
            wsum = wsum + w
    return (acc / torch.clamp(wsum, min=1e-8)[..., None]).cpu().numpy()


def main(argv=None):
    from ..io.image import read_pfm, write_pfm, write_png
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--normal")
    ap.add_argument("--albedo")
    ap.add_argument("--depth")
    ap.add_argument("--variance")
    ap.add_argument("--radius", type=int, default=7)
    ap.add_argument("--patch", type=int, default=1)
    ap.add_argument("--k", type=float, default=0.45)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def ld(p):
        return None if p is None else read_pfm(p)

    out = nl_means(read_pfm(args.input), variance=ld(args.variance),
                   normal=ld(args.normal), albedo=ld(args.albedo),
                   depth=(None if args.depth is None
                          else read_pfm(args.depth)[..., 0]),
                   radius=args.radius, patch=args.patch, k=args.k,
                   device=args.device)
    if args.output.endswith(".png"):
        write_png(args.output, out)
    else:
        write_pfm(args.output, out)


if __name__ == "__main__":
    main()
