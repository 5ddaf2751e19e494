"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Builds kernel K1 from tungsten_tpu_torch/csrc/noise3d.cu, holds it against
its plain PyTorch twin on the card, renders BASELINE config 1
(scenes/gpis-sphere-box.json) through tungsten_tpu_torch.render, checks the
image and that the render went through K1, and compares a 64x64 render with
the committed reference golden by bucket means.  Each phase that fails
raises, so the script exits non-zero; it needs CUDA and never imports JAX
or the JAX package.
The last line of its output is one JSON object naming the device.

`python3 chip_smoke.py --profile` adds a phase that measures where the
render's time goes (PERF.md section 5): the 128x128 render at 1, 4 and 16
spp per ray batch, timed twice each, with its K1 launches and host syncs,
then one 16-spp render under torch.profiler, whose op table it writes to
chiprun_out/profile_16spp.txt.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
GOLDEN = os.path.join(ROOT, "goldens", "gpis-sphere-box.pfm")
PROFILE_TABLE = os.path.join(ROOT, "chiprun_out", "profile_16spp.txt")
K1_ATOL = 1e-5  # raw sum of at most 81 unit-bounded terms, fp32
TWIN_POINTS = 1 << 20


def phase(name):
    print(f"== {name}", flush=True)


def card():
    """(name, power limit) as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return out


def median_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def buckets(img, b=8):
    h, w, _ = img.shape
    return img.reshape(h // b, b, w // b, b, 3).mean(axis=(1, 3))


def golden_bucket_test(ours, gold, spp_ours, b=8):
    """Bucket-mean comparison with the reference golden (256 spp): a bucket
    is bad when it differs by more than 3 standard errors (the golden's own
    per-bucket spread, scaled for our sample count) plus 0.02."""
    gb, ob = buckets(gold, b), buckets(ours, b)
    gv = buckets((gold - np.repeat(np.repeat(gb, b, 0), b, 1)) ** 2, b)
    stderr_gold = np.sqrt(gv / (b * b))
    stderr_ours = stderr_gold * np.sqrt(256.0 / max(spp_ours, 1))
    tol = 3.0 * (stderr_gold + stderr_ours) + 0.02
    ratio = (ob.mean(-1).mean() + 1e-6) / (gb.mean(-1).mean() + 1e-6)
    frac_bad = float((np.abs(ob - gb) > tol).mean())
    return float(ratio), frac_bad


def timed(fn):
    """Seconds of host clock around fn(), from and to an idle card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def host_syncs(fn):
    """Host syncs in fn(), as torch.cuda.set_sync_debug_mode counts them:
    one warning per synchronizing CUDA operation."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def profile(trender, noise3d, scene, dev, card_line):
    """Where the 128x128 render's time goes; see the module docstring."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    walls16 = []
    for spp in (1, 4, 16):
        walls, launches = [], []
        for _ in range(2):
            before = noise3d.LAUNCHES
            walls.append(timed(lambda: trender.render(scene, spp, device=dev)))
            launches.append(noise3d.LAUNCHES - before)
        syncs = host_syncs(lambda: trender.render(scene, spp, device=dev))
        if syncs == 0:
            raise RuntimeError("set_sync_debug_mode reported no host sync")
        rates = ", ".join(f"{128 * 128 * spp / w / 1e3:.2f}" for w in walls)
        print(f"{spp} spp in one batch: {walls[0]:.4f} s, {walls[1]:.4f} s "
              f"({rates} Ksamples/s); K1 launches {launches}; host syncs "
              f"{syncs} ({card_line})", flush=True)
        if spp == 16:
            walls16 = walls

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        wall = timed(lambda: trender.render(scene, 16, device=dev))
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    k1_ms = sum(e.self_device_time_total for e in device
                if "noise3d_sum_s_kernel" in e.key) / 1e3
    launch = [e for e in events if e.key.startswith("cudaLaunchKernel")]
    n_launch = sum(e.count for e in launch)
    launch_ms = sum(e.cpu_time_total for e in launch) / 1e3
    os.makedirs(os.path.dirname(PROFILE_TABLE), exist_ok=True)
    with open(PROFILE_TABLE, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=60))
    print(f"16 spp under torch.profiler: wall {wall * 1e3:.1f} ms, device "
          f"{device_ms:.1f} ms (busy {device_ms / (wall * 1e3):.3f} of the "
          f"profiled wall, {device_ms / (min(walls16) * 1e3):.3f} of the "
          f"fastest unprofiled wall), K1 {k1_ms:.1f} ms; cudaLaunchKernel "
          f"x{n_launch}, {launch_ms:.1f} ms host ({card_line}); table in "
          f"{os.path.relpath(PROFILE_TABLE, ROOT)}", flush=True)
    if device_ms <= 0 or k1_ms <= 0:
        raise RuntimeError("the profiler saw no device time for the render")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also measure where the render's time goes")
    args = ap.parse_args()
    phase("environment")
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the smoke run needs a GPU")
    card_line = card()
    print(card_line, flush=True)
    sys.path.insert(0, ROOT)
    from tungsten_tpu_torch import render as trender
    from tungsten_tpu_torch.io.image import read_pfm
    from tungsten_tpu_torch.kernels import noise3d
    from tungsten_tpu_torch.scene.parse import load_scene
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build K1")
    t0 = time.perf_counter()
    log = noise3d.build()
    print(f"built {os.path.relpath(noise3d.SOURCE, ROOT)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    phase("K1 against its plain twin")
    scene, _ = load_scene(SCENE, device=dev)
    cov = scene.media[0].gp.cov
    m6 = cov.splat_form().tolist() + [0.0, 0.0, 0.0]
    kr = float(cov.splat_radius())
    rs = np.random.default_rng(0)
    p = torch.from_numpy(rs.uniform(-3.0, 3.0, (TWIN_POINTS, 3)).astype(
        np.float32)).to(dev)
    seed = torch.from_numpy(rs.integers(0, 2 ** 32, TWIN_POINTS,
                                        dtype=np.uint64).astype(np.int64)
                            ).to(dev)
    max_err = 0.0
    for K in (1, 3):
        got = noise3d.noise3d_sum_s(p, seed, kr, m6, K)
        want = noise3d.noise3d_sum_s_ref(p, seed, kr, m6, K)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("K1 returned non-finite values")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        print(f"K={K}: {TWIN_POINTS} points, max |kernel - twin| = {err:.3e}"
              f" (atol {K1_ATOL})", flush=True)
        if err > K1_ATOL:
            raise RuntimeError(f"K1 disagrees with its twin: {err}")
    K = scene.media[0].cfg.impulse_count
    times = {}
    for n in (16384, 65536, 131072, TWIN_POINTS):
        pk, sk = p[:n].contiguous(), seed[:n].contiguous()
        got = noise3d.noise3d_sum_s(pk, sk, kr, m6, K)
        want = noise3d.noise3d_sum_s_ref(pk, sk, kr, m6, K)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if err > K1_ATOL:
            raise RuntimeError(f"K1 disagrees with its twin at N={n}: {err}")
        t_k = median_ms(lambda: noise3d.noise3d_sum_s(pk, sk, kr, m6, K))
        t_p = median_ms(lambda: noise3d.noise3d_sum_s_ref(pk, sk, kr, m6, K))
        times[n] = (t_k, t_p)
        print(f"K={K} N={n}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms "
              f"(median of 20, CUDA events; {card_line})", flush=True)

    phase("render config 1 (128x128, 4 spp) through the CLI")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sphere-box.png")
        noise3d.LAUNCHES = 0
        t0 = time.perf_counter()
        trender.main([SCENE, "--spp", "4", "-o", out, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = noise3d.LAUNCHES
        img = read_pfm(os.path.splitext(out)[0] + ".pfm")
        if not os.path.getsize(out):
            raise RuntimeError("the render wrote an empty PNG")
    lum = float((0.2126 * img[..., 0] + 0.7152 * img[..., 1]
                 + 0.0722 * img[..., 2]).mean())
    print(f"image {img.shape}, finite {bool(np.isfinite(img).all())}, mean "
          f"luminance {lum:.4f}, K1 launches {launches}, {wall:.2f} s "
          "(with scene load and first-use set-up)", flush=True)
    if img.shape != (128, 128, 3) or not np.isfinite(img).all():
        raise RuntimeError("the render is not a finite 128x128 image")
    if lum <= 0.01:
        raise RuntimeError(f"the render is black: mean luminance {lum}")
    if launches <= 0:
        raise RuntimeError("the render never launched K1")

    phase("timing run (128x128, 16 spp)")
    scene128, _ = load_scene(SCENE, res_override=(128, 128), device=dev)
    before = noise3d.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film = trender.render(scene128, 16, device=dev)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    print(f"16 spp in {el:.3f} s: {128 * 128 * 16 / el / 1e3:.2f} Ksamples/s,"
          f" {noise3d.LAUNCHES - before} K1 launches ({card_line})",
          flush=True)
    if not bool(torch.isfinite(film).all()):
        raise RuntimeError("the timing render is not finite")

    phase("64x64, 48 spp against the reference golden")
    scene64, _ = load_scene(SCENE, res_override=(64, 64), device=dev)
    ours = (trender.render(scene64, 48, device=dev) / 48).cpu().numpy()
    ratio, frac_bad = golden_bucket_test(ours, read_pfm(GOLDEN), 48)
    print(f"energy ratio {ratio:.4f} (0.9-1.1), frac_bad {frac_bad:.4f} "
          "(< 0.08)", flush=True)
    if not (0.9 < ratio < 1.1 and frac_bad < 0.08):
        raise RuntimeError("the golden bucket test failed")

    if args.profile:
        phase("profile (128x128; 1, 4, 16 spp per ray batch)")
        profile(trender, noise3d, scene128, dev, card_line)

    if "jax" in sys.modules or "tungsten_tpu" in sys.modules:
        raise RuntimeError("the port imported jax or the JAX package")
    t_k, t_p = times[65536]
    print(json.dumps({"kernels": [{
        "name": "K1 noise3d_sum_s", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/noise3d.cu",
        "replaces": "tungsten_tpu/ops/sparse_conv_pallas.py:144",
        "launches": launches, "max_abs_err": max_err, "ms": t_k,
        "plain_ms": t_p}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
