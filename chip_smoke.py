"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Builds the port's CUDA kernels from tungsten_tpu_torch/csrc/ (one nvcc per
source, all started together) and holds each against its plain PyTorch
twin on the card: K1 and K2 (noise3d.cu), K3 (noise1d.cu) and K5/K4
(ws_trace.cu).  Then it drives the port's main paths through
tungsten_tpu_torch.render, each with the launch counts set to 0 just
before and read just after:
- BASELINE config 1 (scenes/gpis-sphere-box.json, sparse-conv noise, K1);
- BASELINE config 4a (scenes/gpis-weight-space.json, weight-space RFF,
  1024 basis functions, K5's fixed-step march);
- config 4a with step_size 0 (K4's range-bound sphere trace);
- BASELINE configs 3 and 3b (scenes/gpis-mirror-1d{,-corrxy}.json, 1D
  sparse-conv sampling with renewal+ conditioning and mirror NEE/MIS, K3);
- BASELINE config 5, the hero (scenes/gpis-hero.json, multi-resolution
  procedural-nonstationary noise under the Global context, K2), at its own
  1920x1080 in row bands.
It checks each image, times the renders, and compares 64x64 renders with
the committed reference goldens by bucket means.  Each phase that fails
raises, so the script exits non-zero; it needs CUDA and never imports JAX
or the JAX package.  It prints the card line of nvidia-smi, then a JSON
line with every kernel's numbers, and last one JSON object naming the
device.

`python3 chip_smoke.py --profile` adds phases that measure where the
renders' time goes (PERF.md section 5): config 1 at 1, 4 and 16 spp per ray
batch, config 4a (both step sizes) at 8 spp, config 3 and the hero at 16
spp, each with its launches and host syncs, and one render of each under
torch.profiler, whose op tables it writes to chiprun_out/.
"""
import argparse
import concurrent.futures
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
WS_SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
WS_GOLDEN = os.path.join(ROOT, "goldens", "gpis-weight-space.pfm")
M1D_SCENES = {name: (os.path.join(ROOT, "scenes", f"gpis-{stem}.json"),
                     os.path.join(ROOT, "goldens", f"gpis-{stem}.pfm"))
              for name, stem in (("config 3", "mirror-1d"),
                                 ("config 3b", "mirror-1d-corrxy"))}
HERO_SCENE = os.path.join(ROOT, "scenes", "gpis-hero.json")
HERO_GOLDEN = os.path.join(ROOT, "goldens", "gpis-hero.pfm")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
K1_ATOL = 1e-5  # raw sum of at most 81 unit-bounded terms, fp32
TWIN_POINTS = 1 << 20
K1_MAIN_POINTS = 1 << 18  # config 1's 16-spp batch at 128x128
# Up to the most rays the render launches K5/K4 on: NEE's shadow batch
# doubles a batch of render.MAX_RAYS camera rays.  The kernels line gives
# the numbers at config 4a's 8-spp camera batch, WS_LINE_RAYS.
WS_RAYS = (16384, 65536, 131072, 262144, 524288)
WS_LINE_RAYS = 131072
WS_RTOL = 1e-5  # float columns within WS_RTOL * (1 + |twin|)
K3_ATOL = 1e-5  # raw sum of at most 9 unit-bounded terms, fp32
# Up to 2^20 points, past the most a render launches K3 on: the [2R] shadow
# batch of render.MAX_RAYS camera rays, 524,288.  The kernels line gives
# the numbers at config 3's 16-spp camera batch, K3_LINE_POINTS.
K3_POINTS = (16384, 65536, 131072, 262144, 524288, 1 << 20)
K3_LINE_POINTS = 262144
K2_ATOL = 1e-5  # raw sum of at most 81 unit-bounded terms, fp32
# Up to 2^20 points: the hero's 1080p bands hold 136 x 1920 = 261,120 rays,
# the march sends both levels of each ray in one launch ([2R]) and the
# shadow walk doubles that ([4R] = 1,044,480).  The kernels line gives the
# numbers at the camera march's launch, K2_LINE_POINTS.
K2_POINTS = (16384, 65536, 131072, 262144, 524288, 1 << 20)
K2_LINE_POINTS = 524288
WS_MAX_SHARE = 1e-3  # rays whose flags or decisions may differ

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores; 32-bit integer work
# is counted at the same instruction rate.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# Operation counts behind the bounds, read off the kernels' code.  K1, per
# cell: xxhash32_4 (27 ops) + 6 index/offset ops; per impulse: 4 xxhash32_2
# (15 ops each), 4 variates (3 each) and the splat (48, expf included).
K1_OPS_CELL, K1_OPS_IMPULSE = 33, 4 * 15 + 4 * 3 + 48
# A precise cosf: 3-part Cody-Waite reduction and a polynomial, ~20 ops;
# an IEEE divide ~10.
OPS_COSF, OPS_DIV = 20, 10
# K2: K1's sum plus a per-point reciprocal (1 / kr) and one qm multiply
# per impulse
K2_OPS_POINT, K2_OPS_IMPULSE = OPS_DIV, K1_OPS_IMPULSE + 1
# K5 per basis function and step: phase (2), cosf, amp * cos and the sum (2)
K5_OPS = 4 + OPS_COSF
# K3, per cell: xxhash32_2 (15 ops) + 6 coordinate/index ops; per impulse:
# 2 xxhash32_2 (15 each), 2 variates (3 each), the sign select, d, kr * d,
# d * d and its compare, the splat's products and sum (8) and a precise
# expf (~20)
K3_OPS_CELL, K3_OPS_IMPULSE = 21, 2 * 15 + 2 * 3 + 8 + 20
# K4 per basis function and iteration: 2 phases (4), 2 cosf, 4 divides,
# 4 floors, 2 subtracts, min/max and selects (10), 2 products, 2 min/max
# and 2 sums
K4_OPS = 4 + 2 * OPS_COSF + 4 * OPS_DIV + 4 + 2 + 10 + 6


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


def kernel_device_ms(fn, kernel, reps=20):
    """Mean device time of the CUDA kernel named `kernel` per call of fn(),
    from torch.profiler over `reps` calls after one warm-up: the kernel
    alone, without the host work and gaps a CUDA-event window around a
    short launch also holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    if us <= 0:
        raise RuntimeError(f"the profiler saw no device time for {kernel}")
    return us / reps / 1e3


def bound_ms(n_bytes, n_ops):
    """(least time in ms for the bytes and operations, what bounds it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def ws_doc(step_size=None, res=None):
    """Config 4a's scene dict, optionally with another step_size or
    resolution."""
    with open(WS_SCENE) as f:
        doc = json.load(f)
    if step_size is not None:
        doc["media"][0]["step_size"] = step_size
    if res is not None:
        doc["camera"]["resolution"] = list(res)
    return doc


def ws_rays(med, R, seed, dev):
    """R rays of config 4a inside its bounding cube, made from a numpy seed:
    origins around the GPIS sphere, random directions and (pixel, sample,
    bounce) words, the march interval clamped to the cube as the medium
    clamps it; a third of the rays start after an interior scatter."""
    from tungsten_tpu_torch.models import media as md
    r = np.random.default_rng(seed)
    center = np.array([0.0, 0.9, 0.0], np.float32)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    ro = (center + u * r.uniform(0.0, 0.7, (R, 1))).astype(np.float32)
    rd = r.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    pss = r.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(np.int64)
    uj = r.uniform(size=R).astype(np.float32)
    ro, rd, pss, uj = (torch.from_numpy(x).to(dev) for x in (ro, rd, pss, uj))
    near = torch.zeros(R, device=dev)
    far = md._far_eff(med, ro, rd, near, torch.full((R,), 3e38, device=dev))
    step = torch.clamp(torch.minimum(med.step_size, (far - near)
                                     / med.min_step), min=1e-6)
    absorb = torch.arange(R, device=dev) % 3 == 0
    return md._ws_real(med, pss), ro, rd, near, far, step, uj, absorb


def ws_kernel_checks(wst, med, dev, card_line):
    """K5 and K4 against their twins at WS_RAYS rays x 1024 basis functions,
    chunk after chunk until every ray is done.  Returns {kernel: numbers at
    WS_LINE_RAYS} for the kernels line."""
    flag_cols = {"K5": [wst.M_DONE, wst.M_CROSS, wst.M_SIGN],
                 "K4": [wst.C_DONE, wst.C_HIT, wst.C_SIGN]}
    out = {}
    for name in ("K5", "K4"):
        max_err = 0.0
        for R in WS_RAYS:
            real, ro, rd, near, far, step, uj, absorb = ws_rays(med, R, R,
                                                                dev)
            if name == "K5":
                h, aux, S0, params = wst.march_inputs(
                    real, med.gp, ro, rd, near, far, step, uj, absorb)
                kern, twin = wst.march_chunk, wst.march_chunk_ref
            else:
                h, aux, S0, params = wst.trace_inputs(real, med.gp, ro, rd,
                                                      near, far)
                kern, twin = wst.trace_chunk, wst.trace_chunk_ref
            del real
            n = h.a.shape[1]
            # as many chunks as the batch functions allow at most
            limit = -(-(8192 if name == "K5" else 256)
                      // (wst.MARCH_CHUNK if name == "K5" else wst.TRACE_CHUNK))
            S, chunks, n_bad = S0, 0, 0
            while (chunks < limit
                   and bool((S[:, flag_cols[name][0]] < 0.5).any())):
                got = kern(h.a, h.slope, h.amp, aux, S, params, h.spherical)
                want = twin(h.a, h.slope, h.amp, aux, S, params,
                            h.spherical)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"{name} returned non-finite state")
                err = (got - want).abs()
                off = (err > WS_RTOL * (1.0 + want.abs())).any(dim=1)
                flags = (got[:, flag_cols[name]]
                         != want[:, flag_cols[name]]).any(dim=1)
                bad = off | flags
                n_bad += int(bad.sum())
                if bool((~bad).any()):
                    max_err = max(max_err, float(err[~bad].max()))
                S, chunks = got, chunks + 1
            share = n_bad / R
            done = float((S[:, flag_cols[name][1]] > 0.5).float().mean())
            print(f"{name} R={R} n={n}: {chunks} chunks until done, "
                  f"{100 * done:.2f}% of rays hit; rays whose flags or "
                  f"decisions differ {n_bad} ({share:.2e}, limit "
                  f"{WS_MAX_SHARE}); max |kernel - twin| on the others "
                  f"{max_err:.3e} (limit {WS_RTOL}*(1+|x|))", flush=True)
            if share > WS_MAX_SHARE:
                raise RuntimeError(f"{name} disagrees with its twin on "
                                   f"{n_bad} of {R} rays")
            t_k = median_ms(lambda: kern(h.a, h.slope, h.amp, aux, S0,
                                         params, h.spherical))
            t_p = median_ms(lambda: twin(h.a, h.slope, h.amp, aux, S0,
                                         params, h.spherical))
            S1 = kern(h.a, h.slope, h.amp, aux, S0, params, h.spherical)
            if name == "K5":
                # steps evaluated: the advances, plus the step that ended a
                # ray; basis rows are read for rays that step at all
                steps = (S1[:, wst.M_K] - S0[:, wst.M_K]
                         + (S1[:, wst.M_DONE] > S0[:, wst.M_DONE]).float())
                ops_per = K5_OPS
            else:
                steps = S1[:, wst.C_IT] - S0[:, wst.C_IT]
                ops_per = K4_OPS
            n_steps = float(steps.sum())
            n_bytes = (12 * n * float((steps > 0).sum()) + 3 * 32 * R + 32)
            b_ms, b_by = bound_ms(n_bytes, n_steps * n * ops_per)
            print(f"{name} R={R}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms per "
                  f"chunk from the start state (median of 20, CUDA events;"
                  f" {card_line}); {n_steps:.0f} ray-steps, bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            if R == WS_LINE_RAYS:
                out[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                             "bound_by": b_by}
            del h, aux, S0, S, S1
            torch.cuda.empty_cache()
        out[name]["max_abs_err"] = max_err
    return out


def record_rays(wst):
    """Wrap K5's and K4's wrappers, as the medium calls them, so that the
    renders record the most rays each kernel was launched on; returns that
    record, {"K5": R, "K4": R}."""
    most = {"K5": 0, "K4": 0}
    for name, attr in (("K5", "march_chunk"), ("K4", "trace_chunk")):
        def wrapped(a, *rest, _fn=getattr(wst, attr), _name=name):
            most[_name] = max(most[_name], a.shape[0])
            return _fn(a, *rest)
        setattr(wst, attr, wrapped)
    return most


def check_rays(most, name):
    """The kernel's largest launch in a render lies within the rays it was
    checked on."""
    print(f"{name}: at most {most[name]} rays per launch in this render "
          f"(checked against its twin up to {max(WS_RAYS)})", flush=True)
    if most[name] > max(WS_RAYS):
        raise RuntimeError(f"the render launched {name} on {most[name]} rays,"
                           f" more than the twin check covers")


def render_cli(trender, scene_path, spp, tmp, name):
    """Render through the CLI at the scene's own resolution; returns
    (image, wall seconds, peak device bytes)."""
    out = os.path.join(tmp, name + ".png")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trender.main([scene_path, "--spp", str(spp), "-o", out, "--device",
                  "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from tungsten_tpu_torch.io.image import read_pfm
    if not os.path.getsize(out):
        raise RuntimeError("the render wrote an empty PNG")
    return (read_pfm(os.path.splitext(out)[0] + ".pfm"), wall,
            torch.cuda.max_memory_allocated())


def check_image(img, what, shape=(128, 128, 3)):
    lum = float((0.2126 * img[..., 0] + 0.7152 * img[..., 1]
                 + 0.0722 * img[..., 2]).mean())
    if img.shape != shape or not np.isfinite(img).all():
        raise RuntimeError(f"{what} is not a finite {shape[1]}x{shape[0]} "
                           "image")
    if lum <= 0.01:
        raise RuntimeError(f"{what} is black: mean luminance {lum}")
    return lum


def k3_checks(noise1d, dev, card_line):
    """K3 against its twin at K3_POINTS random iso-ray coordinates (both
    signs, many cells) and seeds; returns (max |diff|, {N: (kernel device
    ms, twin ms, bound ms, bound_by)}).  The seeds are int32 words, as
    the march passes them."""
    rs = np.random.default_rng(3)
    n_max = max(K3_POINTS)
    pz = torch.from_numpy(rs.uniform(-40.0, 40.0, n_max).astype(
        np.float32)).to(dev)
    seed = torch.from_numpy(rs.integers(0, 2 ** 32, n_max, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    kr, K = 3.0, 3
    err_max, times = 0.0, {}
    for n in K3_POINTS:
        pk, sk = pz[:n].contiguous(), seed[:n].contiguous()
        got = noise1d.noise1d_sum(pk, sk, kr, K)
        want = noise1d.noise1d_sum_ref(pk, sk, kr, K)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("K3 returned non-finite values")
        err = float((got - want).abs().max())
        err_max = max(err_max, err)
        if err > K3_ATOL:
            raise RuntimeError(f"K3 disagrees with its twin at N={n}: {err}")
        t_w = median_ms(lambda: noise1d.noise1d_sum(pk, sk, kr, K))
        t_k = kernel_device_ms(lambda: noise1d.noise1d_sum(pk, sk, kr, K),
                               "noise1d_sum_kernel")
        t_p = median_ms(lambda: noise1d.noise1d_sum_ref(pk, sk, kr, K))
        b_ms, b_by = bound_ms(12 * n, n * 3 * (K3_OPS_CELL
                                                + K * K3_OPS_IMPULSE))
        times[n] = (t_k, t_p, b_ms, b_by)
        print(f"K3 K={K} N={n}: max |kernel - twin| = {err:.3e} (atol "
              f"{K3_ATOL}); kernel {t_k:.4f} ms of device time (mean of 20, "
              f"torch.profiler), wrapper call {t_w:.4f} ms and twin "
              f"{t_p:.4f} ms (median of 20, CUDA events; {card_line}); "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return err_max, times


def check_k3_points(noise1d, what):
    """The render's largest K3 launch lies within the points K3 was
    checked on."""
    print(f"{what}: K3 launched on at most {noise1d.MOST_POINTS} points "
          f"(checked against its twin up to {max(K3_POINTS)})", flush=True)
    if noise1d.MOST_POINTS > max(K3_POINTS):
        raise RuntimeError(f"{what} launched K3 on {noise1d.MOST_POINTS} "
                           "points, more than the twin check covers")


def k2_inputs(base, n, dev):
    """n points in the hero's bounding cube with per-point levels drawn as
    the hero draws them: s = 2.5^l for l in -1..2 (0.4, 1, 2.5, 6.25),
    kr = kr_unit * s, qm = 1 / s^2, and seeds offset by the level with
    uint32 wrap (a quarter of them from words just below 2^32, a quarter
    from 0)."""
    r = np.random.default_rng(5)
    p = (np.array([0.0, 0.9, 0.0]) + r.uniform(-0.75, 0.75, (n, 3))
         ).astype(np.float32)
    lvl = r.integers(-1, 3, n)
    s = np.float32(2.5) ** lvl.astype(np.float32)
    word = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64)
    word[: n // 4] = 2 ** 32 - 1 - r.integers(0, 2, n // 4)
    word[n // 4: n // 2] = 0
    seed = (word + lvl) % 2 ** 32
    kr = np.float32(float(base.splat_radius())) * s
    qm = np.float32(1.0) / (s * s)
    return tuple(torch.from_numpy(x).to(dev) for x in (p, seed, kr, qm))


def k2_checks(noise3d, base, dev, card_line):
    """K2 against its twin at K2_POINTS points (K = 1 and 3); returns
    (max |diff|, {N: (kernel device ms, twin ms, bound ms, bound_by)} at
    the hero's K = 3)."""
    m6 = base.splat_form().tolist() + [0.0, 0.0, 0.0]
    p, seed, kr, qm = k2_inputs(base, max(K2_POINTS), dev)
    err_max, times = 0.0, {}
    for n in K2_POINTS:
        args = (p[:n], seed[:n], kr[:n], qm[:n], m6)
        for K in (1, 3):
            got = noise3d.noise3d_sum(*args, K)
            want = noise3d.noise3d_sum_ref(*args, K)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError("K2 returned non-finite values")
            err = float((got - want).abs().max())
            err_max = max(err_max, err)
            print(f"K2 K={K} N={n}: max |kernel - twin| = {err:.3e} (atol "
                  f"{K2_ATOL})", flush=True)
            if err > K2_ATOL:
                raise RuntimeError(f"K2 disagrees with its twin at N={n}, "
                                   f"K={K}: {err}")
        K = 3
        t_w = median_ms(lambda: noise3d.noise3d_sum(*args, K))
        t_k = kernel_device_ms(lambda: noise3d.noise3d_sum(*args, K),
                               "noise3d_sum_kernel")
        t_p = median_ms(lambda: noise3d.noise3d_sum_ref(*args, K))
        b_ms, b_by = bound_ms(28 * n, n * (K2_OPS_POINT + 27 * (
            K1_OPS_CELL + K * K2_OPS_IMPULSE)))
        times[n] = (t_k, t_p, b_ms, b_by)
        print(f"K2 K={K} N={n}: kernel {t_k:.4f} ms of device time (mean of "
              f"20, torch.profiler), wrapper call {t_w:.4f} ms and twin "
              f"{t_p:.4f} ms (median of 20, CUDA events; {card_line}); "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return err_max, times


def check_k2_points(noise3d, what):
    """The render's largest K2 launch lies within the points K2 was
    checked on."""
    print(f"{what}: K2 launched on at most {noise3d.K2_MOST_POINTS} points "
          f"(checked against its twin up to {max(K2_POINTS)})", flush=True)
    if noise3d.K2_MOST_POINTS > max(K2_POINTS):
        raise RuntimeError(f"{what} launched K2 on {noise3d.K2_MOST_POINTS} "
                           "points, more than the twin check covers")


def profile_table(prof, name):
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=60))
    return os.path.relpath(path, ROOT)


def profile(trender, noise3d, wst, scene, ws_scene, ws_trace_scene, dev,
            card_line):
    """Where the 128x128 renders' time goes; see the module docstring."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def device_ms(events, match=None):
        """Device time of the kernels (a profiler range's span on the
        device timeline is left out)."""
        return sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and (match is None or match in e.key)) / 1e3

    def launches(events):
        ev = [e for e in events if e.key.startswith("cudaLaunchKernel")]
        return sum(e.count for e in ev), sum(e.cpu_time_total
                                             for e in ev) / 1e3

    walls16 = []
    for spp in (1, 4, 16):
        walls, counts = [], []
        for _ in range(2):
            noise3d.LAUNCHES = 0
            walls.append(timed(lambda: trender.render(scene, spp, device=dev)))
            counts.append(noise3d.LAUNCHES)
        syncs = host_syncs(lambda: trender.render(scene, spp, device=dev))
        if syncs == 0:
            raise RuntimeError("set_sync_debug_mode reported no host sync")
        rates = ", ".join(f"{128 * 128 * spp / w / 1e3:.2f}" for w in walls)
        print(f"config 1, {spp} spp in one batch: {walls[0]:.4f} s, "
              f"{walls[1]:.4f} s ({rates} Ksamples/s); K1 launches {counts};"
              f" host syncs {syncs} ({card_line})", flush=True)
        if spp == 16:
            walls16 = walls
    fn, points = noise3d.noise3d_sum_s, [0]

    def counted(p, *rest):
        points[0] += p.shape[0]
        return fn(p, *rest)

    noise3d.noise3d_sum_s = counted
    try:
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: trender.render(scene, 16, device=dev))
    finally:
        noise3d.noise3d_sum_s = fn
    events = prof.key_averages()
    dev_ms, k1_ms = device_ms(events), device_ms(events,
                                                 "noise3d_sum_s_kernel")
    b_ms, b_by = bound_ms(20 * points[0], points[0] * 27 * (
        K1_OPS_CELL + 3 * K1_OPS_IMPULSE))
    n_launch, launch_ms = launches(events)
    table = profile_table(prof, "profile_16spp.txt")
    print(f"config 1, 16 spp under torch.profiler: wall {wall * 1e3:.1f} ms,"
          f" device {dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f} of the "
          f"profiled wall, {dev_ms / (min(walls16) * 1e3):.3f} of the "
          f"fastest unprofiled wall), K1 {k1_ms:.1f} ms on {points[0]} "
          f"points, bound {b_ms:.3f} ms ({b_by}); cudaLaunchKernel "
          f"x{n_launch}, {launch_ms:.1f} ms host ({card_line}); table in "
          f"{table}", flush=True)
    if dev_ms <= 0 or k1_ms <= 0:
        raise RuntimeError("the profiler saw no device time for config 1")

    for what, sc, kernel, counter in (
            ("config 4a", ws_scene, "ws_march_kernel", "MARCH_LAUNCHES"),
            ("config 4a, step_size 0", ws_trace_scene, "ws_trace_kernel",
             "TRACE_LAUNCHES")):
        walls, counts = [], []
        for _ in range(2):
            setattr(wst, counter, 0)
            walls.append(timed(lambda: trender.render(sc, 8, device=dev)))
            counts.append(getattr(wst, counter))
        syncs = host_syncs(lambda: trender.render(sc, 8, device=dev))
        rates = ", ".join(f"{128 * 128 * 8 / w / 1e3:.2f}" for w in walls)
        print(f"{what}, 8 spp in one batch: {walls[0]:.4f} s, "
              f"{walls[1]:.4f} s ({rates} Ksamples/s); {kernel} launches "
              f"{counts}; host syncs {syncs} ({card_line})", flush=True)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: trender.render(sc, 8, device=dev))
        events = prof.key_averages()
        dev_ms, k_ms = device_ms(events), device_ms(events, kernel)
        # the kernels launched inside media._ws_real's profiler range
        synth = [e for e in events if e.key == "ws_realization"
                 and e.device_type == DeviceType.CPU]
        synth_ms = sum(e.device_time_total for e in synth) / 1e3
        n_launch, launch_ms = launches(events)
        table = profile_table(prof, "profile_ws_8spp.txt"
                              if kernel == "ws_march_kernel"
                              else "profile_ws_trace_8spp.txt")
        print(f"{what}, 8 spp under torch.profiler: wall {wall * 1e3:.1f} "
              f"ms, device {dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f} "
              f"of the profiled wall, {dev_ms / (min(walls) * 1e3):.3f} of "
              f"the fastest unprofiled wall), {kernel} {k_ms:.1f} ms, "
              f"realization synthesis {synth_ms:.1f} ms ("
              f"{synth_ms / dev_ms:.3f} of device time, "
              f"{sum(e.count for e in synth)} calls); cudaLaunchKernel "
              f"x{n_launch}, {launch_ms:.1f} ms host ({card_line}); table in "
              f"{table}", flush=True)
        if dev_ms <= 0 or k_ms <= 0 or synth_ms <= 0:
            raise RuntimeError(f"the profiler saw no device time for {what}")


def profile_render(trender, what, scene, spp, mod, counter, kernel, label,
                   table_name, dev, card_line, wrapper, bytes_pt, ops_pt):
    """Where a 128x128 render spends its time: walls and launches of the
    kernel (counted by mod.<counter>) of two runs, host syncs of a third,
    and one run under torch.profiler (op table in chiprun_out/), with the
    kernel's bound over that run: the points its wrapper mod.<wrapper> was
    called on, at bytes_pt bytes and ops_pt operations each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    walls, counts = [], []
    for _ in range(2):
        setattr(mod, counter, 0)
        walls.append(timed(lambda: trender.render(scene, spp, device=dev)))
        counts.append(getattr(mod, counter))
    syncs = host_syncs(lambda: trender.render(scene, spp, device=dev))
    rates = ", ".join(f"{128 * 128 * spp / w / 1e3:.2f}" for w in walls)
    print(f"{what}, {spp} spp in one batch: {walls[0]:.4f} s, {walls[1]:.4f} "
          f"s ({rates} Ksamples/s); {label} launches {counts}; host syncs "
          f"{syncs} ({card_line})", flush=True)
    setattr(mod, counter, 0)
    fn, points = getattr(mod, wrapper), [0]

    def counted(x, *rest):
        points[0] += x.shape[0]
        return fn(x, *rest)

    setattr(mod, wrapper, counted)
    try:
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: trender.render(scene, spp, device=dev))
    finally:
        setattr(mod, wrapper, fn)
    n_k = getattr(mod, counter)
    b_ms, b_by = bound_ms(points[0] * bytes_pt, points[0] * ops_pt)
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    k_ms = sum(e.self_device_time_total for e in kern
               if kernel in e.key) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    launch = [e for e in events if e.key.startswith("cudaLaunchKernel")]
    n_launch = sum(e.count for e in launch)
    table = profile_table(prof, table_name)
    print(f"{what}, {spp} spp under torch.profiler: wall {wall * 1e3:.1f} ms,"
          f" device {dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f} of the"
          f" profiled wall, {dev_ms / (min(walls) * 1e3):.3f} of the fastest"
          f" unprofiled wall), {label} {k_ms:.1f} ms over {n_k} launches "
          f"({k_ms / max(n_k, 1):.4f} ms each, {k_ms / max(dev_ms, 1e-9):.3f}"
          f" of device time) on {points[0]} points, bound {b_ms:.3f} ms "
          f"({b_by}); cudaLaunchKernel x{n_launch} "
          f"({n_launch / max(n_k, 1):.1f} per {label} launch), "
          f"{sum(e.cpu_time_total for e in launch) / 1e3:.1f} ms host "
          f"({card_line}); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in top)
          + f"; table in {table}", flush=True)
    if dev_ms <= 0 or k_ms <= 0:
        raise RuntimeError(f"the profiler saw no device time for {what}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also measure where the renders' time goes")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase("environment")
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the smoke run needs a GPU")
    card_line = card()
    print(card_line, flush=True)
    sys.path.insert(0, ROOT)
    from tungsten_tpu_torch import render as trender
    from tungsten_tpu_torch.io.image import read_pfm
    from tungsten_tpu_torch.kernels import noise1d, noise3d
    from tungsten_tpu_torch.kernels import ws_trace as wst
    from tungsten_tpu_torch.scene.parse import load_scene, scene_from_dict
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def done(t0):
        print(f"-- {time.perf_counter() - t0:.1f} s", flush=True)

    phase("build K1/K2, K3 and K5/K4, in parallel")
    t0 = time.perf_counter()

    def build(mod):
        t = time.perf_counter()
        return mod.build(), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = {mod: pool.submit(build, mod)
                for mod in (noise3d, noise1d, wst)}
    for mod, job in jobs.items():
        log, secs = job.result()
        print(f"built {os.path.relpath(mod.SOURCE, ROOT)} for sm_90a in "
              f"{secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    done(t0)

    phase("K1 against its plain twin")
    t0 = time.perf_counter()
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
    k1_err = 0.0
    for K in (1, 3):
        got = noise3d.noise3d_sum_s(p, seed, kr, m6, K)
        want = noise3d.noise3d_sum_s_ref(p, seed, kr, m6, K)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("K1 returned non-finite values")
        err = float((got - want).abs().max())
        k1_err = max(k1_err, err)
        print(f"K={K}: {TWIN_POINTS} points, max |kernel - twin| = {err:.3e}"
              f" (atol {K1_ATOL})", flush=True)
        if err > K1_ATOL:
            raise RuntimeError(f"K1 disagrees with its twin: {err}")
    K = scene.media[0].cfg.impulse_count
    k1_times = {}
    for n in (16384, 65536, 131072, K1_MAIN_POINTS, TWIN_POINTS):
        pk, sk = p[:n].contiguous(), seed[:n].contiguous()
        got = noise3d.noise3d_sum_s(pk, sk, kr, m6, K)
        want = noise3d.noise3d_sum_s_ref(pk, sk, kr, m6, K)
        err = float((got - want).abs().max())
        k1_err = max(k1_err, err)
        if err > K1_ATOL:
            raise RuntimeError(f"K1 disagrees with its twin at N={n}: {err}")
        t_k = median_ms(lambda: noise3d.noise3d_sum_s(pk, sk, kr, m6, K))
        t_p = median_ms(lambda: noise3d.noise3d_sum_s_ref(pk, sk, kr, m6, K))
        b_ms, b_by = bound_ms(20 * n, n * 27 * (K1_OPS_CELL
                                                + K * K1_OPS_IMPULSE))
        k1_times[n] = (t_k, t_p, b_ms, b_by)
        print(f"K={K} N={n}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms "
              f"(median of 20, CUDA events; {card_line}); bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
    del p, seed
    done(t0)

    phase("K2 against its plain twin (the hero's levels)")
    t0 = time.perf_counter()
    hero_base = load_scene(HERO_SCENE, device=dev)[0].media[0].gp.cov.base
    k2_err, k2_times = k2_checks(noise3d, hero_base, dev, card_line)
    done(t0)

    phase("K3 against its plain twin")
    t0 = time.perf_counter()
    k3_err, k3_times = k3_checks(noise1d, dev, card_line)
    done(t0)

    phase("K5 and K4 against their plain twins (config 4a rays, n=1024)")
    t0 = time.perf_counter()
    ws_scene_full, _ = load_scene(WS_SCENE, device=dev)
    ws_numbers = ws_kernel_checks(wst, ws_scene_full.media[0], dev,
                                  card_line)
    done(t0)

    most_rays = record_rays(wst)
    with tempfile.TemporaryDirectory() as tmp:
        phase("config 1 (128x128, 4 spp) through the CLI")
        t0 = time.perf_counter()
        noise3d.LAUNCHES = 0
        img, wall, _ = render_cli(trender, SCENE, 4, tmp, "sphere-box")
        k1_launches = noise3d.LAUNCHES
        lum = check_image(img, "config 1")
        print(f"mean luminance {lum:.4f}, K1 launches {k1_launches}, "
              f"{wall:.2f} s (with scene load and first-use set-up)",
              flush=True)
        if k1_launches <= 0:
            raise RuntimeError("the config-1 render never launched K1")
        done(t0)

        phase("config 4a (128x128, 8 spp, 1024 basis functions) through "
              "the CLI")
        t0 = time.perf_counter()
        noise3d.LAUNCHES = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
        img, wall, peak = render_cli(trender, WS_SCENE, 8, tmp, "ws")
        k5_launches, k1_in_ws = wst.MARCH_LAUNCHES, noise3d.LAUNCHES
        lum = check_image(img, "config 4a")
        print(f"mean luminance {lum:.4f}, K5 launches {k5_launches}, K4 "
              f"launches {wst.TRACE_LAUNCHES}, K1 launches {k1_in_ws}; "
              f"{wall:.2f} s (with scene load), peak device memory "
              f"{peak / 2 ** 30:.2f} GiB ({card_line})", flush=True)
        if k5_launches <= 0 or k1_in_ws != 0:
            raise RuntimeError("the config-4a render did not go through K5 "
                               "alone")
        check_rays(most_rays, "K5")
        done(t0)

        phase("config 4a with step_size 0 (128x128, 8 spp) through the CLI")
        t0 = time.perf_counter()
        path = os.path.join(tmp, "ws-trace.json")
        with open(path, "w") as fh:
            json.dump(ws_doc(step_size=0.0), fh)
        noise3d.LAUNCHES = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
        img, wall, peak = render_cli(trender, path, 8, tmp, "ws-trace")
        k4_launches = wst.TRACE_LAUNCHES
        lum = check_image(img, "config 4a, step_size 0")
        print(f"mean luminance {lum:.4f}, K4 launches {k4_launches}, K5 "
              f"launches {wst.MARCH_LAUNCHES}, K1 launches "
              f"{noise3d.LAUNCHES}; {wall:.2f} s (with scene load), peak "
              f"device memory {peak / 2 ** 30:.2f} GiB", flush=True)
        if k4_launches <= 0 or wst.MARCH_LAUNCHES or noise3d.LAUNCHES:
            raise RuntimeError("the step_size-0 render did not go through "
                               "K4 alone")
        check_rays(most_rays, "K4")
        done(t0)

        m1d = {}
        for what, (path, _) in M1D_SCENES.items():
            phase(f"{what} (128x128, 16 spp) through the CLI")
            t0 = time.perf_counter()
            noise3d.LAUNCHES = noise1d.LAUNCHES = noise1d.MOST_POINTS = 0
            wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
            img, wall, peak = render_cli(trender, path, 16, tmp,
                                         os.path.basename(path)[:-5])
            m1d[what] = noise1d.LAUNCHES
            lum = check_image(img, what)
            print(f"mean luminance {lum:.4f}, K3 launches {noise1d.LAUNCHES}"
                  f", K1 launches {noise3d.LAUNCHES}; {wall:.2f} s with scene"
                  f" load ({128 * 128 * 16 / wall / 1e3:.2f} Ksamples/s), "
                  f"peak device memory {peak / 2 ** 30:.2f} GiB "
                  f"({card_line})", flush=True)
            if (noise1d.LAUNCHES <= 0 or noise3d.LAUNCHES
                    or wst.MARCH_LAUNCHES or wst.TRACE_LAUNCHES):
                raise RuntimeError(f"the {what} render did not go through "
                                   "K3 alone")
            check_k3_points(noise1d, what)
            done(t0)

        rows = trender.MAX_RAYS // 1920
        phase(f"config 5, the hero (1920x1080, 1 spp, bands of {rows} rows) "
              "through the CLI")
        t0 = time.perf_counter()
        noise3d.LAUNCHES = noise3d.K2_LAUNCHES = noise3d.K2_MOST_POINTS = 0
        noise1d.LAUNCHES = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
        img, wall, peak = render_cli(trender, HERO_SCENE, 1, tmp, "hero")
        k2_launches = noise3d.K2_LAUNCHES
        lum = check_image(img, "the hero", (1080, 1920, 3))
        print(f"{-(-1080 // rows)} bands; mean luminance {lum:.4f}, K2 "
              f"launches {k2_launches}, K1 launches {noise3d.LAUNCHES}, K3 "
              f"launches {noise1d.LAUNCHES}; {wall:.2f} s with scene load "
              f"({1920 * 1080 / wall / 1e3:.2f} Ksamples/s), peak device "
              f"memory {peak / 2 ** 30:.2f} GiB ({card_line})", flush=True)
        if (k2_launches <= 0 or noise3d.LAUNCHES or noise1d.LAUNCHES
                or wst.MARCH_LAUNCHES or wst.TRACE_LAUNCHES):
            raise RuntimeError("the hero render did not go through K2 alone")
        check_k2_points(noise3d, "the hero")
        done(t0)

    phase("timing runs (128x128)")
    t0 = time.perf_counter()
    noise1d.MOST_POINTS = 0
    scene128, _ = load_scene(SCENE, res_override=(128, 128), device=dev)
    ws128, _ = load_scene(WS_SCENE, res_override=(128, 128), device=dev)
    m1d128, _ = load_scene(M1D_SCENES["config 3"][0], device=dev)
    hero128, _ = load_scene(HERO_SCENE, res_override=(128, 128), device=dev)
    for what, sc, spp in (("config 1", scene128, 16), ("config 4a", ws128, 8),
                          ("config 3", m1d128, 16), ("config 5", hero128, 16)):
        film = None

        def run():
            nonlocal film
            film = trender.render(sc, spp, device=dev)

        el = timed(run)
        print(f"{what}, {spp} spp in {el:.3f} s: "
              f"{128 * 128 * spp / el / 1e3:.2f} Ksamples/s ({card_line})",
              flush=True)
        if not bool(torch.isfinite(film).all()):
            raise RuntimeError(f"the {what} timing render is not finite")
    done(t0)

    phase("64x64, 48 spp against the reference goldens")
    t0 = time.perf_counter()
    for what, sc, gold, gate in (
            ("config 1", load_scene(SCENE, res_override=(64, 64),
                                    device=dev)[0], GOLDEN, True),
            ("config 4a", load_scene(WS_SCENE, res_override=(64, 64),
                                     device=dev)[0], WS_GOLDEN, True),
            ("config 4a, step_size 0 (record only: the golden was "
             "rendered with the fixed-step march)",
             scene_from_dict(ws_doc(0.0, (64, 64)), device=dev)[0],
             WS_GOLDEN, False),
            *((what, load_scene(path, res_override=(64, 64), device=dev)[0],
               gold, True) for what, (path, gold) in M1D_SCENES.items()),
            ("config 5", load_scene(HERO_SCENE, res_override=(64, 64),
                                    device=dev)[0], HERO_GOLDEN, True)):
        ours = (trender.render(sc, 48, device=dev) / 48).cpu().numpy()
        ratio, frac_bad = golden_bucket_test(ours, read_pfm(gold), 48)
        print(f"{what}: energy ratio {ratio:.4f} (0.9-1.1), frac_bad "
              f"{frac_bad:.4f} (< 0.08)", flush=True)
        if gate and not (0.9 < ratio < 1.1 and frac_bad < 0.08):
            raise RuntimeError(f"the golden bucket test of {what} failed")
    for name in ("K5", "K4"):  # the timing and golden renders too
        check_rays(most_rays, name)
    check_k3_points(noise1d, "the timing and golden renders")
    check_k2_points(noise3d, "the timing and golden renders")
    done(t0)

    if args.profile:
        phase("profile (128x128)")
        t0 = time.perf_counter()
        profile(trender, noise3d, wst, scene128, ws128,
                scene_from_dict(ws_doc(0.0), device=dev)[0], dev, card_line)
        profile_render(trender, "config 3", m1d128, 16, noise1d, "LAUNCHES",
                       "noise1d_sum_kernel", "K3",
                       "profile_mirror1d_16spp.txt", dev, card_line,
                       "noise1d_sum", 12,
                       3 * (K3_OPS_CELL + 3 * K3_OPS_IMPULSE))
        profile_render(trender, "config 5", hero128, 16, noise3d,
                       "K2_LAUNCHES", "noise3d_sum_kernel", "K2",
                       "profile_hero_16spp.txt", dev, card_line,
                       "noise3d_sum", 28, K2_OPS_POINT + 27 * (
                           K1_OPS_CELL + 3 * K2_OPS_IMPULSE))
        check_k3_points(noise1d, "the profiled renders")
        check_k2_points(noise3d, "the profiled renders")
        done(t0)

    if "jax" in sys.modules or "tungsten_tpu" in sys.modules:
        raise RuntimeError("the port imported jax or the JAX package")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card_line, flush=True)
    t_k, t_p, b_ms, b_by = k1_times[K1_MAIN_POINTS]
    kernels = [{
        "name": "K1 noise3d_sum_s", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/noise3d.cu",
        "replaces": "tungsten_tpu/ops/sparse_conv_pallas.py:144",
        "launches": k1_launches, "max_abs_err": k1_err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    t_k, t_p, b_ms, b_by = k2_times[K2_LINE_POINTS]
    kernels.append({
        "name": "K2 noise3d_sum", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/noise3d.cu",
        "replaces": "tungsten_tpu/ops/sparse_conv_pallas.py:136",
        "launches": k2_launches, "max_abs_err": k2_err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    t_k, t_p, b_ms, b_by = k3_times[K3_LINE_POINTS]
    kernels.append({
        "name": "K3 noise1d_sum", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/noise1d.cu",
        "replaces": "tungsten_tpu/ops/sparse_conv_pallas.py:321",
        "launches": m1d["config 3"], "max_abs_err": k3_err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    for name, fn, line, n in (("K5", "ws_march_chunk", 169, k5_launches),
                              ("K4", "ws_trace_chunk", 45, k4_launches)):
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda",
            "source": "tungsten_tpu_torch/csrc/ws_trace.cu",
            "replaces": f"tungsten_tpu/ops/ws_trace_pallas.py:{line}",
            "launches": n, **ws_numbers[name], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
