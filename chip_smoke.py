"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Builds the port's CUDA kernels from tungsten_tpu_torch/csrc/ (one nvcc per
source, all started together) and holds each against its plain PyTorch
twin on the card: K1, K2 and their backwards K1b and K2b (noise3d.cu), K3
and its backward K3b (noise1d.cu), K5/K4 (ws_trace.cu, one whole
weight-space search per launch) and K8 (psd.cu, the function-space
medium's batched symmetric eigensolver: against torch.linalg.eigh on the
matrices a config-4b render of its own hands it and on 131,072 random 34x34
conditioning blocks, beside torch.linalg.eigh's own time and launches).
K1b and K3b sum the parameters'
partials over points inside the launch: their d/dp must equal the twin's
bit for bit, their sums the twin's within 1e-4, two launches on the same
inputs must agree bit for bit, a backward through autograd must be one
launch, and K1b is also run with more impulses within reach of a point
than its ring holds.  Each kernel's bound is the largest of its bytes over
HBM's rate and its instructions per pipe class over that class's rate
(K1, K1b, K2, K2b, K3 and K3b: counted from the built kernels' SASS, K1b's
along its split walk; K5/K4 and K8: operations read off the source, all
counted as issued, K8's float64 ones and its shared-memory bytes in classes
of their own); a measured time below its bound fails the run.  Then it
drives the port's main paths through tungsten_tpu_torch.render and
tungsten_tpu_torch.entry, each with the launch counts set to 0 just before
and read just after:
- BASELINE config 1 (scenes/gpis-sphere-box.json, sparse-conv noise, K1);
- BASELINE config 4a (scenes/gpis-weight-space.json, weight-space RFF,
  1024 basis functions, K5's fixed-step march);
- config 4a with step_size 0 (K4's range-bound sphere trace);
- BASELINE configs 3 and 3b (scenes/gpis-mirror-1d{,-corrxy}.json, 1D
  sparse-conv sampling with renewal+ conditioning and mirror NEE/MIS, K3);
- BASELINE config 5, the hero (scenes/gpis-hero.json, multi-resolution
  procedural-nonstationary noise under the Global context, K2), at its own
  1920x1080 in row bands;
- BASELINE config 2, the ensemble (scenes/gpis-ensemble.json, 3D sampling
  in isotropic-ray space, renewal+ conditioning of each path's 3D
  realization, K1), at its own 256x256, 16 spp through the CLI and at
  128x128, 16 spp with its launches, host syncs and peak memory;
- config 1's hyperparameter gradient: sample_distance's d sum(t) /
  d(sigma, l) on 32 rays against central FD and against the port on the
  CPU, then 2 inverse-rendering steps of tungsten_tpu_torch.entry's
  train_step at 128x128, 4 spp, depth 2 (K1 forward, K1b backward), each
  with its loss, parameters, gradient, wall, launches and host syncs;
- the hyperparameter gradient of configs 3 and 3b: config 3's
  sample_distance gradient on 48 rays against central FD and the CPU,
  then 2 training steps of config 3 and one of config 3b at 128x128,
  16 spp, depth 2 (K3 forward, K3b backward), each with its loss,
  gradient, wall, launches, host syncs and peak memory, and one step
  through the CLI (`python -m tungsten_tpu_torch.entry --scene
  scenes/gpis-mirror-1d.json --steps 1`);
- the hero's hyperparameter gradient (in the base covariance's sigma and
  l): sample_distance's gradient of a signed sum of t on 32 rays against
  central FD and the CPU, 2 training steps at 128x128, 16 spp, depth 2
  (K2 forward, K2b backward), each with its loss, gradient, wall,
  launches, host syncs and peak memory, and one step through the CLI at
  the hero's own 1920x1080, 1 spp, in 8 row bands;
- config 2's hyperparameter gradient: the two-segment d sum(t1 + t2) /
  d(sigma, l) on 32 rays (the second segment conditioned at its start)
  against central FD over the lanes FD resolves and against the CPU, and
  2 training steps at its own 256x256, depth 2, at 8 of its 16 spp (2
  groups of 4 samples; K1 forward, K1b backward);
- BASELINE config 4b (scenes/gpis-function-space.json) and its CSG union
  (scenes/gpis-csg.json), function space, renewal+, K8 alone: 128x128,
  8 spp through the CLI, then under torch.profiler with host syncs, peak
  memory, K8's device time split by n (one kernel instance per size) and
  the check that no cuSOLVER kernel and no torch.linalg.eigh ran;
- config 4a's hyperparameter gradient (K5/K4 search, the realization
  rebuilt in the graph): the medium-level gradient on 32 rays against
  central FD (K5; K4's printed) and, per lane with the card's crossing
  fed to the CPU's reattachment, the CPU, for both step sizes; the
  image-level check of tests/test_grad_e2e.py::test_image_grad_allclose_fd
  (24x24, 16 passes, isotropic phase, event-linear pixels) against
  central FD in sigma and l; 2 training steps at 128x128, 8 spp (K5) and
  one with step_size 0 (K4), each launching the kernel as often as the
  forward render.
- the distribution layer (parallel/mesh.py): the hero at its own
  1920x1080, 1 spp, sharded over two gloo ranks that share the card
  (parallel/launch.py spawns them after every library is built; each
  renders its 540 rows in bands and all-gathers the film), both films bit
  for bit the single-process CLI frame, K2 launched in each rank, each
  rank's render wall, peak memory and gather time printed; config 1 at
  128x128, 4 spp through render.render(sharded=True) in an NCCL group of
  one rank, bit for bit render.render; config 1's training step
  (128x128, 4 spp) sharded over two gloo ranks, twice, within 1e-5
  relative of entry.train_step and bit for bit the same over the runs,
  K1b launched in each rank;
- the render driver's options through the CLI on config 1 at 128x128:
  --checkpoint-interval 2 to 2 spp then --resume to 4 (within
  1e-6 (1 + |x|) of 4 uninterrupted), --aovs (four finite buffers, the
  image bit for bit the plain one) with --serve 0 (/status, /framebuffer)
  and --profile, -o *.exr (read back), --adaptive 4 on 8 spp (some pixels
  take the extra samples), --data-dump-pixel 64,64, and --sampler sobol at
  64x64, 48 spp against config 1's golden;
- the rest of the GP layer: K5 and K4 for the rational quadratic (a =
  1.5) and Matern (nu = 1.5) covariances (each a template instance with
  its own spectral draw) against their twins on 131,072 rays;
  config 4a with its covariance swapped for each, at 8 spp, through K5
  and, with step_size 0, through K4; config 4b with Matern nu = 2.5
  through K8 (its matrices against the twin); config 1 with a procedural
  knob mean, with a mesh mean baked from a sphere written at run time,
  with GGX normals and as a CSG union (the additional mean), each through
  K1; config 4a with a linear mean, which takes the plain weight-space
  fallback (no kernel, as in the JAX package).  Each 128x128 image is held
  by 8x8 bucket means against the port's own CPU render of the same scene
  at 32x32 and the same spp, rendered in spawned one-thread processes
  from the start of the run (this phase comes last);
- the rest of the GP layer's forward (tools/gp_variants.py, in the same
  phase): config 4b under the Global context (each ray's ring of 16
  conditioning rows), the None context (the constrained prior), with
  skip_space (its mean skipped length printed) and under Global
  conditioned on a sphere mesh, each through K8 alone, with host syncs,
  peak memory and K8's share of device time under torch.profiler; the
  hero at its own 1920x1080, 1 spp with brute-force nonstationary noise
  (K2 on the branch's own per-lane arguments, which a launch of the
  render hands it and which are held against the twin), isotropic-ray
  sampling (K1 on both levels), renewal+ conditioning (K2), 1D sampling
  (the multi-resolution general evaluator: no kernel, as in the JAX
  package) and surface/volume phase ids with GGX normals (K2); config 1
  with isotropic-ray sampling, with an anisoMtx there, with a mirror
  phase and with a mirror back wall (K1); config 3 under renewal and with
  an anisoMtx (K3).  Each image against the port's CPU render of the
  same scene at the same spp (the hero's at 48x27, 3x3 buckets); K8 at
  the new sizes (the Global ring's 16, on random conditioning blocks:
  under config 4b's one chunk a segment and depth 2 the ring's blocks
  are diagonal; the chunk's 32, on the matrices an fs-global render
  hands it) against its twin, timed at 4096 matrices beside its bound,
  its twin and torch.linalg.eigh.  The hero's five variants render at
  960x540 (HERO_VARIANT_RES), a cut of their depth;
- the gradient through the GP layer's types (ROADMAP 16c): K1b's and
  K2b's full-form instances (an anisoMtx in world space: all six
  partials of the splat form) against their twins on box-aniso's form
  and on the hero's base over it, up to 2^20 points, timed beside their
  SASS bounds; then for each variant of GRAD_VARIANTS (config 1's at
  128x128, 4 spp; config 3's at 16 spp; config 4a's at 8 spp; the hero's
  at 128x128, 16 spp; hero-aniso, the hero over box-aniso's anisoMtx) one
  step of entry.train_step with its loss, gradient, wall, launches, host
  syncs and peak memory (the backward launched at least once a recording
  sample_distance where the path has a lattice sum; box-aniso's and
  hero-aniso's first full-form launch held against the twin), and the
  medium-level gradient on the family's rays, per lane, against the
  port's CPU run of the same rays (spawned at the start of the run) and
  central FD on the lanes FD resolves; box-knob must be refused by name;
  then hero-bruteforce's gradient through the CLI at 1920x1080, 1 spp.
It checks each image, shows that every weight-space search was one launch
with no host sync inside, prints config 4a's host syncs, realization
synthesis and peak memory beside the earlier design's recorded numbers,
times the renders, and compares 64x64 renders with the committed
reference goldens by bucket means.  Each phase that fails
raises, so the script exits non-zero; it needs CUDA and never imports JAX
or the JAX package.  It prints the card line of nvidia-smi, then a JSON
line with every kernel's numbers, and last one JSON object naming the
device.

`python3 chip_smoke.py --profile` adds phases that measure where the
renders' time goes (PERF.md section 5): config 1 at 1, 4 and 16 spp per ray
batch, config 4a (both step sizes) at 8 spp, configs 3, 5 and 2 at 16
spp, each with its launches and host syncs, and one render of each under
torch.profiler, whose op tables it writes to OUT_DIR, with each kernel's
bound over that render; K5/K4 timed whole and in parts; and config 4a's
host syncs, realization synthesis and peak memory through the plain
twins, which keep the earlier design's [R, n] structure; and one
training step each of configs 1, 3, 5 and 2 (128x128, 16 spp) under
torch.profiler, with the bounds of their lattice kernel and its backward
over it, and of config 4a (both step sizes) with K5's or K4's.
"""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import shutil
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
ENS_SCENE = os.path.join(ROOT, "scenes", "gpis-ensemble.json")
ENS_GOLDEN = os.path.join(ROOT, "goldens", "gpis-ensemble.pfm")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
K1_ATOL = 1e-5  # raw sum of at most 81 unit-bounded terms, fp32
TWIN_POINTS = 1 << 20
K1_MAIN_POINTS = 1 << 18  # config 1's 16-spp batch at 128x128
# Up to the most rays the render launches K5/K4 on: NEE's shadow batch
# doubles a batch of render.MAX_RAYS camera rays.  The kernels line gives
# the numbers at config 4a's 8-spp camera batch, WS_LINE_RAYS.
WS_RAYS = (16384, 65536, 131072, 262144, 524288)
WS_LINE_RAYS = 131072
WS_RTOL = 1e-5  # t, value and gradient within WS_RTOL * (1 + |twin|)
# config 4a's peak device memory at 8 spp with [R, n] realizations
# (PERF.md): the one-launch search allocates none, so its renders must stay
# below it
WS_OLD_PEAK_GIB = 6.95
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
# K1b against its twin up to 2^20 points; the kernels line gives the numbers
# at the training step's launch (65,536 rays: config 1's 128x128 at 4 spp).
# dp bit-equal (K1B_DP_RTOL 0: the twin adds each point's terms in the
# kernel's order with its operations, and runs on the card); the sums over
# points of the parameters' partials (float64 in both, in other orders,
# each rounded once to float32) within K1B_SUM_ULPS float32 ulps:
# bit-equal, as two float64 sums a few float64 ulps apart round to one
# float32 unless they straddle a rounding boundary.  At each timed size
# the twin also sums in float32, a control of what the limit rejects: a
# kernel that added its partials in float32 (printed; its readings in
# PERF.md).  K1b and K3b are also checked untimed at ODD_POINTS (one
# point, under one block, not a multiple of a block) and with MANY_K
# impulses per cell (K1b: ~33.5 within reach of a point, more than its
# ring holds; K3b: its runtime-K kernel).
K1B_POINTS = (4096, 65536, 1 << 20)
ODD_POINTS = (1, 255, 4097)
MANY_K = 8
K1B_LINE_POINTS = 65536
K1B_DP_RTOL, K1B_SUM_ULPS = 0.0, 0
# K3b against its twin at K3_POINTS; the kernels line gives the numbers at
# config 3's 16-spp training batch (262,144 rays).  dpz bit-equal, d/dkr
# summed over points (float64 in both) within K3B_SUM_ULPS float32 ulps,
# with K1b's float32 control.
K3B_LINE_POINTS = 262144
K3B_DP_RTOL, K3B_SUM_ULPS = 0.0, 0
# K2b against its twin at K2_POINTS (K = 1 and 3); the kernels line gives the
# numbers at the hero step's [2R] launch (524,288 points: 128x128 at 16
# spp).  dp and the per-point partials in kr and qm within K2B_RTOL * (1 +
# |x|), the m partials' sums over points (in float64) within K2B_SUM_RTOL.
K2B_LINE_POINTS = 524288
K2B_RTOL, K2B_SUM_RTOL = 1e-5, 1e-4
# The medium-level gradient against central FD, with the limits of the JAX
# package's tests/test_grad_e2e.py::test_medium_level_grad_matches_fd and
# ::test_medium_level_grad_matches_fd_1d, and against the port on the CPU.
# Per scene, the rays of that test: (count, origin, half-angle of the fan,
# y of the direction, near, far, FD step, or the steps in sigma and l).
# The hero's (tests/test_torch_grad_hero.py) weighs each ray's t by the sign
# of its d t / d sigma as the JAX package gave it (MEDIUM_WEIGHTS), so that
# FD resolves the sigma partial.  Config 4a's phases scale as 1 / l, so
# its l step is 1e-4 (1e-3 leaves the realization's linear regime).
# Config 2's rays go on from their first crossing in a second segment,
# conditioned there (renewal+), as tests/test_torch_ensemble.py runs them;
# FD is taken over the lanes it resolves (tungsten_tpu_torch/utils/fd.py
# `fd_lanes`).
MEDIUM_RAYS = {"config 1": (32, (0.0, 1.0, 3.8), 0.12, -0.02, 2.0, 4.5, 4e-3),
               "config 2": (32, (0.0, 1.0, 3.8), 0.12, -0.02, 2.0, 4.5, 5e-4),
               "config 3": (48, (0.0, 0.9, 3.0), 0.15, -0.01, 1.2, 4.5, 2e-3),
               "config 4a": (32, (0.0, 1.0, 3.8), 0.12, -0.02, 2.0, 4.5,
                             (1e-3, 1e-4)),
               "config 5": (32, (0.0, 1.0, 3.8), 0.10, -0.03, 2.0, 4.5, 5e-4)}
MEDIUM_WEIGHTS = {"config 5": "--+---+-++---+------+++++++--++-"}
# the K4 variant of config 4a takes config 4a's rays
MEDIUM_SPEC = {"config 4a, step_size 0": "config 4a"}
MEDIUM_FD_RTOL, MEDIUM_FD_ATOL = 0.15, 0.5
MEDIUM_CPU_RTOL = 1e-3
# Config 4a's K5 and K4 agree with their twins within WS_RTOL * (1 + |x|),
# not bit for bit, and its sum over lanes cancels: its card gradient is
# held to the CPU's per lane, with the crossing (t, hit, the kernel's
# gradient) that the card's search found fed into the CPU's reattachment
# (`ws_lane_grads`), each lane within MEDIUM_CPU_RTOL of (|its CPU
# partial| + the lanes' mean |partial|)
# Training steps of each BASELINE config: two (a third would not fit the
# run's time limit beside the gradient variants' steps)
TRAIN_STEPS = 2
# Config 4b (function space) and its CSG union: 128x128, 8 spp, depth 2
# through the CLI and the 64x64, 48-spp goldens.  K8 against its twin
# (torch.linalg.eigh, on the CPU): V diag(W) V^T within K8_RECON_TOL
# max|w| of A, V^T V within K8_ORTH_TOL of I, W within K8_EIG_TOL max|w|
# of the twin's, and, with the limits of tests/test_torch_gp.py, the
# symmetric root within K8_ROOT_RTOL sqrt(max|w|) and b^T pinv(A) b within
# K8_SCHUR_RTOL; on the first K8_CAPTURE matrices of each size that a
# config-4b render hands it (a render of its own, with no time or memory
# reported) and on K8_RANDOM random conditioning blocks [K8_RANDOM, 34,
# 34].  The kernels line and the library call at K8_LINE of those blocks.
FS_SCENES = {name: (os.path.join(ROOT, "scenes", f"gpis-{stem}.json"),
                    os.path.join(ROOT, "goldens", f"gpis-{stem}.pfm"))
             for name, stem in (("config 4b", "function-space"),
                                ("config 4b, CSG", "csg"))}
K8_RECON_TOL, K8_ORTH_TOL, K8_EIG_TOL = 1e-5, 1e-5, 1e-5
K8_ROOT_RTOL, K8_SCHUR_RTOL = 2e-3, 5e-3
K8_CAPTURE, K8_RANDOM, K8_LINE = 16384, 131072, 4096
# kernel and op names of cuSOLVER's and MAGMA's eigensolvers
SOLVER_WORDS = ("syev", "cusolver", "sytrd", "steqr", "ormtr", "magma",
                "linalg_eigh")

# Peaks of one H100 SXM at 700 W: HBM bytes/s (NVIDIA's data sheet), and
# 132 SMs at 1.98 GHz, each issuing or executing per clock the thread-
# instructions of tungsten_tpu_torch/kernels/sass.py's SM_RATES: 128 issued,
# 128 on the FMA pipes (FP32 and integer multiply-add), 64 integer
# multiply-adds on the heavy FMA pipe, 64 on the ALU (integer add, logic,
# shift, compare, select), 16 on the XU (MUFU, conversions).  The data
# sheet's 67 TFLOP/s counts an FMA as two operations; the kernels are built
# with -fmad=false.  Two classes more, for K8: "fp64", float64 adds and
# multiplies, 64 per SM and clock (the data sheet's 34 TFLOP/s of FP64 FMA
# at 132 SMs and 1.98 GHz), and "shared", bytes of shared-memory loads and
# stores, 128 per SM and clock (32 banks of 4 bytes; CUDA C++ Programming
# Guide).
PEAK_BYTES = 3.35e12
SMS, CLOCK = 132, 1.98e9
EXTRA_RATES = {"fp64": 64, "shared": 128}
SM_ISSUE = 128  # thread-instructions issued per SM and clock
# K1, K2 and K3: instructions per point by class, counted from the built
# kernels' SASS (lattice_pipes).  Each impulse within reach of the point
# (d^2 < 1) takes the long path (its last variate and expf; in K1b's split
# walk, its append to the ring and its drained entry): with impulses
# uniform in their cells, per impulse index 4 pi / 3 of the 27 cells' in
# 3D, 2 of the 3 cells' in 1D.
LONG_3D, LONG_1D = 4.0 * np.pi / 3.0, 2.0
# Instructions per point of K1b's and K3b's earlier design (one branch per
# impulse, the per-point partials summed outside), counted in the same way
# from its SASS on an H100: printed beside the new design's times for
# information.
OLD_WORK = {"K1b": 7410.4, "K3b": 471.0}
# K5 and K4: operations per basis function read off the source, each at
# least one instruction, so they bound the issue class; the SASS issues
# more (35.5 instructions per term of K5's march step against 24 counted,
# 104.5 of K4's against 84).  A precise cosf or sinf: a 3-part Cody-Waite
# reduction and a polynomial, ~20; an IEEE divide ~10; a precise log1pf
# ~20; a precise sqrtf ~8; xxhash32_2 with one word fixed 11 (an add, a
# rotate, 3 multiplies, 3 shifts and 3 xors).
OPS_COSF, OPS_DIV, OPS_LOG1P, OPS_SQRT = 20, 10, 20, 8
OPS_HASH2 = 11
# Synthesis of one basis function from the ray's keys: 3 Box-Muller pairs
# (7 xxhash32_2 with their counters and shifts, integer; per pair 2
# conversions and multiplies, a negate, log1pf, a multiply, sqrtf and the
# angle's multiply, float) plus the offset's variate, 4 cosf/sinf and their
# 4 radius products, omega (3 divides, 3 multiplies), freq (dot, max,
# sqrtf), dirs (3 divides) and the offset's multiply.
WS_SYNTH_INT = 7 * (OPS_HASH2 + 1) + 3 * 2 + 7
WS_SYNTH_FLT = (3 * (4 + 1 + OPS_LOG1P + 1 + OPS_SQRT + 1) + 2 + 1
                + 4 * OPS_COSF + 4 + 3 * OPS_DIV + 3 + 6 + OPS_SQRT
                + 3 * OPS_DIV)
WS_HOIST_FLT = 14  # a, slope (two projections and products) and amp
# the end point's value and gradient, from the basis the search already
# holds: the phase a + slope t (2), cosf, sinf, the value's product and sum
# (2), the gradient's coefficient (3) and its 3 products and 3 sums
WS_EVAL_FLT = 2 + 2 * OPS_COSF + 2 + 3 + 6
WS_F0_FLT = 7 + OPS_COSF + 2  # K4's f0 term in the evaluate form
# per basis function and evaluation: K5's phase (2), cosf, amp * cos and
# the sum (2); K4's 2 phases (4), 2 cosf, 4 divides by 2 pi (a product and
# two fma each, rounded as IEEE division), 4 floors, the cos interval's
# min/max, subtracts, compares and selects (18) and the bound's 2 products,
# min/max and 2 sums (6)
K5_FLT_STEP = 4 + OPS_COSF
K4_FLT_STEP = 4 + 2 * OPS_COSF + 4 * 3 + 4 + 18 + 6
# bytes per ray: keys (8), ro and rd (24), near and far (8), K5's step,
# u_jitter and absorb (9), and the [8] float output (32)
K5_BYTES_RAY, K4_BYTES_RAY = 8 + 24 + 8 + 9 + 32, 8 + 24 + 8 + 32
# The spectral draws beside the squared exponential's, per basis function,
# read off csrc/ws_trace.cu (a precise logf ~12).  RQ: d and c (a subtract,
# a multiply, sqrtf, a divide); per proposal the normal (2 hashed
# uniforms, their conversions, log1pf, sqrtf, cosf, 4 products) and the
# uniform (a hash, a conversion), the counters (3), x and v (4), the
# floor, 2 compares, logf(u), the bound (6) with logf(vf), the candidate
# and 2 selects; then the fallback select, mean_rate and tau (2 divides,
# 2 more ops) and l_eff (sqrtf, a divide), omega by 3 divides where the
# SE's takes 3 divides and 3 products.  Matern: the uniform at 5i + 1 (a
# hash, its counter, a conversion), chi2 (log1pf, a negate, 2 products),
# 2 nu, the floor, a divide and sqrtf; omega's 3 products and 3 divides
# replace the SE's.
OPS_LOGF = 12
WS_DRAW_EXTRA = {
    "se": 0,
    "rq": (2 + OPS_SQRT + OPS_DIV
           + 4 * (3 * (OPS_HASH2 + 1) + 3 + 3 + 4 + 1 + OPS_LOG1P
                  + OPS_SQRT + OPS_COSF + 4 + 4 + 1 + 2 + OPS_LOGF + 6
                  + OPS_LOGF + 1 + 2)
           + 1 + 2 * OPS_DIV + 2 + OPS_SQRT + OPS_DIV - 3),
    "matern": OPS_HASH2 + 1 + 2 + 1 + OPS_LOG1P + 3 + 1 + 1 + OPS_DIV
    + OPS_SQRT,
}
# the covariances whose K5/K4 instances the run checks beside the SE's,
# as config 4a's covariance (scene file entries)
WS_TAG_COVS = {
    "rq": {"type": "rational_quadratic", "sigma": 0.06, "lengthScale": 0.12,
           "a": 1.5},
    "matern": {"type": "matern", "sigma": 0.06, "lengthScale": 0.12,
               "v": 1.5}}
WS_TAG_RAYS = (131072,)  # past the most rays a variant render launches on
# the GP layer's variant renders: 8x8 bucket means of the card's 128x128
# image against the port's CPU render of the same scene at 32x32 and the
# same spp (fewer samples shift the image's energy: the samples of a
# pixel are stratified together), one sample a pass; the CPU renders run
# in VARIANT_CPU_WORKERS one-thread processes from the start of the run,
# beside the card's phases
VARIANT_CPU_RES = 32
VARIANT_CPU_WORKERS = 6
VARIANT_BUCKETS = 8
# the variants of the rest of the GP layer's forward: their host syncs
# are counted and the function-space ones' K8 share profiled
SLICE_VARIANTS = ("fs-global", "fs-none", "fs-skip", "fs-conditioned",
                  "hero-bruteforce", "hero-iso", "hero-renewal", "hero-1d",
                  "hero-surfvol", "box-iso", "box-iso-aniso",
                  "box-mirror-phase", "box-mirror-surface", "m1d-renewal",
                  "m1d-aniso")
# the hero's variants' CPU image keeps their 16:9 aspect: (W, H), buckets
# a side
VARIANT_CPU_SHAPE = {n: ((48, 27), 3) for n in SLICE_VARIANTS
                     if n.startswith("hero")}
K8_NEW_SIZES = (16, 32)  # the Global ring's solve, the chunk's root
# the hero's forward variants render at half its 1920x1080 a side (2 row
# bands of 273 rows where the frame takes 8 of 136)
HERO_VARIANT_RES = (960, 540)


def ws_work(name, n, rays, rays_eval, steps, refined, tag="se"):
    """(bytes, {class: instructions}) of K5 or K4 (`name`) over `rays` rays
    of n basis functions that took `steps` march steps or iterations in
    all, `rays_eval` of them evaluating their end point and `refined` of
    them (K5) refining a crossing: one synthesis of the basis per ray (the
    function needs no second one: the end point's phase is the held
    a + slope t, its gradient needs omega), with covariance `tag`'s
    spectral draw, all ops counted as issued."""
    ops = (n * (WS_SYNTH_INT + WS_SYNTH_FLT + WS_HOIST_FLT
                + WS_DRAW_EXTRA[tag]) * rays
           + n * WS_EVAL_FLT * rays_eval)
    if name == "K5":  # f0, the steps and 6 Illinois steps per crossing
        ops += n * K5_FLT_STEP * (rays + steps + 6 * refined)
        return K5_BYTES_RAY * rays, {"issue": ops}
    ops += n * (WS_F0_FLT * rays + K4_FLT_STEP * steps)
    return K4_BYTES_RAY * rays, {"issue": ops}


def lattice_pipes(sass, noise3d, noise1d):
    """{kernel: (bytes, {class: instructions}) per point} of K1, K1b, K2,
    K2b, K3 and K3b (and K1b's and K2b's full-form instances) at K = 3
    impulses per cell (every scene's), from the SASS of the libraries just
    built (K1b's, K3's and K3b's K = 3 kernels)."""
    from tungsten_tpu_torch.kernels.nvcc import compile_library, sass_listing
    l3 = sass_listing(compile_library(noise3d.SOURCE)[0])
    l1 = sass_listing(compile_library(noise1d.SOURCE)[0])
    K = 3
    return {
        "K1": (20, sass.lattice_counts(l3, "noise3d_sum_s_kernel", 27 * K,
                                       LONG_3D * K, cells=27)),
        # p, seed and the cotangent in; dp out.  The split walk: the cell
        # loop (K = 3 tests each) 27 times, an append and a drained entry
        # per impulse within reach, and the point loop around the walk
        # (loads, dp and the float64 partials) once
        "K1b": (32, sass.split_counts(l3, "noise3d_sum_s_bwd_kernelILi3ELb0",
                                      27, LONG_3D * K, around=1)),
        # the full-form instance: the same walk, three more sums a drained
        # entry
        "K1b full": (32, sass.split_counts(
            l3, "noise3d_sum_s_bwd_kernelILi3ELb1", 27, LONG_3D * K,
            around=1)),
        "K2": (28, sass.lattice_counts(l3, "noise3d_sum_kernel", 27 * K,
                                       LONG_3D * K, cells=27)),
        # p, seed, kr, qm and the cotangent in; dp and 5 partials out
        "K2b": (60, sass.lattice_counts(l3, "noise3d_sum_bwd_kernelILb0",
                                        27 * K, LONG_3D * K, cells=27)),
        # and 3 + 8 partials out
        "K2b full": (72, sass.lattice_counts(
            l3, "noise3d_sum_bwd_kernelILb1", 27 * K, LONG_3D * K,
            cells=27)),
        "K3": (12, sass.lattice_counts(l1, "noise1d_sum_kernelILi3", 1,
                                       LONG_1D * K)),
        # pz, seed and the cotangent in; dpz out
        "K3b": (16, sass.lattice_counts(l1, "noise1d_sum_bwd_kernelILi3", 1,
                                        LONG_1D * K))}


def per_points(work, n):
    """(bytes, {class: instructions}) of a lattice kernel on n points."""
    n_bytes, counts = work
    return n_bytes * n, {c: v * n for c, v in counts.items()}


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


def kernel_device_ms(fn, kernel, reps=20, tries=3):
    """Mean device time of one launch of the CUDA kernel named `kernel`
    (fn() launches it once), from torch.profiler over `reps` calls after
    one warm-up: the kernel alone, without the host work and gaps a
    CUDA-event window around a short launch also holds.  The mean is over
    the launches the profiler recorded; a window in which it recorded none
    is profiled again, up to `tries` times.  Where none did, the time is
    the median of `reps` CUDA-event windows around fn() (host work and
    gaps included, so no less than the kernel's), and the run says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        launches = sum(e.count for e in seen)
        us = sum(e.self_device_time_total for e in seen)
        if launches > 0 and us > 0:
            return us / launches / 1e3
    t = median_ms(fn, reps)
    print(f"the profiler recorded no device time for {kernel} in {tries} "
          f"windows: its time is {t:.4f} ms, the median of {reps} CUDA-event "
          "windows around one call", flush=True)
    return t


def bound_ms(n_bytes, counts):
    """(least time in ms, "bytes" or "operations", the class that bounds
    it) for n_bytes of device memory traffic and {class: instructions}:
    the largest of bytes over HBM's rate and each class's instructions
    (bytes, for "shared") over its rate on all SMs (SM_RATES and
    EXTRA_RATES)."""
    from tungsten_tpu_torch.kernels.sass import SM_RATES
    rates = {**SM_RATES, **EXTRA_RATES}
    times = {"bytes": n_bytes / PEAK_BYTES}
    for cls, n in counts.items():
        times[cls] = n / (rates[cls] * SMS * CLOCK)
    cls = max(times, key=times.get)
    return (times[cls] * 1e3, "bytes" if cls == "bytes" else "operations",
            cls)


def check_bound(what, ms, b_ms):
    """A measured time below its lower bound means the counts behind the
    bound are wrong: fail."""
    if ms < b_ms:
        raise RuntimeError(f"{what}: {ms:.4f} ms measured is below its bound "
                           f"{b_ms:.4f} ms; the bound's counts are wrong")


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


def ws_doc(step_size=None, res=None, cov=None):
    """Config 4a's scene dict, optionally with another step_size,
    resolution or covariance."""
    with open(WS_SCENE) as f:
        doc = json.load(f)
    if step_size is not None:
        doc["media"][0]["step_size"] = step_size
    if res is not None:
        doc["camera"]["resolution"] = list(res)
    if cov is not None:
        doc["media"][0]["gaussian_process"]["covariance"] = cov
    return doc


def ws_args(med, R, seed, dev, name):
    """Arguments of K5's (`name` "K5") or K4's batch function for R rays of
    config 4a inside its bounding cube, made from a numpy seed: origins
    around the GPIS sphere, random directions and (pixel, sample, bounce)
    words, the march interval clamped to the cube as the medium clamps it;
    a third of the rays start after an interior scatter."""
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
    head = (med.gp, med.basis_functions, md._ws_key(med, pss), ro, rd, near,
            far)
    if name == "K4":
        return head
    step = torch.clamp(torch.minimum(med.step_size, (far - near)
                                     / med.min_step), min=1e-6)
    absorb = torch.arange(R, device=dev) % 3 == 0
    return head + (step, uj, absorb, med.max_march_steps)


WS_FNS = {"K5": "fixed_march_batch", "K4": "sphere_trace_batch"}


def ws_kernel_checks(wst, med, dev, card_line, rays=WS_RAYS, tag="se",
                     twin_reps=3):
    """K5 and K4 against their plain twins, one whole search of each of
    `rays` rays of config 4a (with covariance `tag`) at n = 1024: hit,
    sign0 and the step count, then t, the value and the gradient at the
    end point.  Returns {kernel: numbers at WS_LINE_RAYS} for the kernels
    line (the twin's time the median of `twin_reps`)."""
    n = med.basis_functions
    out = {}
    for name, fn in WS_FNS.items():
        kern, twin = getattr(wst, fn), getattr(wst, fn + "_ref")
        max_err = 0.0
        for R in rays:
            args = ws_args(med, R, R, dev, name)
            got = kern(*args)
            torch.cuda.synchronize()
            want = twin(*args)
            if not all(bool(torch.isfinite(got[k]).all())
                       for k in ("t", "val", "grad")):
                raise RuntimeError(f"{name} returned non-finite values")
            bad = ((got["hit"] != want["hit"]) | (got["sign0"] != want["sign0"])
                   | (got["steps"] != want["steps"]))
            for k in ("t", "val", "grad"):
                off = (got[k] - want[k]).abs() > WS_RTOL * (1.0 + want[k].abs())
                bad |= off if off.dim() == 1 else off.any(dim=1)
            n_bad = int(bad.sum())
            if bool((~bad).any()):
                max_err = max(max_err, *(float((got[k] - want[k])[~bad]
                                               .abs().max())
                                         for k in ("t", "val", "grad")))
            share = n_bad / R
            steps, hits = float(got["steps"].sum()), int(got["hit"].sum())
            t_k = median_ms(lambda: kern(*args))
            print(f"{name} ({tag}) R={R} n={n}: {100 * hits / R:.2f}% of "
                  "rays hit, "
                  f"{steps:.0f} ray-steps; rays whose hit, sign0 or step count"
                  f" or t, value or gradient differ {n_bad} ({share:.2e}, "
                  f"limit {WS_MAX_SHARE}); max |kernel - twin| on the others "
                  f"{max_err:.3e} (limit {WS_RTOL}*(1+|x|)); kernel {t_k:.4f}"
                  f" ms per search (median of 20, CUDA events; {card_line})",
                  flush=True)
            if share > WS_MAX_SHARE:
                raise RuntimeError(f"{name} disagrees with its twin on "
                                   f"{n_bad} of {R} rays")
            if R == WS_LINE_RAYS:
                t_p = median_ms(lambda: twin(*args), reps=twin_reps)
                b_ms, b_by, b_cls = bound_ms(*ws_work(
                    name, n, R, R, steps, hits if name == "K5" else 0, tag))
                check_bound(f"{name} ({tag}) R={R}", t_k, b_ms)
                print(f"{name} ({tag}) R={R}: twin {t_p:.4f} ms per search "
                      "(median "
                      f"of {twin_reps}); bound {b_ms:.4f} ms ({b_cls}), the "
                      "kernel at "
                      f"{b_ms / t_k:.3f} of it", flush=True)
                out[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                             "bound_by": b_by, "bound_class": b_cls}
            del args, got, want, bad
            torch.cuda.empty_cache()
        out[name]["max_abs_err"] = max_err
    return out


class WsSearches:
    """Wraps K5's and K4's batch functions, as the medium calls them, to
    record per kernel the searches, the most rays one took, the host syncs
    inside them (torch.cuda.set_sync_debug_mode), and, on the device, the
    work they did: rays, rays that evaluated their end point, ray-steps and
    refined crossings (for the bound over a render)."""

    def __init__(self, wst):
        self.wst = wst
        self.fns = {name: getattr(wst, fn) for name, fn in WS_FNS.items()}
        self.reset()
        for name, fn in WS_FNS.items():
            setattr(wst, fn, self._wrap(name))

    def reset(self):
        self.calls = {name: 0 for name in WS_FNS}
        self.most = {name: 0 for name in WS_FNS}
        self.syncs = {name: 0 for name in WS_FNS}
        self.work = {name: [0, 0, 0, 0] for name in WS_FNS}

    def _wrap(self, name):
        def wrapped(gp, n, key, *rest, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = self.fns[name](gp, n, key, *rest, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
            R = key.shape[0]
            self.calls[name] += 1
            self.most[name] = max(self.most[name], R)
            self.syncs[name] += sum("synchronizing CUDA operation"
                                    in str(w.message) for w in caught)
            w = self.work[name]
            w[0] += R
            w[1] += R if kw.get("evaluate", True) else 0
            w[2] = w[2] + res["steps"].sum()
            if name == "K5" and kw.get("refine", True):
                w[3] = w[3] + res["hit"].sum()
            return res
        return wrapped

    def bound(self, name, n):
        """The kernel's bound over the searches since the last reset:
        (ms, bytes/operations, class, rays, ray-steps)."""
        rays, rays_eval, steps, refined = (float(x) for x in self.work[name])
        return (*bound_ms(*ws_work(name, n, rays, rays_eval, steps, refined)),
                rays, steps)

    def check(self, name, what, limit=max(WS_RAYS)):
        """The render's searches each launched the kernel once, with no host
        sync inside, on at most the rays the twin check covers (`limit`)."""
        launches = getattr(self.wst, "MARCH_LAUNCHES" if name == "K5"
                           else "TRACE_LAUNCHES")
        print(f"{what}: {self.calls[name]} {name} searches, {launches} "
              f"launches, {self.syncs[name]} host syncs inside them, at most "
              f"{self.most[name]} rays per launch (checked against its twin "
              f"up to {limit})", flush=True)
        if launches != self.calls[name] or self.syncs[name]:
            raise RuntimeError(f"{what}: {name} made other than one launch "
                               "and no host sync per search")
        if self.most[name] > limit:
            raise RuntimeError(f"{what} launched {name} on {self.most[name]} "
                               "rays, more than the twin check covers")


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


def bucket_compare(card_img, cpu_img, n=VARIANT_BUCKETS):
    """n x n bucket means of the card's image against the CPU's render of
    the same scene at another resolution: (energy ratio, share of bad
    buckets).  A bucket is bad when the means differ by more than 3
    standard errors of both (each from its pixels' spread) plus 0.02."""
    def stats(img):
        h, w, _ = img.shape
        b = img.reshape(n, h // n, n, w // n, 3)
        m = b.mean(axis=(1, 3))
        se = np.sqrt(b.var(axis=(1, 3)) / (h // n * w // n))
        return m, se
    mc, sc = stats(card_img)
    mp, sp = stats(cpu_img)
    ratio = (mc.mean() + 1e-6) / (mp.mean() + 1e-6)
    bad = float((np.abs(mc - mp) > 3.0 * (sc + sp) + 0.02).mean())
    return float(ratio), bad


# the kernels each GP-layer variant (tools/gp_variants.py) goes through,
# and its K5/K4 tag
VARIANT_KERNELS = {
    "ws-rq": (("K5",), "rq"), "ws-rq-trace": (("K4",), "rq"),
    "ws-matern": (("K5",), "matern"), "ws-matern-trace": (("K4",), "matern"),
    "fs-matern": (("K8",), None), "box-knob": (("K1",), None),
    "box-mesh": (("K1",), None), "box-ggx": (("K1",), None),
    "box-csg": (("K1",), None), "ws-linear": ((), None),
    "fs-global": (("K8",), None), "fs-none": (("K8",), None),
    "fs-skip": (("K8",), None), "fs-conditioned": (("K8",), None),
    "hero-bruteforce": (("K2",), None), "hero-iso": (("K1",), None),
    "hero-renewal": (("K2",), None), "hero-1d": ((), None),
    "hero-surfvol": (("K2",), None), "box-iso": (("K1",), None),
    "box-iso-aniso": (("K1",), None), "box-aniso": (("K1",), None),
    "box-mirror-phase": (("K1",), None),
    "box-mirror-surface": (("K1",), None), "m1d-renewal": (("K3",), None),
    "m1d-aniso": (("K3",), None)}


def variant_docs(tmp):
    """The GP layer's variant scenes: {label: (scene dict, spp, the kernels
    the render goes through, the K5/K4 tag, the variant's name)}; the
    hero's at HERO_VARIANT_RES (a cut of their depth: the time limit
    leaves room for the gradient variants)."""
    from tungsten_tpu_torch.tools.gp_variants import variant_docs as docs
    out = {}
    for name, (label, doc, spp) in docs(tmp).items():
        if name.startswith("hero"):
            doc = json.loads(json.dumps(doc))
            doc["camera"]["resolution"] = list(HERO_VARIANT_RES)
            label = label.replace("config 5", "config 5 at "
                                  f"{HERO_VARIANT_RES[0]}x"
                                  f"{HERO_VARIANT_RES[1]}")
        out[label] = (doc, spp, *VARIANT_KERNELS[name], name)
    return out


def cpu_reference(doc, spp, res=(VARIANT_CPU_RES, VARIANT_CPU_RES)):
    """The port's CPU render of scene dict `doc` at res (W, H), spp
    samples one a pass, as a mean image (numpy), and its wall seconds: run
    in a process of its own, on one thread."""
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from tungsten_tpu_torch.models.integrator import render_pass
    from tungsten_tpu_torch.scene.parse import scene_from_dict
    t0 = time.perf_counter()
    doc = json.loads(json.dumps(doc))
    doc["camera"]["resolution"] = list(res)
    scene, _ = scene_from_dict(doc, device="cpu")
    img = sum(render_pass(scene, s) for s in range(spp)) / spp
    return img.numpy(), time.perf_counter() - t0


_POOLS = []  # the process pools main() starts


def start_cpu_references(tmp):
    """(variant_docs(tmp), a spawned process pool, {name: future of
    cpu_reference}): the variants' CPU renders, started at once."""
    import multiprocessing
    docs = variant_docs(tmp)
    pool = concurrent.futures.ProcessPoolExecutor(
        VARIANT_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    # the slice's first: the phase renders them last
    order = sorted(docs.items(), key=lambda kv: kv[1][4] not in
                   SLICE_VARIANTS)
    futures = {}
    for what, (doc, spp, _, _, name) in order:
        res, _ = VARIANT_CPU_SHAPE.get(
            name, ((VARIANT_CPU_RES, VARIANT_CPU_RES), VARIANT_BUCKETS))
        futures[what] = pool.submit(cpu_reference, doc, spp, res)
    return docs, pool, futures


class LaunchCapture:
    """Wraps K2's raw wrapper, as the march calls it, to keep the inputs
    of its first launch on at least `least` points; the launches stay the
    render's."""

    def __init__(self, noise3d, least):
        self.noise3d, self.least, self.args = noise3d, least, None
        self.fn = noise3d.noise3d_sum

    def __enter__(self):
        def launch(p, seed, kr, qm, m6, K):
            if self.args is None and p.shape[0] >= self.least:
                self.args = (p.clone(), seed.clone(), kr.clone(), qm.clone(),
                             tuple(float(v) for v in m6), K)
            return self.fn(p, seed, kr, qm, m6, K)
        self.noise3d.noise3d_sum = launch
        return self

    def __exit__(self, *exc):
        self.noise3d.noise3d_sum = self.fn


def k2_brute_force_check(noise3d, args, work, card_line):
    """K2 against its twin on a brute-force launch's own arguments (one
    cell radius for all lanes, per-lane form scales), atol K2_ATOL, and
    timed beside its bound."""
    p, seed, kr, qm, m6, K = args
    got = noise3d.noise3d_sum(p, seed, kr, qm, m6, K)
    want = noise3d.noise3d_sum_ref(p, seed, kr, qm, m6, K)
    err = float((got - want).abs().max())
    t_k = kernel_device_ms(lambda: noise3d.noise3d_sum(p, seed, kr, qm, m6,
                                                       K),
                           "noise3d_sum_kernel", reps=5)
    b_ms, _, b_cls = bound_ms(*per_points(work, p.shape[0]))
    check_bound("K2 on the brute-force launch", t_k, b_ms)
    print(f"K2 on a brute-force launch's own arguments ({p.shape[0]} points,"
          f" cell radius {float(kr[0]):.5f} for all, form scales "
          f"{float(qm.min()):.4f}-{float(qm.max()):.4f}): max |kernel - "
          f"twin| = {err:.3e} (atol {K2_ATOL}); device {t_k:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_cls}), {b_ms / t_k:.3f} of it ({card_line})",
          flush=True)
    if err > K2_ATOL or not bool(torch.isfinite(got).all()):
        raise RuntimeError("K2 disagrees with its twin on the brute-force "
                           "branch's arguments")
    return err


class CoupledCapture:
    """Wraps K8's wrapper to keep the first `most` matrices of each size in
    `sizes` that a render hands it with an off-diagonal entry (a ring with
    no row yet, or with only the two rows of one crossing, gives a
    diagonal block, which K8 leaves at once), and to count all and the
    coupled ones by size; the launches stay the render's."""

    def __init__(self, psd, sizes, most):
        self.psd, self.sizes, self.most = psd, sizes, most
        self.mats = {n: [] for n in sizes}
        self.seen = {n: [0, 0] for n in sizes}
        self.eigh = psd.eigh

    def __enter__(self):
        def eigh(a, sweeps=False):
            n = a.shape[-1]
            if n in self.mats:
                flat = a.reshape(-1, n, n)
                off = flat - torch.diag_embed(flat.diagonal(dim1=1, dim2=2))
                keep = flat[off.abs().amax((1, 2)) > 0]
                self.seen[n][0] += flat.shape[0]
                self.seen[n][1] += keep.shape[0]
                have = sum(x.shape[0] for x in self.mats[n])
                if have < self.most:
                    self.mats[n].append(keep[:self.most - have].clone())
            return self.eigh(a, sweeps)
        self.psd.eigh = eigh
        return self

    def __exit__(self, *exc):
        self.psd.eigh = self.eigh


def k8_share(trender, psd, counters, scene, what, spp, card_line,
             tries=3):
    """A function-space render on the card under torch.profiler (device
    activity only, read from its raw events) with the launch counts at 0
    just before: K8's device time and share of the render's, K8 alone
    launched, no solver kernel.  After the spawned ranks of the sharded
    phases the profiler may record no device activity at all (PERF.md,
    PR 13): the render is profiled again, up to `tries` times, and the
    share printed as not measured if none recorded any (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(tries):
        zero_counts(counters)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            trender.render(scene, spp, device="cuda")
            torch.cuda.synchronize()
        check_counts(counters, ("K8",), what)
        total = k8 = 0.0
        solver = set()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            us = e.duration_ns() / 1e3
            total += us
            if "jacobi_eigh_kernel" in e.name():
                k8 += us
            elif any(w in e.name().lower() for w in SOLVER_WORDS):
                solver.add(e.name())
        if solver:
            raise RuntimeError(f"{what}: a solver kernel ran: "
                               f"{sorted(solver)}")
        if total > 0.0:
            break
    if total <= 0.0:
        print(f"{what} under the profiler, {spp} spp: K8's share of device "
              f"time not measured (the profiler recorded no device "
              f"activity in {tries} renders)", flush=True)
        return None
    if k8 <= 0.0:
        raise RuntimeError(f"{what}: the profiler saw device time but none "
                           "of K8's")
    print(f"{what} under the profiler, {spp} spp: device time "
          f"{total / 1e3:.1f} ms, K8 {k8 / 1e3:.1f} ms, {k8 / total:.3f} of "
          f"it; no cuSOLVER kernel ({card_line})", flush=True)
    return k8 / total


def k8_new_sizes(trender, psd, gpmod, scene, card_line):
    """K8 at the Global and None contexts' sizes (K8_NEW_SIZES): against
    its twin on the first K8_CAPTURE coupled matrices of each size that a
    render of `scene` hands it (where the render hands it fewer than
    K8_LINE, on as many random conditioning blocks of that size,
    `fs_blocks`), then timed at K8_LINE of them (device time), beside its
    bound, its twin (the CPU) and torch.linalg.eigh (the card).  Returns
    {n: the kernels line's numbers}."""
    with CoupledCapture(psd, K8_NEW_SIZES, K8_CAPTURE) as cap:
        trender.render(scene, 8, device="cuda")
    out = {}
    for n in K8_NEW_SIZES:
        total, coupled = cap.seen[n]
        print(f"fs-global's pass handed K8 {total} matrices {n}x{n}, "
              f"{coupled} of them with an off-diagonal entry", flush=True)
        if coupled >= K8_LINE:
            a_all, what = torch.cat(cap.mats[n]), f"fs-global's pass, n = {n}"
        else:
            a_all = fs_blocks(gpmod, scene.media[0].gp.cov, K8_CAPTURE,
                              n - 2, "cuda", n)[0]
            what = f"random conditioning blocks, n = {n}"
        err, _, mean, most = k8_against_twin(psd, gpmod, a_all, None, what)
        mats = {n: a_all}
        a = mats[n][:K8_LINE].contiguous()
        B = a.shape[0]
        sweeps = int(psd.eigh(a, sweeps=True)[2].sum())
        # CUDA events: after the spawned ranks of the sharded phases the
        # profiler may record no device activity (PERF.md, PR 13)
        k8_ms = median_ms(lambda: psd.eigh(a))
        plain_ms = median_ms(lambda: psd.eigh_ref(a.cpu()), reps=1)
        lib_ms, _ = k8_library(a, k8_ms, card_line, f"[{B}, {n}, {n}] {what}")
        b_ms, b_by, b_cls = bound_ms(*k8_work(n, sweeps, B))
        check_bound(f"K8 at [{B}, {n}, {n}]", k8_ms, b_ms)
        print(f"K8 at [{B}, {n}, {n}]: {k8_ms:.4f} ms (median of 20, CUDA "
              f"events), twin "
              f"{plain_ms:.3f} ms, torch.linalg.eigh {lib_ms:.3f} ms; bound "
              f"{b_ms:.4f} ms ({b_cls}; {sweeps} sweeps in all), "
              f"{b_ms / k8_ms:.3f} of it ({card_line})", flush=True)
        out[n] = {"max_abs_err": err, "ms": k8_ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "bound_class": b_cls,
                  "library_ms": lib_ms, "sweeps": [mean, most]}
    return out


def gp_layer_variants(trender, scene_from_dict, wst, searches, counters,
                      psd, gpmod, noise3d, lattice, dev, docs, cpu_refs, tmp,
                      card_line):
    """The GP layer's variant renders (variant_docs) through the CLI at
    their scenes' own size, each with the launch counts set to 0 just
    before and read just after, held by bucket means against the port's
    CPU render (`cpu_refs`: futures of cpu_reference); the function-space
    variants' matrices against K8's twin.  The new variants (SLICE_VARIANTS)
    also count their host syncs; their function-space ones render again
    under the profiler for K8's share of device time, and fs-global's
    matrices hold K8 at its new sizes; hero-bruteforce's first K2 launch
    is held against the twin on its own arguments.  Returns ({(kernel,
    tag): launches} of the K5/K4 tag renders, {n: K8's numbers at the new
    sizes}, {n: K8's launches at the new sizes})."""
    from tungsten_tpu_torch.models import fs_medium
    tag_launches, k8_new, k8_by_n = {}, {}, {n: 0 for n in K8_NEW_SIZES}
    for what, (doc, spp, used, tag, name) in docs.items():
        new = name in SLICE_VARIANTS
        res, nb = VARIANT_CPU_SHAPE.get(
            name, ((VARIANT_CPU_RES, VARIANT_CPU_RES), VARIANT_BUCKETS))
        W, H = doc["camera"]["resolution"]
        phase(f"{what} ({W}x{H}, {spp} spp) through the CLI, against the "
              f"CPU at {res[0]}x{res[1]}")
        t0 = time.perf_counter()
        path = os.path.join(tmp, "variant.json")
        with open(path, "w") as fh:
            json.dump(doc, fh)
        zero_counts(counters)
        psd.LAUNCHES_BY_N.clear()
        wst.LAUNCHES_BY_TAG.clear()
        searches.reset()
        fs_medium.SKIPPED.update(length=0.0, rays=0)
        capture = LaunchCapture(noise3d, 1 << 16)
        box = []

        def run():
            box.append(render_cli(trender, path, spp, tmp, "variant"))
        with capture if name == "hero-bruteforce" else \
                contextlib.nullcontext():
            syncs = host_syncs(run) if new else run()
        img, wall, peak = box[0]
        counts = check_counts(counters, used, what)
        for n in K8_NEW_SIZES:
            k8_by_n[n] += psd.LAUNCHES_BY_N.get(n, 0)
        for kname in used:
            if kname in WS_FNS:
                searches.check(kname, what, max(WS_TAG_RAYS))
                key = ({"K5": "ws_march", "K4": "ws_trace"}[kname], tag)
                tag_launches[(kname, tag)] = wst.LAUNCHES_BY_TAG.get(key, 0)
                if set(wst.LAUNCHES_BY_TAG) != {key}:
                    raise RuntimeError(f"{what} launched other instances: "
                                       f"{wst.LAUNCHES_BY_TAG}")
        lum = check_image(img, what, (H, W, 3))
        t1 = time.perf_counter()
        cpu_img, cpu_s = cpu_refs[what].result()
        waited = time.perf_counter() - t1
        ratio, bad = bucket_compare(img, cpu_img, nb)
        extra = ""
        if new:
            extra = f", {syncs} host syncs"
            if psd.LAUNCHES_BY_N:
                extra += ", K8 launches by n " + ", ".join(
                    f"{n}: {c}" for n, c in sorted(psd.LAUNCHES_BY_N.items()))
            if fs_medium.SKIPPED["rays"]:
                extra += (f", mean skipped length "
                          f"{float(fs_medium.SKIPPED['length']) / fs_medium.SKIPPED['rays']:.4f}"
                          f" over {fs_medium.SKIPPED['rays']} segments")
        print(f"mean luminance {lum:.4f}; launches {counts}{extra}; "
              f"{wall:.2f} s with scene load, peak device memory "
              f"{peak / 2 ** 30:.2f} GiB ({card_line}); against the CPU's "
              f"{res[0]}x{res[1]}, {spp}-spp render ({cpu_s:.1f} s in "
              f"its process, {waited:.1f} s waited for): energy ratio "
              f"{ratio:.4f} (0.9-1.1), {nb}x{nb} buckets bad {bad:.4f} "
              f"(< 0.08)", flush=True)
        if not (0.9 < ratio < 1.1 and bad < 0.08):
            raise RuntimeError(f"{what} disagrees with the CPU render")
        if name == "hero-bruteforce":
            if capture.args is None:
                raise RuntimeError("hero-bruteforce made no K2 launch of "
                                   "2^16 points or more")
            k2_brute_force_check(noise3d, capture.args, lattice["K2"],
                                 card_line)
        if "K8" in used:
            scene = scene_from_dict(doc, device=dev)[0]
            gc = scene.media[0].gp.global_cond
            if gc is not None:
                from tungsten_tpu_torch.scene import parse as tparse
                free = dataclasses.replace(scene.media[0].gp,
                                           global_cond=None)
                gdoc = doc["media"][0]["gaussian_process"]
                tparse._global_cond(free, gdoc, dev, tmp)  # warm
                solve_s = timed(lambda: tparse._global_cond(free, gdoc, dev,
                                                            tmp))
                print(f"{what}: the scene-load solve of its "
                      f"{gc.pts.shape[0]} mesh rows (K11 and its float64 "
                      f"pseudo-inverse by torch.linalg.eigh, alpha) "
                      f"{solve_s * 1e3:.1f} ms ({card_line})", flush=True)
            if new:
                k8_share(trender, psd, counters, scene, what, spp, card_line)
            if name == "fs-global":
                k8_new = k8_new_sizes(trender, psd, gpmod, scene, card_line)
            elif not new:
                with EighCapture(psd, gpmod, K8_CAPTURE) as cap:
                    trender.render(scene, spp, device=dev)
                mats, (s11, s12) = cap.sets()
                for n, a in sorted(mats.items()):
                    if n != s11.shape[-1]:
                        k8_against_twin(psd, gpmod, a, None,
                                        f"{what}, n = {n}")
                k8_against_twin(psd, gpmod, s11, s12,
                                f"{what}, the normal solves' blocks",
                                schur_gate=False)
        done_print(t0)
    return tag_launches, k8_new, k8_by_n


def done_print(t0):
    print(f"-- {time.perf_counter() - t0:.1f} s", flush=True)


def k3_checks(noise1d, work, dev, card_line):
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
        b_ms, b_by, b_cls = bound_ms(*per_points(work, n))
        check_bound(f"K3 N={n}", t_k, b_ms)
        times[n] = (t_k, t_p, b_ms, b_by, b_cls)
        print(f"K3 K={K} N={n}: max |kernel - twin| = {err:.3e} (atol "
              f"{K3_ATOL}); kernel {t_k:.4f} ms of device time (mean of 20, "
              f"torch.profiler), wrapper call {t_w:.4f} ms and twin "
              f"{t_p:.4f} ms (median of 20, CUDA events; {card_line}); "
              f"bound {b_ms:.4f} ms ({b_cls})", flush=True)
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


def k2_checks(noise3d, base, work, dev, card_line):
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
        b_ms, b_by, b_cls = bound_ms(*per_points(work, n))
        check_bound(f"K2 N={n}", t_k, b_ms)
        times[n] = (t_k, t_p, b_ms, b_by, b_cls)
        print(f"K2 K={K} N={n}: kernel {t_k:.4f} ms of device time (mean of "
              f"20, torch.profiler), wrapper call {t_w:.4f} ms and twin "
              f"{t_p:.4f} ms (median of 20, CUDA events; {card_line}); "
              f"bound {b_ms:.4f} ms ({b_cls})", flush=True)
    return err_max, times


def check_k2_points(noise3d, what):
    """The largest K2 and K2b launches lie within the points they were
    checked on."""
    most = {"K2": noise3d.K2_MOST_POINTS, "K2b": noise3d.K2B_MOST_POINTS}
    print(f"{what}: " + ", ".join(f"{k} launched on at most {v} points"
                                  for k, v in most.items())
          + f" (checked against their twins up to {max(K2_POINTS)})",
          flush=True)
    if max(most.values()) > max(K2_POINTS):
        raise RuntimeError(f"{what} launched K2 or K2b on {most} points, "
                           "more than the twin check covers")


def profile_table(prof, name):
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=60))
    return os.path.relpath(path, ROOT)


def profile(trender, noise3d, wst, searches, lattice, scene, ws_scene,
            ws_trace_scene, dev, card_line):
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
    b_ms, _, b_cls = bound_ms(*per_points(lattice["K1"], points[0]))
    n_launch, launch_ms = launches(events)
    table = profile_table(prof, "profile_16spp.txt")
    print(f"config 1, 16 spp under torch.profiler: wall {wall * 1e3:.1f} ms,"
          f" device {dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f} of the "
          f"profiled wall, {dev_ms / (min(walls16) * 1e3):.3f} of the "
          f"fastest unprofiled wall), K1 {k1_ms:.1f} ms on {points[0]} "
          f"points, bound {b_ms:.3f} ms ({b_cls}); cudaLaunchKernel "
          f"x{n_launch}, {launch_ms:.1f} ms host ({card_line}); table in "
          f"{table}", flush=True)
    if dev_ms <= 0 or k1_ms <= 0:
        raise RuntimeError("the profiler saw no device time for config 1")
    check_bound("K1 over config 1's render", k1_ms, b_ms)

    for what, sc, name, kernel, counter in (
            ("config 4a", ws_scene, "K5", "ws_march_kernel",
             "MARCH_LAUNCHES"),
            ("config 4a, step_size 0", ws_trace_scene, "K4",
             "ws_trace_kernel", "TRACE_LAUNCHES")):
        walls, counts = [], []
        for _ in range(2):
            setattr(wst, counter, 0)
            walls.append(timed(lambda: trender.render(sc, 8, device=dev)))
            counts.append(getattr(wst, counter))
        syncs = host_syncs(lambda: trender.render(sc, 8, device=dev))
        rates = ", ".join(f"{128 * 128 * 8 / w / 1e3:.2f}" for w in walls)
        print(f"{what}, 8 spp in one batch: {walls[0]:.4f} s, "
              f"{walls[1]:.4f} s ({rates} Ksamples/s); {name} launches "
              f"{counts}; host syncs {syncs} ({card_line})", flush=True)
        setattr(wst, counter, 0)
        searches.reset()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: trender.render(sc, 8, device=dev))
        n_k = getattr(wst, counter)
        b_ms, _, b_cls, rays, steps = searches.bound(name, sc.media[0]
                                                     .basis_functions)
        events = prof.key_averages()
        dev_ms, k_ms = device_ms(events), device_ms(events, kernel)
        synth = [e for e in events if e.key == "ws_realization"
                 and e.device_type == DeviceType.CPU]
        synth_ms = sum(e.device_time_total for e in synth) / 1e3
        n_launch, launch_ms = launches(events)
        table = profile_table(prof, "profile_ws_8spp.txt" if name == "K5"
                              else "profile_ws_trace_8spp.txt")
        print(f"{what}, 8 spp under torch.profiler: wall {wall * 1e3:.1f} "
              f"ms, device {dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f} "
              f"of the profiled wall, {dev_ms / (min(walls) * 1e3):.3f} of "
              f"the fastest unprofiled wall), {name} {k_ms:.1f} ms over {n_k}"
              f" launches ({k_ms / max(dev_ms, 1e-9):.3f} of device time) on "
              f"{rays:.0f} rays and {steps:.0f} ray-steps, bound {b_ms:.3f} "
              f"ms ({b_cls}; the kernel at {b_ms / max(k_ms, 1e-9):.3f} of "
              f"it); ws_realization {synth_ms:.1f} ms; cudaLaunchKernel "
              f"x{n_launch}, {launch_ms:.1f} ms host ({card_line}); table in "
              f"{table}", flush=True)
        if dev_ms <= 0 or k_ms <= 0:
            raise RuntimeError(f"the profiler saw no device time for {what}")
        check_bound(f"{name} over the {what} render", k_ms, b_ms)


def ws_kernel_parts(searches, med, dev, card_line):
    """K5 and K4 on WS_LINE_RAYS config-4a rays, timed whole and in parts:
    without the end point's evaluation (its second synthesis), and for K5
    with no march step (the synthesis and f0 alone)."""
    for name in WS_FNS:
        fn, args = searches.fns[name], ws_args(med, WS_LINE_RAYS,
                                               WS_LINE_RAYS, dev, name)
        parts = {"whole": median_ms(lambda: fn(*args)),
                 "without the end point": median_ms(
                     lambda: fn(*args, evaluate=False))}
        if name == "K5":
            parts["synthesis and f0 alone"] = median_ms(
                lambda: fn(*args[:-1], 0, evaluate=False))
        print(f"{name} on {WS_LINE_RAYS} rays, ms per search (median of 20, "
              f"CUDA events; {card_line}): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()), flush=True)


# What config 4a's 8-spp render cost through the earlier design (kernels
# over [R, n] realizations made by int64 hash glue, one dispatch and host
# sync per chunk), as PERF.md records it from runs of this script on an
# NVIDIA H100 80GB HBM3 at 700 W
WS_BEFORE = {
    "K5": "29 K5 launches, 114 host syncs, ws_realization 0.763 of 865.2 ms "
          "of device time, peak 6.95 GiB (PERF.md)",
    "K4": "122 K4 launches, 899.0 ms of device time (PERF.md; host syncs "
          "and the range's share not recorded)"}


def ws_realization_runs(trender, wst, searches, scenes, dev, card_line,
                        twins=False):
    """Config 4a at 128x128 and 8 spp, both step sizes, each under
    torch.profiler: prints the render's host syncs, the device time and
    share of the profiler range "ws_realization", peak device memory, and
    searches and launches.  Through the one-launch kernels it fails unless
    the range holds no time, peak memory stays below WS_OLD_PEAK_GIB, and
    each search was one launch with no host sync; beside it stand the
    earlier design's recorded numbers (WS_BEFORE).  With `twins`, the
    renders go through the plain twins instead, which keep the earlier
    design's structure (each realization made as [R, n] tensors inside the
    range, one host sync per 32-step or 16-iteration chunk; their chunks
    are plain PyTorch, so their device time and peak memory exceed the
    earlier kernels')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    for (what, sc), name in zip(scenes, WS_FNS):
        fn = WS_FNS[name]
        wrapped = getattr(wst, fn)
        if twins:
            setattr(wst, fn, getattr(wst, fn + "_ref"))
        searches.reset()
        wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                syncs = host_syncs(lambda: trender.render(sc, 8, device=dev))
        finally:
            setattr(wst, fn, wrapped)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        events = prof.key_averages()
        dev_ms = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)) / 1e3
        synth_ms = sum(e.device_time_total for e in events
                       if e.key == "ws_realization"
                       and e.device_type == DeviceType.CPU) / 1e3
        label = ("the plain twins' [R, n] synthesis and chunk loop" if twins
                 else "one K5/K4 launch per search")
        print(f"{what}, 8 spp, {label}: host syncs {syncs}; "
              f"ws_realization {synth_ms:.1f} ms of device time "
              f"({synth_ms / max(dev_ms, 1e-9):.3f} of {dev_ms:.1f} ms); "
              f"peak device memory {peak:.2f} GiB ({card_line})", flush=True)
        if twins:
            continue
        print(f"{what}, 8 spp, the earlier design as recorded: "
              f"{WS_BEFORE[name]}", flush=True)
        searches.check(name, what)
        if synth_ms > 0 or peak >= WS_OLD_PEAK_GIB:
            raise RuntimeError(f"{what} still synthesises [R, n] "
                               "realizations on the card")


def profile_render(trender, what, scene, spp, mod, counter, kernel, label,
                   table_name, dev, card_line, wrapper, work):
    """Where a 128x128 render spends its time: walls and launches of the
    kernel (counted by mod.<counter>) of two runs, host syncs of a third,
    and one run under torch.profiler (op table in chiprun_out/), with the
    kernel's bound over that run: the points its wrapper mod.<wrapper> was
    called on, each with the bytes and instructions of `work`."""
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
    b_ms, _, b_cls = bound_ms(*per_points(work, points[0]))
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
          f"({b_cls}); cudaLaunchKernel x{n_launch} "
          f"({n_launch / max(n_k, 1):.1f} per {label} launch), "
          f"{sum(e.cpu_time_total for e in launch) / 1e3:.1f} ms host "
          f"({card_line}); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in top)
          + f"; table in {table}", flush=True)
    if dev_ms <= 0 or k_ms <= 0:
        raise RuntimeError(f"the profiler saw no device time for {what}")
    check_bound(f"{label} over the {what} render", k_ms, b_ms)


def profile_ws_step(entry, searches, load_scene, what, path, dev,
                    card_line, name):
    """One config-4a training step at 128x128, 8 spp under torch.profiler:
    wall, device time and busy share, the search kernel's device time
    against its bound over the step's searches (`searches`, WsSearches),
    and the top kernels (op table in OUT_DIR)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    scene, _ = load_scene(path, res_override=(128, 128), device=dev)
    spp_idx = torch.arange(8, device=dev)
    target = torch.zeros(128, 128, 3, device=dev)
    walls = [timed(lambda: entry.train_step(scene, target, spp_idx))
             for _ in range(2)]
    searches.reset()
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed(lambda: entry.train_step(scene, target, spp_idx))
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    kernel = "ws_march_kernel" if name == "K5" else "ws_trace_kernel"
    k_ms = sum(e.self_device_time_total for e in kern
               if kernel in e.key) / 1e3
    b_ms, _, b_cls, rays, steps = searches.bound(name, 1024)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    launch = [e for e in events if e.key.startswith("cudaLaunchKernel")]
    table = profile_table(prof, f"profile_grad_step_{name}.txt")
    print(f"{what} training step (128x128, 8 spp) under torch.profiler: wall "
          f"{wall * 1e3:.1f} ms (unprofiled {walls[0] * 1e3:.1f}, "
          f"{walls[1] * 1e3:.1f} ms), device {dev_ms:.1f} ms (busy "
          f"{dev_ms / (wall * 1e3):.3f} of the profiled wall); {name} "
          f"{k_ms:.2f} ms over {searches.calls[name]} searches of "
          f"{rays:.0f} rays and {steps:.0f} steps, bound {b_ms:.3f} ms "
          f"({b_cls}); kernels on the card x{sum(e.count for e in kern)}, "
          f"cudaLaunchKernel x{sum(e.count for e in launch)} ({card_line});"
          " top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in top)
          + f"; table in {table}", flush=True)
    if k_ms <= 0:
        raise RuntimeError(f"the profiler saw no device time for {name}")
    check_bound(f"{name} over {what}'s training step", k_ms, b_ms)


def k1b_inputs(n, dev, seed=5):
    """n random points, seeds and cotangents of K1b, made with numpy."""
    r = np.random.default_rng(seed)
    p = torch.from_numpy(r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32))
    sd = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                          .astype(np.int64))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    return p.to(dev), sd.to(dev), g.to(dev)


def bwd_checks(name, launch, twin, kernel, sizes, work, part_names, rtols,
               card_line, per_point=None, control=None):
    """A backward kernel against its twin (`twin(n)`) at each of `sizes`.
    With per_point None, `launch(n)` -> (d [n, ...], the parameters'
    partials summed over points, float32), the sums within rtols[1] float32
    ulps of the twin's, and a second launch must repeat both bit for bit
    (the sums are deterministic and the ticket was reset); with per_point
    k, `launch(n)` -> (d, per-point partials [n, P]), whose first k columns
    count with d and whose others are summed over points here (in float64),
    the sums within rtols[1] relative.  d within rtols[0] * (1 + |x|) per
    point (0: bit-equal).  With `kernel`, each size timed beside its bound
    by the kernel's device time (a CUDA-event window around a launch this
    short holds mostly the wrapper's host work), and `control(n)`, the twin
    summing in float32, read against the twin (printed).  Returns (max
    |kernel - twin| of d and the per-point partials, {n: (device ms, twin
    ms, bound ms, by, class)})."""
    err, times = 0.0, {}
    for n in sizes:
        d, second = launch(n)
        d_t, second_t = twin(n)
        again = launch(n) if per_point is None else None
        torch.cuda.synchronize()
        if not bool(torch.isfinite(d).all() and torch.isfinite(second).all()):
            raise RuntimeError(f"{name} returned non-finite values")
        if per_point is None:
            if not (torch.equal(again[0], d)
                    and torch.equal(again[1], second)):
                raise RuntimeError(f"{name} N={n}: two launches on the same "
                                   "inputs differ")
            s = second.double().reshape(-1)
            s_t = second_t.double().reshape(-1)
            d, d_t = d.reshape(n, -1), d_t.reshape(n, -1)
            srel = f32_ulps(second, second_t)
            unit = "float32 ulps"
        else:
            s = second[:, per_point:].sum(dim=0, dtype=torch.float64)
            s_t = second_t[:, per_point:].sum(dim=0, dtype=torch.float64)
            d = torch.cat([d.reshape(n, -1), second[:, :per_point]], dim=1)
            d_t = torch.cat([d_t.reshape(n, -1), second_t[:, :per_point]],
                            dim=1)
            srel = float(((s - s_t).abs() / s_t.abs().clamp(min=1e-30))
                         .max())
            unit = "relative"
        rel = float(((d - d_t).abs() / (1.0 + d_t.abs())).max())
        err = max(err, float((d - d_t).abs().max()))
        if rel > rtols[0] or srel > rtols[1]:
            raise RuntimeError(f"{name} disagrees with its twin at N={n}: "
                               f"{rel:.3e} of 1 + |x|, sums {srel:.3e} "
                               f"{unit}")
        same = "repeated launches bit-equal, " if per_point is None else ""
        if kernel is None:
            print(f"{name} N={n}: within {rel:.2e} * (1 + |x|) "
                  f"({rtols[0]}), {same}sums of the partials in {part_names}"
                  f" within {srel:.2e} {unit} ({rtols[1]})", flush=True)
            continue
        ctl = ""
        if control is not None:
            crel = f32_ulps(control(n)[1], second_t)
            verdict = "rejected" if crel > rtols[1] else "NOT rejected"
            ctl = (f"; float32-accumulation control {crel:.0f} {unit} from "
                   f"the twin's sums ({verdict} by the limit)")
        t_w = median_ms(lambda: launch(n))
        t_k = kernel_device_ms(lambda: launch(n), kernel)
        t_p = median_ms(lambda: twin(n), reps=5)
        b_ms, b_by, b_cls = bound_ms(*per_points(work, n))
        check_bound(f"{name} N={n}", t_k, b_ms)
        times[n] = (t_k, t_p, b_ms, b_by, b_cls)
        old = ""
        if name in OLD_WORK:
            o_ms = OLD_WORK[name] * n / (SM_ISSUE * SMS * CLOCK) * 1e3
            old = (f"; the old design's work ({OLD_WORK[name]} instructions "
                   f"a point, issue): {o_ms:.4f} ms, {o_ms / t_k:.3f} of it "
                   "(for information)")
        print(f"{name} K=3 N={n}: within {rel:.2e} * (1 + |x|) ({rtols[0]}),"
              f" max |kernel - twin| {err:.3e}, {same}sums of the partials "
              f"in {part_names} {[round(v, 6) for v in s.tolist()]} within "
              f"{srel:.2e} {unit} ({rtols[1]}); kernel {t_k:.4f} ms of "
              f"device time "
              f"(mean of 20, torch.profiler), wrapper call {t_w:.4f} ms "
              f"(median of 20) and twin {t_p:.4f} ms (median of 5; CUDA "
              f"events; {card_line}); bound {b_ms:.4f} ms ({b_cls}), "
              f"{b_ms / t_k:.3f} of it{old}{ctl}", flush=True)
    return err, times


def f32_ulps(a, b):
    """Largest |a - b| over float32 tensors a and b, in float32 ulps of b
    (the step from b towards +inf)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = torch.nextafter(b, torch.full_like(b, float("inf"))) - b
    return float(((a.double() - b.double()).abs() / step.double()).max())


def device_kernels(fn, tries=3):
    """{kernel: [launches, device ms]} the card ran for one call of fn(),
    after a warm-up call (torch.profiler).  A window in which the profiler
    recorded no kernel at all is profiled again, up to `tries` times; {}
    when none recorded one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ran = {e.key: [e.count, e.self_device_time_total / 1e3]
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)}
        if ran:
            return ran
    return {}


def backward_kernels(name, fn, kernel, mod, counter):
    """One call of fn(), a backward through autograd, must be one launch
    of `kernel`: its wrapper's count `mod.counter` must rise by one, and
    the kernels the card ran (torch.profiler) must be that one launch and
    nothing else.  Where the profiler recorded no kernel in any window,
    the count alone holds it, and the run says so."""
    before = getattr(mod, counter)
    fn()
    torch.cuda.synchronize()
    launched = getattr(mod, counter) - before
    ran = device_kernels(fn)
    print(f"{name}'s backward through autograd: {launched} launch(es) by "
          f"its wrapper's count {counter}; ran on the card: "
          f"{ran or 'nothing the profiler recorded (the count holds it)'}",
          flush=True)
    if launched != 1:
        raise RuntimeError(f"{name}'s backward made {launched} launches of "
                           f"{kernel}, not one")
    if ran and (sum(c for c, _ in ran.values()) != 1
                or not any(kernel in k for k in ran)):
        raise RuntimeError(f"{name}'s backward is not one launch of {kernel}:"
                           f" {ran}")


def k1b_checks(noise3d, cov, K, work, dev, card_line):
    """K1b against its twin at K1B_POINTS (fresh points, seeds and
    cotangents per size) with config 1's cell radius and splat form, timed;
    untimed at ODD_POINTS and with MANY_K impulses per cell (more
    within reach than the ring holds); then one backward through autograd
    must be one launch."""
    host = noise3d.host_params(cov.splat_radius(), cov.splat_form())
    kr, m3 = host[0], host[1:]
    inputs = {n: k1b_inputs(n, dev)
              for n in (*ODD_POINTS, *K1B_POINTS)}

    def check(sizes, K, kernel):
        def args(n):
            p, sd, g = inputs[n]
            return p, sd, kr, m3, K, g
        return bwd_checks(
            f"K1b K={K}" if kernel is None else "K1b",
            lambda n: noise3d.noise3d_sum_s_bwd(*args(n)),
            lambda n: noise3d.noise3d_sum_s_bwd_ref(*args(n)), kernel, sizes,
            work, "(kr, m00, m11, m22)", (K1B_DP_RTOL, K1B_SUM_ULPS),
            card_line, control=lambda n: noise3d.noise3d_sum_s_bwd_ref(
                *args(n), sum_dtype=torch.float32))
    check(ODD_POINTS, K, None)
    check((K1B_LINE_POINTS,), MANY_K, None)
    p, sd, g = inputs[K1B_LINE_POINTS]
    leaves = (p.clone().requires_grad_(),
              torch.tensor(kr, device=dev, requires_grad=True),
              torch.tensor(m3, device=dev, requires_grad=True))
    out = noise3d.noise3d_sum_s_diff(leaves[0], sd, leaves[1], leaves[2], K,
                                     host)
    backward_kernels("K1b", lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), "noise3d_sum_s_bwd_kernel",
        noise3d, "K1B_LAUNCHES")
    return check(K1B_POINTS, K, "noise3d_sum_s_bwd_kernel")


def k3b_checks(noise1d, work, dev, card_line):
    """K3b against its twin at K3_POINTS random iso-ray coordinates and
    seeds (those of k3_checks; each size a prefix) with config 3's cell
    radius and a random cotangent, timed; untimed at ODD_POINTS and
    with K = 1 and MANY_K (the runtime-K kernel); then one backward
    through autograd must be one launch."""
    rs = np.random.default_rng(3)
    n_max = max(K3_POINTS)
    pz = torch.from_numpy(rs.uniform(-40.0, 40.0, n_max).astype(
        np.float32)).to(dev)
    seed = torch.from_numpy(rs.integers(0, 2 ** 32, n_max, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    g = torch.from_numpy(rs.normal(size=n_max).astype(np.float32)).to(dev)

    def check(sizes, K, kernel):
        def args(n):
            return pz[:n], seed[:n], 3.0, K, g[:n]
        return bwd_checks(
            f"K3b K={K}" if kernel is None else "K3b",
            lambda n: noise1d.noise1d_sum_bwd(*args(n)),
            lambda n: noise1d.noise1d_sum_bwd_ref(*args(n)), kernel, sizes,
            work, "kr", (K3B_DP_RTOL, K3B_SUM_ULPS), card_line,
            control=lambda n: noise1d.noise1d_sum_bwd_ref(
                *args(n), sum_dtype=torch.float32))
    check(ODD_POINTS, 3, None)
    for K in (1, MANY_K):
        check((K3B_LINE_POINTS,), K, None)
    n = K3B_LINE_POINTS
    leaves = (pz[:n].clone().requires_grad_(),
              torch.tensor(3.0, device=dev, requires_grad=True))
    out = noise1d.noise1d_sum_diff(leaves[0], seed[:n], leaves[1], 3)
    backward_kernels("K3b", lambda: torch.autograd.grad(
        out, leaves, g[:n], retain_graph=True), "noise1d_sum_bwd_kernel",
        noise1d, "K3B_LAUNCHES")
    return check(K3_POINTS, 3, "noise1d_sum_bwd_kernel")


def k2b_checks(noise3d, base, work, dev, card_line):
    """K2b against its twin at K2_POINTS with the points, seeds and levels
    of k2_checks (each size a prefix), the hero's splat form and a random
    cotangent: K = 1 at each size untimed, then K = 3 timed
    (bwd_checks)."""
    m3 = base.splat_form().tolist()
    p, seed, kr, qm = k2_inputs(base, max(K2_POINTS), dev)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=max(K2_POINTS)).astype(np.float32)).to(dev)

    def args(n, K=3):
        return p[:n], seed[:n], kr[:n], qm[:n], m3, K, g[:n]
    bwd_checks("K2b K=1", lambda n: noise3d.noise3d_sum_bwd(*args(n, 1)),
               lambda n: noise3d.noise3d_sum_bwd_ref(*args(n, 1)), None,
               K2_POINTS, None, "(m00, m11, m22)", (K2B_RTOL, K2B_SUM_RTOL),
               card_line, per_point=2)
    return bwd_checks(
        "K2b", lambda n: noise3d.noise3d_sum_bwd(*args(n)),
        lambda n: noise3d.noise3d_sum_bwd_ref(*args(n)),
        "noise3d_sum_bwd_kernel", K2_POINTS, work, "(m00, m11, m22)",
        (K2B_RTOL, K2B_SUM_RTOL), card_line, per_point=2)


def fan_rays(spec, dev):
    """The rays of a medium-level gradient test (`spec`, an entry of
    MEDIUM_RAYS) on `dev`: (ro, rd, near, far, pss, u_jitter, active)."""
    R, origin, half, dy, near, far = spec[:6]
    ths = np.linspace(-half, half, R, dtype=np.float32)
    ro = np.tile(np.array([origin], np.float32), (R, 1))
    rd = np.stack([np.sin(ths), np.zeros(R, np.float32) + dy,
                   -np.cos(ths)], axis=-1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    pss = np.stack([np.arange(R), np.zeros(R), np.zeros(R), np.zeros(R)],
                   axis=-1).astype(np.int64)
    return (*(torch.from_numpy(a).to(dev) for a in (
        ro, rd, np.full(R, near, np.float32), np.full(R, far, np.float32),
        pss)), torch.full((R,), 0.5, device=dev),
        torch.ones(R, dtype=torch.bool, device=dev))


def medium_grad(md, convert, entry, scene, dev, spec, weights=None):
    """d sum(w t) / d(sigma, l) of a scene's sample_distance on the rays of
    the medium-level gradient test for it (`spec`, an entry of
    MEDIUM_RAYS; w = +-1 per ray from `weights`, "+" and "-", or 1), over
    the lanes that hit at every FD evaluation, and its central FD: returns
    (dsigma, dl, FD dsigma, FD dl, stable lanes)."""
    R, eps = spec[0], spec[-1]
    eps_s, eps_l = eps if isinstance(eps, tuple) else (eps, eps)
    w_ray = torch.tensor([-1.0 if c == "-" else 1.0
                          for c in (weights or "+" * R)], device=dev)
    ro, rd, near, far, pss, uj, active = fan_rays(spec, dev)
    args, rest = (ro, rd, near, far), (pss, uj, active)

    def crossing(sigma, l):
        med = convert.set_params(scene, sigma, l).media[0]
        res, _ = md.sample_distance(med, scene.scene_seed, *args,
                                    md.MediumState.make(R, dev), *rest)
        return res

    sigma0, l0 = (float(x) for x in entry.params(scene))

    def val(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    with torch.no_grad():
        stable = torch.ones(R, dtype=torch.bool, device=dev)
        for ds, dl in ((0, 0), (eps_s, 0), (-eps_s, 0), (0, eps_l),
                       (0, -eps_l)):
            stable &= ~crossing(val(sigma0 + ds), val(l0 + dl))["exited"]
        w = torch.where(stable, w_ray, 0.0)

        def f(s, l):
            return float((w * crossing(val(s), val(l))["t"]).sum())
        fd_s = (f(sigma0 + eps_s, l0) - f(sigma0 - eps_s, l0)) / (2 * eps_s)
        fd_l = (f(sigma0, l0 + eps_l) - f(sigma0, l0 - eps_l)) / (2 * eps_l)
    sigma = val(sigma0).requires_grad_()
    l = val(l0).requires_grad_()
    loss = (w * crossing(sigma, l)["t"]).sum()
    gs, gl = torch.autograd.grad(loss, (sigma, l))
    return float(gs), float(gl), fd_s, fd_l, stable.cpu()


def ws_lane_grads(md, convert, scene, cpu_scene, dev, spec):
    """Per-lane d t / d(sigma, l) of a weight-space scene's sample_distance
    on the card, and on the CPU with the card's search result (hit, t, the
    kernel's gradient) fed into the CPU's reattachment
    (`media._ws_reattach`): ([R, 2] card, [R, 2] CPU, hit [R]), both on the
    CPU."""
    R = spec[0]
    ro, rd, near, far, pss, uj, active = fan_rays(spec, dev)
    params = [torch.tensor(float(x), device=dev).requires_grad_()
              for x in (scene.media[0].gp.cov.sigma, scene.media[0].gp.cov.l)]
    med = convert.set_params(scene, *params).media[0]
    state = md.MediumState.make(R, dev)
    res, _ = md.sample_distance(med, scene.scene_seed, ro, rd, near, far,
                                state, pss, uj, active)
    with torch.no_grad():
        hit, t_k, grad_k, _, _ = md._crossing_ws(
            md.detach(med), scene.scene_seed, ro, rd, near,
            md._far_eff(med, ro, rd, near, far).detach(), state, pss, uj,
            active)
    cpu_params = [x.detach().cpu().requires_grad_() for x in params]
    cpu_med = convert.set_params(cpu_scene, *cpu_params).media[0]
    t_c, _ = md._ws_reattach(cpu_med, ro.cpu(), rd.cpu(), t_k.cpu(),
                             hit.cpu(), grad_k.cpu(), pss.cpu())
    if not torch.equal(res["t"].detach().cpu(), t_k.cpu()):
        raise RuntimeError("the card's sample_distance and its search found "
                           "other crossings")

    def grads(y, xs):  # a grazing lane (no IFT step) has none
        if not y.requires_grad:
            return torch.zeros(len(xs))
        return torch.stack([torch.zeros(()) if g is None else g.cpu()
                            for g in torch.autograd.grad(
                                y, xs, retain_graph=True,
                                allow_unused=True)])

    card, cpu = torch.zeros(R, 2), torch.zeros(R, 2)
    for i in torch.nonzero(hit.cpu()).squeeze(1).tolist():
        card[i] = grads(res["t"][i], params)
        cpu[i] = grads(t_c[i], cpu_params)
    return card, cpu, hit.cpu()


def grad_checks(md, convert, entry, load_scene, dev, what, path,
                fd_gate=True, lanes=False):
    """A scene's medium-level gradient on the card against central FD and
    against the port on the CPU within MEDIUM_CPU_RTOL (without `fd_gate`,
    FD is printed, not held; with `lanes`, a weight-space scene, the CPU is
    held per lane by `ws_lane_grads`)."""
    spec, weights = MEDIUM_RAYS[MEDIUM_SPEC.get(what, what)], \
        MEDIUM_WEIGHTS.get(what)
    R, eps = spec[0], spec[-1]
    scene, _ = load_scene(path, device=dev)
    gs, gl, fd_s, fd_l, stable = medium_grad(md, convert, entry, scene, dev,
                                             spec, weights)
    cpu_scene, _ = load_scene(path, device="cpu")
    c_gs, c_gl, _, _, c_stable = medium_grad(md, convert, entry, cpu_scene,
                                             "cpu", spec, weights)
    loss = "sum(w t)" if weights else "sum(t)"
    print(f"{what} medium-level d {loss} / d(sigma, l) on "
          f"{int(stable.sum())} of {R} rays: card ({gs:.5f}, {gl:.5f}), "
          f"central FD at eps {eps} ({fd_s:.5f}, {fd_l:.5f}), CPU "
          f"({c_gs:.5f}, {c_gl:.5f})", flush=True)
    if not torch.equal(stable, c_stable) or int(stable.sum()) < R // 2:
        raise RuntimeError(f"{what}: the card and the CPU disagree on the "
                           "stable lanes, or fewer than half of the lanes "
                           "are stable")
    for name, ad, fd, cpu in (("dsigma", gs, fd_s, c_gs),
                              ("dl", gl, fd_l, c_gl)):
        if ad == 0.0 or fd_gate and abs(ad - fd) > (
                MEDIUM_FD_ATOL + MEDIUM_FD_RTOL * abs(fd)):
            raise RuntimeError(f"{what}: medium-level {name} {ad} is not "
                               f"within rtol {MEDIUM_FD_RTOL}, atol "
                               f"{MEDIUM_FD_ATOL} of FD {fd}")
        if not lanes and abs(ad - cpu) > MEDIUM_CPU_RTOL * abs(cpu):
            raise RuntimeError(f"{what}: medium-level {name} on the card {ad}"
                               f" is not within {MEDIUM_CPU_RTOL} of the "
                               f"CPU's {cpu}")
    if lanes:
        card, cpu, hit = ws_lane_grads(md, convert, scene, cpu_scene, dev,
                                       spec)
        floor = cpu[hit].abs().mean(dim=0)
        err = ((card - cpu).abs() / (cpu.abs() + floor))[hit]
        print(f"{what}: per-lane d t / d(sigma, l) on {int(hit.sum())} hit "
              f"lanes, the card's search fed to the CPU's reattachment: "
              f"max |card - CPU| / (|CPU| + mean |CPU|) = "
              f"({float(err[:, 0].max()):.3e}, {float(err[:, 1].max()):.3e})"
              f" (limit {MEDIUM_CPU_RTOL})", flush=True)
        if int(hit.sum()) < R // 2 or float(err.max()) > MEDIUM_CPU_RTOL:
            raise RuntimeError(f"{what}: the card's per-lane gradient is not "
                               f"within {MEDIUM_CPU_RTOL} of the CPU's")


def two_segments(md, med, scene_seed, rays):
    """sample_distance along the rays (fan_rays), then on from each first
    crossing in the same direction in a second segment, which renewal+
    conditions at its start on the first crossing's value and normal:
    (first result, second result)."""
    ro, rd, near, far, pss, uj, active = rays
    R = ro.shape[0]
    r1, st = md.sample_distance(med, scene_seed, ro, rd, near, far,
                                md.MediumState.make(R, ro.device), pss, uj,
                                active)
    r2, _ = md.sample_distance(
        med, scene_seed, ro + r1["t"][:, None] * rd, rd, torch.zeros_like(near),
        torch.full_like(far, 3.0), st,
        pss + torch.tensor([0, 0, 0, 1], device=pss.device), uj,
        ~r1["exited"])
    return r1, r2


def variant_run(md, convert, scene, dev, spec, segments, sigma, l):
    """sample_distance over a variant's fan of rays (fan_rays), in one
    segment or two (`two_segments`): a list of the results."""
    rays = fan_rays(spec, dev)
    med = convert.set_params(scene, sigma, l).media[0]
    if segments == 2:
        return list(two_segments(md, med, scene.scene_seed, rays))
    ro, rd, near, far, pss, uj, active = rays
    res, _ = md.sample_distance(med, scene.scene_seed, ro, rd, near, far,
                                md.MediumState.make(ro.shape[0], dev), pss,
                                uj, active)
    return [res]


def lane_grads(md, convert, entry, scene, dev, spec, segments):
    """Each lane's d(t1 + t2) / d(sigma, l) (one backward a lane), its
    t1 + t2 and whether it hit in every segment: ([R, 2], [R], [R]) on
    the CPU."""
    sigma, l = (x.detach().clone().requires_grad_()
                for x in entry.params(scene))
    res = variant_run(md, convert, scene, dev, spec, segments, sigma, l)
    t = sum(r["t"] for r in res)
    hit = torch.ones_like(res[0]["exited"])
    for r in res:
        hit &= ~r["exited"]
    ad = torch.zeros(t.shape[0], 2)
    for i in range(t.shape[0]):
        if t[i].requires_grad:
            ad[i] = torch.stack(torch.autograd.grad(
                t[i], (sigma, l), retain_graph=True)).cpu()
    return ad, t.detach().cpu(), hit.cpu()


def two_segment_grad_checks(md, convert, entry, load_scene, dev, what, path):
    """A renewal scene's two-segment medium-level gradient d sum(t1 + t2) /
    d(sigma, l) on the card against central FD over the lanes FD resolves
    (`fd_lanes` at eps and eps / 4, FD at eps / 4) and against the port
    on the CPU over the same lanes (each lane's partial from
    `lane_grads`)."""
    from tungsten_tpu_torch.utils.fd import fd_lanes
    spec = MEDIUM_RAYS[what]
    R, eps = spec[0], spec[-1]
    scenes = {d: load_scene(path, device=d)[0] for d in (dev, "cpu")}
    grads = {d: lane_grads(md, convert, entry, scenes[d], d, spec, 2)
             for d in (dev, "cpu")}
    params = tuple(float(v) for v in entry.params(scenes[dev]))
    for i, name in enumerate(("dsigma", "dl")):
        lanes, fd = fd_lanes(lambda s, l: variant_run(
            md, convert, scenes[dev], dev, spec, 2, s, l), params, i, eps,
            dev, n_steps=2)
        lanes &= grads[dev][2]
        fd = float(torch.where(lanes, fd, 0.0).sum())
        g, g_cpu = (float(grads[d][0][lanes, i].sum()) for d in (dev, "cpu"))
        print(f"{what} two-segment medium-level d sum(t1 + t2) / {name[1:]}"
              f" on the {int(lanes.sum())} of {R} lanes FD resolves: card "
              f"{g:.5f}, central FD at eps {eps / 4:g} {fd:.5f}, CPU "
              f"{g_cpu:.5f}", flush=True)
        if int(lanes.sum()) < R // 4:
            raise RuntimeError(f"{what}: FD resolves fewer than {R // 4} "
                               "lanes")
        if g == 0.0 or abs(g - fd) > MEDIUM_FD_ATOL + MEDIUM_FD_RTOL * abs(
                fd):
            raise RuntimeError(f"{what}: medium-level {name} {g} is not "
                               f"within rtol {MEDIUM_FD_RTOL}, atol "
                               f"{MEDIUM_FD_ATOL} of FD {fd}")
        if abs(g - g_cpu) > MEDIUM_CPU_RTOL * abs(g_cpu):
            raise RuntimeError(f"{what}: medium-level {name} on the card {g}"
                               f" is not within {MEDIUM_CPU_RTOL} of the "
                               f"CPU's {g_cpu}")


def ws_image_grad_check(entry, convert, load_scene, dev, card_line):
    """tests/test_grad_e2e.py::test_image_grad_allclose_fd for config 4a in
    the port: a 24x24 image averaged over 16 passes with the isotropic
    phase in place of the BRDF one (FD sees the scattered direction turn
    with the normal, which the detached-sampling estimator leaves out);
    over the pixels linear in the parameter across the FD stencil, AD of
    their sum within rtol 0.15, atol 2e-2 of central FD, in sigma at eps
    1e-3 and in l at eps 1e-5."""
    import dataclasses
    from tungsten_tpu_torch.models.integrator import render_pass
    base, _ = load_scene(WS_SCENE, res_override=(24, 24), device=dev)
    base = dataclasses.replace(base, media=(dataclasses.replace(
        base.media[0], phase_kind="isotropic"),))
    spp = torch.arange(16, device=dev)

    def img(sigma, l):
        return render_pass(convert.set_params(base, sigma, l),
                           spp).sum(-1) / 16

    x0 = [float(v) for v in entry.params(base)]

    def val(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    with torch.no_grad():
        i0 = img(val(x0[0]), val(x0[1]))
    for i, name, eps in ((0, "sigma", 1e-3), (1, "l", 1e-5)):
        xp, xm = list(x0), list(x0)
        xp[i] += eps
        xm[i] -= eps
        with torch.no_grad():
            ip, im = img(*map(val, xp)), img(*map(val, xm))
        lin = (ip + im - 2.0 * i0).abs()
        d1 = (ip - im).abs()
        m = (lin < 0.35 * d1 + 1e-4) & (d1 > 1e-6)
        leaves = [val(v).requires_grad_() for v in x0]
        ad = float(torch.autograd.grad(
            torch.where(m, img(*leaves), 0.0).sum(), leaves[i])[0])
        fd = float((torch.where(m, ip, 0.0).sum()
                    - torch.where(m, im, 0.0).sum()) / (2 * eps))
        print(f"config 4a image-level d/d{name} (24x24, 16 passes, isotropic "
              f"phase) over {int(m.sum())} event-linear pixels: AD {ad:.5f},"
              f" central FD at eps {eps} {fd:.5f} ({card_line})", flush=True)
        if int(m.sum()) < 24:
            raise RuntimeError(f"config 4a: only {int(m.sum())} event-linear "
                               "pixels")
        if not (np.isfinite(ad) and abs(ad) > 1e-5
                and abs(ad - fd) <= 2e-2 + 0.15 * abs(fd)):
            raise RuntimeError(f"config 4a: image-level d/d{name} {ad} is "
                               f"not within rtol 0.15, atol 2e-2 of FD {fd}")


def fs_blocks(gpmod, cov, B, n, dev, seed):
    """B random conditioning blocks of the function-space normal's solve
    on the card ([B, n + 2, n + 2]: n values along a segment of length
    0.2-1.6 of a random ray, then the value and along-ray derivative at its
    end) and their cross covariances with the 3 derivative queries there
    ([B, n + 2, 3]), under the covariance `cov`."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-0.5, 0.5, (B, 3)) + np.array([0.0, 0.9, 0.0])
    rd = r.normal(size=(B, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ts = np.linspace(0.0, 1.0, n)[None] * r.uniform(0.2, 1.6, (B, 1))
    pts = ro[:, None] + ts[..., None] * rd[:, None]
    rows = np.concatenate([pts, pts[:, -1:], pts[:, -1:]], axis=1)
    tg = np.cross(rd, r.normal(size=(B, 3)))
    tg /= np.linalg.norm(tg, axis=-1, keepdims=True)
    qd = np.stack([tg, np.cross(rd, tg), rd], axis=1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    dirs = t(np.broadcast_to(rd[:, None], rows.shape))
    kinds = torch.tensor([0] * (n + 1) + [1], device=dev)
    qk = torch.ones(3, dtype=torch.int64, device=dev)
    a = gpmod.cov_matrix(cov, t(rows), kinds, dirs, t(rows), kinds, dirs)
    b = gpmod.cov_matrix(cov, t(rows), kinds, dirs,
                         t(np.broadcast_to(pts[:, -1:], (B, 3, 3))), qk,
                         t(qd))
    return a.contiguous(), b.contiguous()


# K8: what a round of its fused pass needs, read off csrc/psd.cu as K5's
# and K4's operations are, per real pair (p, q) (n // 2 of them; for odd n
# the pair holding the padding index rotates nothing), each float32 or
# float64 operation and each shared-memory access counted as issued:
# - an off-diagonal 2x2 block of A between two pairs: 4 float32 entries
#   read and written once (A is kept as its upper triangle), 32 bytes; the
#   row and the column rotation, 8 FMUL and 4 FADD each;
# - for odd n, the unpaired index's 2 entries with a pair: one rotation,
#   16 bytes, 4 FMUL and 2 FADD;
# - a row of V against a pair: 2 float64 entries read and written, 32
#   bytes; 4 DMUL and 2 DADD;
# - the pair's rotation and diagonal block: a_pp, a_qq, a_pq read and
#   written, 24 bytes; tau, t, c, s and the two diagonal entries in
#   float64, 16 operations with each divide and square root as one.
# The earlier design (separate row and column passes over A, each entry
# of A read and written twice a round) counted 64 bytes, 30 issued, 12
# FP32 and 6 FP64 operations per pair-element (a pair and one of the n
# indices); this one, at n = 34, (4,760 + 18,496) / 578 = 40.2 bytes,
# 18.2 issued, 5.6 FP32 and 6.5 FP64.  The SASS issues more (the addresses,
# the guards, the rotation parameters' loads): printed beside, from
# sass.jacobi_counts.
K8_BLOCK = {"issue": 8 + 24, "fma": 24, "shared": 32}
K8_EDGE = {"issue": 4 + 6, "fma": 6, "shared": 16}
K8_V_UNIT = {"issue": 4 + 6, "fp64": 6, "shared": 32}
K8_ROTATION = {"issue": 6 + 16, "fp64": 16, "shared": 24}


def k8_work(n, sweeps, batch):
    """(bytes, {class: operations}) of K8 on `batch` matrices of size n
    that took `sweeps` sweeps in all: each sweep m - 1 rounds (m = n
    rounded up to even), each round n // 2 pairs, their off-diagonal
    blocks, V's rows against them and, for odd n, the unpaired index's
    entries, at K8_BLOCK, K8_V_UNIT, K8_ROTATION and K8_EDGE."""
    m, pairs = n + (n & 1), n // 2
    rounds = sweeps * (m - 1)
    parts = ((K8_BLOCK, pairs * (pairs - 1) // 2), (K8_EDGE, pairs * (n & 1)),
             (K8_V_UNIT, n * pairs), (K8_ROTATION, pairs))
    work = {}
    for cost, count in parts:
        for c, k in cost.items():
            work[c] = work.get(c, 0) + rounds * count * k
    return batch * (8 * n * n + 4 * n + 4), work


def k8_against_twin(psd, gpmod, a, b, what, schur_gate=True):
    """K8 on the card against its twin (torch.linalg.eigh, run on the CPU)
    on matrices a [B, n, n] (and, given b [B, n, k], the product
    b^T pinv(a) b the conditioning subtracts), with the limits of
    tests/test_torch_gp.py.  Without `schur_gate` (Matern's blocks, whose
    spectra decay slowly through the pseudo-inverse's 1e-6 cutoff, so that
    in float32 the product is ill-posed for any eigensolver) the product
    is printed beside the twin's, each against float64 eigh of the same
    matrices, and not held.  Returns (max |w - twin's|, total sweeps, mean
    sweeps, max sweeps)."""
    n = a.shape[-1]
    w, v, sw = psd.eigh(a, sweeps=True)
    a_cpu = a.cpu()
    tw, tv = psd.eigh_ref(a_cpu)
    wmax = tw.abs().amax(-1).double().to(a.device)
    a64 = (0.5 * (a + a.transpose(1, 2))).double()
    v64 = v.double()
    recon = torch.matmul(v64 * w.double()[:, None, :], v64.transpose(1, 2))
    err_recon = ((recon - a64).abs().amax((1, 2)) / wmax).max()
    err_orth = (torch.matmul(v64.transpose(1, 2), v64)
                - torch.eye(n, dtype=torch.float64, device=a.device)).abs(
                    ).max()
    err_w = (w.double().cpu() - tw.double()).abs().amax(-1)
    err_eig = (err_w.to(a.device) / wmax).max()
    mine, twin = (lambda _: (w, v)), (lambda _: (tw, tv))
    root = psd.sqrt_psd(a, eigh_fn=mine).cpu()
    troot = psd.sqrt_psd(a_cpu, eigh_fn=twin)
    err_root = ((root - troot).abs().amax((1, 2)).double()
                / wmax.cpu().sqrt()).max()
    line = (f"{what}: {a.shape[0]} matrices {n}x{n}, sweeps mean "
            f"{float(sw.float().mean()):.2f} max {int(sw.max())}; max "
            f"|V W V^T - A| / max|w| {float(err_recon):.3e} (limit "
            f"{K8_RECON_TOL}), max |V^T V - I| {float(err_orth):.3e} "
            f"({K8_ORTH_TOL}), max |w - twin| / max|w| {float(err_eig):.3e} "
            f"({K8_EIG_TOL}), max |root - twin's| / sqrt(max|w|) "
            f"{float(err_root):.3e} ({K8_ROOT_RTOL})")
    bad = (err_recon > K8_RECON_TOL or err_orth > K8_ORTH_TOL
           or err_eig > K8_EIG_TOL or err_root > K8_ROOT_RTOL)
    if b is not None:
        bt = b.transpose(1, 2)
        got = torch.matmul(bt, torch.matmul(
            psd.pseudo_inverse(a, eigh_fn=mine), b)).cpu()
        b_cpu = b.cpu()
        want = torch.matmul(b_cpu.transpose(1, 2), torch.matmul(
            psd.pseudo_inverse(a_cpu, eigh_fn=twin), b_cpu))
        err_schur = ((got - want).abs().amax((1, 2))
                     / want.abs().amax((1, 2)).clamp(min=1e-30)).max()
        line += (f", max |b^T pinv(A) b - twin's| / max|twin's| "
                 f"{float(err_schur):.3e} ({K8_SCHUR_RTOL})")
        if schur_gate:
            bad = bad or err_schur > K8_SCHUR_RTOL
        else:
            a64 = a64.cpu()
            w64, v64 = torch.linalg.eigh(a64)
            ref = torch.matmul(b_cpu.double().transpose(1, 2), torch.matmul(
                psd.pseudo_inverse(a64, eigh_fn=lambda _: (w64, v64)),
                b_cpu.double()))

            def med(x):
                return float(((x.double() - ref).abs().amax((1, 2))
                              / ref.abs().amax((1, 2)).clamp(min=1e-30))
                             .median())
            line += (f" not held: against float64 eigh, median relative "
                     f"error K8 {med(got):.3e}, twin {med(want):.3e}")
    print(line, flush=True)
    if bad or not bool(torch.isfinite(w).all()):
        raise RuntimeError(f"K8 disagrees with its twin on {what}")
    return (float(err_w.max()), int(sw.sum()), float(sw.float().mean()),
            int(sw.max()))


def no_solver_kernels(prof):
    """The profiled run launched no cuSOLVER (or MAGMA) kernel and called
    no torch.linalg.eigh: raises otherwise."""
    from torch.autograd import DeviceType
    bad = [e.key for e in prof.key_averages()
           if any(w in e.key.lower() for w in SOLVER_WORDS)
           and (e.device_type == DeviceType.CUDA or "linalg" in e.key)]
    if bad:
        raise RuntimeError(f"a solver kernel or eigh ran: {bad}")


def fs_render_checks(trender, psd, gpmod, counters, scene, what, spp,
                     card_line):
    """A function-space render on the card under torch.profiler and the sync
    counter, with the launch counts at 0 just before: K8 alone, no solver
    kernel, K8's device time and share; returns (K8 launches, wall, host
    syncs, peak GiB)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        syncs = host_syncs(lambda: trender.render(scene, spp, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = check_counts(counters, ("K8",), what)
    no_solver_kernels(prof)
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in dev_ev) / 1e3
    k8 = sum(e.self_device_time_total for e in dev_ev
             if "jacobi_eigh_kernel" in e.key) / 1e3
    if not dev_ev:
        print(f"{what} under the profiler, {spp} spp: {wall:.3f} s "
              f"(profiled), K8 launches {counts['K8']}, largest launch "
              f"{psd.MOST_MATRICES} matrices, host syncs {syncs}, peak "
              f"device memory {peak:.2f} GiB; K8's device time and share "
              "not measured (the profiler recorded no device activity; the "
              f"launch count holds K8 alone) ({card_line})", flush=True)
        return counts["K8"], wall, syncs, peak
    if k8 <= 0.0:
        raise RuntimeError(f"{what}: the profiler saw no K8 device time")
    by_n = {}
    for e in dev_ev:
        inst = re.search(r"jacobi_eigh_kernel(?:<|ILi)(\d+)", e.key)
        if inst:
            n = int(inst.group(1)) or "other"
            ms, launches = by_n.get(n, (0.0, 0))
            by_n[n] = (ms + e.self_device_time_total / 1e3, launches + e.count)
    if not by_n:
        raise RuntimeError(f"{what}: no K8 instance named by its n")
    print(f"{what} under the profiler, {spp} spp: {wall:.3f} s (profiled), "
          f"K8 launches {counts['K8']}, largest launch {psd.MOST_MATRICES} "
          f"matrices, host syncs {syncs}, peak device memory {peak:.2f} GiB; "
          f"device time {total:.1f} ms, K8 {k8:.1f} ms ("
          + ", ".join(f"n = {n}: {ms:.1f} ms over {c} launches"
                      for n, (ms, c) in sorted(by_n.items(), key=str))
          + f"); no cuSOLVER kernel and no eigh ({card_line})", flush=True)
    return counts["K8"], wall, syncs, peak


class EighCapture:
    """Wraps K8's wrapper and the function-space solve, as the medium calls
    them, to keep the first `most` matrices of each size (and the
    normal's cross covariances with its conditioning blocks) that a render
    hands them; the launches stay the render's."""

    def __init__(self, psd, gpmod, most):
        self.psd, self.gpmod, self.most = psd, gpmod, most
        self.mats, self.pairs = {}, []
        self.eigh, self.solve = psd.eigh, gpmod.psd_solve

    def __enter__(self):
        def eigh(a, sweeps=False):
            n = a.shape[-1]
            have = sum(x.shape[0] for x in self.mats.get(n, []))
            if have < self.most:
                self.mats.setdefault(n, []).append(
                    a.reshape(-1, n, n)[:self.most - have].clone())
            return self.eigh(a, sweeps)

        def solve(a, b):
            have = sum(x[0].shape[0] for x in self.pairs)
            if have < self.most:
                self.pairs.append((a[:self.most - have].clone(),
                                   b[:self.most - have].clone()))
            return self.solve(a, b)

        self.psd.eigh, self.gpmod.psd_solve = eigh, solve
        return self

    def __exit__(self, *exc):
        self.psd.eigh, self.gpmod.psd_solve = self.eigh, self.solve

    def sets(self):
        """{size: [B, n, n]} and the normal's (blocks, cross covariances)."""
        mats = {n: torch.cat(v)[:self.most] for n, v in self.mats.items()}
        a = torch.cat([x[0] for x in self.pairs])[:self.most]
        b = torch.cat([x[1] for x in self.pairs])[:self.most]
        return mats, (a.contiguous(), b.contiguous())


def k8_library(a, k8_ms, card_line, what):
    """torch.linalg.eigh, the library call K8 stands beside, on a [B, n, n]
    on the card: (ms, kernel launches per call), printed beside K8's device
    time on the same input, k8_ms.  At n > 32 the library loops over the
    matrices, some 10^5 launches a call: the launches are counted from the
    profiler's raw device events of one warm call (its Python event table
    would take minutes to build), after every profile of K8."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    lib_ms = median_ms(lambda: torch.linalg.eigh(a), reps=3)
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.linalg.eigh(a)
        torch.cuda.synchronize()
    ran = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ran[e.name()] = ran.get(e.name(), 0) + 1
    copies = sum(c for k, c in ran.items() if k.startswith("Mem"))
    calls = sum(ran.values()) - copies
    print(f"{what}: torch.linalg.eigh {lib_ms:.3f} ms (median of 3, CUDA "
          f"events), {calls} kernel launches and {copies} memory copies a "
          "call: " + ", ".join(f"{k[:50]} x{c}" for k, c in sorted(
              ran.items(), key=lambda kv: -kv[1])[:6])
          + f"; K8 {k8_ms:.3f} ms device ({card_line})", flush=True)
    return lib_ms, calls


def launch_counters(noise3d, noise1d, wst, psd):
    """{kernel: (module, name of its launch counter)} of every kernel."""
    return {"K1": (noise3d, "LAUNCHES"), "K1b": (noise3d, "K1B_LAUNCHES"),
            "K2": (noise3d, "K2_LAUNCHES"), "K2b": (noise3d, "K2B_LAUNCHES"),
            "K1b full": (noise3d, "K1B_FULL_LAUNCHES"),
            "K2b full": (noise3d, "K2B_FULL_LAUNCHES"),
            "K3": (noise1d, "LAUNCHES"),
            "K3b": (noise1d, "K3B_LAUNCHES"), "K5": (wst, "MARCH_LAUNCHES"),
            "K4": (wst, "TRACE_LAUNCHES"), "K8": (psd, "LAUNCHES")}


def read_counts(counters):
    return {k: getattr(mod, name) for k, (mod, name) in counters.items()}


def zero_counts(counters):
    for mod, name in counters.values():
        setattr(mod, name, 0)


def check_counts(counters, used, what):
    """Every kernel of `used` was launched and no other kernel was."""
    counts = read_counts(counters)
    if any(counts[k] <= 0 for k in used) or any(
            v for k, v in counts.items() if k not in used):
        raise RuntimeError(f"{what} did not go through {' and '.join(used)} "
                           f"alone: launches {counts}")
    return counts


def train_steps(entry, counters, load_scene, dev, card_line, what, path,
                steps, shape, used, res=None, spp=None, per_step=None):
    """`steps` steps of entry.train_step on a scene at its own resolution,
    spp and depth (or at `res` and `spp`; `shape`: (H, W, spp,
    max_bounces), checked), against a zero target, with the launch counts
    set to 0 just before and read just after; each step must have a finite
    loss and a finite, nonzero dsigma and dl, and go through the kernels
    `used` (a forward and, for a lattice sum, its backward) alone, the
    backward at least once per sample_distance that records a graph, and
    the forward `per_step` times a step if given.  Returns the launch
    counts."""
    from tungsten_tpu_torch import convert
    from tungsten_tpu_torch.models import media as md
    scene, rdoc = load_scene(path, res_override=res, device=dev)
    spp = spp or int(rdoc["spp"])
    H, W = scene.camera.res_y, scene.camera.res_x
    if (H, W, spp, scene.max_bounces) != shape:
        raise RuntimeError(f"{what} is no longer {shape[1]}x{shape[0]}, "
                           f"{shape[2]} spp, depth {shape[3]}")
    spp_idx = torch.arange(spp, device=dev)
    target = torch.zeros(H, W, 3, device=dev)
    graphs = [0]
    sample_distance = md.sample_distance

    def counted(med, *args):
        graphs[0] += torch.is_grad_enabled() and md.requires_grad(med)
        return sample_distance(med, *args)

    peaks = []
    md.sample_distance = counted
    zero_counts(counters)
    try:
        for step in range(steps):
            out = []
            before, graphs[0] = read_counts(counters), 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            syncs = host_syncs(lambda: out.append(entry.train_step(
                scene, target, spp_idx)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            after = read_counts(counters)
            sigma, l, loss, (gs, gl) = out[0]
            others = sum(after[k] - before[k] for k in after if k not in used)
            print(f"{what} step {step}: loss {float(loss):.6f}, sigma "
                  f"{float(sigma):.6f}, l {float(l):.6f}, dsigma "
                  f"{float(gs):.6e}, dl {float(gl):.6e}; {wall:.3f} s, "
                  + ", ".join(f"{k} launches {after[k] - before[k]}"
                              for k in used)
                  + f", other kernels' launches {others}, sample_distance "
                  f"with a graph {graphs[0]}, host syncs {syncs}, peak "
                  f"device memory {peaks[-1]:.2f} GiB ({card_line})",
                  flush=True)
            if not bool(torch.isfinite(loss)):
                raise RuntimeError(f"{what} step {step}: the loss is not "
                                   "finite")
            if not all(np.isfinite(float(g)) and float(g) != 0.0
                       for g in (gs, gl)):
                raise RuntimeError(f"{what} step {step}: dsigma {float(gs)}, "
                                   f"dl {float(gl)}: the gradient chain is "
                                   "severed or not finite")
            bwd = used[-1] if used else None
            if graphs[0] <= 0 or len(used) > 1 and graphs[0] > (
                    after[bwd] - before[bwd]):
                raise RuntimeError(f"{what} step {step}: {bwd} launched "
                                   f"{after[bwd] - before[bwd]} times for "
                                   f"{graphs[0]} sample_distance calls with "
                                   "a graph")
            fwd = after[used[0]] - before[used[0]] if used else 0
            if per_step is not None and fwd != per_step:
                raise RuntimeError(f"{what} step {step}: {used[0]} launched "
                                   f"{fwd} times, the forward render "
                                   f"{per_step}")
            scene = convert.set_params(scene, sigma, l)
    finally:
        md.sample_distance = sample_distance
    counts = read_counts(counters)
    print(f"{what}, {steps} steps: "
          + ", ".join(f"{k} launches {v}" for k, v in counts.items())
          + f"; peak device memory {max(peaks):.2f} GiB ({card_line})",
          flush=True)
    return check_counts(counters, used, f"{what}'s training steps")


def train_cli(entry, counters, args, used, card_line):
    """One step through the gradient CLI, `python -m
    tungsten_tpu_torch.entry <args> --steps 1`, run in this process (it
    fails by itself on a non-finite loss or a severed gradient), with the
    launch counts set to 0 just before and read just after; it must go
    through the kernels `used` alone."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    wall = timed(lambda: entry.main([*args, "--steps", "1", "--device",
                                     "cuda"]))
    counts = check_counts(counters, used, "the gradient CLI")
    print(f"the CLI's step with scene load: {wall:.2f} s, "
          + ", ".join(f"{k} launches {counts[k]}" for k in used)
          + f", peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"({card_line})", flush=True)
    return counts


def profile_grad(entry, mod, fns, lattice, load_scene, what, path, dev,
                 card_line, res=None, spp=None):
    """One training step of a scene at its own resolution and spp (or at
    `res` and `spp`) under torch.profiler: wall, device time and busy
    share, and the device time of its lattice kernel and that kernel's
    backward against their bounds over the points the step gave them (op
    table in OUT_DIR).  fns: {kernel: (wrapper in mod, CUDA kernel
    name)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    scene, rdoc = load_scene(path, res_override=res, device=dev)
    spp = spp or int(rdoc["spp"])
    H, W = scene.camera.res_y, scene.camera.res_x
    spp_idx = torch.arange(spp, device=dev)
    target = torch.zeros(H, W, 3, device=dev)
    walls = [timed(lambda: entry.train_step(scene, target, spp_idx))
             for _ in range(2)]
    orig = {k: getattr(mod, v) for k, (v, _) in fns.items()}
    points = {k: 0 for k in fns}

    def counter(k):
        def counted(p, *rest):
            points[k] += p.shape[0]
            return orig[k](p, *rest)
        return counted

    for k, (v, _) in fns.items():
        setattr(mod, v, counter(k))
    try:
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: entry.train_step(scene, target, spp_idx))
    finally:
        for k, (v, _) in fns.items():
            setattr(mod, v, orig[k])
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    parts = []
    for k, (_, name) in fns.items():
        k_ms = sum(e.self_device_time_total for e in kern
                   if name in e.key) / 1e3
        b_ms, _, b_cls = bound_ms(*per_points(lattice[k], points[k]))
        parts.append(f"{k} {k_ms:.2f} ms on {points[k]} points, bound "
                     f"{b_ms:.3f} ms ({b_cls})")
        if k_ms <= 0:
            raise RuntimeError(f"the profiler saw no device time for {k}")
        check_bound(f"{k} over {what}'s training step", k_ms, b_ms)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    launch = [e for e in events if e.key.startswith("cudaLaunchKernel")]
    stem = what.replace(" ", "")
    table = profile_table(prof, f"profile_grad_step_{stem}.txt")
    print(f"{what} training step ({W}x{H}, {spp} spp) under torch.profiler: "
          f"wall {wall * 1e3:.1f} ms (unprofiled {walls[0] * 1e3:.1f}, "
          f"{walls[1] * 1e3:.1f} ms), device {dev_ms:.1f} ms (busy "
          f"{dev_ms / (wall * 1e3):.3f} of the profiled wall, "
          f"{dev_ms / (min(walls) * 1e3):.3f} of the fastest unprofiled "
          f"wall); " + "; ".join(parts) + f"; kernels on the card "
          f"x{sum(e.count for e in kern)}, cudaLaunchKernel "
          f"x{sum(e.count for e in launch)}, "
          f"{sum(e.cpu_time_total for e in launch) / 1e3:.1f} ms host "
          f"({card_line}); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in top)
          + f"; table in {table}", flush=True)


def hero_sharded(single, card_line):
    """The hero at its own 1920x1080, 1 spp, sharded over two gloo ranks
    that share the card (parallel/launch.py spawns them; each renders its
    540 rows in render.render's bands and all-gathers the film): both
    ranks' films must equal the single-process CLI frame `single` bit for
    bit, and each rank must launch K2 and not K1."""
    from tungsten_tpu_torch.parallel import jobs, launch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = launch.spawn(jobs.sharded_render, 2, HERO_SCENE, None, 1,
                         "cuda:0", backend="gloo")
    wall = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        film = out["film"]
        differ = int((film != single).any(axis=-1).sum())
        print(f"rank {r}: rows {out['rows'][0]}-{out['rows'][1]}, K2 "
              f"launches {out['k2']}, K1 launches {out['k1']}; render "
              f"{out['wall']:.2f} s, peak device memory "
              f"{out['peak'] / 2 ** 30:.2f} GiB, one gather of its shard "
              f"{out['gather_s'] * 1e3:.1f} ms; pixels differing from the "
              f"single-process frame {differ} (max |diff| "
              f"{float(np.abs(film - single).max()):.3g})", flush=True)
        if differ:
            raise RuntimeError(f"rank {r}'s gathered hero differs from the "
                               "single-process frame")
        if out["k2"] <= 0 or out["k1"]:
            raise RuntimeError(f"rank {r} did not render through K2 alone")
    print(f"two ranks, spawn to exit (process start, CUDA set-up and scene "
          f"load included): {wall:.2f} s ({card_line})", flush=True)
    return [out["k2"] for out in ranks]


def nccl_world_one(trender, noise3d, load_scene, dev, card_line):
    """Config 1 at 128x128, 4 spp through render.render(sharded=True) in an
    NCCL process group of one rank on the card (broadcast_scene and the
    film's all-gather run through NCCL): bit for bit render.render."""
    import torch.distributed as dist
    from tungsten_tpu_torch.parallel import launch, mesh
    scene, _ = load_scene(SCENE, res_override=(128, 128), device=dev)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{launch.free_port()}", rank=0, world_size=1)
    try:
        shared = mesh.broadcast_scene(scene)
        noise3d.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = trender.render(shared, 4, sharded=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = noise3d.LAUNCHES
    finally:
        dist.destroy_process_group()
    ref = trender.render(scene, 4, device=dev)
    equal = bool(torch.equal(got, ref))
    print(f"backend nccl, world 1: K1 launches {k1}, {wall:.3f} s, "
          f"bit-equal to render.render: {equal} ({card_line})", flush=True)
    if not equal or k1 <= 0:
        raise RuntimeError("the NCCL world-1 render is not render.render's")


def sharded_step_phase(card_line):
    """entry.train_step_sharded of config 1 at 128x128, 4 spp, over two
    gloo ranks on the card, twice from the same parameters: within 1e-5
    relative of entry.train_step in this process, the two runs and the two
    ranks bit for bit the same, K1b launched in each rank."""
    from tungsten_tpu_torch.parallel import jobs, launch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(jobs.sharded_steps, 2, SCENE, (128, 128), 4,
                         "cuda:0", 2, backend="gloo")
    wall = time.perf_counter() - t0
    single = jobs.single_step(SCENE, (128, 128), 4, "cuda")
    names = ("loss", "sigma", "l", "dsigma", "dl")
    print("single process: " + ", ".join(
        f"{n} {v:.8g}" for n, v in zip(names, single)), flush=True)
    for r, out in enumerate(ranks):
        steps = out["steps"]
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(steps[0], single))
        print(f"rank {r}: " + ", ".join(
            f"{n} {v:.8g}" for n, v in zip(names, steps[0]))
            + f"; largest relative difference {rel:.2e}; K1 launches "
            f"{out['k1']}, K1b {out['k1b']} over {len(steps)} steps",
            flush=True)
        if rel > 1e-5 or steps[1] != steps[0] or steps != ranks[0]["steps"]:
            raise RuntimeError(f"rank {r}'s sharded step is not the single "
                               "step or not reproducible")
        if out["k1b"] <= 0:
            raise RuntimeError(f"rank {r}'s step did not launch K1b")
    print(f"two ranks, spawn to exit: {wall:.2f} s ({card_line})",
          flush=True)


def quiet_cli(trender, args):
    """trender.main(args) with its progress lines kept out of the log;
    returns (its return value, the lines it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = trender.main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    print(f"  {' '.join(os.path.basename(a) for a in args)}: "
          f"{time.perf_counter() - t0:.2f} s; {lines[-1] if lines else ''}",
          flush=True)
    return ret, lines


def driver_options(trender, read_pfm, noise3d, tmp, card_line):
    """The render driver's options through the CLI on config 1 at 128x128
    (the Sobol sampler at 64x64, 48 spp, against the golden)."""
    import urllib.request
    from tungsten_tpu_torch.io.exr import read_exr

    def out(name):
        return os.path.join(tmp, name)

    def pfm(name):
        return read_pfm(out(name))

    base = [SCENE, "--res", "128x128"]
    quiet_cli(trender, base + ["--spp", "4", "-o", out("full.png")])
    full = pfm("full.pfm")
    quiet_cli(trender, base + ["--spp", "2", "--checkpoint-interval", "2",
                               "-o", out("r.png")])
    _, lines = quiet_cli(trender, base + ["--spp", "2", "--resume",
                                          "--checkpoint-interval", "2",
                                          "-o", out("r.png")])
    err = float((np.abs(pfm("r.pfm") - full) / (1 + np.abs(full))).max())
    print(f"resume (2 + 2 spp) against 4 spp: max |diff| / (1 + |x|) "
          f"{err:.3g} (1e-6)", flush=True)
    if "resumed at spp=2" not in lines or err > 1e-6:
        raise RuntimeError("--resume did not continue the samples")

    srv, _ = quiet_cli(trender, base + [
        "--spp", "4", "--aovs", "--serve", "0", "--profile",
        out("prof"), "-o", out("opt.png")])
    try:
        url = f"http://127.0.0.1:{srv.port}"
        status = json.loads(urllib.request.urlopen(url + "/status").read())
        png = urllib.request.urlopen(url + "/framebuffer").read()
    finally:
        srv.shutdown()
    aovs = {k: pfm(f"opt.{k}.pfm") for k in ("depth", "normal", "albedo",
                                              "visibility")}
    plain_equal = bool(np.array_equal(pfm("opt.pfm"), full))
    trace_bytes = os.path.getsize(os.path.join(out("prof"),
                                               "render_trace.json"))
    print(f"--aovs: image bit-equal to the plain render: {plain_equal}; "
          + ", ".join(f"{k} mean {float(v.mean()):.4f}"
                      for k, v in aovs.items())
          + f"; --serve: /status spp_done {status['spp_done']}, state "
          f"{status['state']}, /framebuffer {len(png)} bytes; --profile: "
          f"trace {trace_bytes} bytes", flush=True)
    if (not plain_equal or status["spp_done"] != 4
            or png[:8] != b"\x89PNG\r\n\x1a\n"
            or not all(np.isfinite(v).all() for v in aovs.values())):
        raise RuntimeError("--aovs, --serve or --profile failed")

    quiet_cli(trender, base + ["--spp", "4", "--tonemap", "filmic", "-o",
                               out("e.exr")])
    exr = read_exr(out("e.exr"))[..., :3]
    if not np.array_equal(exr, full.astype(np.float16).astype(np.float32)):
        raise RuntimeError("-o *.exr does not read back as the render")

    adaptive_fn, seen = trender.render_adaptive, []

    def counted(*a, **k):  # the CLI's render_adaptive, its counts kept
        seen.append(adaptive_fn(*a, **k))
        return seen[-1]

    trender.render_adaptive = counted
    try:
        quiet_cli(trender, base + ["--spp", "8", "--adaptive", "4", "-o",
                                   out("ad.png")])
    finally:
        trender.render_adaptive = adaptive_fn
    counts = seen[0][1].cpu().numpy()
    adaptive = pfm("ad.pfm")
    print(f"--adaptive 4 on 8 spp: {int((counts > 8).sum())} of "
          f"{counts.size} pixels took the extra samples; image finite "
          f"{bool(np.isfinite(adaptive).all())}", flush=True)
    if not (counts > 8).any() or not np.isfinite(adaptive).all():
        raise RuntimeError("--adaptive added no sample or is not finite")

    quiet_cli(trender, base + ["--data-dump-pixel", "64,64", "-o",
                               out("d.png")])
    with open(out("d.dump_64_64.json")) as f:
        dump = json.load(f)
    if len(dump["f"]) != 512 or not np.isfinite(dump["f"]).all():
        raise RuntimeError("--data-dump-pixel wrote no finite values")
    print(f"--data-dump-pixel 64,64: 512 values, f in "
          f"[{min(dump['f']):.4f}, {max(dump['f']):.4f}]", flush=True)

    noise3d.LAUNCHES = 0
    quiet_cli(trender, [SCENE, "--res", "64x64", "--spp", "48", "--sampler",
                        "sobol", "-o", out("sobol.png")])
    ratio, frac_bad = golden_bucket_test(pfm("sobol.pfm"), read_pfm(GOLDEN),
                                         48)
    print(f"--sampler sobol, 64x64, 48 spp against the golden: energy ratio "
          f"{ratio:.4f} (0.9-1.1), frac_bad {frac_bad:.4f} (< 0.08), K1 "
          f"launches {noise3d.LAUNCHES} ({card_line})", flush=True)
    if not (0.9 < ratio < 1.1 and frac_bad < 0.08) or noise3d.LAUNCHES <= 0:
        raise RuntimeError("the Sobol render failed the golden bucket test")


# ---------------------------------------------------------------------------
# The gradient through the GP layer's types (ROADMAP 16c)
# ---------------------------------------------------------------------------

# Each variant's training step, one step of entry.train_step against a
# zero target at 128x128 and depth 2 (config 1's variants at 4 spp, config
# 3's at 16, config 4a's at 8, the hero's at 16 as its own step phase
# runs), and the kernels its forward and backward launch (none: hero-1d's
# multi-resolution 1D general evaluator and ws-linear's plain weight-space
# fallback, as in the JAX package).  box-mirror-phase trains at depth 3:
# at depth 2 a path reflected off the medium ends there, so its image
# gradient is 0 in both packages (tests/test_torch_grad_mirror.py).
# hero-aniso is this script's own: the hero over box-aniso's anisoMtx
# (the full splat form in world space, K2b's full instance).  box-knob is
# refused by name: the knob SDF's gradient is NaN in jax.grad too.
GRAD_VARIANTS = {
    "box-iso": ("K1", "K1b"), "box-iso-aniso": ("K1", "K1b"),
    "box-aniso": ("K1", "K1b full"), "box-mesh": ("K1", "K1b"),
    "box-csg": ("K1", "K1b"), "box-ggx": ("K1", "K1b"),
    "box-mirror-phase": ("K1", "K1b"), "box-mirror-surface": ("K1", "K1b"),
    "m1d-renewal": ("K3", "K3b"), "m1d-aniso": ("K3", "K3b"),
    "ws-rq": ("K5",), "ws-rq-trace": ("K4",), "ws-matern": ("K5",),
    "ws-matern-trace": ("K4",), "ws-linear": (),
    "hero-bruteforce": ("K2", "K2b"), "hero-iso": ("K1", "K1b"),
    "hero-renewal": ("K2", "K2b"), "hero-1d": (),
    "hero-surfvol": ("K2", "K2b"), "hero-aniso": ("K2", "K2b full")}
GRAD_REFUSED = {"box-knob": "knob mean"}
GRAD_DEPTH = {"box-mirror-phase": 3}
# the medium-level gradient's rays per family (MEDIUM_RAYS), and the
# variants whose second segment conditions at its start (two segments)
GRAD_FAMILY = {"box": "config 1", "m1d": "config 3", "ws": "config 4a",
               "hero": "config 5"}
TWO_SEGMENTS = ("hero-renewal", "m1d-renewal", "m1d-aniso", "ws-rq",
                "ws-matern")
# the medium-level gradient's lanes on which the card and the CPU found
# one crossing (within this of 1 + |t|)
LANE_T_RTOL = 1e-4
# K1b's and K2b's full instances (full_form_checks): K1b at K1B_POINTS,
# K2b at K2_POINTS, on the forms of box-aniso and of the hero's base over
# its anisoMtx; K1b's dp bit for bit and its sums within K1B_SUM_ULPS (its
# operations in the twin's order, -fmad=false), K2b within K2B_RTOL and
# K2B_SUM_RTOL, as their diagonal instances


def grad_variant_docs(tmp):
    """{name: (scene dict, spp, resolution override or None)} of the
    variants whose gradient the run takes, with hero-aniso beside them."""
    from tungsten_tpu_torch.tools.gp_variants import ANISO_MTX
    from tungsten_tpu_torch.tools.gp_variants import variant_docs as docs
    out = {}
    all_docs = docs(tmp)
    for name, (_, doc, spp) in all_docs.items():
        if name not in GRAD_VARIANTS and name not in GRAD_REFUSED:
            continue
        doc = json.loads(json.dumps(doc))
        if name in GRAD_DEPTH:
            doc["integrator"]["max_bounces"] = GRAD_DEPTH[name]
        hero = name.startswith("hero")
        out[name] = (doc, 16 if hero else spp, (128, 128) if hero else None)
    hero = json.loads(json.dumps(all_docs["hero-iso"][1]))
    hero["media"][0]["isotropic_3D_sampling"] = False
    hero["media"][0]["gaussian_process"]["covariance"]["cov"][
        "anisoMtx"] = ANISO_MTX
    out["hero-aniso"] = (hero, 16, (128, 128))
    return out


def _family(name):
    return name.split("-")[0]


def cpu_lane_grads(doc, name):
    """`lane_grads` of variant `name` (scene dict `doc`) on the CPU, and its
    wall seconds: run in a process of its own, on one thread."""
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from tungsten_tpu_torch import convert, entry
    from tungsten_tpu_torch.models import media as md
    from tungsten_tpu_torch.scene.parse import scene_from_dict
    t0 = time.perf_counter()
    scene, _ = scene_from_dict(doc, device="cpu")
    spec = MEDIUM_RAYS[GRAD_FAMILY[_family(name)]]
    out = lane_grads(md, convert, entry, scene, "cpu", spec,
                     2 if name in TWO_SEGMENTS else 1)
    return (*(x.numpy() for x in out), time.perf_counter() - t0)


def variant_grad_check(md, convert, entry, scene, dev, name, cpu_future):
    """A variant's medium-level gradient on the card, per lane (one
    backward a lane), against the port's CPU run of the same rays
    (`cpu_future`: cpu_lane_grads, started at the run's beginning) and
    central FD.  Each lane's t1 + t2 is weighed by the sign of its card
    partial, so that the lanes add: over the lanes where the card and the
    CPU found one crossing (within LANE_T_RTOL), the weighed sum within
    MEDIUM_CPU_RTOL of the CPU's; over those whose FD resolves
    (`fd_lanes`), within MEDIUM_FD_RTOL, MEDIUM_FD_ATOL of FD.  A
    parameter whose FD resolves no lane is printed, not held (K4's
    variants: the sphere trace stops off the root, at a t that does not
    move across the stencil).  Returns the wall seconds of the card's
    part."""
    from tungsten_tpu_torch.utils.fd import fd_lanes
    t0 = time.perf_counter()
    segments = 2 if name in TWO_SEGMENTS else 1
    spec = MEDIUM_RAYS[GRAD_FAMILY[_family(name)]]
    R, eps = spec[0], spec[-1]
    eps = eps if isinstance(eps, tuple) else (eps, eps)
    params = tuple(float(x) for x in entry.params(scene))

    def run(sigma, l):
        return variant_run(md, convert, scene, dev, spec, segments, sigma,
                           l)

    fd = [fd_lanes(run, params, i, eps[i], dev) for i in range(2)]
    ad, t, hit = lane_grads(md, convert, entry, scene, dev, spec, segments)
    card_s = time.perf_counter() - t0
    ad_c, t_c, hit_c, cpu_s = (torch.from_numpy(np.asarray(x)) if k < 3
                               else x for k, x in
                               enumerate(cpu_future.result()))
    same = hit & hit_c & ((t - t_c).abs() <= LANE_T_RTOL * (1 + t_c.abs()))
    if int(same.sum()) < R // 2:
        raise RuntimeError(f"{name}: the card and the CPU found one crossing"
                           f" on {int(same.sum())} of {R} lanes")
    parts = []
    for i, pname in enumerate(("dsigma", "dl")):
        w = torch.where(same, torch.sign(ad[:, i]), 0.0)
        g, g_c = float((w * ad[:, i]).sum()), float((w * ad_c[:, i]).sum())
        lanes, fd_lane = fd[i]
        wf = torch.where(lanes & same, torch.sign(ad[:, i]), 0.0)
        g_f, g_fd = float((wf * ad[:, i]).sum()), float((wf * fd_lane).sum())
        n_fd = int((wf != 0).sum())
        parts.append(f"{pname}: card {g:.5f}, CPU {g_c:.5f} on "
                     f"{int(same.sum())} lanes; card {g_f:.5f}, FD at eps {eps[i] / 4:g} "
                     f"{g_fd:.5f} on the {n_fd} lanes FD resolves")
        if g == 0.0 or not np.isfinite(g) or abs(g - g_c) > (
                MEDIUM_CPU_RTOL * abs(g_c)):
            raise RuntimeError(f"{name}: medium-level {pname} on the card {g}"
                               f" is not within {MEDIUM_CPU_RTOL} of the "
                               f"CPU's {g_c}")
        if n_fd == 0:
            parts[-1] += " (printed, not held)"
        elif abs(g_f - g_fd) > MEDIUM_FD_ATOL + MEDIUM_FD_RTOL * abs(g_fd):
            raise RuntimeError(f"{name}: medium-level {pname} {g_f} is not "
                               f"within rtol {MEDIUM_FD_RTOL}, atol "
                               f"{MEDIUM_FD_ATOL} of FD {g_fd}")
    print(f"{name} medium-level d sum(s (t1 + t2)) / d(sigma, l) ({segments}"
          f" segment{'s' if segments > 1 else ''}, s the sign of each lane's "
          f"card partial): " + "; ".join(parts)
          + f" ({card_s:.2f} s on the card, {cpu_s:.1f} s on the CPU in its "
          "process)", flush=True)
    return card_s


class BwdCapture:
    """Wraps K1b's or K2b's raw wrapper (`fn`: "noise3d_sum_s_bwd" or
    "noise3d_sum_bwd"), as autograd calls it, to keep the inputs of its
    first full-form launch on at least `least` points; the launches stay
    the step's."""

    def __init__(self, noise3d, fn, least):
        self.noise3d, self.name, self.least = noise3d, fn, least
        self.fn, self.args = getattr(noise3d, fn), None

    def __enter__(self):
        def launch(p, *rest):
            m = rest[-3]
            if self.args is None and len(m) == 6 and p.shape[0] >= self.least:
                self.args = tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in (p, *rest))
            return self.fn(p, *rest)
        setattr(self.noise3d, self.name, launch)
        return self

    def __exit__(self, *exc):
        setattr(self.noise3d, self.name, self.fn)


def full_form_checks(noise3d, cov, hero_base, lattice, dev, card_line):
    """K1b's and K2b's full instances against their twins on the card:
    K1b on box-aniso's cell radius and form at ODD_POINTS (untimed), with
    MANY_K impulses, and at K1B_POINTS (timed), then one backward through
    autograd must be one launch of it; K2b on the hero's levels over the
    hero's base with box-aniso's anisoMtx, K = 1 untimed and K = 3 timed at
    K2_POINTS.  Returns ({"K1b full": (max |diff|, times), "K2b full":
    ...})."""
    from tungsten_tpu_torch.tools.gp_variants import ANISO_MTX
    mtx = torch.tensor(ANISO_MTX, device=dev)
    acov = dataclasses.replace(cov, aniso_mtx=mtx)
    m6 = noise3d.form6(acov.splat_form())
    host = noise3d.host_params(acov.splat_radius(), m6)
    kr, m = host[0], host[1:]
    print(f"box-aniso's full splat form {[round(v, 4) for v in m]}, cell "
          f"radius {kr:.5f}", flush=True)
    inputs = {n: k1b_inputs(n, dev, seed=6)
              for n in (*ODD_POINTS, *K1B_POINTS)}

    def check(sizes, K, kernel):
        def args(n):
            p, sd, g = inputs[n]
            return p, sd, kr, m, K, g
        return bwd_checks(
            f"K1b full K={K}" if kernel is None else "K1b full",
            lambda n: noise3d.noise3d_sum_s_bwd(*args(n)),
            lambda n: noise3d.noise3d_sum_s_bwd_ref(*args(n)), kernel, sizes,
            lattice["K1b full"],
            "(kr, m00, m11, m22, m01, m02, m12)",
            (K1B_DP_RTOL, K1B_SUM_ULPS), card_line)
    check(ODD_POINTS, 3, None)
    check((K1B_LINE_POINTS,), MANY_K, None)
    p, sd, g = inputs[K1B_LINE_POINTS]
    leaves = (p.clone().requires_grad_(),
              torch.tensor(kr, device=dev, requires_grad=True),
              torch.tensor(m, device=dev, requires_grad=True))
    out = noise3d.noise3d_sum_s_diff(leaves[0], sd, leaves[1], leaves[2], 3,
                                     host)
    backward_kernels("K1b full", lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), "noise3d_sum_s_bwd_kernel<3, "
        "true>", noise3d, "K1B_FULL_LAUNCHES")
    k1b = check(K1B_POINTS, 3, "noise3d_sum_s_bwd_kernel")
    abase = dataclasses.replace(hero_base, aniso_mtx=mtx)
    m2 = noise3d.form6(abase.splat_form()).tolist()
    p, seed, kr2, qm = k2_inputs(abase, max(K2_POINTS), dev)
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=max(K2_POINTS)).astype(np.float32)).to(dev)

    def args2(n, K=3):
        return p[:n], seed[:n], kr2[:n], qm[:n], m2, K, g[:n]
    bwd_checks("K2b full K=1",
               lambda n: noise3d.noise3d_sum_bwd(*args2(n, 1)),
               lambda n: noise3d.noise3d_sum_bwd_ref(*args2(n, 1)), None,
               K2_POINTS, None, "(m00, m11, m22, m01, m02, m12)",
               (K2B_RTOL, K2B_SUM_RTOL), card_line, per_point=2)
    k2b = bwd_checks(
        "K2b full", lambda n: noise3d.noise3d_sum_bwd(*args2(n)),
        lambda n: noise3d.noise3d_sum_bwd_ref(*args2(n)),
        "noise3d_sum_bwd_kernel", K2_POINTS, lattice["K2b full"],
        "(m00, m11, m22, m01, m02, m12)", (K2B_RTOL, K2B_SUM_RTOL),
        card_line, per_point=2)
    return {"K1b full": k1b, "K2b full": k2b}


def captured_full_check(noise3d, name, args, card_line):
    """A full instance against its twin on the arguments a training step's
    launch handed it: K1b's dp bit for bit and its sums within
    K1B_SUM_ULPS, K2b within K2B_RTOL (1 + |x|) and its m partials' sums
    within K2B_SUM_RTOL."""
    if args is None:
        raise RuntimeError(f"the training step made no {name} launch")
    if name == "K1b full":
        dp, sums = noise3d.noise3d_sum_s_bwd(*args)
        dp_t, sums_t = noise3d.noise3d_sum_s_bwd_ref(*args)
        ulps = f32_ulps(sums, sums_t)
        ok = torch.equal(dp, dp_t) and ulps <= K1B_SUM_ULPS
        what = (f"dp max |diff| {float((dp - dp_t).abs().max()):.3e}, sums "
                f"{[round(v, 6) for v in sums.tolist()]} within {ulps:.0f} "
                "float32 ulps")
    else:
        dp, part = noise3d.noise3d_sum_bwd(*args)
        dp_t, part_t = noise3d.noise3d_sum_bwd_ref(*args)
        d = torch.cat([dp, part[:, :2]], 1)
        d_t = torch.cat([dp_t, part_t[:, :2]], 1)
        rel = float(((d - d_t).abs() / (1 + d_t.abs())).max())
        s, s_t = (x[:, 2:].sum(0, dtype=torch.float64) for x in (part,
                                                                 part_t))
        srel = float(((s - s_t).abs() / s_t.abs().clamp(min=1e-30)).max())
        ok = rel <= K2B_RTOL and srel <= K2B_SUM_RTOL
        what = f"within {rel:.2e} * (1 + |x|), the m sums within {srel:.2e}"
    n = args[0].shape[0]
    print(f"{name} on a training step's own launch ({n} points, form "
          f"{[round(v, 4) for v in args[-3]]}): {what} ({card_line})",
          flush=True)
    if not ok:
        raise RuntimeError(f"{name} disagrees with its twin on the training "
                           "step's launch")


def start_grad_references(pool, docs):
    """{name: future of cpu_lane_grads} of the gradient variants, on the
    pool of the forward variants' CPU renders (after them)."""
    return {name: pool.submit(cpu_lane_grads, doc, name)
            for name, (doc, _, _) in docs.items()
            if name in GRAD_VARIANTS}


def gradient_variants(entry, convert, md, noise3d, counters, load_scene,
                      dev, docs, cpu_grads, tmp, card_line):
    """Each variant's training step (GRAD_VARIANTS, `train_steps`, one
    step, the launch counts set to 0 just before and read just after),
    with the first full-form launch of box-aniso's (K1b) and hero-aniso's
    (K2b) held against the twin, then its medium-level gradient against
    the CPU and FD (`variant_grad_check`); a refused one (GRAD_REFUSED)
    must raise by name.  Returns ({kernel: launches over the steps},
    {name: step wall}), and the captured checks' kernels."""
    totals, walls = {}, {}
    for name, (doc, spp, res) in docs.items():
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as fh:
            json.dump(doc, fh)
        if name in GRAD_REFUSED:
            phase(f"{name}: the gradient is refused by name")
            scene = load_scene(path, res_override=(8, 8), device=dev)[0]
            try:
                entry.fwd_bwd(scene, 0)
            except NotImplementedError as e:
                if GRAD_REFUSED[name] not in str(e):
                    raise
                print(f"{name}: {e}", flush=True)
                continue
            raise RuntimeError(f"{name}'s gradient was not refused")
        used = GRAD_VARIANTS[name]
        depth = GRAD_DEPTH.get(name, 2)
        phase(f"{name}'s training step (128x128, {spp} spp, depth {depth})"
              " and medium-level gradient")
        t0 = time.perf_counter()
        capture = contextlib.nullcontext()
        full = [k for k in used if k.endswith("full")]
        if full:
            capture = BwdCapture(noise3d, "noise3d_sum_s_bwd" if full[0]
                                 == "K1b full" else "noise3d_sum_bwd", 1024)
        with capture:
            counts = train_steps(entry, counters, load_scene, dev, card_line,
                                 name, path, 1, (128, 128, spp, depth), used,
                                 res=res, spp=spp)
        walls[name] = time.perf_counter() - t0
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if full:
            captured_full_check(noise3d, full[0], capture.args, card_line)
        scene = load_scene(path, res_override=res, device=dev)[0]
        variant_grad_check(md, convert, entry, scene, dev, name,
                           cpu_grads[name])
        done_print(t0)
    return totals, walls


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
    from tungsten_tpu_torch import convert, entry
    from tungsten_tpu_torch import render as trender
    from tungsten_tpu_torch.io.image import read_pfm
    from tungsten_tpu_torch.kernels import noise1d, noise3d, psd, sass
    from tungsten_tpu_torch.kernels import ws_trace as wst
    from tungsten_tpu_torch.models import media as md
    from tungsten_tpu_torch.ops import gp as gpmod
    from tungsten_tpu_torch.scene.parse import load_scene, scene_from_dict
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def done(t0):
        print(f"-- {time.perf_counter() - t0:.1f} s", flush=True)

    phase("build K1/K2, K3, K5/K4 and K8, in parallel")
    t0 = time.perf_counter()

    def build(mod):
        t = time.perf_counter()
        return mod.build(), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = {mod: pool.submit(build, mod)
                for mod in (noise3d, noise1d, wst, psd)}
    for mod, job in jobs.items():
        log, secs = job.result()
        print(f"built {os.path.relpath(mod.SOURCE, ROOT)} for sm_90a in "
              f"{secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    lattice = lattice_pipes(sass, noise3d, noise1d)
    for name, (n_bytes, counts) in lattice.items():
        print(f"{name} per point at K = 3, from its SASS: {n_bytes} bytes; "
              + ", ".join(f"{c} {v:.1f}" for c, v in counts.items()),
              flush=True)
    from tungsten_tpu_torch.kernels.nvcc import compile_library, sass_listing
    a_block, v_unit = sass.jacobi_counts(
        sass_listing(compile_library(psd.SOURCE)[0]),
        "jacobi_eigh_kernelILi34ELi128")
    for name, counts in (("A block", a_block), ("V unit", v_unit)):
        print(f"K8 at n = 34, one {name} of a round, from its SASS: "
              + ", ".join(f"{c} {v}" for c, v in counts.items()), flush=True)
    blocks, units = 17 * 16 // 2, 34 * 17  # a round's, at n = 34
    per_sweep = k8_work(34, 1, 1)[1]
    print(f"K8 per pair-element at n = 34 (a round's {blocks} blocks and "
          f"{units} V units over its {units} pair-elements): the SASS issues "
          f"{(blocks * a_block['issue'] + units * v_unit['issue']) / units:.1f}"
          " instructions, the bound counts "
          + ", ".join(f"{c} {v / 33 / units:.1f}"
                      for c, v in per_sweep.items())
          + " (the rotations' step included)", flush=True)
    done(t0)

    # the GP layer variants' CPU renders, in processes beside the card
    variant_tmp = tempfile.mkdtemp()
    variant_docs_, cpu_pool, cpu_refs = start_cpu_references(variant_tmp)
    _POOLS.append(cpu_pool)
    # and the gradient variants' per-lane CPU gradients, after them
    grad_docs = grad_variant_docs(variant_tmp)
    cpu_grads = start_grad_references(cpu_pool, grad_docs)

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
    if K != 3:
        raise RuntimeError(f"config 1 has K = {K}; K1's SASS counts K = 3")
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
        b_ms, b_by, b_cls = bound_ms(*per_points(lattice["K1"], n))
        check_bound(f"K1 N={n}", t_k, b_ms)
        k1_times[n] = (t_k, t_p, b_ms, b_by, b_cls)
        print(f"K={K} N={n}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms "
              f"(median of 20, CUDA events; {card_line}); bound "
              f"{b_ms:.4f} ms ({b_cls})", flush=True)
    del p, seed
    done(t0)

    phase("K1b (K1's backward) against its plain twin")
    t0 = time.perf_counter()
    k1b_err, k1b_times = k1b_checks(noise3d, cov, K, lattice["K1b"], dev,
                                    card_line)
    done(t0)

    phase("K2 against its plain twin (the hero's levels)")
    t0 = time.perf_counter()
    hero_base = load_scene(HERO_SCENE, device=dev)[0].media[0].gp.cov.base
    k2_err, k2_times = k2_checks(noise3d, hero_base, lattice["K2"], dev,
                                 card_line)
    done(t0)

    phase("K2b (K2's backward) against its plain twin (the hero's levels)")
    t0 = time.perf_counter()
    k2b_err, k2b_times = k2b_checks(noise3d, hero_base, lattice["K2b"], dev,
                                    card_line)
    done(t0)

    phase("K1b's and K2b's full-form instances (an anisoMtx in world "
          "space) against their plain twins")
    t0 = time.perf_counter()
    full_numbers = full_form_checks(noise3d, cov, hero_base, lattice, dev,
                                    card_line)
    done(t0)

    phase("K3 against its plain twin")
    t0 = time.perf_counter()
    k3_err, k3_times = k3_checks(noise1d, lattice["K3"], dev, card_line)
    done(t0)

    phase("K3b (K3's backward) against its plain twin")
    t0 = time.perf_counter()
    k3b_err, k3b_times = k3b_checks(noise1d, lattice["K3b"], dev, card_line)
    done(t0)

    phase("K5 and K4 against their plain twins (config 4a rays, n=1024)")
    t0 = time.perf_counter()
    ws_scene_full, _ = load_scene(WS_SCENE, device=dev)
    ws_numbers = ws_kernel_checks(wst, ws_scene_full.media[0], dev,
                                  card_line)
    done(t0)

    ws_tag_numbers = {}
    for tag, cov in WS_TAG_COVS.items():
        phase(f"K5 and K4, the {tag} instances, against their plain twins "
              "(config 4a rays, n=1024)")
        t0 = time.perf_counter()
        tag_med = scene_from_dict(ws_doc(cov=cov), device=dev)[0].media[0]
        ws_tag_numbers[tag] = ws_kernel_checks(wst, tag_med, dev, card_line,
                                               WS_TAG_RAYS, tag, twin_reps=1)
        done(t0)

    searches = WsSearches(wst)
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
        searches.reset()
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
        searches.check("K5", "config 4a")
        done(t0)

        phase("config 4a with step_size 0 (128x128, 8 spp) through the CLI")
        t0 = time.perf_counter()
        path = os.path.join(tmp, "ws-trace.json")
        with open(path, "w") as fh:
            json.dump(ws_doc(step_size=0.0), fh)
        noise3d.LAUNCHES = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
        searches.reset()
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
        searches.check("K4", "config 4a, step_size 0")
        done(t0)

        phase("config 4a (128x128, 8 spp, both step sizes): host syncs, "
              "realization synthesis and peak memory")
        t0 = time.perf_counter()
        ws_scenes = (
            ("config 4a", load_scene(WS_SCENE, res_override=(128, 128),
                                     device=dev)[0]),
            ("config 4a, step_size 0", scene_from_dict(
                ws_doc(0.0, (128, 128)), device=dev)[0]))
        ws_realization_runs(trender, wst, searches, ws_scenes, dev,
                            card_line)
        done(t0)

        m1d = {}
        for what, (path, _) in M1D_SCENES.items():
            phase(f"{what} (128x128, 16 spp) through the CLI")
            t0 = time.perf_counter()
            noise3d.LAUNCHES = noise1d.LAUNCHES = noise1d.MOST_POINTS = 0
            noise1d.K3B_LAUNCHES = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
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
                    or noise1d.K3B_LAUNCHES or wst.MARCH_LAUNCHES
                    or wst.TRACE_LAUNCHES):
                raise RuntimeError(f"the {what} render did not go through "
                                   "K3 alone")
            check_k3_points(noise1d, what)
            done(t0)

        rows = trender.MAX_RAYS // 1920
        phase(f"config 5, the hero (1920x1080, 1 spp, bands of {rows} rows) "
              "through the CLI")
        t0 = time.perf_counter()
        noise3d.LAUNCHES = noise3d.K2_LAUNCHES = noise3d.K2_MOST_POINTS = 0
        noise3d.K2B_LAUNCHES = noise3d.K2B_MOST_POINTS = 0
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
                or noise3d.K2B_LAUNCHES or wst.MARCH_LAUNCHES
                or wst.TRACE_LAUNCHES):
            raise RuntimeError("the hero render did not go through K2 alone")
        check_k2_points(noise3d, "the hero")
        done(t0)

        hero_frame = read_pfm(os.path.join(tmp, "hero.pfm"))

        phase("config 2, the ensemble (256x256, 16 spp, in 4 batches of 4 "
              "spp) through the CLI")
        t0 = time.perf_counter()
        noise3d.LAUNCHES = noise3d.K1B_LAUNCHES = noise3d.K2_LAUNCHES = 0
        noise1d.LAUNCHES = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
        img, wall, peak = render_cli(trender, ENS_SCENE, 16, tmp, "ensemble")
        k1_ens = noise3d.LAUNCHES
        lum = check_image(img, "config 2", (256, 256, 3))
        print(f"mean luminance {lum:.4f}, K1 launches {k1_ens}; {wall:.2f} s"
              f" with scene load ({256 * 256 * 16 / wall / 1e3:.2f} "
              f"Ksamples/s), peak device memory {peak / 2 ** 30:.2f} GiB "
              f"({card_line})", flush=True)
        if (k1_ens <= 0 or noise3d.K1B_LAUNCHES or noise3d.K2_LAUNCHES
                or noise1d.LAUNCHES or wst.MARCH_LAUNCHES
                or wst.TRACE_LAUNCHES):
            raise RuntimeError("the config-2 render did not go through K1 "
                               "alone")
        done(t0)

        phase("config 2 (128x128, 16 spp, one batch): launches, host syncs "
              "and peak memory")
        t0 = time.perf_counter()
        ens128, _ = load_scene(ENS_SCENE, res_override=(128, 128),
                               device=dev)
        noise3d.LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        syncs = host_syncs(lambda: trender.render(ens128, 16, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        print(f"config 2, 128x128, 16 spp: {wall:.3f} s with the sync count "
              f"on, K1 launches {noise3d.LAUNCHES}, host syncs {syncs}, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
              f" GiB ({card_line})", flush=True)
        done(t0)

        counters = launch_counters(noise3d, noise1d, wst, psd)
        fs_k8 = {}
        for what, (path, _) in FS_SCENES.items():
            phase(f"{what} (128x128, 8 spp) through the CLI")
            t0 = time.perf_counter()
            zero_counts(counters)
            psd.MOST_MATRICES = 0
            img, wall, peak = render_cli(trender, path, 8, tmp,
                                         os.path.basename(path)[:-5])
            counts = check_counts(counters, ("K8",), what)
            fs_k8[what] = counts["K8"]
            lum = check_image(img, what)
            print(f"mean luminance {lum:.4f}, K8 launches {counts['K8']}, "
                  f"largest launch {psd.MOST_MATRICES} matrices; {wall:.2f} "
                  f"s with scene load ({128 * 128 * 8 / wall / 1e3:.2f} "
                  f"Ksamples/s), peak device memory {peak / 2 ** 30:.2f} GiB"
                  f" ({card_line})", flush=True)
            done(t0)


    phase("K8 against its twin: the matrices of config 4b's pass and "
          f"{K8_RANDOM} random conditioning blocks")
    t0 = time.perf_counter()
    fs_scene = load_scene(FS_SCENES["config 4b"][0], device=dev)[0]
    fs_cov = fs_scene.media[0].gp.cov
    with EighCapture(psd, gpmod, K8_CAPTURE) as cap:
        trender.render(fs_scene, 8, device=dev)
    mats, (s11, s12) = cap.sets()
    k8_err, k8_sweeps = 0.0, {}
    for n, a in sorted(mats.items()):
        if n != s11.shape[-1]:  # those are the normal solves' blocks
            e, _, mean, most = k8_against_twin(psd, gpmod, a, None,
                                               f"config 4b's pass, n = {n}")
            k8_err, k8_sweeps[f"pass, n = {n}"] = max(k8_err, e), (mean, most)
    e, _, mean, most = k8_against_twin(
        psd, gpmod, s11, s12, "config 4b's pass, the normal solves' blocks")
    n = s11.shape[-1]
    k8_err, k8_sweeps[f"pass, n = {n}"] = max(k8_err, e), (mean, most)
    blocks, cross = fs_blocks(gpmod, fs_cov, K8_RANDOM, 32, dev, 8)
    e, total, mean, most = k8_against_twin(psd, gpmod, blocks, cross,
                                           "random conditioning blocks")
    k8_err = max(k8_err, e)
    k8_sweeps[f"random, n = 34, {K8_RANDOM} matrices"] = (mean, most)
    print("K8 sweeps per matrix (mean, max): " + "; ".join(
        f"{k} {m:.3f}, {x}" for k, (m, x) in k8_sweeps.items()), flush=True)
    k8_all_ms = median_ms(lambda: psd.eigh(blocks), reps=5)
    b_ms, _, b_cls = bound_ms(*k8_work(34, total, K8_RANDOM))
    check_bound(f"K8 at {K8_RANDOM} matrices", k8_all_ms, b_ms)
    print(f"K8 on {K8_RANDOM} 34x34 blocks: {k8_all_ms:.3f} ms (median of 5,"
          f" CUDA events), bound {b_ms:.3f} ms ({b_cls}; {total} sweeps in "
          f"all), {b_ms / k8_all_ms:.3f} of it ({card_line})", flush=True)
    line_a = blocks[:K8_LINE].contiguous()
    line_sweeps = psd.eigh(line_a, sweeps=True)[2]
    line_sets = {33: fs_blocks(gpmod, fs_cov, K8_LINE, 31, dev, 9)[0],
                 34: line_a}
    k8_dev = {n: kernel_device_ms(lambda: psd.eigh(a), "jacobi_eigh_kernel",
                                  reps=5) for n, a in line_sets.items()}
    lib = {n: k8_library(a, k8_dev[n], card_line,
                         f"[{K8_LINE}, {n}, {n}] conditioning blocks")
           for n, a in line_sets.items()}
    lib_ms, k8_ms = lib[34][0], k8_dev[34]
    plain_ms = median_ms(lambda: psd.eigh_ref(line_a), reps=1)
    b_ms, b_by, b_cls = bound_ms(*k8_work(34, int(line_sweeps.sum()),
                                          K8_LINE))
    check_bound(f"K8 at {K8_LINE} matrices", k8_ms, b_ms)
    k8_numbers = {"max_abs_err": k8_err, "ms": k8_ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "bound_class": b_cls,
                  "library_ms": lib_ms,
                  "sweeps": {k: [m, x] for k, (m, x) in k8_sweeps.items()}}
    print(f"K8 at [{K8_LINE}, 34, 34]: device {k8_ms:.4f} ms, twin "
          f"{plain_ms:.3f} ms, torch.linalg.eigh {lib_ms:.3f} ms; bound "
          f"{b_ms:.4f} ms ({b_cls}; {int(line_sweeps.sum())} sweeps in "
          f"all), {b_ms / k8_ms:.3f} of it", flush=True)
    del blocks, cross, mats, s11, s12, cap
    done(t0)

    for what, (path, _) in FS_SCENES.items():
        phase(f"{what} (128x128, 8 spp): host syncs, peak memory and the "
              "kernels under torch.profiler")
        t0 = time.perf_counter()
        fs_render_checks(trender, psd, gpmod, counters,
                         load_scene(path, device=dev)[0], what, 8, card_line)
        done(t0)

    phase("config 1's medium-level gradient: card against FD and the CPU")
    t0 = time.perf_counter()
    grad_checks(md, convert, entry, load_scene, dev, "config 1", SCENE)
    done(t0)

    phase(f"config 1's training step (128x128, 4 spp, depth 2): "
          f"{TRAIN_STEPS} steps of entry.train_step")
    t0 = time.perf_counter()
    k1b_launches = train_steps(entry, counters, load_scene, dev, card_line,
                               "config 1", SCENE, TRAIN_STEPS,
                               (128, 128, 4, 2), ("K1", "K1b"))["K1b"]
    done(t0)

    m1d_path = M1D_SCENES["config 3"][0]
    phase("config 3's medium-level gradient: card against FD and the CPU")
    t0 = time.perf_counter()
    grad_checks(md, convert, entry, load_scene, dev, "config 3", m1d_path)
    done(t0)

    k3b_launches = None
    for what, steps in (("config 3", TRAIN_STEPS), ("config 3b", 1)):
        phase(f"{what}'s training step (128x128, 16 spp, depth 2): "
              f"{steps} step(s) of entry.train_step")
        t0 = time.perf_counter()
        counts = train_steps(entry, counters, load_scene, dev, card_line,
                             what, M1D_SCENES[what][0], steps,
                             (128, 128, 16, 2), ("K3", "K3b"))
        k3b_launches = k3b_launches or counts["K3b"]
        check_k3_points(noise1d, f"{what}'s training steps")
        done(t0)

    phase("config 3's gradient through the CLI: python -m "
          "tungsten_tpu_torch.entry --scene scenes/gpis-mirror-1d.json "
          "--steps 1")
    t0 = time.perf_counter()
    train_cli(entry, counters, ["--scene", m1d_path], ("K3", "K3b"),
              card_line)
    done(t0)

    phase("config 5's (the hero's) medium-level gradient: card against FD "
          "and the CPU")
    t0 = time.perf_counter()
    grad_checks(md, convert, entry, load_scene, dev, "config 5", HERO_SCENE)
    done(t0)

    phase(f"config 5's training step (128x128, 16 spp, depth 2): "
          f"{TRAIN_STEPS} steps of entry.train_step")
    t0 = time.perf_counter()
    noise3d.K2_MOST_POINTS = noise3d.K2B_MOST_POINTS = 0
    k2b_launches = train_steps(entry, counters, load_scene, dev, card_line,
                               "config 5", HERO_SCENE, TRAIN_STEPS,
                               (128, 128, 16, 2), ("K2", "K2b"),
                               res=(128, 128), spp=16)["K2b"]
    check_k2_points(noise3d, "the hero's training steps")
    done(t0)

    rows = trender.MAX_RAYS // 1920
    phase(f"config 5's gradient through the CLI at 1920x1080, 1 spp (bands "
          f"of {rows} rows): python -m tungsten_tpu_torch.entry --scene "
          "scenes/gpis-hero.json --spp 1 --steps 1")
    t0 = time.perf_counter()
    train_cli(entry, counters, ["--scene", HERO_SCENE, "--spp", "1"],
              ("K2", "K2b"), card_line)
    check_k2_points(noise3d, "the hero's CLI step")
    done(t0)

    phase("config 2's two-segment medium-level gradient (renewal+ at the "
          "second segment's start): card against FD and the CPU")
    t0 = time.perf_counter()
    two_segment_grad_checks(md, convert, entry, load_scene, dev, "config 2",
                            ENS_SCENE)
    done(t0)

    # (8 of the scene's 16 spp: the run's time limit leaves room for the
    # GP layer's variants)
    phase(f"config 2's training step (256x256, 8 spp, depth 2, in 2 groups "
          f"of 4 samples): {TRAIN_STEPS} steps of entry.train_step")
    t0 = time.perf_counter()
    k1b_ens = train_steps(entry, counters, load_scene, dev, card_line,
                          "config 2", ENS_SCENE, TRAIN_STEPS,
                          (256, 256, 8, 2), ("K1", "K1b"), spp=8)["K1b"]
    done(t0)

    with tempfile.TemporaryDirectory() as tmp:
        ws0_path = os.path.join(tmp, "ws-trace.json")
        with open(ws0_path, "w") as fh:
            json.dump(ws_doc(step_size=0.0), fh)
        for what, path, gate in (("config 4a", WS_SCENE, True),
                                 ("config 4a, step_size 0", ws0_path, False)):
            phase(f"{what}'s medium-level gradient: card against FD"
                  + ("" if gate else " (printed, not held: K4's IFT is taken"
                     " at its trace's end point, off the root)")
                  + " and the CPU")
            t0 = time.perf_counter()
            grad_checks(md, convert, entry, load_scene, dev, what, path,
                        fd_gate=gate, lanes=True)
            done(t0)

        phase("config 4a's image-level gradient against FD (24x24, 16 "
              "passes, isotropic phase, event-linear pixels)")
        t0 = time.perf_counter()
        ws_image_grad_check(entry, convert, load_scene, dev, card_line)
        done(t0)

        for what, path, used, steps, fwd in (
                ("config 4a", WS_SCENE, ("K5",), TRAIN_STEPS, k5_launches),
                ("config 4a, step_size 0", ws0_path, ("K4",), 1,
                 k4_launches)):
            phase(f"{what}'s training step (128x128, 8 spp, depth 2): "
                  f"{steps} step(s) of entry.train_step")
            t0 = time.perf_counter()
            train_steps(entry, counters, load_scene, dev, card_line, what,
                        path, steps, (128, 128, 8, 2), used, per_step=fwd)
            done(t0)

    phase("timing runs (128x128)")
    t0 = time.perf_counter()
    noise1d.MOST_POINTS = wst.MARCH_LAUNCHES = wst.TRACE_LAUNCHES = 0
    searches.reset()
    scene128, _ = load_scene(SCENE, res_override=(128, 128), device=dev)
    ws128, _ = load_scene(WS_SCENE, res_override=(128, 128), device=dev)
    m1d128, _ = load_scene(M1D_SCENES["config 3"][0], device=dev)
    hero128, _ = load_scene(HERO_SCENE, res_override=(128, 128), device=dev)
    for what, sc, spp in (("config 1", scene128, 16), ("config 4a", ws128, 8),
                          ("config 3", m1d128, 16), ("config 5", hero128, 16),
                          ("config 2", ens128, 16)):
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
                                    device=dev)[0], HERO_GOLDEN, True),
            ("config 2", load_scene(ENS_SCENE, res_override=(64, 64),
                                    device=dev)[0], ENS_GOLDEN, True),
            *((what, load_scene(path, res_override=(64, 64), device=dev)[0],
               gold, True) for what, (path, gold) in FS_SCENES.items())):
        ours = (trender.render(sc, 48, device=dev) / 48).cpu().numpy()
        ratio, frac_bad = golden_bucket_test(ours, read_pfm(gold), 48)
        print(f"{what}: energy ratio {ratio:.4f} (0.9-1.1), frac_bad "
              f"{frac_bad:.4f} (< 0.08)", flush=True)
        if gate and not (0.9 < ratio < 1.1 and frac_bad < 0.08):
            raise RuntimeError(f"the golden bucket test of {what} failed")
    for name in WS_FNS:  # the timing and golden renders too
        searches.check(name, "the timing and golden renders")
    check_k3_points(noise1d, "the timing and golden renders")
    check_k2_points(noise3d, "the timing and golden renders")
    done(t0)

    if args.profile:
        phase("profile (128x128)")
        t0 = time.perf_counter()
        profile(trender, noise3d, wst, searches, lattice, scene128, ws128,
                scene_from_dict(ws_doc(0.0), device=dev)[0], dev, card_line)
        ws_kernel_parts(searches, ws_scene_full.media[0], dev, card_line)
        ws_realization_runs(trender, wst, searches, ws_scenes, dev,
                            card_line, twins=True)
        profile_render(trender, "config 3", m1d128, 16, noise1d, "LAUNCHES",
                       "noise1d_sum_kernel", "K3",
                       "profile_mirror1d_16spp.txt", dev, card_line,
                       "noise1d_sum", lattice["K3"])
        profile_render(trender, "config 5", hero128, 16, noise3d,
                       "K2_LAUNCHES", "noise3d_sum_kernel", "K2",
                       "profile_hero_16spp.txt", dev, card_line,
                       "noise3d_sum", lattice["K2"])
        check_k3_points(noise1d, "the profiled renders")
        check_k2_points(noise3d, "the profiled renders")
        profile_grad(entry, noise3d, {
            "K1": ("noise3d_sum_s", "noise3d_sum_s_kernel"),
            "K1b": ("noise3d_sum_s_bwd", "noise3d_sum_s_bwd_kernel")},
            lattice, load_scene, "config 1", SCENE, dev, card_line)
        profile_grad(entry, noise1d, {
            "K3": ("noise1d_sum", "noise1d_sum_kernel"),
            "K3b": ("noise1d_sum_bwd", "noise1d_sum_bwd_kernel")},
            lattice, load_scene, "config 3", m1d_path, dev, card_line)
        profile_grad(entry, noise3d, {
            "K2": ("noise3d_sum", "noise3d_sum_kernel"),
            "K2b": ("noise3d_sum_bwd", "noise3d_sum_bwd_kernel")},
            lattice, load_scene, "config 5", HERO_SCENE, dev, card_line,
            res=(128, 128), spp=16)
        profile_render(trender, "config 2", ens128, 16, noise3d, "LAUNCHES",
                       "noise3d_sum_s_kernel", "K1",
                       "profile_ensemble_16spp.txt", dev, card_line,
                       "noise3d_sum_s", lattice["K1"])
        profile_grad(entry, noise3d, {
            "K1": ("noise3d_sum_s", "noise3d_sum_s_kernel"),
            "K1b": ("noise3d_sum_s_bwd", "noise3d_sum_s_bwd_kernel")},
            lattice, load_scene, "config 2", ENS_SCENE, dev, card_line,
            res=(128, 128), spp=16)
        with tempfile.TemporaryDirectory() as tmp:
            ws0_path = os.path.join(tmp, "ws-trace.json")
            with open(ws0_path, "w") as fh:
                json.dump(ws_doc(step_size=0.0), fh)
            for what, path, name in (("config 4a", WS_SCENE, "K5"),
                                     ("config 4a, step_size 0", ws0_path,
                                      "K4")):
                profile_ws_step(entry, searches, load_scene, what, path, dev,
                                card_line, name)
        done(t0)

    # the phases that start processes on the card come last, after every
    # torch.profiler measurement
    phase("config 5, the hero (1920x1080, 1 spp), sharded over two gloo "
          "ranks on the card: each rank's 540 rows in bands, the film "
          "all-gathered")
    t0 = time.perf_counter()
    hero_sharded(hero_frame, card_line)
    done(t0)

    phase("config 1 (128x128, 4 spp) through render.render(sharded=True) in "
          "an NCCL process group of one rank")
    t0 = time.perf_counter()
    nccl_world_one(trender, noise3d, load_scene, dev, card_line)
    done(t0)

    phase("config 1's training step (128x128, 4 spp) sharded over two gloo "
          "ranks on the card: entry.train_step_sharded, twice")
    t0 = time.perf_counter()
    sharded_step_phase(card_line)
    done(t0)

    phase("the render driver's options through the CLI (config 1, "
          "128x128): --checkpoint-interval/--resume, --aovs, --serve, "
          "--profile, -o *.exr, --adaptive, --data-dump-pixel, --sampler "
          "sobol (64x64, 48 spp, against the golden)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        driver_options(trender, read_pfm, noise3d, tmp, card_line)
    done(t0)

    # last, so that the variants' CPU renders and gradients, started after
    # the build, are done by now
    t_variants = time.perf_counter()
    try:
        tag_launches, k8_new, k8_by_n = gp_layer_variants(
            trender, scene_from_dict, wst, searches, counters, psd, gpmod,
            noise3d, lattice, dev, variant_docs_, cpu_refs, variant_tmp,
            card_line)
        print(f"the GP layer's variants in "
              f"{time.perf_counter() - t_variants:.1f} s", flush=True)
        t_grad = time.perf_counter()
        grad_totals, grad_walls = gradient_variants(
            entry, convert, md, noise3d, counters, load_scene, dev,
            grad_docs, cpu_grads, variant_tmp, card_line)
        print(f"the gradient variants in {time.perf_counter() - t_grad:.1f}"
              " s: steps " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in grad_walls.items())
              + "; launches over the steps " + ", ".join(
                  f"{k} {v}" for k, v in grad_totals.items()), flush=True)
        rows = trender.MAX_RAYS // 1920
        path = os.path.join(variant_tmp, "hero-bruteforce.json")
        phase(f"hero-bruteforce's gradient through the CLI at 1920x1080, 1 "
              f"spp (bands of {rows} rows): python -m tungsten_tpu_torch."
              "entry --scene hero-bruteforce.json --spp 1 --steps 1")
        t0 = time.perf_counter()
        bf = train_cli(entry, counters, ["--scene", path, "--spp", "1"],
                       ("K2", "K2b"), card_line)
        for k, v in bf.items():
            grad_totals[k] = grad_totals.get(k, 0) + v
        check_k2_points(noise3d, "hero-bruteforce's CLI step")
        done(t0)
    finally:
        cpu_pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(variant_tmp, ignore_errors=True)

    if "jax" in sys.modules or "tungsten_tpu" in sys.modules:
        raise RuntimeError("the port imported jax or the JAX package")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card_line, flush=True)
    kernels = []
    # (the lattice kernels' launches: their BASELINE phases' and the
    # gradient variants' steps)
    extra = grad_totals.get
    for name, src, line, launched, err, (t_k, t_p, b_ms, b_by, b_cls) in (
            ("K1 noise3d_sum_s", "noise3d.cu", "sparse_conv_pallas.py:144",
             k1_launches + k1_ens + extra("K1", 0), k1_err,
             k1_times[K1_MAIN_POINTS]),
            ("K1b noise3d_sum_s_bwd", "noise3d.cu",
             "sparse_conv_pallas.py:234 _noise3d_sum_s_bwd",
             k1b_launches + k1b_ens + extra("K1b", 0), k1b_err,
             k1b_times[K1B_LINE_POINTS]),
            ("K1b noise3d_sum_s_bwd (full form: an anisoMtx in world space)",
             "noise3d.cu", "sparse_conv_pallas.py:234 _noise3d_sum_s_bwd",
             extra("K1b full", 0), full_numbers["K1b full"][0],
             full_numbers["K1b full"][1][K1B_LINE_POINTS]),
            ("K2 noise3d_sum", "noise3d.cu", "sparse_conv_pallas.py:136",
             k2_launches + extra("K2", 0), k2_err,
             k2_times[K2_LINE_POINTS]),
            ("K2b noise3d_sum_bwd", "noise3d.cu",
             "sparse_conv_pallas.py:179 _noise3d_sum_bwd",
             k2b_launches + extra("K2b", 0), k2b_err,
             k2b_times[K2B_LINE_POINTS]),
            ("K2b noise3d_sum_bwd (full form: an anisoMtx in world space)",
             "noise3d.cu", "sparse_conv_pallas.py:179 _noise3d_sum_bwd",
             extra("K2b full", 0), full_numbers["K2b full"][0],
             full_numbers["K2b full"][1][K2B_LINE_POINTS]),
            ("K3 noise1d_sum", "noise1d.cu", "sparse_conv_pallas.py:321",
             m1d["config 3"] + extra("K3", 0), k3_err,
             k3_times[K3_LINE_POINTS]),
            ("K3b noise1d_sum_bwd", "noise1d.cu",
             "sparse_conv_pallas.py:340 _noise1d_sum_bwd",
             k3b_launches + extra("K3b", 0), k3b_err,
             k3b_times[K3B_LINE_POINTS])):
        if launched <= 0:
            raise RuntimeError(f"{name} was launched no time on its main "
                               "paths")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tungsten_tpu_torch/csrc/{src}",
            "replaces": f"tungsten_tpu/ops/{line}", "launches": launched,
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
            "bound_by": b_by, "bound_class": b_cls, "library_ms": None})
    for name, fn, line, launched in (("K5", "ws_march", 169, k5_launches),
                                     ("K4", "ws_trace", 45, k4_launches)):
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda",
            "source": "tungsten_tpu_torch/csrc/ws_trace.cu",
            "replaces": f"tungsten_tpu/ops/ws_trace_pallas.py:{line}",
            "launches": launched, **ws_numbers[name], "library_ms": None})
    for tag, numbers in ws_tag_numbers.items():
        for name, fn, line in (("K5", "ws_march", 169),
                               ("K4", "ws_trace", 45)):
            kernels.append({
                "name": f"{name} {fn} ({tag})", "route": "cuda",
                "source": "tungsten_tpu_torch/csrc/ws_trace.cu",
                "replaces": f"tungsten_tpu/ops/ws_trace_pallas.py:{line}",
                "launches": tag_launches[(name, tag)], **numbers[name],
                "library_ms": None})
    kernels.append({
        "name": "K8 jacobi_eigh", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/psd.cu",
        "replaces": "tungsten_tpu/ops/gp.py:127,148 jnp.linalg.eigh",
        "launches": sum(fs_k8.values()), **k8_numbers})
    for n, numbers in sorted(k8_new.items()):
        kernels.append({
            "name": f"K8 jacobi_eigh (n = {n}: the function-space Global and "
                    "None contexts)", "route": "cuda",
            "source": "tungsten_tpu_torch/csrc/psd.cu",
            "replaces": "tungsten_tpu/ops/gp.py:127,148 jnp.linalg.eigh",
            "launches": k8_by_n[n], **numbers})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        # a failed phase leaves no CPU render behind
        for pool in _POOLS:
            pool.shutdown(wait=True, cancel_futures=True)
