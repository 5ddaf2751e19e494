"""Kernels K1, K1b, K2, K2b, K3, K3b, K5, K4 and K8 on the card, against
their plain PyTorch twins (K1b and K2b also in their full-form instances,
on box-aniso's anisoMtx; K2 also on the brute-force nonstationary
branch's arguments, K8 also at the Global and None contexts' sizes), the
config-1, config-4a, config-3 and hero renders on the card against the
same renders on the CPU, the function-space renders (config 4b and its
CSG union) through K8 alone, its Global, None, skip and mesh-conditioned
variants against the CPU,
the training steps of configs 1, 3 and 5 on the card against the same
steps on the CPU, a render sharded over two gloo ranks that share the
card against the single-process render, and `dryrun_multichip` on the
card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they are
marked `cuda` and skip without one.  They import no JAX, so they run on a
machine that has only PyTorch:
`python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`.

Tolerances: K1 and K2 vs twin atol 1e-5 (a raw sum of at most 81
unit-bounded fp32 terms; K1 measured 0 on an H100); K1b and K3b vs their
twins run on the card, whose torch.exp is the kernels' expf: dp (dpz) bit
for bit (the twins add each point's terms in the kernels' order with
their operations), the partials summed over points (float64 in both, in
other orders, each rounded once to float32) within SUM_ULPS = 0 float32
ulps (summing in float32 misses it by up to tens of ulps: PERF.md), and
two launches on the same inputs bit for bit, also on two streams at once;
K2b vs its twin run
on the card, whose torch.exp is the kernel's expf: dp and the per-point
partials in (kr, qm, m00, m11, m22) within 1e-5 * (1 + |x|), their sums
over points within 1e-4 (against the CPU's twin one ulp of exp moves the kr
partial by up to ~2e-4: at the finest level it is a difference of terms
up to ~1e3); K3 vs twin atol 1e-5
(at most 9 such terms).  K5/K4 vs twin, one whole search of 4096 rays of
config 4a at n = 1024 (the shared-memory tile) and n = 1100 (beyond it):
hit, sign0 or the step count differ on at most 0.1% of rays (the warp
sums add in another order than the twin's, so a value within rounding of
0 may decide otherwise), and t, the value and the gradient of the other
rays within 1e-5 * (1 + |twin|).  GPU vs CPU render
at 8x8, 1 spp: at least 97% of pixels within 1e-3 * (1 + |cpu|) and means
within 1% (the elementwise math around the kernels may round differently
on the two devices, and an ulp can flip one ray's crossing).  The 16x16,
1-spp training steps: loss, new parameters and gradient within 1e-3
relative of the CPU's.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.kernels import noise1d, noise3d
from tungsten_tpu_torch.kernels import ws_trace as wst
from tungsten_tpu_torch.models import media as md
from tungsten_tpu_torch.scene.parse import load_scene, scene_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")
M1D_PLAIN_SCENE = os.path.join(ROOT, "scenes", "gpis-mirror-1d.json")
WS_SCENE = os.path.join(ROOT, "scenes", "gpis-weight-space.json")
M1D_SCENE = os.path.join(ROOT, "scenes", "gpis-mirror-1d-corrxy.json")
HERO_SCENE = os.path.join(ROOT, "scenes", "gpis-hero.json")
SUM_ULPS = 0  # K1b's and K3b's float32 sums over points against twins


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k1_kernel_matches_twin_on_the_card(cuda, K):
    scene, _ = load_scene(SCENE, device="cpu")
    cov = scene.media[0].gp.cov
    m6 = cov.splat_form().tolist() + [0.0, 0.0, 0.0]
    kr = float(cov.splat_radius())
    r = np.random.default_rng(11)
    n = 1 << 16
    p = torch.from_numpy(r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32))
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64))
    before = noise3d.LAUNCHES
    got = noise3d.noise3d_sum_s(p.to(cuda), seed.to(cuda), kr, m6, K)
    torch.cuda.synchronize()
    assert noise3d.LAUNCHES == before + 1
    want = noise3d.noise3d_sum_s_ref(p, seed, kr, m6, K)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def _aniso(cov):
    """The covariance over the anisoMtx of tools/gp_variants.py's
    box-aniso (a full splat form in world space)."""
    from tungsten_tpu_torch.tools.gp_variants import ANISO_MTX
    return dataclasses.replace(cov, aniso_mtx=torch.tensor(ANISO_MTX))


def _k1b_on_the_card(cuda, n, K, rng_seed=23, full=False):
    """K1b at n random points against its twin run on the card: dp bit for
    bit, the four sums (full: seven, the full instance on box-aniso's
    form) within SUM_ULPS float32 ulps; a second launch must give the same
    dp and sums bit for bit (the ticket was reset)."""
    scene, _ = load_scene(SCENE, device="cpu")
    cov = scene.media[0].gp.cov
    if full:
        cov = _aniso(cov)
        host = noise3d.host_params(cov.splat_radius(),
                                   noise3d.form6(cov.splat_form()))
    else:
        host = noise3d.host_params(cov.splat_radius(), cov.splat_form())
    r = np.random.default_rng(rng_seed)
    p = torch.from_numpy(r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32))
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    args = (p.to(cuda), seed.to(cuda), host[0], host[1:], K, g.to(cuda))
    counter = "K1B_FULL_LAUNCHES" if full else "K1B_LAUNCHES"
    before = getattr(noise3d, counter)
    dp, sums = noise3d.noise3d_sum_s_bwd(*args)
    again = noise3d.noise3d_sum_s_bwd(*args)
    torch.cuda.synchronize()
    assert getattr(noise3d, counter) == before + 2
    assert dp.shape == (n, 3) and sums.shape == (7 if full else 4,)
    assert sums.dtype == torch.float32
    assert torch.equal(again[0], dp) and torch.equal(again[1], sums)
    dp_t, sums_t = noise3d.noise3d_sum_s_bwd_ref(*args)
    assert torch.equal(dp, dp_t)
    np.testing.assert_array_max_ulp(sums.cpu().numpy(), sums_t.cpu().numpy(),
                                    maxulp=SUM_ULPS)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k1b_kernel_matches_twin_on_the_card(cuda, K):
    _k1b_on_the_card(cuda, (1 << 16) + 3, K)  # a ragged tail


@pytest.mark.cuda
def test_k1b_ring_overflow_on_the_card(cuda):
    # K = 8: ~33.5 impulses within reach of a point, more than the ring
    # holds, so the warps drain inside the walk
    _k1b_on_the_card(cuda, 1 << 14, 8, rng_seed=37)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 4097, 3 * (1 << 18) + 1])
def test_k1b_sizes_on_the_card(cuda, n):
    # one point, under one block, not a multiple of a block, more points
    # than a wave of threads holds
    _k1b_on_the_card(cuda, n, 3, rng_seed=n)


@pytest.mark.cuda
def test_train_step_on_the_card_goes_through_k1b_and_matches_cpu(cuda):
    _train_step_on_the_card_matches_cpu(
        cuda, SCENE, lambda: noise3d.LAUNCHES > 0 and noise3d.K1B_LAUNCHES > 0)
    assert noise1d.LAUNCHES == 0 and noise1d.K3B_LAUNCHES == 0


def _k3b_on_the_card(cuda, n, K, rng_seed=29):
    """K3b at n random points against its twin run on the card: dpz bit for
    bit, d/dkr within SUM_ULPS float32 ulps; a second launch must give the
    same dpz and d/dkr bit for bit (the ticket was reset)."""
    r = np.random.default_rng(rng_seed)
    pz = torch.from_numpy(r.uniform(-6.0, 6.0, n).astype(np.float32))
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    args = (pz.to(cuda), seed.to(cuda), 3.0, K, g.to(cuda))
    before = noise1d.K3B_LAUNCHES
    dpz, dkr = noise1d.noise1d_sum_bwd(*args)
    again = noise1d.noise1d_sum_bwd(*args)
    torch.cuda.synchronize()
    assert noise1d.K3B_LAUNCHES == before + 2
    assert dpz.shape == (n,) and dkr.shape == ()
    assert torch.equal(again[0], dpz) and torch.equal(again[1], dkr)
    dpz_t, dkr_t = noise1d.noise1d_sum_bwd_ref(*args)
    assert torch.equal(dpz, dpz_t)
    np.testing.assert_array_max_ulp(dkr.cpu().numpy(), dkr_t.cpu().numpy(),
                                    maxulp=SUM_ULPS)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 8])
def test_k3b_kernel_matches_twin_on_the_card(cuda, K):
    _k3b_on_the_card(cuda, (1 << 16) + 3, K)  # a ragged tail


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 4097, 3 * (1 << 20) + 1])
def test_k3b_sizes_on_the_card(cuda, n):
    # one point, under one block, not a multiple of a block, more points
    # than a wave of threads holds
    _k3b_on_the_card(cuda, n, 3, rng_seed=n)


@pytest.mark.cuda
def test_backwards_through_autograd_launch_once(cuda):
    r = np.random.default_rng(41)
    n = 4096
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64)).to(cuda)
    g = torch.from_numpy(r.normal(size=n).astype(np.float32)).to(cuda)
    p = torch.from_numpy(r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32))
    p = p.to(cuda).requires_grad_()
    kr = torch.tensor(0.3, device=cuda, requires_grad=True)
    m3 = torch.tensor([2.0, 3.0, 4.0], device=cuda, requires_grad=True)
    host = noise3d.host_params(kr, m3)
    out = noise3d.noise3d_sum_s_diff(p, seed, kr, m3, 3, host)
    before = noise3d.K1B_LAUNCHES
    dp, dkr, dm = torch.autograd.grad(out, (p, kr, m3), g)
    assert noise3d.K1B_LAUNCHES == before + 1
    want = noise3d.noise3d_sum_s_bwd_ref(p.detach(), seed, host[0],
                                         host[1:], 3, g)
    assert torch.equal(dp, want[0])
    np.testing.assert_array_max_ulp(
        torch.cat([dkr.reshape(1), dm]).cpu().numpy(), want[1].cpu().numpy(),
        maxulp=SUM_ULPS)
    pz = (p.detach()[:, 0] * 10.0).requires_grad_()
    kr1 = torch.tensor(3.0, device=cuda, requires_grad=True)
    out = noise1d.noise1d_sum_diff(pz, seed, kr1, 3)
    before = noise1d.K3B_LAUNCHES
    dpz, dkr1 = torch.autograd.grad(out, (pz, kr1), g)
    assert noise1d.K3B_LAUNCHES == before + 1
    want = noise1d.noise1d_sum_bwd_ref(pz.detach(), seed, 3.0, 3, g)
    assert torch.equal(dpz, want[0])
    np.testing.assert_array_max_ulp(dkr1.cpu().numpy(),
                                    want[1].cpu().numpy(), maxulp=SUM_ULPS)


@pytest.mark.cuda
def test_backwards_on_two_streams_at_once(cuda):
    # K1b and K3b launched in turn on two streams, whose launches overlap:
    # each stream takes its own ticket, so every launch's sums are those
    # of a launch alone
    r = np.random.default_rng(43)
    n = 1 << 18
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64)).to(cuda)
    g = torch.from_numpy(r.normal(size=n).astype(np.float32)).to(cuda)
    p = torch.from_numpy(r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32))
    p = p.to(cuda)
    a1 = (p, seed, 0.3, (2.0, 3.0, 4.0), 3, g)
    a3 = (p[:, 0] * 10.0, seed, 3.0, 3, g)
    want = (noise3d.noise3d_sum_s_bwd(*a1)[1], noise1d.noise1d_sum_bwd(*a3)[1])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                got.append((noise3d.noise3d_sum_s_bwd(*a1)[1],
                            noise1d.noise1d_sum_bwd(*a3)[1]))
    torch.cuda.synchronize()
    for sums, dkr in got:
        assert torch.equal(sums, want[0]) and torch.equal(dkr, want[1])


@pytest.mark.cuda
def test_train_step_on_the_card_goes_through_k3b_and_matches_cpu(cuda):
    _train_step_on_the_card_matches_cpu(
        cuda, M1D_PLAIN_SCENE,
        lambda: noise1d.LAUNCHES > 0 and noise1d.K3B_LAUNCHES > 0)
    assert noise3d.LAUNCHES == 0 and noise3d.K1B_LAUNCHES == 0


def _train_step_on_the_card_matches_cpu(cuda, path, launched):
    """A 16x16, 1-spp training step on the card against the same step on
    the CPU; `launched()` says whether it went through the kernels."""
    from tungsten_tpu_torch import entry
    scene, _ = load_scene(path, res_override=(16, 16), device="cpu")
    target = torch.zeros(16, 16, 3)
    ref = entry.train_step(scene, target, torch.arange(1))
    noise3d.LAUNCHES = noise3d.K1B_LAUNCHES = 0
    noise3d.K2_LAUNCHES = noise3d.K2B_LAUNCHES = 0
    noise1d.LAUNCHES = noise1d.K3B_LAUNCHES = 0
    got = entry.train_step(trender.to_device(scene, cuda), target.to(cuda),
                           torch.arange(1, device=cuda))
    assert launched()
    for a, b in ((got[0], ref[0]), (got[1], ref[1]), (got[2], ref[2]),
                 *zip(got[3], ref[3])):
        assert bool(torch.isfinite(a))
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3)
    assert float(got[3][0]) != 0.0 and float(got[3][1]) != 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k2_kernel_matches_twin_on_the_card(cuda, K):
    scene, _ = load_scene(HERO_SCENE, device="cpu")
    base = scene.media[0].gp.cov.base
    m6 = base.splat_form().tolist() + [0.0, 0.0, 0.0]
    r = np.random.default_rng(19)
    n = (1 << 16) + 7  # a ragged tail
    p = torch.from_numpy(r.uniform(-1.0, 2.0, (n, 3)).astype(np.float32))
    lvl = r.integers(-1, 3, n)
    s = np.float32(2.5) ** lvl.astype(np.float32)
    # seeds offset by the level, wrapping at 2^32
    seed = torch.from_numpy((r.integers(0, 2 ** 32, n, dtype=np.uint64)
                             .astype(np.int64) + lvl) % 2 ** 32)
    kr = torch.from_numpy(np.float32(float(base.splat_radius())) * s)
    qm = torch.from_numpy(np.float32(1.0) / (s * s))
    before = noise3d.K2_LAUNCHES
    got = noise3d.noise3d_sum(p.to(cuda), seed.to(cuda), kr.to(cuda),
                              qm.to(cuda), m6, K)
    torch.cuda.synchronize()
    assert noise3d.K2_LAUNCHES == before + 1 and noise3d.K2_MOST_POINTS >= n
    want = noise3d.noise3d_sum_ref(p, seed, kr, qm, m6, K)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("iso", [False, True])
def test_k2_kernel_on_brute_force_arguments_matches_twin_on_the_card(cuda,
                                                                     iso):
    """K2 on the brute-force nonstationary branch's launch arguments
    (tools/gp_variants.py's hero-bruteforce): one cell radius for every
    lane (the base's at max(ls) in world space, kernel_scale in isotropic
    space), the per-lane form scale 1 / (ls(p) / max(ls))^2 (over max(ls)^2
    in world space) and, in world space, the seeds offset by the level of
    max(ls); atol 1e-5 of the twin."""
    from tungsten_tpu_torch.tools.gp_variants import variant_docs
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        doc = variant_docs(tmp)["hero-bruteforce"][1]
        scene, _ = scene_from_dict(doc, device="cpu")
    cov = scene.media[0].gp.cov
    r = np.random.default_rng(31)
    n = (1 << 18) + 5
    p = torch.from_numpy(r.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
                         + np.float32([0.0, 0.9, 0.0]))
    ml = torch.tensor(cov.max_ls)
    ls = cov.nonstat_splat_kernel_scale(p)
    inv = 1.0 / torch.clamp(ls * ls, min=1e-12)
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64))
    if iso:
        kr_f, qm, m6 = cov.splat_radius_iso(), inv, (0.5, 0.5, 0.5, 0, 0, 0)
        p = cov.pos_world_to_local(p)
    else:
        kr_f = float(cov.base.splat_radius() * ml)
        qm = inv / (ml * ml)
        m6 = tuple(cov.base.splat_form().tolist()) + (0.0, 0.0, 0.0)
        seed = (seed + int(np.floor(np.log(np.float32(cov.max_ls))
                                    / np.log(np.float32(2.5))))) % 2 ** 32
    kr = torch.full((n,), kr_f)
    before = noise3d.K2_LAUNCHES
    got = noise3d.noise3d_sum(p.contiguous().to(cuda), seed.to(cuda),
                              kr.to(cuda), qm.contiguous().to(cuda), m6, 3)
    torch.cuda.synchronize()
    assert noise3d.K2_LAUNCHES == before + 1
    want = noise3d.noise3d_sum_ref(p.contiguous(), seed, kr, qm.contiguous(),
                                   m6, 3)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    assert float(want.abs().max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k1b_full_instance_matches_twin_on_the_card(cuda, K):
    _k1b_on_the_card(cuda, (1 << 16) + 3, K, full=True)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k2b_kernel_matches_twin_on_the_card(cuda, K):
    _k2b_on_the_card(cuda, K)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k2b_full_instance_matches_twin_on_the_card(cuda, K):
    _k2b_on_the_card(cuda, K, full=True)


def _k2b_on_the_card(cuda, K, full=False):
    """K2b on the hero's levels against its twin run on the card (full:
    the full instance, on the hero's base over box-aniso's anisoMtx)."""
    scene, _ = load_scene(HERO_SCENE, device="cpu")
    base = scene.media[0].gp.cov.base
    if full:
        base = _aniso(base)
        m3 = noise3d.form6(base.splat_form()).tolist()
    else:
        m3 = base.splat_form().tolist()
    r = np.random.default_rng(31)
    n = (1 << 16) + 5  # a ragged tail
    p = torch.from_numpy(r.uniform(-1.0, 2.0, (n, 3)).astype(np.float32))
    lvl = r.integers(-1, 3, n)
    s = np.float32(2.5) ** lvl.astype(np.float32)
    seed = torch.from_numpy((r.integers(0, 2 ** 32, n, dtype=np.uint64)
                             .astype(np.int64) + lvl) % 2 ** 32)
    kr = torch.from_numpy(np.float32(float(base.splat_radius())) * s)
    qm = torch.from_numpy(np.float32(1.0) / (s * s))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    counter = "K2B_FULL_LAUNCHES" if full else "K2B_LAUNCHES"
    before = getattr(noise3d, counter)
    dp, part = noise3d.noise3d_sum_bwd(p.to(cuda), seed.to(cuda),
                                       kr.to(cuda), qm.to(cuda), m3, K,
                                       g.to(cuda))
    torch.cuda.synchronize()
    assert getattr(noise3d, counter) == before + 1
    assert part.shape == (n, 8 if full else 5)
    dp_t, part_t = noise3d.noise3d_sum_bwd_ref(
        p.to(cuda), seed.to(cuda), kr.to(cuda), qm.to(cuda), m3, K,
        g.to(cuda))
    for got, want in ((dp, dp_t), (part, part_t)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        part.cpu().double().sum(0).numpy(),
        part_t.cpu().double().sum(0).numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_hero_train_step_on_the_card_goes_through_k2b_and_matches_cpu(cuda):
    _train_step_on_the_card_matches_cpu(
        cuda, HERO_SCENE,
        lambda: noise3d.K2_LAUNCHES > 0 and noise3d.K2B_LAUNCHES > 0)
    assert noise3d.LAUNCHES == 0 and noise3d.K1B_LAUNCHES == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k3_kernel_matches_twin_on_the_card(cuda, K):
    r = np.random.default_rng(17)
    n = (1 << 16) + 5  # a ragged tail
    pz = torch.from_numpy(r.uniform(-40.0, 40.0, n).astype(np.float32))
    seed = torch.from_numpy(r.integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.int64))
    before = noise1d.LAUNCHES
    got = noise1d.noise1d_sum(pz.to(cuda), seed.to(cuda), 3.0, K)
    torch.cuda.synchronize()
    assert noise1d.LAUNCHES == before + 1 and noise1d.MOST_POINTS >= n
    want = noise1d.noise1d_sum_ref(pz, seed, 3.0, K)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def _ws_start(kernel, device, n, R=4096, cov=None):
    """R rays of config 4a (with covariance `cov`, a scene file entry, if
    given) in its bounding cube with their realization keys, and the rest
    of K5's or K4's arguments: (function, arguments)."""
    if cov is None:
        scene, _ = load_scene(WS_SCENE, device=device)
    else:
        import json
        with open(WS_SCENE) as f:
            doc = json.load(f)
        doc["media"][0]["gaussian_process"]["covariance"] = cov
        scene, _ = scene_from_dict(doc, device=device)
    med = scene.media[0]
    r = np.random.default_rng(13)
    u = r.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    ro = np.array([0.0, 0.9, 0.0]) + u * r.uniform(0.0, 0.7, (R, 1))
    rd = r.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    pss = r.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(np.int64)
    ro, rd, uj = (torch.from_numpy(x.astype(np.float32)).to(device)
                  for x in (ro, rd, r.uniform(size=R)))
    near = torch.zeros(R, device=device)
    far = md._far_eff(med, ro, rd, near,
                      torch.full((R,), 3e38, device=device))
    key = md._ws_key(med, torch.from_numpy(pss).to(device))
    if kernel == "march":
        step = torch.clamp(torch.minimum(med.step_size,
                                         (far - near) / med.min_step),
                           min=1e-6)
        absorb = torch.arange(R, device=device) % 3 == 0
        return "fixed_march_batch", (med.gp, n, key, ro, rd, near, far, step,
                                     uj, absorb, med.max_march_steps)
    return "sphere_trace_batch", (med.gp, n, key, ro, rd, near, far)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1100])
@pytest.mark.parametrize("kernel", ["march", "trace"])
def test_ws_kernel_matches_twin_on_the_card(cuda, kernel, n):
    name, args = _ws_start(kernel, cuda, n)
    counter = "MARCH_LAUNCHES" if kernel == "march" else "TRACE_LAUNCHES"
    before = getattr(wst, counter)
    got = getattr(wst, name)(*args)
    torch.cuda.synchronize()
    assert getattr(wst, counter) == before + 1
    want = getattr(wst, name + "_ref")(*args)
    decided = ((got["hit"] != want["hit"]) | (got["sign0"] != want["sign0"])
               | (got["steps"] != want["steps"]))
    off = decided.clone()
    for k in ("t", "val", "grad"):
        err = (got[k] - want[k]).abs() > 1e-5 * (1.0 + want[k].abs())
        off |= err if err.dim() == 1 else err.any(dim=1)
    assert 0.1 < float(want["hit"].float().mean()) < 0.99
    assert int(off.sum()) <= 0.001 * off.shape[0], int(off.sum())


# one covariance per K5/K4 instance beside the squared exponential's
WS_TAG_COVS = {
    "rq": {"type": "rational_quadratic", "sigma": 0.06, "lengthScale": 0.12,
           "a": 1.5},
    "matern": {"type": "matern", "sigma": 0.06, "lengthScale": 0.12,
               "v": 1.5},
    "gabor_aniso": {"type": "gabor_aniso", "sigma": 0.06, "a_inv": 0.3,
                    "f_inv": 0.3},
    "gabor_iso": {"type": "gabor_iso", "sigma": 0.06, "a_inv": 0.3,
                  "f_inv": 0.3}}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["march", "trace"])
@pytest.mark.parametrize("tag", sorted(WS_TAG_COVS))
def test_ws_kernel_instances_match_twin_on_the_card(cuda, tag, kernel):
    """Each covariance's K5/K4 instance (its own spectral draw) against the
    twin, which draws with the covariance's sample_spectral_3d, with the
    gates of chip_smoke.py."""
    name, args = _ws_start(kernel, cuda, 1024, cov=WS_TAG_COVS[tag])
    wst.LAUNCHES_BY_TAG.clear()
    got = getattr(wst, name)(*args)
    torch.cuda.synchronize()
    want = getattr(wst, name + "_ref")(*args)
    assert set(wst.LAUNCHES_BY_TAG.values()) == {1}
    assert [k for k, _ in wst.LAUNCHES_BY_TAG] == [
        "ws_march" if kernel == "march" else "ws_trace"]
    off = ((got["hit"] != want["hit"]) | (got["sign0"] != want["sign0"])
           | (got["steps"] != want["steps"]))
    for k in ("t", "val", "grad"):
        err = (got[k] - want[k]).abs() > 1e-5 * (1.0 + want[k].abs())
        off |= err if err.dim() == 1 else err.any(dim=1)
    assert 0.1 < float(want["hit"].float().mean()) < 0.99
    assert int(off.sum()) <= 0.001 * off.shape[0], int(off.sum())


@pytest.mark.cuda
def test_render_on_the_card_goes_through_k1_and_matches_cpu(cuda):
    _render_on_the_card_matches_cpu(cuda, SCENE, "k1")


@pytest.mark.cuda
def test_ws_render_on_the_card_goes_through_k5_and_matches_cpu(cuda):
    _render_on_the_card_matches_cpu(cuda, WS_SCENE, "k5")


@pytest.mark.cuda
def test_mirror_1d_render_on_the_card_goes_through_k3_and_matches_cpu(cuda):
    _render_on_the_card_matches_cpu(cuda, M1D_SCENE, "k3")


@pytest.mark.cuda
def test_hero_render_on_the_card_goes_through_k2_and_matches_cpu(cuda):
    _render_on_the_card_matches_cpu(cuda, HERO_SCENE, "k2")


def _render_on_the_card_matches_cpu(cuda, path, kernel):
    scene, _ = load_scene(path, res_override=(8, 8), device="cpu")
    ref = trender.render(scene, 1, device="cpu").numpy()
    noise3d.LAUNCHES = noise3d.K2_LAUNCHES = noise1d.LAUNCHES = 0
    wst.MARCH_LAUNCHES = 0
    got = trender.render(scene, 1, device=cuda).cpu().numpy()
    if kernel == "k1":
        assert noise3d.LAUNCHES > 0 and noise1d.LAUNCHES == 0
    elif kernel == "k2":
        assert noise3d.K2_LAUNCHES > 0 and noise3d.LAUNCHES == 0
    elif kernel == "k3":
        assert noise1d.LAUNCHES > 0 and noise3d.LAUNCHES == 0
    else:
        assert wst.MARCH_LAUNCHES > 0 and noise3d.LAUNCHES == 0
    assert np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert ok.mean() >= 0.97, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())


def _k8_blocks(n, B, seed):
    """B symmetric PSD n x n squared-exponential covariances of n points
    along random segments (sigma 0.06, l 0.12: near-singular, as the
    function-space chunks' are)."""
    r = np.random.default_rng(seed)
    ts = np.linspace(0.0, 1.0, n)[None] * r.uniform(0.2, 1.6, (B, 1))
    d = ts[:, :, None] - ts[:, None, :]
    return torch.from_numpy((0.0036 * np.exp(-d * d / 0.0288)).astype(
        np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 16, 17, 32, 33, 34, 64])
def test_k8_kernel_matches_twin_on_the_card(cuda, n):
    """K8 against torch.linalg.eigh with chip_smoke.py's limits (the
    root's is tests/test_torch_gp.py's): V diag(W) V^T within 1e-5 max|w| of A, V^T V
    within 1e-5 of I, W within 1e-5 max|w|, the symmetric root within
    2e-3 sqrt(max|w|).  The path's sizes (3, 33, 34) have instances of
    their own; 1, 2 and 8 take the generic 32-thread one, 9 (the first
    size above it), 16 (the Global context's ring), 17 (odd: a padding
    pair each round), 32 (the Global and None contexts' chunk) and 64
    (above 48 KB of shared memory) the generic 128-thread one."""
    from tungsten_tpu_torch.kernels import psd
    a = _k8_blocks(n, 2048, n) if n > 3 else torch.from_numpy(
        np.random.default_rng(n).normal(size=(2048, n, n)).astype(
            np.float32))
    before = psd.LAUNCHES
    w, v, sweeps = psd.eigh(a.to(cuda), sweeps=True)
    torch.cuda.synchronize()
    assert psd.LAUNCHES == before + 1
    assert int(sweeps.max()) <= psd.MAX_SWEEPS
    tw, _ = psd.eigh_ref(a)
    wmax = tw.abs().amax(-1, keepdim=True).double()
    w64, v64 = w.cpu().double(), v.cpu().double()
    a64 = (0.5 * (a + a.transpose(1, 2))).double()
    recon = (v64 * w64[:, None, :]) @ v64.transpose(1, 2)
    assert ((recon - a64).abs().amax(-1) <= 1e-5 * wmax).all()
    assert ((v64.transpose(1, 2) @ v64 - torch.eye(n, dtype=torch.float64))
            .abs().max() <= 1e-5)
    assert ((w64 - tw.double()).abs() <= 1e-5 * wmax).all()
    root = psd.sqrt_psd(a.to(cuda)).cpu()
    twin = psd.sqrt_psd(a, eigh_fn=psd.eigh_ref)
    assert ((root - twin).abs().amax((1, 2))
            <= 2e-3 * wmax[:, 0].sqrt().float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("stem", ["function-space", "csg"])
def test_fs_render_on_the_card_goes_through_k8_alone(cuda, stem):
    """A 16x16, 1-spp function-space render on the card: finite, K8
    launched and no other kernel, and no torch.linalg.eigh called."""
    from tungsten_tpu_torch.kernels import psd
    scene, _ = load_scene(os.path.join(ROOT, "scenes", f"gpis-{stem}.json"),
                          res_override=(16, 16), device="cuda")
    before = (psd.LAUNCHES, noise3d.LAUNCHES, noise1d.LAUNCHES,
              wst.MARCH_LAUNCHES, wst.TRACE_LAUNCHES)
    eigh = torch.linalg.eigh

    def refused(*args, **kw):
        raise AssertionError("torch.linalg.eigh ran in a card render")

    torch.linalg.eigh = refused
    try:
        img = trender.render(scene, 1, device="cuda")
        torch.cuda.synchronize()
    finally:
        torch.linalg.eigh = eigh
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    assert psd.LAUNCHES > before[0]
    assert (noise3d.LAUNCHES, noise1d.LAUNCHES, wst.MARCH_LAUNCHES,
            wst.TRACE_LAUNCHES) == before[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fs-global", "fs-none", "fs-skip",
                                  "fs-conditioned"])
def test_fs_context_renders_on_the_card_go_through_k8_and_match_cpu(cuda,
                                                                    name):
    """The function-space Global, None, skip and mesh-conditioned variants
    (tools/gp_variants.py) at 8x8, 2 spp on the card: K8 launched and no
    other kernel; against the same render on the CPU, means within 5%
    (each chunk's root is drawn through K8 on the card and its twin on
    the CPU, and the Global ring carries a ray's differences into its
    later segments)."""
    from tungsten_tpu_torch.kernels import psd
    from tungsten_tpu_torch.tools.gp_variants import variant_docs
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        doc = json.loads(json.dumps(variant_docs(tmp)[name][1]))
        doc["camera"]["resolution"] = [8, 8]
        scenes = {d: scene_from_dict(doc, device=d)[0]
                  for d in ("cpu", "cuda")}
    before = (psd.LAUNCHES, noise3d.LAUNCHES)
    got = trender.render(scenes["cuda"], 2, device="cuda").cpu().numpy()
    assert psd.LAUNCHES > before[0] and noise3d.LAUNCHES == before[1]
    want = trender.render(scenes["cpu"], 2, device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0.0
    assert abs(got.mean() - want.mean()) <= 0.05 * want.mean()


@pytest.mark.cuda
def test_sharded_render_of_two_gloo_ranks_on_the_card_is_the_single_one(
        cuda):
    """Config 1 at 64x64, 2 spp, sharded over two gloo ranks that share the
    card: both gathered films bit for bit render.render's in this
    process, K1 launched in each rank."""
    from tungsten_tpu_torch.parallel import jobs, launch
    noise3d.build()  # before the ranks start
    scene, _ = load_scene(SCENE, res_override=(64, 64), device=cuda)
    ref = trender.render(scene, 2, device=cuda).cpu().numpy()
    ranks = launch.spawn(jobs.sharded_render, 2, SCENE, (64, 64), 2,
                         "cuda:0", backend="gloo")
    for out in ranks:
        np.testing.assert_array_equal(out["film"], ref)
        assert out["k1"] > 0


@pytest.mark.cuda
def test_dryrun_multichip_runs_on_the_card(cuda):
    """entry.dryrun_multichip(2) on its default device: nccl with a card
    a rank where there are two, else two gloo ranks sharing the card;
    a finite loss and a step that moved sigma and l."""
    from tungsten_tpu_torch import entry
    loss, ds, dl = entry.dryrun_multichip(2)
    assert np.isfinite([loss, ds, dl]).all() and ds != 0.0 and dl != 0.0
