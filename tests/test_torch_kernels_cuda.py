"""Kernel K1 on the card, against its plain PyTorch twin, and the config-1
render on the card against the same render on the CPU.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they are
marked `cuda` and skip without one.  They import no JAX, so they run on a
machine that has only PyTorch:
`python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`.

Tolerances: K1 vs twin atol 1e-5 (a raw sum of at most 81 unit-bounded
fp32 terms; measured 0 on an H100).  GPU vs CPU render at 8x8, 1 spp: at
least 97% of pixels within 1e-3 * (1 + |cpu|) and means within 1% (the
elementwise math around K1 may round differently on the two devices, and
an ulp can flip one ray's crossing).
"""
import os

import numpy as np
import pytest
import torch

from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.kernels import noise3d
from tungsten_tpu_torch.scene.parse import load_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "gpis-sphere-box.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_k1_kernel_matches_twin_on_the_card(cuda, K):
    scene, _ = load_scene(SCENE)
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


@pytest.mark.cuda
def test_render_on_the_card_goes_through_k1_and_matches_cpu(cuda):
    scene, _ = load_scene(SCENE, res_override=(8, 8))
    ref = trender.render(scene, 1, device="cpu").numpy()
    before = noise3d.LAUNCHES
    got = trender.render(scene, 1, device=cuda).cpu().numpy()
    assert noise3d.LAUNCHES > before
    assert np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(axis=-1)
    assert ok.mean() >= 0.97, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())
