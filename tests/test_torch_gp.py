"""The port's function-space GP ops (tungsten_tpu_torch/ops/gp.py) against
tungsten_tpu/ops/gp.py on seeded numpy inputs, and what the port forms from
eigh (the symmetric root and the pseudo-inverse of kernels/psd.py, on the
CPU through K8's twin torch.linalg.eigh) against the JAX package's eigh
branch on the matrices K8 takes in a small function-space pass.

Tolerances: covariance blocks (values, first and mixed second
derivatives) within 1e-5 of the largest entry of each (closed forms here,
nested jax.jvp there); pseudo-inverse products, the conditioned mean and
the conditioned covariance B B^T within 1e-4 (1 + |x|) on well-conditioned
systems; the uniforms behind a realization's Box-Muller z stream bit for
bit and z within 2 float32 ulps (log1p, cos and sin of two libraries
differ by an ulp); the truncated normal within 1e-5 (erf and erfinv of
two libraries).

On the pass's matrices, per matrix: the eigenvalues within EIG_TOL
max|w|; the sampling covariance R R^T within RECON_TOL max|w| of JAX's
(whatever root each side takes); the symmetric root within ROOT_RTOL
sqrt(max|w|) of the one formed from JAX's eigh; and the product the
conditioning subtracts, s12^T pinv(s11) s12, within SCHUR_RTOL of JAX's
largest entry.  Measured on this pass: 8e-7, 2.1e-6, 1.3e-4 and 4.9e-4:
the roots of these near-singular float32 covariances differ between any
two float32 eigensolvers (the eigenvectors of eigenvalues at float32 noise
are noise), and the pseudo-inverse itself differs by up to ~5% in the
directions at its 1e-6 cut, which the cross covariances barely reach.
chip_smoke.py holds K8 to its twin on the card with ROOT_RTOL and
SCHUR_RTOL.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.ops import gp as jgp
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops.covariance import SquaredExponentialCov as JSE
from tungsten_tpu.ops.means import SphericalMean as JSphere
from tungsten_tpu.utils import rng as jtrng
from tungsten_tpu_torch.kernels import psd
from tungsten_tpu_torch.ops import gp as tgp
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops.covariance import SquaredExponentialCov as TSE
from tungsten_tpu_torch.ops.means import SphericalMean as TSphere
from tungsten_tpu_torch.utils import rng as trng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECON_TOL, EIG_TOL = 1e-5, 1e-5
ROOT_RTOL, SCHUR_RTOL = 2e-3, 5e-3

SIGMA, ELL = 0.06, 0.12
ANISO = (1.0, 0.8, 1.3)
CENTER, RADIUS = (0.0, 0.9, 0.0), 0.45


def _gps():
    jg = jsc.GP(mean=JSphere.create(CENTER, RADIUS),
                cov=JSE.create(sigma=SIGMA, l=ELL, aniso=ANISO))
    tg = tsc.GP(mean=TSphere(center=torch.tensor(CENTER),
                             radius=torch.tensor(RADIUS)),
                cov=TSE(sigma=torch.tensor(SIGMA), l=torch.tensor(ELL),
                        aniso=torch.tensor(ANISO)))
    return jg, tg


def _rows(r, B, N, spread):
    pts = (np.array(CENTER) + r.uniform(-spread, spread, (B, N, 3))).astype(
        np.float32)
    dts = r.integers(0, 2, (B, N)).astype(np.int32)
    dirs = r.normal(size=(B, N, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)
    return pts, dts, dirs


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def test_cov_matrix_matches_jax_with_derivative_rows():
    jg, tg = _gps()
    r = np.random.default_rng(0)
    B, N = 8, 24
    pts, dts, dirs = _rows(r, B, N, 0.15)

    @jax.jit
    def jcov(p, d, u):
        return jax.vmap(lambda p, d, u: jgp.cov_matrix(
            jg.cov.cov, p, d, u, p, d, u))(p, d, u)

    ref = np.asarray(jcov(pts, dts, dirs))
    got = tgp.cov_matrix(tg.cov, *_t(pts, dts, dirs, pts, dts, dirs)).numpy()
    kinds = dts[:, :, None] + dts[:, None, :]  # 0 value, 1 first, 2 mixed
    for k in range(3):
        sel = kinds == k
        scale = np.abs(ref[sel]).max()
        assert np.abs(got[sel] - ref[sel]).max() <= 1e-5 * scale, k


def _spd(r, B, n):
    x = r.normal(size=(B, n, n))
    return (x @ x.transpose(0, 2, 1) / n + 0.5 * np.eye(n)).astype(
        np.float32)


def test_pseudo_inverse_products_match_jax():
    r = np.random.default_rng(1)
    a = _spd(r, 6, 10)
    b = r.normal(size=(6, 10, 3)).astype(np.float32)
    ref = np.asarray(jax.vmap(jgp.psd_solve)(a, b))
    got = tgp.psd_solve(*_t(a, b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # a rank-deficient system: the eigenvalues under 1e-6 max|w| drop out
    u = r.normal(size=(6, 10, 4))
    low = (u @ u.transpose(0, 2, 1)).astype(np.float32)
    ref = np.asarray(jax.vmap(jgp.pseudo_inverse)(low) @ low)
    got = (psd.pseudo_inverse(torch.from_numpy(low))
           @ torch.from_numpy(low)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_conditional_mvn_matches_jax():
    """The Schur-complement conditioning of derivative queries on value and
    derivative rows (the normal's solve), and the prior of those rows: the
    mean and the covariance B B^T, whatever root each side takes."""
    jg, tg = _gps()
    jg = jsc.GP(mean=jg.mean, cov=JSE.create(sigma=SIGMA, l=0.6,
                                             aniso=ANISO))
    tg = tsc.GP(mean=tg.mean, cov=TSE(sigma=torch.tensor(SIGMA),
                                      l=torch.tensor(0.6),
                                      aniso=torch.tensor(ANISO)))
    r = np.random.default_rng(2)
    B = 6
    cp, cd, cu = _rows(r, B, 8, 0.6)
    qp, qd, qu = _rows(r, B, 3, 0.6)
    vals = r.normal(0.0, SIGMA, (B, 8)).astype(np.float32)

    @jax.jit
    def jcond(qp, qd, qu, cp, cd, cu, v):
        def one(*a):
            m, s, _ = jgp.conditional_mvn(jg, jg.cov.cov, *a)
            return m, s @ s.T
        return jax.vmap(one)(qp, qd, qu, cp, cd, cu, v)

    jm, jc = (np.asarray(x) for x in jcond(qp, qd, qu, cp, cd, cu, vals))
    tm, troot, _ = tgp.conditional_mvn(tg, *_t(qp, qd, qu, cp, cd, cu, vals))
    tc = (troot @ troot.transpose(1, 2)).numpy()
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    # the unconditioned prior of the same rows
    jm, jc = (np.asarray(x) for x in jax.vmap(lambda *a: (
        lambda m, s, _: (m, s @ s.T))(*jgp.prior_mvn(jg, jg.cov.cov, *a)))(
            cp, cd, cu))
    tm, troot, _ = tgp.prior_mvn(tg, *_t(cp, cd, cu))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((troot @ troot.transpose(1, 2)).numpy(), jc,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [3, 33, 34])
def test_sample_mvn_z_stream(n):
    """The uniforms behind z bit for bit; z itself within 2 float32 ulps
    (log1p, cos and sin of two libraries differ by an ulp)."""
    r = np.random.default_rng(n)
    keys = r.integers(0, 2 ** 32, 16, dtype=np.uint64).astype(np.uint32)
    tkeys = torch.from_numpy(keys.astype(np.int64))
    for ctr in (7, 11, 23):
        half = (n + 1) // 2
        cj = ctr * half + np.arange(half, dtype=np.uint32)
        uj = np.asarray(jax.vmap(lambda k: jnp.stack(
            jtrng.uniform2(k, jnp.asarray(cj))))(keys))
        ut = torch.stack(trng.uniform2(tkeys[:, None],
                                       tgp.z_counters(ctr, n, "cpu")), 1)
        np.testing.assert_array_equal(ut.numpy(), uj)
        ref = np.asarray(jax.vmap(lambda k: jgp.sample_mvn(
            jnp.zeros(n), jnp.eye(n), k, jnp.uint32(ctr)))(keys))
        got = tgp.normals(tkeys, ctr, n).numpy()
        np.testing.assert_array_max_ulp(got, ref, maxulp=2)
    # and one realization from one root
    root = np.tril(r.normal(size=(16, n, n))).astype(np.float32)
    mean = r.normal(size=(16, n)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda m, s, k: jgp.sample_mvn(
        m, s, k, jnp.uint32(11)))(mean, root, keys))
    got = tgp.sample_mvn(*_t(mean, root, keys.astype(np.int64)), 11).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_truncated_normal_matches_jax():
    r = np.random.default_rng(5)
    R = 256
    # the start value's law on the path: the mean at most 3 sigma inside
    # the surface (deeper, 1 - Phi(a) nears the clip, where an ulp of erf
    # moves erfinv's steep tail by more than 1e-5)
    sigma = r.uniform(0.01, 0.2, R).astype(np.float32)
    mean = (sigma * r.uniform(-3.0, 10.0, R)).astype(np.float32)
    keys = r.integers(0, 2 ** 32, R, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jax.vmap(lambda m, s, k: jgp.sample_truncated_normal(
        m, s, 0.0, k, jnp.uint32(7)))(mean, sigma, keys))
    got = tgp.sample_truncated_normal(
        *_t(mean, sigma), 0.0, torch.from_numpy(keys.astype(np.int64)),
        7).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The root and the pseudo-inverse that the port forms from eigh, on the
# matrices of a function-space pass
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pass_matrices():
    """The matrices K8 takes in a function-space sample_distance of 64
    rays (the chunks' joint covariances, the normal's conditioning blocks
    and their 3x3 roots) and the cross covariances of those blocks."""
    from tungsten_tpu_torch.models import media as tmd
    from tungsten_tpu_torch.scene.parse import load_scene
    scene, _ = load_scene(os.path.join(ROOT, "scenes",
                                       "gpis-function-space.json"),
                          device="cpu")
    seen = {}
    mp = pytest.MonkeyPatch()

    def eigh(a, sweeps=False):
        seen.setdefault(a.shape[-1], []).append(a.clone())
        return psd.eigh_ref(a)

    def solve(a, b):
        seen.setdefault("s12", []).append(b.clone())
        return torch.matmul(psd.pseudo_inverse(a), b)

    mp.setattr(psd, "eigh", eigh)
    mp.setattr(tgp, "psd_solve", solve)
    try:
        R = 64
        th = np.linspace(-0.3, 0.3, R, dtype=np.float32)
        rd = np.stack([np.sin(th), -0.05 + 0 * th, -np.cos(th)], -1)
        rd = torch.from_numpy((rd / np.linalg.norm(rd, axis=-1,
                                                   keepdims=True)).astype(
            np.float32))
        ro = torch.tensor([[0.0, 0.9, 2.0]]).expand(R, 3).contiguous()
        pss = torch.stack([torch.arange(R)]
                          + [torch.zeros(R, dtype=torch.int64)] * 3, dim=-1)
        tmd.sample_distance(scene.media[0], scene.scene_seed, ro, rd,
                            torch.full((R,), 1.0), torch.full((R,), 3.0),
                            tmd.MediumState.make(R, "cpu"), pss,
                            torch.full((R,), 0.5),
                            torch.ones(R, dtype=torch.bool))
    finally:
        mp.undo()
    return {k: torch.cat(v) for k, v in seen.items()}


@pytest.mark.parametrize("n", [3, 33, 34])
def test_root_and_solve_match_jax_on_a_pass(pass_matrices, n):
    """What the port forms from eigh (on the CPU, K8's twin) against the
    JAX package's eigh branch, on the matrices K8 takes in a pass."""
    a = pass_matrices[n]
    assert a.shape[0] >= 64
    ja = a.numpy()
    jw, jv = (np.asarray(x, np.float64) for x in jax.vmap(jnp.linalg.eigh)(
        0.5 * (ja + ja.transpose(0, 2, 1))))
    wmax = torch.from_numpy(np.abs(jw).max(-1))
    w = psd.eigh(a)[0].double()
    assert ((w - torch.from_numpy(jw)).abs().amax(-1) <= EIG_TOL * wmax).all()
    # the sampling covariance R R^T, whatever root each side takes
    root = psd.sqrt_psd(a).double()
    jroot = np.asarray(jax.vmap(jgp._sqrt_psd)(ja), np.float64)
    cov = root @ root.transpose(1, 2)
    jcov = torch.from_numpy(jroot @ jroot.transpose(0, 2, 1))
    assert ((cov - jcov).abs().amax((1, 2)) <= RECON_TOL * wmax).all()
    # the symmetric root, formed from JAX's eigh too
    jsym = torch.from_numpy(jroot @ jv.transpose(0, 2, 1))
    assert ((root - jsym).abs().amax((1, 2))
            <= ROOT_RTOL * wmax.sqrt()).all()
    if n == 34:
        b = pass_matrices["s12"]
        got = b.transpose(1, 2) @ psd.pseudo_inverse(a) @ b
        jpinv = torch.from_numpy(np.array(jax.vmap(jgp.pseudo_inverse)(ja)))
        want = b.transpose(1, 2) @ jpinv @ b
        err = (got - want).abs().amax((1, 2))
        assert (err <= SCHUR_RTOL * want.abs().amax((1, 2))).all()
