"""The port's sparse-convolution evaluators and kernel K1 against the JAX
package, on the same numpy-seeded inputs.

Tolerances:
- K1's twin vs `sparse_conv_pallas.noise3d_sum(..., interpret=True)`:
  rtol 1e-5, atol 1e-6 (the Pallas-vs-XLA tolerance of tests/test_pallas.py);
  measured max difference 7.5e-8 (exp rounds differently in XLA and
  PyTorch).
- make_value_at vs `sparse_conv_fast.make_value_at` (TUNGSTEN_TPU_PALLAS=0
  and =1): rtol 1e-5, atol 1e-6, measured 6e-8; gp ids exact.
- batched eval_value / eval_gradient vs the vmapped JAX functions:
  rtol 1e-4, atol 1e-5 (the sums over 27 x K terms reduce in another
  order); measured 4.8e-7 on gradients of size ~3.
K1 on the card is held to its twin in tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops import sparse_conv_fast as jfast
from tungsten_tpu.ops import sparse_conv_pallas as jscp
from tungsten_tpu.ops.covariance import SquaredExponentialCov as JSE
from tungsten_tpu.ops.means import SphericalMean as JSphere
from tungsten_tpu_torch.kernels import noise3d
from tungsten_tpu_torch.ops import sparse_conv as tsc
from tungsten_tpu_torch.ops import sparse_conv_fast as tfast
from tungsten_tpu_torch.ops.covariance import SquaredExponentialCov
from tungsten_tpu_torch.ops.means import SphericalMean

SIGMA, L, ANISO = 0.06, 0.12, (1.0, 1.7, 0.6)
CENTER, RADIUS = (0.0, 0.9, 0.0), 0.45


def _gps():
    jgp = jsc.GP(mean=JSphere.create(center=CENTER, radius=RADIUS),
                 cov=JSE.create(sigma=SIGMA, l=L, aniso=ANISO))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    tgp = tsc.GP(mean=SphericalMean(center=f32(CENTER), radius=f32(RADIUS)),
                 cov=SquaredExponentialCov(sigma=f32(SIGMA), l=f32(L),
                                           aniso=f32(ANISO)))
    return jgp, tgp


def _cfgs(single):
    ctxt = jsc.CTXT_RENEWAL if single else jsc.CTXT_NONE
    jcfg = jsc.SparseConvConfig.create(global_seed=42, impulse_density=3.0,
                                       ctxt=ctxt,
                                       use_single_realization=single)
    tcfg = tsc.SparseConvConfig(global_seed=42,
                                impulse_density=torch.tensor(3.0),
                                ctxt=ctxt, use_single_realization=single)
    return jcfg, tcfg


def _rays(n, seed=5):
    r = np.random.default_rng(seed)
    ro = (r.uniform(-0.7, 0.7, (n, 3)) + [0.0, 0.9, 0.0]).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    pss = r.integers(0, 50, (n, 4)).astype(np.uint32)
    t = r.uniform(0.0, 1.0, n).astype(np.float32)
    return ro, rd, pss, t


def _k1_inputs(n):
    r = np.random.default_rng(11)
    p = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    seed = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    _, tgp = _gps()
    m6 = tgp.cov.splat_form().tolist() + [0.0, 0.0, 0.0]
    return p, seed, float(tgp.cov.splat_radius()), m6


@pytest.mark.parametrize("K", [1, 3])
def test_k1_twin_matches_pallas_interpret(K):
    p, seed, kr, m6 = _k1_inputs(300)
    assert (p < 0).any()  # negative cells are included
    want = np.asarray(jscp.noise3d_sum(
        jnp.asarray(p), jnp.asarray(seed), jnp.float32(kr),
        jnp.asarray(m6, jnp.float32), impulse_count=K, interpret=True))
    got = noise3d.noise3d_sum_s(torch.from_numpy(p),
                                torch.from_numpy(seed.astype(np.int64)),
                                kr, m6, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_k1_wrapper_takes_the_twin_on_cpu_and_checks_inputs():
    p, seed, kr, m6 = _k1_inputs(64)
    pt, st = torch.from_numpy(p), torch.from_numpy(seed.astype(np.int64))
    before = noise3d.LAUNCHES
    out = noise3d.noise3d_sum_s(pt, st, kr, m6, 3)
    assert noise3d.LAUNCHES == before  # the twin is not a kernel launch
    np.testing.assert_array_equal(
        out.numpy(), noise3d.noise3d_sum_s_ref(pt, st, kr, m6, 3).numpy())
    with pytest.raises(ValueError):
        noise3d.noise3d_sum_s(pt.double(), st, kr, m6, 3)
    with pytest.raises(ValueError):
        noise3d.noise3d_sum_s(pt, st[:10], kr, m6, 3)
    with pytest.raises(NotImplementedError):
        noise3d.noise3d_sum_s(pt.requires_grad_(), st, kr, m6, 3)


@pytest.mark.parametrize("single", [True, False])
@pytest.mark.parametrize("pallas", ["0", "1"])
def test_make_value_at_matches_jax(single, pallas, monkeypatch):
    jgp, tgp = _gps()
    jcfg, tcfg = _cfgs(single)
    # 300 rays: the same K1 shape as the test above, so the interpret-mode
    # kernel compiles once
    ro, rd, pss, t = _rays(300)
    monkeypatch.setenv("TUNGSTEN_TPU_PALLAS", pallas)
    jva = jfast.make_value_at(jcfg, jgp, None, jnp.asarray(ro),
                              jnp.asarray(rd), jnp.asarray(pss),
                              jnp.uint32(9))
    jv, jid = jva(jnp.asarray(t))
    tva = tfast.make_value_at(tcfg, tgp, torch.from_numpy(ro),
                              torch.from_numpy(rd),
                              torch.from_numpy(pss.astype(np.int64)), 9)
    tv, tid = tva(torch.from_numpy(t))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


@pytest.mark.parametrize("single", [True, False])
def test_eval_value_and_gradient_match_vmapped_jax(single):
    jgp, tgp = _gps()
    jcfg, tcfg = _cfgs(single)
    ro, rd, pss, t = _rays(64, seed=6)
    p = ro + t[:, None] * rd
    zero = jsc.Coeffs.zero()

    def jgrad(p_i, rd_i, pss_i):
        return jsc.eval_gradient(jcfg, jgp, zero, zero, p_i, 0.0, rd_i, pss_i,
                                 jnp.uint32(9), 0.0)

    def jval(p_i, rd_i, pss_i):
        return jsc.eval_value(jcfg, jgp, zero, zero, p_i, 0.0, rd_i, pss_i,
                              jnp.uint32(9), 0.0)

    args = (jnp.asarray(p), jnp.asarray(rd), jnp.asarray(pss))
    jg = np.asarray(jax.vmap(jgrad)(*args))
    jv, jid = jax.vmap(jval)(*args)
    tp = torch.from_numpy(p)
    tpss = torch.from_numpy(pss.astype(np.int64))
    tg = tsc.eval_gradient(tcfg, tgp, tp, tpss, 9)
    tv, tid = tsc.eval_value(tcfg, tgp, tp, tpss, 9)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))

