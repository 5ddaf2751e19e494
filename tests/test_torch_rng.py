"""The port's xxhash32 counter RNG against tungsten_tpu/utils/rng.py.

Tolerance: bit-exact (assert_array_equal) on 10^4 random words plus the
edge words 0, 2^31 and 2^32 - 1; negative int32 inputs wrap as
astype(int32).astype(uint32) does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.utils import rng as trng


def _words(shift):
    r = np.random.default_rng(7)
    w = r.integers(0, 2 ** 32, 10_000, dtype=np.uint64).astype(np.uint32)
    w = np.concatenate([w, np.array([0, 2 ** 31, 2 ** 32 - 1], np.uint32)])
    return np.roll(w, shift * 101)


def _t(w):
    return torch.from_numpy(w.astype(np.int64))


@pytest.mark.parametrize("name,arity", [("xxhash32", 1), ("xxhash32_2", 2),
                                        ("xxhash32_3", 3),
                                        ("xxhash32_4", 4)])
def test_hash_bit_exact(name, arity):
    words = [_words(i) for i in range(arity)]
    want = np.asarray(getattr(jrng, name)(*[jnp.asarray(w) for w in words]))
    got = getattr(trng, name)(*[_t(w) for w in words])
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32


def test_uniform_and_bernoulli_bit_exact():
    a, b = _words(0), _words(1)
    u_j = np.asarray(jrng.uniform(jnp.asarray(a), jnp.asarray(b)))
    u_t = trng.uniform(_t(a), _t(b))
    assert u_t.dtype == torch.float32
    np.testing.assert_array_equal(u_t.numpy(), u_j)
    np.testing.assert_array_equal(
        trng.u32_to_uniform(_t(a)).numpy(),
        np.asarray(jrng.u32_to_uniform(jnp.asarray(a))))
    np.testing.assert_array_equal(
        trng.bernoulli_pm1(u_t).numpy(),
        np.asarray(jrng.bernoulli_pm1(jnp.asarray(u_j))))


def test_negative_cells_wrap_like_int32_to_uint32():
    cells = np.array([-2 ** 31, -3, -1, 0, 1, 2 ** 31 - 1], np.int32)
    rev = cells[::-1].copy()
    want = np.asarray(jrng.xxhash32_4(jnp.asarray(cells), jnp.asarray(cells),
                                      jnp.asarray(rev), jnp.uint32(42)))
    c = torch.from_numpy(cells)
    got = trng.xxhash32_4(c, c, torch.from_numpy(rev), 42)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
