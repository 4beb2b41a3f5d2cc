"""The port's threefry2x32 PRNG (``repro_torch.core.prng``) against
``jax.random`` on the CPU: ``PRNGKey``, ``fold_in``, ``split``, 32-bit
``bits``, ``uniform`` and ``randint`` bit for bit over 20 seeds at the
sampler's shape (V,) with V = 50257, the forward's (b, hkv) and the
decision's (); ``gumbel`` within one f32 ulp of the reference's value at
magnitude max(|g|, 1), i.e. 2e-7 of it (its two ``log``s are XLA's on one
side and PyTorch's on the other).

The port follows JAX with ``jax_threefry_partitionable`` on; the first
test fails if the installed JAX's default moves away from it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 2, 3, 7, 11, 17, 42, 99, 123, 1000, 4242, 65535, 65536,
         123456789, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 3, 2 ** 32 - 1, 987654321]
SHAPES = [(50257,), (2, 3), ()]
GUMBEL_REL = 2e-7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """threefry is ~110 small int64 launches per draw: intra-op threads only
    add synchronisation, and under parallel test workers they oversubscribe
    the cores. One thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for d in (0, 5, seed % 977, 2 ** 31 + 7):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(jk, np.uint32(d))))
    np.testing.assert_array_equal(prng.split(tk).numpy(), _np(jax.random.split(jk)))
    np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                  _np(jax.random.split(jk, 5)))
    for shape in SHAPES:
        np.testing.assert_array_equal(
            prng.bits32(tk, shape).numpy(),
            _np(jax.random.bits(jk, shape, jnp.uint32)))
        u_t = prng.uniform(tk, shape).numpy()
        u_j = np.asarray(jax.random.uniform(jk, shape))
        np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))
        for lo, hi in ((0, 4), (0, 7), (3, 10), (0, 1)):
            np.testing.assert_array_equal(
                prng.randint(tk, shape, lo, hi).numpy(),
                np.asarray(jax.random.randint(jk, shape, lo, hi)))
        g_t = prng.gumbel(tk, shape).numpy()
        g_j = np.asarray(jax.random.gumbel(jk, shape))
        err = np.abs(g_t - g_j) / np.maximum(np.abs(g_j), 1.0)
        assert err.max() <= GUMBEL_REL, err.max()


def test_uniform_range_is_bitwise():
    """minval/maxval scaling and the floor at minval, bit for bit."""
    jk, tk = jax.random.PRNGKey(5), prng.key(5)
    for lo, hi in ((-2.0, 3.0), (0.25, 0.5), (float(prng.F32_TINY), 1.0)):
        u_t = prng.uniform(tk, (4099,), lo, hi).numpy()
        u_j = np.asarray(jax.random.uniform(jk, (4099,), minval=lo, maxval=hi))
        np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))


def test_batched_keys_match_vmap():
    """The sampler's form: one key per slot from a vector of seeds, folded
    with each row's output position, then a gumbel row each."""
    seeds = np.array([0, 7, 2 ** 32 - 1, 123], np.uint32)
    pos = np.array([0, 3, 11, 250], np.int32)
    keys_j = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s), p))(
        seeds, pos.astype(np.uint32))
    keys_t = prng.fold_in(prng.key(torch.from_numpy(seeds.astype(np.int64))),
                          torch.from_numpy(pos))
    np.testing.assert_array_equal(keys_t.numpy(), _np(keys_j))
    g_j = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (300,)))(keys_j))
    g_t = prng.gumbel(keys_t, (300,)).numpy()
    assert g_t.shape == (4, 300)
    err = np.abs(g_t - g_j) / np.maximum(np.abs(g_j), 1.0)
    assert err.max() <= GUMBEL_REL
    r_j = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (2, 3), 0, 4))(keys_j))
    np.testing.assert_array_equal(prng.randint(keys_t, (2, 3), 0, 4).numpy(), r_j)
