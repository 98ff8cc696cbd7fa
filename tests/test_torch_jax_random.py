"""The port's threefry2x32 PRNG and flax's key folding
(``scannertools_tpu_torch/models/jax_random.py``) held to ``jax.random``
and flax.

Keys, bits and uniform draws are bit-equal over several seeds and shapes
(odd sizes, a zero dimension, more than 2**16 elements).
``truncated_normal`` and the initializers are held within 1e-6 of the
draw's largest magnitude: XLA's float32 ``erf_inv`` polynomial against a
float64 ``erfinv`` rounded to float32 (measured 8.3e-7 on values up to 2,
4.2e-7 of the scale). The test fails loudly if a JAX or flax upgrade
changes the semantics the port copies (``jax_threefry_partitionable``,
``flax_fix_rng_separator``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static
from jax._src.nn.initializers import _compute_fans

from scannertools_tpu_torch.models import jax_random as JR

SEEDS = [0, 1, 42, 2**31 - 1, -7, 2**32 - 1]
SHAPES = [(), (1,), (3,), (5, 7), (0, 3), (3, 0, 2), (257, 259)]
RTOL = 1e-6  # of a draw's largest magnitude


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_the_copied_semantics_hold():
    assert jax.config.jax_threefry_partitionable is True
    assert flax.config.flax_fix_rng_separator is False


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = JR.prng_key(seed, "cpu")
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for n in (1, 2, 3, 7):
        np.testing.assert_array_equal(JR.split(tk, n).numpy(),
                                      _words(jax.random.split(jk, n)))
    for data in (0, 1, 12345, 2**32 - 1):
        np.testing.assert_array_equal(
            JR.fold_in(tk, data).numpy(),
            _words(jax.random.fold_in(jk, np.uint32(data))))


def test_threefry2x32_bit_equal_on_arrays_and_ints():
    """On int64 tensors (a draw's counts) and on Python ints (a fold)."""
    from jax._src import prng

    rng = np.random.default_rng(5)
    k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 1001), dtype=np.uint64).astype(np.uint32)
    want = [_words(w) for w in prng.threefry2x32_p.bind(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
        jnp.asarray(x[1]))]
    t = [torch.from_numpy(a.astype(np.int64)) for a in x]
    got_t = JR.threefry2x32(int(k[0]), int(k[1]), t[0], t[1])
    for g, w in zip(got_t, want):
        np.testing.assert_array_equal(g.numpy(), w)
    one = JR.threefry2x32(int(k[0]), int(k[1]), int(x[0, 3]),
                          int(x[1, 3]))
    assert list(one) == [int(want[0][3]), int(want[1][3])]


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), JR.prng_key(seed, "cpu")
    np.testing.assert_array_equal(JR.random_bits(tk, shape).numpy(),
                                  _words(jax.random.bits(jk, shape)))
    for lo, hi in ((0.0, 1.0), (-0.3, 1.7), (-0.9544997, 0.9544997)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        got = JR.uniform(tk, shape, lo, hi).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_bits_past_one_chunk_and_two_to_the_sixteen():
    """More than 2**16 elements, hashed in several chunks of the flat
    index (13 of the CPU's)."""
    assert 3 * 70001 > 12 * JR._chunk(torch.device("cpu"))
    jk, tk = jax.random.PRNGKey(11), JR.prng_key(11, "cpu")
    shape = (3, 70001)
    np.testing.assert_array_equal(JR.random_bits(tk, shape).numpy(),
                                  _words(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        JR.uniform(tk, shape).numpy(),
        np.asarray(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("shape", [(5,), (64, 33), (300, 301)])
def test_truncated_normal_within_tolerance(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), JR.prng_key(seed, "cpu")
    want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape))
    got = JR.truncated_normal(tk, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got) < 2).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(9, 7), (3, 3, 7, 5), (4, 24, 16),
                                   (1, 1, 1, 3)])
def test_initializers_within_tolerance(shape):
    jk, tk = jax.random.PRNGKey(4), JR.prng_key(4, "cpu")
    for jinit, tinit in ((jax.nn.initializers.lecun_normal(),
                          JR.lecun_normal),
                         (jax.nn.initializers.he_normal(), JR.he_normal)):
        want = np.asarray(jinit(jk, shape, jnp.float32))
        got = tinit(tk, shape).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
    assert JR.fans(shape) == _compute_fans(shape)
    for name, value in (("zeros", 0.0), ("ones", 1.0)):
        np.testing.assert_array_equal(
            getattr(JR, name)(tk, shape, "cpu").numpy(),
            np.full(shape, value, np.float32))
    np.testing.assert_array_equal(
        JR.constant(tk, shape, 0.25, "cpu").numpy(),
        np.asarray(jax.nn.initializers.constant(0.25)(jk, shape)))


@pytest.mark.parametrize("suffix", [(), ("conv1", 1), ("conv1", "bn", 2),
                                    ("block35_3", "branch2", "conv", 1),
                                    ("a" * 70, 300), ("x", 0)])
def test_fold_in_static_bit_equal(suffix):
    jk, tk = jax.random.PRNGKey(0), JR.prng_key(0, "cpu")
    np.testing.assert_array_equal(JR.fold_in_static(tk, suffix).numpy(),
                                  _words(_fold_in_static(jk, suffix)))


def test_flax_layer_keys_bit_equal():
    """A flax ``Dense`` in a named scope: its kernel is lecun_normal on the
    key folded with (scope, 1), its bias takes counter 2."""
    import flax.linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(7, name="fc")(nn.Conv(5, (3, 3), name="c")(x))

    v = Net().init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))
    tk = JR.prng_key(0, "cpu")
    for scope, shape in (("c", (3, 3, 3, 5)), ("fc", (5, 7))):
        got = JR.lecun_normal(JR.fold_in_static(tk, (scope, 1)), shape)
        want = np.asarray(v["params"][scope]["kernel"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RTOL * np.abs(want).max())


def test_seeds_out_of_range_raise():
    with pytest.raises(OverflowError):
        JR.prng_key(2**32, "cpu")
    with pytest.raises(OverflowError):
        JR.prng_key(-2**31 - 1, "cpu")
