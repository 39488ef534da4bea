"""``xgboost_tpu_torch.random`` (threefry2x32) bit for bit against
``jax.random`` in its partitionable mode: keys (``PRNGKey``, ``split``
2 and 3 ways, ``fold_in``), the 32-bit ``random_bits``, ``uniform`` and
``randint`` on the host, and the per-row ``uniform_rows`` on a torch
device, over seeds 0, 1, 42 and 2**31 - 1, shapes 1, 7, 28, 4097 and
70001 and several ``randint`` ranges.  Tolerance: none, every word and
every float's bits equal.

The grid includes the grower's own chains: ``fold_in(fold_in(PRNGKey(s),
iteration), tree)``, its 3-way split, and ``fold_in(level_key, depth)``.
Imports no grower, so it stays fast."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from xgboost_tpu_torch import random as prng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SHAPES = [1, 7, 28, 4097, 70001]
RANGES = [(0, 1), (0, 28), (3, 3), (10, 5), (-5, 70000), (0, 65537),
          (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)]


def jkey(seed):
    return jax.random.PRNGKey(seed)


def grower_chain(seed, it=7, tree=2, depth=3):
    """The keys of one grown tree: round key, tree key, its 3-way split,
    and one level's feature key, in both packages."""
    kj = jax.random.fold_in(jax.random.fold_in(jkey(seed), it), tree)
    kt = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), it), tree)
    sj, st = jax.random.split(kj, 3), prng.split(kt, 3)
    return ([kj, *sj, jax.random.fold_in(sj[2], depth)],
            [kt, *st, prng.fold_in(st[2], depth)])


def test_partitionable_mode_is_the_one_ported():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bitwise(seed):
    np.testing.assert_array_equal(np.asarray(jkey(seed)),
                                  prng.PRNGKey(seed))
    for num in (2, 3):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jkey(seed), num)),
            prng.split(prng.PRNGKey(seed), num))
    for data in (0, 1, 19, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jkey(seed), data)),
            prng.fold_in(prng.PRNGKey(seed), data))
    chain_j, chain_t = grower_chain(seed)
    for a, b in zip(chain_j, chain_t):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bitwise(seed, shape):
    for kj, kt in zip(*grower_chain(seed)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, (shape,))),
            prng.random_bits(kt, shape))
        want = np.asarray(jax.random.uniform(kj, (shape,))).view(np.uint32)
        np.testing.assert_array_equal(
            prng.uniform(kt, shape).view(np.uint32), want)
        np.testing.assert_array_equal(
            prng.uniform_rows(kt, shape, "cpu").numpy().view(np.uint32),
            want)
    # minval / maxval of a float range
    kj, kt = jkey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, (shape,), minval=-2.5,
                                      maxval=0.75)),
        prng.uniform(kt, shape, -2.5, 0.75))


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_bitwise(shape, lo, hi):
    for seed in SEEDS:
        kj, kt = grower_chain(seed)[0][2], grower_chain(seed)[1][2]
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(kj, (shape,), lo, hi)),
            prng.randint(kt, shape, lo, hi))
        # the grower's scalar draw (the empty-mask fallback feature)
        assert int(jax.random.randint(kj, (), lo, hi)) == int(
            prng.randint(kt, (), lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_stacked_keys_draw_each_keys_own(seed):
    """A (T, 2) stack of keys draws each key's own values: the grower
    draws T trees' rows in one device pass and their features on the
    host in one call."""
    keys_j = [jax.random.fold_in(jkey(seed), t) for t in range(5)]
    keys_t = np.stack([prng.fold_in(prng.PRNGKey(seed), t)
                       for t in range(5)])
    levels = prng.fold_in(keys_t[None], np.arange(4)[:, None])  # (4, 5)
    for d in range(4):
        for t, kj in enumerate(keys_j):
            np.testing.assert_array_equal(
                levels[d, t], np.asarray(jax.random.fold_in(kj, d)))
    rows = prng.uniform_rows(keys_t, 999, "cpu").numpy()
    feats = prng.uniform(keys_t, 28)
    picks = prng.randint(keys_t, (), 0, 28)
    splits = prng.split(keys_t, 3)
    for t, kj in enumerate(keys_j):
        np.testing.assert_array_equal(
            rows[t], np.asarray(jax.random.uniform(kj, (999,))))
        np.testing.assert_array_equal(
            feats[t], np.asarray(jax.random.uniform(kj, (28,))))
        assert picks[t] == int(jax.random.randint(kj, (), 0, 28))
        np.testing.assert_array_equal(
            splits[t], np.asarray(jax.random.split(kj, 3)))
