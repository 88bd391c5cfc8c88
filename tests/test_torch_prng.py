"""PyTorch port vs the JAX package: the Threefry-2x32 random numbers the
fault schedules draw (``resilience/prng.py`` against ``jax.random`` with
``jax_threefry_partitionable=True``).

Tolerances, and why: keys, split and folded keys, raw bits, uniforms and
Bernoulli masks are integer functions of the key (the uniform is the top
23 bits as a mantissa, minus 1: exact), so they must be equal word for
word. ``normal`` goes through ``erf^-1`` -- the port's copy of the float32
polynomial JAX lowers to, whose ``log1p`` and ``sqrt`` may round an ulp
apart between libraries -- so it agrees within 2e-6 (an ulp of a ~4-sigma
draw is 5e-7).
"""

import jax
import numpy as np
import pytest
import torch

from tpu_aerial_transport_torch.resilience import prng

SEEDS = [0, 1, 42, 12345, 2 ** 31 - 1, 2 ** 32 - 1, -5]


def _words(jkey):
    return np.asarray(jkey).astype(np.int64)


def test_threefry_partitionable_is_the_reference_setting():
    """The port follows the partitionable Threefry layout (JAX's default
    since 0.5)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    """``prng_key``, ``fold_in`` (small, large and tensor data) and
    ``split`` equal JAX's words exactly."""
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for data in (0, 1, 2, 7, 123456, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            _words(jax.random.fold_in(jk, data)), err_msg=str(data))
    np.testing.assert_array_equal(prng.fold_in(tk, torch.tensor(9)).numpy(),
                                  _words(jax.random.fold_in(jk, 9)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _words(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", [(1,), (5,), (8,), (3, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bits32_matches_jax_bits(shape):
    """Raw 32-bit words on odd and even shapes, and the float32 uniforms
    built on them, for several keys."""
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, device="cpu")
        np.testing.assert_array_equal(
            prng.bits32(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
        np.testing.assert_array_equal(
            prng.uniform(tk, shape).numpy(),
            np.asarray(jax.random.uniform(jk, shape)))


def test_bernoulli_masks_match_jax():
    """``bernoulli`` (mode 'low': uniform < p) equals JAX's masks at the
    edges and in between."""
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, device="cpu")
        for p in (0.0, 0.05, 0.3, 0.5, 0.999, 1.0):
            np.testing.assert_array_equal(
                prng.bernoulli(tk, p, (64,)).numpy(),
                np.asarray(jax.random.bernoulli(jk, p, (64,))),
                err_msg=f"seed {seed}, p {p}")


def test_normal_matches_jax():
    """``normal`` within 2e-6 of ``jax.random.normal`` over 4000 draws a
    key, tails included; ``erfinv`` maps +-1 to +-inf."""
    for seed in SEEDS:
        jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (4000,)))
        tn = prng.normal(prng.prng_key(seed, device="cpu"), (4000,)).numpy()
        np.testing.assert_allclose(tn, jn, atol=2e-6, rtol=0)
        assert np.abs(tn).max() > 3.0
    ends = prng.erfinv(torch.tensor([-1.0, 1.0]))
    assert ends.tolist() == [-float("inf"), float("inf")]


def test_batched_keys_give_the_rows_of_per_key_draws():
    """A ``(S, 2)`` key batch gives, row by row, JAX's draws for each key:
    bits, uniforms, Bernoulli masks with a per-key probability, normals,
    folds with per-key data and splits."""
    seeds = [3, 11, 2 ** 31 + 5]
    tkeys = torch.stack([prng.prng_key(s, device="cpu") for s in seeds])
    jkeys = [jax.random.PRNGKey(s) for s in seeds]
    p = torch.tensor([0.1, 0.5, 0.9])
    bits = prng.bits32(tkeys, (3, 4))
    bern = prng.bernoulli(tkeys, p, (16,))
    norm = prng.normal(tkeys, (6,))
    folded = prng.fold_in(tkeys, torch.tensor([4, 0, 77]))
    split = prng.split(tkeys, 3)
    assert bits.shape == (3, 3, 4) and split.shape == (3, 3, 2)
    for i, jk in enumerate(jkeys):
        np.testing.assert_array_equal(
            bits[i].numpy(), np.asarray(jax.random.bits(jk, (3, 4))).astype(
                np.int64))
        np.testing.assert_array_equal(
            bern[i].numpy(),
            np.asarray(jax.random.bernoulli(jk, float(p[i]), (16,))))
        np.testing.assert_allclose(
            norm[i].numpy(), np.asarray(jax.random.normal(jk, (6,))),
            atol=2e-6, rtol=0)
        np.testing.assert_array_equal(
            folded[i].numpy(),
            _words(jax.random.fold_in(jk, [4, 0, 77][i])))
        np.testing.assert_array_equal(split[i].numpy(),
                                      _words(jax.random.split(jk, 3)))
