"""Threefry-2x32 counter-based random numbers: the port's own copy of the
``jax.random`` calls the fault schedules make, so that a schedule draws the
JAX package's bits for the same key.

JAX's default PRNG (``jax_threefry_partitionable=True``, the default since
JAX 0.5) hashes a 64-bit iota of the output shape, split into two uint32
words, with the 20-round Threefry-2x32 block cipher keyed by the two words
of the key (``jax/_src/prng.py threefry_2x32``,
``_threefry_random_bits_partitionable``, ``_threefry_split_foldlike``,
``_threefry_fold_in``). Here every uint32 word is held in an ``int64``
tensor with its value in ``[0, 2**32)``: each add and rotate is masked with
``0xFFFFFFFF``, so right shifts never see a sign bit.

Keys are ``(..., 2)`` integer tensors; leading axes are a batch of keys
(one per scenario) and broadcast against the draws: ``bits32(key, shape)``
returns ``key.shape[:-1] + shape``. Everything is stateless and runs on the
key's device -- no ``torch.Generator``, no host copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Giles' single-precision erf^-1 coefficients (the f32 expansion XLA and
# StableHLO use for ``lax.erf_inv``), innermost first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry_2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the count words ``(x0, x1)`` under the key
    words ``(k1, k2)`` (all int64 holding uint32, broadcasting): 5 blocks
    of 4 rounds with a key injection after each."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (the JAX package's
    setting): the key ``[0, seed mod 2**32]`` (int64 words) on ``device``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor):
    """The key's two words, each ``key.shape[:-1]``."""
    if key.shape[-1] != 2:
        raise ValueError(f"a key has 2 words on its last axis: {key.shape}")
    key = key.to(torch.int64)
    return key[..., 0], key[..., 1]


def _hash_iota(key: torch.Tensor, shape: tuple):
    """``threefry_2x32(key, iota_2x32_shape(shape))``: both output words,
    ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    lead = k1.shape
    k1 = k1.reshape(lead + (1,) * len(shape))
    k2 = k2.reshape(lead + (1,) * len(shape))
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return threefry_2x32(k1, k2, idx >> 32, idx & MASK32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count ``[0, data]``
    (data as uint32: a Python int, which costs no host-to-device copy, or
    a tensor broadcasting against the key's batch axes)."""
    k1, k2 = _words(key)
    data = (data if isinstance(data, int) else data.to(torch.int64)) & MASK32
    y0, y1 = threefry_2x32(k1, k2, 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``key.shape[:-1] + (num, 2)``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def bits32(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64):
    ``key.shape[:-1] + shape``."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple, dtype=torch.float32,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to ``[minval, maxval)``."""
    if dtype != torch.float32:
        raise ValueError(f"uniform: float32 only, not {dtype}")
    mant = (bits32(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars, so the scale and shift round as JAX's do.
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * scale + lo, min=lo)


def bernoulli(key: torch.Tensor, p, shape: tuple) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``'low'``): ``uniform <
    p`` in float32. ``p`` is a scalar or one value per key (``key.shape[:-1]``)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    p = p.reshape(p.shape + (1,) * len(shape))
    return uniform(key, shape) < p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf^-1`` by Giles' approximation, as ``lax.erf_inv`` lowers
    it (``w = -log1p(-x^2)``, a degree-8 polynomial in ``w - 2.5`` below 5
    and in ``sqrt(w) - 3`` above; ``+-1 -> +-inf``)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, c_lt),
                        torch.full_like(x, c_ge))
        p = c + p * w
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: tuple,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) erf^-1(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    return erfinv(u) * float(np.float32(math.sqrt(2)))
