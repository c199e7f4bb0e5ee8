"""Deterministic, order-independent random draws (counterpart of
shadow1_tpu/core/rng.py).

Two halves:

* Keys.  `root_key`/`purpose_key`/`world_key` are JAX's threefry2x32
  `PRNGKey`/`fold_in`, written in numpy and run on the host at build
  time.  A key is a numpy uint32[2] array, bit-identical to
  `jax.random.key_data` of the JAX key.  `NetParams` folds every
  `PURPOSE_*` key once when it is built (params.purpose_words), so no
  draw re-derives a key.
* Draws.  `keyed_bits`/`keyed_uniform` are the stateless 32-bit hash of
  the JAX package, on int64 tensors masked to 32 bits: torch's CPU
  kernels have no `>>` or `+` on torch.uint32.  The multiplies by the
  mixing constants go through `_mul32`, which splits the constant into
  16-bit halves so no intermediate product leaves int64's range (the
  wrap of a signed 64-bit product is not something to rely on).
"""

from __future__ import annotations

import numpy as np
import torch

PURPOSE_PACKET_DROP = 1
PURPOSE_HOST_APP = 2
PURPOSE_ATTACH = 3
PURPOSE_JITTER = 4
PURPOSE_SCHED = 5
PURPOSE_CHAOS = 6
PURPOSE_LINEAGE = 7
PURPOSE_WORLD = 8

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

# ---------------------------------------------------------------------------
# threefry2x32 keys (host side, numpy)
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: int, k2: int, x0: int, x1: int) -> tuple[int, int]:
    """One threefry2x32 block (20 rounds), the function behind JAX's
    `threefry_2x32` on a single counter pair."""
    k1 &= M32
    k2 &= M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & M32, (x1 + ks[1]) & M32]

    def rounds(rots):
        for r in rots:
            x[0] = (x[0] + x[1]) & M32
            x[1] = ((x[1] << r) | (x[1] >> (32 - r))) & M32
            x[1] ^= x[0]

    for i in range(5):
        rounds(_ROT[i % 2])
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & M32
    return x[0], x[1]


def root_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` as its uint32[2] key data."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & M32], dtype=np.uint32)


def purpose_key(key, purpose: int) -> np.ndarray:
    """`jax.random.fold_in(key, purpose)`: threefry of the counter pair
    (0, data) under the key."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    y0, y1 = _threefry2x32(int(k[0]), int(k[1]), 0, int(purpose) & M32)
    return np.array([y0, y1], dtype=np.uint32)


def world_key(key, world: int) -> np.ndarray:
    """Seed key for world `world` of an ensemble (world 0 = identity)."""
    if world == 0:
        return np.asarray(key, dtype=np.uint32)
    return purpose_key(purpose_key(key, PURPOSE_WORLD), world)


def key_words(key) -> tuple[int, int]:
    """The (first, last) uint32 words keyed_bits mixes, as Python ints."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    return int(k[0]), int(k[-1])


# ---------------------------------------------------------------------------
# Keyed draws (torch, int64 masked to 32 bits)
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32 without leaving int64:
    c = c_hi * 2^16 + c_lo, so both partial products stay below 2^48."""
    c_lo, c_hi = c & 0xFFFF, c >> 16
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & M32


def _mix32(x):
    """Full-avalanche 32-bit finalizer of rng.py, on int64 values in
    [0, 2^32).  Works on Python ints and int64 tensors alike."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _as_u32(v, like):
    """An id as int64 in [0, 2^32): what `jnp.asarray(v, uint32)` keeps."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & M32
    return torch.full_like(like, int(v) & M32, dtype=torch.int64)


def keyed_bits(words: tuple[int, int], *ids) -> torch.Tensor:
    """uint32 random bits (held in int64) keyed by integer ids.

    `words` are the two key words of a purpose key (params.purpose_words
    or key_words()).  `ids` are tensors of one broadcast shape or Python
    ints; at least one must be a tensor."""
    k0, k1 = words
    like = next(i for i in ids if isinstance(i, torch.Tensor))
    shape = torch.broadcast_shapes(*[i.shape for i in ids
                                     if isinstance(i, torch.Tensor)])
    like = torch.zeros(shape, dtype=torch.int64, device=like.device)
    h = _mix32((k0 ^ 0x85EBCA6B) & M32)      # a Python int
    hv = torch.full_like(like, h)
    for n, idv in enumerate(ids):
        g = (_GOLDEN * (2 * n + 1)) & M32
        hv = _mix32(hv ^ ((_as_u32(idv, like) + g) & M32))
    return _mix32(hv ^ k1)


def keyed_uniform(words: tuple[int, int], *ids) -> torch.Tensor:
    """U[0,1) as float32 with 24 bits of entropy (same contract as
    keyed_bits): (bits >> 8) * 2^-24, exact in f32."""
    bits = keyed_bits(words, *ids)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
