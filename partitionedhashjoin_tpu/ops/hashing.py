"""Vectorized seedable hashing.

Counterpart of the reference's XXHasher (src/Common/IHasher.hpp:6-11,
src/Common/XXHasher.hpp:10-28: XXH3_64bits_withSeed over the 8-byte key,
reduced ``% cardinality``).  We use a murmur3-style finalizer (avalanche
multiply-xor-shift) rather than XXH3: the finalizer is a handful of
data-parallel uint32 ops, the avalanche quality is equivalent for 4/8-byte
fixed-width keys, and the reference's contract is only "uniform seeded hash to
[0, cardinality)" — its two hashers are decorrelated by random seeds, not by
algorithm (src/main.cpp:211-217,267).

All functions are pure jnp on unsigned ints, so they work identically in any
traced program, on the GPU and the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


def fmix32(h):
    """murmur3 32-bit finalizer: full avalanche on uint32 lanes."""
    h = jnp.asarray(h, jnp.uint32)
    h = h ^ (h >> 16)
    h = h * _C1
    h = h ^ (h >> 13)
    h = h * _C2
    h = h ^ (h >> 16)
    return h


def hash32(keys, seed=0):
    """Seeded uint32 hash of 32-bit keys (int32/uint32 accepted).

    ``seed`` may be a Python int or a traced scalar (so per-instance random
    seeds, XXHasher.hpp:12-17, don't trigger recompilation under jit).
    """
    h = jnp.asarray(keys).astype(jnp.uint32)
    if isinstance(seed, int):
        seed = np.uint32(seed & 0xFFFFFFFF)
    h = h ^ jnp.asarray(seed).astype(jnp.uint32)
    h = fmix32(h)
    # second round decorrelates consecutive keys fully even after xor-seed
    h = fmix32(h + _GOLDEN)
    return h


def hash64_pair(lo, hi, seed: int = 0):
    """Seeded uint32 hash of 64-bit keys given as (lo, hi) uint32 halves.

    Used when 64-bit keys are carried without enabling jax x64: mixes both
    halves through the finalizer with distinct round constants.
    """
    lo = jnp.asarray(lo).astype(jnp.uint32)
    hi = jnp.asarray(hi).astype(jnp.uint32)
    h = fmix32(lo ^ jnp.uint32(np.uint32(seed)))
    h = fmix32(h ^ hi ^ _GOLDEN)
    return h


def bucket(h, cardinality: int):
    """Reduce a uint32 hash to [0, cardinality) (XXHasher.hpp:19-22 semantics).

    Power-of-two cardinalities use a mask over the (fully avalanched) low
    bits; the general case uses modulo.
    """
    h = jnp.asarray(h, jnp.uint32)
    if cardinality <= 0:
        raise ValueError("bucket: cardinality must be positive")
    if cardinality & (cardinality - 1) == 0:
        return (h & jnp.uint32(cardinality - 1)).astype(jnp.int32)
    return (h % jnp.uint32(cardinality)).astype(jnp.int32)


class VectorHasher:
    """Per-instance randomly-seeded hasher (XXHasher.hpp:12-22 semantics).

    ``hash(keys, cardinality)`` maps a key vector to bucket/partition indices
    in [0, cardinality).  Two independently constructed instances are
    decorrelated by their seeds, mirroring the reference's use of separate
    hashers for partitioning vs. hash-table bucketing (src/main.cpp:215-217,267).
    """

    def __init__(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = int(np.random.SeedSequence().entropy & 0xFFFFFFFF)
        self.seed = int(seed) & 0xFFFFFFFF

    def hash_bits(self, keys):
        return hash32(keys, self.seed)

    def hash(self, keys, cardinality: int):
        return bucket(hash32(keys, self.seed), cardinality)


def split64(keys64) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split int64/uint64 keys into (lo, hi) uint32 halves (x64 mode only)."""
    k = jnp.asarray(keys64).astype(jnp.uint64)
    lo = (k & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (k >> jnp.uint64(32)).astype(jnp.uint32)
    return lo, hi
