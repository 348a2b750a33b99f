"""Exact 64-bit summation of 32-bit device arrays without x64 mode.

The engine keeps row data in int32, but a GetAll join
cardinality is Σ multiplicities and can exceed 2^31-1 (e.g. 10^5-duplicated
build keys × 2·10^8 probe rows ≈ 2·10^13).  ``jnp.sum`` over int32 silently
wraps — the reference never hits this because its counter is a C++ int64
(src/NoPartitioning/HashJoin.hpp:144-157 accumulates into int64_t counters).

``exact_sum_u64`` computes the sum exactly on device using only 32-bit
integer ops: terms are decomposed into base-2^15 limbs, limb streams are
reduced in 2^15-wide chunks (15+15 = 30 bits — int32-exact), and the
shrinking partial-sum arrays recurse until scalar.  The result is a
``uint32[2]`` (hi, lo) pair; ``pair_to_int`` rebuilds the Python int on host.
Deterministic, exact for true sums < 2^64, and a handful of streaming
reductions in cost (the term arrays shrink 2^15× per level).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LIMB_BITS = 15
_LIMB_MASK = (1 << _LIMB_BITS) - 1
_CHUNK = 1 << _LIMB_BITS  # reduction width: chunk_sum < 2^30, int32-exact


def _add_shifted(hi, lo, val, shift: int):
    """(hi, lo) += val · 2^shift for a uint32 scalar ``val``, static shift."""
    if shift >= 64:
        return hi, lo
    if shift >= 32:
        return hi + (val << jnp.uint32(shift - 32)), lo
    contrib_lo = val << jnp.uint32(shift) if shift else val
    contrib_hi = (val >> jnp.uint32(32 - shift)) if shift else jnp.uint32(0)
    new_lo = lo + contrib_lo
    carry = (new_lo < lo).astype(jnp.uint32)  # wraparound ⇒ carry out
    return hi + contrib_hi + carry, new_lo


def exact_sum_u64(terms: jax.Array) -> jax.Array:
    """Exact Σ terms (non-negative int32/uint32) as a uint32[2] (hi, lo).

    Negative int32 inputs are a caller bug; they would be summed as their
    two's-complement uint32 value.
    """
    x = jnp.asarray(terms)
    if x.dtype == jnp.int32:
        x = x.astype(jnp.uint32)
    if x.dtype != jnp.uint32:
        raise TypeError(f"exact_sum_u64 expects (u)int32 terms, got {x.dtype}")
    hi = jnp.zeros((), jnp.uint32)
    lo = jnp.zeros((), jnp.uint32)
    # (shift, array, value_bits) work items; sizes shrink 2^15× per level and
    # value_bits 15 per limb split, so the Python loop is tiny and static.
    stack = [(0, x.reshape(-1), 32)]
    while stack:
        shift, arr, bits = stack.pop()
        if bits <= 0 or shift >= 64 or arr.shape[0] == 0:
            continue
        if arr.shape[0] == 1:
            v = arr[0]
            hi, lo = _add_shifted(hi, lo, v & jnp.uint32(0xFFFF), shift)
            hi, lo = _add_shifted(hi, lo, v >> jnp.uint32(16), shift + 16)
            continue
        if bits > _LIMB_BITS:
            stack.append((shift + _LIMB_BITS, arr >> jnp.uint32(_LIMB_BITS),
                          bits - _LIMB_BITS))
            arr = arr & jnp.uint32(_LIMB_MASK)
            bits = _LIMB_BITS
        n = arr.shape[0]
        pad = (-n) % _CHUNK
        if pad:
            arr = jnp.concatenate([arr, jnp.zeros((pad,), jnp.uint32)])
        rows = jnp.sum(arr.reshape(-1, _CHUNK), axis=1)  # < 2^30 each
        stack.append((shift, rows, bits + _LIMB_BITS))
    return jnp.stack([hi, lo])


def pair_to_int(pair) -> int:
    """Host-side: rebuild the Python int from a uint32[2] (hi, lo) pair."""
    hi, lo = (int(v) for v in jax.device_get(pair))
    return (hi << 32) | lo
