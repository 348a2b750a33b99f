"""Windowed probe of a sorted build run: a Pallas kernel through Triton.

The two-run join's probe (ops/merge_join.py) binary-searches every probe
key over the WHOLE sorted build run: log2(n_build) dependent gathers per
row (24 at 10M).  When the probe side is sorted too, a block of
``BLOCK`` consecutive probe keys can only match the build keys between the
block's first and last key — its window, found by two searches per block
(not per row).  One program per probe block then searches only that window:
bit_length(window) rounds instead of 24, a trip count that is uniform
across the program, with all of the block's gathers landing in one small
region of the build run.  The window is not staged in shared memory: each
round is one dependent gather, read through L1/L2, so there is no load loop
to pipeline.

Exactness: every row is searched over its block's full window, so the
count is the full-domain Get-semantics count; probe padding rows are masked
by position, never by a sentinel key.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: probe rows per program (a power of two, as Triton requires)
BLOCK = 1024


def _window_count_kernel(a_ref, b_ref, lo_ref, steps_ref, hi_ref, out_ref,
                         *, n_a: int, n_b: int):
    i = pl.program_id(0)
    pos = i * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    valid = pos < n_b
    q = plgpu.load(b_ref.at[pl.ds(i * BLOCK, BLOCK)], mask=valid, other=0)
    lo = lo_ref[i]
    hi = hi_ref[i]

    def body(_, carry):
        left, right = carry
        active = left < right
        mid = left + (right - left) // 2  # no int32 overflow
        v = plgpu.load(a_ref.at[jnp.minimum(mid, n_a - 1)])
        go_right = active & (v < q)
        go_left = active & ~(v < q)
        return (
            jnp.where(go_right, mid + 1, left),
            jnp.where(go_left, mid, right),
        )

    left, _ = jax.lax.fori_loop(
        0, steps_ref[i], body,
        (jnp.full((BLOCK,), lo, jnp.int32), jnp.full((BLOCK,), hi, jnp.int32)),
    )
    v = plgpu.load(a_ref.at[jnp.minimum(left, n_a - 1)])
    hit = valid & (left < hi) & (v == q)
    out_ref[i] = jnp.sum(hit.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("interpret",))
def windowed_count(a_sorted: jax.Array, b_sorted: jax.Array,
                   interpret: bool = False) -> jax.Array:
    """Number of rows of the ascending ``b_sorted`` whose key occurs in the
    ascending ``a_sorted`` (int32, full domain)."""
    n_a, n_b = a_sorted.shape[0], b_sorted.shape[0]
    if n_a == 0 or n_b == 0:
        return jnp.asarray(0, jnp.int32)
    num_blocks = -(-n_b // BLOCK)
    last = jnp.minimum(
        jnp.arange(num_blocks, dtype=jnp.int32) * BLOCK + BLOCK - 1, n_b - 1
    )
    # each block's window [lo, hi) of the build run, and the search rounds
    # it needs: bit_length(hi - lo)
    lo = jnp.searchsorted(a_sorted, b_sorted[::BLOCK], side="left")
    hi = jnp.searchsorted(a_sorted, b_sorted[last], side="right")
    lo, hi = lo.astype(jnp.int32), hi.astype(jnp.int32)
    steps = 32 - jax.lax.clz(hi - lo)
    per_block = pl.pallas_call(
        functools.partial(_window_count_kernel, n_a=n_a, n_b=n_b),
        out_shape=jax.ShapeDtypeStruct((num_blocks,), jnp.int32),
        grid=(num_blocks,),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        backend="triton",
        interpret=interpret,
        name="windowed_probe_count",
    )(a_sorted.astype(jnp.int32), b_sorted.astype(jnp.int32), lo, steps, hi)
    return jnp.sum(per_block)
