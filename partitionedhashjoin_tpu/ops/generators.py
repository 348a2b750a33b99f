"""Device-side data generators: the engine's first kernels.

Counterparts of src/DataGenerator/:

- ``sequential_keys`` / ``sequential_table``: ids ``start, start+1, ...`` with
  ``payload = row index`` (src/DataGenerator/Sequential.cpp:20-25).  This is
  a single iota — the reference's per-thread batch loop (Sequential.cpp:27-39)
  is replaced by data parallelism.
- ``zipf_keys`` / ``zipf_table``: Zipf(alpha)-distributed ids over a closed
  range [lo, hi] via the same inverse-CDF-proposal rejection sampler as the
  reference (src/DataGenerator/Zipf.cpp:14-56, after
  jasoncrease's "Rejection sampling the Zipf distribution"), vectorized as
  one oversampled candidate round whose accepted draws are compacted to the
  front (see ``zipf_keys``).  Randomness is JAX's counter-based threefry instead
  of the per-worker Park-Miller LCG (src/Common/Random.cpp:9-30) — stateful
  sequential generators do not map to SPMD hardware; the distribution is
  identical (equivalence validated in tests against the host LCG sampler).

Both samplers share the reference's parameter conventions: the alpha~1 clamp
(Zipf.cpp:22-26), the closed-range cardinality and ``lo - 1`` correction
(Zipf.cpp:81-83), and ``payload = i`` (Zipf.cpp:48-49 analogue).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import Table, make_table

_ERROR_DIFFERENTIAL = 0.01


def _zipf_params(alpha: float, cardinality: int) -> Tuple[float, float, float]:
    """Clamped (alpha, skew_differential, normalization) — Zipf.cpp:16-29."""
    if alpha < 0.01:
        raise ValueError("Skew parameter must be greater than 0.01.")
    skew_differential = 1.001 - alpha
    diff = 1.0 - alpha
    if abs(diff) < _ERROR_DIFFERENTIAL:
        skew_differential = _ERROR_DIFFERENTIAL * (1.0 if diff < 0 else -1.0)
        alpha = 1.0 - skew_differential
    normalization = (
        math.pow(cardinality, skew_differential) - alpha
    ) / skew_differential
    return alpha, skew_differential, normalization


def zipf_candidates(u1, u2, alpha: float, cardinality: int, u3=None):
    """One vectorized accept/reject round given uniforms in [0, 1).

    Returns (samples int32 in [1, cardinality], accepted bool).  Pure jnp.

    Float32 has a 24-bit mantissa, so for cardinality > 2^24 the inverse-CDF
    lands only on multiples of the local float spacing (4 at 2^24..2^25, 8
    above, ...), making most large keys unreachable.  ``u3`` dithers the
    integer sample uniformly within its float32 quantum: the Zipf density's
    relative change across one quantum is alpha * spacing / k < 2^-23, so
    the dithered distribution is exact to ~1e-7 — the reference samples in
    double (Zipf.cpp) where no dither is needed.
    """
    alpha_c, sd, norm = _zipf_params(alpha, cardinality)
    dtype = u1.dtype
    alpha_v = jnp.asarray(alpha_c, dtype)
    sd_v = jnp.asarray(sd, dtype)
    norm_v = jnp.asarray(norm, dtype)

    un = u1 * norm_v
    # inverse CDF of the proposal (Zipf.cpp:35-43)
    icdf_tail = jnp.power(un * sd_v + alpha_v, 1.0 / sd_v)
    icdf = jnp.where(un <= 1.0, un, icdf_tail)
    sample = jnp.floor(icdf + 1.0)
    # guard float rounding at the top of the range (u1 < 1 guarantees
    # icdf < cardinality in exact arithmetic)
    sample = jnp.clip(sample, 1.0, float(cardinality))

    density_original = jnp.power(sample, -alpha_v)
    density_sampling = jnp.where(
        sample <= 1.0, 1.0 / norm_v, jnp.power(icdf, -alpha_v) / norm_v
    )
    ratio = density_original / (density_sampling * norm_v)
    accepted = u2 < ratio

    sample_i = sample.astype(jnp.int32)
    if u3 is not None and cardinality > (1 << 24):
        # float32 spacing at |sample|: 2^(exponent - 23); uniform dither
        # within [sample, sample + spacing) re-populates the skipped ints
        exponent = (
            (jax.lax.bitcast_convert_type(sample.astype(jnp.float32), jnp.int32)
             >> 23) & 0xFF
        ) - 127
        spacing = jnp.where(
            exponent > 23,
            jnp.left_shift(jnp.int32(1), jnp.maximum(exponent - 23, 0)),
            1,
        )
        dither = (u3 * spacing.astype(jnp.float32)).astype(jnp.int32)
        sample_i = jnp.minimum(sample_i + dither, cardinality)
    return sample_i, accepted


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _zipf_round(key: jax.Array, m: int, alpha: float, cardinality: int):
    """One oversampled rejection round: m candidates, accepted ones
    compacted to the front IN DRAW ORDER.  Returns (vals int32[m], count).

    The 2-key unstable sort on (rejected-flag, draw position) carries the
    samples as a value operand; the position tiebreak matters for
    exactness — sorting accepted samples by *value* and taking a prefix
    would bias toward small keys, whereas a draw-order prefix of an iid
    stream is itself iid."""
    u = jax.random.uniform(key, (3, m), dtype=jnp.float32)
    sample, ok = zipf_candidates(u[0], u[1], alpha, cardinality, u3=u[2])
    flag = jnp.where(ok, 0, 1).astype(jnp.int32)
    iota = jnp.arange(m, dtype=jnp.int32)
    flag_s, _, vals = jax.lax.sort(
        (flag, iota, sample), num_keys=2, is_stable=False
    )
    return vals, m - jnp.sum(flag_s)


def zipf_keys(
    key: jax.Array,
    n: int,
    alpha: float,
    cardinality: int,
    oversample: float = 1.35,
) -> jax.Array:
    """n Zipf(alpha) samples over the closed range [1, cardinality], int32.

    Oversample-and-compact rejection (Zipf.cpp:31-55 semantics): draw
    ``oversample * n`` candidates in ONE vectorized round, stable-partition
    the accepted ones to the front, take the first n.  Measured acceptance
    is >= 0.82 for alpha in [0.5, 2] (>= 0.96 at the benchmark's 1.05), so
    one round suffices in practice; a host-level refill loop tops up any
    shortfall exactly.  Replaces the earlier lockstep all-slots-retry
    while_loop, which re-ran full-width threefry + pow over all n slots
    until the LAST slot accepted (~7 rounds; this formulation runs one
    1.35x-wide round + one compaction sort).
    """
    _zipf_params(alpha, cardinality)  # validate alpha (raises early)
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    parts = []
    remaining = n
    first_m = int(n * oversample) + 4096
    while remaining > 0:
        key, sub = jax.random.split(key)
        m = int(remaining * oversample) + 4096
        if remaining < n:
            # refill rounds: snap the data-dependent shortfall size to a
            # power of two so rare top-ups reuse a cached compile instead of
            # paying a fresh compile per distinct m
            m = min(first_m, 1 << (m - 1).bit_length())
        vals, cnt = _zipf_round(sub, m, alpha, cardinality)
        take = min(int(cnt), remaining)
        if take > 0:
            parts.append(jax.lax.slice_in_dim(vals, 0, take))
            remaining -= take
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


@functools.partial(jax.jit, static_argnums=(1,))
def zipf_keys_alias(
    key: jax.Array, n: int, prob: jax.Array, alias: jax.Array
) -> jax.Array:
    """n Zipf samples via Vose alias tables (exact, rejection-free).

    ``(prob, alias)`` come from the native builder
    (data/host_loader.py::build_zipf_alias); each draw is two uniforms and
    two gathers: bin = floor(u1 * card); emit bin if u2 < prob[bin] else
    alias[bin] (+1 for the 1-based key range).  Preferred when the alias
    tables (8 B/key of the *cardinality*, not the relation) are cheap to
    build/transfer — e.g. 80 MB for cardinality 10M vs 800 MB for a 200M-row
    relation.  Cardinality must be <= 2^24 (float32 bin selection is exact
    there; larger domains use the dithered rejection sampler, zipf_keys).
    """
    card = prob.shape[0]
    if card > (1 << 24):
        raise ValueError(
            "alias sampler requires cardinality <= 2^24; use zipf_keys"
        )
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n,), dtype=jnp.float32)
    u2 = jax.random.uniform(k2, (n,), dtype=jnp.float32)
    bin_ = jnp.minimum((u1 * card).astype(jnp.int32), card - 1)
    take_bin = u2 < prob[bin_]
    return jnp.where(take_bin, bin_, alias[bin_]) + 1


def uniform_keys(
    key: jax.Array, n: int, lo: int, hi: int, dtype=jnp.int32
) -> jax.Array:
    """n uniform ids over the closed range [lo, hi] — Zipf with alpha = 0.

    The uniform-keys workload (BASELINE.json configs "uniform keys",
    10M⋈200M).  Zipf(0) IS the uniform distribution, so this is the exact
    ``--skew 0`` semantics of the reference sampler (Zipf.cpp:14-56 with
    alpha = 0 accepts every proposal uniformly) — implemented directly with
    one counter-based randint draw instead of the rejection loop.
    """
    return jax.random.randint(key, (n,), lo, hi + 1, dtype=dtype)


def uniform_table(
    n: int,
    key_range: Tuple[int, int],
    seed: Optional[int] = None,
    dtype=jnp.int32,
) -> Table:
    """Secondary relation with uniform ids over closed [lo, hi]."""
    lo, hi = key_range
    if lo >= hi:
        raise ValueError(
            f"Range for uniform generation is incorrectly specified: [{lo}, {hi}]."
        )
    if seed is None:
        import numpy as _np

        seed = int(_np.random.SeedSequence().entropy & 0x7FFFFFFF)
    ids = uniform_keys(jax.random.PRNGKey(seed), n, lo, hi, dtype=dtype)
    return make_table(ids, jnp.arange(n, dtype=dtype))


def sequential_keys(n: int, start: int = 1, dtype=jnp.int32) -> jax.Array:
    """ids start..start+n-1 (Sequential.cpp:20-25)."""
    return start + jnp.arange(n, dtype=dtype)


def sequential_table(n: int, start: int = 1, dtype=jnp.int32) -> Table:
    """Primary relation: sequential unique ids, payload = row index."""
    return make_table(
        sequential_keys(n, start, dtype), jnp.arange(n, dtype=dtype)
    )


def zipf_table(
    n: int,
    alpha: float,
    key_range: Tuple[int, int],
    seed: Optional[int] = None,
    dtype=jnp.int32,
    method: str = "rejection",
) -> Table:
    """Secondary relation: Zipf ids over closed [lo, hi], payload = row index.

    Mirrors Zipf::FillTable (Zipf.cpp:58-108): range validation, closed-range
    cardinality, and the ``lo - 1`` correction.

    ``method``: "rejection" (pure-device, the reference's sampler math) or
    "alias" (native host-built Vose tables + two-gather device sampling —
    exact and rejection-free; requires cardinality <= 2^24).
    """
    lo, hi = key_range
    if lo >= hi:
        raise ValueError(
            f"Range for Zipf generation is incorrectly specified: [{lo}, {hi}]."
        )
    if float(alpha) == 0.0:
        # Zipf(0) is the uniform distribution; skip the rejection/alias
        # machinery and draw directly (same key multiset semantics).
        return uniform_table(n, key_range, seed=seed, dtype=dtype)
    cardinality = hi - lo + 1
    correction = lo - 1
    if seed is None:
        # fresh entropy, like the reference's random_device-seeded factory
        # (src/Common/Random.cpp:32-41)
        import numpy as _np

        seed = int(_np.random.SeedSequence().entropy & 0x7FFFFFFF)
    rng = jax.random.PRNGKey(seed)
    if method == "alias":
        if cardinality > (1 << 24):
            raise ValueError(
                "alias sampling requires cardinality <= 2^24 "
                "(float32 bin selection); use method='rejection'"
            )
        from partitionedhashjoin_tpu.data.host_loader import build_zipf_alias

        # same clamped alpha as the rejection path (Zipf.cpp:22-26), so both
        # methods target the same distribution for any skew
        alpha_c, _, _ = _zipf_params(float(alpha), int(cardinality))
        prob, alias = build_zipf_alias(alpha_c, int(cardinality))
        ids = zipf_keys_alias(
            rng, n, jax.device_put(prob), jax.device_put(alias)
        )
    elif method == "rejection":
        ids = zipf_keys(rng, n, float(alpha), int(cardinality))
    else:
        raise ValueError(f"unknown Zipf sampling method: {method!r}")
    ids = (ids + jnp.asarray(correction, jnp.int32)).astype(dtype)
    return make_table(ids, jnp.arange(n, dtype=dtype))
