"""Two-run merge join: sort each relation once, probe the sorted build run.

The implementation behind the flagship joiner's count (ops/sort_merge.py),
the radix and no-partitioning joiners' "vmem" mode, the planner's general
plan and the query layer's key-ordered materializer:

    order:  one unstable 1-key sort per relation (a single-key sort is the
            form XLA:GPU hands to CUB's radix sort)
    probe:  on the GPU, the windowed Pallas/Triton probe
            (ops/windowed_probe.py): each block of sorted probe keys
            binary-searches only its window of the sorted build run.
            Elsewhere (and for int64 keys) one vectorized
            ``jnp.searchsorted`` of every probe key over the whole run.
            A 10M-row int32 build run is 40 MB, which stays resident in
            the H100's 50 MB L2 during the probe.

Sorting by key IS range-radix clustering (partition = contiguous key range;
Manegold et al.'s radix-cluster on key bits — the reference hashes first
only to randomize arbitrary key sets, src/RadixCluster/HashJoin.hpp:349;
comparison sorting needs no such randomization, so the sorted form is
distribution-robust by construction).

Validity masks (bucketized/padded inputs from parallel/shuffle.py) are
supported exactly: invalid rows are rewritten to INT32_MAX before the sort,
probe rows equal to INT32_MAX are never counted by the search, and genuine
INT32_MAX matches are restored by a closed-form correction term —
sentinel-free over the full int32 domain.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_I32_MAX = jnp.iinfo(jnp.int32).max

#: ``jnp.searchsorted`` algorithm of the plain search: "scan_unrolled"
#: unrolls the log2(n) rounds into one fused program.  It measured faster
#: than "scan" in either probe order and faster than "sort" on an unsorted
#: probe on the H100 (PERF.md, path decisions).
SEARCH_METHOD = "scan_unrolled"


def _key_sort(keys: jax.Array) -> jax.Array:
    """Unstable ascending 1-key sort."""
    return jax.lax.sort((keys,), num_keys=1, is_stable=False)[0]


def sorted_position(a_sorted: jax.Array, q: jax.Array):
    """(hit, idx): ``idx`` is the LOWEST position of ``q`` in ``a_sorted``
    when ``hit`` (searchsorted side="left"), undefined otherwise."""
    n = a_sorted.shape[0]
    idx = jnp.searchsorted(a_sorted, q, side="left", method=SEARCH_METHOD)
    idx = jnp.minimum(idx, n - 1).astype(jnp.int32)
    return a_sorted[idx] == q, idx


def _check_i32(fn_name: str, **arrays) -> None:
    for name, arr in arrays.items():
        dt = jnp.asarray(arr).dtype
        if dt in (jnp.int64, jnp.uint64):
            # never silently truncate 64-bit keys (distinct keys would
            # collide and miscount) — same contract as hash_table._as_i32_keys
            raise TypeError(
                f"{fn_name} is the int32 path ({name} is {dt}); "
                "use two_run_count_i64 for 64-bit keys"
            )


def two_run_count(
    build_keys: jax.Array,
    probe_keys: jax.Array,
    build_valid=None,
    probe_valid=None,
) -> jax.Array:
    """Get-semantics match count (number of valid probe rows whose key
    appears among valid build keys), int32 keys.

    Equivalent to ops/sort_merge.py::sort_merge_count.  int64 keys take
    ``two_run_count_i64``.
    """
    _check_i32("two_run_count", build_keys=build_keys, probe_keys=probe_keys)
    build_keys = jnp.asarray(build_keys, jnp.int32)
    probe_keys = jnp.asarray(probe_keys, jnp.int32)
    if build_keys.shape[0] == 0 or probe_keys.shape[0] == 0:
        return jnp.asarray(0, jnp.int32)
    # composed as _prepare_build_i32 + _probe_prepared_i32 so the INT32_MAX
    # validity-sentinel protocol lives in exactly one place (PreparedBuild
    # probes through the same two programs, so the compile cache is shared)
    a_sorted, max_in_a = _prepare_build_i32(
        build_keys, build_valid, has_valid=build_valid is not None
    )
    return _probe_prepared_i32(
        a_sorted, max_in_a, probe_keys, probe_valid,
        has_valid=probe_valid is not None,
    )


def _plain_sorted_count(a_sorted, b_keys):
    hit, _ = sorted_position(a_sorted, b_keys)
    return jnp.sum(hit.astype(jnp.int32))


@jax.jit
def sorted_runs_count(a_sorted: jax.Array, b_sorted: jax.Array) -> jax.Array:
    """Count of probe rows whose key exists in the sorted build run — the
    pre-sorted merge primitive (full key domain, int32 or int64; both runs
    ascending).  int32 runs take the windowed Triton probe on the GPU and
    the plain search elsewhere."""
    if a_sorted.shape[0] == 0 or b_sorted.shape[0] == 0:
        return jnp.asarray(0, jnp.int32)
    if a_sorted.dtype != jnp.int32 or b_sorted.dtype != jnp.int32:
        return _plain_sorted_count(a_sorted, b_sorted)
    from partitionedhashjoin_tpu.ops import windowed_probe

    return jax.lax.platform_dependent(
        a_sorted, b_sorted,
        cuda=windowed_probe.windowed_count, default=_plain_sorted_count,
    )


@functools.partial(jax.jit, static_argnames=("has_valid",))
def _prepare_build_i32(build_keys, build_valid=None, has_valid=False):
    build_keys = jnp.asarray(build_keys, jnp.int32)
    if has_valid:
        build_valid = jnp.asarray(build_valid, jnp.bool_)
        a_eff = jnp.where(build_valid, build_keys, _I32_MAX)
        max_in_a = jnp.any(build_valid & (build_keys == _I32_MAX))
    else:
        a_eff = build_keys
        max_in_a = jnp.any(build_keys == _I32_MAX)
    return _key_sort(a_eff), max_in_a


@functools.partial(jax.jit, static_argnames=("has_valid",))
def _probe_prepared_i32(
    a_sorted, max_in_a, probe_keys, probe_valid=None, has_valid=False,
):
    probe_keys = jnp.asarray(probe_keys, jnp.int32)
    if has_valid:
        probe_valid = jnp.asarray(probe_valid, jnp.bool_)
        b_eff = jnp.where(probe_valid, probe_keys, _I32_MAX)
        n_max = jnp.sum(
            (probe_valid & (probe_keys == _I32_MAX)).astype(jnp.int32)
        )
    else:
        b_eff = probe_keys
        n_max = jnp.sum((probe_keys == _I32_MAX).astype(jnp.int32))
    # the probe sort orders the searches so neighbouring queries read
    # neighbouring build positions
    b_sorted = _key_sort(b_eff)
    # INT32_MAX rows (the invalid sentinel, or genuine) match iff the build
    # run holds INT32_MAX; they are taken out here and the genuine matches
    # restored in closed form
    n_max_eff = jnp.sum((b_eff == _I32_MAX).astype(jnp.int32))
    count = sorted_runs_count(a_sorted, b_sorted) - jnp.where(
        a_sorted[-1] == _I32_MAX, n_max_eff, 0
    )
    return count + jnp.where(max_in_a, n_max, 0)


class PreparedBuild:
    """Build once, probe many — the engine analogue of the reference's
    reusable built hash table (src/NoPartitioning/HashJoin.hpp: Build runs
    once at :60-103, Probe is then driven repeatedly against the same
    table).  The flagship join's "index" is the sorted build run; this
    object pays that sort (and the INT32_MAX bookkeeping) exactly once and
    serves any number of probes against it.

    Supports int32 (with validity masks) and int64 (requires x64; masks
    unsupported — rewrite keys on the caller side).
    """

    def __init__(self, build_keys, build_valid=None):
        keys = jnp.asarray(build_keys)
        self._n = int(keys.shape[0])
        self._i64 = keys.dtype in (jnp.int64, jnp.uint64)
        if self._i64:
            if build_valid is not None:
                raise TypeError(
                    "validity masks are int32-path only; rewrite invalid "
                    "int64 keys before preparing the build"
                )
            self.a_sorted = _key_sort(keys.astype(jnp.int64))
            self.max_in_a = None
        else:
            self.a_sorted, self.max_in_a = _prepare_build_i32(
                keys, build_valid, has_valid=build_valid is not None
            )

    def count(self, probe_keys, probe_valid=None) -> jax.Array:
        """Get-semantics match count of this probe against the prepared
        build — no build-side work happens here."""
        if self._n == 0 or jnp.asarray(probe_keys).shape[0] == 0:
            return jnp.asarray(0, jnp.int32)
        if self._i64:
            if probe_valid is not None:
                raise TypeError("validity masks are int32-path only")
            return sorted_runs_count(
                self.a_sorted, _key_sort(jnp.asarray(probe_keys, jnp.int64))
            )
        return _probe_prepared_i32(
            self.a_sorted, self.max_in_a, probe_keys, probe_valid,
            has_valid=probe_valid is not None,
        )


# ---------------------------------------------------------------------------
# Materializing two-run join (engine extension; the reference materializes
# nothing — src/NoPartitioning/HashJoin.hpp:186 returns an empty table).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("probe_payload_sorted",))
def _materialize_i32(
    build_keys, build_payloads, probe_keys, probe_payloads,
    probe_payload_sorted: bool = False,
):
    def kv_sort(keys, pay, full_lex=False):
        # unstable key sort carrying the payload.  full_lex: the payload
        # becomes a SECOND sort key, so output runs are payload-ascending
        # within each key — what aggregate_sorted's payload_sorted fast
        # path consumes
        return jax.lax.sort(
            (jnp.asarray(keys, jnp.int32), jnp.asarray(pay, jnp.int32)),
            num_keys=2 if full_lex else 1, is_stable=False,
        )

    a_keys, a_pay = kv_sort(build_keys, build_payloads)
    b_keys, b_pay = kv_sort(
        probe_keys, probe_payloads, full_lex=probe_payload_sorted
    )
    hit, idx = sorted_position(a_keys, b_keys)
    pay_a = jnp.where(hit, a_pay[idx], 0)
    count = jnp.sum(hit.astype(jnp.int32))
    return b_keys, pay_a, b_pay, hit, count


@jax.jit
def _compact_hits(b_keys, pay_a, b_pay, hit):
    from partitionedhashjoin_tpu.ops.filter import compact

    _, keys, pa, pb = compact(hit, b_keys, pay_a, b_pay)
    return keys, pa, pb


def two_run_materialize(
    build_keys: jax.Array,
    build_payloads: jax.Array,
    probe_keys: jax.Array,
    probe_payloads: jax.Array,
    probe_payload_sorted: bool = False,
):
    """Materialized first-match inner join on the two-run path (int32).

    Output order is SORTED-KEY order (the engine's natural order after the
    two-run partition step), compacted to the front with a zero tail:
    returns ``(keys, pay_a, pay_b, count)``.  Among duplicate build keys
    the LOWEST sorted-A position wins (deterministic).  Differs from
    ``ops.sort_merge.sort_merge_materialize`` (probe-row order, latest
    build row) — callers needing probe order pay one more placement sort.

    Cost anatomy: two value-carrying sorts + one search and payload
    gather; the compaction dispatch is SKIPPED when every probe row
    matches (count readback decides), which is the common
    primary-key⋈foreign-key case.

    ``probe_payload_sorted=True`` makes the probe payload a SECOND sort
    key, so output ``pay_b`` runs ascend within each key — the order
    ``aggregate_sorted(payload_sorted=True)`` consumes for a sort-free
    downstream GROUP BY (the composed-query plan).  The stable compaction
    preserves the order in the non-all-match case.
    """
    _check_i32(
        "two_run_materialize", build_keys=build_keys,
        build_payloads=build_payloads, probe_keys=probe_keys,
        probe_payloads=probe_payloads,
    )
    n_b = jnp.asarray(probe_keys).shape[0]
    if jnp.asarray(build_keys).shape[0] == 0 or n_b == 0:
        z = jnp.zeros((n_b,), jnp.int32)
        return z, z, z, jnp.asarray(0, jnp.int32)
    b_keys, pay_a, b_pay, hit, count = _materialize_i32(
        build_keys, build_payloads, probe_keys, probe_payloads,
        probe_payload_sorted=probe_payload_sorted,
    )
    if int(jax.device_get(count)) == n_b:  # all-match: no compaction needed
        return b_keys, pay_a, b_pay, count
    keys, pa, pb = _compact_hits(b_keys, pay_a, b_pay, hit)
    return keys, pa, pb, count


@jax.jit
def _count_i64(build_keys, probe_keys):
    a_sorted = _key_sort(jnp.asarray(build_keys, jnp.int64))
    b_sorted = _key_sort(jnp.asarray(probe_keys, jnp.int64))
    return _plain_sorted_count(a_sorted, b_sorted)


def two_run_count_i64(build_keys: jax.Array, probe_keys: jax.Array) -> jax.Array:
    """int64-key two-run count join (requires x64 mode).  The reference's
    Tuple::id is int64 (src/Common/Table.hpp:20-25).  No sentinel is
    involved, so the whole int64 domain is exact."""
    if build_keys.shape[0] == 0 or probe_keys.shape[0] == 0:
        return jnp.asarray(0, jnp.int32)
    return _count_i64(build_keys, probe_keys)
