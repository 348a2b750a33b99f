"""Sort-merge count join — the single-device count path.

The reference's probe is a latched pointer-chase (src/NoPartitioning/
HashJoin.hpp:144-157) because CPUs love caches.  This module implements the
join count with sorts and streaming scans only, no hash table:

1. Concatenate ``[build_keys; probe_keys]``.
2. Unstable 2-key sort on (key, probe-tag): the comparator itself puts every
   build row *before* the equal-keyed probe rows, so each equal-key run is
   [builds..., probes...] without a stable sort.
3. Per-position build multiplicity of the current key =
   ``cumsum(is_build) - (that cumsum at the run start)``; the run-start
   snapshot propagates by ``cummax`` (snapshots are non-decreasing).
4. A probe row matches iff its key's build multiplicity > 0 — the
   ``Get != null`` count semantics (HashJoin.hpp:144-157), gather-free and
   sentinel-free (exact over the full int32 domain).

``valid`` masks support bucketized/padded inputs (parallel/shuffle.py).
SURVEY.md §7 step 3 sanctions exactly this design ("sorted-merge ... instead
of pointer-chasing HashTables"); the hash-table path (ops/no_partitioning.py)
remains for materialization and as the structure-parity join.

``SortMergeJoiner.count`` runs whichever of this concatenated form and the
two-run join (ops/merge_join.py) measured faster on the H100 (PERF.md).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.utils.logger import get_new_logger
from partitionedhashjoin_tpu.utils.results import IHashJoinTimer, NoOpHashJoinTimer


def _key_dtype(build_keys, probe_keys):
    """Common integer key dtype: int64 when either side is 64-bit (requires
    jax x64 mode — the reference's Tuple::id is int64, Table.hpp:20-25),
    else int32.  Chosen explicitly so 64-bit keys are never silently
    truncated."""
    a = jnp.asarray(build_keys).dtype
    b = jnp.asarray(probe_keys).dtype
    return jnp.int64 if jnp.int64 in (a, b) else jnp.int32


def _merged_multiplicity(build_keys, probe_keys, build_valid, probe_valid):
    """Shared sort+scan: returns (is_probe_row, probe_row_valid, mult) in
    sorted order, where mult = number of valid build rows with this key."""
    n_a = build_keys.shape[0]
    n_b = probe_keys.shape[0]
    dtype = _key_dtype(build_keys, probe_keys)
    keys = jnp.concatenate(
        [jnp.asarray(build_keys, dtype), jnp.asarray(probe_keys, dtype)]
    )
    is_build = jnp.concatenate(
        [jnp.ones((n_a,), jnp.bool_), jnp.zeros((n_b,), jnp.bool_)]
    )
    valid = jnp.concatenate(
        [
            jnp.ones((n_a,), jnp.bool_) if build_valid is None else jnp.asarray(build_valid, jnp.bool_),
            jnp.ones((n_b,), jnp.bool_) if probe_valid is None else jnp.asarray(probe_valid, jnp.bool_),
        ]
    )
    # unstable 2-key sort: ties beyond (key, build-tag) are interchangeable
    # for counting, so stability buys nothing
    keys_s, tag_s, valid_s = jax.lax.sort(
        (keys, ~is_build, valid), num_keys=2, is_stable=False
    )
    is_build_s = ~tag_s
    counted = is_build_s & valid_s
    build_prefix = jnp.cumsum(counted.astype(jnp.int32))
    new_key = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), keys_s[1:] != keys_s[:-1]]
    )
    # exclusive prefix at each run start, -1 elsewhere; cummax propagates the
    # current run's snapshot (snapshots never decrease)
    snapshot = jnp.where(new_key, build_prefix - counted.astype(jnp.int32), -1)
    run_start_prefix = jax.lax.cummax(snapshot)
    mult = build_prefix - run_start_prefix
    return ~is_build_s, valid_s, mult


_I32_MIN = jnp.iinfo(jnp.int32).min


@jax.jit
def sort_merge_count(
    build_keys: jax.Array,
    probe_keys: jax.Array,
    build_valid=None,
    probe_valid=None,
) -> jax.Array:
    """Number of (valid) probe rows whose key appears among valid build keys."""
    if build_valid is None and probe_valid is None:
        # Fast path: 2-operand sort + one cummax.  ``last_build = running max
        # of build keys`` equals the most recent build key because keys
        # ascend; the dtype minimum doubles as "no build key yet", so probe
        # rows with that key are handled by a separate O(1)-pass correction
        # instead of a sentinel-free third operand.
        n_a = build_keys.shape[0]
        n_b = probe_keys.shape[0]
        dtype = _key_dtype(build_keys, probe_keys)
        kmin = jnp.iinfo(dtype).min
        build_keys = jnp.asarray(build_keys, dtype)
        probe_keys = jnp.asarray(probe_keys, dtype)
        keys = jnp.concatenate([build_keys, probe_keys])
        # tag participates in the comparator (num_keys=2): builds (False)
        # order before equal-keyed probes (True) WITHOUT stability
        is_probe_tag = jnp.concatenate(
            [jnp.zeros((n_a,), jnp.bool_), jnp.ones((n_b,), jnp.bool_)]
        )
        keys_s, tag_s = jax.lax.sort(
            (keys, is_probe_tag), num_keys=2, is_stable=False
        )
        is_build_s = ~tag_s
        masked = jnp.where(is_build_s, keys_s, kmin)
        last_build = jax.lax.cummax(masked)
        hit = (~is_build_s) & (last_build == keys_s) & (keys_s != kmin)
        count = jnp.sum(hit.astype(jnp.int32))
        # correction: probe keys equal to the dtype minimum match iff any
        # build key is
        min_in_build = jnp.any(build_keys == kmin)
        n_min_probe = jnp.sum((probe_keys == kmin).astype(jnp.int32))
        return count + jnp.where(min_in_build, n_min_probe, 0)
    is_probe, valid, mult = _merged_multiplicity(
        build_keys, probe_keys, build_valid, probe_valid
    )
    hit = is_probe & valid & (mult > 0)
    return jnp.sum(hit.astype(jnp.int32))


@jax.jit
def sort_merge_count_all(
    build_keys: jax.Array,
    probe_keys: jax.Array,
    build_valid=None,
    probe_valid=None,
) -> jax.Array:
    """Full inner-join cardinality (duplicates multiply, ``GetAll``
    semantics): sum over probe rows of their key's build multiplicity.

    Returns a ``uint32[2]`` (hi, lo) pair — the cardinality can exceed
    2^31-1 with duplicated build keys (the reference accumulates into a C++
    64-bit counter), and the engine runs without x64.  Use
    ``utils.widesum.pair_to_int`` on host.
    """
    from partitionedhashjoin_tpu.utils import widesum

    is_probe, valid, mult = _merged_multiplicity(
        build_keys, probe_keys, build_valid, probe_valid
    )
    return widesum.exact_sum_u64(jnp.where(is_probe & valid, mult, 0))


@jax.jit
def sort_merge_materialize(
    build_keys: jax.Array,
    build_payloads: jax.Array,
    probe_keys: jax.Array,
    probe_payloads: jax.Array,
):
    """Materialized first-match join: (keys, payload_a, payload_b, count),
    compacted to the front in probe-row order.

    The matching build row for a probe row is the *latest* build row at or
    before it in sorted order (deterministic; the reference's ``Get`` picks
    an arbitrary chain-order first match, HashJoin.hpp:159-180).  Sorted
    positions ascend, so ``cummax(where(is_build, position, -1))`` is the
    last build position — the same one-scan trick as the count.
    """
    keys_out, pay_a, pay_b, _, count = _materialize_typed(
        build_keys, build_payloads, probe_keys, probe_payloads, "inner"
    )
    return keys_out, pay_a, pay_b, count


def _match_probe_rows(build_keys, probe_keys, build_payloads=None,
                      build_valid=None):
    """(hit, build_row[, pay_a]) per probe row: whether its key exists
    among build keys and, if so, the matching build row (latest in sorted
    order — deterministic; the reference's ``Get`` picks an arbitrary
    chain-order first match, HashJoin.hpp:159-180).

    ``build_valid`` masks build rows out of the match without moving them:
    an invalid build row is re-tagged as probe-like (it no longer feeds the
    forward fill) and its tiebreak row index is offset past every real
    probe row, so the placement slice can never pick it up.  Filters over
    the build relation therefore compose with the materializer as masks —
    no compaction pass, no sentinel keys (exact over the full int32/int64
    key domain).

    Movement-wise everything rides sorts and streaming scans: build
    row/payload propagate by an O(n)-work ``associative_scan`` forward-fill
    and return to probe-row order through one value-carrying sort.
    Passing ``build_payloads`` carries the matched payload through the same
    two sorts instead of a relation-sized gather.
    """
    n_a = build_keys.shape[0]
    n_b = probe_keys.shape[0]
    with_pay_early = build_payloads is not None
    if n_a == 0 or n_b == 0:
        hit = jnp.zeros((n_b,), jnp.bool_)
        row = jnp.zeros((n_b,), jnp.int32)
        if with_pay_early:
            # dtype must not flip on emptiness (round-3 review: an empty
            # partition's JoinedTable would not concatenate with its peers)
            pay_dt = jnp.asarray(build_payloads).dtype
            return hit, row, jnp.zeros((n_b,), pay_dt)
        return hit, row
    dtype = _key_dtype(build_keys, probe_keys)
    kmin = jnp.iinfo(dtype).min
    keys = jnp.concatenate(
        [jnp.asarray(build_keys, dtype), jnp.asarray(probe_keys, dtype)]
    )
    build_row_ids = jnp.arange(n_a, dtype=jnp.int32)
    if build_valid is None:
        build_flags = jnp.ones((n_a,), jnp.bool_)
    else:
        build_flags = jnp.asarray(build_valid, jnp.bool_)
        # invalid build rows act as probe-like spectators; row ids past n_b
        # keep the 3-key comparator deterministic AND keep them out of the
        # placement slice (real probe rows occupy exactly [0, n_b))
        build_row_ids = jnp.where(
            build_flags, build_row_ids, jnp.int32(n_b) + build_row_ids
        )
    is_build = jnp.concatenate(
        [build_flags, jnp.zeros((n_b,), jnp.bool_)]
    )
    orig_row = jnp.concatenate(
        [build_row_ids, jnp.arange(n_b, dtype=jnp.int32)]
    )
    with_pay = build_payloads is not None
    # num_keys=3 keeps full determinism without stability: within a key,
    # builds (tag False) precede probes, then ascending original row — so
    # "latest build position" is the highest-numbered build row of the key
    operands = (keys, ~is_build, orig_row)
    if with_pay:
        pay_col = jnp.concatenate(
            [
                jnp.asarray(build_payloads),
                jnp.zeros((n_b,), jnp.asarray(build_payloads).dtype),
            ]
        )
        keys_s, tag_s, row_s, pay_s = jax.lax.sort(
            operands + (pay_col,), num_keys=3, is_stable=False
        )
    else:
        keys_s, tag_s, row_s = jax.lax.sort(
            operands, num_keys=3, is_stable=False
        )
    is_build_s = ~tag_s
    last_build_key = jax.lax.cummax(jnp.where(is_build_s, keys_s, kmin))
    any_build = jax.lax.cummax(is_build_s.astype(jnp.int32)) > 0
    hit_s = (~is_build_s) & any_build & (last_build_key == keys_s)

    def _ffill(vals):
        # propagate the last build row's value forward: O(n) work, no
        # relation-sized gather
        return jax.lax.associative_scan(
            lambda a, b: (
                jnp.where(b[1], b[0], a[0]),
                jnp.logical_or(a[1], b[1]),
            ),
            (vals, is_build_s),
        )[0]

    build_row_s = _ffill(row_s)
    carried = [hit_s, build_row_s]
    if with_pay:
        carried.append(_ffill(pay_s))
    # back to probe-row order: one value-carrying sort on the original row
    # (builds keyed past every probe row), sliced to the probe prefix
    placement_key = jnp.where(~is_build_s, row_s, jnp.int32(n_b))
    placed = jax.lax.sort(
        (placement_key, hit_s.astype(jnp.int32)) + tuple(carried[1:]),
        num_keys=1,
        is_stable=False,
    )
    hit = placed[1][:n_b] > 0
    build_row = placed[2][:n_b]
    if with_pay:
        pay_a = jnp.where(hit, placed[3][:n_b], 0)
        return hit, build_row, pay_a
    return hit, build_row


@functools.partial(jax.jit, static_argnames=("join_type",))
def _materialize_typed(
    build_keys, build_payloads, probe_keys, probe_payloads, join_type: str,
    build_valid=None, probe_valid=None,
):
    """Materialized join, all probe-side variants of the reference's
    Get-semantics probe (HashJoin.hpp:144-180) plus the standard relational
    extensions the reference lacks:

    - ``inner``/``semi``: probe rows whose key matches, compacted front
      (first-match build payload; identical output — a semi join per probe
      row IS the first-match inner join here)
    - ``anti``: probe rows with NO match, compacted front (pay_a zeros)
    - ``left``: every probe row in place; ``matched`` marks rows whose
      pay_a is a real build payload (NULL indicator, zeros otherwise)
    - ``full``: the ``left`` block (all probe rows, in place) followed by
      the compacted UNMATCHED build rows (keys + pay_a from the build side,
      pay_b zero, matched False — their NULL side is the probe side); rows
      before ``n_probe`` are probe-side, after are build-only.  Output is
      ``n_probe + n_build`` rows static, ``count`` live.

    Returns (keys, pay_a, pay_b, matched, count); rows beyond ``count``
    are zero padding (static shapes — XLA compaction idiom).

    ``build_valid`` / ``probe_valid`` fold upstream FILTERS into the join
    as masks (the query layer's rule: filters never materialize an
    intermediate): an invalid build row can never be matched
    (``_match_probe_rows`` re-tags it), and an invalid probe row is
    excluded from every variant's output — for ``left``/``full`` the probe
    block is then compacted to the valid rows (the filtered relation IS
    the left side, so dropped rows simply do not exist in it).
    """
    if join_type not in ("inner", "semi", "anti", "left", "full"):
        raise ValueError(f"unknown join_type {join_type!r}")
    n_b = probe_keys.shape[0]
    hit, _, pay_matched = _match_probe_rows(
        build_keys, probe_keys, jnp.asarray(build_payloads),
        build_valid=build_valid,
    )
    pv = (
        None if probe_valid is None
        else jnp.asarray(probe_valid, jnp.bool_)
    )
    if pv is not None:
        hit = hit & pv
    from partitionedhashjoin_tpu.ops.filter import compact_sort

    if join_type == "left":
        if pv is None:
            return (
                jnp.asarray(probe_keys),
                pay_matched,
                jnp.asarray(probe_payloads),
                hit,
                jnp.asarray(n_b, jnp.int32),
            )
        count, keys_out, pay_a, pay_b, matched = compact_sort(
            pv,
            jnp.asarray(probe_keys),
            pay_matched,
            jnp.asarray(probe_payloads),
            hit.astype(jnp.int32),
        )
        live = jnp.arange(n_b, dtype=jnp.int32) < count
        return (
            jnp.where(live, keys_out, 0),
            jnp.where(live, pay_a, 0),
            jnp.where(live, pay_b, 0),
            jnp.where(live, matched > 0, False),
            count,
        )
    if join_type == "full":
        n_a = build_keys.shape[0]
        # reversed match: which BUILD rows found no (valid) probe partner
        # (duplicate unmatched build keys all appear — full-outer
        # multiplicity); probe_valid masks the reversed build side
        hit_b, _ = _match_probe_rows(
            probe_keys, build_keys, build_valid=pv
        )
        keep_b = ~hit_b
        if build_valid is not None:
            keep_b = keep_b & jnp.asarray(build_valid, jnp.bool_)
        if pv is None:
            count_b, k_b, p_b = compact_sort(
                keep_b, jnp.asarray(build_keys), jnp.asarray(build_payloads)
            )
            live_b = jnp.arange(n_a, dtype=jnp.int32) < count_b
            zero_b = jnp.zeros((n_a,), jnp.asarray(probe_payloads).dtype)
            return (
                jnp.concatenate(
                    [jnp.asarray(probe_keys), jnp.where(live_b, k_b, 0)]
                ),
                jnp.concatenate([pay_matched, jnp.where(live_b, p_b, 0)]),
                jnp.concatenate([jnp.asarray(probe_payloads), zero_b]),
                jnp.concatenate([hit, jnp.zeros((n_a,), jnp.bool_)]),
                jnp.asarray(n_b, jnp.int32) + count_b,
            )
        # filtered probe side: one combined stable compaction keeps the
        # [valid probe block, unmatched build block] contract with no gap
        keep_cat = jnp.concatenate([pv, keep_b])
        keys_cat = jnp.concatenate(
            [jnp.asarray(probe_keys), jnp.asarray(build_keys)]
        )
        pay_a_cat = jnp.concatenate([pay_matched, jnp.asarray(build_payloads)])
        pay_b_cat = jnp.concatenate(
            [
                jnp.asarray(probe_payloads),
                jnp.zeros((n_a,), jnp.asarray(probe_payloads).dtype),
            ]
        )
        matched_cat = jnp.concatenate([hit, jnp.zeros((n_a,), jnp.bool_)])
        count, keys_out, pay_a, pay_b, matched = compact_sort(
            keep_cat, keys_cat, pay_a_cat, pay_b_cat,
            matched_cat.astype(jnp.int32),
        )
        live = jnp.arange(n_a + n_b, dtype=jnp.int32) < count
        return (
            jnp.where(live, keys_out, 0),
            jnp.where(live, pay_a, 0),
            jnp.where(live, pay_b, 0),
            jnp.where(live, matched > 0, False),
            count,
        )
    if join_type == "anti":
        keep = ~hit if pv is None else (~hit & pv)
    else:
        keep = hit
    # stable compaction via one 2-key value-carrying sort, then an explicit
    # zero tail to keep the padded contract
    count, keys_out, pay_a, pay_b, matched = compact_sort(
        keep,
        jnp.asarray(probe_keys),
        pay_matched,
        jnp.asarray(probe_payloads),
        hit.astype(jnp.int32),
    )
    live = jnp.arange(n_b, dtype=jnp.int32) < count
    return (
        jnp.where(live, keys_out, 0),
        jnp.where(live, pay_a, 0),
        jnp.where(live, pay_b, 0),
        jnp.where(live, matched > 0, False),
        count,
    )


def sort_merge_materialize_typed(
    build_keys, build_payloads, probe_keys, probe_payloads,
    join_type: str = "inner",
    build_valid=None, probe_valid=None,
):
    """Public typed materializer — see ``_materialize_typed``."""
    return _materialize_typed(
        build_keys, build_payloads, probe_keys, probe_payloads, join_type,
        build_valid=build_valid, probe_valid=probe_valid,
    )


def anti_count(build_keys, probe_keys, build_valid=None, probe_valid=None):
    """Anti-join count: valid probe rows whose key does NOT appear among
    valid build keys (complement of the Get-semantics count)."""
    n_valid = (
        jnp.sum(jnp.asarray(probe_valid, jnp.bool_).astype(jnp.int32))
        if probe_valid is not None
        else jnp.asarray(jnp.asarray(probe_keys).shape[0], jnp.int32)
    )
    return n_valid - sort_merge_count(
        build_keys, probe_keys, build_valid, probe_valid
    )


class SortMergeJoiner:
    """Driver with the reference's ``run(table_a, table_b, timer)`` shape.

    The sort subsumes build+probe; it is attributed to the probe phase
    (build is a no-op), mirroring how the no-partitioning join reports no
    partition phase.
    """

    def __init__(self, seed: Optional[int] = None) -> None:
        # seed is unused (the sort is hash-free); kept for API symmetry
        self._logger = get_new_logger("SortMergeJoiner")

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        timer.set_build_phase_end()
        timer.set_probe_phase_begin()
        count = self.count(table_a.keys, table_b.keys)
        count = int(jax.device_get(count))
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

    @staticmethod
    def count(build_keys, probe_keys) -> jax.Array:
        """The flagship count: the two-run join (one sort per relation +
        a binary-search probe, ops/merge_join.py), int32 or int64 keys.
        It measured faster than the concatenated 2-key sort + cummax form
        above at 10M ⋈ 200M on the H100 (PERF.md, path decisions)."""
        from partitionedhashjoin_tpu.ops import merge_join

        if _key_dtype(build_keys, probe_keys) == jnp.int64:
            return merge_join.two_run_count_i64(build_keys, probe_keys)
        return merge_join.two_run_count(build_keys, probe_keys)

    def run_materialize(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
        join_type: str = "inner",
        order: str = "probe",
    ):
        """Engine extension: materialized join output.

        ``join_type`` selects the probe-side variant ("inner", "semi",
        "anti", "left" — see ``sort_merge_materialize_typed``); the
        reference materializes nothing, so all variants are extensions.

        ``order`` selects the output row order:
        - "probe" (default): probe-row order, latest-build-row match — the
          scan path (every join type and key dtype).
        - "key": sorted-key order, lowest-sorted-position match — the
          two-run path (merge_join.two_run_materialize; int32 keys, "inner"
          only), which skips the placement sort AND the compaction
          dispatch when every probe row matches.
        """
        from partitionedhashjoin_tpu.data.table import JoinedTable
        from partitionedhashjoin_tpu.ops import merge_join

        if order not in ("probe", "key"):
            raise ValueError(f"unknown order {order!r}")
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        timer.set_build_phase_end()
        timer.set_probe_phase_begin()
        if order == "key":
            if join_type != "inner":
                raise ValueError(
                    "order='key' (the two-run path) supports inner joins; "
                    "use order='probe' for semi/anti/left"
                )
            if _key_dtype(table_a.keys, table_b.keys) != jnp.int32:
                raise ValueError("order='key' needs int32 keys")
            keys, pay_a, pay_b, count = merge_join.two_run_materialize(
                table_a.keys, table_a.payloads,
                table_b.keys, table_b.payloads,
            )
            matched = None
        else:
            keys, pay_a, pay_b, matched, count = _materialize_typed(
                table_a.keys, table_a.payloads,
                table_b.keys, table_b.payloads, join_type,
            )
        count_host = int(jax.device_get(count))
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count_host)
        return JoinedTable(
            keys=keys,
            payloads_a=pay_a,
            payloads_b=pay_b,
            count=count,
            matched=matched,
        )
