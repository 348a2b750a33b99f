"""Hash aggregate: GROUP BY key with COUNT / SUM / MIN / MAX.

Part of the extended db_exec_kernel suite (BASELINE.json configs[3],
"Filter + hash-aggregate pipeline"); the reference has no aggregate operator.

Hash aggregation, no sort: the deduplicating claim loop
(ops/hash_table.py::build_dedup_hash_table) maps every row to a canonical
representative row of its key in O(distinct-collision-chain) rounds —
independent of duplication, so Zipf heads cost nothing extra.  Group ids are
densified with a flag + prefix sum, and all aggregates are conflict-free
scatter-adds/mins/maxes onto the group vector (integer scatter-adds are
exact in any order — the reference would have needed its latch/atomic
machinery here).

Output arrays have static capacity = number of input rows; ``num_groups``
bounds the valid prefix.  Group order is hash-table claim order (i.e.
arbitrary but deterministic given the seed), matching unordered GROUP BY
semantics.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.ops import hash_table as ht
from partitionedhashjoin_tpu.ops.filter import compact

_I32_MAX = jnp.iinfo(jnp.int32).max
_I32_MIN = jnp.iinfo(jnp.int32).min


def masked_mean(count, total, dtype=jnp.float32) -> jax.Array:
    """The engine's AVG convention (shared by GroupByResult and
    query.ScalarAggResult): sum/count where count > 0, else 0."""
    c = jnp.maximum(count, 1).astype(dtype)
    return jnp.where(
        count > 0, total.astype(dtype) / c, jnp.zeros((), dtype)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GroupByResult:
    """GROUP BY output: per-group key + aggregates, valid in [0, num_groups)."""

    keys: jax.Array  # int32[n] group keys
    count: jax.Array  # int32[n] COUNT(*)
    sum: jax.Array  # payload-dtype[n] SUM(payload)
    min: jax.Array  # payload-dtype[n] MIN(payload)
    max: jax.Array  # payload-dtype[n] MAX(payload)
    num_groups: jax.Array  # int32 scalar
    # int32[n] dense group id per input row for AGGREGATION results
    # (all -1 on paths that don't track membership).  SELECTION results
    # (query.group_top_k: order_by/limit/having over a group table)
    # carry an EMPTY (0-length) group_of_row instead: a k-sized
    # selection has no row mapping, and a relation-sized -1 array cost
    # 800 MB of dead HBM per result at 200M rows (round 5).
    group_of_row: jax.Array
    # COUNT(DISTINCT payload) per group; present only when the sort path
    # ran with ``with_distinct=True`` (payload is the 3rd sort key there, so
    # distinct values are run boundaries — free ordering the hash path lacks)
    distinct: "jax.Array | None" = None

    def mean(self, dtype=jnp.float32) -> jax.Array:
        """AVG(payload) per group: sum/count where count > 0, else 0."""
        return masked_mean(self.count, self.sum, dtype)


@functools.partial(jax.jit, static_argnames=("size", "has_valid"))
def _group_and_aggregate(
    keys: jax.Array,
    payloads: jax.Array,
    seed: jax.Array,
    size: int,
    valid: "jax.Array | None" = None,
    has_valid: bool = False,
) -> GroupByResult:
    n = keys.shape[0]
    _, rep_row = ht.build_dedup_hash_table(
        keys, seed, size, valid=valid, has_valid=has_valid
    )
    # densify representatives -> group ids 0..G-1 (stable in row order);
    # invalid rows keep rep_row == -1 and aggregate into the dump slot
    safe_rep = jnp.where(rep_row >= 0, rep_row, n)
    is_rep_flag = (
        jnp.zeros((n,), jnp.int32).at[safe_rep].max(1, mode="drop")
    )
    dense_of_row = jnp.cumsum(is_rep_flag) - is_rep_flag  # id at rep positions
    gid = jnp.where(
        rep_row >= 0, dense_of_row[jnp.maximum(rep_row, 0)], n
    )
    num_groups = jnp.sum(is_rep_flag)

    ones = jnp.ones((n,), jnp.int32)
    count = jnp.zeros((n,), jnp.int32).at[gid].add(ones, mode="drop")
    sum_ = jnp.zeros((n,), payloads.dtype).at[gid].add(payloads, mode="drop")
    # MIN/MAX keep the payload dtype like SUM does (an int32 cast would
    # silently truncate int64 payloads in min/max only — round-1 ADVICE)
    pinfo = (
        jnp.iinfo(payloads.dtype)
        if jnp.issubdtype(payloads.dtype, jnp.integer)
        else jnp.finfo(payloads.dtype)
    )
    min_ = jnp.full((n,), pinfo.max, payloads.dtype).at[gid].min(
        payloads, mode="drop"
    )
    max_ = jnp.full((n,), pinfo.min, payloads.dtype).at[gid].max(
        payloads, mode="drop"
    )
    group_keys = jnp.zeros((n,), keys.dtype).at[gid].set(keys, mode="drop")
    return GroupByResult(
        keys=group_keys,
        count=count,
        sum=sum_,
        min=min_,
        max=max_,
        num_groups=num_groups,
        group_of_row=jnp.where(gid < n, gid, -1),
    )


def hash_aggregate(table: Table, seed: int = 0) -> GroupByResult:
    """GROUP BY ``table.keys``, aggregating ``table.payloads``."""
    size = ht.table_size_for(table.size)
    seed_dev = jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32)
    return _group_and_aggregate(table.keys, table.payloads, seed_dev, size)


def filter_aggregate(table: Table, predicate, seed: int = 0) -> GroupByResult:
    """Filter → hash-aggregate pipeline (BASELINE.json configs[3]:
    "Filter + hash-aggregate pipeline on generated key/value tables").

    Rows failing ``predicate(keys, payloads)`` are excluded via the dedup
    table's validity mechanism (they are never inserted, keep ``rep_row ==
    -1``, and aggregate into a dropped dump slot) — no materialized
    intermediate table, so XLA fuses the mask directly into the group-by
    scatters.

    Returns ``(GroupByResult of the selected rows, selected_row_count)``;
    ``group_of_row`` is -1 for filtered-out rows.
    """
    mask = predicate(table.keys, table.payloads)
    g = _group_and_aggregate(
        table.keys,
        table.payloads,
        jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32),
        ht.table_size_for(table.size),
        valid=mask,
        has_valid=True,
    )
    return g, jnp.sum(mask.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Sort-based aggregate: the at-scale GROUP BY path.
#
# The hash path above pays ~5 relation-sized scatters plus the dedup claim
# loop.  A (valid, key, payload) sort makes every group a contiguous run with
# its MIN payload first and MAX last, so all four aggregates fall out of ONE
# sort + prefix scans:
#
#   starts S_g  : boundary-flag compaction (pass 2) — either a scatter to
#                 exclusive-prefix positions or a second unstable 2-key sort
#                 on (not-start, position); both carry key/min/cumsum/max
#                 columns along, so NO group-indexed gathers remain
#   count       : S_{g+1} - S_g  (slice-shift of the compacted prefix)
#   sum         : exclusive-cumsum difference csx[S_{g+1}] - csx[S_g].
#                 int32 cumsum wraps mod 2^32 exactly like the hash path's
#                 scatter-add accumulation (addition mod 2^32 is
#                 associative), so the two paths return bit-identical sums
#                 even for overflowing heavy groups.
#   min / max   : payload at S_g / S_{g+1}-1 (payload is the 3rd sort key)
#   group keys  : key at S_g
#
# Group order is key-ascending (vs the hash path's claim order) — both are
# valid unordered-GROUP-BY orders; tests compare as key→aggregate maps.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=(
        "group_capacity", "has_valid", "with_group_of_row",
        "scatter_compaction", "with_distinct", "presorted",
    ),
)
def _sort_group_and_aggregate(
    keys: jax.Array,
    payloads: jax.Array,
    group_capacity: int,
    valid: "jax.Array | None" = None,
    has_valid: bool = False,
    with_group_of_row: bool = False,
    scatter_compaction: bool = False,
    with_distinct: bool = False,
    presorted: bool = False,
) -> GroupByResult:
    n = keys.shape[0]
    if n == 0:
        gz = jnp.zeros((group_capacity,), jnp.int32)
        pz = jnp.zeros((group_capacity,), payloads.dtype)
        return GroupByResult(
            keys=gz, count=gz, sum=pz, min=pz, max=pz,
            num_groups=jnp.asarray(0, jnp.int32),
            group_of_row=jnp.full((n,), -1, jnp.int32),
            distinct=gz if with_distinct else None,
        )
    if group_capacity == 0:
        # num_groups stays EXACT (the capacity-overflow retry contract —
        # round-2 review: returning 0 here made 'num_groups <= capacity'
        # read as complete): count distinct valid keys, return no groups.
        inv = (
            jnp.where(valid, 0, 1).astype(jnp.int32)
            if has_valid
            else jnp.zeros((n,), jnp.int32)
        )
        inv_s, key_s = jax.lax.sort((inv, keys), num_keys=2, is_stable=False)
        valid_s = inv_s == 0
        prev_key = jnp.concatenate([key_s[:1], key_s[:-1]])
        is_start = valid_s & (
            (jnp.arange(n, dtype=jnp.int32) == 0) | (key_s != prev_key)
        )
        gz = jnp.zeros((0,), jnp.int32)
        pz = jnp.zeros((0,), payloads.dtype)
        return GroupByResult(
            keys=gz, count=gz, sum=pz, min=pz, max=pz,
            num_groups=jnp.sum(is_start.astype(jnp.int32)),
            group_of_row=jnp.full((n,), -1, jnp.int32),
            distinct=gz if with_distinct else None,
        )
    inv = (
        jnp.where(valid, 0, 1).astype(jnp.int32)
        if has_valid
        else jnp.zeros((n,), jnp.int32)
    )
    iota = jnp.arange(n, dtype=jnp.int32)
    # pass 1: one unstable multi-key sort carrying the extra operands.
    # Invalid rows sort to the back, so the valid prefix is contiguous.
    ops = (inv, keys, payloads) + ((iota,) if with_group_of_row else ())
    if presorted:
        # caller asserts the input is ALREADY (inv, key, payload)-ordered:
        # valid rows a prefix, keys ascending within it, payloads ascending
        # within each key run (aggregate_sorted's payload_sorted contract —
        # the materialized join emits exactly this order).  Every
        # downstream invariant (min at run start, max at run end, distinct
        # pair boundaries) then holds without the relation sort.
        sorted_ops = ops
    else:
        sorted_ops = jax.lax.sort(ops, num_keys=3, is_stable=False)
    inv_s, key_s, pay_s = sorted_ops[:3]
    valid_s = inv_s == 0
    n_valid = jnp.sum(valid_s.astype(jnp.int32))

    prev_key = jnp.concatenate([key_s[:1], key_s[:-1]])
    is_start = valid_s & ((iota == 0) | (key_s != prev_key))
    num_groups = jnp.sum(is_start.astype(jnp.int32))

    # pass 2: compact the start rows and CARRY every per-group value along
    # (no group-indexed gathers); every group aggregate below falls out of
    # slice-shifts of the compacted prefix:
    #   key_g   = key at the start row
    #   min_g   = payload at the start row (payload is the 3rd sort key, so
    #             runs are payload-ascending)
    #   sum_g   = csx[s_{g+1}] - csx[s_g] with csx the EXCLUSIVE payload
    #             cumsum (last group closes with the total valid sum)
    #   max_g   = payload at s_{g+1}-1 = maxprev carried at start row g+1
    #             (last group: payload at the last valid row)
    # dtype= pins the accumulator: reductions otherwise promote int32 to
    # int64 under x64, which would break the documented mod-2^32 sum parity
    # with the hash path for overflowing heavy groups
    cs = jnp.cumsum(pay_s, dtype=payloads.dtype)
    csx = cs - pay_s.astype(payloads.dtype)
    maxprev = jnp.concatenate([pay_s[:1], pay_s[:-1]])
    if with_distinct:
        # payload is the 3rd sort key, so each group's payloads ascend and
        # COUNT(DISTINCT payload) = number of (group, payload) run starts.
        # Same exclusive-cumsum-at-boundary trick as SUM: one extra int32
        # column rides pass 2.
        pair_start = (
            valid_s & (is_start | (pay_s != maxprev))
        ).astype(jnp.int32)
        cpx_d = jnp.cumsum(pair_start) - pair_start
        total_pairs = jnp.sum(pair_start)
    else:
        cpx_d = None
    carried = [iota, key_s, pay_s, csx, maxprev]
    if with_distinct:
        carried.append(cpx_d)
    s_full, gkey, gmin, gcsx, gmaxp, *rest = _compact_starts(
        is_start, carried, group_capacity, scatter_compaction
    )
    gcpxd = rest[0] if with_distinct else None

    cap = group_capacity
    g = jnp.arange(cap, dtype=jnp.int32)
    g_ok = g < num_groups
    has_next = g + 1 < num_groups
    zero_p = jnp.zeros((), payloads.dtype)
    zero1 = jnp.zeros((1,), jnp.int32)
    zero1_p = jnp.zeros((1,), payloads.dtype)

    def shift(col, pad):
        return jnp.concatenate([col[1:cap + 1], pad])[:cap]

    s_g = jnp.where(g_ok, s_full[:cap], 0)
    e_excl = jnp.where(has_next, shift(s_full, zero1), n_valid)
    count = jnp.where(g_ok, e_excl - s_g, 0)

    total_valid = jnp.sum(
        jnp.where(valid_s, pay_s, 0), dtype=payloads.dtype
    )
    sum_hi = jnp.where(has_next, shift(gcsx, zero1_p), total_valid)
    sum_ = jnp.where(g_ok, sum_hi - gcsx[:cap], zero_p)

    last_valid_pay = pay_s[jnp.maximum(n_valid - 1, 0)]
    max_ = jnp.where(
        g_ok,
        jnp.where(has_next, shift(gmaxp, zero1_p), last_valid_pay),
        zero_p,
    )
    if with_distinct:
        d_hi = jnp.where(has_next, shift(gcpxd, zero1), total_pairs)
        distinct = jnp.where(g_ok, d_hi - gcpxd[:cap], 0)
    else:
        distinct = None
    res = GroupByResult(
        keys=jnp.where(g_ok, gkey[:cap], 0),
        count=count,
        sum=sum_,
        min=jnp.where(g_ok, gmin[:cap], zero_p),
        max=max_,
        num_groups=num_groups,
        group_of_row=jnp.full((n,), -1, jnp.int32),
        distinct=distinct,
    )
    if with_group_of_row:
        # dense id of each SORTED row, scattered back to input positions
        row_iota_s = sorted_ops[3]
        gid_s = jnp.cumsum(is_start.astype(jnp.int32)) - 1
        gid_s = jnp.where(valid_s, gid_s, -1)
        res = dataclasses.replace(
            res,
            group_of_row=jnp.zeros((n,), jnp.int32).at[row_iota_s].set(gid_s),
        )
    return res


def _compact_starts(is_start, carried, group_capacity: int, scatter: bool):
    """Pass 2: the carried columns at group-start rows, compacted to the
    front in row order (at least ``group_capacity + 1`` rows; the tail past
    the last start is unread).  ``scatter``: one scatter to exclusive-prefix
    positions, bounded by the capacity; otherwise one unstable 2-key sort on
    (not-start, position) carrying every column."""
    if scatter:
        return list(
            compact(is_start, *carried, capacity=group_capacity + 1)[1:]
        )
    flag = jnp.where(is_start, 0, 1).astype(jnp.int32)
    return list(
        jax.lax.sort(
            (flag,) + tuple(carried), num_keys=2, is_stable=False
        )[1:]
    )


_SEG_L = 8192  # intra-block scan length for the two-level segmented scan


def _seg_comb(op):
    """Segmented-scan operator: flag marks a segment START toward the scan
    direction.  Associative by the standard (value, flag) construction."""

    def comb(a, b):
        va, fa = a
        vb, fb = b
        return jnp.where(fb, vb, op(va, vb)), fa | fb

    return comb


def _seg_suffix_scan(vals, is_end, op):
    """Segmented SUFFIX scan: out[i] = op-fold of vals[i..j] where j is the
    first position >= i with ``is_end[j]`` (out[i] = vals[i] when is_end[i]).

    TWO-LEVEL formulation: a single flat ``associative_scan`` over a
    relation-sized array emits log2(n) ≈ 28 levels of relation-sized
    slice/concat HLO, whose program at 200M rows exhausted a compile
    helper's memory.  Reshaping to (B, 8192) caps level count at 13
    relation-sized levels plus a B-sized block-summary scan and one
    broadcast fix-up.
    Works in reversed orientation (suffix = prefix of the flipped array,
    where ``is_end`` becomes the segment-start flag)."""
    n = vals.shape[0]
    comb = _seg_comb(op)
    if n <= _SEG_L:
        out, _ = jax.lax.associative_scan(comb, (vals, is_end), reverse=True)
        return out
    pad = (-n) % _SEG_L
    r_vals = vals[::-1]
    r_flag = is_end[::-1]
    if pad:
        # pad values are op-identity-free: they carry flag False and sit
        # PAST every real row in reversed orientation, so they only ever
        # appear as the left operand of real rows' combines — where a
        # flagged first real element resets anyway.  The LAST real row of
        # the original array is is_end (or invalid/unread), so no real
        # suffix extends into the pad.
        r_vals = jnp.concatenate([r_vals, jnp.zeros((pad,), vals.dtype)])
        r_flag = jnp.concatenate([r_flag, jnp.zeros((pad,), jnp.bool_)])
    B = r_vals.shape[0] // _SEG_L
    V = r_vals.reshape(B, _SEG_L)
    F = r_flag.reshape(B, _SEG_L)
    # level 1: segmented prefix scan within each block (13 levels)
    sv, sf = jax.lax.associative_scan(comb, (V, F), axis=1)
    # level 2: carry flowing INTO each block = inclusive segmented scan of
    # the block summaries (last element of each block's level-1 scan),
    # shifted by one.  For every b > 0 the incoming piece is nonempty (the
    # segment containing block b-1's last element), so only b=0 lacks one.
    csv, _ = jax.lax.associative_scan(comb, (sv[:, -1], sf[:, -1]))
    carry_v = jnp.concatenate([csv[:1], csv[:-1]])  # value is unread for b=0
    no_carry = (
        jnp.arange(B, dtype=jnp.int32) == 0
    )
    # fix-up: rows with no flag at-or-before them in their block (sf False)
    # continue the incoming segment and absorb the carry
    fixed = jnp.where(
        sf | no_carry[:, None], sv, op(carry_v[:, None], sv)
    )
    out = fixed.reshape(-1)[:n]
    return out[::-1]


@functools.partial(
    jax.jit,
    static_argnames=(
        "group_capacity", "has_nvalid", "scatter_compaction",
    ),
)
def _aggregate_sorted_impl(
    keys: jax.Array,
    payloads: jax.Array,
    group_capacity: int,
    n_valid_in=None,
    has_nvalid: bool = False,
    scatter_compaction: bool = False,
) -> GroupByResult:
    n = keys.shape[0]
    if n == 0:
        gz = jnp.zeros((group_capacity,), jnp.int32)
        pz = jnp.zeros((group_capacity,), payloads.dtype)
        return GroupByResult(
            keys=gz, count=gz, sum=pz, min=pz, max=pz,
            num_groups=jnp.asarray(0, jnp.int32),
            group_of_row=jnp.full((n,), -1, jnp.int32),
        )
    iota = jnp.arange(n, dtype=jnp.int32)
    if has_nvalid:
        n_valid = jnp.asarray(n_valid_in, jnp.int32)
        valid_s = iota < n_valid
    else:
        n_valid = jnp.asarray(n, jnp.int32)
        valid_s = jnp.ones((n,), jnp.bool_)
    key_s, pay_s = keys, payloads
    prev_key = jnp.concatenate([key_s[:1], key_s[:-1]])
    is_start = valid_s & ((iota == 0) | (key_s != prev_key))
    num_groups = jnp.sum(is_start.astype(jnp.int32))
    if group_capacity == 0:
        gz = jnp.zeros((0,), jnp.int32)
        pz = jnp.zeros((0,), payloads.dtype)
        return GroupByResult(
            keys=gz, count=gz, sum=pz, min=pz, max=pz,
            num_groups=num_groups,
            group_of_row=jnp.full((n,), -1, jnp.int32),
        )

    cs = jnp.cumsum(pay_s, dtype=payloads.dtype)
    csx = cs - pay_s.astype(payloads.dtype)

    # MIN/MAX without payload ordering (the sort path gets them free from
    # payload-as-3rd-key; here payloads within a group are arbitrary):
    # segmented SUFFIX scans — at a group's start row, the suffix aggregate
    # bounded by the group end IS the full-group aggregate, and start rows
    # are exactly what pass 2 compacts.  The invalid tail never reaches a
    # start row (valid rows are a prefix), so its scan content is unread.
    nxt_key = jnp.concatenate([key_s[1:], key_s[-1:]])
    nxt_valid = jnp.concatenate([valid_s[1:], jnp.zeros((1,), jnp.bool_)])
    is_end = valid_s & (~nxt_valid | (nxt_key != key_s))

    seg_min = _seg_suffix_scan(pay_s, is_end, jnp.minimum)
    seg_max = _seg_suffix_scan(pay_s, is_end, jnp.maximum)

    s_full, gkey, gmin, gcsx, gmax = _compact_starts(
        is_start, [iota, key_s, seg_min, csx, seg_max], group_capacity,
        scatter_compaction,
    )

    cap = group_capacity
    g = jnp.arange(cap, dtype=jnp.int32)
    g_ok = g < num_groups
    has_next = g + 1 < num_groups
    zero_p = jnp.zeros((), payloads.dtype)
    zero1 = jnp.zeros((1,), jnp.int32)
    zero1_p = jnp.zeros((1,), payloads.dtype)

    def shift(col, pad_v):
        return jnp.concatenate([col[1:cap + 1], pad_v])[:cap]

    s_g = jnp.where(g_ok, s_full[:cap], 0)
    e_excl = jnp.where(has_next, shift(s_full, zero1), n_valid)
    count = jnp.where(g_ok, e_excl - s_g, 0)
    total_valid = jnp.sum(
        jnp.where(valid_s, pay_s, 0), dtype=payloads.dtype
    )
    sum_hi = jnp.where(has_next, shift(gcsx, zero1_p), total_valid)
    return GroupByResult(
        keys=jnp.where(g_ok, gkey[:cap], 0),
        count=count,
        sum=jnp.where(g_ok, sum_hi - gcsx[:cap], zero_p),
        min=jnp.where(g_ok, gmin[:cap], zero_p),
        max=jnp.where(g_ok, gmax[:cap], zero_p),
        num_groups=num_groups,
        group_of_row=jnp.full((n,), -1, jnp.int32),
    )


def aggregate_sorted(
    table: Table,
    group_capacity: "int | None" = None,
    n_valid=None,
    compaction: str = "auto",
    check: bool = False,
    payload_sorted: bool = False,
    with_distinct: bool = False,
) -> GroupByResult:
    """Order-propagating GROUP BY: aggregate a table whose keys are ALREADY
    ascending, skipping the pass-1 relation sort entirely (the dominant
    cost of ``sort_aggregate``).

    This is the engine's interesting-order rule: the materialized join
    (``merge_join.two_run_materialize``) emits its output in sorted-key
    order, so a join → GROUP BY query feeds it here and never pays a
    second relation-sized reorder.  Two variants:

    - ``payload_sorted=True`` (the at-scale route): payloads also ascend
      within each key run (``two_run_materialize(probe_payload_sorted=
      True)`` provides this as a second sort key).  MIN/MAX/COUNT DISTINCT fall
      out of run boundaries exactly as in ``sort_aggregate``'s post-sort
      logic, which this reuses verbatim with the sort skipped
      (``presorted=True``) — no scans, full feature set.
    - default: payloads within a run are arbitrary; MIN/MAX come from a
      two-level segmented suffix scan (``_seg_suffix_scan``).  COUNT
      DISTINCT is refused (it needs payload-ordered runs).  Prefer
      ``payload_sorted`` when the producer can provide the order.

    COUNT/SUM use the boundary-cumsum scheme either way.  ``n_valid``:
    number of leading valid rows (rows past it are ignored — the
    materializer's compacted zero tail, for instance).  Keys must ascend
    over ``[0, n_valid)`` (and payload runs too, under
    ``payload_sorted``); ``check=True`` verifies that with one cheap
    fused reduce + readback and raises on violation (unchecked calls with
    unsorted input return garbage, like any presorted contract).  Returns
    the usual capacity-truncated ``GroupByResult`` with exact
    ``num_groups``.
    """
    n = table.size
    if check and n:
        k = table.keys
        asc = k[1:] >= k[:-1]
        if payload_sorted:
            p = table.payloads
            asc = (k[1:] > k[:-1]) | (
                (k[1:] == k[:-1]) & (p[1:] >= p[:-1])
            )
        if n_valid is not None:
            lim = jnp.asarray(n_valid, jnp.int32)
            ok_arr = (jnp.arange(n - 1, dtype=jnp.int32) + 1 >= lim) | asc
        else:
            ok_arr = asc
        if not bool(jax.device_get(jnp.all(ok_arr))):
            raise ValueError(
                "aggregate_sorted: keys (or payload runs, with "
                "payload_sorted) are not ascending over the valid prefix"
            )
    cap = n if group_capacity is None else min(group_capacity, n)
    if payload_sorted:
        # payloads ascend within each key run (the materializer's
        # probe_payload_sorted=True output): min/max/distinct come from the
        # run boundaries exactly as in the sort path, so this rides
        # _sort_group_and_aggregate with the pass-1 sort skipped — no
        # segmented scans.
        valid = None
        if n_valid is not None:
            valid = jnp.arange(n, dtype=jnp.int32) < jnp.asarray(
                n_valid, jnp.int32
            )
        return _sort_group_and_aggregate(
            table.keys,
            table.payloads,
            cap,
            valid=valid,
            has_valid=valid is not None,
            scatter_compaction=_scatter_compaction(compaction),
            with_distinct=with_distinct,
            presorted=True,
        )
    if with_distinct:
        raise ValueError(
            "with_distinct needs payload-ordered runs: pass "
            "payload_sorted=True (or use sort_aggregate)"
        )
    return _aggregate_sorted_impl(
        table.keys,
        table.payloads,
        cap,
        n_valid_in=n_valid,
        has_nvalid=n_valid is not None,
        scatter_compaction=_scatter_compaction(compaction),
    )


#: Pass-2 compaction that ``compaction="auto"`` resolves to: the faster of
#: the two on the H100 (PERF.md, path decisions).
AUTO_COMPACTION = "scatter"


def _scatter_compaction(compaction: str) -> bool:
    """Resolve the pass-2 compaction strategy: "scatter", "sort", or
    "auto" (``AUTO_COMPACTION``).  Both are exact for every column dtype."""
    if compaction == "auto":
        compaction = AUTO_COMPACTION
    if compaction not in ("sort", "scatter"):
        raise ValueError(f"unknown compaction {compaction!r}")
    return compaction == "scatter"


def sort_aggregate(
    table: Table,
    group_capacity: "int | None" = None,
    with_group_of_row: bool = False,
    compaction: str = "auto",
    with_distinct: bool = False,
) -> GroupByResult:
    """GROUP BY via one multi-key sort — the at-scale aggregate path.

    ``group_capacity`` bounds the group-indexed outputs (default: table
    size).  Exactness contract: ``num_groups`` is always exact; if it
    exceeds ``group_capacity`` the per-group arrays are truncated and the
    caller must retry with a larger capacity (the static-capacity +
    overflow-counter protocol used across the engine).

    ``compaction`` selects the pass-2 strategy (see
    ``_scatter_compaction``).
    """
    cap = table.size if group_capacity is None else min(group_capacity, table.size)
    return _sort_group_and_aggregate(
        table.keys,
        table.payloads,
        cap,
        with_group_of_row=with_group_of_row,
        scatter_compaction=_scatter_compaction(compaction),
        with_distinct=with_distinct,
    )


@functools.partial(
    jax.jit, static_argnames=("n_orig", "size", "group_capacity",
                              "scatter_compaction", "with_distinct"),
)
def _staged_pass2(
    total, keys_c, pay_c, n_orig: int, size: int, group_capacity: int,
    scatter_compaction: bool, with_distinct: bool = False,
):
    """Dispatch 2 of the staged filter→GROUP BY: aggregate the bucketed
    static slice ``[0, size)`` of the front-compacted columns, whose first
    ``total`` rows are the survivors."""
    valid = jnp.arange(size, dtype=jnp.int32) < total
    g = _sort_group_and_aggregate(
        jax.lax.slice_in_dim(keys_c, 0, size),
        jax.lax.slice_in_dim(pay_c, 0, size),
        group_capacity,
        valid=valid,
        has_valid=True,
        scatter_compaction=scatter_compaction,
        with_distinct=with_distinct,
    )
    # group_of_row keeps its documented [n_orig] shape (all -1: the staged
    # path drops row→group tracking; see filter_sort_aggregate_staged)
    g = dataclasses.replace(
        g, group_of_row=jnp.full((n_orig,), -1, jnp.int32)
    )
    return g, jnp.sum(valid.astype(jnp.int32))


def staged_slice_size(n: int, total: int, granularity: int = 16) -> int:
    """Static length covering ``total`` survivors of ``n`` rows, in buckets
    of ~n/granularity rows, so at most ``granularity`` program shapes ever
    compile (the dispatch-level dynamic-shape idiom used across the
    engine)."""
    chunk = max(1, -(-n // max(granularity, 1)))
    return min(max(-(-total // chunk) * chunk, 1), n)


def filter_sort_aggregate_staged(
    table: Table,
    predicate,
    group_capacity: "int | None" = None,
    compaction: str = "auto",
    slice_granularity: int = 16,
    with_distinct: bool = False,
):
    """Filter → GROUP BY as TWO dispatches so the relation-sized sort only
    touches the rows that survive the filter.

    The fused path (``filter_sort_aggregate``) folds the predicate into the
    pass-1 sort as a leading key, so filtered-out rows still cost full sort
    work.  This variant spends one streaming compaction (prefix sum +
    scatter, ``ops.filter.compact``) to shrink the data FIRST, reads back
    the survivor count, and dispatches the aggregate over the smallest
    bucketed static slice that covers it (``staged_slice_size``).
    Exactness: identical GroupByResult aggregates.

    int32 columns only — callers with wider columns use the fused path.
    ``group_of_row`` is not tracked (returned all -1); use the fused path
    when row→group ids are needed.  Returns ``(GroupByResult,
    selected_row_count)``.
    """
    if table.keys.dtype != jnp.int32 or table.payloads.dtype != jnp.int32:
        raise TypeError(
            "staged filter aggregate is int32-only (keys "
            f"{table.keys.dtype}, payloads {table.payloads.dtype}); "
            "use filter_sort_aggregate for wider columns"
        )
    n = table.size
    mask = jnp.asarray(predicate(table.keys, table.payloads), jnp.bool_)
    total, keys_c, pay_c = compact(mask, table.keys, table.payloads)
    total = int(jax.device_get(total))
    size = staged_slice_size(n, total, slice_granularity)
    cap = n if group_capacity is None else min(group_capacity, n)
    cap = min(cap, size)
    return _staged_pass2(
        total, keys_c, pay_c, n, size, cap,
        scatter_compaction=_scatter_compaction(compaction),
        with_distinct=with_distinct,
    )


def filter_sort_aggregate(
    table: Table,
    predicate,
    group_capacity: "int | None" = None,
    with_group_of_row: bool = False,
    compaction: str = "auto",
    with_distinct: bool = False,
):
    """Filter → sort-aggregate pipeline (BASELINE.json configs[3] at scale).

    The predicate mask becomes the leading sort key, so filtering fuses
    into the same sort — no materialized intermediate, like
    ``filter_aggregate``.  Returns ``(GroupByResult, selected_row_count)``.
    """
    mask = predicate(table.keys, table.payloads)
    cap = table.size if group_capacity is None else min(group_capacity, table.size)
    g = _sort_group_and_aggregate(
        table.keys,
        table.payloads,
        cap,
        valid=mask,
        has_valid=True,
        with_group_of_row=with_group_of_row,
        scatter_compaction=_scatter_compaction(compaction),
        with_distinct=with_distinct,
    )
    return g, jnp.sum(mask.astype(jnp.int32))
