"""Declarative query plans over the engine's operators.

The reference hard-wires exactly one pipeline into its driver — generate →
join → count (src/main.cpp:210-293); every operator composition is a code
change.  This module is the engine extension that turns the operator set
into a composable query engine: logical plans built with a fluent API, a
rule-based physical planner, EXPLAIN output, and execution on one device
or a device mesh.

    from partitionedhashjoin_tpu.query import scan

    q = (scan(orders)                       # Table (probe side)
         .filter(lambda k, p: p % 2 == 0)
         .join(scan(customers))             # build side subplan
         .group_by()                        # COUNT/SUM/MIN/MAX per key
         .order_by("count", descending=True)
         .limit(10))
    print(q.explain())
    top = q.execute()                       # GroupByResult, 10 rows

Physical rewrite rules:

  R1  count-only queries never materialize: ``.count()`` on a join plan
      routes to the count joins with filters as validity masks.
  R2  filters never materialize an intermediate: predicates become
      validity masks that ride the downstream sorts (typed-materializer
      ``build_valid``/``probe_valid``, count-join masks, aggregate
      validity).  Only a standalone trailing filter pays a compaction.
  R3  interesting-order propagation: JOIN → GROUP BY asks the two-run
      materializer for (key, payload)-ordered runs and aggregates with
      the relation sort skipped (``aggregate_sorted``).
  R4  GROUP BY → ORDER BY … LIMIT k rides ``lax.top_k`` over the group
      columns — no relation-sized sort for small k.
  R5  filter → GROUP BY stages a scatter compaction first so the
      aggregate's sort touches only surviving rows
      (``filter_sort_aggregate_staged``).
  R6  the same logical plan executes on a ``jax.sharding.Mesh``: GROUP BY
      maps to the combiner-plan distributed aggregate (with_distinct to
      the row-exchange plan), count joins to the shuffle join,
      materializing joins (inner/semi/anti/left) to the distributed
      materializer, ORDER BY … LIMIT to the (mask-aware) distributed
      top-k, and JOIN → GROUP BY to the one-shuffle join-aggregate (the
      join exchange co-partitions the groups;
      parallel/join_aggregate.py).  Filters push into the exchange
      bucketizer everywhere — invalid rows never travel.
  R7  filtered JOIN → GROUP BY composes R5 with R3: compact the filtered
      probe, re-key invalid rows to opposite sentinels (probe INT32_MAX,
      build INT32_MIN — they can never match), and run the two-run
      pipeline on the survivors; int32-extreme inputs fall back to the
      typed path at runtime.

Everything here is host-side planning; all device work happens inside the
operator modules this planner dispatches to.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import JoinedTable, Table, make_table

Predicate = Callable[[jax.Array, jax.Array], jax.Array]

_JOIN_TYPES = ("inner", "semi", "anti", "left", "full")


class PlanError(ValueError):
    """Unsupported logical-plan shape (raised at build or plan time)."""


# ---------------------------------------------------------------------------
# logical nodes


@dataclasses.dataclass(frozen=True)
class _Scan:
    table: Table


@dataclasses.dataclass(frozen=True)
class _Filter:
    child: object
    predicate: Predicate


@dataclasses.dataclass(frozen=True)
class _Join:
    probe: object
    build: object
    join_type: str
    carry: str  # which payload column downstream table ops keep


@dataclasses.dataclass(frozen=True)
class _GroupBy:
    child: object
    with_distinct: bool
    group_capacity: Optional[int]


@dataclasses.dataclass(frozen=True)
class _Having:
    child: object  # a group-stage node
    predicate: Callable  # GroupByResult -> bool mask over its rows


@dataclasses.dataclass(frozen=True)
class _OrderBy:
    child: object
    by: str
    descending: bool


@dataclasses.dataclass(frozen=True)
class _Limit:
    child: object
    k: int


def _stage(node) -> str:
    """"table" (rows flow) or "group" (aggregates flow)."""
    if isinstance(node, (_Scan, _Filter, _Join)):
        return "table"
    if isinstance(node, _GroupBy):
        return "group"
    return _stage(node.child)


# ---------------------------------------------------------------------------
# runtime intermediates

_GROUP_ORDER_COLS = ("key", "count", "sum", "min", "max", "distinct")


@dataclasses.dataclass
class _T:
    """Table-stage value: parallel columns + an optional validity mask.

    ``mask is None`` means every row is valid.  ``prefix_count`` is set
    when the valid rows are a compacted prefix (mask == arange < count)."""

    keys: jax.Array
    pays: jax.Array
    mask: Optional[jax.Array] = None
    prefix_count: Optional[jax.Array] = None
    joined: Optional[JoinedTable] = None  # set by a materializing join

    def count(self) -> jax.Array:
        if self.prefix_count is not None:
            return self.prefix_count
        if self.mask is None:
            return jnp.asarray(self.keys.shape[0], jnp.int32)
        return jnp.sum(self.mask.astype(jnp.int32))

    def effective_mask(self) -> Optional[jax.Array]:
        """Validity as one mask, folding ``prefix_count`` in (None = all
        rows valid).  Every consumer of a side's validity (filters, join
        build/probe masks, aggregates) must use THIS, not ``.mask``: a
        materialized join's output carries its validity only as
        ``prefix_count``, and reading ``.mask`` alone would turn its
        zero-padding tail into real rows."""
        m = self.mask
        if self.prefix_count is not None:
            pm = (
                jnp.arange(self.keys.shape[0], dtype=jnp.int32)
                < self.prefix_count
            )
            m = pm if m is None else (m & pm)
        return m


@dataclasses.dataclass
class TableResult:
    """A table-stage query result: rows ``[0, count)`` of ``table`` are
    valid (static-capacity compaction idiom used across the engine)."""

    table: Table
    count: jax.Array


@dataclasses.dataclass
class ScalarAggResult:
    """Whole-relation aggregates (no GROUP BY), one result row.
    ``min``/``max`` are 0 when ``count`` is 0 (the engine's masked-row
    convention); ``distinct`` is None unless requested."""

    count: jax.Array
    sum: jax.Array
    min: jax.Array
    max: jax.Array
    distinct: "jax.Array | None" = None

    def mean(self, dtype=jnp.float32) -> jax.Array:
        from partitionedhashjoin_tpu.ops.aggregate import masked_mean

        return masked_mean(self.count, self.sum, dtype)


# ---------------------------------------------------------------------------
# fluent builder


class Query:
    """Immutable logical plan; every method returns a new Query."""

    def __init__(self, node) -> None:
        self._node = node

    # -- builders ----------------------------------------------------------

    def filter(self, predicate: Predicate) -> "Query":
        """Keep rows where ``predicate(keys, payloads)`` holds (stage R2:
        becomes a validity mask, not a materialized intermediate)."""
        if _stage(self._node) != "table" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError(
                "filter applies to a table stage before order_by/limit"
            )
        return Query(_Filter(self._node, predicate))

    def join(
        self, build: "Query", join_type: str = "inner", carry: str = "probe"
    ) -> "Query":
        """Join this plan (the PROBE/large side) against ``build`` on key.

        ``join_type`` ∈ {inner, semi, anti, left, full} — the typed
        materializer's semantics (ops/sort_merge.py); inner is first-match
        (Get semantics, the reference's probe, HashJoin.hpp:144-157).
        ``carry`` picks which payload column ("probe" or "build")
        downstream table-stage operators and GROUP BY aggregate over;
        a bare ``.join().execute()`` returns all three columns.
        """
        if join_type not in _JOIN_TYPES:
            raise PlanError(f"unknown join_type {join_type!r}")
        if carry not in ("probe", "build"):
            raise PlanError(f"carry must be 'probe' or 'build', not {carry!r}")
        if not isinstance(build, Query):
            raise PlanError("build side must be a Query (wrap with scan())")
        for side, node in (("probe", self._node), ("build", build._node)):
            if _stage(node) != "table" or isinstance(node, (_OrderBy, _Limit)):
                raise PlanError(f"join {side} side must be a table stage")
        return Query(_Join(self._node, build._node, join_type, carry))

    def group_by(
        self,
        with_distinct: bool = False,
        group_capacity: Optional[int] = None,
    ) -> "Query":
        """GROUP BY key, aggregating COUNT(*), SUM, MIN, MAX (and
        COUNT(DISTINCT payload) with ``with_distinct``) over the payload
        column.  Result rows ``[0, num_groups)`` are valid."""
        if _stage(self._node) != "table" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError("group_by applies to a table stage")
        return Query(_GroupBy(self._node, with_distinct, group_capacity))

    def having(self, predicate) -> "Query":
        """Keep groups where ``predicate(g)`` holds — ``g`` is the
        GroupByResult, so conditions read like SQL HAVING:
        ``.having(lambda g: g.count > 5)``.  Surviving groups are
        compacted (k-sized gathers via the validity-dominant selection,
        never a re-aggregation); chains AND together."""
        if _stage(self._node) != "group" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError(
                "having applies to a group stage before order_by/limit"
            )
        return Query(_Having(self._node, predicate))

    def order_by(self, by: str = "key", descending: bool = False) -> "Query":
        """Sort by a column: table stage ``by`` ∈ {key, payload}; group
        stage ``by`` ∈ {key, count, sum, min, max}."""
        valid = (
            ("key", "payload")
            if _stage(self._node) == "table"
            else _GROUP_ORDER_COLS
        )
        if by not in valid:
            raise PlanError(f"order_by column must be one of {valid}")
        if isinstance(self._node, (_OrderBy, _Limit)):
            raise PlanError("only one order_by/limit suffix is supported")
        return Query(_OrderBy(self._node, by, descending))

    def limit(self, k: int) -> "Query":
        """Keep the first ``k`` rows (after order_by: the top k)."""
        if not isinstance(k, int) or k <= 0:
            raise PlanError(f"limit must be a positive int, got {k!r}")
        if isinstance(self._node, _Limit):
            raise PlanError("limit already applied")
        return Query(_Limit(self._node, k))

    # -- terminals ----------------------------------------------------------

    def execute(self, mesh=None):
        """Run the plan.  Returns a ``GroupByResult`` for group-stage
        plans, a ``JoinedTable`` for a bare join, else a ``TableResult``.
        ``mesh``: execute on a jax.sharding.Mesh via the distributed
        operators (R6; see docs/PARITY.md for mesh-plan coverage)."""
        plan = _compile(self._node, _Ctx(mesh=mesh))
        return plan.run()

    def count(self, mesh=None) -> int:
        """Row count of the plan's result, without materializing when a
        count join exists (R1)."""
        plan = _compile_count(self._node, _Ctx(mesh=mesh))
        return int(jax.device_get(plan.run()))

    def aggregate(
        self,
        with_distinct: bool = False,
        mesh=None,
    ) -> ScalarAggResult:
        """Whole-relation aggregates (SQL's SELECT SUM(...) without
        GROUP BY): COUNT/SUM/MIN/MAX of the payload over the plan's
        valid rows in ONE streaming pass — plus one
        validity-dominant 2-key sort when ``with_distinct``.  SUM
        follows the engine-wide mod-2^32 int32 law (same as every
        GROUP BY path), so relation-scale sums WRAP and ``mean()`` is
        the wrapped sum over count — widen payloads to int64 (x64 mode)
        for exact big sums.  Runs on whatever sharding the inputs carry
        (reductions jit to psums on sharded arrays); join plans flow
        through their materializer first."""
        if _stage(self._node) != "table" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError(
                "aggregate() applies to a table stage (ordering cannot "
                "change a scalar aggregate; drop the order_by/limit)"
            )
        steps: list = []
        inner = _exec_table(self._node, _Ctx(mesh=mesh), steps)
        t = inner()
        return _scalar_aggregate(
            t.pays, t.effective_mask(), with_distinct
        )

    def explain(self, mesh=None) -> str:
        """The physical plan as text, one operator per line, with the
        rewrite rule each line rides (R1-R6 in the module docstring)."""
        ctx = _Ctx(mesh=mesh)
        plan = _compile(self._node, ctx)
        head = (
            f"physical plan [mesh S={int(mesh.devices.size)}]"
            if mesh is not None
            else "physical plan [single device]"
        )
        return "\n".join([head] + [f"  {s}" for s in plan.steps])


def scan(table: Table) -> Query:
    """Start a plan from a relation."""
    if not isinstance(table, Table):
        raise PlanError("scan() takes a data.table.Table")
    return Query(_Scan(table))


# ---------------------------------------------------------------------------
# physical planning


@dataclasses.dataclass
class _Ctx:
    mesh: object = None


@dataclasses.dataclass
class _Plan:
    steps: list
    run: Callable[[], object]


def _two_run_ok(keys_dtype) -> bool:
    """The two-run join and materializer are the int32 path."""
    return keys_dtype == jnp.int32


def _exec_table(node, ctx: _Ctx, steps: list) -> Callable[[], _T]:
    """Compile a table-stage subtree to a thunk returning _T (R2: filters
    accumulate as masks; joins materialize only when rows must flow)."""
    if isinstance(node, _Scan):
        n = node.table.size
        steps.append(
            f"scan {node.table.uuid[:8]} ({n} rows, "
            f"{node.table.keys.dtype})"
        )
        t = node.table
        return lambda: _T(t.keys, t.payloads)
    if isinstance(node, _Filter):
        inner = _exec_table(node.child, ctx, steps)
        steps.append("filter -> validity mask, no materialization (R2)")
        pred = node.predicate

        def run():
            t = inner()
            m = jnp.asarray(pred(t.keys, t.pays), jnp.bool_)
            em = t.effective_mask()  # folds a join output's prefix_count
            if em is not None:
                m = m & em
            return _T(t.keys, t.pays, m)

        return run
    if isinstance(node, _Join):
        return _exec_join_rows(node, ctx, steps)
    raise PlanError(f"not a table-stage node: {type(node).__name__}")


def _exec_join_sides(node: _Join, ctx: _Ctx, steps: list):
    bsteps: list = []
    build = _exec_table(node.build, ctx, bsteps)
    psteps: list = []
    probe = _exec_table(node.probe, ctx, psteps)
    steps.extend(psteps)
    steps.extend("  [build] " + s for s in bsteps)
    return build, probe


def _join_is_plain(node: _Join) -> bool:
    """True when neither side carries a filter (masks absent statically)."""
    return isinstance(node.probe, _Scan) and isinstance(node.build, _Scan)


def _mesh_side_ok(node) -> bool:
    """True when a join side is a scan or a filter chain over a scan —
    shapes unchanged, so the side compiles to (columns, validity mask)
    and the mask pushes down into the distributed exchange (R6)."""
    while isinstance(node, _Filter):
        node = node.child
    return isinstance(node, _Scan)


def _exec_join_rows(node: _Join, ctx: _Ctx, steps: list):
    """Join whose output rows flow onward (or are the result)."""
    if ctx.mesh is not None:
        jt = node.join_type
        if jt not in ("inner", "semi", "anti", "left") or not (
            _mesh_side_ok(node.build) and _mesh_side_ok(node.probe)
        ):
            raise PlanError(
                "mesh materializing joins support inner/semi/anti/left "
                "over scan/filter sides (full needs a per-build-row "
                "cross-shard reduction); compose others single-device"
            )
        build, probe = _exec_join_sides(node, ctx, steps)
        carry = node.carry
        steps.append(
            f"join[{jt}] -> distributed materialize (exchange + per-shard "
            "typed union join, gathered + compacted); filters pushed into "
            "the bucketizer (R2, R6); carry=" + carry
        )
        mesh = ctx.mesh

        def run_mesh():
            from partitionedhashjoin_tpu.parallel.materialize_shuffle import (
                DistributedMaterializeJoiner,
            )

            b, p = build(), probe()
            op = DistributedMaterializeJoiner(mesh, seed=0x5EED)
            joined = op.run(
                make_table(b.keys, b.pays),
                make_table(p.keys, p.pays),
                jt,
                build_valid=b.effective_mask(),
                probe_valid=p.effective_mask(),
            )
            pays = (
                joined.payloads_b if carry == "probe"
                else joined.payloads_a
            )
            t = _T(joined.keys, pays, prefix_count=joined.count)
            t.joined = joined
            return t

        return run_mesh
    build, probe = _exec_join_sides(node, ctx, steps)
    jt, carry = node.join_type, node.carry
    steps.append(
        f"join[{jt}] -> typed sort-merge materializer, filters as "
        "validity masks (R2); carry=" + carry
    )

    def run():
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        b, p = build(), probe()
        keys, pa, pb, matched, count = sort_merge_materialize_typed(
            b.keys, b.pays, p.keys, p.pays, jt,
            build_valid=b.effective_mask(),
            probe_valid=p.effective_mask(),
        )
        pays = pb if carry == "probe" else pa
        t = _T(keys, pays, prefix_count=count)
        t.joined = JoinedTable(  # kept for a bare-join execute()
            keys=keys, payloads_a=pa, payloads_b=pb, count=count,
            matched=matched,
        )
        return t

    return run


def _compile(node, ctx: _Ctx) -> _Plan:
    steps: list = []
    if _stage(node) == "table":
        # peel the optional order_by/limit suffix
        limit_k = None
        order = None
        core = node
        if isinstance(core, _Limit):
            limit_k = core.k
            core = core.child
        if isinstance(core, _OrderBy):
            order = core
            core = core.child
        inner = _exec_table(core, ctx, steps)
        if order is None and limit_k is None:
            if isinstance(core, _Join):
                steps.append("emit JoinedTable (3 columns + count)")

                def run_join():
                    t = inner()
                    return t.joined

                return _Plan(steps, run_join)
            steps.append("emit TableResult (compact if filtered)")

            def run_table():
                t = inner()
                if t.mask is None:
                    table = make_table(t.keys, t.pays)
                    return TableResult(table, t.count())
                from partitionedhashjoin_tpu.ops.filter import compact_sort

                cnt, k, p = compact_sort(t.mask, t.keys, t.pays)
                return TableResult(make_table(k, p), cnt)

            return _Plan(steps, run_table)
        return _compile_table_tail(inner, core, order, limit_k, ctx, steps)

    # group stage
    limit_k = None
    order = None
    core = node
    if isinstance(core, _Limit):
        limit_k = core.k
        core = core.child
    if isinstance(core, _OrderBy):
        order = core
        core = core.child
    having_preds = []
    while isinstance(core, _Having):
        having_preds.append(core.predicate)
        core = core.child
    assert isinstance(core, _GroupBy)
    run_group = _exec_group(core, ctx, steps)
    mask_fn = None
    if having_preds:
        steps.append(
            f"having ({len(having_preds)} predicate"
            f"{'s' if len(having_preds) > 1 else ''}) -> group validity "
            "mask, folded into the k-sized selection (no re-aggregation)"
        )

        def mask_fn(g):
            m = None
            for pred in having_preds:
                pm = jnp.asarray(pred(g), jnp.bool_)
                m = pm if m is None else (m & pm)
            return m

    if order is None and limit_k is None:
        if mask_fn is None:
            return _Plan(steps, run_group)

        def run_having():
            g = run_group()
            # compact surviving groups to the front, key order
            return group_top_k(
                g, g.keys.shape[0], by="key", descending=False,
                mask=mask_fn(g),
            )

        return _Plan(steps, run_having)
    return _compile_group_tail(
        run_group, order, limit_k, ctx, steps, mask_fn=mask_fn
    )


# -- table-stage order_by / limit -------------------------------------------


def _order_col_key(col, descending):
    """Monotone reorder key: ascending wants smallest first, and top-k /
    sorts pick largest/smallest consistently via bitwise complement (the
    INT_MIN-safe trick from ops/order_by.py)."""
    return ~col if descending else col


def _compile_table_tail(inner, core, order, limit_k, ctx, steps) -> _Plan:
    if ctx.mesh is not None and isinstance(core, _Join):
        # join tail: the distributed materialize already returns a
        # replicated prefix-compacted relation, so the ordinary local
        # order_by/limit tail below applies to it unchanged (it reads
        # t.prefix_count); fall through.
        steps.append(
            "join tail on mesh -> local order/limit over the gathered "
            "replicated join output"
        )
    elif ctx.mesh is not None:
        if order is None or limit_k is None or not _mesh_side_ok(core):
            raise PlanError(
                "mesh table-stage plans support "
                "scan()[.filter()].order_by().limit() (distributed "
                "top-k); compose others single-device"
            )
        filtered = not isinstance(core, _Scan)
        steps.append(
            f"order_by {order.by} {'desc' if order.descending else 'asc'} "
            f"+ limit {limit_k} -> distributed top-k "
            + (
                "(filter as validity mask, validity-dominant sort; "
                if filtered else "(local top-k, "
            )
            + "all_gather S*k, replicated final) (R2, R4, R6)"
        )
        mesh = ctx.mesh

        def run_mesh():
            from partitionedhashjoin_tpu.parallel.top_k import (
                distributed_top_k,
            )

            t = inner()
            out, n_live = distributed_top_k(
                mesh, make_table(t.keys, t.pays), limit_k,
                by=order.by, descending=order.descending,
                mask=t.effective_mask(),
            )
            return TableResult(out, n_live)

        return _Plan(steps, run_mesh)

    if order is None:
        # LIMIT without ORDER BY: head of the (valid) rows
        steps.append(f"limit {limit_k} -> head slice (compact if filtered)")

        def run_head():
            from partitionedhashjoin_tpu.ops.filter import compact_sort

            t = inner()
            k = min(limit_k, t.keys.shape[0])
            if t.mask is None and t.prefix_count is not None:
                # already prefix-compacted (a materialized join): the head
                # is the slice, but the live count caps at the prefix
                cnt = jnp.minimum(
                    jnp.asarray(k, jnp.int32), t.prefix_count
                )
                keys, pays = t.keys[:k], t.pays[:k]
            elif t.mask is None:
                cnt = jnp.asarray(k, jnp.int32)
                keys, pays = t.keys[:k], t.pays[:k]
            else:
                cnt, keys, pays = compact_sort(t.mask, t.keys, t.pays)
                cnt = jnp.minimum(cnt, k)
                keys, pays = keys[:k], pays[:k]
                live = jnp.arange(k, dtype=jnp.int32) < cnt
                keys = jnp.where(live, keys, 0)
                pays = jnp.where(live, pays, 0)
            return TableResult(make_table(keys, pays), cnt)

        return _Plan(steps, run_head)

    by, desc = order.by, order.descending
    if limit_k is not None:
        steps.append(
            f"order_by {by} {'desc' if desc else 'asc'} + limit {limit_k} "
            "-> lax.top_k, no relation sort (R4)"
        )

        def run_topk():
            t = inner()
            n = t.keys.shape[0]
            k = min(limit_k, n)
            if t.mask is None and t.prefix_count is None:
                col = t.keys if by == "key" else t.pays
                # lax.top_k picks the LARGEST; ascending wants the
                # largest of ~col (the INT_MIN-safe complement trick,
                # ops/order_by.py)
                _, idx = jax.lax.top_k(col if desc else ~col, k)
                return TableResult(
                    make_table(t.keys[idx], t.pays[idx]),
                    jnp.asarray(k, jnp.int32),
                )
            # exact under validity: one masked 3-key sort + head-k — a
            # top_k sentinel value could collide with a real extreme key
            cnt, keys_s, pays_s = _masked_order(t, by, desc)
            kcnt = jnp.minimum(cnt, k)
            live = jnp.arange(k, dtype=jnp.int32) < kcnt
            return TableResult(
                make_table(
                    jnp.where(live, keys_s[:k], 0),
                    jnp.where(live, pays_s[:k], 0),
                ),
                kcnt,
            )

        return _Plan(steps, run_topk)

    steps.append(
        f"order_by {by} {'desc' if desc else 'asc'} -> one value-carrying "
        "unstable sort (validity as leading sort key when filtered)"
    )

    def run_order():
        t = inner()
        cnt, keys_s, pays_s = _masked_order(t, by, desc)
        return TableResult(make_table(keys_s, pays_s), cnt)

    return _Plan(steps, run_order)


@functools.partial(jax.jit, static_argnames=("with_distinct",))
def _scalar_agg_impl(pays, mask, with_distinct):
    """``mask=None`` (a static pytree shape) skips every select — the
    unfiltered case is pure streaming reductions, no O(n) mask."""
    info = jnp.iinfo(pays.dtype)
    zero = jnp.zeros((), pays.dtype)
    if mask is None:
        cnt = jnp.asarray(pays.shape[0], jnp.int32)
        s = jnp.sum(pays)  # mod-2^32, engine SUM law
        mn, mx = jnp.min(pays), jnp.max(pays)
    else:
        cnt = jnp.sum(mask.astype(jnp.int32))
        s = jnp.sum(jnp.where(mask, pays, zero))
        mn = jnp.min(
            jnp.where(mask, pays, jnp.asarray(info.max, pays.dtype))
        )
        mx = jnp.max(
            jnp.where(mask, pays, jnp.asarray(info.min, pays.dtype))
        )
        mn = jnp.where(cnt > 0, mn, zero)
        mx = jnp.where(cnt > 0, mx, zero)
    d = jnp.zeros((), jnp.int32)
    if with_distinct:
        # validity-dominant 2-key sort: valid payloads form a sorted
        # prefix, distinct values are its run boundaries — exact over
        # the full int domain, no sentinel values
        if mask is None:
            pay_s = jax.lax.sort(pays)
            d = 1 + jnp.sum((pay_s[1:] != pay_s[:-1]).astype(jnp.int32))
        else:
            inv = jnp.where(mask, 0, 1).astype(jnp.int32)
            inv_s, pay_s = jax.lax.sort((inv, pays), num_keys=2)
            valid_s = inv_s == 0
            d = valid_s[0].astype(jnp.int32) + jnp.sum(
                ((pay_s[1:] != pay_s[:-1]) & valid_s[1:]).astype(jnp.int32)
            )
    return cnt, s, mn, mx, d


def _scalar_aggregate(pays, mask, with_distinct) -> ScalarAggResult:
    n = pays.shape[0]
    if n == 0:
        z = jnp.zeros((), pays.dtype)
        zi = jnp.zeros((), jnp.int32)
        return ScalarAggResult(
            zi, z, z, z, zi if with_distinct else None
        )
    cnt, s, mn, mx, d = _scalar_agg_impl(pays, mask, with_distinct)
    return ScalarAggResult(cnt, s, mn, mx, d if with_distinct else None)


@jax.jit
def _masked_order_impl(keys, pays, invalid, ordcol):
    n = keys.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)  # determinism tiebreak
    inv_s, _, _, keys_s, pays_s = jax.lax.sort(
        (invalid, ordcol, pos, keys, pays), num_keys=3, is_stable=False
    )
    cnt = jnp.sum((~inv_s).astype(jnp.int32))
    live = pos < cnt
    return (
        cnt,
        jnp.where(live, keys_s, 0),
        jnp.where(live, pays_s, 0),
    )


def _masked_order(t: _T, by: str, desc: bool):
    """Order valid rows to the front: invalid-flag is the leading sort key,
    so filtered rows can never interleave (exact over the full int domain —
    no sentinel keys)."""
    n = t.keys.shape[0]
    if t.mask is not None:
        invalid = ~t.mask
    elif t.prefix_count is not None:
        invalid = jnp.arange(n, dtype=jnp.int32) >= t.prefix_count
    else:
        invalid = jnp.zeros((n,), jnp.bool_)
    ordcol = _order_col_key(t.keys if by == "key" else t.pays, desc)
    return _masked_order_impl(t.keys, t.pays, invalid, ordcol)


# -- group stage -------------------------------------------------------------


def _exec_group(node: _GroupBy, ctx: _Ctx, steps: list):
    child = node.child
    cap = node.group_capacity
    wd = node.with_distinct

    if ctx.mesh is not None:
        if wd and isinstance(child, _Join):
            raise PlanError(
                "mesh join->group_by(with_distinct) is not supported "
                "(hot-key probe rows stay sharded, so their payload sets "
                "never meet); compose it single-device"
            )
        if isinstance(child, _Join):
            join = child
            if (
                join.join_type != "inner"
                or not (
                    _mesh_side_ok(join.build) and _mesh_side_ok(join.probe)
                )
                or join.carry != "probe"
            ):
                raise PlanError(
                    "mesh join->group_by supports an inner join over "
                    "scan/filter sides with carry='probe' (the join "
                    "exchange co-partitions the groups); compose others "
                    "single-device"
                )
            build, probe = _exec_join_sides(join, ctx, steps)
            steps.append(
                "join[inner] + group_by -> one shuffle: the join exchange "
                "co-partitions the groups (filters pushed into the "
                "bucketizer); partials matched per key, combiner merge "
                "(R2, R3, R6)"
            )
            mesh = ctx.mesh

            def run_mesh_join():
                from partitionedhashjoin_tpu.parallel.join_aggregate import (
                    DistributedJoinAggregateOperator,
                )

                b, p = build(), probe()
                op = DistributedJoinAggregateOperator(mesh, seed=0x5EED)
                return op.run(
                    make_table(b.keys, b.pays),
                    make_table(p.keys, p.pays),
                    group_capacity=cap,
                    build_valid=b.mask,
                    probe_valid=p.mask,
                )

            return run_mesh_join
        inner = _exec_table(child, ctx, steps)
        steps.append(
            "group_by -> distributed row-exchange aggregate with exact "
            "COUNT DISTINCT (payload sets meet at the owner shard) (R6)"
            if wd else
            "group_by -> distributed combiner-plan aggregate (local "
            "sort-aggregate, hash-routed partials, psum-exact) (R6)"
        )
        mesh = ctx.mesh

        def run_mesh():
            from partitionedhashjoin_tpu.parallel.aggregate_shuffle import (
                DistributedAggregateOperator,
            )

            t = inner()
            op = DistributedAggregateOperator(mesh, seed=0x5EED)
            return op.run(
                make_table(t.keys, t.pays), group_capacity=cap,
                mask=t.mask, with_distinct=wd,
            )

        return run_mesh

    if isinstance(child, _Join):
        return _exec_join_group(child, node, ctx, steps)

    if isinstance(child, _Filter):
        inner = _exec_table(child.child, ctx, steps)
        steps.append(
            "filter + group_by -> staged scatter-compaction filter, "
            "aggregate sorts only survivors (R5)"
        )
        pred = child.predicate

        def run_staged():
            from partitionedhashjoin_tpu.ops.aggregate import (
                filter_sort_aggregate,
                filter_sort_aggregate_staged,
            )

            t = inner()
            mask = jnp.asarray(pred(t.keys, t.pays), jnp.bool_)
            em = t.effective_mask()
            if em is not None:
                mask = mask & em
            staged = (
                t.keys.dtype == jnp.int32 and t.pays.dtype == jnp.int32
            )
            fn = (
                filter_sort_aggregate_staged if staged
                else filter_sort_aggregate  # staged path is int32-only
            )
            g, _ = fn(
                make_table(t.keys, t.pays),
                lambda k, p: mask,
                group_capacity=cap,
                with_distinct=wd,
            )
            return g

        return run_staged

    inner = _exec_table(child, ctx, steps)
    steps.append("group_by -> sort_aggregate (one multi-key sort)")

    def run_sort():
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
            sort_aggregate,
        )

        t = inner()
        mask = t.effective_mask()
        if mask is not None:
            g, _ = filter_sort_aggregate(
                make_table(t.keys, t.pays),
                lambda k, p: mask,
                group_capacity=cap,
                with_distinct=wd,
            )
            return g
        return sort_aggregate(
            make_table(t.keys, t.pays),
            group_capacity=cap,
            with_distinct=wd,
        )

    return run_sort


def _exec_join_group(join: _Join, gb: _GroupBy, ctx: _Ctx, steps: list):
    """R3: join → group_by without a second relation sort.

    The two-run materializer emits key-ordered (optionally payload-ordered)
    runs, so the aggregate skips its pass-1 sort entirely.  Conditions for
    the two-run path: inner join, int32 columns, no filters on either side
    (the materializer has no validity protocol); otherwise the typed
    materializer (probe-row order) feeds the sorting aggregate with the
    joined rows' validity mask."""
    build, probe = _exec_join_sides(join, ctx, steps)
    carry = join.carry
    cap = gb.group_capacity
    wd = gb.with_distinct
    two_run = (
        join.join_type == "inner"
        and _join_is_plain(join)
        and _two_run_ok(_scan_dtype(join.probe))
        and _two_run_ok(_scan_dtype(join.build))
    )
    if two_run:
        steps.append(
            "join[inner] + group_by -> two-run materializer emits "
            "(key, payload)-ordered runs; aggregate_sorted skips the "
            "relation sort (R3)"
        )

        def run_two_run():
            from partitionedhashjoin_tpu.ops.aggregate import aggregate_sorted
            from partitionedhashjoin_tpu.ops.merge_join import (
                two_run_materialize,
            )

            b, p = build(), probe()
            keys, pa, pb, count = two_run_materialize(
                b.keys, b.pays, p.keys, p.pays,
                # carry=="build": pay_a is constant within a key run
                # (first-match), so runs are trivially payload-ordered
                probe_payload_sorted=(carry == "probe"),
            )
            pays = pb if carry == "probe" else pa
            return aggregate_sorted(
                make_table(keys, pays),
                group_capacity=cap,
                n_valid=count,
                payload_sorted=True,
                with_distinct=wd,
            )

        return run_two_run

    jt = join.join_type

    def _typed_body(b, p):
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
        )
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        keys, pa, pb, matched, count = sort_merge_materialize_typed(
            b.keys, b.pays, p.keys, p.pays, jt,
            build_valid=b.effective_mask(),
            probe_valid=p.effective_mask(),
        )
        pays = pb if carry == "probe" else pa
        live = jnp.arange(keys.shape[0], dtype=jnp.int32) < count
        g, _ = filter_sort_aggregate(
            make_table(keys, pays),
            lambda k, v: live,
            group_capacity=cap,
            with_distinct=wd,
        )
        return g

    staged = (
        jt == "inner"
        and _mesh_side_ok(join.build)
        and _mesh_side_ok(join.probe)
        and _two_run_ok(_scan_dtype(join.probe))
        and _two_run_ok(_scan_dtype(join.build))
    )
    if staged:
        # R7 = R5 ∘ R3: stage the filters OUT of the join instead of
        # masking the typed materializer.  The probe filter pays one
        # scatter compaction (no relation sort), invalid build rows
        # re-key to a sentinel, and the two-run pipeline then runs
        # on the survivors — its sorts scale with selectivity and the
        # GROUP BY stays sort-free (aggregate_sorted).  The two sides
        # use OPPOSITE sentinels (probe→INT32_MAX, build→INT32_MIN) so
        # injected rows can never match each other; exactness guard:
        # either extreme present in either original key column would
        # collide with a sentinel, so such inputs take the typed path
        # (one fused reduction to check).
        steps.append(
            "join[inner] + group_by -> staged: scatter compaction "
            "of the filtered probe, invalid rows re-keyed to opposite "
            "sentinels, two-run materializer + aggregate_sorted on the "
            "survivors (R7 = R5∘R3; int32-extreme keys fall back to the "
            "typed path)"
        )

        def run_staged():
            from partitionedhashjoin_tpu.ops.aggregate import (
                aggregate_sorted,
                staged_slice_size,
            )
            from partitionedhashjoin_tpu.ops.filter import compact
            from partitionedhashjoin_tpu.ops.merge_join import (
                two_run_materialize,
            )

            b, p = build(), probe()
            i32max = jnp.iinfo(jnp.int32).max
            i32min = jnp.iinfo(jnp.int32).min

            def _has_extreme(k):
                return jnp.any((k == i32max) | (k == i32min))

            if (
                b.pays.dtype != jnp.int32
                or p.pays.dtype != jnp.int32
                or bool(
                    jax.device_get(
                        _has_extreme(b.keys) | _has_extreme(p.keys)
                    )
                )
            ):
                return _typed_body(b, p)
            b_em, p_em = b.effective_mask(), p.effective_mask()
            bk = (
                jnp.where(b_em, b.keys, i32min)
                if b_em is not None else b.keys
            )
            if p_em is not None:
                n = p.keys.shape[0]
                total, keys_c, pay_c = compact(p_em, p.keys, p.pays)
                total = int(jax.device_get(total))
                # bucketed static slice (the staged aggregate's dispatch
                # idiom, filter_sort_aggregate_staged)
                size = staged_slice_size(n, total)
                keys_s = jax.lax.slice_in_dim(keys_c, 0, size)
                pay_s = jax.lax.slice_in_dim(pay_c, 0, size)
                # the tail past the survivors re-keys to INT32_MAX: it
                # matches nothing, so the materializer drops it for free
                valid = jnp.arange(size, dtype=jnp.int32) < total
                keys_s = jnp.where(valid, keys_s, i32max)
            else:
                keys_s, pay_s = p.keys, p.pays
            keys, pa, pb, count = two_run_materialize(
                bk, b.pays, keys_s, pay_s,
                probe_payload_sorted=(carry == "probe"),
            )
            pays = pb if carry == "probe" else pa
            return aggregate_sorted(
                make_table(keys, pays),
                group_capacity=cap,
                n_valid=count,
                payload_sorted=True,
                with_distinct=wd,
            )

        return run_staged

    steps.append(
        f"join[{jt}] + group_by -> typed materializer (masks, R2), then "
        "sorting aggregate over the compacted join output"
    )

    def run_typed():
        b, p = build(), probe()
        return _typed_body(b, p)

    return run_typed


def _scan_dtype(node):
    while isinstance(node, _Filter):
        node = node.child
    assert isinstance(node, _Scan)
    return node.table.keys.dtype


# -- group-stage order_by / limit --------------------------------------------


def _group_columns(g):
    cols = {
        "key": g.keys, "count": g.count, "sum": g.sum,
        "min": g.min, "max": g.max,
    }
    if g.distinct is not None:
        cols["distinct"] = g.distinct
    return cols


def group_top_k(
    g, k: int, by: str = "count", descending: bool = True, mask=None
):
    """Top-k groups of a GroupByResult by one aggregate column, all columns
    carried (k-sized gathers).  Exact under capacity truncation: rows past
    ``num_groups`` are force-masked before selection.  ``mask``: optional
    extra per-row validity (a HAVING predicate) ANDed in — filtered groups
    can never be selected and ``num_groups`` reflects the survivors.
    Returns a GroupByResult with ``num_groups = min(k, #valid)`` whose
    rows are in the requested order.

    COUNT-descending (the hot "top groups" shape) rides ``lax.top_k``
    directly — a masked-out row's count of 0 can never beat a valid
    group's count ≥ 1, so no sentinel collision exists and no group-table
    sort is paid.  Every other column/direction uses a validity-dominant
    3-key sort: invalid rows lose the leading comparison, so no sentinel
    VALUE is needed at all (exact over the full int domain)."""
    from partitionedhashjoin_tpu.ops.aggregate import GroupByResult

    cols = _group_columns(g)
    if by not in cols:
        raise PlanError(f"order_by column must be one of {tuple(cols)}")
    n = g.keys.shape[0]
    if k > n:
        k = n
    pos = jnp.arange(n, dtype=jnp.int32)
    valid = pos < g.num_groups
    n_valid = g.num_groups
    if mask is not None:
        valid = valid & jnp.asarray(mask, jnp.bool_)
        n_valid = jnp.sum(valid.astype(jnp.int32))
    if by == "count" and descending:
        _, idx_k = jax.lax.top_k(jnp.where(valid, g.count, 0), k)
    else:
        ordcol = _order_col_key(cols[by], descending)  # ascending-native
        _, _, _, idx_s = jax.lax.sort(
            (~valid, ordcol, pos, pos), num_keys=3, is_stable=False
        )
        idx_k = idx_s[:k]
    live = pos[:k] < jnp.minimum(n_valid, k)

    def take(col, zero):
        return jnp.where(live, col[idx_k], zero)

    return GroupByResult(
        keys=take(g.keys, 0),
        count=take(g.count, 0),
        sum=take(g.sum, jnp.zeros((), g.sum.dtype)),
        min=take(g.min, jnp.zeros((), g.min.dtype)),
        max=take(g.max, jnp.zeros((), g.max.dtype)),
        num_groups=jnp.minimum(n_valid, k),
        # a selection result tracks no row membership; an [n_rows] -1
        # array here cost 800 MB of dead HBM per result at 200M rows
        # (the round-5 pipeline-bench OOM)
        group_of_row=jnp.zeros((0,), jnp.int32),
        distinct=(None if g.distinct is None else take(g.distinct, 0)),
    )


def _compile_group_tail(
    run_group, order, limit_k, ctx, steps, mask_fn=None
) -> _Plan:
    def tail_top_k(g, k, by, descending):
        return group_top_k(
            g, k, by=by, descending=descending,
            mask=None if mask_fn is None else mask_fn(g),
        )

    if order is None:
        # LIMIT over groups without an order: first k valid groups
        steps.append(f"limit {limit_k} -> head of the group table")

        def run_head():
            g = run_group()
            return tail_top_k(  # key order of the group layout
                g, limit_k, by="key", descending=False
            )

        return _Plan(steps, run_head)
    by, desc = order.by, order.descending
    if limit_k is None:
        steps.append(
            f"order_by {by} {'desc' if desc else 'asc'} -> full group sort "
            "(validity-dominant 3-key sort, all columns carried)"
        )

        def run_order():
            g = run_group()
            return tail_top_k(g, g.keys.shape[0], by=by, descending=desc)

        return _Plan(steps, run_order)
    steps.append(
        f"order_by {by} {'desc' if desc else 'asc'} + limit {limit_k} -> "
        "top-k over group columns, no relation sort (R4)"
    )

    def run_topk():
        g = run_group()
        return tail_top_k(g, limit_k, by=by, descending=desc)

    return _Plan(steps, run_topk)


# ---------------------------------------------------------------------------
# count-only compilation (R1)


def _compile_count(node, ctx: _Ctx) -> _Plan:
    steps: list = []
    if _stage(node) == "group":
        plan = _compile(node, ctx)

        def run_groups():
            return plan.run().num_groups

        return _Plan(plan.steps + ["count -> num_groups"], run_groups)

    core = node
    k_limit = None
    if isinstance(core, _Limit):
        k_limit = core.k
        core = core.child
    if isinstance(core, _OrderBy):
        core = core.child  # ordering does not change the count

    if isinstance(core, _Join):
        run = _count_join(core, ctx, steps)
    else:
        inner = _exec_table(core, ctx, steps)
        steps.append("count -> mask popcount (no materialization, R1)")

        def run():
            return inner().count()

    if k_limit is None:
        return _Plan(steps, run)
    steps.append(f"count -> min(count, limit {k_limit})")
    return _Plan(
        steps, lambda: jnp.minimum(run(), jnp.asarray(k_limit, jnp.int32))
    )


def _count_join(node: _Join, ctx: _Ctx, steps: list):
    jt = node.join_type
    if ctx.mesh is not None:
        if jt not in ("inner", "semi") or not (
            _mesh_side_ok(node.build) and _mesh_side_ok(node.probe)
        ):
            raise PlanError(
                "mesh join counts support inner/semi joins over "
                "scan/filter sides (the shuffle join); compose others "
                "single-device"
            )
        build, probe = _exec_join_sides(node, ctx, steps)
        steps.append(
            "count join[inner] -> distributed shuffle join "
            "(all_to_all exchange, hot-key replication, filters pushed "
            "into the bucketizer, psum count) (R1, R2, R6)"
        )
        mesh = ctx.mesh

        def run_mesh():
            from partitionedhashjoin_tpu.parallel.shuffle import (
                DistributedShuffleJoiner,
            )

            b, p = build(), probe()
            joiner = DistributedShuffleJoiner(mesh, seed=0x5EED)
            return jnp.asarray(
                joiner.run(
                    make_table(b.keys, b.pays),
                    make_table(p.keys, p.pays),
                    valid_a=b.effective_mask(),
                    valid_b=p.effective_mask(),
                ),
                jnp.int32,
            )

        return run_mesh

    build, probe = _exec_join_sides(node, ctx, steps)
    steps.append(
        f"count join[{jt}] -> two-run count with validity masks, "
        "nothing materialized (R1)"
    )

    def run():
        from partitionedhashjoin_tpu.ops.merge_join import two_run_count
        from partitionedhashjoin_tpu.ops.sort_merge import (
            anti_count,
            sort_merge_count,
        )

        b, p = build(), probe()
        b_em, p_em = b.effective_mask(), p.effective_mask()

        def match_count():
            if _two_run_ok(b.keys.dtype) and _two_run_ok(
                p.keys.dtype
            ):
                return two_run_count(
                    b.keys, p.keys, build_valid=b_em, probe_valid=p_em
                )
            return sort_merge_count(
                b.keys, p.keys, build_valid=b_em, probe_valid=p_em
            )

        if jt in ("inner", "semi"):
            return match_count()
        if jt == "anti":
            return anti_count(
                b.keys, p.keys, build_valid=b_em, probe_valid=p_em
            )
        if jt == "left":
            return p.count()
        # full: valid probe rows + unmatched valid build rows
        return p.count() + anti_count(
            p.keys, b.keys, build_valid=p_em, probe_valid=b_em
        )

    return run
