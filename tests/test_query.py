"""Query-layer tests: fluent plans, physical rewrites, and mesh execution.

Every executed plan is checked against either a direct operator call or a
host-side numpy oracle.  Two-run-path tests reuse the
(100, 3000, probe_payload_sorted=True) shape already compiled by
test_operators.py — shape discipline per CLAUDE.md.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.data.table import JoinedTable, Table, make_table
from partitionedhashjoin_tpu.query import (
    PlanError,
    TableResult,
    group_top_k,
    scan,
)


def _t(keys, pays):
    return make_table(
        np.asarray(keys, np.int32), np.asarray(pays, np.int32)
    )


def _rand_tables(seed, n_a=80, n_b=400, key_hi=40):
    rng = np.random.default_rng(seed)
    a = _t(rng.integers(0, key_hi, n_a), rng.integers(1, 1000, n_a))
    b = _t(
        rng.integers(0, key_hi + 10, n_b), rng.integers(-500, 500, n_b)
    )
    return a, b, rng


def _np_group(keys, pays, with_distinct=False):
    """key -> (count, sum mod 2^32 as int32, min, max[, distinct])."""
    out = {}
    for k, p in zip(keys.tolist(), pays.tolist()):
        c, s, mn, mx, dv = out.get(k, (0, 0, None, None, set()))
        mn = p if mn is None else min(mn, p)
        mx = p if mx is None else max(mx, p)
        dv = dv | {p}
        out[k] = (c + 1, np.int32(np.int64(s) + p), mn, mx, dv)
    return {
        k: (c, int(s), mn, mx) + ((len(dv),) if with_distinct else ())
        for k, (c, s, mn, mx, dv) in out.items()
    }


def _group_dict(g, with_distinct=False):
    n = int(g.num_groups)
    out = {}
    for i in range(n):
        out[int(np.asarray(g.keys)[i])] = (
            int(np.asarray(g.count)[i]),
            int(np.asarray(g.sum)[i]),
            int(np.asarray(g.min)[i]),
            int(np.asarray(g.max)[i]),
        ) + (
            (int(np.asarray(g.distinct)[i]),) if with_distinct else ()
        )
    return out


class TestValidation:
    def test_plan_errors(self):
        t = _t([1, 2], [3, 4])
        q = scan(t)
        with pytest.raises(PlanError):
            scan("nope")
        with pytest.raises(PlanError):
            q.join("nope")
        with pytest.raises(PlanError):
            q.join(q, join_type="cross")
        with pytest.raises(PlanError):
            q.join(q, carry="both")
        with pytest.raises(PlanError):
            q.order_by("sum")  # table stage: key/payload only
        with pytest.raises(PlanError):
            q.group_by().order_by("payload")  # group stage col set
        with pytest.raises(PlanError):
            q.limit(0)
        with pytest.raises(PlanError):
            q.limit(3).limit(4)
        with pytest.raises(PlanError):
            q.order_by("key").filter(lambda k, p: k > 0)
        with pytest.raises(PlanError):
            q.group_by().group_by()
        with pytest.raises(PlanError):
            q.order_by("key").join(q)

    def test_group_stage_detection(self):
        t = _t([1, 2], [3, 4])
        g = scan(t).group_by().order_by("count", descending=True)
        with pytest.raises(PlanError):
            g.group_by()


class TestTableStage:
    def test_scan_execute(self):
        t = _t([5, 1, 7], [10, 20, 30])
        r = scan(t).execute()
        assert isinstance(r, TableResult)
        assert int(r.count) == 3
        assert np.asarray(r.table.keys).tolist() == [5, 1, 7]

    def test_filter_execute_and_count(self):
        a, b, _ = _rand_tables(3)
        pred = lambda k, p: (p % 3 == 0) & (k < 30)
        q = scan(b).filter(pred)
        want = np.asarray(pred(b.keys, b.payloads))
        assert q.count() == int(want.sum())
        r = q.execute()
        assert int(r.count) == int(want.sum())
        got_k = np.asarray(r.table.keys)[: int(r.count)]
        np.testing.assert_array_equal(got_k, np.asarray(b.keys)[want])
        # stacked filters AND together
        q2 = scan(b).filter(lambda k, p: p % 3 == 0).filter(
            lambda k, p: k < 30
        )
        assert q2.count() == int(want.sum())

    def test_order_by_limit_topk_vs_masked(self):
        a, b, _ = _rand_tables(5)
        # unmasked: lax.top_k path
        r = scan(b).order_by("payload", descending=True).limit(7).execute()
        want = np.sort(np.asarray(b.payloads))[::-1][:7]
        np.testing.assert_array_equal(np.asarray(r.table.payloads), want)
        # masked: validity-dominant sort path, exact under filters
        pred = lambda k, p: k % 2 == 0
        r2 = (
            scan(b).filter(pred)
            .order_by("payload", descending=False).limit(5).execute()
        )
        sel = np.asarray(b.payloads)[np.asarray(pred(b.keys, b.payloads))]
        np.testing.assert_array_equal(
            np.asarray(r2.table.payloads)[: int(r2.count)],
            np.sort(sel)[:5],
        )

    def test_order_by_full_and_head_limit(self):
        a, b, _ = _rand_tables(6, n_b=50)
        r = scan(b).order_by("key").execute()
        np.testing.assert_array_equal(
            np.asarray(r.table.keys), np.sort(np.asarray(b.keys))
        )
        # limit without order: first k valid rows in original order
        pred = lambda k, p: p > 0
        r2 = scan(b).filter(pred).limit(4).execute()
        sel = np.asarray(pred(b.keys, b.payloads))
        want = np.asarray(b.keys)[sel][:4]
        np.testing.assert_array_equal(
            np.asarray(r2.table.keys)[: int(r2.count)], want
        )


class TestJoins:
    @pytest.mark.parametrize(
        "jt", ["inner", "semi", "anti", "left", "full"]
    )
    def test_join_execute_matches_direct(self, jt):
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        a, b, _ = _rand_tables(11)
        bp = lambda k, p: p % 2 == 0
        pp = lambda k, p: k % 3 != 0
        q = scan(b).filter(pp).join(scan(a).filter(bp), join_type=jt)
        out = q.execute()
        assert isinstance(out, JoinedTable)
        keys, pa, pb, matched, count = sort_merge_materialize_typed(
            a.keys, a.payloads, b.keys, b.payloads, jt,
            build_valid=bp(a.keys, a.payloads),
            probe_valid=pp(b.keys, b.payloads),
        )
        assert int(out.count) == int(count)
        np.testing.assert_array_equal(np.asarray(out.keys), np.asarray(keys))
        np.testing.assert_array_equal(
            np.asarray(out.payloads_a), np.asarray(pa)
        )
        np.testing.assert_array_equal(
            np.asarray(out.payloads_b), np.asarray(pb)
        )
        # .count() agrees without materializing (R1)
        assert q.count() == int(count)

    def test_join_count_oracle(self):
        a, b, _ = _rand_tables(13)
        ak = set(np.asarray(a.keys).tolist())
        bk = np.asarray(b.keys)
        hits = int(sum(1 for k in bk.tolist() if k in ak))
        q = scan(b).join(scan(a))
        assert q.count() == hits
        assert scan(b).join(scan(a), join_type="anti").count() == (
            len(bk) - hits
        )
        assert scan(b).join(scan(a), join_type="left").count() == len(bk)
        unmatched_a = int(
            sum(1 for k in np.asarray(a.keys).tolist()
                if k not in set(bk.tolist()))
        )
        assert scan(b).join(scan(a), join_type="full").count() == (
            len(bk) + unmatched_a
        )

    def test_join_carry_then_order(self):
        a, b, _ = _rand_tables(17, n_a=30, n_b=60, key_hi=20)
        # carry build payload downstream, then top-k by it
        r = (
            scan(b).join(scan(a), carry="build")
            .order_by("payload", descending=True).limit(3).execute()
        )
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        keys, pa, pb, matched, count = sort_merge_materialize_typed(
            a.keys, a.payloads, b.keys, b.payloads, "inner"
        )
        pa = np.asarray(pa)[: int(count)]
        want = np.sort(pa)[::-1][:3]
        np.testing.assert_array_equal(
            np.asarray(r.table.payloads)[: int(r.count)], want
        )


class TestJoinOutputValidity:
    """A materialized join's validity lives in its prefix_count; every
    downstream consumer must fold it in (ADVICE r4 high: .mask alone turns
    the join's zero-padding tail into real rows)."""

    def _ab(self):
        # build: unique keys; probe: 3 matches out of 5, so the join
        # output has a 2-row zero-padding tail (keys 0, payloads 0)
        a = _t([1, 2, 3], [10, 20, 30])
        b = _t([1, 2, 9, 9, 3], [2, 3, 4, 5, 7])
        return a, b

    def test_join_then_filter_count(self):
        a, b = self._ab()
        # predicate accepts payload 0 → buggy code counts padding rows
        q = scan(b).join(scan(a)).filter(lambda k, p: p % 2 == 0)
        # true joined rows (probe payload carried): 2, 3, 7 → only 2 even
        assert q.count() == 1

    def test_join_then_filter_execute_compacts(self):
        a, b = self._ab()
        r = (
            scan(b).join(scan(a))
            .filter(lambda k, p: p % 2 == 0).execute()
        )
        assert isinstance(r, TableResult)
        assert int(r.count) == 1
        assert np.asarray(r.table.keys)[0] == 1
        assert np.asarray(r.table.payloads)[0] == 2

    def test_join_into_join_no_phantom_matches(self):
        a, b = self._ab()
        # second build side's only key is 0 = the padding key: every
        # padding row would phantom-match
        c = _t([0], [5])
        q = scan(b).join(scan(a)).join(scan(c))
        assert q.count() == 0
        out = scan(b).join(scan(a)).join(scan(c)).execute()
        assert int(out.count) == 0
        # and a build side that matches a REAL joined key still works
        d = _t([3], [8])
        q2 = scan(b).join(scan(a)).join(scan(d))
        assert q2.count() == 1
        out2 = q2.execute()
        assert int(out2.count) == 1
        assert np.asarray(out2.keys)[0] == 3

    def test_join_as_build_side(self):
        a, b = self._ab()
        # join output as the BUILD side: padding key 0 must not match
        # probe rows with key 0
        p = _t([0, 0, 1], [1, 2, 3])
        q = scan(p).join(scan(b).join(scan(a)))
        assert q.count() == 1  # only the key-1 probe row

    def test_join_then_group_by(self):
        a, b = self._ab()
        g = scan(b).join(scan(a)).group_by().execute()
        got = _group_dict(g)
        want = _np_group(
            np.asarray([1, 2, 3]), np.asarray([2, 3, 7])
        )
        assert got == want

    def test_join_then_filter_group_by(self):
        a, b = self._ab()
        # staged filter+group_by path with a join child: padding rows
        # (key 0, payload 0) pass the predicate and must still drop
        g = (
            scan(b).join(scan(a))
            .filter(lambda k, p: p % 2 != 0).group_by().execute()
        )
        got = _group_dict(g)
        want = _np_group(np.asarray([2, 3]), np.asarray([3, 7]))
        assert got == want

    def test_join_then_order_by_limit(self):
        a, b = self._ab()
        # ascending by payload: padding zeros would win the top slots
        r = (
            scan(b).join(scan(a))
            .order_by("payload", descending=False).limit(2).execute()
        )
        assert int(r.count) == 2
        np.testing.assert_array_equal(
            np.asarray(r.table.payloads), np.asarray([2, 3])
        )


class TestGroupBy:
    def test_scan_group_by(self):
        a, b, _ = _rand_tables(19)
        g = scan(b).group_by(with_distinct=True).execute()
        want = _np_group(
            np.asarray(b.keys), np.asarray(b.payloads), with_distinct=True
        )
        got = _group_dict(g, with_distinct=True)
        assert got == want

    def test_filter_group_by_staged(self):
        a, b, _ = _rand_tables(23)
        pred = lambda k, p: p > 0
        g = scan(b).filter(pred).group_by().execute()
        sel = np.asarray(pred(b.keys, b.payloads))
        want = _np_group(
            np.asarray(b.keys)[sel], np.asarray(b.payloads)[sel]
        )
        assert _group_dict(g) == want

    def test_join_group_by_staged_filter_kernel(self):
        # R7 = R5∘R3: filtered join→GROUP BY stages the scatter
        # compaction, re-keys invalid build rows to the sentinel, and
        # runs the two-run pipeline on the survivors — exact vs numpy
        rng = np.random.default_rng(77)
        n_a, n_b = 2048, 8192
        a = _t(rng.integers(0, 4000, n_a), rng.integers(0, 100, n_a))
        b = _t(rng.integers(0, 5000, n_b), rng.integers(-100, 100, n_b))
        bp = lambda k, p: p % 2 == 0
        ap = lambda k, p: p != 7
        q = scan(b).filter(bp).join(scan(a).filter(ap)).group_by()
        plan = q.explain()
        assert "R7" in plan and "staged" in plan
        g = q.execute()  # staged two-run path
        # oracle from numpy
        ak = np.unique(
            np.asarray(a.keys)[np.asarray(ap(a.keys, a.payloads))]
        )
        sel = np.asarray(bp(b.keys, b.payloads)) & np.isin(
            np.asarray(b.keys), ak
        )
        want = _np_group(
            np.asarray(b.keys)[sel], np.asarray(b.payloads)[sel]
        )
        assert _group_dict(g) == want

    def test_join_group_by_staged_sentinel_fallback(self):
        # INT32_MAX present in a key column: the staged plan must fall
        # back to the typed path at runtime and stay exact
        rng = np.random.default_rng(79)
        n_a, n_b = 2048, 8192
        ak = rng.integers(0, 50, n_a).astype(np.int32)
        ak[0] = np.iinfo(np.int32).max
        bk = rng.integers(0, 60, n_b).astype(np.int32)
        bk[:16] = np.iinfo(np.int32).max  # matching probe rows too
        a = _t(ak, rng.integers(0, 100, n_a))
        b = _t(bk, rng.integers(-100, 100, n_b))
        bp = lambda k, p: p % 2 == 0
        q = scan(b).filter(bp).join(scan(a)).group_by()
        g = q.execute()
        sel = np.asarray(bp(b.keys, b.payloads)) & np.isin(
            bk, np.unique(ak)
        )
        want = _np_group(bk[sel], np.asarray(b.payloads)[sel])
        assert _group_dict(g) == want
        assert any(
            int(k) == np.iinfo(np.int32).max for k in want
        ), "test must exercise a genuine INT32_MAX group"

    def test_join_group_by_typed_path(self):
        # probe-side filter forces the typed materializer path
        a, b, _ = _rand_tables(29, n_a=40, n_b=300, key_hi=30)
        pred = lambda k, p: p != 0
        g = (
            scan(b).filter(pred).join(scan(a), carry="probe")
            .group_by().execute()
        )
        ak = set(np.asarray(a.keys).tolist())
        sel = np.asarray(pred(b.keys, b.payloads))
        keys = np.asarray(b.keys)[sel]
        pays = np.asarray(b.payloads)[sel]
        m = np.isin(keys, list(ak))
        want = _np_group(keys[m], pays[m])
        assert _group_dict(g) == want

    def test_join_group_by_kernel_path_interpret(self):
        """R3: the two-run materializer + aggregate_sorted plan."""
        rng = np.random.default_rng(58)
        a = _t(np.arange(1, 101), np.arange(1, 101) * 2)
        b = _t(
            rng.integers(1, 131, 3000), rng.integers(-50, 50, 3000)
        )
        q = scan(b).join(scan(a)).group_by()
        text = q.explain()
        assert "R3" in text and "aggregate_sorted" in text
        g = q.execute()
        bk, bp = np.asarray(b.keys), np.asarray(b.payloads)
        m = bk <= 100
        want = _np_group(bk[m], bp[m])
        assert _group_dict(g) == want

    def test_group_order_limit(self):
        a, b, _ = _rand_tables(31, n_b=500, key_hi=25)
        q = scan(b).group_by()
        want = _np_group(np.asarray(b.keys), np.asarray(b.payloads))
        # top-3 by count desc (lax.top_k fast path)
        top = q.order_by("count", descending=True).limit(3).execute()
        assert int(top.num_groups) == 3
        counts = sorted((c for c, *_ in want.values()), reverse=True)[:3]
        assert np.asarray(top.count)[:3].tolist() == counts
        # ascending sum (validity-dominant sort path), all groups
        asc = q.order_by("sum").execute()
        n = int(asc.num_groups)
        sums = np.asarray(asc.sum)[:n]
        assert sums.tolist() == sorted(s for _, s, _, _ in want.values())
        # order by min, limit beyond group count clamps
        k = len(want) + 5
        lim = q.order_by("min", descending=True).limit(k).execute()
        assert int(lim.num_groups) == len(want)

    def test_group_top_k_truncation_guard(self):
        """Rows past num_groups must never be selected, whatever their
        content."""
        from partitionedhashjoin_tpu.ops.aggregate import GroupByResult

        g = GroupByResult(
            keys=jnp.asarray([5, 9, 1234], jnp.int32),
            count=jnp.asarray([2, 1, 999], jnp.int32),
            sum=jnp.asarray([10, 20, 888], jnp.int32),
            min=jnp.asarray([1, 2, -999], jnp.int32),
            max=jnp.asarray([9, 20, 999], jnp.int32),
            num_groups=jnp.asarray(2, jnp.int32),
            group_of_row=jnp.zeros((3,), jnp.int32),
        )
        top = group_top_k(g, 3, by="count", descending=True)
        assert int(top.num_groups) == 2
        assert np.asarray(top.count)[:2].tolist() == [2, 1]
        assert np.asarray(top.count)[2] == 0
        low = group_top_k(g, 2, by="min", descending=False)
        assert np.asarray(low.min)[:2].tolist() == [1, 2]

    def test_count_terminal_on_groups(self):
        a, b, _ = _rand_tables(37)
        want = len(_np_group(np.asarray(b.keys), np.asarray(b.payloads)))
        assert scan(b).group_by().count() == want
        assert scan(b).group_by().limit(3).count() == 3


class TestMesh:
    @pytest.fixture(scope="class")
    def mesh(self):
        from partitionedhashjoin_tpu.parallel.mesh import make_mesh

        return make_mesh(8)

    def test_mesh_filter_group_by(self, mesh):
        rng = np.random.default_rng(41)
        b = _t(rng.integers(0, 30, 640), rng.integers(-99, 99, 640))
        pred = lambda k, p: p % 2 == 0
        q = scan(b).filter(pred).group_by()
        g = q.execute(mesh=mesh)
        sel = np.asarray(pred(b.keys, b.payloads))
        want = _np_group(
            np.asarray(b.keys)[sel], np.asarray(b.payloads)[sel]
        )
        assert _group_dict(g) == want
        # group-stage tail runs on the replicated result
        top = q.order_by("count", descending=True).limit(2).execute(
            mesh=mesh
        )
        counts = sorted((c for c, *_ in want.values()), reverse=True)[:2]
        assert np.asarray(top.count)[:2].tolist() == counts

    def test_mesh_group_by_having(self, mesh):
        # HAVING folds into the selection over the REPLICATED distributed
        # group result — same mask machinery as single-device (round 5)
        rng = np.random.default_rng(43)
        b = _t(rng.integers(0, 25, 640), rng.integers(-99, 99, 640))
        g = (
            scan(b).group_by().having(lambda g: g.count > 30)
            .execute(mesh=mesh)
        )
        want = {
            k: v
            for k, v in _np_group(
                np.asarray(b.keys), np.asarray(b.payloads)
            ).items()
            if v[0] > 30
        }
        assert len(want) > 0 and _group_dict(g) == want
        # and through the SQL surface with an order/limit tail
        from partitionedhashjoin_tpu.sql import execute_sql

        r = execute_sql(
            "SELECT key, COUNT(*) FROM b GROUP BY key "
            "HAVING COUNT(*) > 30 ORDER BY count DESC LIMIT 3",
            {"b": b}, mesh=mesh,
        )
        counts = sorted((c for c, *_ in want.values()), reverse=True)[:3]
        assert r.columns["count"].tolist() == counts

    def test_mesh_join_count(self, mesh):
        rng = np.random.default_rng(43)
        a = _t(rng.integers(0, 50, 64), rng.integers(1, 9, 64))
        b = _t(rng.integers(0, 60, 512), rng.integers(1, 9, 512))
        ak = set(np.asarray(a.keys).tolist())
        want = int(sum(1 for k in np.asarray(b.keys).tolist() if k in ak))
        assert scan(b).join(scan(a)).count(mesh=mesh) == want

    def test_mesh_join_count_filtered(self, mesh):
        # filters push down into the exchange bucketizer (R2 + R6):
        # the distributed count equals the single-device masked count
        rng = np.random.default_rng(59)
        a = _t(rng.integers(0, 50, 64), rng.integers(1, 9, 64))
        b = _t(rng.integers(0, 60, 512), rng.integers(-9, 9, 512))
        bp = lambda k, p: p % 2 == 0
        ap = lambda k, p: p > 3
        q = scan(b).filter(bp).join(scan(a).filter(ap))
        ak = set(
            np.asarray(a.keys)[np.asarray(ap(a.keys, a.payloads))].tolist()
        )
        sel = np.asarray(bp(b.keys, b.payloads))
        want = int(
            sum(1 for k in np.asarray(b.keys)[sel].tolist() if k in ak)
        )
        assert q.count(mesh=mesh) == want == q.count()

    def test_mesh_top_k(self, mesh):
        rng = np.random.default_rng(47)
        b = _t(rng.integers(0, 10**6, 512), rng.integers(0, 99, 512))
        r = scan(b).order_by("key", descending=True).limit(5).execute(
            mesh=mesh
        )
        want = np.sort(np.asarray(b.keys))[::-1][:5]
        np.testing.assert_array_equal(np.asarray(r.table.keys), want)

    def test_mesh_top_k_filtered(self, mesh):
        # filter pushes into the distributed top-k as a validity mask;
        # the live count reflects the survivors (R2 + R4 + R6)
        rng = np.random.default_rng(48)
        b = _t(rng.integers(0, 10**6, 512), rng.integers(0, 99, 512))
        pred = lambda k, p: p < 50
        q = scan(b).filter(pred).order_by("key", descending=True).limit(5)
        assert "validity mask" in q.explain(mesh=mesh)
        r = q.execute(mesh=mesh)
        sel = np.asarray(pred(b.keys, b.payloads))
        want = np.sort(np.asarray(b.keys)[sel])[::-1][:5]
        assert int(r.count) == 5
        np.testing.assert_array_equal(np.asarray(r.table.keys), want)
        # survivors < k: live prefix shrinks
        q2 = (
            scan(b).filter(lambda k, p: p == 7)
            .order_by("key", descending=True).limit(5)
        )
        r2 = q2.execute(mesh=mesh)
        sel2 = np.asarray(b.payloads) == 7
        n2 = min(5, int(sel2.sum()))
        assert int(r2.count) == n2
        np.testing.assert_array_equal(
            np.asarray(r2.table.keys)[:n2],
            np.sort(np.asarray(b.keys)[sel2])[::-1][:n2],
        )

    def test_mesh_join_group_by(self, mesh):
        rng = np.random.default_rng(53)
        a = _t(rng.integers(0, 40, 64), rng.integers(1, 9, 64))
        b = _t(rng.integers(0, 60, 512), rng.integers(-99, 99, 512))
        q = scan(b).join(scan(a)).group_by()
        assert "one shuffle" in q.explain(mesh=mesh)
        g = q.execute(mesh=mesh)
        ak = set(np.asarray(a.keys).tolist())
        sel = np.isin(np.asarray(b.keys), list(ak))
        want = _np_group(
            np.asarray(b.keys)[sel], np.asarray(b.payloads)[sel]
        )
        assert _group_dict(g) == want
        # group-stage tail runs on the replicated result
        top = q.order_by("count", descending=True).limit(3).execute(
            mesh=mesh
        )
        counts = sorted((c for c, *_ in want.values()), reverse=True)[:3]
        assert np.asarray(top.count)[:3].tolist() == counts

    def test_mesh_join_group_by_filtered(self, mesh):
        # both-side filters ride the one-shuffle join->GROUP BY as
        # validity masks: invalid rows never travel, never go hot, and
        # never register build membership (R2 + R3 + R6)
        rng = np.random.default_rng(61)
        a = _t(rng.integers(0, 40, 64), rng.integers(1, 9, 64))
        b = _t(rng.integers(0, 60, 512), rng.integers(-99, 99, 512))
        ap = lambda k, p: p != 4
        bp = lambda k, p: p % 3 != 0
        q = scan(b).filter(bp).join(scan(a).filter(ap)).group_by()
        assert "filters pushed" in q.explain(mesh=mesh)
        g = q.execute(mesh=mesh)
        ak = set(
            np.asarray(a.keys)[np.asarray(ap(a.keys, a.payloads))].tolist()
        )
        sel = np.asarray(bp(b.keys, b.payloads)) & np.isin(
            np.asarray(b.keys), list(ak)
        )
        want = _np_group(
            np.asarray(b.keys)[sel], np.asarray(b.payloads)[sel]
        )
        assert _group_dict(g) == want
        # identical to the single-device composed plan
        g1 = q.execute()
        assert _group_dict(g1) == want

    @pytest.mark.parametrize("jt", ["inner", "semi", "anti", "left"])
    def test_mesh_join_materialize(self, mesh, jt):
        # distributed materializing join: row multiset equals the
        # single-device typed materializer (payload_a omitted — with
        # duplicate build keys the first-match choice is impl-defined)
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        rng = np.random.default_rng(67)
        a = _t(rng.integers(0, 40, 64), rng.integers(1, 9, 64))
        b = _t(rng.integers(0, 60, 512), rng.integers(-99, 99, 512))
        bp = lambda k, p: p % 2 == 0
        pp = lambda k, p: p > -50
        q = scan(b).filter(pp).join(scan(a).filter(bp), join_type=jt)
        out = q.execute(mesh=mesh)
        assert isinstance(out, JoinedTable)
        keys, _pa, pb, matched, count = sort_merge_materialize_typed(
            a.keys, a.payloads, b.keys, b.payloads, jt,
            build_valid=bp(a.keys, a.payloads),
            probe_valid=pp(b.keys, b.payloads),
        )
        n = int(count)
        assert int(out.count) == n

        def rows(k, p, m, c):
            return sorted(
                zip(
                    np.asarray(k)[:c].tolist(),
                    np.asarray(p)[:c].tolist(),
                    np.asarray(m)[:c].tolist(),
                )
            )

        assert rows(out.keys, out.payloads_b, out.matched, n) == rows(
            keys, pb, matched, n
        )

    def test_mesh_join_order_by_limit(self, mesh):
        # join tail: order/limit runs locally over the gathered
        # replicated join output; matches the single-device plan
        rng = np.random.default_rng(69)
        a = _t(rng.integers(0, 40, 64), rng.integers(1, 9, 64))
        b = _t(rng.integers(0, 60, 512), rng.integers(-99, 99, 512))
        q = (
            scan(b).join(scan(a))
            .order_by("payload", descending=True).limit(4)
        )
        r = q.execute(mesh=mesh)
        r1 = q.execute()
        assert int(r.count) == int(r1.count)
        np.testing.assert_array_equal(
            np.asarray(r.table.payloads), np.asarray(r1.table.payloads)
        )
        # limit-without-order: the live count caps at the joined-row
        # prefix, not at k (regression: run_head ignored prefix_count)
        one = _t([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8])
        tiny = _t([1, 0, 0, 0, 0, 0, 0, 0], [5, 0, 0, 0, 0, 0, 0, 0])
        qh = scan(tiny).join(scan(one)).limit(5)
        for res in (qh.execute(), qh.execute(mesh=mesh)):
            assert int(res.count) == 1

    def test_mesh_unsupported_shapes_raise(self, mesh):
        t = _t([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8])
        with pytest.raises(PlanError):  # carry="build" stays single-device
            scan(t).join(scan(t), carry="build").group_by().execute(
                mesh=mesh
            )
        with pytest.raises(PlanError):  # join-of-join side stays local
            scan(t).join(
                scan(t).join(scan(t), carry="probe")
            ).group_by().execute(mesh=mesh)
        with pytest.raises(PlanError):  # non-inner join type
            scan(t).join(scan(t), join_type="left").group_by().execute(
                mesh=mesh
            )
        with pytest.raises(PlanError):  # full join stays single-device
            scan(t).join(scan(t), join_type="full").execute(mesh=mesh)
        with pytest.raises(PlanError):  # hot probe rows stay sharded
            scan(t).join(scan(t)).group_by(
                with_distinct=True
            ).execute(mesh=mesh)

    def test_mesh_group_by_distinct(self, mesh):
        # exact distributed COUNT DISTINCT via the row-exchange plan
        rng = np.random.default_rng(71)
        b = _t(rng.integers(0, 20, 640), rng.integers(0, 7, 640))
        q = scan(b).group_by(with_distinct=True)
        assert "row-exchange" in q.explain(mesh=mesh)
        g = q.execute(mesh=mesh)
        g1 = q.execute()
        n, n1 = int(g.num_groups), int(g1.num_groups)
        assert n == n1
        want = {
            int(k): int(d)
            for k, d in zip(
                np.asarray(g1.keys)[:n1], np.asarray(g1.distinct)[:n1]
            )
        }
        got = {
            int(k): int(d)
            for k, d in zip(
                np.asarray(g.keys)[:n], np.asarray(g.distinct)[:n]
            )
        }
        assert got == want


class TestExplain:
    def test_explain_mentions_rules(self):
        a, b, _ = _rand_tables(53)
        q = (
            scan(b).filter(lambda k, p: p > 0).join(scan(a))
            .group_by().order_by("count", descending=True).limit(10)
        )
        text = q.explain()
        assert text.splitlines()[0].startswith("physical plan")
        assert "R2" in text  # filter as mask
        assert "R4" in text  # top-k over groups
        q2 = scan(b).filter(lambda k, p: p > 0).group_by()
        assert "R5" in q2.explain()

    def test_explain_does_not_execute(self):
        boom = lambda k, p: (_ for _ in ()).throw(RuntimeError("no"))
        t = _t([1], [2])
        # predicate must not run during planning
        text = scan(t).filter(boom).group_by().explain()
        assert "filter" in text
