"""Every main-path program lowers for the CUDA target.

``jax.export(jax.jit(f), platforms=["cuda"])`` runs the whole
JAX → StableHLO lowering for the GPU on a CPU host, where a primitive or
layout that has no CUDA lowering surfaces.  XLA:GPU's compiler itself runs
only on the card (``chip_smoke.py``), so these tests are the CPU-side half
of that check: each case is a jitted program the engine dispatches on its
main path, at small static shapes.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax import export

from partitionedhashjoin_tpu.ops import aggregate as agg
from partitionedhashjoin_tpu.ops import filter as filt
from partitionedhashjoin_tpu.ops import generators as gen
from partitionedhashjoin_tpu.ops import hash_table as ht
from partitionedhashjoin_tpu.ops import merge_join as mj
from partitionedhashjoin_tpu.ops import multi_key as mk
from partitionedhashjoin_tpu.ops import order_by as ob
from partitionedhashjoin_tpu.ops import planner as pl
from partitionedhashjoin_tpu.ops import radix_cluster as rc
from partitionedhashjoin_tpu.ops import sort_merge as sm

S = jax.ShapeDtypeStruct
NA, NB = 1024, 8192
I32, I64, B = jnp.int32, jnp.int64, jnp.bool_
A = S((NA,), I32)
Bk = S((NB,), I32)
A64, B64 = S((NA,), I64), S((NB,), I64)
VA, VB = S((NA,), B), S((NB,), B)
SCALAR_B = S((), B)
SEED = S((), jnp.uint32)


#: the one foreign call target the main path may hold: the windowed
#: Triton probe (ops/windowed_probe.py) behind merge_join.sorted_runs_count
TRITON = "__gpu$xla.gpu.triton"


def _lower(fn, *args):
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(TRITON)],
    )(*args)
    assert exp.platforms == ("cuda",)
    assert len(exp.mlir_module_serialized) > 0
    return exp


def _composed_sql_top10(bk, bp, ak, ap):
    """The device steps of SELECT key, COUNT(*), SUM(b.payload) FROM b
    JOIN a USING (key) GROUP BY key ORDER BY count DESC LIMIT 10: the
    two-run materializer (payload-ordered runs), the presorted GROUP BY and
    the count top-k."""
    from partitionedhashjoin_tpu.query import group_top_k

    keys, _, pb, hit, count = mj._materialize_i32(
        ak, ap, bk, bp, probe_payload_sorted=True
    )
    g = agg._sort_group_and_aggregate(
        keys, pb, 256, valid=jnp.arange(keys.shape[0]) < count,
        has_valid=True, scatter_compaction=True, presorted=True,
    )
    return group_top_k(g, 10)


def _chained_join(ak, bk, seed):
    table = ht.build_chained(ak, seed, ht.chained_num_buckets(NA))
    return ht.probe_chained_count(table, bk)


def _radix_vmem(ak, bk):
    a_s = jax.lax.sort((ak,), num_keys=1, is_stable=False)[0]
    b_s = jax.lax.sort((bk,), num_keys=1, is_stable=False)[0]
    return mj.sorted_runs_count(a_s, b_s)


def _planner_two_run(ak, bk):
    a_s = pl._sort_build(ak)
    lo, hi, covered = pl._sorted_stats(a_s)
    return mj.sorted_runs_count(a_s, jnp.sort(bk)), lo, hi, covered


# (id, fn, args, needs x64)
CASES = [
    ("sort_merge_count_i32", sm.sort_merge_count, (A, Bk), False),
    ("sort_merge_count_i64", sm.sort_merge_count, (A64, B64), True),
    ("sort_merge_count_masked",
     lambda a, b, va, vb: sm.sort_merge_count(a, b, va, vb),
     (A, Bk, VA, VB), False),
    ("sort_merge_count_all", sm.sort_merge_count_all, (A, Bk), False),
    ("two_run_prepare_build",
     functools.partial(mj._prepare_build_i32, has_valid=False), (A,), False),
    ("two_run_prepare_build_masked",
     lambda a, v: mj._prepare_build_i32(a, v, has_valid=True),
     (A, VA), False),
    ("two_run_probe",
     functools.partial(mj._probe_prepared_i32, has_valid=False),
     (A, SCALAR_B, Bk), False),
    ("two_run_probe_masked",
     lambda a, m, b, v: mj._probe_prepared_i32(a, m, b, v, has_valid=True),
     (A, SCALAR_B, Bk, VB), False),
    ("prepared_build_probe_i64",
     lambda a, b: mj.sorted_runs_count(a, jnp.sort(b)), (A64, B64), True),
    ("sorted_runs_count_i32", mj.sorted_runs_count, (A, Bk), False),
    ("sorted_runs_count_unsorted_probe", mj.sorted_runs_count, (A, Bk),
     False),
    ("two_run_count_i64", mj._count_i64, (A64, B64), True),
    ("materialize_key_order", mj._materialize_i32, (A, A, Bk, Bk), False),
    ("materialize_key_order_payload_sorted",
     functools.partial(mj._materialize_i32, probe_payload_sorted=True),
     (A, A, Bk, Bk), False),
    ("materialize_compact_hits", mj._compact_hits, (Bk, Bk, Bk, VB), False),
    ("materialize_probe_order_inner",
     lambda a, pa, b, pb: sm._materialize_typed(a, pa, b, pb, "inner"),
     (A, A, Bk, Bk), False),
    ("materialize_probe_order_semi",
     lambda a, pa, b, pb: sm._materialize_typed(a, pa, b, pb, "semi"),
     (A, A, Bk, Bk), False),
    ("materialize_probe_order_anti",
     lambda a, pa, b, pb: sm._materialize_typed(a, pa, b, pb, "anti"),
     (A, A, Bk, Bk), False),
    ("materialize_probe_order_left",
     lambda a, pa, b, pb: sm._materialize_typed(a, pa, b, pb, "left"),
     (A, A, Bk, Bk), False),
    ("materialize_probe_order_full",
     lambda a, pa, b, pb: sm._materialize_typed(a, pa, b, pb, "full"),
     (A, A, Bk, Bk), False),
    ("materialize_probe_order_masked",
     lambda a, pa, b, pb, va, vb: sm._materialize_typed(
         a, pa, b, pb, "inner", build_valid=va, probe_valid=vb),
     (A, A, Bk, Bk, VA, VB), False),
    ("materialize_probe_order_i64",
     lambda a, pa, b, pb: sm._materialize_typed(a, pa, b, pb, "inner"),
     (A64, A, B64, Bk), True),
    ("chained_mode_join", _chained_join, (A, Bk, SEED), False),
    ("radix_chained_partition",
     lambda a, b, s: rc._partition_both(a, b, s, 16), (A, Bk, SEED), False),
    ("radix_vmem_mode_join", _radix_vmem, (A, Bk), False),
    ("planner_stats_and_two_run", _planner_two_run, (A, Bk), False),
    ("planner_interval", pl._interval_count, (Bk, S((), I32), S((), I32)),
     False),
    ("group_by_sort_compaction",
     lambda k, p: agg._sort_group_and_aggregate(k, p, 512),
     (Bk, Bk), False),
    ("group_by_scatter_compaction",
     lambda k, p: agg._sort_group_and_aggregate(
         k, p, 512, scatter_compaction=True), (Bk, Bk), False),
    ("group_by_distinct_sort",
     lambda k, p: agg._sort_group_and_aggregate(
         k, p, 512, with_distinct=True), (Bk, Bk), False),
    ("group_by_distinct_scatter",
     lambda k, p: agg._sort_group_and_aggregate(
         k, p, 512, scatter_compaction=True, with_distinct=True),
     (Bk, Bk), False),
    ("group_by_group_of_row",
     lambda k, p: agg._sort_group_and_aggregate(
         k, p, 512, with_group_of_row=True), (Bk, Bk), False),
    ("group_by_fused_filter",
     lambda k, p, v: agg._sort_group_and_aggregate(
         k, p, 512, valid=v, has_valid=True, scatter_compaction=True),
     (Bk, Bk, VB), False),
    ("group_by_i64_payloads",
     lambda k, p: agg._sort_group_and_aggregate(
         k, p, 512, scatter_compaction=True), (Bk, B64), True),
    ("aggregate_sorted_scatter",
     lambda k, p, n: agg._aggregate_sorted_impl(
         k, p, 512, n, has_nvalid=True, scatter_compaction=True),
     (Bk, Bk, S((), I32)), False),
    ("aggregate_sorted_sort",
     lambda k, p, n: agg._aggregate_sorted_impl(
         k, p, 512, n, has_nvalid=True), (Bk, Bk, S((), I32)), False),
    ("staged_filter_compaction",
     lambda m, k, p: filt.compact(m, k, p), (VB, Bk, Bk), False),
    ("staged_group_by_pass2",
     lambda t, k, p: agg._staged_pass2(
         t, k, p, NB, NB // 2, 256, scatter_compaction=True,
         with_distinct=True), (S((), I32), Bk, Bk), False),
    ("compact_capacity",
     lambda m, c: filt.compact(m, c, capacity=100), (VB, Bk), False),
    ("compact_sort", filt.compact_sort, (VB, Bk, Bk), False),
    ("hash_group_by",
     lambda k, p, s: agg._group_and_aggregate(
         k, p, s, ht.table_size_for(NB)), (Bk, Bk, SEED), False),
    ("top_k", lambda k, p: ob._top_k(k, p, 10, "key", True), (Bk, Bk),
     False),
    ("sql_composed_plan", _composed_sql_top10, (Bk, Bk, A, A), False),
    ("multi_key_count",
     lambda a0, a1, b0, b1: mk._multi_key_count_xla((a0, a1), (b0, b1)),
     (A, A, Bk, Bk), False),
    ("multi_key_count_all",
     lambda a0, a1, b0, b1: mk._multi_key_count_all_xla((a0, a1), (b0, b1)),
     (A, A, Bk, Bk), False),
    ("zipf_sampler_round",
     lambda key: gen._zipf_round(key, NB, 1.05, NA),
     (S((2,), jnp.uint32),), False),
    ("zipf_alias_sampler",
     lambda key, prob, alias: gen.zipf_keys_alias(key, NB, prob, alias),
     (S((2,), jnp.uint32), S((NA,), jnp.float32), A), False),
]


@pytest.mark.parametrize(
    "fn,args,x64", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
)
def test_lowers_for_cuda(fn, args, x64):
    with jax.enable_x64(x64):
        _lower(fn, *args)


def test_plain_programs_have_no_custom_calls():
    """The main path is plain XLA: the only custom calls are XLA's own
    (``mhlo.topk``), never a foreign kernel target."""
    import re

    exp = _lower(_composed_sql_top10, Bk, Bk, A, A)
    targets = set(re.findall(r"custom_call @([\w.]+)", exp.mlir_module()))
    assert targets <= {"mhlo.topk"}, targets


def test_shuffle_local_join_lowers_on_a_four_device_mesh():
    from partitionedhashjoin_tpu.parallel import shuffle as sh
    from partitionedhashjoin_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    n = 4 * 256
    args = (S((n,), I32), S((n,), B)) * 2 + (
        S((n,), I32), S((n,), B), S((64,), I32), S((64,), B),
        S((64,), I32), S((64,), B),
    )
    exp = export.export(
        jax.jit(functools.partial(
            sh._sort_merge_local_count, mesh, use_hot=True
        )),
        platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(TRITON)],
    )(*args)
    assert len(exp.mlir_module_serialized) > 0
