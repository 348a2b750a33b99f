"""Windowed Triton probe (ops/windowed_probe.py) in interpret mode, and the
GPU route of the two-run count that dispatches to it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import export

from partitionedhashjoin_tpu.ops import merge_join
from partitionedhashjoin_tpu.ops.windowed_probe import BLOCK, windowed_count

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _count(a, b):
    a = np.sort(np.asarray(a, np.int32))
    b = np.sort(np.asarray(b, np.int32))
    got = int(windowed_count(jnp.asarray(a), jnp.asarray(b), interpret=True))
    assert got == int(np.isin(b, a).sum())
    return got


@pytest.mark.parametrize("dom", [40, 5000, 2**31 - 1])
def test_random_counts_match_numpy(dom):
    rng = np.random.default_rng(dom)
    a = rng.integers(-dom, dom, 2000, dtype=np.int64).astype(np.int32)
    b = rng.integers(-dom, dom, 9000, dtype=np.int64).astype(np.int32)
    b[:3000] = rng.choice(a, 3000)
    _count(a, b)


@pytest.mark.parametrize("n_b", [1, BLOCK - 1, BLOCK, 3 * BLOCK + 37])
def test_partial_last_block(n_b):
    rng = np.random.default_rng(n_b)
    a = rng.integers(0, 300, 700).astype(np.int32)
    b = rng.integers(-10, 310, n_b).astype(np.int32)
    _count(a, b)


def test_full_domain_edges_and_duplicates():
    a = [I32_MAX, I32_MAX, 5, I32_MIN, -7, 5, 5]
    b = [I32_MAX, 5, 6, I32_MAX, -7, I32_MIN, I32_MIN, 4]
    assert _count(a, b) == 6
    assert _count([5, -7], [I32_MAX, 5]) == 1


def test_hot_key_run_spanning_many_blocks():
    a = np.concatenate([np.full(5000, 9, np.int32), np.arange(20, 40)])
    b = np.concatenate([np.full(3 * BLOCK, 9, np.int32), np.arange(0, 50)])
    _count(a, b)


def test_empty_sides():
    z = jnp.zeros((0,), jnp.int32)
    some = jnp.arange(5, dtype=jnp.int32)
    assert int(windowed_count(z, some, interpret=True)) == 0
    assert int(windowed_count(some, z, interpret=True)) == 0


def test_sorted_runs_count_takes_the_plain_search_off_the_gpu():
    # the CPU executes the default branch; both branches agree
    rng = np.random.default_rng(2)
    a = np.sort(rng.integers(0, 500, 300).astype(np.int32))
    b = np.sort(rng.integers(-20, 520, 4000).astype(np.int32))
    want = int(np.isin(b, a).sum())
    assert int(merge_join.sorted_runs_count(jnp.asarray(a), jnp.asarray(b))) \
        == want
    assert _count(a, b) == want


def test_gpu_route_lowers_to_the_triton_kernel():
    S = jax.ShapeDtypeStruct
    exp = export.export(
        merge_join.sorted_runs_count,
        platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(S((10_000,), jnp.int32), S((100_000,), jnp.int32))
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert "windowed_probe_count" in text
