"""merge_join.PreparedBuild: build once, probe many.

Contract: counts identical to two_run_count for every probe, with the
build-side sort paid exactly once.
"""

import jax
import jax.numpy as jnp
import numpy as np

from partitionedhashjoin_tpu.ops.merge_join import PreparedBuild, two_run_count

I32_MAX = np.iinfo(np.int32).max


def test_multiple_probes_one_build():
    rng = np.random.default_rng(0)
    build = rng.integers(-5000, 5000, 3000).astype(np.int32)
    pb = PreparedBuild(jnp.asarray(build))
    for trial in range(4):
        probe = rng.integers(-6000, 6000, 40000).astype(np.int32)
        want = int(np.isin(probe, build).sum())
        got = int(pb.count(jnp.asarray(probe)))
        ref = int(
            two_run_count(jnp.asarray(build), jnp.asarray(probe))
        )
        assert got == want == ref, trial


def test_validity_masks_and_int32_max():
    build = jnp.asarray([1, 2, I32_MAX, 7], jnp.int32)
    bvalid = jnp.asarray([True, False, True, True])
    pb = PreparedBuild(build, build_valid=bvalid)
    probe = jnp.asarray([1, 2, I32_MAX, 7, 9, I32_MAX], jnp.int32)
    pvalid = jnp.asarray([True, True, True, True, True, False])
    # valid build keys {1, INT32_MAX, 7}; valid probes matching: 1, MAX, 7
    assert int(pb.count(probe, probe_valid=pvalid)) == 3
    # unmasked probe: 1, MAX, 7, MAX
    assert int(pb.count(probe)) == 4


def test_int64_prepared():
    with jax.enable_x64(True):
        base = jnp.int64(1) << jnp.int64(35)
        build = base * jnp.asarray([1, 5, 9, 12], jnp.int64)
        pb = PreparedBuild(build)
        probe = base * jnp.asarray([1, 2, 5, 9, 9, 13], jnp.int64)
        assert int(pb.count(probe)) == 4


def test_empty_sides():
    pb = PreparedBuild(jnp.zeros((0,), jnp.int32))
    assert int(pb.count(jnp.asarray([1, 2], jnp.int32))) == 0
    pb2 = PreparedBuild(jnp.asarray([1, 2], jnp.int32))
    assert int(pb2.count(jnp.zeros((0,), jnp.int32))) == 0


def test_duplicate_heavy_build_reuse():
    # a duplicate run longer than any block of the old tiled probe
    CAP = 2048

    build = np.concatenate(
        [np.full(2 * CAP + 3, 50, np.int32),
         np.arange(100, 200, dtype=np.int32)]
    )
    pb = PreparedBuild(jnp.asarray(build))
    probe = np.asarray([49, 50, 51, 150, 250] * 500, np.int32)
    # matches per group of 5: 50 (the hot run) and 150 -> 2 * 500
    assert int(pb.count(jnp.asarray(probe))) == 2 * 500
