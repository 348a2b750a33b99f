"""Composite-key (multi-column) join counts — ops/multi_key.py.

Oracles are host-side Python set/Counter arithmetic over key TUPLES, so
any packing/hashing collision in the implementation would be caught.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from partitionedhashjoin_tpu.ops import multi_key

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _oracle_count(build_cols, probe_cols):
    build = set(zip(*[np.asarray(c).tolist() for c in build_cols]))
    probe = zip(*[np.asarray(c).tolist() for c in probe_cols])
    return sum(1 for t in probe if t in build)


def _oracle_count_all(build_cols, probe_cols):
    from collections import Counter

    mult = Counter(zip(*[np.asarray(c).tolist() for c in build_cols]))
    probe = zip(*[np.asarray(c).tolist() for c in probe_cols])
    return sum(mult[t] for t in probe)


def _random_cols(rng, k, n, lo=-50, hi=50):
    return [rng.integers(lo, hi, size=n).astype(np.int32) for _ in range(k)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_count_matches_oracle(k):
    rng = np.random.default_rng(100 + k)
    a = _random_cols(rng, k, 400)
    b = _random_cols(rng, k, 700)
    got = int(multi_key.multi_key_count(a, b))
    assert got == _oracle_count(a, b)


@pytest.mark.parametrize("k", [2, 3])
def test_count_all_matches_oracle(k):
    from partitionedhashjoin_tpu.utils import widesum

    rng = np.random.default_rng(200 + k)
    a = _random_cols(rng, k, 300, lo=-5, hi=5)  # heavy duplication
    b = _random_cols(rng, k, 500, lo=-5, hi=5)
    got = widesum.pair_to_int(multi_key.multi_key_count_all(a, b))
    assert got == _oracle_count_all(a, b)


def test_partial_tuple_matches_do_not_count():
    # rows agreeing on SOME columns but not all must not match — the bug a
    # packed/hashed composite key would show
    a = [np.array([1, 2, 3], np.int32), np.array([10, 20, 30], np.int32)]
    b = [np.array([1, 2, 3], np.int32), np.array([99, 20, 31], np.int32)]
    assert int(multi_key.multi_key_count(a, b)) == 1


def test_boundary_values_pair_kernel():
    # (MAX, MAX) is the kernel's padding tuple; genuine occurrences must
    # still count exactly (pad-correction path), as must MIN values
    a = [
        np.array([I32_MAX, I32_MAX, I32_MIN, 0], np.int32),
        np.array([I32_MAX, 5, I32_MIN, 0], np.int32),
    ]
    b = [
        np.array([I32_MAX, I32_MAX, I32_MAX, I32_MIN, 7], np.int32),
        np.array([I32_MAX, I32_MAX, 5, I32_MIN, 7], np.int32),
    ]
    got = int(multi_key.multi_key_count(a, b))
    assert got == _oracle_count(a, b)  # == 3


@pytest.mark.parametrize("k", [2, 3])
def test_kernel_and_xla_paths_agree(k):
    rng = np.random.default_rng(300 + k)
    a = _random_cols(rng, k, 3000, lo=0, hi=40)
    b = _random_cols(rng, k, 5000, lo=0, hi=40)
    xla = int(multi_key._multi_key_count_xla(tuple(map(jnp.asarray, a)),
                                             tuple(map(jnp.asarray, b))))
    api = int(multi_key.multi_key_count(a, b))
    assert api == xla == _oracle_count(a, b)


def test_empty_sides():
    e = [np.array([], np.int32), np.array([], np.int32)]
    a = [np.array([1], np.int32), np.array([2], np.int32)]
    assert int(multi_key.multi_key_count(e, a)) == 0
    assert int(multi_key.multi_key_count(a, e)) == 0
    from partitionedhashjoin_tpu.utils import widesum

    assert widesum.pair_to_int(multi_key.multi_key_count_all(a, e)) == 0


def test_validation_errors():
    a1 = np.array([1, 2], np.int32)
    with pytest.raises(TypeError):
        multi_key.multi_key_count([a1.astype(np.int64)], [a1])
    with pytest.raises(ValueError):
        multi_key.multi_key_count([a1, a1], [a1])  # k mismatch
    with pytest.raises(ValueError):
        multi_key.multi_key_count([], [])
    with pytest.raises(ValueError):
        multi_key.multi_key_count([a1, np.array([1], np.int32)], [a1, a1])


def test_int64_via_planes_recipe():
    # the documented 64-bit recipe: split_i64 planes as a 2-column key
    import jax

    rng = np.random.default_rng(7)
    a64 = (rng.integers(-(2**40), 2**40, size=500)).astype(np.int64)
    b64 = np.concatenate([a64[:200], (rng.integers(-(2**40), 2**40, size=300)).astype(np.int64)])
    with jax.enable_x64(True):
        ah, al = multi_key.split_i64(jnp.asarray(a64))
        bh, bl = multi_key.split_i64(jnp.asarray(b64))
        ah, al, bh, bl = map(np.asarray, (ah, al, bh, bl))
    got = int(multi_key.multi_key_count([ah, al], [bh, bl]))
    assert got == sum(1 for x in b64.tolist() if x in set(a64.tolist()))


def test_fuzz_small():
    rng = np.random.default_rng(42)
    for trial in range(8):
        k = int(rng.integers(1, 4))
        n_a = int(rng.integers(1, 80))
        n_b = int(rng.integers(1, 120))
        a = _random_cols(rng, k, n_a, lo=-6, hi=6)
        b = _random_cols(rng, k, n_b, lo=-6, hi=6)
        got = int(multi_key.multi_key_count(a, b))
        assert got == _oracle_count(a, b), (trial, k, n_a, n_b)
