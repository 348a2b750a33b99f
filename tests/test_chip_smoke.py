"""chip_smoke.py on the CPU: argument parsing, its oracles, and its refusal
to run (or to print a result) without a GPU or without the engine."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_parse_args_defaults_are_the_reference_workload():
    args = chip_smoke.parse_args([])
    assert (chip_smoke.PRIMARY, chip_smoke.SECONDARY, args.skew) == (
        10_000_000, 200_000_000, 1.05
    )
    assert not args.multi and chip_smoke.REPS >= 1


def test_parse_args_multi_uses_heavy_skew():
    assert chip_smoke.parse_args(["--multi"]).skew == 1.25
    with pytest.raises(SystemExit):  # the workload is fixed, not an option
        chip_smoke.parse_args(["--multi", "--skew", "1.05"])


def test_group_oracle_matches_brute_force():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, 3000)
    pays = np.sort(rng.choice(2**31 - 1, 3000, replace=False))
    g = chip_smoke.group_oracle(keys, pays)
    for i, k in enumerate(g["keys"]):
        sel = pays[keys == k]
        assert g["count"][i] == sel.size
        assert g["sum"][i] == np.int64(sel.sum()).astype(np.int32)
        assert g["min"][i] == sel.min() and g["max"][i] == sel.max()
    assert set(g["keys"].tolist()) == set(keys.tolist())


def test_group_oracle_needs_ascending_payloads():
    with pytest.raises(ValueError, match="ascending"):
        chip_smoke.group_oracle(np.array([1, 2]), np.array([5, 3]))


def test_top_k_oracle_flags_ties_at_the_cut():
    g = {"count": np.array([5, 9, 9, 1])}
    cut, tied = chip_smoke.top_k_oracle(g, 2)
    assert sorted(cut.tolist()) == [1, 2] and not tied
    cut, tied = chip_smoke.top_k_oracle(g, 1)
    assert tied


def test_join_oracle_matches_numpy():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 500, 300).astype(np.int32)
    b = rng.integers(-50, 600, 5000).astype(np.int32)
    assert chip_smoke.join_oracle(a, b) == int(np.isin(b, a).sum())
    with pytest.raises(ValueError, match="int32"):
        chip_smoke.join_oracle(np.array([2**40]), b)


def test_report_records_mismatches_and_failures(capsys):
    rep = chip_smoke.Report("card X, 700.00 W")
    assert rep.check("p", "equal", 3, 3)
    assert not rep.check("p", "differs", 3, 4)
    rep.fail("p", "raised", RuntimeError("boom"))
    rep.phase_done("p", 0.0)
    out = capsys.readouterr().out
    assert rep.failed == ["p/differs", "p/raised"]
    assert "PHASE p: FAILED 1/3" in out and "card X, 700.00 W" in out


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_refuses_without_a_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs 1 GPU" in r.stderr


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.chip
def test_flagship_count_on_the_gpu(gpu):
    import jax
    import jax.numpy as jnp

    from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

    a = jax.device_put(jnp.arange(1, 1025, dtype=jnp.int32), gpu)
    b = jax.device_put(jnp.arange(0, 4096, dtype=jnp.int32) % 2048, gpu)
    assert int(SortMergeJoiner.count(a, b)) == 2 * 1024
