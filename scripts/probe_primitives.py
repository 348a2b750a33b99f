"""Primitive-cost probes: the per-primitive costs behind the engine's design
rules (CLAUDE.md "Design invariants").  Run on the GPU:

    python scripts/probe_primitives.py --section all
    python scripts/probe_primitives.py --section sort,gather   # subset

Sections:
    stream    dispatch overhead, streaming bandwidth
    sort      XLA sort variants (the flagship's dominant cost)
    gather    XLA gather / scatter / searchsorted
    hist      one-hot histograms, partition-by-sort

Timing method: jit + one warmup, then min-of-3 with a host readback of a
small checksum.  Unsupported forms print FAILED with the error head.
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

N_PROBE = 50_000_000
N_BUILD = 10_000_000


def timed(name, fn, *args, iters=3, jit=True):
    """min-of-iters wall time with a forced host readback per call."""
    try:
        fn_j = jax.jit(fn) if jit else fn
        out = np.asarray(fn_j(*args))  # warmup + compile
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = np.asarray(fn_j(*args))
            ts.append(time.perf_counter() - t0)
        print(f"{name:56s} {min(ts) * 1e3:10.2f} ms  out={out.ravel()[:2]}",
              flush=True)
        return min(ts)
    except Exception as e:  # noqa: BLE001 - a support probe failing IS data
        print(f"{name:56s} FAILED: {type(e).__name__}: {str(e)[:140]}",
              flush=True)
        return None


def make_relations():
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    probe = jax.random.randint(k1, (N_PROBE,), 1, N_BUILD + 1, dtype=jnp.int32)
    build = jax.random.permutation(
        k2, jnp.arange(1, N_BUILD + 1, dtype=jnp.int32)
    )
    vals = jnp.arange(N_PROBE, dtype=jnp.int32)
    jax.block_until_ready((probe, build, vals))
    return probe, build, vals


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def section_stream(probe, build, vals):
    x1 = jnp.ones((8, 128), jnp.float32)
    timed("tiny op (dispatch overhead)", lambda x: (x + 1).sum(), x1)
    timed("stream sum 50M int32", lambda p: p.sum(), probe)
    timed("elementwise x+1 50M (read+write) -> checksum",
          lambda p: (p + 1)[::1000001].sum(), probe)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def section_sort(probe, build, vals):
    timed("stable 1-key sort 50M -> checksum",
          lambda x: jax.lax.sort(x)[::1000001].sum(), probe)
    timed("UNstable 1-key sort 50M -> checksum",
          lambda x: jax.lax.sort((x,), num_keys=1, is_stable=False)[0][::1000001].sum(),
          probe)
    timed("stable (key+payload) sort 50M -> checksum",
          lambda x, v: sum(a[::1000001].sum()
                           for a in jax.lax.sort((x, v), num_keys=1)),
          probe, vals)
    timed("UNstable 2-KEY sort 50M -> checksum",
          lambda x, v: sum(a[::1000001].sum()
                           for a in jax.lax.sort((x, v), num_keys=2,
                                                 is_stable=False)),
          probe, vals)
    timed("sort build 10M -> checksum",
          lambda x: jax.lax.sort(x)[::999999].sum(), build)


# ---------------------------------------------------------------------------
# gather / scatter / searchsorted
# ---------------------------------------------------------------------------

def section_gather(probe, build, vals):
    build_sorted = jax.block_until_ready(jax.jit(jax.lax.sort)(build))
    timed("gather 50M from 10M -> checksum",
          lambda t, i: t[i - 1][::1000001].sum(), build, probe)
    small = jnp.arange(65536, dtype=jnp.int32)
    timed("gather 50M from 64K (256KB) -> checksum",
          lambda t, i: t[i & 65535][::1000001].sum(), small, probe)
    timed("4-wide window gather 50M -> checksum",
          lambda t, i: t[(i - 1)[:, None]
                         + jnp.arange(4, dtype=jnp.int32)[None, :]
                         & (N_BUILD - 1)][::1000001, :].sum(),
          build, probe)
    timed("scatter-add 50M into 10M -> checksum",
          lambda i: jnp.zeros(N_BUILD, jnp.int32).at[i - 1].add(1)[::999999].sum(),
          probe)
    timed("scatter-set 50M into 10M -> checksum",
          lambda i: jnp.zeros(N_BUILD, jnp.int32).at[i - 1].set(1)[::999999].sum(),
          probe)
    timed("searchsorted 50M -> 10M -> checksum",
          lambda p, b: jnp.searchsorted(b, p)[::1000001].sum(),
          probe, build_sorted)
    timed("cumsum 50M -> checksum",
          lambda p: jnp.cumsum(p)[::1000001].sum(), probe)
    timed("cummax 50M -> checksum",
          lambda p: jax.lax.cummax(p)[::1000001].sum(), probe)


# ---------------------------------------------------------------------------
# hist
# ---------------------------------------------------------------------------

def section_hist(probe, build, vals):
    def hist64(p):
        oh = (p & 63)[:, None] == jnp.arange(64, dtype=jnp.int32)[None, :]
        return jnp.sum(oh, axis=0, dtype=jnp.int32).sum()

    timed("one-hot histogram P=64 (50M)", hist64, probe)

    def partition_sort(p, v):
        pid = p & 4095
        outs = jax.lax.sort((pid, p, v), num_keys=1, is_stable=True)
        return outs[1][::1000001].sum() + outs[2][::1000001].sum()

    timed("partition via stable sort P=4096 (50M)", partition_sort, probe, vals)

    def partition_sort_2key(p):
        pid = p & 4095
        outs = jax.lax.sort((pid, p), num_keys=2, is_stable=False)
        return outs[1][::1000001].sum()

    timed("partition via UNstable (pid,key) sort P=4096", partition_sort_2key,
          probe)


SECTIONS = {
    "stream": section_stream,
    "sort": section_sort,
    "gather": section_gather,
    "hist": section_hist,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--section", default="all",
                    help="comma list of sections, or 'all'")
    args = ap.parse_args()
    names = (list(SECTIONS) if args.section == "all"
             else [s.strip() for s in args.section.split(",")])
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})", flush=True)
    probe, build, vals = make_relations()
    print(f"relations: probe={N_PROBE/1e6:.0f}M build={N_BUILD/1e6:.0f}M",
          flush=True)
    for s in names:
        print(f"\n== {s} ==", flush=True)
        SECTIONS[s](probe, build, vals)


if __name__ == "__main__":
    main()
