#!/usr/bin/env bash
# Run the test suite one FILE per interpreter process.
#
# Why not one `pytest tests/`: on this 4-core box the monolithic run
# accumulates hundreds of XLA CPU executables in one process and has
# segfaulted deep into the run (round 5: rc=139 at ~43% with >100 GB
# free RAM — an XLA-CPU pressure artifact, not a test failure; every
# file passes in its own process).  A fresh interpreter per file bounds
# that state, gives per-file wall times, and isolates any crash to its
# file.
#
# Usage: scripts/run_tests.sh [pytest-args...]   (extra args forwarded)
set -u
cd "$(dirname "$0")/.."
overall=0
total_start=$(date +%s)
for f in tests/test_*.py; do
  start=$(date +%s)
  if out=$(python -m pytest "$f" -q "$@" 2>&1); then rc=0; else rc=$?; fi
  line=$(printf '%s\n' "$out" | grep -E "passed|failed|error" | tail -1)
  echo "$f [$(($(date +%s) - start))s] rc=$rc  ${line:-<no summary>}"
  if [ "$rc" -ne 0 ]; then
    overall=1
    printf '%s\n' "$out" | tail -40
  fi
done
echo "TOTAL $((($(date +%s) - total_start) / 60)) min, overall rc=$overall"
exit $overall
