"""Phase timing, parameter bags, and results rendering.

Counterpart of src/Common/Results.hpp:

- ``Parameters``               <- Results.hpp:20-56
- ``HashJoinTimingResult``     <- Results.hpp:60-88
- ``TimeSegmentMeasurer``      <- Results.hpp:98-123
- ``HashJoinTimer``            <- Results.hpp:125-247 (begin/end + set-duration)
- ``NoOpHashJoinTimer``        <- Results.hpp:151-165
- ``JSONResultsFormatter``     <- Results.hpp:262-311 (same JSON schema:
  ``{id, parameters.*, results.{partition,build,probe}}``, values as strings,
  durations cast to the configured unit)
- ``FileResultsRenderer``      <- Results.hpp:313-325

Divergence from the reference (documented per SURVEY.md appendix item 1): the
reference computes the no-partitioning probe duration from *build start*
(Results.hpp:202), so its published probe figures include build time.  This
implementation attributes each phase to its own begin/end pair.  On a
device, a phase "ends" only after ``jax.block_until_ready`` — callers are responsible
for device synchronization before calling the ``set_*_end`` methods.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterator, Optional, TextIO

from partitionedhashjoin_tpu.config import (
    OutputConfiguration,
    OutputType,
    ResultsFormat,
    ResultsFormatConfiguration,
)


class Parameters:
    """String->string parameter bag rendered under ``parameters.`` in JSON.

    The reference stores parameters in a std::map, so rendered output is
    sorted by key (observed in results/1.05/partitions_64.txt); we match that.
    """

    def __init__(self) -> None:
        self._params: Dict[str, str] = {}

    def set_parameter(self, key: str, value: str) -> None:
        self._params[key] = value

    def get_parameter(self, key: str) -> str:
        return self._params[key]

    def __iter__(self) -> Iterator:
        return iter(sorted(self._params.items()))

    def __len__(self) -> int:
        return len(self._params)

    def as_sorted_dict(self) -> Dict[str, str]:
        return dict(sorted(self._params.items()))


class HashJoinTimingResult:
    """Three phase durations (seconds) + the parameter bag."""

    def __init__(self, parameters: Parameters) -> None:
        self._parameters = parameters
        self._partitioning_s: float = 0.0
        self._build_s: float = 0.0
        self._probe_s: float = 0.0

    # Setters mirror Results.hpp:70-80.
    def set_partitioning_phase_duration(self, seconds: float) -> None:
        self._partitioning_s = seconds

    def set_build_phase_duration(self, seconds: float) -> None:
        self._build_s = seconds

    def set_probe_phase_duration(self, seconds: float) -> None:
        self._probe_s = seconds

    def get_partitioning_phase_duration(self) -> float:
        return self._partitioning_s

    def get_build_phase_duration(self) -> float:
        return self._build_s

    def get_probe_phase_duration(self) -> float:
        return self._probe_s

    def get_parameters(self) -> Parameters:
        return self._parameters


class TimeSegmentMeasurer:
    """Accumulating start/stop measurer for discontinuous segments.

    Mirrors Results.hpp:98-123 — used when a phase is split into interleaved
    per-partition segments (the radix join's per-partition build/probe).
    """

    def __init__(self) -> None:
        self._total_s = 0.0
        self._start: Optional[float] = None

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError("TimeSegmentMeasurer.start: already running.")
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is None:
            raise RuntimeError("TimeSegmentMeasurer.stop: not running.")
        self._total_s += time.perf_counter() - self._start
        self._start = None

    def get_duration(self) -> float:
        return self._total_s


class IHashJoinTimer:
    """Timer interface (Results.hpp:125-149)."""

    def set_partitioning_phase_begin(self) -> None:
        raise NotImplementedError

    def set_partitioning_phase_end(self) -> None:
        raise NotImplementedError

    def set_build_phase_begin(self) -> None:
        raise NotImplementedError

    def set_build_phase_end(self) -> None:
        raise NotImplementedError

    def set_probe_phase_begin(self) -> None:
        raise NotImplementedError

    def set_probe_phase_end(self) -> None:
        raise NotImplementedError

    def set_partitioning_phase_duration(self, seconds: float) -> None:
        raise NotImplementedError

    def set_build_phase_duration(self, seconds: float) -> None:
        raise NotImplementedError

    def set_probe_phase_duration(self, seconds: float) -> None:
        raise NotImplementedError

    def get_result(self) -> HashJoinTimingResult:
        raise NotImplementedError


class NoOpHashJoinTimer(IHashJoinTimer):
    """Disabled timer, the default for library use (Results.hpp:151-165)."""

    def set_partitioning_phase_begin(self) -> None: ...
    def set_partitioning_phase_end(self) -> None: ...
    def set_build_phase_begin(self) -> None: ...
    def set_build_phase_end(self) -> None: ...
    def set_probe_phase_begin(self) -> None: ...
    def set_probe_phase_end(self) -> None: ...
    def set_partitioning_phase_duration(self, seconds: float) -> None: ...
    def set_build_phase_duration(self, seconds: float) -> None: ...
    def set_probe_phase_duration(self, seconds: float) -> None: ...

    def get_result(self) -> HashJoinTimingResult:
        return HashJoinTimingResult(Parameters())


class HashJoinTimer(IHashJoinTimer):
    """Wall-clock phase timer (Results.hpp:167-247).

    Supports both the continuous begin/end API and the thread-safe
    set-duration API (used when per-worker segment measurers are reduced to a
    representative duration, RadixCluster/HashJoin.hpp:63-87).
    """

    def __init__(self, parameters: Parameters) -> None:
        self._result = HashJoinTimingResult(parameters)
        self._lock = threading.Lock()
        self._begins: Dict[str, float] = {}

    def _begin(self, phase: str) -> None:
        if phase in self._begins:
            raise RuntimeError(f"HashJoinTimer: {phase} phase already begun.")
        self._begins[phase] = time.perf_counter()

    def _end(self, phase: str) -> float:
        if phase not in self._begins:
            raise RuntimeError(f"HashJoinTimer: {phase} phase was not begun.")
        return time.perf_counter() - self._begins.pop(phase)

    def set_partitioning_phase_begin(self) -> None:
        self._begin("partition")

    def set_partitioning_phase_end(self) -> None:
        self._result.set_partitioning_phase_duration(self._end("partition"))

    def set_build_phase_begin(self) -> None:
        self._begin("build")

    def set_build_phase_end(self) -> None:
        self._result.set_build_phase_duration(self._end("build"))

    def set_probe_phase_begin(self) -> None:
        self._begin("probe")

    def set_probe_phase_end(self) -> None:
        # NOTE: measured from probe begin — the reference measures from build
        # start (Results.hpp:202), a documented bug we do not replicate.
        self._result.set_probe_phase_duration(self._end("probe"))

    def set_partitioning_phase_duration(self, seconds: float) -> None:
        with self._lock:
            self._result.set_partitioning_phase_duration(seconds)

    def set_build_phase_duration(self, seconds: float) -> None:
        with self._lock:
            self._result.set_build_phase_duration(seconds)

    def set_probe_phase_duration(self, seconds: float) -> None:
        with self._lock:
            self._result.set_probe_phase_duration(seconds)

    def get_result(self) -> HashJoinTimingResult:
        return self._result


_UNIT_DIVISORS = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}


class JSONResultsFormatter:
    """Render a timing result to the reference's JSON schema.

    Matches Results.hpp:262-311: top-level ``id`` ("hashjointimingresult"),
    ``parameters`` (all strings, sorted keys), ``results`` with integral
    durations cast to the configured unit, rendered as strings.
    """

    def __init__(self, config: ResultsFormatConfiguration) -> None:
        if config.time_unit not in _UNIT_DIVISORS:
            raise ValueError(
                "JSONResultsFormatter: unrecognized duration unit: "
                + config.time_unit
            )
        self._config = config

    def _cast(self, seconds: float) -> str:
        # truncation like std::chrono::duration_cast, with an epsilon so that
        # exact unit multiples survive float division (0.814/0.001 -> 814)
        return str(int(seconds / _UNIT_DIVISORS[self._config.time_unit] + 1e-6))

    def format_dict(self, results: HashJoinTimingResult) -> Dict:
        return {
            "id": "hashjointimingresult",
            "parameters": results.get_parameters().as_sorted_dict(),
            "results": {
                "partition": self._cast(results.get_partitioning_phase_duration()),
                "build": self._cast(results.get_build_phase_duration()),
                "probe": self._cast(results.get_probe_phase_duration()),
            },
        }

    def format(self, stream: TextIO, results: HashJoinTimingResult) -> None:
        json.dump(self.format_dict(results), stream, indent=4)
        stream.write("\n")


class FileResultsRenderer:
    """Write formatted results to a file (Results.hpp:313-325)."""

    def __init__(self, filename: str) -> None:
        self._filename = filename

    def render(
        self, formatter: JSONResultsFormatter, results: HashJoinTimingResult
    ) -> None:
        with open(self._filename, "w") as f:
            formatter.format(f, results)


class StreamResultsRenderer:
    """Write formatted results to an open stream (engine extension)."""

    def __init__(self, stream: TextIO) -> None:
        self._stream = stream

    def render(
        self, formatter: JSONResultsFormatter, results: HashJoinTimingResult
    ) -> None:
        formatter.format(self._stream, results)


def select_results_formatter(
    config: ResultsFormatConfiguration,
) -> JSONResultsFormatter:
    """Formatter factory (Results.hpp:327-337)."""
    if config.format == ResultsFormat.JSON:
        return JSONResultsFormatter(config)
    raise ValueError(f"Unsupported results format: {config.format}")


def select_results_renderer(config: OutputConfiguration):
    """Renderer factory (Results.hpp:339-347)."""
    if config.type == OutputType.FILE:
        return FileResultsRenderer(config.file.name)
    if config.type == OutputType.STDOUT:
        import sys

        return StreamResultsRenderer(sys.stdout)
    raise ValueError(f"Unsupported output type: {config.type}")
