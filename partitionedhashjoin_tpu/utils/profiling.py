"""Tracing and roofline accounting.

Counterpart of the reference's profiling story (SURVEY.md §5): the
reference has manual phase timers plus an acknowledged TODO for CPU
cache-miss counters (Readme.md:66-67).  Here:

- ``trace(...)``: a ``jax.profiler`` trace context producing TensorBoard/
  Perfetto traces of device execution.
- ``roofline(...)``: device-memory roofline accounting for a phase — the
  engine's kernels are memory-bound, so achieved GB/s over the device's
  peak GB/s is the speed-of-light fraction.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

#: Peak device-memory bandwidth, GB/s, keyed by ``jax.Device.device_kind``.
#: H100 SXM: 80 GB HBM3 at 3.35 TB/s (NVIDIA H100 data sheet).  A device
#: that is not listed is an error, never a default.
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_gbps(device_kind: str) -> float:
    """Peak memory bandwidth of ``device_kind``; raises for an unknown
    device."""
    try:
        return HBM_PEAK_GBPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth recorded for device kind {device_kind!r}; "
            "add it to utils/profiling.HBM_PEAK_GBPS with its source"
        ) from None


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device profile for [enter, exit) into ``log_dir``.

    View with TensorBoard's profile plugin or Perfetto.  Wraps
    ``jax.profiler.trace`` so callers don't import jax.profiler directly.
    """
    import jax.profiler

    with jax.profiler.trace(log_dir):
        yield


@dataclasses.dataclass
class RooflineReport:
    """Achieved vs peak memory bandwidth for one phase."""

    seconds: float
    bytes_moved: int
    achieved_gbps: float
    peak_gbps: float

    @property
    def fraction_of_peak(self) -> float:
        return self.achieved_gbps / self.peak_gbps

    def __str__(self) -> str:
        return (
            f"{self.bytes_moved / 1e9:.2f} GB in {self.seconds * 1e3:.0f} ms "
            f"-> {self.achieved_gbps:.0f} GB/s "
            f"({self.fraction_of_peak * 100:.0f}% of {self.peak_gbps:.0f} peak)"
        )


def roofline(seconds: float, bytes_moved: int, device_kind: str) -> RooflineReport:
    """Bandwidth roofline for a measured phase on ``device_kind``.

    ``bytes_moved`` is the algorithmic device-memory traffic (reads +
    writes of live arrays), computed by the caller from shapes.
    """
    achieved = bytes_moved / max(seconds, 1e-12) / 1e9
    return RooflineReport(
        seconds=seconds,
        bytes_moved=bytes_moved,
        achieved_gbps=achieved,
        peak_gbps=peak_gbps(device_kind),
    )
