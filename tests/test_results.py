"""Timer + JSON schema tests (reference: src/Common/Results.hpp)."""

import io
import json
import time

import pytest

from partitionedhashjoin_tpu.config import (
    OutputConfiguration,
    ResultsFormatConfiguration,
)
from partitionedhashjoin_tpu.utils.results import (
    FileResultsRenderer,
    HashJoinTimer,
    JSONResultsFormatter,
    NoOpHashJoinTimer,
    Parameters,
    TimeSegmentMeasurer,
    select_results_formatter,
    select_results_renderer,
)


def _params():
    p = Parameters()
    p.set_parameter("PrimaryRelationSize", "1000")
    p.set_parameter("SecondaryRelationSize", "2000")
    p.set_parameter("Skew", f"{1.05:.6f}")
    p.set_parameter("Type", "NoPartitioning")
    return p


def test_timer_phases_are_independent():
    t = HashJoinTimer(_params())
    t.set_build_phase_begin()
    time.sleep(0.02)
    t.set_build_phase_end()
    t.set_probe_phase_begin()
    time.sleep(0.01)
    t.set_probe_phase_end()
    r = t.get_result()
    # probe must NOT include build (the reference's Results.hpp:202 bug)
    assert r.get_probe_phase_duration() < r.get_build_phase_duration()
    assert r.get_partitioning_phase_duration() == 0.0


def test_timer_guards():
    t = HashJoinTimer(_params())
    with pytest.raises(RuntimeError):
        t.set_build_phase_end()
    t.set_build_phase_begin()
    with pytest.raises(RuntimeError):
        t.set_build_phase_begin()


def test_set_duration_api():
    t = HashJoinTimer(_params())
    t.set_partitioning_phase_duration(1.5)
    t.set_build_phase_duration(0.25)
    t.set_probe_phase_duration(0.125)
    r = t.get_result()
    assert r.get_partitioning_phase_duration() == 1.5


def test_segment_measurer_accumulates():
    m = TimeSegmentMeasurer()
    m.start()
    time.sleep(0.005)
    m.stop()
    first = m.get_duration()
    m.start()
    time.sleep(0.005)
    m.stop()
    assert m.get_duration() > first
    with pytest.raises(RuntimeError):
        m.stop()


def test_json_schema_matches_reference():
    """Schema parity with results/1.05/partitions_64.txt."""
    t = HashJoinTimer(_params())
    t.set_build_phase_duration(0.056)
    t.set_probe_phase_duration(0.581)
    t.set_partitioning_phase_duration(0.814)
    fmt = JSONResultsFormatter(ResultsFormatConfiguration(time_unit="ms"))
    buf = io.StringIO()
    fmt.format(buf, t.get_result())
    doc = json.loads(buf.getvalue())
    assert doc["id"] == "hashjointimingresult"
    assert doc["parameters"]["Skew"] == "1.050000"
    assert list(doc["parameters"].keys()) == sorted(doc["parameters"].keys())
    assert doc["results"] == {"partition": "814", "build": "56", "probe": "581"}


def test_unit_casting():
    t = HashJoinTimer(_params())
    t.set_probe_phase_duration(1.5)
    for unit, expect in (("ns", "1500000000"), ("us", "1500000"), ("ms", "1500"), ("s", "1")):
        fmt = JSONResultsFormatter(ResultsFormatConfiguration(time_unit=unit))
        assert fmt.format_dict(t.get_result())["results"]["probe"] == expect


def test_file_renderer(tmp_path):
    path = tmp_path / "out.json"
    r = FileResultsRenderer(str(path))
    t = NoOpHashJoinTimer()
    fmt = JSONResultsFormatter(ResultsFormatConfiguration())
    r.render(fmt, t.get_result())
    doc = json.loads(path.read_text())
    assert doc["id"] == "hashjointimingresult"


def test_selectors():
    fmt = select_results_formatter(ResultsFormatConfiguration())
    assert isinstance(fmt, JSONResultsFormatter)
    out_cfg = OutputConfiguration()
    out_cfg.file.name = "x.json"
    assert isinstance(select_results_renderer(out_cfg), FileResultsRenderer)


class TestProfiling:
    """Roofline accounting utilities (utils/profiling.py)."""

    def test_roofline_math(self):
        from partitionedhashjoin_tpu.utils.profiling import roofline

        r = roofline(
            seconds=1.0, bytes_moved=3_350_000_000_000,
            device_kind="NVIDIA H100 80GB HBM3",
        )
        assert abs(r.achieved_gbps - 3350.0) < 1e-6
        assert abs(r.fraction_of_peak - 1.0) < 1e-6
        assert "100%" in str(r)

    def test_unknown_device_kind_raises(self):
        import pytest

        from partitionedhashjoin_tpu.utils.profiling import peak_gbps, roofline

        for kind in ("cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB"):
            with pytest.raises(ValueError, match="no peak bandwidth"):
                peak_gbps(kind)
        with pytest.raises(ValueError):
            roofline(1.0, 1, device_kind="cpu")

    def test_trace_context_manager_runs(self, tmp_path):
        import jax.numpy as jnp

        from partitionedhashjoin_tpu.utils.profiling import trace

        with trace(str(tmp_path)):
            jnp.arange(10).sum().block_until_ready()


class TestTimeSegmentMeasurer:
    """Accumulating segment measurer (Results.hpp:98-123 semantics)."""

    def test_accumulates_discontinuous_segments(self):
        import time as _t

        from partitionedhashjoin_tpu.utils.results import TimeSegmentMeasurer

        m = TimeSegmentMeasurer()
        m.start(); _t.sleep(0.01); m.stop()
        first = m.get_duration()
        assert first > 0
        m.start(); _t.sleep(0.01); m.stop()
        assert m.get_duration() > first  # accumulates, does not reset

    def test_misuse_raises(self):
        import pytest

        from partitionedhashjoin_tpu.utils.results import TimeSegmentMeasurer

        m = TimeSegmentMeasurer()
        with pytest.raises(RuntimeError):
            m.stop()  # not running
        m.start()
        with pytest.raises(RuntimeError):
            m.start()  # already running


class TestTimerGuards:
    """Unlike the reference (which constructs guard exceptions but never
    throws them, SURVEY.md appendix 2), misuse must actually raise."""

    def test_begin_twice_raises(self):
        import pytest

        from partitionedhashjoin_tpu.utils.results import (
            HashJoinTimer,
            Parameters,
        )

        t = HashJoinTimer(Parameters())
        t.set_build_phase_begin()
        with pytest.raises(RuntimeError):
            t.set_build_phase_begin()

    def test_end_without_begin_raises(self):
        import pytest

        from partitionedhashjoin_tpu.utils.results import (
            HashJoinTimer,
            Parameters,
        )

        t = HashJoinTimer(Parameters())
        with pytest.raises(RuntimeError):
            t.set_probe_phase_end()
