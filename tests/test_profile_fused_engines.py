"""The trace reduction of scripts/profile_fused_engines.py on recorded
intervals: busy time is the union of the device events, idle share is
measured over the window from the first start to the last end."""

import os
import sys

import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
)

from profile_fused_engines import summarize_events  # noqa: E402


def test_summarize_events_union_and_idle_share():
    ms = 1_000_000
    events = [
        (0, 4 * ms, "gemm"),
        (2 * ms, 5 * ms, "fusion"),  # overlaps the gemm
        (8 * ms, 10 * ms, "gemm"),  # after a 3 ms gap
    ]
    out = summarize_events(events)
    assert out["kernels"] == 3
    assert out["device_window_ms"] == pytest.approx(10.0)
    assert out["device_busy_ms"] == pytest.approx(7.0)
    assert out["idle_share"] == pytest.approx(0.3)
    assert [t["name"] for t in out["top3"]] == ["gemm", "fusion"]
    assert out["top3"][0]["ms"] == pytest.approx(6.0)


def test_summarize_events_empty_trace():
    assert summarize_events([]) == {"kernels": 0}
