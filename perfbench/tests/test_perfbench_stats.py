"""The window's statistics are over every sample of the window."""
import numpy as np
import pytest

from perfbench import core


def test_p95_is_over_every_call_of_a_window_with_a_stall():
    calls = [400.0 if i % 20 == 7 else 30.0 for i in range(200)]   # 10 stalls in 200
    # The 95th percentile of all 200 calls lies between the 190th and the
    # 191st order statistic: a median of chunks would hide the stall.
    assert core.p95(calls) == pytest.approx(30.0 + 0.05 * 370.0)
    chunks = [np.median(calls[i:i + 20]) for i in range(0, 200, 20)]
    assert max(chunks) == 30.0
    assert core.p95([c for c in calls if c < 100]) == 30.0


def test_rate_counts_all_work_over_all_the_window():
    calls_ms = [400.0 if i % 20 == 7 else 30.0 for i in range(200)]
    window_s = sum(calls_ms) / 1e3
    assert core.per_second(len(calls_ms), window_s) == pytest.approx(200 / 9.7)


def test_an_empty_window_has_no_statistics():
    with pytest.raises(ValueError):
        core.p95([])
    with pytest.raises(ValueError):
        core.per_second(3, 0.0)
