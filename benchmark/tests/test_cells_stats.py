"""The percentile and rate arithmetic over synthetic stamp lists."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import core, stats
from benchmark.tests._small import REPO


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_is_numpys_linear(n):
    xs = np.random.default_rng(n).exponential(size=n)
    for p in (0, 5, 50, 95, 100):
        assert stats.percentile(xs, p) == pytest.approx(float(np.percentile(xs, p)))


def test_a_stall_moves_the_tail_and_the_rate():
    """Closed loop, 50 ms a frame, a frame's result two calls after its
    submit; one stall of 2 s in the middle of a 10 s window."""
    bench = core.Bench(REPO)
    p95, fps = bench.reader("frame_p95_ms"), bench.reader("frames_per_s")

    def loop(stall_at=None):
        sub, done, t, pending = {}, {}, 0.0, []
        i = 0
        while t < 10.0:
            sub[i] = t
            pending.append(i)
            t += 0.05 + (2.0 if i == stall_at else 0.0)
            while len(pending) > 2:
                done[pending.pop(0)] = t
            i += 1
        return {"submitted": sub, "completed": done, "window_s": t}

    calm, stalled = loop(), loop(stall_at=100)
    assert p95(calm) == pytest.approx(150.0)
    assert fps(calm) == pytest.approx((len(calm["completed"])) / calm["window_s"])
    assert fps(calm) == pytest.approx(20.0, rel=0.02)
    # the stall delays the two frames in flight and the one it holds: three
    # latencies of ~2.15 s among ~160 frames lift the 95th percentile only
    # as far as its rank allows, and the rate falls by the stall's share
    lat = stats.latencies_ms(stalled["submitted"], stalled["completed"])
    assert sum(x > 2000 for x in lat) == 3
    assert p95(stalled) == pytest.approx(stats.percentile(lat, 95))
    assert fps(stalled) < 0.85 * fps(calm)


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)
