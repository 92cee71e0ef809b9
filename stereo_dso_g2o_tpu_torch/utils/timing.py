"""Lightweight wall-clock profiler.

Port of `stereo_dso_g2o_tpu/utils/timing.py`: named sections accumulate
wall time; when profiling is on (SDSO_PROFILE=1) a section synchronizes the
CUDA device at its end so asynchronous kernel launches are charged to the
section that issued them. While a program is being captured
(`runtime/program.py`) nothing may wait for the device: a section then
only times the capture.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _sync():
    if (torch.cuda.is_available() and torch.cuda.is_initialized()
            and not torch.cuda.is_current_stream_capturing()):
        torch.cuda.synchronize()


class Profiler:
    def __init__(self, enabled: bool | None = None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("SDSO_PROFILE", "0") == "1"
        )
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time a block. `sync` is accepted for call-site parity with the JAX
        profiler; any truthy value synchronizes the device at section end."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def tick(self, name: str, t0: float, sync_obj=None):
        if not self.enabled:
            return
        if sync_obj is not None:
            _sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self, min_ms: float = 0.1) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{'section':<38}{'total_s':>9}{'count':>7}{'ms/call':>9}"]
        for name, tot in rows:
            n = self.counts[name]
            if tot * 1000 < min_ms:
                continue
            lines.append(f"{name:<38}{tot:>9.2f}{n:>7}{1000 * tot / n:>9.1f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


PROF = Profiler()
