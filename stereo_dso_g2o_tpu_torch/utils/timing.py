"""Lightweight wall-clock profiler, and its sections on the device.

Port of `stereo_dso_g2o_tpu/utils/timing.py`: named sections accumulate
wall time; when profiling is on (SDSO_PROFILE=1) a section synchronizes the
CUDA device at its end so asynchronous kernel launches are charged to the
section that issued them. A named loop or branch (`utils/loop.py`) run
eagerly adds its host trips (or taken branches) to `trips`.

While a program is being captured (`runtime/program.py`) nothing may wait
for the device: there a section becomes a pair of device stamps captured
at its entry and exit (`utils/loop.stamped`), whether profiling is on or
not, and each replay that runs it adds to the program's stage accounting
(`Program.stages()`); the host timing is left out.

`span(name)` is a host span on torch.profiler's timeline, made only
while a profiler runs.
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


def _capturing() -> bool:
    return (torch.cuda.is_available() and torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def span(name: str):
    """A host span `name` on torch.profiler's timeline while a profiler
    runs. A plain op record, not `record_function`'s user annotation,
    which the profiler also draws on the device's timeline over the
    kernels launched inside it: the benchmark counts every device record
    as busy time."""
    return torch._C._profiler._RecordFunctionFast(name)


class Profiler:
    def __init__(self, enabled: bool | None = None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("SDSO_PROFILE", "0") == "1"
        )
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.trips = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time a block. `sync` is accepted for call-site parity with the JAX
        profiler; any truthy value synchronizes the device at section end.
        Under capture: device stamps (module docstring). Usable as a
        decorator too."""
        if _capturing():
            from stereo_dso_g2o_tpu_torch.utils import loop

            with loop.stamped(name):
                yield
            return
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def loop(self, name: str, trips: int, seconds: float = 0.0):
        """A named loop's (or branch's) eager run: `trips` trips (or 1 if
        the branch was taken) in `seconds` of host time."""
        if not self.enabled:
            return
        self.totals[name] += seconds
        self.counts[name] += 1
        self.trips[name] += trips

    def report(self, min_ms: float = 0.1) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{'section':<38}{'total_s':>9}{'count':>7}{'ms/call':>9}{'trips':>7}"]
        for name, tot in rows:
            n = self.counts[name]
            if tot * 1000 < min_ms and name not in self.trips:
                continue
            trips = str(self.trips[name]) if name in self.trips else ""
            lines.append(f"{name:<38}{tot:>9.2f}{n:>7}{1000 * tot / n:>9.1f}{trips:>7}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.trips.clear()


PROF = Profiler()
