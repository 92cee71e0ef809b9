"""Faults planted in the port, to see the check of `correct` fail (the
CPU tests, and `benchmark/control.py --fault` on the card; the benchmark's
own runs plant none). Each is a context manager that patches a function of
the port and restores it on exit. Planted before the session's set-up, a
fault is in every program the set-up captures.

- `state_unchanged`: each frame's program hands back the state it was
  given (graph);
- `half_batch`: the batched track advances the first half of the drives
  only; the rest keep their state and report no motion (batched);
- `pose_altered`: every other frame's pose moves half a metre as the
  program hands it over (graph);
- `k1_off_line`: K1's match lands two steps further along the epipolar
  line than its search found (depth refinement);
- `ba_overshoot`: BA applies three times each step it solved for;
- `ba_noop`: BA solves and applies nothing (what it reads: PERF.md).
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _state_unchanged(real):
    def fn(state, *a, **k):
        return state, real(state, *a, **k)[1]
    return fn


def _pose_altered(real):
    calls = []

    def fn(*a, **k):
        state, b = real(*a, **k)
        calls.append(1)
        if len(calls) % 2:
            T = b.T.clone()
            T[..., 0, 3] += 0.5
            b = b._replace(T=T)
        return state, b
    return fn


def _half_batch(real):
    from stereo_dso_g2o_tpu_torch.parallel import batched

    def fn(states, *a, **k):
        new, bundles, aux = real(states, *a, **k)
        n = bundles.T.shape[0]
        rest = list(range(n // 2, n))
        new = batched._tree_scatter(new, batched._tree_rows(states, rest), rest)
        T = bundles.T.clone()
        T[rest] = torch.eye(4, dtype=T.dtype, device=T.device)
        return new, bundles._replace(T=T), aux
    return fn


def _k1_off_line(real):
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    def fn(dI, scal, *a, **k):
        out = real(dI, scal, *a, **k).clone()
        out[..., tk.OUT_BEST_U] += 2.0 * scal[..., 2]
        out[..., tk.OUT_BEST_V] += 2.0 * scal[..., 3]
        return out
    return fn


def _ba_overshoot(real):
    def fn(win, out):
        return real(win, out._replace(step_c=3.0 * out.step_c, step_f=3.0 * out.step_f,
                                      step_pt=3.0 * out.step_pt))
    return fn


def _ba_noop(real):
    def fn(win, out):
        return win
    return fn


PORT = "stereo_dso_g2o_tpu_torch"
FAULTS = {  # name: (module of the port, the function patched, the patch)
    "state_unchanged": (f"{PORT}.frontend.graph_system", "frame_auto", _state_unchanged),
    "pose_altered": (f"{PORT}.frontend.graph_system", "frame_auto", _pose_altered),
    "half_batch": (f"{PORT}.parallel.batched", "frame_track_batched", _half_batch),
    "k1_off_line": (f"{PORT}.ops.trace_cuda", "epipolar_search", _k1_off_line),
    "ba_overshoot": (f"{PORT}.backend.ba", "apply_step", _ba_overshoot),
    "ba_noop": (f"{PORT}.backend.ba", "apply_step", _ba_noop),
}
NAMES = tuple(FAULTS)


def planted(name: str):
    """The context manager of fault `name`."""
    module, function, make = FAULTS[name]
    return _patched(importlib.import_module(module), function, make)
