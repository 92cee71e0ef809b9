"""Config-4 multi-sequence stepping: N sequences, one stacked state.

Port of `stereo_dso_g2o_tpu/parallel/batched.py`. There the whole frame
program is `vmap`ped over a leading sequence axis, so stepping N sequences
is one dispatch and one small fetch per frame. Here the state of all
sequences lives stacked (every leaf of `GraphState` with a leading axis N)
and every part of the frame program is one program over that axis, each op
once for all N sequences, one sequence its batch of one, and on the card
one captured program (`runtime/program.py`) that reads nothing:
`frame_track_batched` is `graph_system.frame_track` on the stacked state
(the N x 5 pose hypotheses as rows of one LM loop, one K1 launch per search
for all sequences; one program per N), `frame_kf_subset_batched` is the
keyframe pipeline (`graph_system._kf_branch`) once over the
keyframe-needing sequences (K1 three launches whatever the subset's size;
one program per subset size), and "fused" `frame_auto_batched` runs both
over all N and selects per sequence on the device (one program per N).
`BatchedRunner.warm_kf_buckets` captures them before a timed run.

Three dispatch modes (`kf_mode`):

- "deferred" (default): the track-only program for all sequences every
  frame; the keyframe pipeline for frame i runs at step i+1, BEFORE frame
  i+1's track, from the pre-track state and the track's aux. Numerically
  identical to "gated" (the keyframe program of frame i still runs before
  track i+1), but `need_kf` is fetched one step late, when the track has
  long finished. The reference's track/map hand-off running one frame
  behind (FullSystem.cpp:1168-1221), with zero staleness, because the
  hand-off completes before the next track runs.
- "gated": the same split, with `need_kf` fetched within the frame.
- "fused": the track program and the keyframe pipeline over all N
  sequences, then a per-sequence select on `need_kf` on the device, which
  is what the JAX package's vmap of the keyframe `cond` computes (both
  branches for every sequence). `need_kf` is never read on the host.

All sequences must share resolution (per-sequence intrinsics VALUES may
differ). The pixel-selector potential is PER SEQUENCE: each sequence's host
adaptation (`GraphSystem.apply_bundle`) feeds back into the next dispatch.
In "deferred" the potentials read at step i+1 serve frame i's keyframe
pipeline, one drain later than in "gated": where a drain between the two
steps changed a sequence's potential, the two modes select other pixels
(the JAX module has the same skew).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.frontend import graph_system as GS
from stereo_dso_g2o_tpu_torch.frontend.full_system import device_image
from stereo_dso_g2o_tpu_torch.frontend.graph_system import (
    FrameBundle,
    GraphState,
    GraphSystem,
    frame_track,
)
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import host
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.tree import tree_map

# ---------------------------------------------------------------------------
# trees of tensors (utils/tree.py): stack, slice and scatter over sequences
# ---------------------------------------------------------------------------


def _tree_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _tree_slice(tree, i):
    return tree_map(lambda x: x[i], tree)


def _tree_scatter(stacked, items, idx):
    """`stacked` with rows `idx` replaced by the rows of `items` (a new
    tree: whoever else holds `stacked` keeps what it had)."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long)
    on = {}  # device -> idx there: one upload for all leaves

    def put(s, x):
        if s.device not in on:
            on[s.device] = idx.to(s.device)
        out = s.clone()
        out[on[s.device]] = x
        return out

    return tree_map(put, stacked, items)


def _tree_rows(tree, idx):
    """Rows `idx` of every leaf, stacked in that order (a copy); the
    indices go to each device once per value (`utils/fixed.constant`)."""
    idx = [int(i) for i in idx]
    return tree_map(lambda x: x[constant(idx, torch.int64, x.device)], tree)


# ---------------------------------------------------------------------------
# the frame program over the leading axis
# ---------------------------------------------------------------------------


def frame_auto_batched(
    states: GraphState,  # leading axis N on every leaf
    lefts,  # (N, H, W)
    rights,
    calib_cs,  # (N, 4)
    baselines,  # (N,)
    exposures,  # (N,)
    pots,  # per-sequence selector potential: (N,) integers
    settings: Settings = default_settings(),
    n_levels: int = 6,
    n_tries: int = 5,
    caps: Tuple[int, ...] = (),
    w0: int = 0,
    h0: int = 0,
    imm_cap: int = 2048,
    uniforms: Optional[Sequence[Optional[Callable]]] = None,
):
    """`frame_auto` over the sequence axis, as the JAX package's vmap of it
    computes it: the track half over all N sequences, the keyframe
    pipeline over all N, and a per-sequence select on `need_kf` on the
    device (the vmapped `lax.cond` runs both branches for every sequence).
    `need_kf` is read on the host zero times. Returns (states, bundles),
    stacked. On the card one program per N (`runtime/program.py`);
    `uniforms` (host draws) only eagerly."""
    dev = lefts.device
    args = (states, lefts, rights, calib_cs, baselines, exposures,
            _pots_on(pots, dev))
    static = dict(settings=settings, n_levels=n_levels, n_tries=n_tries, caps=tuple(caps),
                  w0=w0, h0=h0, imm_cap=imm_cap, gate=False)
    if program.active(dev):
        GS._no_host_draw(uniforms, "uniforms")
        return program.run(GS._frame_auto, args, static, key=(trace_ops.DEFAULT_ROUTE,))
    return GS._frame_auto(*args, **static, uniforms=uniforms)


def _pots_on(pots, dev) -> torch.Tensor:
    """Per-sequence potentials as an int32 tensor on `dev`: host values
    made once per device and value (`utils/fixed.constant`)."""
    if isinstance(pots, torch.Tensor):
        return pots.to(device=dev)
    return constant([int(p) for p in pots], torch.int32, dev)


def frame_track_batched(
    states: GraphState,
    lefts,
    rights,
    calib_cs,
    baselines,
    exposures,
    settings: Settings = default_settings(),
    n_levels: int = 6,
    n_tries: int = 5,
    w0: int = 0,
    h0: int = 0,
):
    """`frame_track` over the sequence axis, as one program: (states,
    bundles, aux), stacked. The whole track half runs once for all N
    sequences (`frame_track` with a leading axis), as the JAX package's
    vmap of it does; on the card as one captured program per N
    (`runtime/program.py`), which "deferred" and "gated" replay."""
    return frame_track(
        states, lefts, rights, calib_cs, baselines, exposures, settings=settings,
        n_levels=n_levels, n_tries=n_tries, w0=w0, h0=h0,
    )


def frame_kf_subset_batched(
    states_pre: GraphState,  # (N, ...) pre-track states
    aux,  # (N, ...) track aux from frame_track_batched
    calib_cs,
    baselines,
    exposures,
    pots: Sequence[int],
    idx,  # distinct indices of the sequences needing the keyframe pipeline
    settings: Settings = default_settings(),
    n_levels: int = 6,
    caps: Tuple[int, ...] = (),
    w0: int = 0,
    h0: int = 0,
    imm_cap: int = 2048,
    uniforms: Optional[Sequence[Optional[Callable]]] = None,
):
    """The keyframe pipeline over the keyframe-needing subset as one pass
    of ops (`graph_system._kf_branch` once over the rows `idx`, gathered
    from the stacked states). Returns (states, bundles), stacked over `idx`.
    On the card one program per subset size (`runtime/program.py`), which
    `BatchedRunner.warm_kf_buckets` captures before a timed run.

    The JAX function pads `idx` with duplicates to a bucket size ({1, 2, N})
    so that few program variants compile. Here a duplicate row would
    compute the same values at the cost of a whole keyframe pipeline, so
    the subset is not padded: a program per size 1..N."""
    idx = [int(i) for i in idx]
    dev = calib_cs.device
    sel = constant(idx, torch.int64, dev)
    args = (_tree_rows(states_pre, idx), _tree_rows(aux, idx), calib_cs[sel], baselines[sel],
            exposures[sel], _pots_on(pots, dev)[sel])
    static = dict(settings=settings, n_levels=n_levels, caps=tuple(caps), w0=w0, h0=h0,
                  imm_cap=imm_cap)
    if program.active(dev):
        GS._no_host_draw(uniforms, "uniforms")
        return program.run(_kf_subset, args, static, key=(trace_ops.DEFAULT_ROUTE,))
    return _kf_subset(*args, **static,
                      uniforms=None if uniforms is None else [uniforms[k] for k in idx])


def _kf_subset(states, aux, calib_cs, baselines, exposures, pots, settings: Settings,
               n_levels: int, caps: Tuple[int, ...], w0: int, h0: int, imm_cap: int,
               uniforms=None):
    """`frame_kf_subset_batched` on its gathered rows, run eagerly (what its
    program captures)."""
    return GS._kf_branch(states, aux, calib_cs, baselines, exposures, settings, n_levels, pots,
                         caps, w0, h0, imm_cap, uniforms)


class BatchedRunner:
    """Steps N bootstrapped sequences on one stacked state.

    Build per-sequence `GraphSystem`s (each bootstrapped through the host
    FullSystem past initialization), then `BatchedRunner(systems)`. Host
    bookkeeping stays per sequence; device state lives stacked, on the
    systems' device."""

    def __init__(self, systems: Sequence[GraphSystem], kf_mode: str = "deferred"):
        assert len(systems) >= 1
        assert kf_mode in ("deferred", "gated", "fused")
        self.kf_mode = kf_mode
        # pending KF hand-off for "deferred": (states_pre, aux, bundles,
        # expos, queue entry) of the latest tracked frame
        self._pending_kf = None
        self.systems: List[GraphSystem] = list(systems)
        cal0 = systems[0].calib
        for gs in systems:
            assert gs.calib.w == cal0.w and gs.calib.h == cal0.h, (
                "sequences must share the image geometry"
            )
            assert gs.device == systems[0].device, "sequences must share the device"
        self.calib = cal0
        self.device = systems[0].device
        self.settings = systems[0].settings
        self.caps = systems[0].caps
        self.states = _tree_stack([gs.state for gs in systems])
        self._pending_q = []
        self.calib_cs = torch.stack([gs.calib.c for gs in systems])
        self.baselines = torch.stack([gs.calib.baseline.to(torch.float32) for gs in systems])
        self.uniforms = [gs.uniform for gs in systems]

    def __len__(self):
        return len(self.systems)

    fetch_lag = 2  # frames the bundle fetch trails the dispatch front

    def _common(self):
        return dict(
            settings=self.settings, n_levels=self.calib.n_levels,
            w0=self.calib.w[0], h0=self.calib.h[0],
        )

    def _stacked_frames(self, frames):
        n = len(self.systems)
        if (
            isinstance(frames, tuple)
            and len(frames) == 2
            and hasattr(frames[0], "ndim")
            and frames[0].ndim == 3
        ):
            lefts, rights = (torch.as_tensor(f).to(self.device) for f in frames)
            assert lefts.shape[0] == n
            return lefts, rights
        assert len(frames) == n
        return tuple(
            torch.stack([device_image(f[j], self.device) for f in frames]) for j in (0, 1)
        )

    def add_frames(self, frames, frame_id: int, timestamp: float = 0.0,
                   exposures: Optional[Sequence[float]] = None):
        """frames: either a list of (left, right) per sequence (host arrays,
        uploaded here), or a tuple (lefts, rights) of already-stacked
        (N, H, W) tensors: pass slices of frames staged on the device to
        skip the per-frame upload. Returns the bundles drained this step
        (numpy leaves, `fetch_lag` frames behind), or None."""
        n = len(self.systems)
        if exposures is None:
            exposures = [1.0] * n
        expos = np.asarray(exposures, np.float32)
        # on a program path made once per value: a copy from the host waits
        expos = (constant(expos, torch.float32, self.device) if program.active(self.device)
                 else torch.as_tensor(expos, device=self.device))
        lefts, rights = self._stacked_frames(frames)
        common = self._common()

        pots = self._current_pots()
        if self.kf_mode == "fused":
            states, bundles = frame_auto_batched(
                self.states, lefts, rights, self.calib_cs, self.baselines,
                expos, pots, n_tries=5, caps=self.caps,
                imm_cap=self.settings.immature_cap, uniforms=self.uniforms, **common,
            )
            self.states = states
        elif self.kf_mode == "deferred":
            # resolve the PREVIOUS frame's keyframe hand-off first: its
            # track has finished, and the keyframe program runs before this
            # frame's track, the same execution order as "gated"
            self._resolve_pending_kf(pots)
            states_pre = self.states
            states, bundles, aux = frame_track_batched(
                states_pre, lefts, rights, self.calib_cs, self.baselines,
                expos, n_tries=5, **common,
            )
            self.states = states
            # the queue ENTRY (a mutable list) is captured so the KF fix-up
            # finds it however many drains shift the queue
            entry = [bundles, frame_id, timestamp]
            self._pending_kf = (states_pre, aux, bundles, expos, entry)
            self._pending_q.append(entry)
            drained = None
            while len(self._pending_q) > self.fetch_lag:
                drained = self._drain_one()
            return drained
        else:
            states_pre = self.states
            states, bundles, aux = frame_track_batched(
                states_pre, lefts, rights, self.calib_cs, self.baselines,
                expos, n_tries=5, **common,
            )
            need = np.nonzero(np.asarray(host.tolist(bundles.need_kf)))[0]
            if need.size:
                st_b, b_b, idx = self._dispatch_kf_subset(
                    states_pre, aux, expos, pots, need, common
                )
                states = _tree_scatter(states, st_b, idx)
                bundles = _tree_scatter(bundles, b_b, idx)
            self.states = states
        self._pending_q.append([bundles, frame_id, timestamp])
        drained = None
        while len(self._pending_q) > self.fetch_lag:
            drained = self._drain_one()
        return drained

    def _dispatch_kf_subset(self, states_pre, aux, expos, pots, need, common):
        """The keyframe pipeline over the sequences `need`, one pass of ops
        for all of them (not padded to the JAX module's {1, 2, N} buckets:
        see `frame_kf_subset_batched`). Returns (states, bundles, indices)
        to scatter."""
        st_b, b_b = frame_kf_subset_batched(
            states_pre, aux, self.calib_cs, self.baselines, expos, pots, need,
            caps=self.caps, imm_cap=self.settings.immature_cap, uniforms=self.uniforms, **common,
        )
        return st_b, b_b, need

    def _resolve_pending_kf(self, pots):
        """Deferred-mode hand-off: fetch the previous frame's need_kf flags
        (its track has already run), run the keyframe pipeline for the
        sequences that need it, and scatter the post-KF states/bundles in.
        The tracked-but-pre-KF speculative state of those sequences is
        replaced wholesale: identical semantics to "gated", one step later
        on the host, same order on the device."""
        if self._pending_kf is None:
            return
        states_pre, aux, bundles, expos, entry = self._pending_kf
        self._pending_kf = None
        need = np.nonzero(np.asarray(host.tolist(bundles.need_kf)))[0]
        if not need.size:
            return
        st_b, b_b, idx = self._dispatch_kf_subset(
            states_pre, aux, expos, pots, need, self._common()
        )
        self.states = _tree_scatter(self.states, st_b, idx)
        # fix up the queued (not-yet-drained) bundle entry of that frame so
        # host bookkeeping sees the keyframe result, not the track-only one
        entry[0] = _tree_scatter(entry[0], b_b, idx)

    def _current_pots(self):
        return [int(gs.pot) for gs in self.systems]

    def warm_kf_buckets(self, frame=None):
        """Capture, before a timed run, every program the steady-state loop
        replays, without touching the runner's state (the JAX runner
        compiles its keyframe buckets here): the track program, the
        keyframe subset's for every size 1..N ("deferred", "gated") or the
        "fused" one. frame: one (left, right) pair or stacked (N, H, W)
        images (only their shapes matter); without it, or off the card or
        inside `program.disabled()`, only the CUDA kernels are built."""
        if self.device.type != "cuda":
            return
        from stereo_dso_g2o_tpu_torch.ops import trace_cuda

        trace_cuda.build()
        if frame is None or not program.active(self.device):
            return
        n = len(self.systems)
        lefts, rights = (torch.as_tensor(f).to(self.device) for f in frame)
        if lefts.dim() == 2:
            lefts, rights = (x.expand((n,) + tuple(x.shape)) for x in (lefts, rights))
        common = self._common()
        expos = constant([1.0] * n, torch.float32, self.device)
        pots = self._current_pots()
        if self.kf_mode == "fused":
            frame_auto_batched(self.states, lefts, rights, self.calib_cs, self.baselines, expos,
                               pots, n_tries=5, caps=self.caps,
                               imm_cap=self.settings.immature_cap, **common)
            return
        _, _, aux = frame_track_batched(self.states, lefts, rights, self.calib_cs,
                                        self.baselines, expos, n_tries=5, **common)
        for size in range(1, n + 1):
            frame_kf_subset_batched(self.states, aux, self.calib_cs, self.baselines, expos, pots,
                                    list(range(size)), caps=self.caps,
                                    imm_cap=self.settings.immature_cap, **common)

    def _drain_one(self):
        bundles, frame_id, timestamp = self._pending_q.pop(0)
        # one wait, for a packed copy of the frame's bundles; it starts here,
        # since a "deferred" keyframe replaces some of them until then
        b_all = FrameBundle(*host.Fetch(bundles).get())
        for k, gs in enumerate(self.systems):
            bk = FrameBundle(*[x[k] for x in b_all])
            # apply_bundle also adapts gs.pot per sequence; the value, stale
            # by the lag, feeds the next dispatch
            gs.apply_bundle(bk, frame_id, timestamp, len(gs.kf_shells) - 1)
        return b_all

    def flush(self):
        # a pending keyframe hand-off must land before its bundle drains
        self._resolve_pending_kf(self._current_pots())
        while self._pending_q:
            self._drain_one()

    def trajectories(self):
        self.flush()
        return [gs.trajectory() for gs in self.systems]
