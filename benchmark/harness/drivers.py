"""The general traffic generator: one reader of every traffic file.

A traffic file (`benchmark/traffic/<name>.json`) names the session kind
that drives the port (`"session"`) and the parameters of the drives it
sends; the configuration (`benchmark/configs/<name>.json`) gives the rig
and the port's Settings. `make_session` loads the kind's file,
`benchmark/sessions/<kind>.py`, by its name, so that a new kind is a new
file: `graph` drives one system through `GraphSystem.add_frame`, `batched`
several through `BatchedRunner.add_frames`.

A session's `call()` makes one call into the port and returns the keys of
the frames it submitted and of those whose result reached the host during
it; the harness stamps both. Everything a session renders is made in
`setup()`, on the device. Drive k of a traffic mix is the same for every
seed (the corridor of `[scene_seed, k]`, the exposure 1 + amp sin(rate i
+ k)); the seed orders the drives over a batch's slots. It changes no
frame: drawn from the seed, the textures alone moved a drive's rate from
11.0 to 16.1 frames/s (PERF.md), so every seed does the same work.

Copied from `stereo_dso_g2o_tpu_torch/bench.py` at commit
6bc983070e31600c426f47f1ed626131eb797c90: the drive (`render_sequence`:
a scene `step * frames + 40` m long, the exposure `1 + 0.12 sin(0.25 i + k)`
of sequence k, which the port is not told of), the 12 bootstrap frames
through `FullSystem` and the 8 warm frames before timing,
`BatchedRunner.warm_kf_buckets`, and `bench_settings` (the configuration's
`settings` are its keys).
"""

from __future__ import annotations

import importlib.util
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from . import render

SESSIONS = Path(__file__).resolve().parent.parent / "sessions"


def settings_of(cfg):
    from stereo_dso_g2o_tpu_torch.config import Settings

    return Settings(**cfg["settings"])


def calib_of(cfg, device):
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    K = render.default_K(cfg["width"], cfg["height"], fov_deg=cfg["fov_deg"])
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["baseline_m"], cfg["width"],
                       cfg["height"], n_levels=cfg["levels"], device=device)
    return K, calib


class Drive:
    """One rendered drive: its frames on the device, its true poses and
    the scene they were rendered from."""

    def __init__(self, cfg, traffic, index, device, n_frames):
        step = traffic["step_m"]
        self.index = index
        self.poses_cw = render.forward_trajectory(
            n_frames, step=step, yaw_amp=traffic["yaw_amp"], yaw_period=traffic["yaw_period"])
        self.c2w = np.linalg.inv(self.poses_cw)  # (N, 4, 4) camera-to-world, float64
        self.rects = render.corridor_scene([traffic["scene_seed"], index],
                                           length=step * n_frames + 40.0,
                                           box_spacing=traffic["box_spacing"],
                                           lateral=traffic["lateral"])
        expos = 1.0 + traffic["exposure_amp"] * np.sin(
            traffic["exposure_rate"] * np.arange(n_frames) + index)
        self.K = render.default_K(cfg["width"], cfg["height"], fov_deg=cfg["fov_deg"])
        self.w, self.h = cfg["width"], cfg["height"]
        self.scene = render.Scene(self.rects, device)
        self.lefts, self.rights = render.render_stereo(
            self.scene, self.K, self.w, self.h, cfg["baseline_m"], self.poses_cw, expos)
        self.n = n_frames

    def true_idepth(self, frames, dtype=torch.float32):
        """(len(frames), h, w) host array: the true inverse depth of those
        frames' left images at pixel centres, the ray caster in `dtype`."""
        scene = self.scene if dtype == torch.float32 else render.Scene(
            self.rects, self.scene.device, dtype)
        idep = render.true_idepth(scene, self.K, self.w, self.h, self.poses_cw[list(frames)])
        return idep.float().cpu().numpy()


def _rendered(device, t0):
    """Seconds since t0 once the rendering is done; the peak memory the
    run reports starts after it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    return time.perf_counter() - t0


def _bootstrap(calib, settings, drive, boot, device, period):
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphSystem

    fs = FullSystem(calib, settings, device=device)
    for i in range(boot):
        fs.add_frame(drive.lefts[i], drive.rights[i], i, timestamp=period * i)
    return GraphSystem.from_full_system(fs)


class DriveSession:
    """What every session kind shares: drives, the pending queue of
    submitted keys, the restart when a window outruns the drives, and the
    answers read back once the window has closed. A kind defines `layer`,
    `_submit`, `_flush`, `_windows` and `label_calls` / `is_kf_call`."""

    layer = ""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.n_drives = int(traffic.get("drives", 1))
        self.boot, self.warm = int(traffic["boot_frames"]), int(traffic["warm_frames"])
        self.period = 1.0 / float(cfg["rate_hz"])
        self.pending = deque()
        self.runs = []  # the GraphSystems of each start of the drives
        self.starts = 0

    def setup(self):
        self.settings = settings_of(self.cfg)
        self.K, self.calib = calib_of(self.cfg, self.device)
        t0 = time.perf_counter()
        self.drives = self.render_drives(int(self.traffic["frames"]))
        self._stage()
        self.render_s = _rendered(self.device, t0)
        self._start()
        for _ in range(self.warm):
            self._advance()
        self.flush()

    def render_drives(self, n):
        """The drives, `n` frames each, in the slot order the seed draws."""
        order = np.random.default_rng(self.seed).permutation(self.n_drives)
        return [Drive(self.cfg, self.traffic, int(k), self.device, n) for k in order]

    def _stage(self):
        """Lay the rendered frames out as the session's calls take them."""

    def _start(self):
        """Bootstrap every drive anew from frame 0 (a new start of the same
        drives: its keys carry the start's number)."""
        self.gss = [_bootstrap(self.calib, self.settings, d, self.boot, self.device, self.period)
                    for d in self.drives]
        self.i = self.boot
        self.runs.append(self.gss)
        self.starts += 1

    def _drained(self, before):
        """Keys whose results reached the host since `before` = the first
        system's history length then."""
        done = []
        for _ in range(len(self.gss[0].history) - before):
            done.extend(self.pending.popleft())
        return done

    def call(self):
        """One call into the port: (keys submitted, keys completed)."""
        if self.i >= self.drives[0].n:
            # the window outran the drives: start them again, bootstrap
            # included; each bootstrap frame completes within its call
            self.flush()
            self._start()
            keys = [(self.starts - 1, k, i) for i in range(self.boot) for k in range(self.n_drives)]
            return keys, keys
        return self._advance()

    def _advance(self):
        keys = [(self.starts - 1, k, self.i) for k in range(self.n_drives)]
        before = len(self.gss[0].history)
        self.pending.append(keys)
        self._submit(self.i)
        self.i += 1
        return keys, self._drained(before)

    def flush(self):
        before = len(self.gss[0].history)
        self._flush()
        return self._drained(before)

    def answers(self):
        """{(start, drive, frame): camera-to-world (4, 4)} of every frame of
        every start, and the starts whose drive was lost."""
        self.flush()
        poses, lost = {}, set()
        for r, gss in enumerate(self.runs):
            for k, gs in enumerate(gss):
                try:
                    traj = gs.trajectory()
                except Exception as e:  # no poses come: every frame of the drive fails
                    print(f"drive {k} of start {r} gave no trajectory: {e!r}", file=sys.stderr)
                    lost.add((r, k))
                    continue
                if gs.is_lost:
                    lost.add((r, k))
                for sh, T in zip(gs.history, traj):
                    poses[(r, k, sh.id)] = np.asarray(T, np.float64)
        return poses, lost

    def final_windows(self):
        """What BA left in each system's final window: [(start, drive,
        keyframes [(frame id, camera-to-world)], points)], points a dict of
        host arrays (frame id of the host keyframe, camera-to-world of that
        keyframe, pixel u, v in it, inverse depth), the window's active
        points as the port's viewer feed hands them over."""
        from stereo_dso_g2o_tpu_torch.frontend.full_system import window_point_cloud

        self.flush()
        out = []
        for r, k, gs, win in self._windows():
            kfs = [(gs.kf_shells[i].id, np.asarray(gs.kf_shells[i].T_cw, np.float64))
                   for i in sorted(gs.slot_frame_id.values())]
            pc = window_point_cloud(win, gs.calib, gs.slot_frame_id)
            host = np.asarray(pc["host_kf_id"], np.int64)
            ok = host >= 0
            host, xyz, idp = host[ok], np.asarray(pc["xyz"])[ok], np.asarray(pc["idepth"])[ok]
            c2w = np.stack([np.asarray(gs.kf_shells[h].T_cw, np.float64) for h in host]) \
                if len(host) else np.zeros((0, 4, 4))
            # the pixel each point was placed from, in its host keyframe
            Xc = np.einsum("nji,nj->ni", c2w[:, :3, :3], xyz - c2w[:, :3, 3])
            u = self.K[0, 0] * Xc[:, 0] / Xc[:, 2] + self.K[0, 2]
            v = self.K[1, 1] * Xc[:, 1] / Xc[:, 2] + self.K[1, 2]
            frames = np.array([gs.kf_shells[h].id for h in host], np.int64)
            out.append((r, k, kfs, {"frame": frames, "u": u, "v": v, "idepth": idp}))
        return out

    def truth(self):
        return self.drives

    def keyframes(self):
        return sum(len(gs.kf_shells) for gss in self.runs for gs in gss)

    def extra_call(self):
        """One more frame after the answers were taken (the next, or the
        last again): the harness records its searches."""
        self._submit(min(self.i, self.drives[0].n - 1))


def load_kind(name: str, sessions: Path = SESSIONS):
    """The session class of `<sessions>/<name>.py` (`benchmark/sessions/`)."""
    path = Path(sessions) / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no session kind {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark_session_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Session


def make_session(cfg, traffic, seed, device, sessions: Path = SESSIONS):
    return load_kind(traffic["session"], sessions)(cfg, traffic, seed, device)
