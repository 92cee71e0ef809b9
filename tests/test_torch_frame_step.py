"""The port's twins of the JAX package's `tests/test_frame_step.py:66`
(the in-program retry ladder recovers a bad try 0) and `:114` (`_select`,
"best" against "sequential"), each held to the JAX test's own bound. The
port's `frame_step_full` and `_select` run N sequences at once: the ladder
runs as the batch of one, and the four `_select` cases run each alone and
all four as one batch of four sequences, which must pick per sequence what
each picks alone."""

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.backend import builder
from stereo_dso_g2o_tpu_torch.backend import window as Wb
from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.frontend import frame_step as FS
from stereo_dso_g2o_tpu_torch.frontend import immature as IMM
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import CoarseTracker
from stereo_dso_g2o_tpu_torch.io import synthetic
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.utils import se3

SET = default_settings()
N_LVL = 5
W_, H_ = 256, 128


def _se3_exp(xi):
    return se3.se3_exp(torch.tensor(xi, dtype=torch.float64)).numpy()


def _setup(seed):
    """tests/test_frame_step.py::_setup on the port: a reference from 1200
    random pixels of a rendered plane at their true inverse depth."""
    scene = synthetic.default_scene(seed)
    K = synthetic.default_K(W_, H_)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.15, W_, H_, n_levels=N_LVL,
                       device="cpu")
    ref_img, idepth = synthetic.render(scene, K, W_, H_, np.eye(4))
    dI_ref, _ = build_pyramid(torch.as_tensor(ref_img), N_LVL)
    rng = np.random.default_rng(seed)
    n = 1200
    us = rng.integers(6, W_ - 6, n).astype(np.float32)
    vs = rng.integers(6, H_ - 6, n).astype(np.float32)
    ids = idepth[vs.astype(int), us.astype(int)]
    tracker = CoarseTracker(calib, SET)
    tracker.set_reference(dI_ref, torch.as_tensor(us), torch.as_tensor(vs),
                          torch.as_tensor(ids), torch.ones(n), torch.ones(n, dtype=torch.bool))
    return scene, K, calib, tracker


def test_frame_step_full_ladder_recovers_bad_init():
    """With a bad try 0 the ladder still finds the pose through the other
    hypotheses (bound: the JAX test's 5e-3 in translation)."""
    scene, K, calib, tracker = _setup(22)
    T_gt = _se3_exp([0.04, -0.01, 0.05, 0.002, 0.006, -0.001])
    img, _ = synthetic.render(scene, K, W_, H_, T_gt)
    right, _ = synthetic.render(scene, K, W_, H_, synthetic.stereo_pose(T_gt, 0.15))
    win = Wb.empty_window(8, 64, calib.c, "cpu")
    win = builder.insert_frame(win, 0, np.eye(4), (0.0, 0.0), 1.0, 0)
    imm = IMM.empty(8, 64, "cpu")
    # try 0 is far off; try 3 is the identity (closest to truth)
    T_bad = _se3_exp([0.6, 0.3, -0.4, 0.15, -0.1, 0.2])
    tries = np.stack([T_bad, T_bad, T_bad, np.eye(4), T_bad])
    f32 = torch.float32
    pyrs, imm2, track, used_ladder = FS.frame_step_full(
        torch.as_tensor(img), torch.as_tensor(right), tuple(tracker.ref), win, imm,
        calib.c, calib.baseline, torch.tensor(0),
        torch.as_tensor(tries, dtype=f32), torch.zeros(2), tracker.ref_aff,
        torch.tensor(1.0), torch.tensor(1.0),
        torch.tensor(1e-3),  # force the ladder even if try 0 "succeeds"
        settings=SET, n_levels=N_LVL, n_tries=5,
    )
    assert bool(used_ladder)
    assert bool(track.ok)
    err = se3.se3_log(torch.as_tensor(track.T.numpy().astype(np.float64) @ np.linalg.inv(T_gt)))
    assert float(torch.linalg.norm(err[:3])) < 5e-3, err


def _mk(res0s, oks, sat0=0.0):
    """One sequence's K hypotheses as a (1, K) batch."""
    n = len(res0s)
    return FS.TrackOut(
        T=torch.stack([torch.eye(4) * (k + 1) for k in range(n)])[None],
        aff=torch.zeros((1, n, 2)),
        residuals=torch.tensor([[r] * 5 for r in res0s], dtype=torch.float32)[None],
        flow=torch.zeros((1, n, 3)),
        ok=torch.tensor(oks)[None],
        sat_frac0=torch.full((1, n), sat0, dtype=torch.float32),
    )


# (hypotheses, last coarse RMSE, {policy: (residual picked, ok)})
SELECT_CASES = [
    # try 0 passes the accept gate but try 3 is slightly lower: sequential
    # stops at try 0, best switches to try 3
    (([10.0, 12.0, 11.0, 9.75, 20.0], [True] * 5), 10.0,
     {"sequential": (10.0, True), "best": (9.75, True)}),
    # try 0 failed (coverage guard): sequential takes the FIRST ok try that
    # passes the gate (12 < 10*1.5) and stops; best scans all
    (([5.0, 12.0, 9.0, 9.75, 20.0], [False, True, True, True, True]), 10.0,
     {"sequential": (12.0, True), "best": (9.0, True)}),
    # nothing ok: ok=False surfaces (isLost handling upstream)
    (([5.0, 6.0, 7.0, 8.0, 9.0], [False] * 5), 10.0,
     {"sequential": (None, False), "best": (None, False)}),
    # a saturated try 0 does not win under "best" even with the lowest residual
    (([5.0, 6.0, 7.0, 8.0, 9.0], [True] * 5, 0.9), 100.0, {"best": (6.0, True)}),
]


def _check(sel, k, want):
    res, ok = want
    assert bool(sel.ok[k]) == ok
    if res is not None:
        assert float(sel.residuals[k, 0]) == res


def test_hypothesis_selection_policies():
    """`_select`: "best" takes the lowest finite-ok residual (try 0 preferred
    when good); "sequential" replays trackNewCoarse STEP2-4 and stops at the
    accept gate. Each case alone, then the four as one batch."""
    for policy in ("sequential", "best"):
        s = Settings(hypothesis_selection=policy)
        cases = [(_mk(*hyp), last, want[policy]) for hyp, last, want in SELECT_CASES
                 if policy in want]
        for tb, last, want in cases:
            _check(FS._select(tb, torch.tensor([last]), s, 5), 0, want)
        batch = FS.TrackOut(*[torch.cat(xs) for xs in zip(*[tb for tb, _, _ in cases])])
        lasts = torch.tensor([last for _, last, _ in cases])
        sel = FS._select(batch, lasts, s, 5)
        for k, (_, _, want) in enumerate(cases):
            _check(sel, k, want)
