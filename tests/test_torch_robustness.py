"""The port's twins of the reference's long-run divergence checks
(tests/test_robustness.py), each on the same rendered window
(test_ba.py's `_build_window`, bridged from the JAX package) and held to
the JAX test's own bound, run through the loop that BA's WHILE node runs
(`ba.optimize_fused` over `utils/loop.while_loop`), host-driven and at
its bound (`utils/loop.bounded`, what the node computes):

- BA survives a valid frame whose residuals all died (test_robustness.py:25);
- BA zeroes a non-finite step instead of spreading it (:45);
- the OOB-recency flag survives the pruning of the residual (:57).
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import fields, t
from test_ba import _build_window

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.utils import loop

SET = bridge.settings_from_fields(dataclasses.asdict(jdefault_settings()))
MODES = ("host", "bounded")


def _loops(name):
    return loop.bounded() if name == "bounded" else contextlib.nullcontext()


def _window(**kw):
    win, dI_stack, *_ = _build_window(n_pts=96)
    win = win.replace(**{k: f(win) for k, f in kw.items()})
    return bridge.window_from_numpy(fields(win), device="cpu"), t(dI_stack)


@pytest.mark.parametrize("mode", MODES)
def test_ba_survives_unsupported_frame(mode):
    """A valid frame whose residuals all died (zero pose information, no
    marginal prior) must not NaN the solve; its own pose must not move.
    Three trips, as the JAX test's three iterations."""
    win, dI = _window(frame_valid=lambda w: w.frame_valid.at[3].set(True),
                      frame_id=lambda w: w.frame_id.at[3].set(99))
    s = dataclasses.replace(SET, min_opt_iterations=3)  # no early stop before the third
    with _loops(mode):
        out, energy, nres = ba.optimize_fused(win, dI, settings=s, max_its=3)
    assert np.isfinite(out.state.numpy()).all()
    assert np.isfinite(float(energy))
    # the unsupported frame's step is pinned in the solve; only the gauge
    # orthogonalization may move it (by the same small amount as everyone)
    assert np.abs(out.state.numpy()[3]).max() < 0.05


@pytest.mark.parametrize("mode", MODES)
def test_ba_rejects_nonfinite_steps(mode):
    """Poisoned linearization data must not propagate NaN through the step
    (the in-solver sanity gate zeroes the whole increment)."""
    win, dI = _window(HM=lambda w: w.HM.at[0, 0].set(jnp.nan))
    with _loops(mode):
        out, _, _ = ba.optimize_fused(win, dI, settings=SET, max_its=1)
    assert np.isfinite(out.state.numpy()).all()
    assert np.isfinite(out.pt_idepth.numpy()).all()


@pytest.mark.parametrize("mode", MODES)
def test_flag_points_oob_recency_survives_pruning(mode):
    """A point whose residual in the newest keyframe went OOB must be
    flagged even after that residual's res_exists was pruned: the recorded
    res_state is the reference's lastResiduals[..].second (isOOB,
    HessianBlocks.h:458). The window first runs one BA trip, as a
    keyframe's does before its points are flagged; the slots are device
    tensors, as the keyframe program passes them."""
    win, dI = _window()
    with _loops(mode):
        win, _, _ = ba.optimize_fused(win, dI, settings=SET, max_its=1)
    last_slot, prev_slot, pt = 2, 1, 5
    num_good = win.pt_num_good_res.clone()
    num_good[pt] = 100  # solid history, so only the recency rule fires
    res_state, res_exists = win.res_state.clone(), win.res_exists.clone()
    res_state[pt, last_slot] = W.RES_OOB  # recorded OOB in the newest keyframe
    res_exists[pt, last_slot] = False  # its residual pruned
    win = win.replace(pt_num_good_res=num_good, res_state=res_state, res_exists=res_exists)
    out = ba.flag_points_for_removal(
        win, dI, torch.zeros((win.F,), dtype=torch.bool), torch.tensor(last_slot),
        torch.tensor(prev_slot), settings=SET)
    st = out.pt_status.numpy()
    assert st[pt] in (W.PT_MARGINALIZE, W.PT_DROP), (
        "OOB-in-newest-KF point must leave the active set")
    # control: an identical point whose newest residual is IN stays active
    assert st[6] == W.PT_ACTIVE
