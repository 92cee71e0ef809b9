"""MODE_STEREOMATCH: the port's `frontend/stereo_match.py` against the JAX
package's on test_stereo_match.py's pair (256x128, default settings), on
both routes of the epipolar search.

Tolerances: the consistency gate is a chain of threshold decisions on f32
values, so `good` is identical on >= 99.5 % of slots; on the common good
slots the inverse depth agrees to 1e-4 relative (the trace module's
target). The selected pixels are identical (the selector is exact)."""

import numpy as np
import pytest
import torch
from _torch_parity import jax_uniform, n

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.frontend import stereo_match as jsm
from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu_torch.config import default_settings as tdefault_settings
from stereo_dso_g2o_tpu_torch.frontend import stereo_match as tsm
from stereo_dso_g2o_tpu_torch.models.camera import make_calib as tmake_calib
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.ops.selector import PixelSelector

JSET, TSET = jdefault_settings(), tdefault_settings()
W_, H_, B_ = 256, 128, 0.15


def _calibs():
    K = synthetic.default_K(W_, H_)
    a = (K[0, 0], K[1, 1], K[0, 2], K[1, 2], B_, W_, H_)
    return jmake_calib(*a, n_levels=4), tmake_calib(*a, n_levels=4, device="cpu")


@pytest.fixture(scope="module")
def pair():
    scene = synthetic.default_scene(11)
    left, right, idepth_gt = synthetic.render_stereo_pair(scene, synthetic.default_K(W_, H_), W_, H_, B_)
    jc, _ = _calibs()
    jres, jmap = jsm.stereo_match(left, right, jc, settings=JSET)
    return left, right, idepth_gt, jres, np.array(jmap)


@pytest.mark.parametrize("route", [None, "resident", "slab"])
def test_stereo_match_matches_jax(pair, route):
    left, right, idepth_gt, jres, jmap = pair
    _, tc = _calibs()
    res, imap = tsm.stereo_match(left, right, tc, selector=PixelSelector(TSET, uniform=jax_uniform),
                                 settings=TSET, device="cpu", route=route)
    np.testing.assert_array_equal(n(res.valid), np.array(jres.valid))
    np.testing.assert_array_equal(n(res.us), np.array(jres.us))
    np.testing.assert_array_equal(n(res.vs), np.array(jres.vs))
    good, jgood = n(res.good), np.array(jres.good)
    assert (good == jgood).mean() >= 0.995, (good == jgood).mean()
    both = good & jgood
    assert both.sum() > 150
    for f in ("idepth", "idepth_min", "idepth_max"):
        np.testing.assert_allclose(n(getattr(res, f))[both], np.array(getattr(jres, f))[both],
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    # test_stereo_match.py's own checks, on the port
    us, vs, est = n(res.us).astype(int), n(res.vs).astype(int), n(res.idepth)
    gt = idepth_gt[vs, us]
    rel = np.abs(est[good] - gt[good]) / gt[good]
    assert np.median(rel) < 0.03 and (rel > 0.2).mean() < 0.05
    m = n(imap)
    assert m.shape == (H_, W_, 3)
    assert (m[vs[good], us[good], 0] == est[good]).all()
    assert (n(res.idepth_min)[good] <= n(res.idepth_max)[good]).all()
    # the map: the JAX map where both accepted, zero where nothing was accepted
    np.testing.assert_allclose(m[vs[both], us[both]], jmap[vs[both], us[both]], rtol=1e-4, atol=1e-6)
    assert int((m[..., 0] != 0).sum()) == int(good.sum())


def test_stereo_match_rejects_textureless():
    flat = np.full((H_, W_), 128.0, dtype=np.float32)
    jc, tc = _calibs()
    jres, _ = jsm.stereo_match(flat, flat, jc, settings=JSET)
    res, imap = tsm.stereo_match(flat, flat, tc, settings=TSET, device="cpu")
    assert int(n(res.good).sum()) == int(np.array(jres.good).sum()) < 20
    assert float(imap.abs().max()) == 0.0


def test_stereo_match_takes_the_gate_route(pair, monkeypatch):
    """Above the 6 MB gate both traces of stereo_match go through the slab
    wrapper; below it through the resident one."""
    left, right = pair[0], pair[1]
    _, tc = _calibs()
    calls = []
    monkeypatch.setattr(tk, "epipolar_search", lambda *a, **k: calls.append("resident") or
                        tk.epipolar_search_ref(*a, **k))
    monkeypatch.setattr(tk, "epipolar_search_slab", lambda *a, **k: calls.append("slab") or
                        tk.epipolar_search_slab_ref(*a, **k))
    tsm.stereo_match(left, right, tc, settings=TSET, device="cpu")
    monkeypatch.setattr(tk, "uses_slab_route", lambda H, W: True)
    tsm.stereo_match(torch.from_numpy(left), torch.from_numpy(right), tc, settings=TSET, device="cpu")
    assert calls == ["resident", "resident", "slab", "slab"]


def test_entry_points_default_to_the_gpu():
    """With no `device` argument and no CUDA device every entry point
    raises, naming device="cpu" as the way to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    from stereo_dso_g2o_tpu_torch import bridge, default_device
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.io import synthetic as tsyn

    K = synthetic.default_K(W_, H_)
    _, tc = _calibs()
    scene = tsyn.corridor_scene(seed=1, length=20.0)
    calls = [
        lambda: default_device(),
        lambda: tmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], B_, W_, H_, n_levels=4),
        lambda: FullSystem(tc, TSET),
        lambda: tsm.stereo_match(np.zeros((H_, W_), np.float32), np.zeros((H_, W_), np.float32), tc),
        lambda: tsyn.render_multi_batch(scene, K, 32, 16, np.eye(4)[None]),
        lambda: tsyn.render_stereo_sequence_fast(scene, K, 32, 16, B_, [np.eye(4)]),
        lambda: bridge.calib_from_numpy(np.ones(4), 0.1, 32, 16, 1),
        lambda: bridge.window_from_numpy({}),
        lambda: bridge.immature_from_numpy({}),
        lambda: bridge.graph_state_from_numpy({}),
        lambda: bridge.full_system_from_snapshot({}, tc, TSET),
        lambda: bridge.graph_system_from_snapshot({}, tc, TSET),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert default_device("cpu") == torch.device("cpu")
    assert tc.c.device.type == "cpu"
