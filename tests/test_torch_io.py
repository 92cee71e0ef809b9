"""The port's output wrappers, viewer and debug overlays against the JAX
package's: the same JSON lines and stdout lines for the same poses and
cloud (numpy or tensors), the same accumulated cloud, the same overlay
arrays; the renderers write PNGs."""

import contextlib
import io

import numpy as np
import pytest
import torch

from stereo_dso_g2o_tpu.io import debug_viz as jviz
from stereo_dso_g2o_tpu.io import output_wrapper as jow
from stereo_dso_g2o_tpu.io import viewer as jviewer
from stereo_dso_g2o_tpu_torch.io import debug_viz as tviz
from stereo_dso_g2o_tpu_torch.io import output_wrapper as tow
from stereo_dso_g2o_tpu_torch.io import viewer as tviewer


def _poses(rng, n):
    out = []
    for _ in range(n):
        T = np.eye(4)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T[:3, :3] = q
        T[:3, 3] = rng.normal(size=3)
        out.append(T)
    return out


def _cloud(rng, n=40):
    return {"xyz": rng.normal(size=(n, 3)) * 5.0, "idepth": rng.uniform(0.05, 1.0, n),
            "host_kf_id": rng.integers(0, 3, n)}


class _FakeSystem:
    """What the viewer reads of a running system: `point_cloud()`."""

    def __init__(self, clouds):
        self.clouds = list(clouds)

    def point_cloud(self):
        return self.clouds.pop(0)


def _publish(module, poses, cloud, as_tensor):
    conv = (lambda x: torch.as_tensor(x)) if as_tensor else (lambda x: x)
    fh = io.StringIO()
    w = module.JsonlOutputWrapper(fh)
    for i, T in enumerate(poses):
        w.publish_cam_pose(i, conv(T), 0.1 * i)
    w.publish_keyframes([(k, conv(T)) for k, T in enumerate(poses[:3])],
                        {k: conv(v) for k, v in cloud.items()} if cloud else cloud)
    w.publish_keyframes([(0, conv(poses[0]))], None)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        s = module.SampleOutputWrapper()
        for i, T in enumerate(poses):
            s.publish_cam_pose(i, conv(T), 0.1 * i)
    return fh.getvalue(), text.getvalue()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_output_wrappers_match_jax(as_tensor):
    rng = np.random.default_rng(0)
    poses, cloud = _poses(rng, 5), _cloud(rng)
    got = _publish(tow, poses, cloud, as_tensor)
    want = _publish(jow, poses, cloud, False)
    assert got == want
    assert got[0].count('"type": "pose"') == 5 and got[0].count('"type": "keyframes"') == 2
    base = tow.Output3DWrapper()
    assert base.publish_graph(None) is None and base.join() is None


def test_cloud_accumulator_and_renderers(tmp_path):
    rng = np.random.default_rng(1)
    clouds = [_cloud(rng, 30), _cloud(rng, 50)]
    ta, ja = tviewer.CloudAccumulator(), jviewer.CloudAccumulator()
    for c in clouds:
        ta.update_from(_FakeSystem([c]))
        ja.update_from(_FakeSystem([c]))
    for a, b in zip(ta.cloud(), ja.cloud()):
        np.testing.assert_array_equal(a, b)
    assert set(ta.per_kf) == set(np.unique(clouds[1]["host_kf_id"]).tolist()) | set(
        np.unique(clouds[0]["host_kf_id"]).tolist())
    xyz, idp = ta.cloud()
    out = tmp_path / "run.png"
    assert tviewer.render_run(str(out), _poses(rng, 6), xyz, idp, gt_trajectory=_poses(rng, 6)) == str(out)
    assert out.stat().st_size > 0
    feed = tmp_path / "feed.jsonl"
    feed.write_text(_publish(tow, _poses(rng, 4), clouds[0], False)[0] + "not json\n")
    png = tmp_path / "feed.png"
    tviewer.render_feed(str(feed), str(png))
    assert png.stat().st_size > 0
    empty = tviewer.CloudAccumulator().cloud()
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_debug_overlays_match_jax(as_tensor, tmp_path):
    rng = np.random.default_rng(2)
    H, W = 40, 56
    img = rng.uniform(-10, 270, (H, W)).astype(np.float32)
    n = 60
    us, vs = rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)
    idp, valid = rng.uniform(0.1, 2.0, n), rng.uniform(size=n) < 0.8
    status = rng.choice([0, 1, 2, 4], (H, W))
    conv = torch.as_tensor if as_tensor else (lambda x: x)
    got = tviz.idepth_overlay(conv(img), conv(us), conv(vs), conv(idp), conv(valid))
    np.testing.assert_array_equal(got, jviz.idepth_overlay(img, us, vs, idp, valid))
    np.testing.assert_array_equal(
        tviz.idepth_overlay(conv(img), conv(us), conv(vs), conv(idp), conv(np.zeros(n, bool))),
        jviz.idepth_overlay(img, us, vs, idp, np.zeros(n, bool)))
    sel = tviz.selection_overlay(conv(img), conv(status))
    np.testing.assert_array_equal(sel, jviz.selection_overlay(img, status))
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    tviz.save_png(str(tmp_path / "o.png"), got)
    assert (tmp_path / "o.png").stat().st_size > 0
