"""The PyTorch port's scene builders and ray caster against the JAX
package's: the numpy builders are copies (equal outputs), the torch ray
caster renders the same corridor as `_raycast_jax`."""

import dataclasses

import numpy as np
import pytest

from stereo_dso_g2o_tpu.io import synthetic as jsyn
from stereo_dso_g2o_tpu_torch.io import synthetic as tsyn


def test_scene_builders_match():
    np.testing.assert_array_equal(tsyn.default_K(1216, 352, 80.0), jsyn.default_K(1216, 352, 80.0))
    for a, b in zip(tsyn.forward_trajectory(9, step=0.3, yaw_amp=0.1, yaw_period=8.0),
                    jsyn.forward_trajectory(9, step=0.3, yaw_amp=0.1, yaw_period=8.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn.stereo_pose(np.eye(4), 0.54), jsyn.stereo_pose(np.eye(4), 0.54))
    ts = tsyn.corridor_scene(seed=3, length=20.0, box_spacing=5.0, lateral=6.0)
    js = jsyn.corridor_scene(seed=3, length=20.0, box_spacing=5.0, lateral=6.0)
    tp, jp = tsyn._pack_scene(ts), jsyn._pack_scene(js)
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert [f.name for f in dataclasses.fields(ts.rects[0])] == [
        f.name for f in dataclasses.fields(js.rects[0])
    ]


@pytest.fixture(scope="module")
def sequence():
    w, h, base = 160, 96, 0.3
    K = jsyn.default_K(w, h, fov_deg=80.0)
    scene = jsyn.corridor_scene(seed=7, length=14.0, box_spacing=4.0, lateral=5.0)
    poses = jsyn.forward_trajectory(3, step=0.3, yaw_amp=0.1, yaw_period=10.0)
    expos = np.array([1.0, 0.9, 1.12])
    return w, h, base, K, scene, poses, expos


def test_raycast_matches_jax(sequence):
    """Both sides intersect every rectangle in f32 and sample the same
    textures bilinearly; they differ only in operation order, so a pixel can
    round to the neighbouring uint8 value, and rarely a subpixel ray at an
    occlusion edge can pick the other surface."""
    w, h, base, K, scene, poses, expos = sequence
    jl, jr = jsyn.render_stereo_sequence_fast(scene, K, w, h, base, poses, expos, chunk=3)
    tl, tr = tsyn.render_stereo_sequence_fast(scene, K, w, h, base, poses, expos, device="cpu")
    for a, b in ((tl.numpy(), jl), (tr.numpy(), jr)):
        assert a.shape == b.shape == (3, h, w) and a.dtype == np.uint8
        d = np.abs(a.astype(np.int32) - np.asarray(b).astype(np.int32))
        assert (d == 0).mean() >= 0.995, (d == 0).mean()
        assert d.max() <= 1, d.max()


def test_raycast_idepth_matches_jax(sequence):
    w, h, base, K, scene, poses, expos = sequence
    _, jid = jsyn.render_multi_batch(scene, K, w, h, np.stack(poses))
    _, tid = tsyn.render_multi_batch(scene, K, w, h, np.stack(poses), device="cpu")
    jid = np.asarray(jid)
    # inverse depths in 1/m of surfaces 1-15 m away: f32 intersection roundoff
    np.testing.assert_allclose(tid.numpy(), jid, rtol=1e-5, atol=1e-6)
