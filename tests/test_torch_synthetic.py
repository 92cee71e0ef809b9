"""The PyTorch port's scene builders, renderers and ray caster against the
JAX package's: the numpy builders and renderers are copies (equal outputs),
the torch ray caster renders the same corridor as `_raycast_jax`."""

import dataclasses

import numpy as np
import pytest
import torch

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


def test_numpy_renderers_match_jax():
    """The host renderers are copies: the same arrays bit for bit."""
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    tex = tsyn.smooth_texture(rng_t, 64)
    assert np.array_equal(tex, jsyn.smooth_texture(rng_j, 64))
    u, v = rng_t.uniform(-300, 300, (2, 500))
    np.testing.assert_array_equal(tsyn._sample_tex(tex, u, v), jsyn._sample_tex(tex, u, v))
    w, h, base = 64, 48, 0.2
    K = tsyn.default_K(w, h)
    T = np.eye(4)
    T[:3, 3] = [0.05, -0.02, 0.1]
    tp, jp = tsyn.default_scene(3), jsyn.default_scene(3)
    for f in ("normal", "dist", "tex", "tex_scale", "e1", "e2"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    for a, b in zip(tsyn.render(tp, K, w, h, T), jsyn.render(jp, K, w, h, T)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.render_stereo_pair(tp, K, w, h, base, T),
                    jsyn.render_stereo_pair(jp, K, w, h, base, T)):
        np.testing.assert_array_equal(a, b)
    poses = [np.eye(4), T]
    for ta, ja in zip(tsyn.render_sequence(tp, K, w, h, base, poses),
                      jsyn.render_sequence(jp, K, w, h, base, poses)):
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(a, b)
    tb, jb = tsyn.box_scene(seed=2, n_boxes=3), jsyn.box_scene(seed=2, n_boxes=3)
    tpk, jpk = tsyn._pack_scene(tb), jsyn._pack_scene(jb)
    for k in jpk:
        np.testing.assert_array_equal(tpk[k], jpk[k], err_msg=k)
    for a, b in zip(tsyn.render_multi(tb, K, w, h, T), jsyn.render_multi(jb, K, w, h, T)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.render_multi_stereo_pair(tb, K, w, h, base, T, exposure=1.1),
                    jsyn.render_multi_stereo_pair(jb, K, w, h, base, T, exposure=1.1)):
        np.testing.assert_array_equal(a, b)


def test_render_multi_fast_matches_jax(sequence):
    """The torch ray caster for one pose against the JAX one, at
    test_raycast_matches_jax's tolerance on the image (as uint8) and
    test_raycast_idepth_matches_jax's on the inverse depth."""
    w, h, base, K, scene, poses, expos = sequence
    ti, tid = tsyn.render_multi_fast(scene, K, w, h, poses[1], device="cpu")
    ji, jid = jsyn.render_multi_fast(scene, K, w, h, poses[1])
    assert ti.shape == tid.shape == (h, w) and ti.dtype == torch.float32
    a = np.clip(ti.numpy(), 0, 255).astype(np.int32)
    b = np.clip(np.asarray(ji), 0, 255).astype(np.int32)
    d = np.abs(a - b)
    assert (d == 0).mean() >= 0.995 and d.max() <= 1, ((d == 0).mean(), d.max())
    np.testing.assert_allclose(tid.numpy(), np.asarray(jid), rtol=1e-5, atol=1e-6)
