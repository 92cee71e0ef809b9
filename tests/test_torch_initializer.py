"""The port's mono initializer (`frontend/initializer.py`) against the JAX
package's, on `tests/test_initializer.py`'s sequence: the tilted textured
plane of `default_scene(13)` at 192x96, 4 levels, `SET`, seven frames of a
growing baseline. Both sides get the same rendered frames; each builds its
own pyramids, and the selector's thinning uses the JAX package's float32
draw. The JAX side runs with x64 off, as a user runs it.

After every `track_frame`: `snapped`, `frame_id` and the returned flag
equal; `this_to_next` within 5e-6 (measured 8.4e-7); `is_good` equal on
every valid point of every level (the bound first set was 99.5 %);
`idepth` of the points good on both sides within 2e-4 relative (measured
4.0e-5; first set 1e-3). Equal `is_good` needs the port to round as XLA
fuses: the projection's dot and `fx*u + cx` as FMAs (at the identity pose
a pattern pixel lands exactly on the in-bounds edge), and the
regularizer's blend as one FMA. `_grid_max_select`, `propagate_up` and
`propagate_down` alone equal the JAX functions exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_uniform, n, t

from stereo_dso_g2o_tpu.config import Settings as JSettings
from stereo_dso_g2o_tpu.frontend import initializer as JI
from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.models.camera import make_calib as jmake_calib
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from stereo_dso_g2o_tpu.utils import se3 as jse3
from stereo_dso_g2o_tpu_torch.config import Settings as TSettings
from stereo_dso_g2o_tpu_torch.frontend import initializer as TI
from stereo_dso_g2o_tpu_torch.models.camera import make_calib as tmake_calib
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid as tbuild_pyramid

W_, H_, LEVELS, FRAMES = 192, 96, 4, 7
SET_KW = dict(desired_point_density=600.0, immature_cap=512, active_cap=1024)
POSE_TOL = 5e-6
GOOD_SHARE = 1.0
IDEPTH_RTOL = 2e-4


def _f32_draw(salt, shape, device="cpu"):
    with jax.enable_x64(False):
        return jax_uniform(salt, shape, device)


def _motion(i):
    return np.array([0.06 * i, 0.015 * i, 0.02 * i, 0.0, 0.004 * i, 0.0])


@pytest.fixture(scope="module")
def runs():
    """Both initializers stepped side by side; per frame, what each holds."""
    scene = synthetic.default_scene(13)
    K = synthetic.default_K(W_, H_)
    with jax.enable_x64(False):
        imgs = [synthetic.render(scene, K, W_, H_, np.eye(4))[0]]
        for i in range(1, FRAMES + 1):
            T = np.asarray(jse3.se3_exp(jnp.asarray(_motion(i), jnp.float32)), np.float64)
            imgs.append(synthetic.render(scene, K, W_, H_, T)[0])
        jcal = jmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.1, W_, H_, n_levels=LEVELS)
        jini = JI.MonoInitializer(jcal, JSettings(**SET_KW))
        jd, ja = jbuild_pyramid(jnp.asarray(imgs[0]), LEVELS)
        jini.set_first(jd, ja)
    tcal = tmake_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.1, W_, H_, n_levels=LEVELS,
                       device="cpu")
    tini = TI.MonoInitializer(tcal, TSettings(**SET_KW), device="cpu", uniform=_f32_draw)
    td, ta = tbuild_pyramid(torch.from_numpy(imgs[0]), LEVELS)
    tini.set_first(td, ta)
    first = [(jax.device_get(jl), tl) for jl, tl in zip(jini.levels, tini.levels)]
    steps = []
    for i in range(1, FRAMES + 1):
        with jax.enable_x64(False):
            jready = jini.track_frame(jbuild_pyramid(jnp.asarray(imgs[i]), LEVELS)[0])
        tready = tini.track_frame(tbuild_pyramid(torch.from_numpy(imgs[i]), LEVELS)[0])
        steps.append(dict(
            j=dict(ready=jready, snapped=jini.snapped, frame_id=jini.frame_id,
                   snapped_at=jini.snapped_at, T=np.array(jini.this_to_next),
                   levels=[jax.device_get(L) for L in jini.levels]),
            t=dict(ready=tready, snapped=tini.snapped, frame_id=tini.frame_id,
                   snapped_at=tini.snapped_at, T=np.array(tini.this_to_next),
                   levels=list(tini.levels)),
        ))
    return dict(first=first, steps=steps, imgs=imgs)


def test_set_first_selects_the_same_points(runs):
    for lvl, (jl, tl) in enumerate(runs["first"]):
        np.testing.assert_array_equal(n(tl.valid), np.array(jl.valid), err_msg=f"level {lvl}")
        np.testing.assert_array_equal(n(tl.u), np.array(jl.u))
        np.testing.assert_array_equal(n(tl.v), np.array(jl.v))
        np.testing.assert_array_equal(n(tl.my_type), np.array(jl.my_type))
        np.testing.assert_array_equal(n(tl.nn), np.array(jl.nn))
        np.testing.assert_array_equal(n(tl.parent), np.array(jl.parent))
        assert int(np.array(jl.valid).sum()) > 0


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
def test_track_frame_follows_the_jax_initializer(runs, frame):
    st = runs["steps"][frame - 1]
    j, tt = st["j"], st["t"]
    assert (tt["ready"], tt["snapped"], tt["frame_id"], tt["snapped_at"]) == \
        (j["ready"], j["snapped"], j["frame_id"], j["snapped_at"])
    np.testing.assert_allclose(tt["T"], j["T"], atol=POSE_TOL, rtol=0)
    for lvl, (jl, tl) in enumerate(zip(j["levels"], tt["levels"])):
        valid = np.array(jl.valid)
        jg, tg = np.array(jl.is_good), n(tl.is_good)
        share = float((jg == tg)[valid].mean())
        assert share >= GOOD_SHARE, (lvl, share)
        both = valid & jg & tg
        np.testing.assert_allclose(n(tl.idepth)[both], np.array(jl.idepth)[both],
                                   rtol=IDEPTH_RTOL, atol=0, err_msg=f"level {lvl}")


def test_initializer_snaps_and_recovers_structure(runs):
    """test_initializer.py's end state, reached by the port."""
    last = runs["steps"][-1]["t"]
    assert last["snapped"]
    L = last["levels"][0]
    good = n(L.valid & L.is_good)
    assert good.sum() > 50


def _level(seed, n_pts, w, h, parent_n=None):
    rng = np.random.default_rng(seed)
    us = rng.uniform(2, w - 3, n_pts).astype(np.float32)
    vs = rng.uniform(2, h - 3, n_pts).astype(np.float32)
    valid = rng.uniform(size=n_pts) > 0.15
    f = dict(
        valid=valid, u=us, v=vs,
        idepth=rng.uniform(0.2, 2.0, n_pts).astype(np.float32),
        idepth_new=rng.uniform(0.2, 2.0, n_pts).astype(np.float32),
        iR=rng.uniform(0.2, 2.0, n_pts).astype(np.float32),
        is_good=rng.uniform(size=n_pts) > 0.3,
        energy=rng.uniform(0, 10, (n_pts, 2)).astype(np.float32),
        last_hessian=np.where(rng.uniform(size=n_pts) > 0.2,
                              rng.uniform(0, 3, n_pts), 0.0).astype(np.float32),
        max_step=np.full(n_pts, 1e10, np.float32),
        outlier_th=np.full(n_pts, 1152.0, np.float32),
        my_type=np.ones(n_pts, np.int32),
        nn=np.where(rng.uniform(size=(n_pts, 10)) > 0.1,
                    rng.integers(0, n_pts, (n_pts, 10)), -1).astype(np.int32),
        parent=(np.where(rng.uniform(size=n_pts) > 0.1, rng.integers(0, parent_n, n_pts), -1)
                if parent_n else np.full(n_pts, -1)).astype(np.int32),
        Jb=np.zeros((n_pts, 10), np.float32),
    )
    with jax.enable_x64(False):
        jl = JI.InitLevel(**{k: jnp.asarray(v) for k, v in f.items()})
    tl = TI.InitLevel(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()})
    return jl, tl


def _assert_levels_equal(jl, tl):
    for name in ("valid", "idepth", "idepth_new", "iR", "is_good", "last_hessian"):
        np.testing.assert_array_equal(n(getattr(tl, name)), np.array(getattr(jl, name)),
                                      err_msg=name)


def test_propagate_up_and_down_equal_jax():
    jf, tf = _level(1, 400, 96, 48, parent_n=120)
    jc, tc = _level(2, 120, 48, 24)
    with jax.enable_x64(False):
        j_up = JI.propagate_up(jf, jc)
        j_down = JI.propagate_down(jf, jc)
    _assert_levels_equal(j_up, TI.propagate_up(tf, tc))
    _assert_levels_equal(j_down, TI.propagate_down(tf, tc))
    # the cases the functions branch on are all present
    assert (np.array(jf.parent) < 0).any() and (~np.array(jc.is_good)).any()


@pytest.mark.parametrize("lvl", [1, 2, 3])
def test_grid_max_select_equals_jax(lvl):
    scene = synthetic.default_scene(13)
    K = synthetic.default_K(W_, H_)
    img = synthetic.render(scene, K, W_, H_, np.eye(4))[0]
    with jax.enable_x64(False):
        jd, ja = jbuild_pyramid(jnp.asarray(img), LEVELS)
        cap = 64 if lvl == 1 else 256  # a cut list, and one with padding
        ju, jv, jvalid = (np.array(x) for x in JI._grid_max_select(jd[lvl], ja[lvl], cap))
    tu, tv, tvalid = TI._grid_max_select(t(jd[lvl]), t(ja[lvl]), cap)
    np.testing.assert_array_equal(n(tvalid), jvalid)
    np.testing.assert_array_equal(n(tu), ju)
    np.testing.assert_array_equal(n(tv), jv)
    assert jvalid.any()


def test_median_is_jnp_median():
    rng = np.random.default_rng(5)
    for size in (7, 8, 1000, 1001):
        x = rng.standard_normal(size).astype(np.float32)
        with jax.enable_x64(False):
            want = np.array(jnp.median(jnp.asarray(x)))
        assert float(TI._median(torch.from_numpy(x))) == float(want)


def test_initializer_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    tcal = tmake_calib(100.0, 100.0, 95.5, 47.5, 0.1, W_, H_, n_levels=LEVELS, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TI.MonoInitializer(tcal, TSettings(**SET_KW))
    assert TI.MonoInitializer(tcal, TSettings(**SET_KW), device="cpu").calib.device.type == "cpu"
