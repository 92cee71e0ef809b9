"""Epipolar tracing of the PyTorch port against the JAX package's "xla"
backend (what the JAX package runs on the CPU), on rendered 256x128 pairs
and on seeded random lanes; and the epipolar-search wrapper itself: its CPU
dispatch, its input checks, and (on a card) the CUDA kernel against its
plain version.

Tolerances: both sides sample in f32 with the same formulas, so a lane's
discrete argmin agrees unless two steps tie to the last bit; status equal
on >= 99.9 % of lanes. On lanes GOOD on both sides, best_u within 1e-3 px
and the idepth interval within 1e-4 relative (the GN step and the interval
formula amplify f32 rounding a little). The JAX package's own Pallas-vs-xla
check needs 0.9 because its kernel samples with bf16 split dots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, t

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.ops import trace as jtr
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from stereo_dso_g2o_tpu.utils import se3 as jse3
from stereo_dso_g2o_tpu_torch.config import PATTERN
from stereo_dso_g2o_tpu_torch.config import default_settings as tdefault_settings
from stereo_dso_g2o_tpu_torch.ops import trace as ttr
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

JSET, TSET = jdefault_settings(), tdefault_settings()
W_, H_ = 256, 128
STATUS_AGREE = 0.999
UV_PX = 1e-3
ID_RTOL = 1e-4


def _compare(jres, tres, min_good=20):
    js, ts = np.array(jres.status), n(tres.status)
    assert (js == ts).mean() >= STATUS_AGREE, ((js == ts).mean(), np.bincount(js))
    good = (js == jtr.IPS_GOOD) & (ts == jtr.IPS_GOOD)
    assert good.sum() >= min_good, good.sum()
    np.testing.assert_allclose(n(tres.last_uv)[good], np.array(jres.last_uv)[good], atol=UV_PX, rtol=0)
    same = js == ts
    for f in ("idepth_min", "idepth_max"):  # 1e-6 1/m: points ~1000 m away
        np.testing.assert_allclose(n(getattr(tres, f))[same], np.array(getattr(jres, f))[same],
                                   rtol=ID_RTOL, atol=1e-6, equal_nan=True, err_msg=f)
    # quality = second-best / best energy. With a good match the residual
    # I - c cancels ~3 digits of I, so a last-bit difference in a sample (XLA
    # fuses the lerps into FMAs, the port rounds each product) is ~1e-4 of
    # an energy; the ratio of two such energies is held to 1e-3.
    np.testing.assert_allclose(n(tres.quality)[same], np.array(jres.quality)[same], rtol=1e-3)
    return good


def _points(rng, n_pts, margin=8):
    us = rng.uniform(margin, W_ - margin - 1, n_pts).astype(np.float32)
    vs = rng.uniform(margin, H_ - margin - 1, n_pts).astype(np.float32)
    return us, vs


def _point_data(jdI, us, vs):
    jd = jtr.extract_point_data(jdI, jnp.asarray(us), jnp.asarray(vs), JSET)
    return jd, tuple(t(x) for x in jd)


@pytest.fixture(scope="module")
def stereo_pair():
    scene = synthetic.default_scene(6)
    K = synthetic.default_K(W_, H_)
    left, right, idepth = synthetic.render_stereo_pair(scene, K, W_, H_, 0.2)
    jl = jbuild_pyramid(jnp.asarray(left, jnp.float32), 1)[0][0]
    jr = jbuild_pyramid(jnp.asarray(right, jnp.float32), 1)[0][0]
    return K, 0.2, jl, jr


def test_extract_point_data_matches(stereo_pair):
    K, b, jl, _ = stereo_pair
    us, vs = _points(np.random.default_rng(0), 400)
    jd = jtr.extract_point_data(jl, jnp.asarray(us), jnp.asarray(vs), JSET)
    td = ttr.extract_point_data(t(jl), t(us), t(vs), TSET)
    for a, b_ in zip(td, jd):
        np.testing.assert_allclose(n(a), np.array(b_), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode_right", [True, False])
def test_trace_stereo_matches(stereo_pair, mode_right):
    K, b, jl, jr = stereo_pair
    host, target = (jl, jr) if mode_right else (jr, jl)
    rng = np.random.default_rng(1)
    us, vs = _points(rng, 1500)
    N = len(us)
    jd, td = _point_data(host, us, vs)
    # fresh points, and points with a prior interval (some tight: SKIPPED)
    idmin = np.where(rng.uniform(size=N) < 0.5, 0.0, rng.uniform(0.05, 0.3, N)).astype(np.float32)
    idmax = np.where(idmin == 0, np.nan, idmin + rng.uniform(0.0, 0.4, N)).astype(np.float32)
    status = rng.choice([jtr.IPS_UNINITIALIZED, jtr.IPS_GOOD, jtr.IPS_OUTLIER, jtr.IPS_OOB],
                        N, p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
    q = np.full(N, 10000.0, np.float32)
    Kf = np.asarray(K, np.float32)
    jres, jid = jtr.trace_stereo(jnp.asarray(us), jnp.asarray(vs), jnp.asarray(idmin),
                                 jnp.asarray(idmax), *jd, jnp.asarray(q), jnp.asarray(status),
                                 jnp.asarray(Kf), jnp.float32(b), target, mode_right=mode_right,
                                 settings=JSET, backend="xla")
    tres, tid = ttr.trace_stereo(t(us), t(vs), t(idmin), t(idmax), *td, t(q), t(status),
                                 t(Kf), torch.tensor(b), t(target), mode_right=mode_right,
                                 settings=TSET)
    good = _compare(jres, tres, min_good=300)
    np.testing.assert_allclose(n(tid)[good], np.array(jid)[good], rtol=ID_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def temporal_pair():
    scene = synthetic.default_scene(5)
    K = synthetic.default_K(W_, H_)
    left0, _, idepth0 = synthetic.render_stereo_pair(scene, K, W_, H_, 0.15)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.12, 0.04, 0.08, 0.01, -0.02, 0.005])), np.float64)
    left1, _ = synthetic.render(scene, K, W_, H_, T)
    j0 = jbuild_pyramid(jnp.asarray(left0, jnp.float32), 1)[0][0]
    j1 = jbuild_pyramid(jnp.asarray(left1, jnp.float32), 1)[0][0]
    return K, T, idepth0, j0, j1


def test_trace_temporal_matches(temporal_pair):
    K, T, idepth0, j0, j1 = temporal_pair
    rng = np.random.default_rng(2)
    us, vs = _points(rng, 1500, margin=20)
    N = len(us)
    gt = idepth0[vs.astype(int), us.astype(int)].astype(np.float32)
    idmin = np.where(rng.uniform(size=N) < 0.5, 0.0, gt * rng.uniform(0.5, 0.95, N)).astype(np.float32)
    idmax = np.where(idmin == 0, np.nan, gt * rng.uniform(1.05, 2.0, N)).astype(np.float32)
    status = np.full(N, jtr.IPS_UNINITIALIZED, np.int32)
    q = np.full(N, 10000.0, np.float32)
    Kf = np.asarray(K, np.float32)
    KRKi = (Kf @ T[:3, :3].astype(np.float32) @ np.linalg.inv(Kf)).astype(np.float32)
    Kt = (Kf @ T[:3, 3].astype(np.float32)).astype(np.float32)
    aff = np.array([1.05, -3.0], np.float32)
    jd, td = _point_data(j0, us, vs)
    jres = jtr.trace(jnp.asarray(us), jnp.asarray(vs), jnp.asarray(idmin), jnp.asarray(idmax), *jd,
                     jnp.asarray(q), jnp.asarray(status), jnp.asarray(KRKi), jnp.asarray(Kt),
                     jnp.asarray(aff), j1, settings=JSET, backend="xla")
    tres = ttr.trace(t(us), t(vs), t(idmin), t(idmax), *td, t(q), t(status), t(KRKi), t(Kt),
                     t(aff), t(j1), settings=TSET)
    _compare(jres, tres, min_good=300)


def test_trace_batch_seeded_random_lanes():
    """Per-lane host->target transforms (rotated patterns, affine, slanted
    lines, lanes leaving the image) on a random-texture target."""
    rng = np.random.default_rng(3)
    img = synthetic.smooth_texture(rng, size=256)[:H_, :W_]
    img = img + rng.normal(0, 4.0, img.shape).astype(np.float32)
    jdI = jbuild_pyramid(jnp.asarray(img, jnp.float32), 1)[0][0]
    N = 2000
    us, vs = _points(rng, N, margin=6)
    K = np.asarray(synthetic.default_K(W_, H_), np.float32)
    Ki = np.linalg.inv(K)
    ang = rng.normal(0, 0.04, (N, 3))
    KRKi = np.empty((N, 3, 3), np.float32)
    for i in range(N):
        th = np.linalg.norm(ang[i])
        k = ang[i] / max(th, 1e-12)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        KRKi[i] = K @ R @ Ki
    Kt = (K @ rng.normal(0, 0.15, (N, 3)).T).T.astype(np.float32)
    aff = np.stack([rng.uniform(0.8, 1.25, N), rng.normal(0, 5, N)], 1).astype(np.float32)
    idmin = rng.uniform(0.0, 0.3, N).astype(np.float32)
    idmax = np.where(rng.uniform(size=N) < 0.4, np.inf, idmin + rng.uniform(0, 0.5, N)).astype(np.float32)
    status = rng.choice([jtr.IPS_UNINITIALIZED, jtr.IPS_OUTLIER, jtr.IPS_OOB], N,
                        p=[0.8, 0.15, 0.05]).astype(np.int32)
    q = rng.uniform(1.0, 50.0, N).astype(np.float32)
    jd, td = _point_data(jdI, us, vs)
    jres = jtr.trace_batch(jnp.asarray(us), jnp.asarray(vs), jnp.asarray(idmin), jnp.asarray(idmax),
                           *jd, jnp.asarray(q), jnp.asarray(status), jnp.asarray(KRKi),
                           jnp.asarray(Kt), jnp.asarray(aff), jdI, settings=JSET, backend="xla")
    tres = ttr.trace_batch(t(us), t(vs), t(idmin), t(idmax), *td, t(q), t(status), t(KRKi),
                           t(Kt), t(aff), t(jdI), settings=TSET)
    _compare(jres, tres, min_good=100)
    # the state machine saw more than one outcome
    assert len(np.unique(np.array(jres.status))) >= 4


def _lanes(n_lanes, stereo, seed=0, h=64, w=96):
    rng = np.random.default_rng(seed)
    dI = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    S = 40
    ptx = rng.uniform(-10, w + 10, n_lanes)
    pty = rng.uniform(-3, h + 3, n_lanes) if not stereo else np.floor(rng.uniform(0, h, n_lanes))
    th = rng.uniform(0, 2 * np.pi, n_lanes)
    dx = np.sign(rng.uniform(-1, 1, n_lanes)) if stereo else np.cos(th)
    dy = np.zeros(n_lanes) if stereo else np.sin(th)
    scal = np.stack([ptx, pty, dx, dy, rng.integers(0, S + 1, n_lanes),
                     rng.uniform(0.8, 1.2, n_lanes), rng.normal(0, 3, n_lanes),
                     np.zeros(n_lanes)], 1).astype(np.float32)
    scal[:3, 0] = np.nan  # non-finite positions are read as 0
    pat = PATTERN.astype(np.float32)
    patx = np.broadcast_to(pat[:, 0], (n_lanes, 8)).copy()
    paty = np.broadcast_to(pat[:, 1], (n_lanes, 8)).copy()
    if not stereo:
        patx = patx + rng.normal(0, 0.2, patx.shape).astype(np.float32)
        paty = paty + rng.normal(0, 0.2, paty.shape).astype(np.float32)
    color = rng.uniform(0, 255, (n_lanes, 8)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, (n_lanes, 8)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (dI, scal, color, weights, patx, paty)]
    kw = dict(S=S, huber_th=9.0, gn_iters=3, gn_threshold=0.1, radius=2,
              edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP)
    return args, kw


@pytest.mark.parametrize("stereo", [False, True])
def test_epipolar_search_cpu_runs_plain_version(stereo):
    args, kw = _lanes(300, stereo)
    before = tk.LAUNCHES
    out = tk.epipolar_search(*args, **kw)
    ref = tk.epipolar_search_ref(*args, **kw)
    assert tk.LAUNCHES == before  # no kernel on the CPU
    assert out.shape == (300, 8) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    bidx = out[:, tk.OUT_BEST_IDX]
    nsteps = args[1][:, 4]
    # masked steps never win; lanes with no step report the +inf energy
    assert bool(((bidx < nsteps) | (nsteps == 0)).all())
    assert bool(torch.isinf(out[nsteps == 0, tk.OUT_E_SEARCH]).all())
    assert bool(torch.isfinite(out[:, tk.OUT_BEST_U]).all())


def test_epipolar_search_rejects_bad_inputs():
    args, kw = _lanes(16, False)
    dI, scal, color, weights, patx, paty = args
    with pytest.raises(TypeError):
        tk.epipolar_search(dI.double(), scal, color, weights, patx, paty, **kw)
    with pytest.raises(ValueError):
        tk.epipolar_search(dI, scal[:, :7].contiguous(), color, weights, patx, paty, **kw)
    with pytest.raises(ValueError):
        tk.epipolar_search(dI, scal, color.t().contiguous().t(), weights, patx, paty, **kw)
    with pytest.raises(ValueError):
        tk.epipolar_search(dI, scal, color, weights, patx, paty, **{**kw, "S": tk.MAX_STEPS + 1})
    with pytest.raises(ValueError):
        tk.epipolar_search(dI, scal, color, weights, patx, paty, **{**kw, "edge": 7})
    with pytest.raises(ValueError):
        tk.epipolar_search(dI[..., :2].contiguous(), scal, color, weights, patx, paty, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [False, True])
def test_epipolar_search_kernel_matches_plain_version(stereo):
    """The CUDA kernel against epipolar_search_ref on the card (chip_smoke.py
    runs the same comparison at the slice's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kw = _lanes(4096, stereo, seed=5, h=352, w=1216)
    args = [a.cuda() for a in args]
    before = tk.LAUNCHES
    out = tk.epipolar_search(*args, **kw)
    ref = tk.epipolar_search_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    same = out[:, tk.OUT_BEST_IDX] == ref[:, tk.OUT_BEST_IDX]
    assert float(same.float().mean()) >= STATUS_AGREE
    assert float((out[same, :2] - ref[same, :2]).abs().max()) <= UV_PX
    for lane in (tk.OUT_E_SEARCH, tk.OUT_SECOND_BEST, tk.OUT_E_GN):
        a, b = out[same, lane], ref[same, lane]
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert float(((a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1e-6)).max()) <= ID_RTOL
