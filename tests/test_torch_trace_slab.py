"""The slab route of the epipolar search: `trace_cuda.epipolar_search_slab`
and its plain version against the resident route's plain version, against
the JAX package's Pallas slab body (`trace_pallas.epipolar_search(...,
resident=False, interpret=True)`, called directly), and, through
`trace_batch` / `trace_stereo(route="slab")`, against the JAX "xla" backend;
the route gate against the JAX formula.

Tolerances. Slab against resident plain version: the two differ only in
where the Gauss-Newton gradient is differenced (from the intensity plane
instead of read from the gradient channels), and 0.5*(a-b) rounds the same
in both places, so best_idx is equal on every lane, best_u/v within 1e-4 px
and energies within 1e-5 relative (observed: bit-identical). Against the
Pallas slab body, on lanes whose window is interior (it edge-pads, the port
clamps): best_idx equal on >= 99 %, best_u/v within 1e-2 px, e_search
within 1e-3 relative (its bilinear taps are bf16 split dots). Against the
"xla" backend: test_torch_trace.py's tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, t
from test_torch_trace import (  # noqa: F401  (fixtures)
    JSET, TSET, H_, W_, _compare, _point_data, _points, stereo_pair, temporal_pair,
)

from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.ops import trace as jtr
from stereo_dso_g2o_tpu.ops import trace_pallas as jtp
from stereo_dso_g2o_tpu_torch.config import PATTERN
from stereo_dso_g2o_tpu_torch.ops import trace as ttr
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid as tbuild_pyramid

GN = dict(huber_th=9.0, gn_iters=3, gn_threshold=0.1, radius=2)


def _image(kind):
    if kind == "random":
        rng = np.random.default_rng(7)
        img = synthetic.smooth_texture(rng, size=256)[:H_, :W_]
        return img + rng.normal(0, 4.0, img.shape).astype(np.float32)
    scene = synthetic.default_scene(6)
    left, _, _ = synthetic.render_stereo_pair(scene, synthetic.default_K(W_, H_), W_, H_, 0.2)
    return np.asarray(left, np.float32)


def _lanes(img, n_lanes, stereo, S, seed, interior=False):
    """Seeded lanes on a real pyramid level (gradient channels consistent
    with the intensity): host colours from the image itself, search lines
    through it; unless `interior`, some start outside or at the border."""
    rng = np.random.default_rng(seed)
    dI = tbuild_pyramid(torch.from_numpy(np.ascontiguousarray(img)), 1)[0][0].contiguous()
    H, W = img.shape
    m = S + 12 if interior else -6
    ptx = rng.uniform(m, W - 1 - m, n_lanes)
    pty = rng.uniform(min(m, H // 2 - 4), H - 1 - min(m, H // 2 - 4), n_lanes)
    th = rng.uniform(0, 2 * np.pi, n_lanes)
    dx = np.sign(rng.uniform(-1, 1, n_lanes)) if stereo else np.cos(th)
    dy = np.zeros(n_lanes) if stereo else np.sin(th)
    if interior and not stereo:  # keep the whole segment inside the rows
        dy = dy * 0.3
        dx = np.sign(dx) * np.sqrt(1 - dy * dy)
        pty = rng.uniform(0.3 * S + 12, H - 1 - 0.3 * S - 12, n_lanes)
    nsteps = rng.integers(0 if not interior else 4, S, n_lanes)
    aff_a = np.ones(n_lanes) if stereo else rng.uniform(0.9, 1.1, n_lanes)
    aff_b = np.zeros(n_lanes) if stereo else rng.normal(0, 2, n_lanes)
    scal = np.stack([ptx, pty, dx, dy, nsteps, aff_a, aff_b, np.zeros(n_lanes)], 1).astype(np.float32)
    pat = PATTERN.astype(np.float32)
    patx = np.broadcast_to(pat[:, 0], (n_lanes, 8)).copy()
    paty = np.broadcast_to(pat[:, 1], (n_lanes, 8)).copy()
    if not stereo:
        rot = rng.normal(0, 0.05, n_lanes)[:, None]
        patx, paty = (np.cos(rot) * patx - np.sin(rot) * paty).astype(np.float32), (
            np.sin(rot) * patx + np.cos(rot) * paty).astype(np.float32)
    # the colour of a true match somewhere along the line, plus noise
    k = rng.integers(0, S, n_lanes)[:, None]
    cx = np.clip(ptx[:, None] + k * dx[:, None] + patx, 0, W - 1).astype(int)
    cy = np.clip(pty[:, None] + k * dy[:, None] + paty, 0, H - 1).astype(int)
    color = (img[cy, cx] - aff_b[:, None]) / aff_a[:, None] + rng.normal(0, 2, (n_lanes, 8))
    weights = rng.uniform(0.2, 1.0, (n_lanes, 8))
    tens = [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in (scal, color, weights, patx, paty)]
    kw = dict(S=S, edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP, **GN)
    return [dI] + tens, kw


def _hold(out, ref, idx_min, uv_tol, e_tol, lanes=(tk.OUT_E_SEARCH, tk.OUT_SECOND_BEST, tk.OUT_E_GN)):
    out, ref = n(out), n(ref)
    same = out[:, tk.OUT_BEST_IDX] == ref[:, tk.OUT_BEST_IDX]
    assert same.mean() >= idx_min, same.mean()
    assert np.abs(out[same, :2] - ref[same, :2]).max() <= uv_tol
    for lane in lanes:
        a, b = out[same, lane], ref[same, lane]
        fin = np.isfinite(b)
        assert (np.isfinite(a) == fin).all()
        assert (np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-6)).max() <= e_tol, lane


@pytest.mark.parametrize("kind", ["random", "rendered"])
@pytest.mark.parametrize("stereo", [False, True])
def test_slab_plain_version_matches_resident_plain_version(kind, stereo):
    args, kw = _lanes(_image(kind), 600, stereo, S=40, seed=11)
    want = tk.epipolar_search_ref(*args, **kw)
    # the slab route reads channel 0 only: hand it garbage gradients
    dI = args[0].clone()
    dI[..., 1:] = 1e9
    got = tk.epipolar_search_slab_ref(dI, *args[1:], **kw)
    _hold(got, want, 1.0, 1e-4, 1e-5)
    border = (args[1][:, 0] < 4) | (args[1][:, 1] < 4) | (args[1][:, 1] > H_ - 5)
    assert int(border.sum()) > 10  # lanes at the border were among them
    assert len(torch.unique(want[:, tk.OUT_BEST_IDX])) > 10


@pytest.mark.parametrize("stereo", [False, True])
def test_slab_plain_version_matches_pallas_slab_body(stereo):
    """The TPU kernel the CUDA slab kernel replaces, in interpret mode, on
    interior lanes."""
    S, N = 40, 256
    img = _image("rendered")
    args, kw = _lanes(img, N, stereo, S=S, seed=13, interior=True)
    dI, scal, color, weights, patx, paty = args
    got = tk.epipolar_search_slab_ref(*args, **kw)

    img_pad, oy, ox = jtp.pad_image_for_search(jnp.asarray(img))
    Hp, Wp = img_pad.shape
    js = jnp.asarray(n(scal))
    y0, x0, ptx_rel, pty_rel = jtp.slab_origins(
        js[:, 0], js[:, 1], js[:, 2], js[:, 3], js[:, 4].astype(jnp.int32), oy, ox, Hp, Wp)
    jscal = js.at[:, 0].set(ptx_rel).at[:, 1].set(pty_rel)
    out = np.array(jtp.epipolar_search(
        img_pad, y0, x0, jscal, jnp.asarray(n(color)), jnp.asarray(n(weights)),
        jnp.asarray(n(patx)), jnp.asarray(n(paty)), S=S, BLK=16, huber_th=GN["huber_th"],
        gn_iters=GN["gn_iters"], gn_threshold=GN["gn_threshold"], resident=False, interpret=True))
    out[:, 0] -= ox - np.array(x0, np.float32)
    out[:, 1] -= oy - np.array(y0, np.float32)
    # the Pallas body reports no second best outside a radius in lane 3 the
    # way the port does for masked lanes; hold the search energy
    _hold(torch.from_numpy(out), got, 0.99, 1e-2, 1e-3, lanes=(tk.OUT_E_SEARCH,))


@pytest.mark.parametrize("mode_right", [True, False])
def test_trace_stereo_slab_route_matches_xla(stereo_pair, mode_right):
    K, b, jl, jr = stereo_pair
    host, target = (jl, jr) if mode_right else (jr, jl)
    rng = np.random.default_rng(1)
    us, vs = _points(rng, 1500)
    N = len(us)
    jd, td = _point_data(host, us, vs)
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
    before = tk.LAUNCHES, tk.LAUNCHES_SLAB
    tres, tid = ttr.trace_stereo(t(us), t(vs), t(idmin), t(idmax), *td, t(q), t(status),
                                 t(Kf), torch.tensor(b), t(target), mode_right=mode_right,
                                 settings=TSET, route="slab")
    assert (tk.LAUNCHES, tk.LAUNCHES_SLAB) == before  # no kernel on the CPU
    good = _compare(jres, tres, min_good=300)
    np.testing.assert_allclose(n(tid)[good], np.array(jid)[good], rtol=1e-4, atol=1e-6)
    # both routes of the port: the same answer
    rres, rid = ttr.trace_stereo(t(us), t(vs), t(idmin), t(idmax), *td, t(q), t(status),
                                 t(Kf), torch.tensor(b), t(target), mode_right=mode_right,
                                 settings=TSET, route="resident")
    for a, b_ in zip(tres, rres):
        assert torch.equal(torch.nan_to_num(a.float()), torch.nan_to_num(b_.float()))


def test_trace_temporal_slab_route_matches_xla(temporal_pair):
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
                     t(aff), t(j1), settings=TSET, route="slab")
    _compare(jres, tres, min_good=300)
    with pytest.raises(ValueError):
        ttr.trace(t(us), t(vs), t(idmin), t(idmax), *td, t(q), t(status), t(KRKi), t(Kt),
                  t(aff), t(j1), settings=TSET, route="pallas")


@pytest.mark.parametrize("w,h,slab", [
    (256, 128, False), (1216, 352, False), (1024, 1024, False),  # last size under the gate
    (1025, 1024, True),  # first one over it
    (1920, 1080, True), (2048, 1024, True),
])
def test_uses_slab_route_is_the_jax_gate(w, h, slab):
    img_pad, _, _ = jtp.pad_image_for_search(jnp.zeros((h, w), jnp.float32))
    jax_resident = img_pad.shape[0] * img_pad.shape[1] * 4 <= 6 * 2**20  # ops/trace.py:318
    assert tk.uses_slab_route(h, w) == (not jax_resident) == slab


def test_gate_picks_the_route(monkeypatch):
    """trace functions with route=None follow the gate; the wrappers are
    what they call."""
    calls = []
    monkeypatch.setattr(tk, "epipolar_search", lambda *a, **k: calls.append("resident") or
                        tk.epipolar_search_ref(*a, **k))
    monkeypatch.setattr(tk, "epipolar_search_slab", lambda *a, **k: calls.append("slab") or
                        tk.epipolar_search_slab_ref(*a, **k))
    args, kw = _lanes(_image("random"), 32, False, S=20, seed=1)
    dI, scal, color, weights, patx, paty = args
    lane = (scal[:, 0], scal[:, 1], scal[:, 2], scal[:, 3], scal[:, 4].int(), scal[:, 5],
            scal[:, 6], color, weights, patx, paty, torch.zeros(32, dtype=torch.bool), 20, TSET,
            tk.EDGE_CLAMP)
    ttr._search(dI, *lane)
    monkeypatch.setattr(tk, "uses_slab_route", lambda H, W: True)
    ttr._search(dI, *lane)
    ttr._search(dI, *lane, route="resident")
    assert calls == ["resident", "slab", "resident"]


def test_slab_wrapper_dispatch_and_checks():
    args, kw = _lanes(_image("random"), 64, False, S=40, seed=3)
    dI, scal, color, weights, patx, paty = args
    before = tk.LAUNCHES_SLAB
    out = tk.epipolar_search_slab(*args, **kw)
    assert tk.LAUNCHES_SLAB == before  # a CPU tensor runs the plain version
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(tk.epipolar_search_slab_ref(*args, **kw)))
    with pytest.raises(TypeError):
        tk.epipolar_search_slab(dI.double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        tk.epipolar_search_slab(dI, scal[:, :7].contiguous(), *args[2:], **kw)
    with pytest.raises(ValueError):
        tk.epipolar_search_slab(*args, **{**kw, "edge": 7})
    # the band follows S: S = 86 (2048x1024) and the trace_max_steps cap fit
    # a block's shared memory four lanes at a time, S = 1000 cannot
    assert tk.slab_window(86)[2] < tk.slab_window(100)[2] < tk.SMEM_MAX // tk.SLAB_WARPS
    assert tk.slab_window(86)[:2] == (16, 108)
    with pytest.raises(ValueError, match="shared memory"):
        tk.epipolar_search_slab(*args, **{**kw, "S": 1000})


def test_intensity_plane_is_made_once_per_image():
    dI = torch.rand(16, 24, 3)
    p1 = tk.intensity_plane(dI)
    assert p1.is_contiguous() and torch.equal(p1, dI[..., 0])
    assert tk.intensity_plane(dI) is p1
    other = torch.rand(16, 24, 3)
    tk.intensity_plane(other)
    assert tk.intensity_plane(dI) is p1  # two images are kept (left and right)
    dI[0, 0, 0] = 7.0  # written in place: the plane is made anew
    p2 = tk.intensity_plane(dI)
    assert p2 is not p1 and float(p2[0, 0]) == 7.0


def _card_lanes(stereo):
    scene = synthetic.default_scene(6)
    w, h = 2048, 1024
    left, _, _ = synthetic.render_stereo_pair(scene, synthetic.default_K(w, h), w, h, 0.2)
    args, kw = _lanes(np.asarray(left, np.float32), 4096, stereo, S=86, seed=5)
    return [a.cuda() for a in args], kw


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [False, True])
def test_slab_kernel_matches_plain_version(stereo):
    """The CUDA slab kernel against epipolar_search_slab_ref on the card
    (chip_smoke.py runs the same comparison at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kw = _card_lanes(stereo)
    before = tk.LAUNCHES_SLAB
    out = tk.epipolar_search_slab(*args, **kw)
    ref = tk.epipolar_search_slab_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES_SLAB == before + 1
    _hold(out, ref, 0.999, 1e-3, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [False, True])
def test_slab_kernel_matches_resident_kernel(stereo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args, kw = _card_lanes(stereo)
    out = tk.epipolar_search_slab(*args, **kw)
    ref = tk.epipolar_search(*args, **kw)
    torch.cuda.synchronize()
    _hold(out, ref, 0.999, 1e-3, 1e-4)
