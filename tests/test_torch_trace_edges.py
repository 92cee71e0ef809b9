"""The epipolar search on edge lanes (`_torch_trace_lanes.edge_lanes`): lanes
with num_steps of 0, 1, a fraction, S - 1, more than S and NaN, lines that
leave the image on each side, stereo anchors beyond the clamp, non-finite
positions and directions, a pattern with a NaN entry. The CUDA kernels skip
invalid steps and masked lanes; what they must reproduce there is pinned
here by the JAX package, twice.

Against the two Pallas bodies (`trace_pallas.epipolar_search`, resident and
slab, in interpret mode), the package's only entry point that takes raw
(N, 8) lanes, prepared with its own `pad_image_for_search` and
`slab_origins` as `trace_batch` prepares them. That is the function the
kernels replace, but not to the last bit and not at every border: its taps
are bf16 split dots, it edge-pads the image (8 rows above, 128 columns to
the left) where the "xla" search clamps coordinates, and its stereo search
edge-pads too where the "xla" strip reads zeros. So it holds the masking
rules, best_idx and the search energy on every geometry it can take, and
best_u/v and all energies where no tap leaves the image.

Against the "xla" backend's search, to tight tolerances on every geometry.
`trace_batch` / `trace_stereo` build their lanes inside and take none, and
cannot be made to produce a num_steps of NaN or over S or a non-finite
direction, so the search is assembled here from the package's own
`_pattern_energy` and `bilinear` as `ops/trace.py:329-410` (temporal) and
`:852-963` (stereo strip) assemble it; the argmin and Gauss-Newton lines
around them (`_finish`, `_gn`) are copied from there, which is why the
Pallas bodies above stand beside them. Non-finite positions and directions
go to the JAX side as 0, as the JAX "pallas" branch and the port's `_search`
sanitize them.

Tolerances: best_idx equal on every lane of a case (lanes where two steps
tie to the last bit aside: >= 95 % of a 24-lane case), best_u/v within 1e-3
px, energies within 1e-4 relative (XLA fuses the lerps into FMAs, the port
rounds each product), the same +inf / NaN pattern. The two plain versions
of the port agree bit for bit.

Also here: the wrapper's Python geometry (band size, shared-memory limits,
strided patterns, the call through the module) and the card-only checks of both
kernels on the same lanes, with the slab kernel's band cut to force its
global-memory fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_trace_lanes as trace_lanes
from _torch_parity import n

from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.ops import trace as jtr
from stereo_dso_g2o_tpu.ops import trace_pallas as jtp
from stereo_dso_g2o_tpu.ops.interp import bilinear as jbilinear
from stereo_dso_g2o_tpu_torch.config import PATTERN, default_settings
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.ops import trace as ttr
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid as tbuild_pyramid

W_, H_, S_ = 256, 128, 40
GN = dict(huber_th=9.0, gn_iters=3, gn_threshold=0.1, radius=2)


@pytest.fixture(scope="module")
def image():
    scene = synthetic.default_scene(6)
    left, _, _ = synthetic.render_stereo_pair(scene, synthetic.default_K(W_, H_), W_, H_, 0.2)
    return tbuild_pyramid(torch.from_numpy(np.asarray(left, np.float32)), 1)[0][0].contiguous()


def _case(dI, stereo, geo, seed=3):
    lanes, labels = trace_lanes.edge_lanes(dI, S_, stereo, seed=seed)
    keep = torch.tensor([g == geo for g, _ in labels])
    args = [dI] + [lanes[k][keep].contiguous() for k in ("scal", "color", "weights", "patx", "paty")]
    kw = dict(S=S_, edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP, **GN)
    return args, kw, [ns for g, ns in labels if g == geo]


def _gn(dI, bu, bv, dx, dy, ref, weights, patx, paty):
    """The Gauss-Newton loop of ops/trace.py:357-410 on JAX arrays."""
    def body(_, carry):
        best_u, best_v, u_bak, v_bak, step_back, best_e, done = carry
        hit = jbilinear(dI, best_u[:, None] + patx, best_v[:, None] + paty)
        r = hit[..., 0] - ref
        d_res = dx[:, None] * hit[..., 1] + dy[:, None] * hit[..., 2]
        ar = jnp.abs(r)
        hw = jnp.where(ar < GN["huber_th"], 1.0, GN["huber_th"] / jnp.maximum(ar, 1e-12))
        Hgn = 1.0 + jnp.sum(hw * d_res * d_res, axis=1)
        bgn = jnp.sum(hw * r * d_res, axis=1)
        energy = jnp.sum(weights * weights * hw * r * r * (2.0 - hw), axis=1)
        worse = energy > best_e
        sb_worse = step_back * 0.5
        step = jnp.clip(-bgn / Hgn, -0.5, 0.5)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        new_u = jnp.where(done, best_u, jnp.where(worse, u_bak + sb_worse * dx, best_u + step * dx))
        new_v = jnp.where(done, best_v, jnp.where(worse, v_bak + sb_worse * dy, best_v + step * dy))
        new_sb = jnp.where(done, step_back, jnp.where(worse, sb_worse, step))
        return (new_u, new_v, jnp.where(done | worse, u_bak, best_u),
                jnp.where(done | worse, v_bak, best_v), new_sb,
                jnp.where(done | worse, best_e, energy),
                done | (jnp.abs(new_sb) < GN["gn_threshold"]))

    carry = (bu, bv, bu, bv, jnp.zeros_like(bu), jnp.full_like(bu, 1e5),
             jnp.zeros_like(bu, dtype=bool))
    out = jax.lax.fori_loop(0, GN["gn_iters"], body, carry)
    return out[0], out[1], out[5]


def _finish(dI, energies, nsteps, ptx, pty, dx, dy, ref, weights, patx, paty):
    steps = jnp.arange(S_, dtype=jnp.float32)
    energies = jnp.where(steps[None, :] < nsteps[:, None], energies, jnp.inf)
    best_idx = jnp.argmin(energies, axis=1)
    best = jnp.min(energies, axis=1)
    outside = jnp.abs(jnp.arange(S_)[None, :] - best_idx[:, None]) > GN["radius"]
    second = jnp.min(jnp.where(outside, energies, jnp.inf), axis=1)
    bu = ptx + best_idx.astype(jnp.float32) * dx
    bv = pty + best_idx.astype(jnp.float32) * dy
    bu, bv, e_gn = _gn(dI, bu, bv, dx, dy, ref, weights, patx, paty)
    zero = jnp.zeros_like(bu)
    return np.array(jnp.stack([bu, bv, best, second, e_gn, best_idx.astype(jnp.float32),
                               zero, zero], axis=1))


def _jax_lanes(args):
    dI, scal, color, weights, patx, paty = (jnp.asarray(n(a)) for a in args)
    safe = lambda x: jnp.where(jnp.isfinite(x), x, 0.0)  # noqa: E731
    return (dI, safe(scal[:, 0]), safe(scal[:, 1]), safe(scal[:, 2]), safe(scal[:, 3]),
            scal[:, 4], scal[:, 5], scal[:, 6], color, weights, patx, paty)


def _jax_temporal(args):
    """ops/trace.py:329-410: the "xla" branch of trace_batch."""
    dI, ptx, pty, dx, dy, nsteps, aff_a, aff_b, color, weights, patx, paty = _jax_lanes(args)
    steps = jnp.arange(S_, dtype=jnp.float32)
    sx = ptx[:, None] + steps[None, :] * dx[:, None]
    sy = pty[:, None] + steps[None, :] * dy[:, None]
    energies = jtr._pattern_energy(
        dI, sx[:, :, None] + patx[:, None, :], sy[:, :, None] + paty[:, None, :],
        color[:, None, :], aff_a[:, None, None], aff_b[:, None, None], GN["huber_th"])
    ref = aff_a[:, None] * color + aff_b[:, None]
    return _finish(dI, energies, nsteps, ptx, pty, dx, dy, ref, weights, patx, paty)


def _jax_stereo(args, dirx):
    """ops/trace.py:852-963: the strip formulation of trace_stereo's "xla"
    branch, for the lanes of one direction."""
    dI, ptx, v, dx, dy, nsteps, _, _, color, weights, patx, paty = _jax_lanes(args)
    SW = S_ + 8
    PADX, PADY = SW, 8
    img = jnp.pad(dI[..., 0], ((PADY, PADY), (PADX, PADX)))
    ptx_f, v_f = jnp.floor(ptx), jnp.floor(v)
    fu, fv = ptx - ptx_f, v - v_f
    K0 = 4 if dirx > 0 else SW - 5
    x0 = ptx_f.astype(jnp.int32) - K0 + PADX
    y0 = v_f.astype(jnp.int32) - 2 + PADY
    strip = img[(y0[:, None] + jnp.arange(6)[None, :])[:, :, None],
                (x0[:, None] + jnp.arange(SW)[None, :])[:, None, :]]
    rows = (1.0 - fv[:, None, None]) * strip[:, :-1, :] + fv[:, None, None] * strip[:, 1:, :]
    energies = jnp.zeros((ptx.shape[0], S_), jnp.float32)
    for p in range(8):
        dxp, dyp = int(PATTERN[p, 0]), int(PATTERN[p, 1])
        row = rows[:, dyp + 2, :]
        if dirx > 0:
            seg0 = row[:, K0 + dxp:K0 + dxp + S_]
            seg1 = row[:, K0 + dxp + 1:K0 + dxp + S_ + 1]
        else:
            seg0 = row[:, K0 + dxp - (S_ - 1):K0 + dxp + 1][:, ::-1]
            seg1 = row[:, K0 + dxp + 1 - (S_ - 1):K0 + dxp + 2][:, ::-1]
        val = (1.0 - fu[:, None]) * seg0 + fu[:, None] * seg1
        r = val - color[:, p:p + 1]
        ar = jnp.abs(r)
        hw = jnp.where(ar < GN["huber_th"], 1.0, GN["huber_th"] / jnp.maximum(ar, 1e-12))
        energies = energies + hw * r * r * (2.0 - hw)
    dxs = jnp.full_like(ptx, dirx)
    return _finish(dI, energies, nsteps, ptx, v, dxs, jnp.zeros_like(ptx), color, weights,
                   patx, paty)


def _hold(out, ref, idx_min=0.95):
    out, ref = n(out) if torch.is_tensor(out) else out, n(ref) if torch.is_tensor(ref) else ref
    same = out[:, tk.OUT_BEST_IDX] == ref[:, tk.OUT_BEST_IDX]
    assert same.mean() >= idx_min, same.mean()
    np.testing.assert_allclose(out[same, :2], ref[same, :2], atol=1e-3, rtol=0)
    for lane in (tk.OUT_E_SEARCH, tk.OUT_SECOND_BEST, tk.OUT_E_GN):
        a, b = out[same, lane], ref[same, lane]
        assert (np.isnan(a) == np.isnan(b)).all(), lane
        assert (np.isposinf(a) == np.isposinf(b)).all(), lane
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-6, err_msg=str(lane))


def _masked_rules(out, nsteps):
    """What every version must give whatever the geometry."""
    out = n(out) if torch.is_tensor(out) else out
    ns = np.asarray(nsteps, np.float32)
    none = ~(ns > 0)  # 0 and NaN
    assert (out[none, tk.OUT_BEST_IDX] == 0).all()
    assert np.isposinf(out[none, tk.OUT_E_SEARCH]).all() and np.isposinf(out[none, tk.OUT_SECOND_BEST]).all()
    live = ~none
    assert (out[live, tk.OUT_BEST_IDX] < np.minimum(np.ceil(ns[live]), S_)).all()
    assert (out[ns == 1, tk.OUT_BEST_IDX] == 0).all()
    assert np.isfinite(out[:, :2]).all()


@pytest.mark.parametrize("geo", trace_lanes.GEOMETRY_TEMPORAL)
def test_edge_lanes_temporal_match_xla_search(image, geo):
    args, kw, nsteps = _case(image, False, geo)
    want = _jax_temporal(args)
    got = tk.epipolar_search_ref(*args, **kw)
    slab = tk.epipolar_search_slab_ref(*args, **kw)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(slab, nan=-1.0))
    _hold(got, want)
    _masked_rules(got, nsteps)
    if geo == "nan_pattern":  # a NaN sample makes every valid step's energy NaN
        live = np.asarray(nsteps) > 0
        assert np.isnan(n(got)[live, tk.OUT_E_SEARCH]).all()
        assert (n(got)[live, tk.OUT_BEST_IDX] == 0).all()


@pytest.mark.parametrize("geo", trace_lanes.GEOMETRY_STEREO)
def test_edge_lanes_stereo_match_xla_search(image, geo):
    args, kw, nsteps = _case(image, True, geo)
    got = tk.epipolar_search_ref(*args, **kw)
    slab = tk.epipolar_search_slab_ref(*args, **kw)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(slab, nan=-1.0))
    _masked_rules(got, nsteps)
    scal, color = n(args[1]), n(args[2])
    if geo in ("far_left", "far_right"):
        # beyond the clamp every tap is outside the image: zeros against the colour
        r = -color
        hw = np.where(np.abs(r) < GN["huber_th"], 1.0, GN["huber_th"] / np.maximum(np.abs(r), 1e-12))
        e0 = (hw * r * r * (2.0 - hw)).astype(np.float32)
        want = e0[:, 0]
        for p in range(1, 8):
            want = want + e0[:, p]
        live = np.asarray(nsteps) > 0
        np.testing.assert_allclose(n(got)[live, tk.OUT_E_SEARCH], want[live], rtol=1e-5)
        assert (n(got)[live, tk.OUT_BEST_IDX] == 0).all()  # all steps tie: the lowest
        return
    if geo in ("nan_dx", "inf_dx"):
        # the direction reads as 0, which the strip formulation cannot take:
        # every step samples the same place, so the lowest step wins the tie
        assert (n(got)[:, tk.OUT_BEST_IDX] == 0).all()
        one = [args[0], args[1].clone()] + args[2:]
        one[1][:, 4] = torch.clamp(torch.nan_to_num(one[1][:, 4]), max=1.0)
        ref1 = tk.epipolar_search_ref(*one, **kw)
        assert torch.equal(got[:, tk.OUT_E_SEARCH], ref1[:, tk.OUT_E_SEARCH])
        return
    dirs = np.where(np.isfinite(scal[:, 2]), scal[:, 2], 0.0)
    for dirx in (-1.0, 1.0):
        m = torch.from_numpy(dirs == dirx)
        if not bool(m.any()):
            continue
        sub = [args[0]] + [a[m].contiguous() for a in args[1:]]
        _hold(got[m], _jax_stereo(sub, dirx))


def _pallas(args, resident):
    """The lanes through a Pallas body in interpret mode, prepared as
    `trace_batch` prepares them (ops/trace.py:264-327): non-finite positions
    and directions as 0, slab origins, slab-relative start, lanes padded to
    a multiple of the block. Masked steps carry 1e30 there: read as +inf."""
    dI, scal, color, weights, patx, paty = args
    img_pad, oy, ox = jtp.pad_image_for_search(jnp.asarray(n(dI[..., 0])))
    Hp, Wp = img_pad.shape
    js = jnp.asarray(n(scal))
    ptx, pty, dx, dy = (jnp.where(jnp.isfinite(js[:, k]), js[:, k], 0.0) for k in range(4))
    ns = jnp.ceil(jnp.nan_to_num(js[:, 4])).astype(jnp.int32)
    y0, x0, ptx_rel, pty_rel = jtp.slab_origins(ptx, pty, dx, dy, ns, oy, ox, Hp, Wp)
    jscal = js.at[:, 0].set(ptx_rel).at[:, 1].set(pty_rel).at[:, 2].set(dx).at[:, 3].set(dy)
    pad = (-js.shape[0]) % 16
    lanes = [jnp.pad(jnp.asarray(x), [(0, pad)] + [(0, 0)] * (x.ndim - 1))
             for x in (y0, x0, jscal, n(color), n(weights), n(patx), n(paty))]
    out = np.array(jtp.epipolar_search(
        img_pad, *lanes, S=S_, BLK=16, huber_th=GN["huber_th"], gn_iters=GN["gn_iters"],
        gn_threshold=GN["gn_threshold"], resident=resident, interpret=True))[:js.shape[0]]
    out[:, 0] -= ox - np.array(x0, np.float32)
    out[:, 1] -= oy - np.array(y0, np.float32)
    out[:, 2:5] = np.where(out[:, 2:5] >= 1e29, np.inf, out[:, 2:5])
    return out


# geometry -> every tap of the lane inside the image. "top" is left out: a
# line leaving through the top passes the 8 rows `pad_image_for_search`
# adds there (`trace_batch` masks such lanes before the kernel), and
# "nan_pattern": the bodies' tent weights turn a NaN offset into zeros.
PALLAS_TEMPORAL = {"inside": True, "left": False, "right": False, "bottom": False,
                   "nan_ptx": False, "inf_ptx": False, "nan_dx": True, "inf_dx": False}
# the stereo search of the bodies edge-pads where the port reads zeros:
# only lanes whose strip lies inside the image compute the same function
PALLAS_STEREO = {"inside": True, "nan_dx": True, "inf_dx": True}


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "slab"])
@pytest.mark.parametrize("stereo,geo", [(False, g) for g in PALLAS_TEMPORAL]
                         + [(True, g) for g in PALLAS_STEREO])
def test_edge_lanes_match_pallas_bodies(image, stereo, geo, resident):
    """Tolerances (bf16 split dots against f32 taps): best_idx equal on >=
    95 % of a 24-lane case, the same +inf pattern in all three energies,
    e_search within 1e-2 relative; where every tap is inside the image also
    best_u/v within 1e-2 px and every energy within 1e-3 relative."""
    args, kw, nsteps = _case(image, stereo, geo)
    interior = (PALLAS_STEREO if stereo else PALLAS_TEMPORAL)[geo]
    want = _pallas(args, resident)
    _masked_rules(want, nsteps)
    for ref in (tk.epipolar_search_ref, tk.epipolar_search_slab_ref):
        got = n(ref(*args, **kw))
        same = got[:, tk.OUT_BEST_IDX] == want[:, tk.OUT_BEST_IDX]
        assert same.mean() >= 0.95, same.mean()
        for lane in (tk.OUT_E_SEARCH, tk.OUT_SECOND_BEST, tk.OUT_E_GN):
            a, b = got[same, lane], want[same, lane]
            assert (np.isposinf(a) == np.isposinf(b)).all(), lane
            fin = np.isfinite(b)
            if interior or lane == tk.OUT_E_SEARCH:
                np.testing.assert_allclose(a[fin], b[fin], rtol=1e-3 if interior else 1e-2,
                                           atol=1e-6, err_msg=str(lane))
        if interior:
            np.testing.assert_allclose(got[same, :2], want[same, :2], atol=1e-2, rtol=0)


@pytest.mark.parametrize("stereo", [False, True])
def test_edge_lanes_cover_their_cases(image, stereo):
    lanes, labels = trace_lanes.edge_lanes(image, S_, stereo, seed=3)
    geos = trace_lanes.GEOMETRY_STEREO if stereo else trace_lanes.GEOMETRY_TEMPORAL
    assert len(labels) == len(geos) * 6 * 4 == lanes["scal"].shape[0]
    scal = n(lanes["scal"])
    assert np.isnan(scal[:, 4]).sum() == len(geos) * 4
    assert np.isnan(scal[:, 0]).any() and np.isinf(scal[:, 0]).any()
    assert np.isnan(scal[:, 2]).any() and np.isinf(scal[:, 2]).any()
    assert np.isnan(n(lanes["patx"])).any() == (not stereo)
    # lines leave the image on all four sides within S steps
    fin = np.isfinite(scal[:, :4]).all(1)
    end = scal[fin, :2] + (S_ - 1) * scal[fin, 2:4]
    assert (end[:, 0] < 0).any() and (end[:, 0] > W_ - 1).any()
    if stereo:
        assert (scal[fin, 1] < 0).any() and (scal[fin, 1] > H_ - 1).any()
        assert (scal[fin, 0] < -(S_ + 16)).any() and (scal[fin, 0] > W_ + S_ + 16).any()
    else:
        assert (end[:, 1] < 0).any() and (end[:, 1] > H_ - 1).any()
    again, _ = trace_lanes.edge_lanes(image, S_, stereo, seed=3)
    for k in lanes:
        assert torch.equal(torch.nan_to_num(lanes[k]), torch.nan_to_num(again[k]))


# ---------------------------------------------------------------------------
# the wrapper's geometry and checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,length", [(1, 24), (40, 60), (46, 68), (86, 108), (100, 120)])
def test_slab_band_size_follows_S(S, length):
    cross, band_len, nbytes = tk.slab_window(S)
    assert (cross, band_len) == (tk.BAND_CROSS, length) == (16, length)
    assert band_len % 4 == 0 and band_len >= S + tk.BAND_EXTRA
    assert nbytes == 4 * (16 * length + (S + 3) // 4 * 4)
    assert tk.SLAB_WARPS * nbytes <= tk.SMEM_MAX
    # a band, not a box: under a fifth of the (S + 16)^2 floats of a bounding box
    if S >= 86:
        assert nbytes < 4 * (S + 16) ** 2 / 5
    assert tk.slab_window(S, 8)[1:] == (8, 4 * (16 * 8 + (S + 3) // 4 * 4))


def test_slab_shared_memory_limit(image):
    args, kw, _ = _case(image, False, "inside")
    s_max = max(s for s in range(1, 2000) if tk.SLAB_WARPS * tk.slab_window(s)[2] <= tk.SMEM_MAX)
    assert s_max >= 800  # the trace_max_steps cap of 100 is far inside
    tk.epipolar_search_slab(*args, **{**kw, "S": s_max})
    with pytest.raises(ValueError, match="shared memory"):
        tk.epipolar_search_slab(*args, **{**kw, "S": s_max + 1})
    with pytest.raises(ValueError, match="band_len"):
        tk.epipolar_search_slab(*args, **kw, band_len=10)
    with pytest.raises(ValueError, match="band_len"):
        tk.epipolar_search_slab(*args, **kw, band_len=0)
    # the cap changes no answer (on the CPU it is not even looked at)
    a = tk.epipolar_search_slab(*args, **kw, band_len=4)
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(tk.epipolar_search_slab(*args, **kw)))


def test_resident_step_limit(image):
    args, kw, _ = _case(image, False, "inside")
    assert tk.MAX_STEPS * 4 * tk.WARPS == 48 * 1024
    tk.epipolar_search(*args, **{**kw, "S": tk.MAX_STEPS})
    with pytest.raises(ValueError, match="S must be"):
        tk.epipolar_search(*args, **{**kw, "S": tk.MAX_STEPS + 1})
    with pytest.raises(ValueError, match="S must be"):
        tk.epipolar_search(*args, **{**kw, "S": 0})


@pytest.mark.parametrize("search", ["epipolar_search", "epipolar_search_slab"])
def test_strided_patterns_are_taken_in_place(image, search):
    """`trace_batch` hands slices of the rotated (N, 8, 2) pattern and
    `trace_stereo` one pattern broadcast over the lanes: no copy is asked
    for, and the answer is that of the contiguous copies."""
    fn = getattr(tk, search)
    args, kw, _ = _case(image, False, "inside")
    dI, scal, color, weights, patx, paty = args
    pat2 = torch.stack([patx, paty], dim=-1)
    sx, sy = pat2[:, :, 0], pat2[:, :, 1]
    assert not sx.is_contiguous()
    assert torch.equal(fn(dI, scal, color, weights, sx, sy, **kw), fn(*args, **kw))
    sargs, skw, _ = _case(image, True, "inside")
    pat = torch.from_numpy(PATTERN.astype(np.float32))
    N = sargs[1].shape[0]
    bx, by = pat[None, :, 0].expand(N, 8), pat[None, :, 1].expand(N, 8)
    assert bx.stride() == (0, 2)
    assert torch.equal(fn(*sargs[:4], bx, by, **skw), fn(*sargs, **skw))
    with pytest.raises(ValueError):  # the other operands stay contiguous
        fn(dI, scal, color.t().contiguous().t(), weights, sx, sy, **kw)


def test_capture_records_wrapper_calls(image, monkeypatch):
    """`ops/trace.py` reaches both wrappers through the `trace_cuda` module
    at each call, so a recording wrapper set on the module for a frame sees
    the operands of the real launches (chip_smoke.py times the kernels on
    lanes taken this way)."""
    args, kw, _ = _case(image, False, "inside")
    calls = []
    for name in ("epipolar_search", "epipolar_search_slab"):
        def record(*tensors, _name=name, _fn=getattr(tk, name), **ckw):
            calls.append((_name, tensors, ckw))
            return _fn(*tensors, **ckw)
        monkeypatch.setattr(tk, name, record)
    scal = args[1]
    for route in ("resident", "slab"):
        ttr._search(args[0], *(scal[:, k] for k in range(7)), *args[2:],
                    torch.zeros(scal.shape[0], dtype=torch.bool), S_, default_settings(),
                    tk.EDGE_CLAMP, route)
    assert [c[0] for c in calls] == ["epipolar_search", "epipolar_search_slab"]
    for _, tensors, ckw in calls:
        assert ckw["S"] == S_ and ckw["edge"] == tk.EDGE_CLAMP
        assert torch.equal(torch.nan_to_num(tensors[1]), torch.nan_to_num(scal))
        assert tensors[4] is args[4] and tensors[5] is args[5]  # patterns go as they are


def test_kernel_sources_and_headers_are_versioned():
    """A build is keyed on the source and the shared header."""
    for src in tk.SOURCES.values():
        text = src.read_text()
        assert '#include "epipolar_common.cuh"' in text
    assert all(h.is_file() for h in tk.HEADERS)
    assert set(tk._ARGTYPES) == set(tk.SOURCES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_case(stereo, size):
    w, h, S = size
    scene = synthetic.default_scene(6)
    left, _, _ = synthetic.render_stereo_pair(scene, synthetic.default_K(w, h), w, h, 0.2)
    dI = tbuild_pyramid(torch.from_numpy(np.asarray(left, np.float32)), 1)[0][0].contiguous().cuda()
    lanes, _ = trace_lanes.edge_lanes(dI, S, stereo, seed=9, reps=16)
    args = [dI] + [lanes[k] for k in ("scal", "color", "weights", "patx", "paty")]
    return args, dict(S=S, edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP, **GN)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1216, 352, 46), (2048, 1024, 86)])
@pytest.mark.parametrize("stereo", [False, True])
def test_kernels_on_edge_lanes(stereo, size):
    """Both kernels against their plain versions and against each other on
    the edge lanes (chip_smoke.py runs the same at its own sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args, kw = _card_case(stereo, size)
    k1 = tk.epipolar_search(*args, **kw)
    k2 = tk.epipolar_search_slab(*args, **kw)
    torch.cuda.synchronize()
    _hold(k1.cpu(), tk.epipolar_search_ref(*args, **kw).cpu(), idx_min=0.999)
    _hold(k2.cpu(), tk.epipolar_search_slab_ref(*args, **kw).cpu(), idx_min=0.999)
    assert torch.equal(torch.nan_to_num(k1, nan=-1.0), torch.nan_to_num(k2, nan=-1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("band_len", [4, 16])
@pytest.mark.parametrize("stereo", [False, True])
def test_slab_kernel_out_of_band_fallback(stereo, band_len):
    """A band far too short for the lane: most taps read global memory, and
    the answer is bit for bit that of the full band and of the other kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kw = _card_case(stereo, (2048, 1024, 86))
    full = tk.epipolar_search_slab(*args, **kw)
    cut = tk.epipolar_search_slab(*args, **kw, band_len=band_len)
    k1 = tk.epipolar_search(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(cut, nan=-1.0), torch.nan_to_num(full, nan=-1.0))
    assert torch.equal(torch.nan_to_num(cut, nan=-1.0), torch.nan_to_num(k1, nan=-1.0))
