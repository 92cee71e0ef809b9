"""The port's four instruments (`stereo_dso_g2o_tpu_torch/tools/`
`bench_tunnel`, `bench_trace_kernel`, `kernel_gap_probe`, `roofline`) and
the search's bound, on the CPU at bench.py's small size (256x128): each
tool's inputs against what the JAX tool's own code builds from the same
state and frames, each `main` with `device=cpu` to its keys (the device's
numbers None), the roofline's aggregation on a fixed list of launches, and
`trace_cuda.search_bound` on hand-counted lanes. Last, the port and
`chip_smoke.py` import with JAX and the JAX package made unimportable."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import fields
from test_torch_immature import seeded  # noqa: F401  (the module fixture)

from stereo_dso_g2o_tpu.backend import window as jW
from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.frontend import frame_step as jFS
from stereo_dso_g2o_tpu.frontend import graph_system as jgs
from stereo_dso_g2o_tpu.frontend import immature as jIMM
from stereo_dso_g2o_tpu.ops import trace as jT
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from stereo_dso_g2o_tpu.utils import se3 as jse3
from stereo_dso_g2o_tpu_torch import bench, bridge
from stereo_dso_g2o_tpu_torch.config import Settings
from stereo_dso_g2o_tpu_torch.frontend.graph_system import FrameBundle
from stereo_dso_g2o_tpu_torch.io import synthetic
from stereo_dso_g2o_tpu_torch.ops import trace as T
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.tools import (
    bench_trace_kernel, bench_tunnel, kernel_gap_probe, roofline,
)
from stereo_dso_g2o_tpu_torch.tools._common import host_split, sequence, union_ns

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(small=1, device="cpu")
JSET = jdefault_settings()


@pytest.mark.parametrize("trace_cap", [5120, 120])
def test_kernel_gap_probe_lanes_are_the_jax_tools(seeded, trace_cap):  # noqa: F811
    """The live pool and per-lane transforms of one seeded immature set
    (two of three slots seeded, slot 1 not a host), bridged to the port,
    against `tools/kernel_gap_probe.py:62-87`'s code on the JAX set; with
    trace_cap=120 the pool is smaller than the ~170 live rows."""
    jset = seeded[0]
    F = jset.u.shape[0]
    rng = np.random.default_rng(3)
    w2c = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6))), np.float32)
                    for _ in range(F)])
    frame_valid = np.array([True, False, True])
    ref_slot = 2
    K = np.asarray(synthetic.default_K(192, 96), np.float32)
    Ki = np.linalg.inv(K).astype(np.float32)
    jsettings = dataclasses.replace(JSET, trace_cap=trace_cap)
    with jax.enable_x64(False):
        Km, Kim = jnp.asarray(K), jnp.asarray(Ki)
        T_new = w2c[ref_slot]
        T_hn = jnp.einsum("ij,fjk->fik", jnp.asarray(T_new), jnp.linalg.inv(jnp.asarray(w2c)))
        KRKi = jnp.einsum("ij,fjk,kl->fil", Km, T_hn[:, :3, :3], Kim)
        Kt = jnp.einsum("ij,fj->fi", Km, T_hn[:, :3, 3])
        aff_ht = jnp.zeros((F, 2)).at[:, 0].set(1.0)
        flat, _ = jax.jit(lambda imm: jIMM._compact_live(imm, jnp.asarray(frame_valid),
                                                         jsettings))(jset)
        flat = jax.device_get(flat)
        host = flat["host"]
        want = dict(flat, KRKi=np.asarray(KRKi)[host], Kt=np.asarray(Kt)[host],
                    aff=np.asarray(aff_ht)[host])

    tset = bridge.immature_from_numpy(fields(jset), device="cpu")
    settings = bridge.settings_from_fields({**dataclasses.asdict(JSET), "trace_cap": trace_cap})
    got = kernel_gap_probe.production_lanes(
        tset, torch.from_numpy(frame_valid), torch.from_numpy(w2c), ref_slot,
        torch.from_numpy(K), torch.from_numpy(Ki), settings)
    assert set(got) == set(want)
    assert len(got["u"]) == min(F * jset.u.shape[1], trace_cap)
    for k, w in want.items():
        g = got[k].numpy()
        if k in ("KRKi", "Kt", "aff"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
        else:
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype), err_msg=k)


@pytest.fixture(scope="module")
def corridor():
    """bench.py's small sequence 0 to frame 33, rendered by the port."""
    _, cfg, _, _, lefts, _, poses = sequence(0, bench_trace_kernel.TARGET_FRAME + 1, True, None,
                                             "cpu")
    return cfg, lefts, poses


def test_bench_trace_kernel_inputs_are_the_jax_tools(corridor):
    """`trace_inputs` against `tools/bench_trace_kernel.py:44-67`'s code on
    the same frames (x64 off, as the tool runs), and the port's
    `trace_batch` on them, through either kernel's plain version, against
    the JAX `"xla"` backend's statuses on every lane."""
    cfg, lefts, poses = corridor
    i, j, n = bench_trace_kernel.HOST_FRAME, bench_trace_kernel.TARGET_FRAME, 2048
    K = synthetic.default_K(cfg["w"], cfg["h"], fov_deg=80.0)
    settings = Settings()
    got = bench_trace_kernel.trace_inputs(lefts[i], lefts[j], K, poses[i], poses[j], n, settings)
    with jax.enable_x64(False):
        dIh = jbuild_pyramid(jnp.asarray(lefts[i].numpy(), jnp.float32), 1)[0][0]
        dIt = jbuild_pyramid(jnp.asarray(lefts[j].numpy(), jnp.float32), 1)[0][0]
        K0 = np.asarray(K)
        T_ht = np.linalg.inv(np.asarray(poses[j])) @ np.asarray(poses[i])
        KRKi = K0 @ T_ht[:3, :3] @ np.linalg.inv(K0)
        Kt = K0 @ T_ht[:3, 3]
        rng = np.random.default_rng(1)
        us = jnp.asarray(rng.uniform(16, cfg["w"] - 16, n).astype(np.float32))
        vs = jnp.asarray(rng.uniform(16, cfg["h"] - 16, n).astype(np.float32))
        id_true = rng.uniform(1 / 40.0, 1 / 5.0, n).astype(np.float32)
        color, weights, gradH, eth = jT.extract_point_data(dIh, us, vs, JSET)
        want = (us, vs, jnp.asarray(id_true * 0.7), jnp.asarray(id_true * 1.5), color, weights,
                gradH, eth, jnp.full((n,), 10000.0, jnp.float32),
                jnp.full((n,), jT.IPS_UNINITIALIZED, jnp.int32),
                jnp.broadcast_to(jnp.asarray(KRKi, jnp.float32), (n, 3, 3)),
                jnp.broadcast_to(jnp.asarray(Kt, jnp.float32), (n, 3)),
                jnp.stack([jnp.ones(n), jnp.zeros(n)], 1).astype(jnp.float32), dIt)
        jstatus = np.asarray(jT.trace_batch(*want, settings=JSET, backend="xla").status)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=str(k))
    assert (jstatus == jT.IPS_GOOD).sum() > n // 4
    for route in ("resident", "slab"):
        st = T.trace_batch(*got, settings=settings, route=route).status.numpy()
        np.testing.assert_array_equal(st, jstatus, err_msg=route)


def test_bench_trace_kernel_keys():
    out = bench_trace_kernel.main(n=256, **SMALL)
    assert out["n_points"] == 256 and out["search_bound_by"] in ("bytes", "operations")
    for k in ("trace_batch_resident", "trace_batch_slab", "plain_search", "kernel_gn0",
              "kernel_gn3", "kernel_slab_gn0", "kernel_slab_gn3"):
        assert out[f"{k}_ms"] > 0, k
        assert out[f"{k}_device_ms"] is None, k  # no device on the CPU
    assert out["kernel_gn3_bound_share"] is None and out["search_bound_gn3_ms"] > 0


def test_kernel_gap_probe_keys():
    out, (ops, kw) = kernel_gap_probe.probe(frames=13, **SMALL)
    s = bench.bench_settings(bench.bench_config(True))
    assert out["n_lanes"] == ops[1].shape[0] == min(s.window_cap * s.immature_cap, s.trace_cap)
    assert 0 <= out["n_status_oob"] <= out["n_lanes"]
    assert 0 <= out["n_uninit_maxinf"] <= out["n_lanes"]
    for k in ("standalone_production_data", "standalone_synthetic_data",
              "standalone_inf_interval", "direct_kernel_resident1", "direct_kernel_resident0"):
        assert out[f"{k}_ms"] > 0 and out[f"{k}_device_ms"] is None, k
    assert out["direct_kernel_100reps_ms_each"] > 0
    assert out["in_frame_k1_us_mean"] is None and out["in_frame_k1_launches"] is None
    assert kw["S"] > 0 and ops[0].shape[2] == 3


def _jax_frame_bundle(F, n_levels):
    """The FrameBundle the JAX package's non-keyframe branch returns for a
    window of F slots and a tracker of `n_levels` levels."""
    eye = jnp.eye(4, dtype=jnp.float32)
    z = jnp.zeros
    state = jgs.GraphState(*[None] * len(jgs.GraphState._fields))._replace(
        win=jW.empty_window(F, 1, [1.0, 1.0, 0.0, 0.0]), ref_slot=jnp.int32(0),
        last_c2w=eye, last_rel=eye, last_slot=jnp.int32(0), last_fid=jnp.int32(0))
    track = jFS.TrackOut(T=eye, aff=z(2), residuals=z(n_levels), flow=z(3),
                         ok=jnp.asarray(True), sat_frac0=z(()))
    return jgs._nonkf_branch(state, jIMM.empty(F, 1), track, eye, z(2), z(3), jnp.asarray(True),
                             z(()), z(()), jnp.asarray(False), z(3))[1]


def test_bench_tunnel_keys_and_bundle():
    out = bench_tunnel.main(device="cpu")
    for k in ("fetch_scalar_ms", "fetch_bundle_pytree_ms", "fetch_bundle_packed_ms",
              "upload_stereo_pair_ms", "upload_8pair_batch_ms", "slice_resident_frame_ms",
              "dispatch_sync_trivial_ms", "dispatch_enqueue_ms", "wrapper_enqueue_ms"):
        assert out[k] > 0, k
    assert out["backend"] == "cpu" and out["device"] == "cpu"
    jb = _jax_frame_bundle(JSET.window_cap, 6)
    assert out["bundle_n_leaves"] == len(jb) == len(FrameBundle._fields)
    assert out["bundle_n_floats"] == sum(int(np.size(x)) for x in jb)
    tb = bench_tunnel.frame_bundle(JSET.window_cap, 6, "cpu")
    assert [tuple(x.shape) for x in tb] == [tuple(np.shape(x)) for x in jb]


def test_roofline_keys():
    out = roofline.main(traced=1, **SMALL)
    assert out["n_frames_traced"] == 1 and out["wall_ms_per_frame"] > 0
    assert out["mode"] == "eager (program.disabled)"
    for k in ("device_ms_per_frame", "launches_per_frame", "top_ops", "short_kernel_share",
              "search_ops", "achieved_GBps", "pct_of_peak"):
        assert out[k] is None, k  # no device on the CPU
    assert out["peak_GBps"] == 3350.0 and out["search_bytes_per_frame"] > 0
    assert set(out["search_launches_per_frame"]) == {"epipolar_search", "epipolar_search_slab"}
    assert "no byte count" in out["bytes_scope"] and "not measured traffic" in out["bytes_scope"]
    host = out["host"]  # the CPU's own ops are traced there too; no runtime calls
    assert host["frames"] == roofline.HOST_FRAMES and host["untraced_wall_ms_per_frame"] > 0
    assert 0 < host["aten_ms_per_frame"] <= host["wall_ms_per_frame"]
    assert host["launch_calls_per_frame"] == 0 and host["launch_ms_per_frame"] == 0
    assert host["other_runtime_ms_per_frame"] == 0
    assert 0 <= host["outside_ms_per_frame"] < host["wall_ms_per_frame"]


def test_union_of_nested_intervals():
    assert union_ns([]) == 0
    assert union_ns([(20, 25), (0, 10), (2, 5), (8, 12), (21, 22), (25, 30)]) == 12 + 10


class _Event:
    def __init__(self, name, start, dur, device=torch.autograd.DeviceType.CPU):
        self._v = name, start, dur, device

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_host_split_of_fixed_events():
    """Two frames, 1 ms each of wall: nested aten ops count once, launch
    calls inside or outside them count as launches, other runtime calls
    apart, device records and other host records (cuDNN, Python) in none."""
    events = [_Event("aten::add", 0, 100_000), _Event("aten::empty", 10_000, 5_000),
              _Event("cudaLaunchKernel", 50_000, 20_000), _Event("aten::mul", 300_000, 50_000),
              _Event("cuLaunchKernelEx", 400_000, 30_000),
              _Event("cudaMemcpyAsync", 500_000, 40_000),
              _Event("cudnnConvolutionForward", 600_000, 10_000),
              _Event("python_function", 700_000, 90_000),
              _Event("epipolar_search_kernel", 0, 900_000, torch.autograd.DeviceType.CUDA)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    got = host_split(Prof, 1.0, 2)
    assert got["aten_ms_per_frame"] == pytest.approx(0.150 / 2)
    assert got["launch_calls_per_frame"] == 1.0
    assert got["launch_ms_per_frame"] == pytest.approx(0.050 / 2)
    assert got["other_runtime_ms_per_frame"] == pytest.approx(0.040 / 2)
    assert got["outside_ms_per_frame"] == pytest.approx(1.0 - (0.150 + 0.030 + 0.040) / 2)


def test_roofline_aggregation_of_fixed_launches():
    launches = [("k_a", 10.0), ("Memcpy HtoD (Pageable -> Device)", 3.0), ("k_b", 20.0),
                ("k_a", 2.0), ("Memset (Device)", 1.0), ("epipolar_search_kernel", 4.0),
                ("epipolar_search_slab_kernel", 6.0), ("epipolar_search_kernel", 2.0)]
    total = sum(us for _, us in launches)
    rows = roofline.op_rows(launches, 2, total)
    assert [(r["op"], r["category"]) for r in rows] == [
        ("k_b", "kernel"), ("k_a", "kernel"), ("epipolar_search_kernel", "kernel"),
        ("epipolar_search_slab_kernel", "kernel"), ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
        ("Memset (Device)", "memset")]
    k_a = rows[1]
    assert k_a["launches_per_frame"] == 1.0 and k_a["us_per_launch"] == 6.0
    assert k_a["self_ms_per_frame"] == pytest.approx(0.006)
    assert sum(r["pct"] for r in rows) == pytest.approx(100.0)
    assert sum(r["pct"] for r in rows[:3]) <= 100.0
    from stereo_dso_g2o_tpu_torch.tools._common import search_kernel

    search = roofline.op_rows([x for x in launches if search_kernel(x[0])], 2, total, search_kernel)
    assert [(r["op"], r["launches_per_frame"]) for r in search] == [
        ("epipolar_search", 1.0), ("epipolar_search_slab", 0.5)]
    assert search[0]["pct"] == pytest.approx(100.0 * 6.0 / 48.0)
    share = roofline.short_kernel_share(launches)
    assert share["device_time"] == pytest.approx((3.0 + 1.0 + 4.0 + 2.0 + 2.0) / 48.0)
    assert share["launches"] == pytest.approx(5 / 8)


def _lanes(num_steps):
    scal = torch.zeros((len(num_steps), 8))
    scal[:, 2] = 1.0  # horizontal lines
    scal[:, 4] = torch.tensor(num_steps, dtype=torch.float32)
    return scal


@pytest.mark.parametrize("case", ["all_masked", "horizontal", "capped_at_the_plane"])
def test_search_bound_hand_counted(case):
    """Bytes: 4 x (plane pixels the lanes need + 5 operands of 8 + the 8
    outputs per lane); operations: 8 x (30 per step + 80 per GN iteration)
    per lane. A lane needs 8 x (valid steps + 7) pixels."""
    if case == "all_masked":  # no valid step: 0, negative, NaN
        H, W, S, gn, scal = 100, 100, 30, 3, _lanes([0.0, -2.0, float("nan")] + [0.0] * 7)
        pixels, steps = 8 * 7 * 10, 0
    elif case == "horizontal":  # 5, ceil(10.5), 20, S
        H, W, S, gn, scal = 100, 100, 30, 3, _lanes([5.0, 10.5, 20.0, 100.0])
        steps = 5 + 11 + 20 + 30
        pixels = 8 * (steps + 7 * 4)
    else:  # one long lane on an 8 x 8 image: the plane's 64 pixels, bound by operations
        H, W, S, gn, scal = 8, 8, 1000, 3, _lanes([1000.0])
        pixels, steps = 64, 1000
    n = scal.shape[0]
    want_bytes = 4 * (pixels + 5 * n * 8 + n * 8)
    want_ops = 8 * (30 * steps + 80 * gn * n)
    b = tk.search_bound(H, W, scal, S, gn)
    assert b.bytes == want_bytes and b.ops == want_ops
    t_bytes, t_ops = want_bytes / 3.35e12, want_ops / 67e12
    assert b.ms == pytest.approx(1000.0 * max(t_bytes, t_ops), rel=1e-12)
    assert b.by == ("operations" if case == "capped_at_the_plane" else "bytes")


def test_the_port_and_chip_smoke_import_without_jax():
    """Every module of the package, tools included, `chip_smoke.py` and
    `kernel_steps.py`, imported in a process where importing jax or the JAX
    package fails."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["stereo_dso_g2o_tpu"] = None
import stereo_dso_g2o_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke", "kernel_steps"]:
    importlib.import_module(name)
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print(len(names))
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert int(run.stdout.strip().splitlines()[-1]) > 40
