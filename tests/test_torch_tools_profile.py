"""The port's profiling tools (`stereo_dso_g2o_tpu_torch/tools/profile_*`)
on the CPU at a tiny size: bench.py's smoke corridor (256x128), a frame or
two past the 12-frame bootstrap (profile_frame: past its 8 warm frames).
Each `main` returns the JSON line it prints, with the JAX tool's stage keys
and the profiler's summary, whose device numbers are None on the CPU
(there is no device to be busy)."""

from stereo_dso_g2o_tpu_torch.tools import (
    profile_frame, profile_kf_stages, profile_refine_stages, profile_track_stages,
)

SMALL = dict(small=1, device="cpu")
PROFILE_KEYS = ("aten_ops_per_frame", "device_busy_share", "kernels_per_frame")


def test_profile_frame_keys():
    out = profile_frame.main(frames=2, traced=1, **SMALL)
    for k in ("n_timed", "fps", "frame_ms_mean", "frame_ms_p50", "frame_ms_p90",
              "kf_frame_ms_p50", "nonkf_frame_ms_p50", "kf_rate", "n_keyframes", *PROFILE_KEYS):
        assert k in out, k
    assert out["n_timed"] == 2 and out["aten_ops_per_frame"] > 0
    assert out["traced_mode"] == "eager (program.disabled)"
    assert out["device_busy_share"] is None  # no device on the CPU


def test_profile_track_stages_keys():
    out = profile_track_stages.main(at=13, reps=1, **SMALL)
    for st in ("pyramids", "cascade_1try", "cascade_5try_select", "nonkey_refine"):
        assert out[f"stage_{st}_ms"] > 0, st
        assert out[f"prefix_{st}_ms"] > 0, st
    assert out["prefix_nonkey_refine_ms"] >= out["prefix_cascade_5try_select_ms"]


def test_profile_kf_stages_keys():
    out = profile_kf_stages.main(capture_after=14, reps=1, **SMALL)
    for st in ("trace_on_kf", "flag_insert", "activation", "ba", "finalize_refbuild",
               "select_seed", "marg_frames"):
        assert f"stage_{st}_ms" in out and f"prefix_{st}_ms" in out, st
        assert out[f"stage_{st}_ms"] >= 0, st
    assert out["kf_frame"] >= 12 and out["frame_track_ms"] > 0
    assert abs(out["prefix_marg_frames_ms"] - out["kf_branch_ms"]) < 1e-2


def test_profile_refine_stages_keys():
    out = profile_refine_stages.main(at=13, reps=1, **SMALL)
    assert out["n_live_immature"] > 0 and sum(out["status_hist"].values()) == out["n_live_immature"]
    for route in ("resident", "slab"):
        for st in profile_refine_stages.STEPS:
            assert out[f"{route}_stage_{st}_ms"] > 0, (route, st)
        assert out[f"{route}_full_refine_ms"] > 0
