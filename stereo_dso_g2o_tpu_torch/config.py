"""Global configuration for the TPU stereo-DSO engine.

Replaces the reference's mutable-global flag system (`util/settings.{h,cpp}`,
defaults at settings.cpp:29-158) with an immutable dataclass that is hashable,
so it can be closed over by jitted functions as a static argument.

The residual pattern is the reference's "8 for SSE efficiency" pattern
(settings.cpp:216-219, index 8 of staticPattern; patternNum=8, padding=2,
settings.h:177-179).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# The 8-pixel residual pattern ("full-spread-8", util/settings.cpp:216-219).
PATTERN = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.int32,
)
PATTERN_NUM = 8
PATTERN_PADDING = 2

# Maximum pyramid levels (util/settings.h:46).
PYR_LEVELS = 6

# Number of global camera intrinsic parameters fx fy cx cy (util/NumType.h:47).
CPARS = 4

# State preconditioning scales (FullSystem/HessianBlocks.h:54-70).
SCALE_IDEPTH = 1.0
SCALE_XI_ROT = 1.0
SCALE_XI_TRANS = 0.5
SCALE_F = 50.0
SCALE_C = 50.0
SCALE_A = 10.0
SCALE_B = 1000.0


@dataclasses.dataclass(frozen=True)
class Settings:
    """Immutable run configuration.

    Field defaults mirror the reference defaults in util/settings.cpp:29-158
    (the fork's modified values, noted where they differ from upstream DSO).
    Capacity fields (`*_cap`) are new: the TPU design uses fixed-capacity
    masked arrays instead of dynamic point sets, so every dynamic count in the
    reference becomes a static capacity here.
    """

    # -- keyframe policy (settings.cpp:32-39) --
    max_shift_weight_t: float = 0.04 * (640 + 480)
    max_shift_weight_r: float = 0.0 * (640 + 480)
    max_shift_weight_rt: float = 0.02 * (640 + 480)
    kf_global_weight: float = 1.0
    max_affine_weight: float = 2.0

    # -- priors (settings.cpp:43-49) --
    idepth_fix_prior: float = 50.0 * 50.0
    idepth_fix_prior_marg_fac: float = 600.0 * 600.0
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_b_prior: float = 1e14
    initial_aff_a_prior: float = 1e14
    initial_calib_hessian: float = 5e9

    # -- solver (settings.cpp:51-54) --
    solver_mode_delta: float = 0.00001
    force_accept_step: bool = True

    # -- activation / marginalization thresholds (settings.cpp:56-66) --
    min_idepth_h_act: float = 100.0
    min_idepth_h_marg: float = 50.0
    desired_immature_density: float = 1500.0  # preset-0 value (main:104-116)
    desired_point_density: float = 2000.0  # preset-0 value
    min_points_remaining: float = 0.05
    max_log_aff_fac_in_window: float = 0.7
    min_frames: int = 5
    max_frames: int = 7
    min_frame_age: int = 1
    max_opt_iterations: int = 6
    min_opt_iterations: int = 1
    th_opt_iterations: float = 1.2

    # -- outlier thresholds (settings.cpp:72-76) --
    outlier_th: float = 12.0 * 12.0
    outlier_th_sum_component: float = 50.0 * 50.0
    marg_weight_fac: float = 0.5 * 0.5

    # -- re-tracking (settings.cpp:79) --
    re_track_threshold: float = 1.5
    # TPU-native robustness superset of the reference's sequential retry
    # ladder (FullSystem.cpp:441-505): always evaluate ALL motion-model
    # hypotheses in the fused frame program (they are a vmapped batch axis —
    # nearly free) and keep the lowest-residual one, instead of engaging the
    # extra hypotheses only when try-0 regresses past re_track_threshold.
    # True: evaluate the whole motion-hypothesis ladder every frame as ONE
    # vmapped cascade (a batch axis is nearly free on TPU and the fused frame
    # program keeps a single static shape); False: reference-style lax.cond
    # that skips the ladder when try-0 passes the accept gate.
    always_retry_ladder: bool = True
    # Which hypothesis wins once the ladder is evaluated:
    # - "sequential": the reference's policy replayed (trackNewCoarse
    #   STEP2-4: ladder order, strict improvement, stop at the accept gate)
    #   — in the normal case try-0 wins outright.
    # - "best": lowest level-0 residual wins, try-0 preferred when it is
    #   good (its saturation gate passes). Round-2 evidence: removes
    #   init-dependent basin hopping on repetitive texture (1.83 m -> 7.8 mm
    #   ATE, PERF.md round 2).
    # Default is "best": replaying the sequential policy diverged the
    # round-3 smoke bench catastrophically (ATE 8.37 m over a 4.8 m path —
    # a 4 m basin hop at frame 21 passed the lenient accept gate), while
    # best-of holds 0.068 m on the same frames. The rotation staircase that
    # motivated trying "sequential" in round 3 is the milder failure mode.
    hypothesis_selection: str = "best"
    # Coarse-only hypothesis evaluation (the always-on ladder's 5x residual
    # work is a real per-frame tax now that tracking is compute-bound, not
    # dispatch-bound — VERDICT r4 weak #3). 0: every hypothesis runs the
    # full cascade (round-2..4 behavior). k>0: all hypotheses run only the
    # COARSE levels (n_levels-1 .. k), the winner is picked there
    # (best-of with try-0 preference, keyed on the level-k residual), and
    # only the winner descends the k fine levels (k-1 .. 0). Per-level LM
    # cost scales ~4x per level of descent, so k=2 cuts the cascade's
    # hypothesis tax ~4x while the basin-selection protection (PERF.md
    # round 2) still acts at level k. The reference's own abort rule prunes
    # losing tries at coarse levels the same way (CoarseTracker.cpp
    # :1032-1033 via trackNewCoarse's min-res ladder).
    # Default 2 per the round-5 on-chip A/B (200-frame KITTI-res corridor,
    # post quality-fix): k=2 gives rel-trans 0.811 % / rel-rot 0.0030 /
    # 46 KFs vs 0.461 % / 0.0027 / 47 KFs for the full ladder — both >4x
    # inside the reference envelope — for ~17 ms saved on EVERY frame (the
    # measured 5-try tax, PERF.md round 5). Set 0 for the accuracy-maximal
    # full ladder.
    ladder_fine_levels: int = 2

    # -- residual count gates (settings.cpp:82-83) --
    min_good_active_res_for_marg: int = 3
    min_good_res_for_marg: int = 4

    # -- photometric calibration (settings.cpp:88-92) --
    photometric_calibration: int = 2
    use_exposure: bool = True
    affine_opt_mode_a: float = 1e12
    affine_opt_mode_b: float = 1e8
    gamma_weights_pixel_select: int = 1

    # -- robust weighting (settings.cpp:95) --
    huber_th: float = 9.0

    # -- adaptive frame energy threshold (settings.cpp:98-102) --
    frame_energy_th_const_weight: float = 0.5
    frame_energy_th_n: float = 0.7
    frame_energy_th_fac_median: float = 1.5
    overall_energy_th_weight: float = 1.0
    coarse_cutoff_th: float = 20.0

    # -- pixel selection (settings.cpp:105-108) --
    min_grad_hist_cut: float = 0.5
    min_grad_hist_add: float = 7.0
    grad_downweight_per_level: float = 0.75
    select_direction_distribution: bool = True

    # -- immature point tracing (settings.cpp:111-121) --
    max_pix_search: float = 0.027
    min_trace_quality: float = 3.0
    min_trace_test_radius: int = 2
    gn_its_on_point_activation: int = 3
    trace_stepsize: float = 1.0
    trace_gn_iterations: int = 3
    trace_gn_threshold: float = 0.1
    trace_extra_slack_on_th: float = 1.2
    trace_slack_interval: float = 1.5
    trace_min_improvement_factor: float = 2.0
    trace_max_steps: int = 100  # errors[100] cap, ImmaturePoint.cpp:260

    # -- static-stereo consistency gates --
    # L->R / R->L re-trace acceptance (CoarseTracker.cpp:330-334: u_delta<1,
    # 0<depth<50; FullSystem.cpp traceNewCoarseNonKey uses depth<70).
    stereo_u_delta_max: float = 1.0
    stereo_depth_max: float = 50.0
    nonkey_stereo_depth_max: float = 70.0

    # -- TPU capacities (new: fixed-size SoA arrays replace dynamic sets) --
    immature_cap: int = 2048  # immature points per keyframe
    active_cap: int = 2048  # active (PointHessian) points per keyframe
    # candidates optimized per activation pass: bounds the 1-dof LM batch
    # (gated candidates rarely exceed the per-KF activation need; overflow
    # simply stays immature until the next keyframe)
    activation_batch: int = 2048
    # live immature points traced per frame: the (F, immature_cap) pool is
    # sized for worst-case seeding, but typically <25% of rows are alive, so
    # the per-frame traces (temporal + 2x static stereo) compact live rows to
    # this fixed batch first. Overflow rows simply keep their interval until
    # a later frame (bounded, burst-only deviation).
    # Compact trace-pool lanes. The epipolar kernel costs ~3 us/LANE
    # (PERF.md round 5), so this cap is a first-order fps knob. Live
    # immature counts at the reference-healthy KF cadence (47/200 frames,
    # round-5 bench obs): p50 3082, max 4748 — 5120 covers the observed
    # max with margin; overflow rows gracefully keep their interval until
    # a later frame. (Round 4's 6144 was sized against the inflated
    # 68-KF cadence whose seeding pushed the pool to 5682.)
    trace_cap: int = 5120
    # Precision of the pallas trace kernel's interpolation dots:
    # "split" = hi/lo bf16 split (3 passes, second-order residual
    # truncation on TPU), "highest" = Precision.HIGHEST (6 passes, exact
    # f32). The kernel is ~0.6 ms either way; see trace.default_backend's
    # round-5 A/B notes.
    trace_dot_precision: str = "split"
    # per-KF eigenvalue/Hessian-diag/nullspace dump into the stats stream
    # (setting_logStuff's printEigenValLine, FullSystem.cpp:1689-1768)
    log_eigenvalues: bool = False
    window_cap: int = 8  # keyframe window capacity (max_frames + 1 slack)

    # -- distributed BA (BASELINE config 5) --
    # >1: the windowed-BA GN loop runs over the dist_ba_shards ranks of a
    # torch.distributed process group (point/residual axis sharded, camera
    # system all-reduced). Opt-in: meant for the ENLARGED window
    # (max_frames ~15, window_cap 16, active_cap >=8192) whose residual cube
    # outgrows one device; the standard F=8 window is faster on one.
    # Requires an initialized group of exactly dist_ba_shards ranks and the
    # point cap divisible by the shard count.
    dist_ba_shards: int = 0

    # -- numerics --
    solve_dtype: str = "float32"  # reduced camera system solve precision

    @property
    def pattern(self) -> np.ndarray:
        return PATTERN

    def energy_th(self) -> float:
        """Per-point photometric energy threshold (ImmaturePoint.cpp:58-60)."""
        return (
            PATTERN_NUM
            * self.outlier_th
            * self.overall_energy_th_weight
            * self.overall_energy_th_weight
        )


_DEFAULT = Settings()


def default_settings() -> Settings:
    return _DEFAULT


def preset_0() -> Settings:
    """Reference preset 0: 2000 active / 1500 immature points, realtime-off
    (main_dso_pangolin.cpp:104-116)."""
    return Settings(desired_point_density=2000.0, desired_immature_density=1500.0)


# Pyramid intrinsics scaling (util/globalCalib.cpp:90-99):
#   fx_l = fx_{l-1} * 0.5 ; cx_l = (cx_0 + 0.5) / 2^l - 0.5
def pyramid_intrinsics(fx: float, fy: float, cx: float, cy: float, levels: int):
    """Return per-level (fx, fy, cx, cy) arrays following the reference formula."""
    fxs, fys, cxs, cys = [], [], [], []
    for lvl in range(levels):
        fxs.append(fx * (0.5**lvl))
        fys.append(fy * (0.5**lvl))
        cxs.append((cx + 0.5) / (1 << lvl) - 0.5)
        cys.append((cy + 0.5) / (1 << lvl) - 0.5)
    return np.array(fxs), np.array(fys), np.array(cxs), np.array(cys)
