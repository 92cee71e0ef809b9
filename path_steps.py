#!/usr/bin/env python3
"""Time the single-sequence graph path and the 4-sequence batched path of the
working tree against those of another checkout of this repository, on one
NVIDIA GPU.

    git archive <commit> | tar -x -C _checkout/parent
    python3 path_steps.py _checkout/parent [report.json]

Each measurement runs in a process of its own, importing the port from one
root, in the order other, this, this, other: it renders chip_smoke.py's
corridor at 1216x352 (sequence 0 and three more, scene seeds 100 + s) on the
card, bootstraps 12 frames through FullSystem, then times GraphSystem over
frames 12-39 and BatchedRunner ("deferred", 4 sequences) over frames 12-31,
each frame synchronized (host clock; frames 14 on). It prints one JSON line
per run and writes them all to the report (default: path_steps.json beside
the other checkout).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, BASE, N, STEP, BOOT, BATCH_FRAMES = 1216, 352, 0.54, 40, 0.30, 12, 32


def run(root: str) -> dict:
    """Both paths of the port under `root`, in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from stereo_dso_g2o_tpu_torch.config import Settings
    from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib
    from stereo_dso_g2o_tpu_torch.parallel.batched import BatchedRunner

    dev = torch.device("cuda", 0)
    settings = Settings(  # chip_smoke.settings_kitti: bench.py's KITTI-resolution settings
        desired_point_density=2000.0, desired_immature_density=1500.0,
        immature_cap=2048, active_cap=2048, affine_opt_mode_a=0.0, affine_opt_mode_b=0.0,
    )
    K = synthetic.default_K(W, H, fov_deg=80.0)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W, H, n_levels=6, device=dev)
    poses = synthetic.forward_trajectory(N, step=STEP, yaw_amp=0.10, yaw_period=80.0, seed=0)
    seqs = []
    for s in range(4):
        scene = synthetic.corridor_scene(seed=100 + s, length=STEP * N + 40.0, box_spacing=9.0,
                                         lateral=14.0)
        expos = 1.0 + 0.12 * np.sin(0.25 * np.arange(N) + s)
        seqs.append(synthetic.render_stereo_sequence_fast(scene, K, W, H, BASE, poses, expos,
                                                          device=dev))

    def boot(s):
        fs = FullSystem(calib, settings, device=dev)
        for i in range(BOOT):
            fs.add_frame(seqs[s][0][i], seqs[s][1][i], i, timestamp=0.1 * i)
        return tgs.GraphSystem.from_full_system(fs)

    def timed(step, frames):
        ms = []
        for i in frames:
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            ms.append(1000.0 * (time.perf_counter() - t0))
        return ms[2:]

    gs = boot(0)
    graph = timed(lambda i: gs.add_frame(seqs[0][0][i], seqs[0][1][i], i, timestamp=0.1 * i),
                  range(BOOT, N))
    runner = BatchedRunner([boot(s) for s in range(4)], kf_mode="deferred")
    lefts = torch.stack([q[0] for q in seqs])
    rights = torch.stack([q[1] for q in seqs])
    batched = timed(lambda i: runner.add_frames((lefts[:, i], rights[:, i]), i, timestamp=0.1 * i),
                    range(BOOT, BATCH_FRAMES))
    runner.flush()
    return {"root": root, "graph_median_ms": float(np.median(graph)),
            "graph_mean_ms": float(np.mean(graph)),
            "batched_median_ms": float(np.median(batched)),
            "batched_mean_ms": float(np.mean(batched)),
            "batched_over_4_graph": float(np.mean(batched) / (4 * np.mean(graph))),
            "kfs": [len(g.kf_shells) for g in runner.systems]}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(run(sys.argv[2])))
        return 0
    other = str(Path(sys.argv[1]).resolve())
    report = Path(sys.argv[2]) if len(sys.argv) > 2 else Path(other).parent / "path_steps.json"
    rows = []
    for root in (other, str(ROOT), str(ROOT), other):
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                             text=True, check=True, cwd=ROOT)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    report.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
