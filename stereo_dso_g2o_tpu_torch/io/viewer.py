"""Offline 3-D run visualization — the headless stand-in for the reference's
live Pangolin viewer (IOWrapper/Pangolin/PangolinDSOViewer.cpp:55-137,
KeyFrameDisplay.cpp). Port of `stereo_dso_g2o_tpu/io/viewer.py`, host numpy:
consumes either a live FullSystem / GraphSystem (its `point_cloud()`) or the
JSONL feed written by JsonlOutputWrapper and renders the trajectory +
accumulated keyframe point clouds to a PNG (matplotlib Agg, no display
needed).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _fig():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_run(
    out_path: str,
    trajectory: Sequence[np.ndarray],  # camToWorld poses
    cloud_xyz: Optional[np.ndarray] = None,  # (N, 3) world points
    cloud_idepth: Optional[np.ndarray] = None,  # (N,) color source
    gt_trajectory: Optional[Sequence[np.ndarray]] = None,
    title: str = "stereo_dso_g2o_tpu_torch run",
):
    """Write a 2-panel overview PNG: top-down (x-z) map with point cloud +
    camera path, and a 3-D view. Mirrors what the Pangolin window shows."""
    plt = _fig()
    traj = np.array([T[:3, 3] for T in trajectory]) if len(trajectory) else np.zeros((0, 3))

    fig = plt.figure(figsize=(14, 6))
    ax = fig.add_subplot(1, 2, 1)
    if cloud_xyz is not None and len(cloud_xyz):
        c = cloud_idepth if cloud_idepth is not None else cloud_xyz[:, 2]
        ax.scatter(
            cloud_xyz[:, 0], cloud_xyz[:, 2], s=0.5, c=c, cmap="turbo",
            alpha=0.6, linewidths=0,
        )
    if len(traj):
        ax.plot(traj[:, 0], traj[:, 2], "k-", lw=1.5, label="estimate")
        ax.plot(traj[-1:, 0], traj[-1:, 2], "r^", ms=8)
    if gt_trajectory is not None:
        g = np.array([T[:3, 3] for T in gt_trajectory])
        ax.plot(g[:, 0], g[:, 2], "g--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"{title} — top-down")
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)

    ax3 = fig.add_subplot(1, 2, 2, projection="3d")
    if cloud_xyz is not None and len(cloud_xyz):
        c = cloud_idepth if cloud_idepth is not None else cloud_xyz[:, 2]
        ax3.scatter(
            cloud_xyz[:, 0], cloud_xyz[:, 2], -cloud_xyz[:, 1],
            s=0.5, c=c, cmap="turbo", alpha=0.5, linewidths=0,
        )
    if len(traj):
        ax3.plot(traj[:, 0], traj[:, 2], -traj[:, 1], "k-", lw=2)
    ax3.set_xlabel("x")
    ax3.set_ylabel("z")
    ax3.set_zlabel("-y (up)")
    ax3.set_title("3-D view")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


class CloudAccumulator:
    """Accumulates per-keyframe point clouds across a run, keeping the latest
    BA-updated snapshot per host keyframe (the viewer's KeyFrameDisplay
    refresh semantics)."""

    def __init__(self):
        self.per_kf: Dict[int, np.ndarray] = {}
        self.per_kf_idepth: Dict[int, np.ndarray] = {}

    def update_from(self, fs):
        pc = fs.point_cloud()
        for kid in np.unique(pc["host_kf_id"]):
            m = pc["host_kf_id"] == kid
            self.per_kf[int(kid)] = pc["xyz"][m]
            self.per_kf_idepth[int(kid)] = pc["idepth"][m]

    def cloud(self):
        if not self.per_kf:
            return np.zeros((0, 3)), np.zeros(0)
        xyz = np.concatenate(list(self.per_kf.values()))
        idp = np.concatenate(list(self.per_kf_idepth.values()))
        return xyz, idp


def render_feed(jsonl_path: str, out_path: str):
    """Render the JsonlOutputWrapper feed to a PNG (poses + point clouds)."""
    poses: List[np.ndarray] = []
    per_kf: Dict[int, np.ndarray] = {}
    per_kf_id: Dict[int, np.ndarray] = {}
    with open(jsonl_path) as f:
        lines = f.readlines()
    for line in lines:
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if d.get("type") == "pose":
            poses.append(np.asarray(d["T_cw"]).reshape(4, 4))
        elif d.get("type") == "keyframes" and "points" in d:
            for kf in d["points"]:
                kid = int(kf["kf_id"])
                xyz = np.asarray(kf["xyz"], np.float64).reshape(-1, 3)
                per_kf[kid] = xyz
                per_kf_id[kid] = np.asarray(kf.get("idepth", [1.0] * len(xyz)))
    cloud = (
        np.concatenate(list(per_kf.values())) if per_kf else np.zeros((0, 3))
    )
    idp = (
        np.concatenate(list(per_kf_id.values())) if per_kf_id else np.zeros(0)
    )
    return render_run(out_path, poses, cloud, idp, title=jsonl_path)
