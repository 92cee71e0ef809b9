"""Output publishing interface.

Port of `stereo_dso_g2o_tpu/io/output_wrapper.py`: IOWrapper/Output3DWrapper.h
:105-177 (the virtual publish API the viewer and loggers implement) and
SampleOutputWrapper (stdout publisher). The Pangolin GUI has no headless
equivalent here; its data feed — camera poses, keyframe point clouds,
connectivity — is published through the same interface so an external
viewer can consume JSON-lines output. Poses and clouds may be numpy arrays
or tensors (on any device); the lines written are the JAX wrapper's.
"""

from __future__ import annotations

import json
from typing import IO

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class Output3DWrapper:
    """Publish interface (Output3DWrapper.h): override what you need."""

    def publish_cam_pose(self, frame_id: int, T_cw, timestamp: float):
        pass

    def publish_keyframes(self, kf_poses, points):
        """kf_poses: list of (kf_id, T_cw); points: dict of arrays
        (u, v, idepth, host_slot, valid)."""
        pass

    def publish_graph(self, connectivity):
        pass

    def push_depth_image(self, idepth_map):
        pass

    def join(self):
        pass


class SampleOutputWrapper(Output3DWrapper):
    """Prints a line per publication (IOWrapper/SampleOutputWrapper.h)."""

    def publish_cam_pose(self, frame_id, T_cw, timestamp):
        t = _host(T_cw)[:3, 3]
        print(
            f"frame {frame_id} t={timestamp:.3f} xyz=({t[0]:.3f}, {t[1]:.3f}, {t[2]:.3f})"
        )


class JsonlOutputWrapper(Output3DWrapper):
    """Streams poses/keyframes as JSON lines (headless viewer feed)."""

    def __init__(self, fh: IO):
        self.fh = fh

    def publish_cam_pose(self, frame_id, T_cw, timestamp):
        self.fh.write(
            json.dumps(
                {
                    "type": "pose",
                    "id": int(frame_id),
                    "t": float(timestamp),
                    "T_cw": _host(T_cw).reshape(-1).tolist(),
                }
            )
            + "\n"
        )

    def publish_keyframes(self, kf_poses, points):
        """points: FullSystem.point_cloud() dict ('xyz', 'idepth',
        'host_kf_id') or None. World-space clouds are grouped per host KF so
        an offline viewer can apply the KeyFrameDisplay refresh semantics."""
        rec = {
            "type": "keyframes",
            "poses": [
                {"id": int(i), "T_cw": _host(T).reshape(-1).tolist()}
                for i, T in kf_poses
            ],
        }
        if points and len(_host(points.get("xyz", []))):
            xyz = _host(points["xyz"], np.float32)
            idp = _host(points["idepth"], np.float32)
            hid = _host(points["host_kf_id"], int)
            rec["points"] = [
                {
                    "kf_id": int(k),
                    "xyz": np.round(xyz[hid == k], 4).reshape(-1).tolist(),
                    "idepth": np.round(idp[hid == k], 5).tolist(),
                }
                for k in np.unique(hid)
            ]
            rec["n_points"] = int(len(xyz))
        else:
            rec["n_points"] = 0
        self.fh.write(json.dumps(rec) + "\n")
