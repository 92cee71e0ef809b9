"""KITTI-style stereo dataset reader.

Port of `stereo_dso_g2o_tpu/io/dataset.py` (util/DatasetReader.h,
ImageFolderReader:119-311): lists image files from `image_0` (left) /
`image_1` (right) folders, reads `times.txt` (either plain timestamps or
id/stamp/exposure triples, loadTimestamps:229-292), applies geometric +
photometric undistortion, and crops to pyramid-friendly dimensions
(multiples of 2^(levels-1); the reference instead warns and degrades the
pyramid depth, globalCalib.cpp:50-60).

Zip archives are supported like the reference's libzip path
(DatasetReader.h:129-166): pass a `.zip` containing image_0/ + image_1/
(+ optional times.txt) as `seq_dir`; members are decoded from memory.

Images are decoded on the host (PIL) and remapped and corrected on the
dataset's device (`device=None`: the GPU); `get` returns tensors there.
`prefetch` streams host numpy frames from the native loader's worker
threads instead, when its library builds.
"""

from __future__ import annotations

import glob
import io as _io
import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.models.undistort import (
    PhotometricUndistorter,
    Undistorter,
    from_calib_file,
)


def _load_gray(path) -> np.ndarray:
    """Decode an 8/16-bit PNG/JPG (path or file-like) to float32 grayscale."""
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., :3].astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    arr = arr.astype(np.float32)
    if arr.max() > 255.0:  # 16-bit input
        arr = arr * (255.0 / 65535.0)
    return arr


class StereoDataset:
    """One KITTI odometry sequence directory:

        seq/
          image_0/*.png   (left)
          image_1/*.png   (right)
          times.txt       (optional)
        calib file        (reference 5-line format) OR explicit intrinsics
    """

    def __init__(
        self,
        seq_dir: str,
        calib_file: Optional[str] = None,
        intrinsics: Optional[Tuple[float, float, float, float]] = None,
        baseline: Optional[float] = None,
        gamma_file: Optional[str] = None,
        vignette_file: Optional[str] = None,
        n_levels: int = 6,
        device=None,
    ):
        self.device = default_device(device)
        self._zip: Optional[zipfile.ZipFile] = None
        if os.path.isfile(seq_dir) and seq_dir.endswith(".zip"):
            # zip-archive mode (DatasetReader.h:129-166): image folders and
            # times.txt live inside the archive, possibly under a prefix dir
            self._zip = zipfile.ZipFile(seq_dir)
            names = self._zip.namelist()

            def members(sub):
                return sorted(
                    n for n in names
                    if f"image_{sub}/" in n
                    and n.lower().endswith((".png", ".jpg"))
                )

            self.left_files = members(0)
            self.right_files = members(1)
            times_members = [n for n in names if n.endswith("times.txt")]
            times_text = (
                self._zip.read(times_members[0]).decode()
                if times_members else None
            )
        else:
            self.left_files = sorted(
                glob.glob(os.path.join(seq_dir, "image_0", "*.png"))
                + glob.glob(os.path.join(seq_dir, "image_0", "*.jpg"))
            )
            self.right_files = sorted(
                glob.glob(os.path.join(seq_dir, "image_1", "*.png"))
                + glob.glob(os.path.join(seq_dir, "image_1", "*.jpg"))
            )
            times_path = os.path.join(seq_dir, "times.txt")
            times_text = None
            if os.path.exists(times_path):
                with open(times_path) as f:
                    times_text = f.read()
        if len(self.left_files) != len(self.right_files):
            raise ValueError(f"stereo mismatch in {seq_dir}: {len(self.left_files)} left, "
                             f"{len(self.right_files)} right images")
        if not self.left_files:
            raise ValueError(f"no images in {seq_dir}")

        self.timestamps, self.exposures = self._load_times(
            times_text, len(self.left_files)
        )

        sample = self._read(self.left_files[0])
        h_org, w_org = sample.shape

        self.undistorter: Optional[Undistorter] = None
        if calib_file is not None:
            self.undistorter = from_calib_file(calib_file, device=self.device)
            fx, fy = self.undistorter.K[0, 0], self.undistorter.K[1, 1]
            cx, cy = self.undistorter.K[0, 2], self.undistorter.K[1, 2]
            w_out, h_out = self.undistorter.w, self.undistorter.h
            baseline = self.undistorter.baseline or baseline or 0.0
        else:
            if intrinsics is None or baseline is None:
                raise ValueError("give a calib file, or intrinsics and a baseline")
            fx, fy, cx, cy = intrinsics
            w_out, h_out = w_org, h_org

        # crop to multiple of 2^(n_levels-1) for the full pyramid
        m = 1 << (n_levels - 1)
        self.crop_w = (w_out // m) * m
        self.crop_h = (h_out // m) * m
        self.calib = make_calib(
            fx, fy, cx, cy, baseline, self.crop_w, self.crop_h, n_levels,
            device=self.device,
        )
        # V is sized to the crop dims and applied post-crop (see get());
        # signature is (w, h) — keep the argument order straight for
        # non-square sequences like KITTI 1226x370.
        self.photometric = PhotometricUndistorter(
            gamma_file, vignette_file, self.crop_w, self.crop_h, device=self.device
        )

    def _read(self, name: str) -> np.ndarray:
        if self._zip is not None:
            return _load_gray(_io.BytesIO(self._zip.read(name)))
        return _load_gray(name)

    @staticmethod
    def _load_times(text: Optional[str], n: int):
        if text is None:
            return np.arange(n) * 0.1, np.ones(n, np.float32)
        rows = []
        for line in text.splitlines():
            vals = line.split()
            if not vals:
                continue
            rows.append([float(v) for v in vals])
        if not rows:
            return np.arange(n) * 0.1, np.ones(n, np.float32)
        rows = rows[:n]
        ts = np.array([r[1] if len(r) >= 2 else r[0] for r in rows])
        exps = np.array(
            [r[2] if len(r) >= 3 else 1.0 for r in rows], dtype=np.float32
        )
        if len(ts) < n:
            ts = np.concatenate([ts, ts[-1] + 0.1 * np.arange(1, n - len(ts) + 1)])
            exps = np.concatenate([exps, np.ones(n - len(exps), np.float32)])
        return ts, exps

    def __len__(self):
        return len(self.left_files)

    def rectify(self, img) -> torch.Tensor:
        """One decoded (H_org, W_org) image -> undistorted, cropped and
        photometrically corrected float32 (crop_h, crop_w) on the device."""
        img = torch.as_tensor(img, device=self.device).to(torch.float32)
        if self.undistorter is not None:
            img = self.undistorter.undistort(img)
        return self.photometric(img[: self.crop_h, : self.crop_w])

    def get(self, i: int):
        """Returns (left, right, timestamp, exposure): float32 (crop_h,
        crop_w) tensors on the device, undistorted, photometrically
        corrected, cropped."""
        left = self.rectify(self._read(self.left_files[i]))
        right = self.rectify(self._read(self.right_files[i]))
        return left, right, float(self.timestamps[i]), float(self.exposures[i])

    # -- native prefetch ----------------------------------------------------
    def frame_source(self) -> str:
        """What `prefetch` streams from: "native" (the C++ loader's worker
        threads) or "get" (zip sources, or no native library)."""
        from stereo_dso_g2o_tpu_torch.runtime import native_loader as NL

        return "native" if self._zip is None and NL.available() else "get"

    def prefetch(self, n_workers: int = 3, capacity: int = 8):
        """Iterate (left, right, timestamp, exposure) with decode + remap +
        photometric correction running on native C++ worker threads
        (runtime/native_loader; reference analog: DatasetReader::getImage on
        the playback thread overlapped via IndexThreadReduce-style workers).
        Frames are host numpy arrays then; with `frame_source() == "get"`
        this is `get(i)` for every frame (device tensors)."""
        from stereo_dso_g2o_tpu_torch.runtime import native_loader as NL

        if self.frame_source() != "native":
            for i in range(len(self)):
                yield self.get(i)
            return

        remap_x = remap_y = None
        if self.undistorter is not None and not self.undistorter.passthrough:
            def host(t):
                return t[: self.crop_h, : self.crop_w].cpu().numpy()

            ok = host(self.undistorter.remap_ok)
            remap_x = np.where(ok, host(self.undistorter.remap_x), -1.0).astype(np.float32)
            remap_y = np.where(ok, host(self.undistorter.remap_y), -1.0).astype(np.float32)
        gamma = (
            self.photometric.G.cpu().numpy()
            if self.photometric.G is not None else None
        )
        vig_inv = (
            1.0 / self.photometric.V.cpu().numpy()
            if self.photometric.V is not None else None
        )
        loader = NL.NativeStereoLoader(
            self.left_files, self.right_files, self.crop_w, self.crop_h,
            remap_x=remap_x, remap_y=remap_y, gamma=gamma,
            vignette_inv=vig_inv, n_workers=n_workers, capacity=capacity,
        )
        try:
            for idx, left, right in loader:
                yield (
                    left, right,
                    float(self.timestamps[idx]), float(self.exposures[idx]),
                )
        finally:
            loader.close()


def write_sequence(seq_dir, lefts, rights, K, baseline: float, exposures=None,
                   out_mode: str = "crop"):
    """Write a rendered stereo sequence in the layout StereoDataset reads:
    8-bit `image_0/NNNNNN.png` / `image_1/NNNNNN.png`, `times.txt` as
    `id stamp exposure` triples (10 Hz), and a 5-line `camera.txt` (Pinhole
    K, input size, `out_mode`, output size, baseline). lefts/rights: uint8
    (H, W) arrays or tensors. Returns (seq_dir, calib path)."""
    from PIL import Image

    seq_dir = str(seq_dir)
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    exposures = np.ones(len(lefts)) if exposures is None else np.asarray(exposures)
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for i, (left, right) in enumerate(zip(lefts, rights)):
            for sub, img in (("image_0", left), ("image_1", right)):
                img = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
                # zlib level 1: 5x faster to write than PIL's default 6
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(seq_dir, sub, f"{i:06d}.png"), compress_level=1)
            f.write(f"{i} {0.1 * i:.6f} {float(exposures[i]):.9f}\n")
    h, w = lefts[0].shape[:2]
    calib = os.path.join(seq_dir, "camera.txt")
    with open(calib, "w") as f:
        f.write(f"Pinhole {K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} 0\n{w} {h}\n{out_mode}\n"
                f"{w} {h}\n{baseline}\n")
    return seq_dir, calib
