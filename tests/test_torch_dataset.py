"""The port's undistortion, dataset reader and native loader against the JAX
package's: remap tables and output K equal bit for bit (both are float64
numpy cast to float32), undistorted and photometrically corrected images
within 1e-4 (the same float32 bilinear formula, other operation order),
native decodes and native streams equal bit for bit (the same C++
post-processing on the same tables), dataset fields equal."""

import os
import struct
import zipfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_dso_g2o_tpu.io import dataset as jds
from stereo_dso_g2o_tpu.models import undistort as jU
from stereo_dso_g2o_tpu.runtime import native_loader as jNL
from stereo_dso_g2o_tpu_torch.io import dataset as tds
from stereo_dso_g2o_tpu_torch.io import synthetic as tsyn
from stereo_dso_g2o_tpu_torch.models import undistort as tU
from stereo_dso_g2o_tpu_torch.runtime import native_loader as tNL

IMG_TOL = 1e-4
W0, H0 = 96, 64


def _save_png(path, arr):
    Image.fromarray(arr).save(path)


def _need_native():
    if not tNL.available():
        pytest.skip(f"the port's native loader did not build (g++ or zlib missing): {tNL.build_error()}")
    if not jNL.available():
        pytest.skip(f"the JAX package's native loader did not build (g++, libpng or libjpeg "
                    f"missing): {jNL.build_error()}")


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """tests/test_dataset.py's layout (4 frames of default_scene(0) at
    128x64, id/stamp/exposure times) with a `crop` calib, so that the remap
    is not a passthrough."""
    scene = tsyn.default_scene(0)
    w, h, b = 128, 64, 0.1
    K = tsyn.default_K(w, h)
    lefts, rights = [], []
    for i in range(4):
        T = np.eye(4)
        T[:3, 3] = [0.02 * i, 0.0, 0.03 * i]
        l, r, _ = tsyn.render_stereo_pair(scene, K, w, h, b, T)
        lefts.append(l.astype(np.uint8))
        rights.append(r.astype(np.uint8))
    return tds.write_sequence(tmp_path_factory.mktemp("seq"), lefts, rights, K, b,
                              0.9 + 0.01 * np.arange(4), out_mode="crop")


# ---------------------------------------------------------------------------
# undistortion
# ---------------------------------------------------------------------------

MODEL_PARS = {
    "FOV": [80.0, 82.0, 47.2, 31.9, 0.9],
    "RadTan": [80.0, 82.0, 47.2, 31.9, -0.21, 0.05, 0.001, -0.0015],
    "Equidistant": [80.0, 82.0, 47.2, 31.9, 0.08, -0.03, 0.01, -0.002],
    "KannalaBrandt": [80.0, 82.0, 47.2, 31.9, 0.02, -0.01, 0.004, -0.001],
    "Pinhole": [80.0, 82.0, 47.2, 31.9],
}
MODES = {"crop": ("crop", W0, H0), "none": ("none", W0, H0),
         "explicit": ((0.55, 0.7, 0.5, 0.5), 80, 48)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model", sorted(MODEL_PARS))
def test_undistorter_matches_jax(model, mode):
    out_mode, w1, h1 = MODES[mode]
    ju = jU.Undistorter(model, MODEL_PARS[model], W0, H0, out_mode, w1, h1, baseline=0.3)
    tu = tU.Undistorter(model, MODEL_PARS[model], W0, H0, out_mode, w1, h1, baseline=0.3,
                        device="cpu")
    np.testing.assert_array_equal(tu.K, ju.K)
    assert tu.passthrough == ju.passthrough == (model == "Pinhole" and mode == "none")
    for name in ("remap_x", "remap_y", "remap_ok"):
        got, want = getattr(tu, name).numpy(), np.asarray(getattr(ju, name))
        assert got.dtype == want.dtype and got.shape == (h1, w1)
        np.testing.assert_array_equal(got, want, err_msg=name)
    if mode != "none":
        assert 0.3 < float(tu.remap_ok.float().mean()) <= 1.0
    img = np.random.default_rng(7).uniform(0, 255, (H0, W0)).astype(np.float32)
    got = tu.undistort(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(ju.undistort(img)), atol=IMG_TOL, rtol=0)


CALIB_TEXTS = {
    "relative": "0.5 0.8 0.5 0.5 0\n640 480\nnone\n640 480\n0.3\n",
    "raw_fov": "0.6 0.9 0.5 0.5 0.85\n640 480\ncrop\n320 240\n0.12\n",
    "raw_radtan": "300 310 319.5 239.5 -0.2 0.04 0.001 0.002\n640 480\nfull\n640 480\n",
    "explicit_out": "Pinhole 0.5 0.8 0.5 0.5 0\n640 480\n0.45 0.7 0.5 0.5 0\n600 440\n0.54\n",
} | {m: f"{m} {' '.join(str(p) for p in pars)}\n{W0} {H0}\ncrop\n{W0} {H0}\n0.2\n"
     for m, pars in MODEL_PARS.items()}


@pytest.mark.parametrize("name", sorted(CALIB_TEXTS))
def test_parse_calib_file_matches_jax(name, tmp_path):
    p = tmp_path / "calib.txt"
    p.write_text(CALIB_TEXTS[name])
    got, want = tU.parse_calib_file(str(p)), jU.parse_calib_file(str(p))
    assert got == want
    if name == "relative":  # tests/test_dataset.py's case
        assert got[0] == "Pinhole" and got[1][0] == pytest.approx(320.0)
    tu = tU.from_calib_file(str(p), device="cpu")
    ju = jU.from_calib_file(str(p))
    np.testing.assert_array_equal(tu.K, ju.K)
    np.testing.assert_array_equal(tu.remap_x.numpy(), np.asarray(ju.remap_x))
    assert tu.baseline == ju.baseline


def test_photometric_matches_jax(tmp_path):
    gamma = tmp_path / "pcalib.txt"
    np.savetxt(gamma, (np.linspace(0, 255, 256) ** 1.1)[None], fmt="%.6f")
    vig = tmp_path / "vignette.png"
    vmap = (55000 + 10000 * np.cos(np.linspace(0, 2, 40))[:, None]
            * np.cos(np.linspace(-1, 1, 56))[None, :]).astype(np.uint16)
    _save_png(str(vig), vmap)
    jp = jU.PhotometricUndistorter(str(gamma), str(vig), 48, 32)  # resampled V
    tp = tU.PhotometricUndistorter(str(gamma), str(vig), 48, 32, device="cpu")
    np.testing.assert_array_equal(tp.G.numpy(), np.asarray(jp.G))
    np.testing.assert_array_equal(tp.V.numpy(), np.asarray(jp.V))
    np.testing.assert_array_equal(tp.gamma_grad_lut().numpy(), np.asarray(jp.gamma_grad_lut()))
    img = np.random.default_rng(3).uniform(-5, 260, (32, 48)).astype(np.float32)
    np.testing.assert_allclose(tp(torch.from_numpy(img)).numpy(), np.asarray(jp(img)),
                               atol=IMG_TOL, rtol=0)
    none = tU.PhotometricUndistorter(None, None, 48, 32, device="cpu")
    assert none.G is None and none.V is None and none.gamma_grad_lut() is None
    np.testing.assert_array_equal(none(img).numpy(), img)


def test_entry_points_raise_without_cuda(kitti_dir, monkeypatch):
    """device=None means the GPU: with none there, they raise rather than
    take the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, calib = kitti_dir
    for make in (lambda: tU.Undistorter("Pinhole", MODEL_PARS["Pinhole"], W0, H0, "none", W0, H0),
                 lambda: tU.PhotometricUndistorter(None, None, 8, 8),
                 lambda: tds.StereoDataset(base, calib_file=calib, n_levels=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# the dataset reader
# ---------------------------------------------------------------------------


def _zip_of(base, tmp_path):
    zpath = str(tmp_path / "seq.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        for root, _, files in os.walk(base):
            for fn in files:
                full = os.path.join(root, fn)
                zf.write(full, os.path.join("seq", os.path.relpath(full, base)))
    return zpath


@pytest.mark.parametrize("source", ["folder", "zip"])
def test_dataset_matches_jax(kitti_dir, source, tmp_path):
    base, calib = kitti_dir
    path = base if source == "folder" else _zip_of(base, tmp_path)
    jd = jds.StereoDataset(path, calib_file=calib, n_levels=4)
    td = tds.StereoDataset(path, calib_file=calib, n_levels=4, device="cpu")
    assert len(td) == len(jd) == 4
    assert [os.path.basename(f) for f in td.left_files] == [os.path.basename(f) for f in jd.left_files]
    np.testing.assert_array_equal(td.timestamps, jd.timestamps)
    np.testing.assert_array_equal(td.exposures, jd.exposures)
    assert (td.crop_w, td.crop_h) == (jd.crop_w, jd.crop_h) == (128, 64)
    np.testing.assert_array_equal(td.calib.c.numpy(), np.asarray(jd.calib.c))
    assert float(td.calib.baseline) == float(jd.calib.baseline) == pytest.approx(0.1)
    assert td.calib.w == jd.calib.w and td.calib.h == jd.calib.h
    assert not td.undistorter.passthrough
    assert td.frame_source() == ("native" if source == "folder" and tNL.available() else "get")
    for i in range(len(td)):
        tl, tr, tts, texp = td.get(i)
        jl, jr, jts, jexp = jd.get(i)
        assert tl.dtype == torch.float32 and tl.device.type == "cpu" and tl.shape == (64, 128)
        np.testing.assert_allclose(tl.numpy(), jl, atol=IMG_TOL, rtol=0)
        np.testing.assert_allclose(tr.numpy(), jr, atol=IMG_TOL, rtol=0)
        assert (tts, texp) == (jts, jexp)


TIMES = {
    "none": None,
    "plain": "0.0\n0.1\n0.25\n",
    "id_stamp": "0 1.5\n1 1.6\n\n2 1.7\n3 1.8\n4 1.9\n5 2.0\n",
    "id_stamp_exposure": "0 0.0 1.1\n1 0.1 0.9\n2 0.2 1.0\n3 0.3 1.2\n4 0.4 1.0\n",
    "empty": "\n\n",
}


@pytest.mark.parametrize("form", sorted(TIMES))
def test_load_times_matches_jax(form):
    got = tds.StereoDataset._load_times(TIMES[form], 5)
    want = jds.StereoDataset._load_times(TIMES[form], 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (5,)
        np.testing.assert_array_equal(a, b)


def test_dataset_intrinsics_mode(kitti_dir):
    """No calib file: explicit intrinsics + baseline, no remap, crop only."""
    base, _ = kitti_dir
    kw = dict(intrinsics=(90.0, 91.0, 63.5, 31.5), baseline=0.1, n_levels=5)
    jd = jds.StereoDataset(base, **kw)
    td = tds.StereoDataset(base, device="cpu", **kw)
    assert td.undistorter is None and (td.crop_w, td.crop_h) == (jd.crop_w, jd.crop_h) == (128, 64)
    np.testing.assert_array_equal(td.calib.c.numpy(), np.asarray(jd.calib.c))
    np.testing.assert_array_equal(td.get(2)[0].numpy(), jd.get(2)[0])
    with pytest.raises(ValueError):
        tds.StereoDataset(base, device="cpu")


# ---------------------------------------------------------------------------
# the native loader
# ---------------------------------------------------------------------------


def _gray_images():
    rng = np.random.default_rng(0)
    return {
        "gray8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
        "gray16": rng.integers(0, 65536, (21, 33), dtype=np.uint16),
        "rgb8": rng.integers(0, 256, (19, 27, 3), dtype=np.uint8),
        "smooth8": tsyn.smooth_texture(rng, 64).astype(np.uint8),  # PIL picks other row filters
    }


@pytest.mark.parametrize("kind", sorted(_gray_images()))
def test_native_decode_matches_jax_and_pil(kind, tmp_path):
    _need_native()
    img = _gray_images()[kind]
    p = str(tmp_path / f"{kind}.png")
    _save_png(p, img)
    got = tNL.decode_gray(p)
    assert got.dtype == np.float32 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, jNL.decode_gray(p))
    pil = jds._load_gray(p)  # the Python reader's conversion (numpy's float32 arithmetic)
    if kind == "rgb8":
        np.testing.assert_allclose(got, pil, atol=1e-3, rtol=0)
    elif kind == "gray16":
        np.testing.assert_allclose(got, pil, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, pil)


def test_native_decode_jpeg_matches_jax(tmp_path):
    _need_native()
    if tNL.jpeg_error() is not None:
        pytest.skip(f"the port's native loader was built without libjpeg: {tNL.jpeg_error()}")
    img = tsyn.smooth_texture(np.random.default_rng(1), 64).astype(np.uint8)
    p = str(tmp_path / "g.jpg")
    Image.fromarray(img).save(p, quality=90)
    np.testing.assert_array_equal(tNL.decode_gray(p), jNL.decode_gray(p))


def _png_by_hand(arr, color_type, depth):
    """A PNG whose rows cycle through all five filter types (none, sub, up,
    average, Paeth), filtered as the PNG specification (section 9) says."""
    h, w = arr.shape[:2]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    bpp = raw.shape[1] // w
    rows, prev = [], np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        cur = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        f = y % 5
        pred = [0, a, prev, (a + prev) // 2, paeth][f]
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (4, 8), (6, 8)])
def test_native_png_row_filters(color_type, depth, tmp_path):
    """The port decodes PNG with zlib alone; every row filter, channel
    layout and depth it accepts, against the conversion io/dataset.py makes."""
    if not tNL.available():
        pytest.skip(f"the port's native loader did not build: {tNL.build_error()}")
    rng = np.random.default_rng(color_type * 100 + depth)
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    arr = rng.integers(0, 256 if depth == 8 else 65536, (23, 17, ch)).astype(np.uint16)
    p = tmp_path / "f.png"
    p.write_bytes(_png_by_hand(arr, color_type, depth))
    a = arr.astype(np.float32)
    want = a[..., 0] if ch < 3 else 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    if depth == 16:
        want = want * np.float32(255.0 / 65535.0)
    got = tNL.decode_gray(str(p))
    if ch < 3:
        np.testing.assert_array_equal(got, want)
    else:  # the C++ sum in float32, against numpy's
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # a file the decoder refuses: interlaced
    data = bytearray(p.read_bytes())
    data[28] = 1  # the IHDR interlace byte
    p.write_bytes(bytes(data))
    with pytest.raises(IOError):
        tNL.decode_gray(str(p))


def test_prefetch_order_and_values(tmp_path):
    _need_native()
    rng = np.random.default_rng(3)
    lp, rp, refs = [], [], []
    for i in range(10):
        l8 = rng.integers(0, 256, (16, 24), dtype=np.uint8)
        r8 = rng.integers(0, 256, (16, 24), dtype=np.uint8)
        lp.append(str(tmp_path / f"l{i}.png"))
        rp.append(str(tmp_path / f"r{i}.png"))
        _save_png(lp[-1], l8)
        _save_png(rp[-1], r8)
        refs.append((l8, r8))
    loader = tNL.NativeStereoLoader(lp, rp, 24, 16, n_workers=3, capacity=3)
    seen = []
    for idx, left, right in loader:
        seen.append(idx)
        np.testing.assert_array_equal(left, refs[idx][0].astype(np.float32))
        np.testing.assert_array_equal(right, refs[idx][1].astype(np.float32))
    assert seen == list(range(10))
    loader.close()


def test_prefetch_matches_get_and_jax(tmp_path):
    """FOV remap + gamma + vignette: the port's native stream against its
    own `get` (the C++ bilinear and the torch one differ in operation order:
    tests/test_native_loader.py's 2e-2) and against the JAX package's native
    stream bit for bit (same tables, same C++ arithmetic)."""
    _need_native()
    base = tmp_path / "seq"
    os.makedirs(base / "image_0")
    os.makedirs(base / "image_1")
    scene = tsyn.default_scene(5)
    K = tsyn.default_K(W0, H0)
    for i in range(3):
        T = np.eye(4)
        T[:3, 3] = [0.02 * i, 0.0, 0.01 * i]
        l, r, _ = tsyn.render_stereo_pair(scene, K, W0, H0, 0.1, T)
        _save_png(str(base / "image_0" / f"{i:06d}.png"), l.astype(np.uint8))
        _save_png(str(base / "image_1" / f"{i:06d}.png"), r.astype(np.uint8))
    calib = base / "cam.txt"
    calib.write_text(f"FOV {K[0,0]/W0} {K[1,1]/H0} {K[0,2]/W0} {K[1,2]/H0} 0.2\n"
                     f"{W0} {H0}\ncrop\n{W0} {H0}\n0.1\n")
    gamma = tmp_path / "pcalib.txt"
    np.savetxt(gamma, (np.linspace(0, 255, 256) ** 1.1)[None], fmt="%.6f")
    vig = tmp_path / "vignette.png"
    _save_png(str(vig), (55000 + 10000 * np.cos(np.linspace(0, 2, H0))[:, None]
                         * np.ones((1, W0))).astype(np.uint16))
    kw = dict(calib_file=str(calib), gamma_file=str(gamma), vignette_file=str(vig), n_levels=4)
    td = tds.StereoDataset(str(base), device="cpu", **kw)
    jd = jds.StereoDataset(str(base), **kw)
    ref = [td.get(i) for i in range(3)]
    out = list(td.prefetch(n_workers=2, capacity=2))
    jout = list(jd.prefetch(n_workers=2, capacity=2))
    assert len(out) == len(jout) == 3
    for (l_n, r_n, ts_n, e_n), (l_p, r_p, ts_p, e_p), (l_j, r_j, ts_j, e_j) in zip(out, ref, jout):
        assert isinstance(l_n, np.ndarray) and l_n.dtype == np.float32
        assert ts_n == ts_p == ts_j and e_n == e_p == e_j
        np.testing.assert_allclose(l_n, l_p.numpy(), atol=2e-2)
        np.testing.assert_allclose(r_n, r_p.numpy(), atol=2e-2)
        np.testing.assert_array_equal(l_n, l_j)
        np.testing.assert_array_equal(r_n, r_j)


def test_zip_prefetch_falls_back_to_get(kitti_dir, tmp_path):
    base, calib = kitti_dir
    td = tds.StereoDataset(_zip_of(base, tmp_path), calib_file=calib, n_levels=4, device="cpu")
    assert td.frame_source() == "get"
    frames = list(td.prefetch())
    assert len(frames) == 4
    for i, (l, r, ts, exp) in enumerate(frames):
        want = td.get(i)
        assert torch.equal(l, want[0]) and torch.equal(r, want[1]) and ts == want[2]
