"""The port's `parallel/multiseq.py` on the CPU.

`MultiSequenceRunner` with two sequences (test_full_system.py's, seeds 4
and 2) on `[cpu, cpu]` equals two separate port FullSystems bit for bit over
8 frames. `sharded_stereo_match` over 2 `gloo` ranks, two 256x128 stereo
pairs a rank, equals `stereo_match_points` mapped over all four pairs in one
process bit for bit, and its `total_good` is the sum over the ranks, the same
on both."""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_dist_workers import run_ranks, stereo_match_sharded
from _torch_parity import n
from test_full_system import BASE, H_, SET, W_, _sequence

from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.config import default_settings
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.frontend.stereo_match import stereo_match_points
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.parallel import multiseq

N_FRAMES = 8
TSET = bridge.settings_from_fields(dataclasses.asdict(SET))


def test_runner_equals_separate_full_systems():
    seqs = [_sequence(N_FRAMES, seed=s) for s in (4, 2)]
    K = seqs[0][0]
    frames = [s[2] for s in seqs]

    def calib():
        return make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=5,
                          device="cpu")

    runner = multiseq.MultiSequenceRunner([calib(), calib()], TSET, devices=["cpu", "cpu"])
    assert runner.devices == [torch.device("cpu")] * 2
    for i in range(N_FRAMES):
        # the second sequence sits the last frame out
        pairs = [frames[0][i], None if i == N_FRAMES - 1 else frames[1][i]]
        runner.add_frames(pairs, i, timestamp=0.1 * i)
    trajs = runner.trajectories()
    assert [len(t) for t in trajs] == [N_FRAMES, N_FRAMES - 1]
    for k, fr in enumerate(frames):
        fs = FullSystem(calib(), TSET, device="cpu")
        for i in range(len(trajs[k])):
            fs.add_frame(fr[i][0], fr[i][1], i, timestamp=0.1 * i)
        assert not fs.is_lost and not runner.systems[k].is_lost and len(fs.kf_shells) >= 2
        np.testing.assert_array_equal(np.stack(trajs[k]), np.stack(fs.trajectory()))
        for f in dataclasses.fields(fs.win):
            a, b = getattr(runner.systems[k].win, f.name), getattr(fs.win, f.name)
            assert bool(((a == b) | ((a != a) & (b != b))).all()), f"seq {k} win.{f.name}"
    # the two sequences are different runs
    assert not np.array_equal(trajs[0][-2], trajs[1][-1])


def test_default_devices_are_the_cuda_devices():
    if torch.cuda.is_available():
        assert multiseq.make_mesh(1) == [torch.device("cuda", 0)]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            multiseq.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            multiseq.MultiSequenceRunner([], TSET)


def test_sharded_stereo_match_two_ranks(tmp_path):
    S, N, base = 4, 384, 0.15
    K = synthetic.default_K(W_, H_)
    rng = np.random.default_rng(3)
    dI_l, dI_r = [], []
    for s in range(S):
        left, right, _ = synthetic.render_stereo_pair(synthetic.default_scene(11 + s), K, W_, H_, base)
        dI_l.append(n(build_pyramid(torch.as_tensor(np.asarray(left, np.float32)), 1)[0][0]))
        dI_r.append(n(build_pyramid(torch.as_tensor(np.asarray(right, np.float32)), 1)[0][0]))
    data = dict(
        us=rng.integers(8, W_ - 8, (S, N)).astype(np.float32),
        vs=rng.integers(8, H_ - 8, (S, N)).astype(np.float32),
        valid=rng.uniform(size=(S, N)) < 0.9,
        dI_l=np.stack(dI_l), dI_r=np.stack(dI_r),
        K=np.asarray(K, np.float32), baseline=np.float32(base),
    )
    np.savez(tmp_path / "match.npz", **data)
    settings = default_settings()
    run_ranks(stereo_match_sharded, 2, tmp_path, settings)

    T = torch.from_numpy
    whole = [stereo_match_points(T(data["us"][s]), T(data["vs"][s]), T(data["valid"][s]),
                                 T(data["dI_l"][s]), T(data["dI_r"][s]), T(data["K"]),
                                 T(np.asarray(data["baseline"])), settings=settings)
             for s in range(S)]
    ranks = [np.load(tmp_path / f"match_rank{r}.npz") for r in range(2)]
    total = sum(int(w.good.sum()) for w in whole)
    assert total > 200 and len({int(w.good.sum()) for w in whole}) > 1
    for r, got in enumerate(ranks):
        assert int(got["total_good"]) == total
        for j in range(2):
            for name in whole[0]._fields:
                a, b = got[name][j], n(getattr(whole[2 * r + j], name))
                assert a.dtype == b.dtype
                assert ((a == b) | ((a != a) & (b != b))).all(), f"rank {r} pair {j} {name}"
