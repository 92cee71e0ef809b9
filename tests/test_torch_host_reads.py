"""`HOST_READS` counts every device-to-host read the frame program's Python
makes: one `frame_track` and one `frame_kf` on the CPU at 256x128 (the
bench entry's small corridor, bootstrapped by the port's FullSystem), with
every Python-level read of a tensor counted by patching `Tensor.__bool__`,
`__int__`, `__float__`, `__index__`, `.item`, `.tolist`, `.cpu` and
`.numpy`. The two counts must be equal, and the tracker's LM loop must be
among them (a read every iteration of every level); run eagerly, the
keyframe reads exactly once for each of its loops' trips and branches
(BA's flags once a trip, one read per supported selector potential, one
per window slot's marginalization)."""

import numpy as np
import pytest
import torch
from _torch_parity import ReadCounter

from stereo_dso_g2o_tpu_torch import bench as tbench
from stereo_dso_g2o_tpu_torch.backend import ba
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops import selector, tracker_ops


@pytest.fixture(scope="module")
def warmed():
    cfg = tbench.bench_config(True)
    n = tbench.BOOT + 2
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, n, torch.device("cpu"))
    settings = tbench.bench_settings(cfg)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device="cpu")
    fs = FullSystem(calib, settings, device="cpu")
    for i in range(tbench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = tgs.GraphSystem.from_full_system(fs)
    return gs, lefts[tbench.BOOT], rights[tbench.BOOT]


def test_host_reads_count_every_read_of_frame_track_and_frame_kf(warmed, monkeypatch):
    gs, left, right = warmed
    cal, s = gs.calib, gs.settings
    common = dict(settings=s, n_levels=cal.n_levels, w0=cal.w[0], h0=cal.h[0])
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    expo = torch.tensor(1.0)
    loops = [0]
    lm_level = tracker_ops.lm_level

    def count_levels(*a, **kw):
        loops[0] += 1
        return lm_level(*a, **kw)

    monkeypatch.setattr(tracker_ops, "lm_level", count_levels)
    trips = [0]
    ba_iteration = ba.ba_iteration

    def count_trips(*a, **kw):
        trips[0] += 1
        return ba_iteration(*a, **kw)

    monkeypatch.setattr(ba, "ba_iteration", count_trips)
    counter = ReadCounter(monkeypatch)
    tgs.reset_host_reads()
    st, bundle, aux = tgs.frame_track(gs.state, lt, rt, cal.c, cal.baseline, expo,
                                      n_tries=5, **common)
    track_reads = (tgs.HOST_READS, counter.n)
    st_kf, b_kf = tgs.frame_kf(gs.state, aux, cal.c, cal.baseline, expo, pot=gs.pot,
                               caps=gs.caps, imm_cap=s.immature_cap, **common)
    total = (tgs.HOST_READS, counter.n)
    monkeypatch.undo()
    # the track half reads once an LM iteration of each level it runs
    assert loops[0] == cal.n_levels
    assert track_reads[0] == track_reads[1] >= cal.n_levels, (track_reads, counter.by)
    # the keyframe adds BA's convergence flags once a trip, one read per
    # supported selector potential and one per window slot
    kf_reads = trips[0] + len(selector.SUPPORTED_POTS) + gs.state.win.F
    assert trips[0] >= 1
    assert total[0] == total[1] == track_reads[0] + kf_reads, (total, kf_reads, counter.by)
    assert int(b_kf.slot) >= 0 and np.isfinite(bundle.T.numpy()).all()
