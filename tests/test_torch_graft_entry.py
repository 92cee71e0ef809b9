"""The port's graft entry points (`stereo_dso_g2o_tpu_torch/graft_entry.py`)
against the repository's `__graft_entry__.py`, on the CPU.

`entry()`'s one BA iteration against the JAX `entry()` jitted: the inputs
the two build agree, then nres equal, energy within 1e-4 relative and the
step's rotations within 1e-5. The entry's window has no depth prior, so its
scale is free and the two solves step along it by different amounts (0.16 %
of the translations, 0.2 % of the inverse depths); with depth priors on its
points the same iteration holds the whole state to tests/test_torch_ba.py's
`ba_iteration` tolerances: poses within 1e-5, inverse depths within 1e-4
relative. `dryrun_multichip(2)` and `(4)` over `gloo` ranks pass their own
assertions (the sharded BA at production shape against the single-process
BA, the sequence-sharded stereo match against the rendered depths) inside
a time limit. Stage (a)'s production window: the port's single-process
energy equals the JAX `ba_iteration`'s on the window the JAX dry run
builds, within 1e-4 relative."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import fields, n

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch import graft_entry as tge
from stereo_dso_g2o_tpu_torch.backend import ba as tba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSET = jdefault_settings()
TSET = bridge.settings_from_fields(dataclasses.asdict(JSET))
RTOL = 1e-4
DRYRUN_LIMIT_S = 300.0


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location("__graft_entry__",
                                                  os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs_agree(twin, tdI, jwin, jdI):
    """The window and images one entry builds against the other's: poses,
    pixels and masks equal, pattern colors and weights within 1e-5."""
    want = bridge.window_from_numpy(fields(jwin), device="cpu")
    for f in ("frame_valid", "evalPT", "pt_status", "pt_host", "pt_u", "pt_v", "pt_idepth",
              "res_exists", "res_state"):
        np.testing.assert_array_equal(n(getattr(twin, f)), n(getattr(want, f)), err_msg=f)
    for f in ("pt_color", "pt_weights", "pt_energy_th"):
        np.testing.assert_allclose(n(getattr(twin, f)), n(getattr(want, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(n(tdI), np.asarray(jdI, np.float32), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("priors", [False, True], ids=["as_built", "depth_priors"])
def test_entry_matches_jax(priors):
    jfn, jargs = _jax_entry_module().entry()
    fn, args = tge.entry(device="cpu")
    assert args[0].device.type == "cpu" and args[1].shape == tuple(jargs[1].shape)
    _inputs_agree(args[0], args[1], jargs[0], jargs[1])
    if priors:
        jargs = (jargs[0].replace(pt_has_prior=jargs[0].pt_status == 1),) + tuple(jargs[1:])
        args = (args[0].replace(pt_has_prior=args[0].pt_status == 1),) + tuple(args[1:])
    jwin, je, _, jn = jax.jit(jfn)(*jargs)
    twin, te, _, tn = fn(*args)
    assert int(tn) == int(jn) > 0 and np.isfinite(float(te))
    np.testing.assert_allclose(float(te), float(je), rtol=RTOL)
    got, want = n(twin.w2c()), n(bridge.window_from_numpy(fields(jwin), device="cpu").w2c())
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-5, rtol=0)
    if priors:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(n(twin.pt_idepth), np.array(jwin.pt_idepth), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip_gloo(n_ranks):
    out = tge.dryrun_multichip(n_ranks, device="cpu", timeout=DRYRUN_LIMIT_S)
    assert out["ba"]["nres"] > 0 and out["ba"]["max_state_diff"] <= 5e-3
    assert out["stereo_match"]["total_good"] > 0.3 * n_ranks * 64
    assert out["stereo_match"]["median_rel_err"] < 0.1


def _jax_production_window():
    """`__graft_entry__.dryrun_multichip`'s stage-1 window, as it builds it."""
    from stereo_dso_g2o_tpu.backend import builder
    from stereo_dso_g2o_tpu.backend import window as Wb
    from stereo_dso_g2o_tpu.io import synthetic
    from stereo_dso_g2o_tpu.ops import trace as trace_ops
    from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid

    rng = np.random.default_rng(0)
    wd, hd, FCAP, NPC, N_VALID, N_FRAMES_W = 1216, 352, 8, 2048, 1337, 7
    Kd = synthetic.default_K(wd, hd, fov_deg=80.0)
    scene = synthetic.default_scene(0)
    win = Wb.empty_window(FCAP, NPC, [Kd[0, 0], Kd[1, 1], Kd[0, 2], Kd[1, 2]])
    dIs = []
    for i in range(N_FRAMES_W):
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, -0.01 * i, 0.08 * i]
        img, idep = synthetic.render(scene, Kd, wd, hd, T)
        dIs.append(build_pyramid(jnp.asarray(img), 1)[0][0])
        win = builder.insert_frame(win, i, T, (0.0, 0.0), 1.0, i)
        if i == 0:
            idepth0 = idep
    dI_stack = jnp.stack(dIs + [jnp.zeros_like(dIs[0])] * (FCAP - N_FRAMES_W + 1))
    us = rng.integers(8, wd - 8, N_VALID).astype(np.float32)
    vs = rng.integers(8, hd - 8, N_VALID).astype(np.float32)
    ids = idepth0[vs.astype(int), us.astype(int)]
    color, weights, _, eth = trace_ops.extract_point_data(dIs[0], jnp.asarray(us), jnp.asarray(vs),
                                                          JSET)
    win = builder.insert_points(win, jnp.arange(N_VALID), 0, jnp.asarray(us), jnp.asarray(vs),
                                jnp.asarray(ids), color, weights, eth)
    for tgt in range(1, N_FRAMES_W):
        win = builder.add_residuals(win, jnp.arange(N_VALID), tgt)
    return win, dI_stack


def test_production_window_energy_matches_jax():
    from stereo_dso_g2o_tpu.backend import ba as jba

    jwin, jdI = _jax_production_window()
    _, je, _, jn = jba.ba_iteration(jwin, jdI, jnp.asarray(0), settings=JSET)
    twin, tdI = tge.production_window(TSET, "cpu")
    _inputs_agree(twin, tdI, jwin, jdI)
    _, te, _, tn = tba.ba_iteration(twin, tdI, 0, settings=TSET)
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(float(te), float(je), rtol=RTOL)


def test_entries_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tge.entry, lambda: tge.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
