"""Immature-point sets of the PyTorch port against the JAX package: seeding
a keyframe row, and the temporal trace of every live row through the
fixed-size compaction pool (including a pool smaller than the live rows,
whose overflow must keep its state). The non-keyframe refinement and the
activation path run on real warmed state in test_torch_full_system."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import fields, n, t

from stereo_dso_g2o_tpu.config import default_settings as jdefault_settings
from stereo_dso_g2o_tpu.frontend import immature as jimm
from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from stereo_dso_g2o_tpu.utils import se3 as jse3
from stereo_dso_g2o_tpu_torch import bridge
from stereo_dso_g2o_tpu_torch.frontend import immature as timm
from stereo_dso_g2o_tpu_torch.ops import trace as ttr

JSET = jdefault_settings()
W_, H_, F, C = 192, 96, 3, 96


def _tset(**kw):
    return bridge.settings_from_fields({**dataclasses.asdict(JSET), **kw})


@pytest.fixture(scope="module")
def seeded():
    scene = synthetic.default_scene(5)
    K = np.asarray(synthetic.default_K(W_, H_), np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.1, 0.02, 0.05, 0.004, -0.01, 0.002])), np.float64)
    left0, _ = synthetic.render(scene, K, W_, H_, np.eye(4))
    left1, _ = synthetic.render(scene, K, W_, H_, T)
    dI0 = jbuild_pyramid(jnp.asarray(left0, jnp.float32), 1)[0][0]
    dI1 = jbuild_pyramid(jnp.asarray(left1, jnp.float32), 1)[0][0]
    rng = np.random.default_rng(4)
    jset, tset = jimm.empty(F, C), timm.empty(F, C, device="cpu")
    for slot in (0, 2):  # slot 1 stays empty
        us = rng.uniform(10, W_ - 11, C).astype(np.float32)
        vs = rng.uniform(10, H_ - 11, C).astype(np.float32)
        types = rng.integers(1, 3, C).astype(np.int32)
        valid = rng.uniform(size=C) < 0.9
        jset = jimm.seed_slot(jset, slot, dI0, jnp.asarray(us), jnp.asarray(vs),
                              jnp.asarray(types), jnp.asarray(valid), settings=JSET)
        tset = timm.seed_slot(tset, slot, t(dI0), t(us), t(vs), torch.from_numpy(types),
                              torch.from_numpy(valid), settings=_tset())
    KRKi = K @ T[:3, :3].astype(np.float32) @ np.linalg.inv(K)
    Kt = K @ T[:3, 3].astype(np.float32)
    return jset, tset, dI1, np.broadcast_to(KRKi, (F, 3, 3)).astype(np.float32), \
        np.broadcast_to(Kt, (F, 3)).astype(np.float32)


def test_seed_slot_matches(seeded):
    jset, tset = seeded[:2]
    for name, want in fields(jset).items():
        got = n(getattr(tset, name))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-4, atol=1e-4,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


@pytest.mark.parametrize("trace_cap", [5120, 120])
def test_trace_on_frame_matches(seeded, trace_cap):
    """All live rows (~170) through the pool; with trace_cap=120 the rows
    past the pool keep their state on both sides."""
    jset, tset, dI1, KRKi, Kt = seeded
    aff = np.broadcast_to(np.array([1.0, 0.0], np.float32), (F, 2)).copy()
    hv = np.array([True, False, True])
    js = dataclasses.replace(JSET, trace_cap=trace_cap)
    jout = jimm.trace_on_frame(jset, jnp.asarray(KRKi), jnp.asarray(Kt), jnp.asarray(aff), dI1,
                               jnp.asarray(hv), js)
    tout = timm.trace_on_frame(tset, t(KRKi), t(Kt), t(aff), t(dI1), torch.from_numpy(hv),
                               settings=_tset(trace_cap=trace_cap))
    jst, tst = np.array(jout.status), n(tout.status)
    assert (jst == tst).mean() >= 0.999
    assert (jst == ttr.IPS_GOOD).sum() > 20
    if trace_cap < 170:
        assert (tst == ttr.IPS_UNINITIALIZED).sum() > 0
    same = jst == tst
    for f in ("idepth_min", "idepth_max"):
        np.testing.assert_allclose(n(getattr(tout, f))[same], np.array(getattr(jout, f))[same],
                                   rtol=1e-4, atol=1e-6, equal_nan=True, err_msg=f)
    good = same & (jst == ttr.IPS_GOOD)
    np.testing.assert_allclose(n(tout.last_uv)[good], np.array(jout.last_uv)[good], atol=1e-3)
    np.testing.assert_array_equal(n(tout.valid), np.array(jout.valid))
