"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: numpy hand-over, the JAX thinning draw, and state snapshots for
`stereo_dso_g2o_tpu_torch.bridge`."""

import dataclasses

import jax
import numpy as np
import torch

# tier-1 runs several test processes at once: keep torch's pool small
torch.set_num_threads(2)


def t(x, dtype=None):
    """JAX/numpy array -> CPU torch tensor (float64 arrays become float32:
    tests/conftest.py turns on jax x64, the port is float32)."""
    a = np.array(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def jax_uniform(salt, shape, device="cpu"):
    """The JAX package's selector thinning draw, for PixelSelector(uniform=)."""
    u = jax.random.uniform(jax.random.PRNGKey(salt & 0x7FFFFFFF), shape)
    return torch.from_numpy(np.array(u)).to(device)


def fields(obj):
    """numpy dict of a flax struct dataclass's leaves."""
    return {f.name: np.array(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def fs_snapshot(fs):
    """Snapshot of a JAX FullSystem for bridge.full_system_from_snapshot."""
    return dict(
        win=fields(fs.win),
        imm=fields(fs.imm),
        tracker_ref=[tuple(np.array(x) for x in lvl) for lvl in fs.tracker.ref],
        tracker_ref_aff=np.array(fs.tracker.ref_aff),
        tracker_ref_exposure=fs.tracker.ref_exposure,
        tracker_first_coarse_rmse=fs.tracker.first_coarse_rmse,
        tracker_ref_frame_id=fs.tracker.ref_frame_id,
        dI_slots=[None if p is None else tuple(np.array(x) for x in p) for p in fs.dI_slots],
        right_slots=[None if r is None else np.array(r) for r in fs.right_slots],
        history=[dataclasses.asdict(h) for h in fs.history],
        kf_slots=list(fs.kf_slots),
        slot_frame_id=dict(fs.slot_frame_id),
        slot_meta=dict(fs.slot_meta),
        kf_out_count=np.array(fs.kf_out_count),
        current_min_act_dist=fs.current_min_act_dist,
        last_coarse_rmse=np.array(fs.last_coarse_rmse),
        next_kf_id=fs.next_kf_id,
        initialized=fs.initialized,
        is_lost=fs.is_lost,
        init_failed=fs.init_failed,
        selector_potential=fs.selector.current_potential,
        selector_calls=fs.selector._calls,
    )
