"""The port's occupancy-grid KNN (`utils/knn.py`) against the JAX package's,
on the jittered grid of `tests/test_initializer.py` (one point per 5-px
cell: the selector's distribution). Neighbour and parent indices must be
equal exactly, `dist2` equal too (measured: bit for bit; the bound
stated is 1e-6 relative).

The cases that decide the port's design: padding lanes (invalid) that land
in a valid point's cell after it (XLA's scatter is last-writer-wins, so the
cell reads -1), invalid lanes interleaved with valid ones, and grids so
small that most cells are clipped to the border (many ties in `top_k`).
The port rounds `du*du + dv*dv` as one FMA, as XLA contracts it; without
that `dist2` parts by one rounding (7.6e-6 at 60 px²) on a tenth of the
entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_dso_g2o_tpu.utils import knn as jknn
from stereo_dso_g2o_tpu_torch.utils import knn as tknn


def _jittered(seed=0, ny=10, nx=20, step=5.0):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:ny, 0:nx]
    n = ny * nx
    us = (gx.ravel() * step + rng.uniform(0, 4, n)).astype(np.float32)
    vs = (gy.ravel() * step + rng.uniform(0, 4, n)).astype(np.float32)
    return us, vs


def _case(name):
    us, vs = _jittered()
    valid = np.ones(us.shape[0], bool)
    if name == "padding_after":
        # fixed-capacity padding: zero coords, invalid, highest lanes — they
        # land in cell (0, 0) after the valid point there
        us = np.concatenate([us, np.zeros(40, np.float32)])
        vs = np.concatenate([vs, np.zeros(40, np.float32)])
        valid = np.concatenate([valid, np.zeros(40, bool)])
    elif name == "interleaved_invalid":
        rng = np.random.default_rng(1)
        valid = rng.uniform(size=us.shape[0]) > 0.3
        # duplicates of valid points' coords, some valid, some not
        dup = rng.choice(us.shape[0], 60, replace=False)
        us = np.concatenate([us, us[dup]])
        vs = np.concatenate([vs, vs[dup] + 0.25])
        valid = np.concatenate([valid, rng.uniform(size=60) > 0.5])
    return us, vs, valid


def _jax(fn, *args, **kw):
    with jax.enable_x64(False):
        return [np.array(x) for x in jax.tree.leaves(fn(*args, **kw))]


@pytest.mark.parametrize("name", ["plain", "padding_after", "interleaved_invalid"])
@pytest.mark.parametrize("gh,gw,k", [(16, 24, 5), (16, 24, 10), (6, 9, 10)])
def test_grid_knn_equals_jax(name, gh, gw, k):
    us, vs, valid = _case(name)
    with jax.enable_x64(False):
        j_idx, j_d2 = _jax(jknn.grid_knn, jnp.asarray(us), jnp.asarray(vs), jnp.asarray(valid),
                           jnp.float32(5.0), gh=gh, gw=gw, k=k)
    t_idx, t_d2 = tknn.grid_knn(torch.from_numpy(us), torch.from_numpy(vs),
                                torch.from_numpy(valid), torch.tensor(5.0), gh=gh, gw=gw, k=k)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_allclose(t_d2.numpy(), j_d2, atol=0, rtol=1e-6)
    assert (j_idx >= 0).any()


def test_occupancy_is_last_writer_wins():
    """What XLA's CPU scatter gives with duplicate cells, including the -1
    written by an invalid lane after a valid one, is what the port builds."""
    rng = np.random.default_rng(3)
    n, gh, gw = 500, 7, 9
    ci = rng.integers(0, gw, n).astype(np.int32)
    cj = rng.integers(0, gh, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.6
    with jax.enable_x64(False):
        grid = jnp.full((gh, gw), -1, jnp.int32).at[jnp.asarray(cj), jnp.asarray(ci)].set(
            jnp.where(jnp.asarray(valid), jnp.arange(n, dtype=jnp.int32), -1))
    want = np.full((gh, gw), -1)
    for i in range(n):
        want[cj[i], ci[i]] = i if valid[i] else -1
    np.testing.assert_array_equal(np.array(grid), want)
    got = tknn._occupancy(torch.from_numpy(ci), torch.from_numpy(cj), torch.from_numpy(valid),
                          gh, gw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).sum() > 0 and (want >= 0).sum() > 0


@pytest.mark.parametrize("name", ["plain", "padding_after", "interleaved_invalid"])
@pytest.mark.parametrize("gh,gw", [(8, 12), (3, 4)])
def test_grid_parent_equals_jax(name, gh, gw):
    us, vs, valid = _case(name)
    # the coarser level: a jittered grid at half the resolution, with
    # padding lanes of its own
    uc, vc = _jittered(seed=7, ny=5, nx=10)
    uc = np.concatenate([uc, np.zeros(8, np.float32)])
    vc = np.concatenate([vc, np.zeros(8, np.float32)])
    valid_c = np.concatenate([np.random.default_rng(8).uniform(size=50) > 0.2,
                              np.zeros(8, bool)])
    (j_par,) = _jax(jknn.grid_parent, *(jnp.asarray(x) for x in (us, vs, valid, uc, vc, valid_c)),
                    jnp.float32(5.0), gh=gh, gw=gw)
    t_par = tknn.grid_parent(*(torch.from_numpy(x) for x in (us, vs, valid, uc, vc, valid_c)),
                             torch.tensor(5.0), gh=gh, gw=gw)
    np.testing.assert_array_equal(t_par.numpy(), j_par)
    assert (j_par >= 0).any()
    assert (j_par[~valid] == -1).all()
