"""The track half as one program (`runtime/program.py`), held on the CPU.

On the card `graph_system.frame_track` is captured once per shape as one
CUDA graph, each LM level's loop a WHILE node and the retry ladder an IF
node; a WHILE node runs the trip until every row is done, and a trip
after that changes nothing. Here the same function runs eagerly with the
loop driver at its bound (`utils/loop.bounded`: every loop runs all its
2 * max_iterations + 2 trips, every branch its body), which is what the
nodes compute, at the bench entry's small corridor (256x128, one
sequence bootstrapped by the port's FullSystem, as
tests/test_torch_host_reads.py warms it). For one sequence, for three
stacked (the state three times, with three frames), and for one sequence
with the retry ladder as a branch (`always_retry_ladder=False`):

- the bounded driver equals the host loop bit for bit, NaN equal to NaN,
  in every leaf of the state, the bundle and the aux;
- it makes zero Python-level reads of a tensor (`ReadCounter`);
- it dispatches no op that waits for the device or has a data-shaped
  result: `nonzero`, `masked_select`, `_local_scalar_dense`,
  `_linalg_check_errors`, `index` / `index_put` with a bool index, nor
  `lift_fresh` (Python data made into a tensor, a copy from the host);
- the input state is bit for bit what it was.

Also: one trip after every row is done changes no entry of the LM carry;
`utils/fixed.scatter_drop` equals JAX's `.at[idx].set(vals, mode="drop")`
on seeded indices with -1 and out-of-range entries (now with no masked
index); on the card (marked
`cuda`, skipped here) the replayed program equals `program.disabled()`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ReadCounter
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_dso_g2o_tpu_torch import bench as tbench
from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import k_levels
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops import tracker_ops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import loop
from stereo_dso_g2o_tpu_torch.utils.fixed import scatter_drop
from stereo_dso_g2o_tpu_torch.utils.tree import tree_map

aten = torch.ops.aten
CASES = ("single", "stacked", "ladder")


class ForbiddenOps(TorchDispatchMode):
    """Notes every dispatched op that waits for the device or has a
    data-shaped result, or copies Python data into a tensor."""

    BAD = {aten.nonzero, aten.masked_select, aten._local_scalar_dense,
           aten._linalg_check_errors, aten.lift_fresh}
    INDEXED = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in self.BAD:
            self.found.append(str(func))
        elif packet in self.INDEXED and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1]):
            self.found.append(f"{func} with a bool index")
        return func(*args, **(kwargs or {}))


def _same(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


def _differing(a, b):
    la, lb = program.leaves(a), program.leaves(b)
    assert len(la) == len(lb)
    return [k for k, (x, y) in enumerate(zip(la, lb)) if not _same(x, y)]


@pytest.fixture(scope="module")
def runs():
    """Per case: the host loop's (state, bundle, aux), the bounded
    driver's, its reads and forbidden ops, and the input state before and
    after both runs."""
    cfg = tbench.bench_config(True)
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, tbench.BOOT + 3, torch.device("cpu"))
    settings = tbench.bench_settings(cfg)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device="cpu")
    fs = FullSystem(calib, settings, device="cpu")
    for i in range(tbench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = tgs.GraphSystem.from_full_system(fs)
    b = tbench.BOOT
    one = (gs.state, torch.as_tensor(lefts[b]), torch.as_tensor(rights[b]), calib.c,
           calib.baseline, torch.tensor(1.0))
    stack = (tree_map(lambda x: torch.stack([x] * 3), gs.state),
             torch.stack([torch.as_tensor(lefts[b + k]) for k in range(3)]),
             torch.stack([torch.as_tensor(rights[b + k]) for k in range(3)]),
             torch.stack([calib.c] * 3), torch.stack([calib.baseline] * 3),
             torch.tensor([1.0, 1.0, 1.0]))
    common = dict(n_levels=calib.n_levels, n_tries=5, w0=calib.w[0], h0=calib.h[0])
    cases = {
        "single": (one, settings),
        "stacked": (stack, settings),
        "ladder": (one, dataclasses.replace(settings, always_retry_ladder=False)),
    }
    out = {"context": (lefts, calib, settings)}
    mp = pytest.MonkeyPatch()
    try:
        for name, (args, s) in cases.items():
            before = [x.clone() for x in program.leaves(args[0])]
            ref = tgs.frame_track(*args, settings=s, **common)
            counter = ReadCounter(mp)
            ops = ForbiddenOps()
            with loop.bounded(), ops:
                got = tgs.frame_track(*args, settings=s, **common)
            reads, by = counter.n, dict(counter.by)
            mp.undo()
            out[name] = dict(ref=ref, got=got, reads=(reads, by), forbidden=ops.found,
                             before=before, after=program.leaves(args[0]))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", CASES)
def test_loop_driver_at_its_bound_equals_the_host_loop(runs, case):
    r = runs[case]
    assert _differing(r["ref"], r["got"]) == []
    assert bool(torch.isfinite(r["got"][1].T).all())


@pytest.mark.parametrize("case", CASES)
def test_track_half_makes_no_read(runs, case):
    assert runs[case]["reads"] == (0, {})


@pytest.mark.parametrize("case", CASES)
def test_track_half_dispatches_no_syncing_op(runs, case):
    assert runs[case]["forbidden"] == []


@pytest.mark.parametrize("case", CASES)
def test_track_half_writes_none_of_its_inputs(runs, case):
    r = runs[case]
    assert all(_same(x, y) for x, y in zip(r["before"], r["after"]))


def test_a_trip_after_every_row_is_done_changes_nothing(runs):
    """`lm_trip` on a carry whose rows are all done leaves every entry of
    it as it was (the WHILE node's last condition check may follow it)."""
    st = runs["single"]["ref"][0]
    lefts, calib, settings = runs["context"]
    lvl = 3
    dI = build_pyramid(torch.as_tensor(lefts[tbench.BOOT]).float(), 6)[0][lvl]
    T0 = torch.eye(4).expand(5, 4, 4).clone()
    p = tracker_ops.LMProblem(*st.ref[lvl], dI, k_levels(calib)[lvl], st.ref_aff, st.ref_exposure,
                              torch.tensor(1.0), settings, 10)
    carry, _ = tracker_ops.lm_init(p, T0, torch.zeros(5, 2), torch.zeros(5, dtype=torch.bool))
    with loop.bounded():
        loop.while_loop(carry.done, lambda: tracker_ops.lm_trip(p, carry), 22)
    assert bool(carry.done.all())
    before = [x.clone() for x in carry]
    tracker_ops.lm_trip(p, carry)
    assert all(_same(x, y) for x, y in zip(before, carry))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batched", [False, True])
def test_scatter_drop_equals_jax(seed, batched):
    """Seeded indices: distinct in-range rows, -1 and other negative
    entries, past-the-end entries. JAX gets the indices as the JAX
    package's call sites give them, a negative one sent past the end."""
    rng = np.random.default_rng(seed)
    N, M, K = 3, 12, 9
    dst = rng.standard_normal((N, M, 2)).astype(np.float32)
    vals = rng.standard_normal((N, K, 2)).astype(np.float32)
    cand = np.concatenate([np.arange(0, M), np.arange(-4, -1), np.arange(M + 1, M + 4)])
    idx = np.stack([rng.permutation(np.concatenate([rng.permutation(cand)[:K - 2], [-1, M]]))
                    for _ in range(N)])
    want = np.stack([np.asarray(jnp.asarray(dst[n]).at[jnp.asarray(np.where(idx[n] < 0, M, idx[n]))]
                                .set(jnp.asarray(vals[n]), mode="drop")) for n in range(N)])
    if batched:
        got = scatter_drop(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(vals),
                           batched=True).numpy()
    else:
        got = np.stack([scatter_drop(torch.from_numpy(dst[n]), torch.from_numpy(idx[n]),
                                     torch.from_numpy(vals[n])).numpy() for n in range(N)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_replayed_program_equals_eager_on_the_card():
    """The track program replayed on the card against the same function
    under `program.disabled()`, bit for bit, over two frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program is a CUDA graph")
    dev = torch.device("cuda", 0)
    cfg = tbench.bench_config(True)
    K, (lefts, rights, _) = tbench.render_sequence(cfg, 0, tbench.BOOT + 2, dev)
    settings = tbench.bench_settings(cfg)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device=dev)
    fs = FullSystem(calib, settings, device=dev)
    for i in range(tbench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    state = tgs.GraphSystem.from_full_system(fs).state
    common = dict(settings=settings, n_levels=6, n_tries=5, w0=calib.w[0], h0=calib.h[0])
    expo = torch.tensor(1.0, device=dev)
    for i in (tbench.BOOT, tbench.BOOT + 1):
        got = tgs.frame_track(state, lefts[i], rights[i], calib.c, calib.baseline, expo, **common)
        with program.disabled():
            want = tgs.frame_track(state, lefts[i], rights[i], calib.c, calib.baseline, expo,
                                   **common)
        assert _differing(got, want) == []
        state = got[0]
