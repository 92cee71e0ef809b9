"""The tracker's LM trip kernel (`csrc/lm_trip.cu`, `tracker_ops.lm_trip`
on CUDA tensors) against its plain version (`tracker_ops.lm_trip_ref`).

Here, on the CPU: the wrapper lays the problem and the carry out as the
kernel reads them (`trip_args`: shapes, the sequence and row counts, the
plain version's strides of |r| and the in-bounds flags) and refuses what
the kernel does not take; and the kernel's source, compiled for the CPU
with g++ against a stand-in runtime (tests/_cuda_emu.py), holds to the
plain version over three trips with the edge rows, and a row of a batched
launch to its sequence alone bit for bit.

On the card (marked `cuda`, skipped here; this file imports no JAX, so it
runs there: `python3 -m pytest --noconftest -o addopts= -p no:cacheprovider
tests/test_torch_lm_trip.py -q`): from the same carry, one trip of the
kernel against one of the plain version on CUDA tensors, at every level's
cap (1024-8192), for 1, 5 and 4 x 5 rows, with a row already done (bit for
bit as it was), a rejected step, a cutoff repeat that ends its pass, a row
with no point in bounds and a NaN pose (`tests/_torch_lm_cases.py` has the
cases and the tolerances, each with its reason); and a row of a batched
launch bit for bit as its sequence launched alone.
"""

import ctypes

import pytest
import torch
from _torch_lm_cases import clone, compare, edge_rows, problem, start, tiny

from stereo_dso_g2o_tpu_torch.ops import tracker_ops as tops

# the levels' caps on the card: the main path's 8192 and 4096, and 2048 and
# 1024 besides (the main path's 1672 and 418 on levels 4 and 5 of 1216x352)
CAPS = (8192, 8192, 8192, 4096, 2048, 1024)


@pytest.mark.parametrize("n_seq", [None, 3])
def test_trip_args_lay_the_operands_out_as_the_kernel_reads_them(n_seq):
    p, c = tiny(n_seq)
    args, keep = tops.trip_args(p, c)
    assert (args.n_seq, args.rows_per_seq, args.P, args.H, args.W) == (n_seq or 1, 3, 40, 12, 16)
    assert args.launches is None and args.max_iterations == 5
    assert (args.opt_a, args.opt_b) == (1, 1)
    assert args.huber_th == 9.0 and args.two_huber_th == 18.0 and args.huber_th_sq == 81.0
    assert list(args.scale) == [1.0] * 3 + [0.5] * 3 + [10.0, 1000.0]
    for name in tops.LMCarry._fields:
        assert getattr(args, name) == getattr(c, name).data_ptr(), name
    for name, x in keep.items():
        assert x.is_contiguous() and x.shape[0] == (n_seq or 1), name
        assert getattr(args, name) == x.data_ptr()
    # the plain version's own layout of |r| and the flags, read in place
    st = c.ar.stride()
    assert list(args.ar_stride) == ([0] if n_seq is None else []) + list(st)
    assert c.inb.stride() == st
    # a dimension of one entry may have any stride in either
    one = tops.LMCarry(*(x[:1] for x in c))
    one = one._replace(inb=one.inb.as_strided(one.inb.shape, (999,) + one.inb.stride()[1:]))
    p1 = tops.LMProblem(*(x[:1] if isinstance(x, torch.Tensor) and x.dim() > 0 else x
                          for x in p)) if n_seq else p
    tops.trip_args(p1, one if n_seq else c)
    # the C struct: 25 addresses, 8 ints, 4 floats, 8 scales, 3 strides
    assert ctypes.sizeof(tops.TripArgs) == 25 * 8 + 8 * 4 + 4 * 4 + 8 * 4 + 3 * 8


@pytest.mark.parametrize("fault", ["dtype", "strided", "rows", "image", "ok"])
def test_trip_args_refuse_what_the_kernel_does_not_take(fault):
    p, c = tiny(2)
    if fault == "dtype":
        c = c._replace(it=c.it.int())
    elif fault == "strided":
        c = c._replace(Hm=c.Hm.transpose(-1, -2))
    elif fault == "rows":
        c = c._replace(T=c.T[:1])
    elif fault == "image":
        p = p._replace(dI_new=p.dI_new[..., :2])
    else:
        p = p._replace(pc_ok=p.pc_ok.float())
    with pytest.raises((ValueError, TypeError)):
        tops.trip_args(p, c)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """`csrc/lm_trip.cu` compiled for the CPU (tests/_cuda_emu.py): a
    trip(p, c) that launches it on CPU tensors."""
    import _cuda_emu

    from stereo_dso_g2o_tpu_torch.ops import trace_cuda

    lib = _cuda_emu.build(trace_cuda.RUNTIME_SOURCES["lm_trip"], tmp_path_factory.mktemp("emu"))
    fn = lib.sdso_lm_trip
    fn.argtypes = [ctypes.POINTER(tops.TripArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def trip(p, c):
        args, _keep = tops.trip_args(p, c)
        assert fn(ctypes.byref(args), None) == 0

    return trip


def _cpu_case(case):
    if case == "random":  # 2 sequences of 5 rows, the last a NaN pose
        p, carry = tiny(n_seq=2, rows=5)
    else:  # the corridor's coarsest level, 418 points, 5 rows
        p, T_gt = problem(5)
        carry = start(p, 5, T_gt)
    return p, edge_rows(carry, p)


@pytest.mark.parametrize("case", ["random", "level5"])
def test_the_kernel_run_on_the_cpu_matches_the_plain_trip(emulated, case):
    """The kernel's source, compiled for the CPU, against the plain version
    from the same carry over three trips, the edge rows included, within
    the card test's tolerances (tests/_torch_lm_cases.py)."""
    p, carry = _cpu_case(case)
    for j in range(3):
        want, got = clone(carry), clone(carry)
        tops.lm_trip_ref(p, want)
        emulated(p, got)
        res = compare(p, got, want, carry)
        checked = res.pop("checked")
        assert checked > 0 or j > 0, res
        assert not any(res.values()), (j, res)
        carry = want


def test_a_batched_row_run_on_the_cpu_rounds_as_its_sequence_alone(emulated):
    p, carry = tiny(n_seq=3, rows=5)
    edge_rows(carry, p)
    batched = clone(carry)
    emulated(p, batched)
    for s in range(3):
        p1 = tops.LMProblem(*(x[s] if isinstance(x, torch.Tensor) else x for x in p))
        alone = tops.LMCarry(*(x[s].clone() for x in carry))
        emulated(p1, alone)
        for name, a, b in zip(tops.LMCarry._fields, alone, batched):
            if a.dtype == torch.float32:  # bit for bit, NaNs included
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b[s]), (s, name)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda", 0)


def _trips(p, carry, trips=3):
    """Up to `trips` trips, each of the kernel and of the plain version
    from the plain version's carry: [compare(...)] of each."""
    got_all = []
    for _ in range(trips):
        want, got = clone(carry), clone(carry)
        tops.lm_trip_ref(p, want)
        tops.lm_trip(p, got)
        torch.cuda.synchronize()
        got_all.append(compare(p, got, want, carry))
        carry = want
    return got_all


@pytest.mark.cuda
@pytest.mark.parametrize("lvl,n_seq,rows", [(lvl, 1, 5) for lvl in range(6)]
                         + [(0, 1, 1), (1, 1, 1), (2, 4, 5), (5, 4, 5)])
def test_kernel_trip_matches_the_plain_trip_on_the_card(lvl, n_seq, rows):
    dev = _card()
    p, T_gt = problem(lvl, n_seq, device=dev, caps=CAPS)
    assert p.pc_u.shape[-1] == CAPS[lvl]
    carry = start(p, rows, T_gt)
    if rows * n_seq >= 5:
        edge_rows(carry, p)
    for j, res in enumerate(_trips(p, carry)):
        checked = res.pop("checked")
        assert checked > 0 or j > 0, res  # the first trip runs rows of certain decisions
        assert not any(res.values()), (j, res)


@pytest.mark.cuda
def test_a_batched_row_rounds_as_its_sequence_launched_alone():
    dev = _card()
    p, T_gt = problem(2, 4, device=dev, caps=CAPS)
    carry = edge_rows(start(p, 5, T_gt), p)
    batched = clone(carry)
    tops.lm_trip(p, batched)
    for s in range(4):
        p1 = tops.LMProblem(*(x[s] if isinstance(x, torch.Tensor) else x for x in p))
        alone = tops.LMCarry(*(x[s].clone() for x in carry))
        tops.lm_trip(p1, alone)
        for name, a, b in zip(tops.LMCarry._fields, alone, batched):
            if a.dtype == torch.float32:  # bit for bit, NaNs included
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b[s]), (s, name)
