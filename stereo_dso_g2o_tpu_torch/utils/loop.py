"""Loops and branches whose course the device decides: the port's
`lax.while_loop` and `lax.cond`.

Eagerly (on the CPU, or on the card outside a captured program) a loop is
a host loop, one read of its flag before every trip (`utils/host.py`), and
a branch one read of its predicate. While `runtime/program.py` captures a
program (inside `capturing`), the same loop becomes a CUDA WHILE node and
the branch an IF node, both added by `csrc/graph_while.cu`, whose library
the capture hands in: nothing is read, the device decides. Under
`bounded()` every loop runs to its bound and every branch's body runs,
with no read: what the nodes compute, checked where there is no card (a
trip after the last changes nothing, and a body leaves what its predicate
does not select as it was). Under `every_branch()` every branch's body
runs and loops run as they do eagerly: a program's warm-up, which runs
every op of the capture once.

A node's body is captured once and runs as often as the device decides;
a search kernel launched inside one counts its launches on the device
(`ops/trace_cuda.launch_counter`), each time the body runs.

A loop or branch given a `name` keeps a stage of the program's accounting
(`Capture.stamps`, read by `runtime/program.Program.stages`): the kernel
that sets its condition also counts its trips (a branch: its evaluations
and how often it was taken) and times a loop's span, adding no node.
`stamped(name)` (what `utils/timing.PROF.section` becomes under capture)
captures a stamp kernel at a block's entry and exit, so a section inside
a node's body stamps each time the body runs. Each stage records the
section open when it was captured as its parent. Eagerly a named loop or
branch adds its host trips to `utils/timing.PROF` when that is enabled,
and an unnamed one keeps nothing anywhere.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from stereo_dso_g2o_tpu_torch.utils import host
from stereo_dso_g2o_tpu_torch.utils.timing import PROF
from stereo_dso_g2o_tpu_torch.utils.tree import leaves, tree_map

_BOUNDED = False
_EVERY_BRANCH = False
_CAPTURE: Optional["Capture"] = None  # the capture in progress
_BODY_STREAMS = {}  # (device, depth) -> the stream node bodies are captured on


@dataclasses.dataclass
class Stage:
    """A named stage of a program: its row of `Capture.stamps`, its kind
    ("section", "while", "if", or "call": stamped outside the graph) and
    the section open when it was captured (None at the top)."""

    slot: int
    kind: str
    parent: Optional[str]


@dataclasses.dataclass
class Capture:
    """What a capture in progress gives its loops and branches: the bound
    `csrc/graph_while.cu` (`sdso_cond_begin`, `sdso_cond_end`,
    `sdso_stamp`), the graph pool a body's allocations go to, and the
    program's stage buffer `stamps` ((slots, 8) int64, made outside the
    graph's pool) with its registry. It counts the nodes it adds."""

    lib: ctypes.CDLL
    body_pool: tuple
    stamps: torch.Tensor
    depth: int = 0
    while_nodes: int = 0
    if_nodes: int = 0
    body_nodes: int = 0
    stamp_nodes: int = 0
    # the bodies' nodes by cudaGraphNodeType
    body_types: ctypes.Array = dataclasses.field(default_factory=lambda: (ctypes.c_ulonglong * 16)())
    stages: Dict[str, Stage] = dataclasses.field(default_factory=dict)
    open: List[str] = dataclasses.field(default_factory=list)  # sections open, innermost last

    def slot(self, name: str, kind: str) -> int:
        """The device address of stage `name`'s row (registered at first
        sight, under the section open now)."""
        st = self.stages.get(name)
        if st is None:
            if len(self.stages) == self.stamps.shape[0]:
                raise RuntimeError(f"a program has room for {self.stamps.shape[0]} stages: "
                                   f"{name} is one more")
            st = self.stages[name] = Stage(len(self.stages), kind,
                                           self.open[-1] if self.open else None)
        elif st.kind != kind:
            raise RuntimeError(f"the stage {name} is a {st.kind}, not a {kind}")
        return self.stamps[st.slot].data_ptr()

    def _stamp(self, addr: int, is_end: int):
        stream = torch.cuda.current_stream(self.stamps.device).cuda_stream
        _check(self.lib.sdso_stamp(stream, addr, is_end), "capturing a stamp")
        self.stamp_nodes += 1

    @contextlib.contextmanager
    def section(self, name: str, kind: str = "section", stamp: bool = True):
        """The block as stage `name`, open for the stages inside it; with
        `stamp`, a stamp kernel captured at its entry and at its exit."""
        addr = self.slot(name, kind)
        if stamp:
            self._stamp(addr, 0)
        self.open.append(name)
        yield
        self.open.pop()
        if stamp:
            self._stamp(addr, 1)


def stamped(name: str):
    """Stage `name` around a block captured now (`Capture.section`);
    nothing outside a capture by `runtime/program.py`."""
    if _CAPTURE is None:
        return contextlib.nullcontext()
    return _CAPTURE.section(name)


@contextlib.contextmanager
def bounded():
    """Within the block, loops run to their bound and branches always."""
    global _BOUNDED
    prev, _BOUNDED = _BOUNDED, True
    try:
        yield
    finally:
        _BOUNDED = prev


@contextlib.contextmanager
def every_branch():
    """Within the block, branches always run their body (loops as eagerly)."""
    global _EVERY_BRANCH
    prev, _EVERY_BRANCH = _EVERY_BRANCH, True
    try:
        yield
    finally:
        _EVERY_BRANCH = prev


@contextlib.contextmanager
def capturing(lib, body_pool, stamps: torch.Tensor):
    """Within the block (a graph capture), loops and branches on a
    capturing stream become conditional nodes, and sections and named
    loops and branches keep their stages in `stamps`; yields their
    `Capture`."""
    global _CAPTURE
    if _CAPTURE is not None:
        raise RuntimeError("a program is already being captured")
    _CAPTURE = Capture(lib, body_pool, stamps)
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = None


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


@contextlib.contextmanager
def _allocate_to(device: torch.device, pool):
    """Route this thread's allocations to the graph pool `pool`."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(idx, pool)


def _conditional(flag: torch.Tensor, body: Callable[[], None], is_while: bool,
                 name: Optional[str]):
    """A conditional node on the () bool `flag` whose body `body()` is
    captured on a stream of its own (one per nesting depth). A body's
    allocations go to the capture's body pool, a pool of their own: a
    body's temporaries are reused only by later bodies, which run after it
    (the thread is routed there once, at the outermost body). `name`: the
    stage its condition kernels keep, or None."""
    cap = _CAPTURE
    if cap is None:
        raise RuntimeError("a loop or branch is being captured outside runtime/program.py")
    dev = flag.device
    key = (dev, cap.depth)
    stream = _BODY_STREAMS.get(key)
    if stream is None:
        stream = _BODY_STREAMS[key] = torch.cuda.Stream(dev)
    slot = cap.slot(name, "while" if is_while else "if") if name else None
    handle = ctypes.c_ulonglong()
    _check(cap.lib.sdso_cond_begin(torch.cuda.current_stream(dev).cuda_stream, stream.cuda_stream,
                                   flag.data_ptr(), int(is_while), slot, ctypes.byref(handle)),
           "adding a conditional node")
    nodes = ctypes.c_ulonglong()
    routed = _allocate_to(dev, cap.body_pool) if cap.depth == 0 else contextlib.nullcontext()
    cap.depth += 1
    try:
        with torch.cuda.stream(stream), routed:
            body()
            _check(cap.lib.sdso_cond_end(stream.cuda_stream, flag.data_ptr() if is_while else None,
                                         handle, slot if is_while else None, ctypes.byref(nodes),
                                         cap.body_types),
                   "capturing a node's body")
    finally:
        cap.depth -= 1
    cap.body_nodes += nodes.value


def _while_node(done: torch.Tensor, trip: Callable[[], None], name: Optional[str]):
    """`while_loop` inside a capture: a WHILE node whose body is `trip` and
    whose condition, "some entry of `done` is not set", the device
    evaluates before every trip (the first included: a loop whose first
    trip always runs starts with `done` unset)."""
    flag = torch.logical_not(done.all())

    def body():
        trip()
        torch.logical_not(done.all(), out=flag)

    _conditional(flag, body, True, name)
    _CAPTURE.while_nodes += 1


def _if_node(pred: torch.Tensor, body: Callable, otherwise, name: Optional[str]):
    """`cond` inside a capture: an IF node on `pred`, whose body writes
    `body()`'s result over a copy of `otherwise`."""
    outs = tree_map(lambda x: x.clone(), otherwise)

    def write():
        got = leaves(body())
        dst = leaves(outs)
        if len(got) != len(dst):
            raise RuntimeError(f"a branch's body gave {len(got)} tensors for {len(dst)}")
        torch._foreach_copy_(dst, got)

    _conditional(pred.to(torch.bool), write, False, name)
    _CAPTURE.if_nodes += 1
    return outs


def while_loop(done: torch.Tensor, trip: Callable[[], None], bound: int,
               first_trip: bool = False, name: Optional[str] = None):
    """Run `trip()` until every entry of the bool tensor `done` is set.
    `trip` updates `done` and the rest of its carry in place; a trip after
    every entry is set must change nothing, and after `bound` trips every
    entry is set. `first_trip`: the caller's `done` starts unset, so the
    host loop runs the first trip without reading it (one read a trip).
    `name`: the stage that counts its trips (module docstring)."""
    if _capturing(done):
        _while_node(done, trip, name)
        return
    t0, trips = time.perf_counter(), 0
    if _BOUNDED:
        trips = bound
        for _ in range(bound):
            trip()
    else:
        if first_trip:
            trip()
            trips += 1
        while not host.flag(done.all()):
            trip()
            trips += 1
    if name:
        PROF.loop(name, trips, time.perf_counter() - t0)


def cond(pred: torch.Tensor, body: Callable, otherwise, name: Optional[str] = None):
    """`body()` if the () bool tensor `pred` holds, else `otherwise` (a tree
    of tensors of body's structure and shapes, `utils/tree.py`). `body`
    must give `otherwise`'s values wherever it does not act, so running it
    always is the same. `name`: the stage that counts its evaluations and
    the times it was taken (module docstring)."""
    if _capturing(pred):
        return _if_node(pred, body, otherwise, name)
    taken = _BOUNDED or _EVERY_BRANCH or host.flag(pred)
    if name:
        PROF.loop(name, int(taken))
    return body() if taken else otherwise
