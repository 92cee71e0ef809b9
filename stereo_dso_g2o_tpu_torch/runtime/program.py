"""A frame function captured once as one CUDA graph and replayed: the
port's `jax.jit`.

The JAX package jits its frame programs (`frontend/graph_system.py`'s
`frame_track`, `frame_auto`): one dispatch a frame, whose LM loops are
`lax.while_loop`s and whose retry ladder is a `lax.cond`, all on the
device. `run(fn, args, static)` gives the port the same on the card:

- **The key** is `fn`, its static arguments (settings, level and try
  counts, image size) and `key`, plus the structure of the tensor tree
  `args` and each leaf's shape, dtype and device. A new key builds a
  `Program`; a known one replays it.
- **Building** copies the inputs into buffers of the program's own, runs
  `fn` once eagerly on a side stream with every branch's body taken
  (`utils/loop.every_branch`: cuBLAS, cuSOLVER, the kernels' libraries and
  every lazy module load happen there, not in the capture), then captures
  `fn` on those buffers into one graph. Inside the capture
  (`utils/loop.capturing`, handed `csrc/graph_while.cu` and a pool for
  node bodies) each loop (`utils/loop.while_loop`: the LM levels, BA)
  becomes a WHILE node and each branch (`utils/loop.cond`: the retry
  ladder, the keyframe pipeline, the selector's potentials, the flagged
  frames' marginalization) an IF node: the graph holds no host read. A
  K1/K2 launch, at the top level or inside a node, captures an increment
  of the device's launch counter next to it (`ops/trace_cuda`), so the
  counts are those the device ran. If the capture fails, `run` raises
  and names the failure; it never runs eagerly instead.
- **Each call** copies the inputs in, replays and returns the outputs:
  an output that is an input buffer is the caller's own tensor (the
  program writes no input), every other one a copy, so that nothing the
  caller keeps (a state, a bundle that waits `fetch_lag` frames, the aux a
  keyframe needs) changes at the next replay. Nothing waits for the
  device: the host may run ahead of it.

`disabled()` is the counterpart of `jax.disable_jit()`: inside it `run`
calls `fn` eagerly, on the card too (`chip_smoke.py` and the tools put the
two side by side with it). Tensors on the CPU always run eagerly.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Callable, Dict

import torch

from stereo_dso_g2o_tpu_torch.ops import trace_cuda
from stereo_dso_g2o_tpu_torch.utils import host, loop
from stereo_dso_g2o_tpu_torch.utils.tree import leaves, tree_map

_DISABLED = 0
PROGRAMS: Dict[tuple, "Program"] = {}  # key -> its program
_LIB = []


@contextlib.contextmanager
def disabled():
    """Within the block `run` calls its function eagerly (`jax.disable_jit`)."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1


def active(device) -> bool:
    """Whether `run` replays a program for tensors on `device`."""
    return torch.device(device).type == "cuda" and not _DISABLED


def _unflatten(tree, new_leaves):
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)


def _signature(tree):
    """The structure of a tree and each leaf's shape, dtype and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple(_signature(getattr(tree, f.name))
                                     for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_signature(x) for x in tree)
    raise TypeError(f"program inputs are trees of tensors, not {type(tree).__name__}")


def _lib():
    if not _LIB:
        lib = ctypes.CDLL(str(trace_cuda.build(["graph_while"])["graph_while"]))
        p, u64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)
        lib.sdso_cond_begin.argtypes = [p, p, p, ctypes.c_int, u64p]
        lib.sdso_cond_end.argtypes = [p, p, ctypes.c_ulonglong, u64p, u64p]
        lib.sdso_graph_nodes.argtypes = [p, u64p, u64p]
        lib.sdso_graph_fault.argtypes = [p, ctypes.c_char_p, ctypes.c_int]
        for fn in (lib.sdso_cond_begin, lib.sdso_cond_end, lib.sdso_graph_nodes,
                   lib.sdso_graph_fault):
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


class Program:
    """`fn(*args, **static)` captured for one key (module docstring)."""

    def __init__(self, fn: Callable, args, static: dict, name: str):
        self.name = name
        self.replays = 0
        in_leaves = leaves(args)
        dev = in_leaves[0].device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        self.inputs = [x.clone() for x in in_leaves]
        self.args = _unflatten(args, self.inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), loop.every_branch():
            fn(*self.args, **static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.pool = torch.cuda.graph_pool_handle()
        self.body_pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept: its nodes are counted
        trace_cuda.launch_counter(dev)
        k0, r0 = tuple(trace_cuda.CAPTURED), host.READS
        try:
            with loop.capturing(_lib(), self.body_pool) as cap, \
                    torch.cuda.graph(self.graph, pool=self.pool):
                out = fn(*self.args, **static)
        except Exception as e:
            raise RuntimeError(f"capturing the program {name} failed: {type(e).__name__}: {e}") from e
        # K1/K2 launches the graph holds, inside its nodes' bodies included
        self.launches = tuple(c - k for c, k in zip(trace_cuda.CAPTURED, k0))
        if host.READS != r0:
            raise RuntimeError(f"the program {name} read the device {host.READS - r0} times")
        self.while_nodes, self.if_nodes, self.body_nodes = (
            cap.while_nodes, cap.if_nodes, cap.body_nodes)
        n, types = ctypes.c_ulonglong(), (ctypes.c_ulonglong * 16)()
        raw = self.graph.raw_cuda_graph()
        rc = _lib().sdso_graph_nodes(raw, ctypes.byref(n), types)
        if rc != 0:
            raise RuntimeError(f"counting the graph's nodes failed: cudaError {rc}")
        self.nodes = n.value
        # nodes by cudaGraphNodeType (0 kernel, 1 memcpy, 2 memset, ...; 15
        # a type the runtime does not name, the conditional nodes with the
        # H100's CUDA), at the top level and in the bodies
        self.node_types = {k: v for k, v in enumerate(types) if v}
        self.body_types = {k: v for k, v in enumerate(cap.body_types) if v}
        try:
            self.graph.instantiate()
        except Exception as e:
            what = ctypes.create_string_buffer(512)
            _lib().sdso_graph_fault(raw, what, len(what))
            raise RuntimeError(
                f"instantiating the program {name} failed ({e}): {what.value.decode()}; "
                f"nodes by type {self.node_types}, in the bodies {self.body_types}") from e
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.input_bytes = sum(x.numel() * x.element_size() for x in self.inputs)
        pools = {tuple(self.pool), tuple(self.body_pool)}
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                              if tuple(seg.get("segment_pool_id") or ()) in pools)

        self.out_tree = out
        self.outputs = leaves(out)
        at = {id(x): j for j, x in enumerate(self.inputs)}
        # per output leaf: the input buffer it is (the caller's tensor is
        # returned), or None (copied from the program's pool every call)
        self.plan = [at.get(id(x)) for x in self.outputs]
        made = {}
        for x, j in zip(self.outputs, self.plan):
            if j is None:
                made.setdefault(id(x), x)
        self.made = list(made.values())
        self.made_at = {k: i for i, k in enumerate(made)}

    def __call__(self, args):
        in_leaves = leaves(args)
        torch._foreach_copy_(self.inputs, in_leaves)
        self.graph.replay()
        self.replays += 1
        copies = [torch.empty_like(x) for x in self.made]
        if copies:
            torch._foreach_copy_(copies, self.made)
        return _unflatten(self.out_tree, [
            in_leaves[j] if j is not None else copies[self.made_at[id(x)]]
            for x, j in zip(self.outputs, self.plan)
        ])


    def report(self) -> dict:
        """What `chip_smoke.py` and the tools print of a program."""
        return dict(name=self.name, capture_s=round(self.capture_s, 4),
                    warmup_s=round(self.warmup_s, 4), nodes=self.nodes,
                    body_nodes=self.body_nodes, node_types=self.node_types,
                    body_types=self.body_types, while_nodes=self.while_nodes,
                    if_nodes=self.if_nodes, launch_sites=list(self.launches),
                    pool_mib=round(self.pool_bytes / 2**20, 1),
                    input_mib=round(self.input_bytes / 2**20, 1), replays=self.replays)


def report() -> list:
    """`Program.report()` of every program built, in the order built."""
    return [p.report() for p in PROGRAMS.values()]


def run(fn: Callable, args, static: dict, key=()):
    """`fn(*args, **static)`: a replay of its program on the card, or the
    call itself on the CPU and inside `disabled()`. `args`: a tuple of
    tensor trees; `static`: hashable keyword arguments; `key`: anything
    else the captured work depends on (a module setting it reads)."""
    first = leaves(args)[0]
    if not active(first.device):
        return fn(*args, **static)
    k = (fn, tuple(sorted(static.items())), key, _signature(args))
    prog = PROGRAMS.get(k)
    if prog is None:
        prog = PROGRAMS[k] = Program(fn, args, static, getattr(fn, "__qualname__", repr(fn)))
    return prog(args)
