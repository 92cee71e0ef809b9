"""One run of one cell: set-up, the measured window, the check, the line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names its configuration
(`benchmark/configs/<config>.json`) and traffic (`benchmark/traffic/<traffic>.json`,
which names its session kind, `benchmark/sessions/<kind>.py`); its limits
sit in `benchmark/workloads/<cell>.json`, each metric's reader in
`benchmark/metrics/<metric>.py`. Nothing here names a cell, a
configuration or a metric.

The window is a closed loop: the next call is made as soon as the last
returns, from the first call until `--seconds` have passed; every call's
submit and every result's arrival on the host are stamped by the host
clock. With `--trace 1` each call is also bracketed by CUDA events on the
stream (the per-layer device times and idle share), a short slice after
the window runs under torch.profiler (`device.busy_s`, `window_s`,
`breakdown`), and one more call runs eagerly with the search kernels'
operands recorded (the kernel rooflines).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_dso_g2o_tpu")  # top-level module names
PROFILED_CALLS = 4  # calls in the profiled slice after a traced window


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `stereo_dso_g2o_tpu_torch` is not
    `stereo_dso_g2o_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """The manifest and the files it names, under a checkout's root."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.manifest = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.manifest["configs"] if c["name"] == cell["config"])
        return load_json(self.root / entry["file"])

    def traffic(self, cell: dict) -> dict:
        return load_json(self.dir / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return load_json(self.dir / "workloads" / f"{cell['name']}.json")

    def metrics(self, cell: dict, trace: bool) -> list:
        """The metric entries this cell reports in a run of this kind."""
        if not trace:
            return [m for m in self.manifest["end_to_end"]
                    if "workloads" not in m or cell["name"] in m["workloads"]]
        e2e = {m["name"] for m in self.metrics(cell, False)}

        def reported(m):
            if "workloads" in m:
                return cell["name"] in m["workloads"]
            return m["moves"] in e2e

        return [m for m in self.manifest["per_layer"] if reported(m)]

    def reader(self, name: str):
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{abs(hash(name))}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device(chips: int, device):
    """The card, or the reason there is none. `device` given (the CPU
    tests) skips the look."""
    import torch

    if device is not None:
        return torch.device(device), None
    if not torch.cuda.is_available():
        return None, "torch.cuda.is_available() is false: this benchmark runs on an NVIDIA GPU only"
    if torch.cuda.device_count() < chips:
        return None, (f"the cell needs {chips} GPUs, torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0), None


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Events:
    """CUDA events around each call of the traced window (none on the CPU)."""

    def __init__(self, dev):
        self.on = dev.type == "cuda"
        self.pairs = []

    def around(self, fn):
        if not self.on:
            return fn()
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        self.pairs.append((a, b))
        return out

    def spans_ms(self):
        return [a.elapsed_time(b) for a, b in self.pairs]

    def window_ms(self):
        return self.pairs[0][0].elapsed_time(self.pairs[-1][1]) if self.pairs else None


def _profile_slice(session, dev, n_calls):
    """n_calls more calls under torch.profiler: (busy_s, window_s,
    breakdown), device busy as the union of the device's records."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if dev.type != "cuda":
        return None
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            with record_function(f"bench.{session.layer}.call"):
                session.call()
        with record_function(f"bench.{session.layer}.drain"):
            session.flush()
            _sync(dev)
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev_iv, spans, by_name = [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if name.startswith("bench."):  # the harness's spans, on both timelines
            if e.device_type() != cuda:
                spans.append((s, s + d, name))
        elif e.device_type() == cuda:
            dev_iv.append((s, s + d))
            by_name[name] = by_name.get(name, 0) + d
    if not dev_iv:
        return None
    dev_iv.sort()
    busy, gaps = 0, []
    cur_s, cur_e = dev_iv[0]
    for s, e in dev_iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s

    def open_span(t):
        inner = [sp for sp in spans if sp[0] <= t <= sp[1]]
        return min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "bench.between_calls"

    named = {}
    for g0, g1 in gaps:
        k = open_span(g0)
        named[k] = named.get(k, 0) + (g1 - g0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    # kernel names are C++ signatures: their head names them
    breakdown = {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
                 "idle_gaps": [[n, v / 1e9] for n, v in idle]}
    return busy / 1e9, window_s, breakdown


def _stderr(line):
    print(line, file=sys.stderr, flush=True)


def _info(obj):
    print(json.dumps(obj), flush=True)


def run_cell(bench, cell, seed, seconds, trace, dev, t_start, session_hook=None,
             control=False) -> dict:
    """Set-up, the window and the check of one cell on `dev`: the result
    line's keys, the earlier line (`info`), and with `control` the numbers
    the control gives on the same answers."""
    import torch

    from . import drivers, kernels, reference

    from stereo_dso_g2o_tpu_torch.runtime import program
    from stereo_dso_g2o_tpu_torch.utils import host

    cfg, traffic, limits = bench.config(cell), bench.traffic(cell), bench.limits(cell)
    metric_entries = bench.metrics(cell, trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in metric_entries}
    session = drivers.make_session(cfg, traffic, seed, dev, bench.dir / "sessions")
    session.setup()
    if session_hook is not None:
        session_hook(session)
    _sync(dev)
    programs_before = len(program.PROGRAMS)
    events = Events(dev) if trace else None
    submitted, completed, call_keys = {}, {}, []
    reads0 = host.READS
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        ts = time.perf_counter()
        if ts - t0 >= seconds:
            break
        keys, done = events.around(session.call) if events else session.call()
        te = time.perf_counter()
        for k in keys:
            submitted[k] = ts
        for k in done:
            completed[k] = te
        call_keys.append(keys)
    t_close = time.perf_counter()
    reads = host.READS - reads0
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    built_in_window = len(program.PROGRAMS) - programs_before

    ctx = {"cell": cell["name"], "setup_s": setup_s, "window_s": t_close - t0,
           "submitted": submitted, "completed": completed, "host_reads": reads,
           "calls": [], "device_window_ms": None, "kernels": {}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        spans = events.spans_ms()
        ctx["device_window_ms"] = events.window_ms()
        prof = _profile_slice(session, dev, PROFILED_CALLS)
        if prof is not None:
            device_info["busy_s"], device_info["window_s"], breakdown = prof

    # the answers: everything submitted in the window is due
    due = list(submitted)
    poses, lost = session.answers()
    windows, drives = session.final_windows(), session.truth()
    wrong_m = float(limits["wrong_frame_m"])
    failed, numbers, shown = reference.drive_checks(poses, lost, windows, drives, due, wrong_m)
    info = {"drive_starts": session.starts, "lost": sorted(map(list, lost)),
            "keyframes": session.keyframes(), "shown": shown,
            "window_points": [len(w[3]["frame"]) for w in windows]}
    controls = reference.drive_control(poses, windows, drives, due, wrong_m) if control else None

    if trace:
        session.label_calls()
        ctx["calls"] = [{"layer": session.layer, "kf": session.is_kf_call(keys), "device_ms": ms}
                        for keys, ms in zip(call_keys, spans)]
        if dev.type == "cuda":
            with kernels.recorded_searches() as calls:
                session.extra_call()
            ctx["kernels"] = kernels.rooflines(calls)

    metrics = {}
    for m in metric_entries:
        v = readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(limits["limits"][k])}
              for k, v in numbers.items()}
    correct = not failed and all(c["value"] <= c["limit"] for c in checks.values())
    info = {"info": "run", "cell": cell["name"], "seed": seed, "setup_s": setup_s,
            "render_s": getattr(session, "render_s", None), "frames_completed": len(completed),
            "calls": len(call_keys), "programs_built_in_window": built_in_window,
            "host_reads": reads, "memory_peak_bytes": int(peak),
            "kernel_launches": _launches(), "kernels": ctx["kernels"],
            "programs": _programs(program), **info}
    result = {"correct": bool(correct), "attempted": len(due), "failed": len(failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "info": info, "controls": controls}


def run(argv=None, *, root=None, device=None, t_start=None, session_hook=None) -> int:
    """One run; returns the exit code. `device` (tests only) skips the look
    for a card; `session_hook(session)` (tests only) may break the timed
    path after set-up."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = Bench(root or Path.cwd())
    cell = bench.cell(args.workload)
    dev, why = _device(int(cell["chips"]), device)
    if dev is None:
        _stderr(f"benchmark: {why}")
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), dev, t_start,
                   session_hook)
    _info(out["info"])
    bad = forbidden_modules()
    if bad:
        _stderr(f"benchmark: modules of the JAX package or JAX were loaded: {', '.join(bad)}")
        return 3
    result = out["result"]
    for k, c in result["checks"].items():
        _stderr(f"check {k} = {c['value']!r} limit {c['limit']!r}")
    _stderr(f"check failed_answers = {result['failed']} limit 0")
    print(json.dumps(result), flush=True)
    return 0


def _launches():
    try:
        from stereo_dso_g2o_tpu_torch.ops import trace_cuda

        return list(trace_cuda.launches())
    except Exception as e:  # the counters are informational
        return repr(e)[:200]


def _programs(program):
    return [{k: r[k] for k in ("name", "capture_s", "nodes", "pool_mib", "replays")}
            for r in program.report()]
