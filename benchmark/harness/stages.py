"""The per-layer metrics read from inside the port's captured programs.

Each program keeps a stage accounting on the device (the port's
`runtime/program.stages()`): per stage its completions (`count`), device
time (`device_ms`, from `%globaltimer` stamps captured in the graph) and,
for a loop, its `trips`. The stats cover every replay since the programs
were built: the warm frames, the window, the profiled calls and the extra
call after it, of which the window is the most by far.

"Frame programs" are the programs that hold the stage `track` (the graph
path's whole-frame program, the batched track program); "keyframe
programs" those that hold `kf` (the whole-frame program, the batched
keyframe subsets). Programs holding neither (the bootstrap's) drop out.

Every reader gives None when the run has no traced calls (`ctx["calls"]`
empty: a run without `--trace`, or on the CPU, where nothing is
captured), when the port keeps no stage accounting, or when no program
of the run holds the stages it reads.
"""

from __future__ import annotations

from typing import Callable, List, Optional


def programs(ctx) -> Optional[List[dict]]:
    """`program.stages()` of the run, or None (module docstring)."""
    if not ctx["calls"]:
        return None
    from stereo_dso_g2o_tpu_torch.runtime import program

    read = getattr(program, "stages", None)
    return read() if read is not None else None


def total(progs: List[dict], stage: str, key: str) -> float:
    """`key` of `stage` summed over the programs that hold it."""
    return sum(p["stages"][stage][key] for p in progs if stage in p["stages"])


def ratio(ctx, among: str, value: Callable[[List[dict]], float],
          per: Callable[[List[dict]], float]) -> Optional[float]:
    """value(progs) / per(progs) over the programs holding stage `among`;
    None where there is nothing to read or `per` is 0."""
    progs = programs(ctx)
    if not progs:
        return None
    held = [p for p in progs if among in p["stages"]]
    if not held:
        return None
    den = per(held)
    return value(held) / den if den else None


def per_frame(ctx, stage: str, key: str) -> Optional[float]:
    """Σ `key` of `stage` over the frame programs, per `track` run."""
    return ratio(ctx, "track", lambda ps: total(ps, stage, key),
                 lambda ps: total(ps, "track", "count"))


def per_keyframe(ctx, stage: str, key: str) -> Optional[float]:
    """Σ `key` of `stage` over the keyframe programs, per `kf` run."""
    return ratio(ctx, "kf", lambda ps: total(ps, stage, key),
                 lambda ps: total(ps, "kf", "count"))


def copy_ms_per_frame(ctx) -> Optional[float]:
    """Σ (`program.call` - `program.replay`) device ms over the frame and
    keyframe programs, per call of the frame programs."""
    progs = programs(ctx)
    if not progs:
        return None
    held = [p for p in progs if "track" in p["stages"] or "kf" in p["stages"]]
    frames = total([p for p in held if "track" in p["stages"]], "program.call", "count")
    if not frames:
        return None
    copies = total(held, "program.call", "device_ms") - total(held, "program.replay", "device_ms")
    return copies / frames
