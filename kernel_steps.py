#!/usr/bin/env python3
"""Time the two epipolar-search kernels of the working tree against those of
another checkout of this repository, on the same lanes, on one NVIDIA GPU.

    SDSO_SAVE_LANES=_checkout/lanes.pt python3 chip_smoke.py
    python3 kernel_steps.py _checkout/lanes.pt [_checkout/parent [report.json]]

The first command writes the lanes `chip_smoke.py` times the kernels on (the
synthetic ones at both image sizes, and the operands of the real launches of
one non-keyframe and one keyframe of the graph path). This script calls the
working tree's wrappers `trace_cuda.epipolar_search` and
`epipolar_search_slab` on every case, the slab kernel also with its band cut
to 4 pixels (every tap from global memory), and, given the root of another
checkout (`git archive <commit> | tar -x -C _checkout/parent`), that
checkout's own two wrappers, loaded from its own `ops/trace_cuda.py`, which
builds its own sources into its own `_build/`. Every output is held to the
working tree's resident kernel (best_idx, best_u/v, energies), then all are
timed with CUDA events (`tools/_common.cuda_ms`: device time), once in the
listed order and once in reverse, the lower of the two kept, and set beside
the bound `ops/trace_cuda.search_bound` gives the case. It prints a table
and writes the report (default: kernel_steps.json beside the lanes file).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import lane_stats  # noqa: E402
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk  # noqa: E402
from stereo_dso_g2o_tpu_torch.tools._common import cuda_ms  # noqa: E402


def other_wrappers(root: Path):
    """The `trace_cuda` module of the checkout at `root`, under a name of
    its own: its kernels build from its csrc/ into its _build/."""
    path = root / "stereo_dso_g2o_tpu_torch" / "ops" / "trace_cuda.py"
    spec = importlib.util.spec_from_file_location("other_trace_cuda", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("kernel_steps: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    saved = torch.load(sys.argv[1], map_location="cuda:0")
    gn = saved["gn"]
    cases = {}
    for group in ("synthetic", "main_path"):
        for name, c in saved[group].items():
            kw = dict(S=c["S"], edge=c["edge"], **gn)
            tensors = [c[k].contiguous() for k in ("dI", "scal", "color", "weights", "patx", "paty")]
            cases[f"{group}: {name}"] = (tensors, kw)

    variants = {
        "K1": tk.epipolar_search,
        "K2": tk.epipolar_search_slab,
        "K2, band of 4 (taps from global memory)":
            lambda *a, **kw: tk.epipolar_search_slab(*a, **kw, band_len=4),
    }
    builds = [tk]
    if len(sys.argv) > 2:
        other = other_wrappers(Path(sys.argv[2]))
        variants["other K1"] = other.epipolar_search
        variants["other K2"] = other.epipolar_search_slab
        builds.append(other)
    for module in builds:
        module.build()  # now, not inside the first timed call
        for log in sorted(module.BUILD_DIR.glob("ptxas_*.log")):
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {'working tree' if module is tk else 'other'} {log.stem}: "
                          f"{line.strip()}")

    report = {"card": smi, "cases": {}}
    for case, (tensors, kw) in cases.items():
        c = {"scal": tensors[1], "S": kw["S"]}
        n_l, zero_share, mean_valid = lane_stats(c)
        bd = tk.search_bound(tensors[0].shape[0], tensors[0].shape[1], c["scal"], c["S"],
                             kw["gn_iters"])
        b_ms, b_by = bd.ms, bd.by
        print(f"\n== {case}: N={n_l}, S={kw['S']}, {100 * zero_share:.1f} % of lanes without a "
              f"valid step, mean valid steps of the rest {mean_valid:.1f}; bound {b_ms:.5f} ms "
              f"by {b_by}")
        want = variants["K1"](*tensors, **kw)
        for name, run in variants.items():
            got = run(*tensors, **kw)
            torch.cuda.synchronize()
            same = got[:, tk.OUT_BEST_IDX] == want[:, tk.OUT_BEST_IDX]
            d = torch.nan_to_num(got[same] - want[same], nan=0.0, posinf=0.0, neginf=0.0)
            rel = d[:, 2:5].abs() / torch.nan_to_num(want[same][:, 2:5], posinf=1.0).abs().clamp(min=1e-6)
            if float(same.float().mean()) < 0.999 or float(d[:, :2].abs().max()) > 1e-3 \
                    or float(rel.max()) > 1e-4:
                raise SystemExit(f"kernel_steps: {name} disagrees with K1 on {case}")
        runs = {name: (lambda r=run: r(*tensors, **kw)) for name, run in variants.items()}
        fwd = {name: cuda_ms(f) for name, f in runs.items()}
        bwd = {name: cuda_ms(runs[name]) for name in reversed(list(runs))}
        row = {name: min(fwd[name], bwd[name]) for name in runs}
        for name, ms in row.items():
            print(f"  {name:45s} {ms:.4f} ms   ({fwd[name]:.4f} / {bwd[name]:.4f})   "
                  f"bound / time {100 * b_ms / ms:.1f} %")
        report["cases"][case] = {"lanes": n_l, "S": kw["S"], "share_without_valid_step": zero_share,
                                 "mean_valid_steps_of_live_lanes": mean_valid,
                                 "bound_ms": b_ms, "bound_by": b_by, "ms": row}
    out = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(sys.argv[1]).with_name("kernel_steps.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"\nwritten {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
