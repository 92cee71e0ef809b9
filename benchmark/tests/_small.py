"""A copy of the benchmark at the port's smoke size (its `bench.py small=1`:
256x128, 2 drives' worth of settings), for the CPU tests: the manifest and
`benchmark/` copied into a temporary root beside a link to the port's
package, configurations and traffic cut to run in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PORT = "stereo_dso_g2o_tpu_torch"

SMALL_RIG = {"width": 256, "height": 128, "baseline_m": 0.2}
SMALL_SETTINGS = {"desired_point_density": 600.0, "desired_immature_density": 450.0,
                  "immature_cap": 512, "active_cap": 1024}
SMALL_TRAFFIC = {"step_m": 0.12, "lateral": 6.0, "box_spacing": 5.0}


def edit_json(path: Path, **changes):
    d = json.loads(path.read_text())
    for k, v in changes.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            d[k].update(v)
        else:
            d[k] = v
    path.write_text(json.dumps(d, indent=1))


def small_copy(dest: Path, frames=40, drives=2, boot=12, warm=2) -> Path:
    """The benchmark under `dest` at the smoke size. Returns `dest`."""
    dest = Path(dest)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / PORT).symlink_to(REPO / PORT)
    b = dest / "benchmark"
    for cfg in (b / "configs").glob("*.json"):
        edit_json(cfg, settings=dict(SMALL_SETTINGS), **SMALL_RIG)
    for t in (b / "traffic").glob("*.json"):
        edit_json(t, **SMALL_TRAFFIC)
    edit_json(b / "traffic" / "corridor.json", frames=frames, boot_frames=boot, warm_frames=warm)
    edit_json(b / "traffic" / "corridor_fleet4.json", frames=frames, boot_frames=boot,
              warm_frames=warm, drives=drives)
    return dest
