"""Keyframe-cadence audit of an obs file: which term drives each keyframe.

Port of `tools/analyze_kf_decisions.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.analyze_kf_decisions [path=...]

The bench entries archive the two keyframe-decision inputs per frame
(FullSystem.cpp:1127-1152): the weighted flow/affine score `kf_delta` (KF
when > 1) and the (rmse, firstCoarseRMSE) pair (KF when 2*first < rmse).
This reports which term drives each keyframe and how close the stream sits
to the thresholds. `path` is any such file: the port's bench writes
`.cache/torch_bench_obs.jsonl` (the default), the JAX bench
`bench_obs.jsonl`.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from stereo_dso_g2o_tpu_torch.tools._common import cli, emit

KEYS = ("path",)


def main(path=None) -> dict:
    from stereo_dso_g2o_tpu_torch.bench import OBS_DEFAULT

    rows = []
    with open(path or OBS_DEFAULT) as f:
        for line in f:
            r = json.loads(line)
            if "kf_delta" in r:
                rows.append(r)
    if not rows:
        out = {"error": "no per-frame decision records found "
                        "(run the bench entry to write them)"}
        emit(out)
        return out
    delta = np.array([r["kf_delta"] for r in rows])
    rmse = np.array([r["kf_rmse"] for r in rows])
    first = np.array([r["kf_first_rmse"] for r in rows])
    need = np.array([r["need_kf"] for r in rows])

    flow_term = delta > 1.0
    # first_rmse < 0 encodes "not yet set for this reference"
    rmse_term = (2.0 * first < rmse) & (first >= 0)
    out = {
        "n_frames": len(rows),
        "n_kf": int(need.sum()),
        "kf_rate": round(float(need.mean()), 3),
        "kf_by_flow_delta_only": int((need & flow_term & ~rmse_term).sum()),
        "kf_by_rmse_doubling_only": int((need & ~flow_term & rmse_term).sum()),
        "kf_by_both": int((need & flow_term & rmse_term).sum()),
        # threshold proximity: how much of the stream idles near delta=1
        "delta_p50": round(float(np.median(delta)), 3),
        "delta_p90": round(float(np.percentile(delta, 90)), 3),
        "nonkf_delta_in_0p8_1": int(((~need) & (delta > 0.8)).sum()),
        "rmse_ratio_p50": round(float(np.median(rmse / np.maximum(first, 1e-9))), 3),
    }
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "analyze_kf_decisions"))
