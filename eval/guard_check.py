"""Round-5 check: change screen + acceptance guard on the hard pairs.

Runs the mode-3 outlier pairs and healthy controls with the DEFAULT
config (screen + guard now on) and prints error vs GT per pair, for
comparison against the r5 base probe (12->9: 100.9 mgon, 7->4: 42.7,
9->6: 38.9; controls 13->10: 6.4, 3->1: 5.7).

Usage: python eval/guard_check.py [--json out.json] [--no-screen]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/python"
DATA = f"{REF}/data/data_synthetic/syntheticPC_with_transformations"
GT = f"{REF}/data/data_synthetic/defined_transformations.txt"
PAIRS = [(12, 9), (7, 4), (9, 6), (13, 10), (3, 1)]
ARC_TO_MGON = 1000.0 * 200.0 / np.pi


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--no-screen", action="store_true")
    ap.add_argument("--no-guard", action="store_true")
    ap.add_argument("--draws", type=int, default=None)
    args = ap.parse_args()

    from piecewise_icp.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import read_pcd
    from piecewise_icp.io.formats import read_ground_truth_transforms
    from piecewise_icp.models.pairwise import prepare_target, register_pair
    from piecewise_icp.ops.transform import matrix_to_angles

    gt_ts, gt_tm = read_ground_truth_transforms(GT)
    gt = dict(zip(gt_ts, gt_tm))

    def params_of(tm):
        ang = np.asarray(matrix_to_angles(tm), dtype=np.float64)
        return np.concatenate([ang * ARC_TO_MGON, tm[:3, 3] * 1000.0])

    cfg = PiecewiseICPConfig(
        path1=DATA, path2="/tmp/probe_out/",
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05,
        set_dtinit=True, dt_init=0.05, dt_min=0.004,
        robust_refine=not args.no_screen,
        guard_enabled=not args.no_guard,
        **({"guard_draws": args.draws} if args.draws else {}))

    results = []
    for (src, tgt) in PAIRS:
        c1 = read_pcd(f"{DATA}/Epoch_{tgt:03d}.pcd")
        c2 = read_pcd(f"{DATA}/Epoch_{src:03d}.pcd")
        want = params_of(np.linalg.inv(gt[tgt]) @ gt[src])
        t0 = time.perf_counter()
        ts = prepare_target(c1, cfg, cfg.sor_std_mult_4d)
        out = register_pair(None, c2, cfg, sor_mult=cfg.sor_std_mult_4d,
                            target_state=ts)
        d = np.abs(params_of(out.trans_mat) - want)
        rec = {"pair": f"{src}->{tgt}",
               "rot_err_mgon": round(float(d[:3].max()), 2),
               "trans_err_mm": round(float(d[3:].max()), 3),
               "stable_ratio": round(out.core.stable_ratio, 3),
               "sigma0_mm": round(out.core.sigma0 * 1000, 4),
               "wall_s": round(time.perf_counter() - t0, 1)}
        print(json.dumps(rec), flush=True)
        results.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
