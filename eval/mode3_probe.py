"""Round-5 probe: diagnose the fixed-mode (pairMode 3) per-pair outliers.

VERDICT r4 item 1: mode3 ours-vs-GT mean 13.44 mgon / 0.330 mm vs the
reference's 9.65 / 0.235 — driven by three outlier pairs (7->4: 42.6,
9->6: 38.9, 12->9: 100.9 mgon max).  This probe registers the outlier
pairs plus healthy controls, recording the convergence-quality signals
(sigma0, stable ratio, iterations) and A/B-ing candidate retry levers:

  * ``lattice``  — seed-lattice shift by half a supervoxel (independent
    patch draw: the hard-pair failure is hypothesised to be a stable-set
    draw, so a re-roll should de-correlate it)
  * ``symmetric``— the stage-gated symmetric objective
  * ``slow``     — slower stage-2 decay (decay bounds [0.7, 0.9])

Goal: find a signal that separates bad from good convergence WITHOUT
ground truth, and a lever that fixes the bad pairs, for the acceptance
guard.  Usage: python eval/mode3_probe.py [--json out.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/python"
DATA = f"{REF}/data/data_synthetic/syntheticPC_with_transformations"
GT = f"{REF}/data/data_synthetic/defined_transformations.txt"

BAD_PAIRS = [(12, 9), (7, 4), (9, 6)]
GOOD_PAIRS = [(13, 10), (3, 1)]
ARC_TO_MGON = 1000.0 * 200.0 / np.pi


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--variants", default="base,lattice,symmetric,slow")
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

    def gt_rel(src, tgt):
        return np.linalg.inv(gt[tgt]) @ gt[src]

    def params_of(tm):
        ang = np.asarray(matrix_to_angles(tm), dtype=np.float64)
        return np.concatenate([ang * ARC_TO_MGON, tm[:3, 3] * 1000.0])

    base_cfg = dict(
        path1=DATA, path2="/tmp/probe_out/",
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05,
        set_dtinit=True, dt_init=0.05, dt_min=0.004)

    variants = {
        "base": dict(),
        "lattice": dict(),       # lattice_shift passed at call level
        "symmetric": dict(icp_variant="symmetric"),
        "slow": dict(dt_decay_lo=0.7, dt_decay_hi=0.9),
    }
    chosen = args.variants.split(",")

    results = []
    tgt_cache = {}
    for (src, tgt) in BAD_PAIRS + GOOD_PAIRS:
        c1 = read_pcd(f"{DATA}/Epoch_{tgt:03d}.pcd")
        c2 = read_pcd(f"{DATA}/Epoch_{src:03d}.pcd")
        want = gt_rel(src, tgt)
        for vname in chosen:
            cfg = PiecewiseICPConfig(**{**base_cfg, **variants[vname]})
            off = (np.array([0.025, 0.025, 0.0]) if vname == "lattice"
                   else None)
            t0 = time.perf_counter()
            try:
                key = (tgt, vname if vname == "lattice" else "base")
                if key not in tgt_cache:
                    tgt_cache[key] = prepare_target(
                        c1, cfg, cfg.sor_std_mult_4d, lattice_offset=off)
                out = register_pair(None, c2, cfg,
                                    sor_mult=cfg.sor_std_mult_4d,
                                    target_state=tgt_cache[key],
                                    lattice_offset=off)
                d = np.abs(params_of(out.trans_mat) - params_of(want))
                rec = {
                    "pair": f"{src}->{tgt}", "variant": vname,
                    "rot_err_mgon": round(float(d[:3].max()), 2),
                    "trans_err_mm": round(float(d[3:].max()), 3),
                    "sigma0_mm": round(out.core.sigma0 * 1000.0, 4),
                    "stable_ratio": round(out.core.stable_ratio, 4),
                    "n_stable": out.core.final_n_stable,
                    "n_patches": out.core.num_patches,
                    "iterations": out.core.iterations,
                    "pred_rot_std_mgon": round(float(np.sqrt(
                        np.diag(out.vcm)[:3].max()) * ARC_TO_MGON), 2),
                    "pred_trans_std_mm": round(float(np.sqrt(
                        np.diag(out.vcm)[3:].max()) * 1000.0), 3),
                    "wall_s": round(time.perf_counter() - t0, 1),
                }
            except Exception as e:  # noqa: BLE001
                rec = {"pair": f"{src}->{tgt}", "variant": vname,
                       "error": str(e)}
            print(json.dumps(rec), flush=True)
            results.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
