"""Full golden evaluation on the accelerator.

Runs the complete 4D registration of the reference's 20-epoch synthetic
series (all pair modes, the exact workload behind
python/results/4DPCReg/) and compares the chained per-epoch transforms
against BOTH the shipped ground truth and the reference's own golden
errors.  Writes results + timings to eval/results_<mode>/.

Usage:  python eval/golden_eval.py [--mode -1|0|N] [--epochs 20]
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
GOLDEN = f"{REF}/results/4DPCReg/TransPara_AbsError.txt"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", type=int, default=-1,
                    help="pair mode: 0 direct, >0 fixed, <0 adaptive")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--kalman", action="store_true")
    ap.add_argument("--refine", default=None,
                    choices=["always", "auto", "off"])
    ap.add_argument("--out-tag", default=None)
    args = ap.parse_args()

    from piecewise_icp.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import formats
    from piecewise_icp.models.four_d import run_4d

    tag = args.out_tag or f"mode{args.mode}"
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           f"results_{tag}/")
    extra = {}
    if args.refine:
        extra["robust_refine"] = (args.refine if args.refine != "off"
                                  else False)
    cfg = PiecewiseICPConfig(
        path1=DATA, path2=out_dir,
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05,
        set_dtinit=True, dt_init=0.05, dt_min=0.004,
        kalman_enabled=args.kalman, **extra)

    t0 = time.perf_counter()
    ok = run_4d(cfg, start_epoch=0, epoch_num=args.epochs,
                pair_mode=args.mode, overlap_thd=0.75, ground_truth=GT)
    wall = time.perf_counter() - t0

    ours = formats.read_abs_errors(os.path.join(out_dir,
                                                "TransPara_AbsError.txt"))
    summary = {
        "mode": args.mode,
        "epochs": args.epochs,
        "ok": ok,
        "wall_s": round(wall, 1),
        "epochs_per_s": round((args.epochs - 1) / wall, 4),
        "ours_mean_rot_mgon": [round(v, 3) for v in ours[:, :3].mean(0)],
        "ours_max_rot_mgon": [round(v, 3) for v in ours[:, :3].max(0)],
        "ours_mean_trans_mm": [round(v, 4) for v in ours[:, 3:].mean(0)],
        "ours_max_trans_mm": [round(v, 4) for v in ours[:, 3:].max(0)],
    }
    if os.path.exists(GOLDEN) and args.mode == -1:
        golden = formats.read_abs_errors(GOLDEN)
        summary["reference_mean_rot_mgon"] = [
            round(v, 3) for v in golden[:, :3].mean(0)]
        summary["reference_mean_trans_mm"] = [
            round(v, 4) for v in golden[:, 3:].mean(0)]
        summary["reference_max_rot_mgon"] = [
            round(v, 3) for v in golden[:, :3].max(0)]
        summary["reference_max_trans_mm"] = [
            round(v, 4) for v in golden[:, 3:].max(0)]

        # direct transform-vs-transform parity against the reference's own
        # chained results (the strictest comparison)
        ref_chained = f"{REF}/results/4DPCReg/TransMatrices_toRef.txt"
        ours_chained = os.path.join(out_dir, "TransMatrices_toRef.txt")
        if os.path.exists(ref_chained) and os.path.exists(ours_chained):
            from piecewise_icp.ops.transform import matrix_to_params_gon

            n_pairs = args.epochs - 1
            _, ours_tm, _ = formats.read_trans_matrices(ours_chained,
                                                        n_pairs)
            _, ref_tm, _ = formats.read_trans_matrices(ref_chained, n_pairs)
            diffs = np.array([
                np.abs(matrix_to_params_gon(a) - matrix_to_params_gon(b))
                * 1000 for a, b in zip(ours_tm, ref_tm)])
            summary["vs_reference_transforms"] = {
                "mean_rot_mgon": [round(v, 2) for v in diffs[:, :3].mean(0)],
                "max_rot_mgon": [round(v, 2) for v in diffs[:, :3].max(0)],
                "mean_trans_mm": [round(v, 3) for v in diffs[:, 3:].mean(0)],
                "max_trans_mm": [round(v, 3) for v in diffs[:, 3:].max(0)],
            }
    print(json.dumps(summary, indent=2))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
