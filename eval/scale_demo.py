"""Scaled 4D campaign demo — BASELINE config 5 ("100+ epochs sharded across
hosts, concurrent pairwise jobs").

Generates a synthetic 100+-epoch series by perturbing the reference's
Epoch_001 scan with a random-walk of small rigid transforms (+ fresh noise
per epoch), writes ground truth in the reference format, then runs the 4D
campaign — optionally as one shard of a fleet — and reports accuracy +
throughput.  On a shared filesystem, N hosts each run one shard:

    host k:  python eval/scale_demo.py --epochs 120 --shard k --shards N
    any:     python eval/scale_demo.py --epochs 120 --resume   # finalise

Usage: python eval/scale_demo.py [--epochs 100] [--mode 1]
                                 [--shard I --shards N] [--resume]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_SCAN = ("/root/reference/python/data/data_synthetic/"
            "syntheticPC_with_transformations/Epoch_001.pcd")


def generate_series(out_dir: str, n_epochs: int, seed: int = 0,
                    noise: float = 1.5e-3, downsample: float = 0.0,
                    digits: int = 4) -> str:
    """Write Epoch_0001..N scans + defined_transformations.txt.

    Epoch k is the base scan moved by the inverse of the cumulative
    ground-truth transform G_k (so registration must recover G_k), with
    fresh per-epoch measurement noise so scans are not identical.
    ``downsample`` > 0 voxel-thins the base scan first (lighter series for
    CPU-backend fleet measurements).
    """
    from piecewise_icp.io import read_pcd, write_pcd
    from piecewise_icp.ops.transform import (apply_transform_np,
                                                 params_to_matrix)

    scans = os.path.join(out_dir, "scans")
    os.makedirs(scans, exist_ok=True)
    base = read_pcd(REF_SCAN)
    if downsample > 0:
        from piecewise_icp.ops.preprocess import voxel_downsample
        base = np.asarray(voxel_downsample(base, downsample))
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(1, n_epochs):
        step = params_to_matrix(np.concatenate([
            rng.normal(scale=5e-4, size=3),     # ~30 mgon steps
            rng.normal(scale=4e-3, size=3)]))   # ~4 mm steps
        gt.append(gt[-1] @ step)
    lines = []
    for k in range(n_epochs):
        pts = base + rng.normal(scale=noise, size=base.shape).astype(
            np.float32)
        moved = apply_transform_np(pts.astype(np.float64),
                                   np.linalg.inv(gt[k])).astype(np.float32)
        write_pcd(os.path.join(scans, f"Epoch_{k + 1:0{digits}d}.pcd"),
                  moved)
        lines.append(str(k + 1))
        for row in gt[k]:
            lines.append(" ".join(f"{v:.12f}" for v in row))
    with open(os.path.join(out_dir, "defined_transformations.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return scans


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--mode", type=int, default=1,
                    help="pair mode (default: fixed interval 1)")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workdir", default="/tmp/pwicp_scale")
    args = ap.parse_args()

    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import formats
    from piecewise_icp.models.four_d import run_4d
    from piecewise_icp.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(args.workdir, exist_ok=True)
    scans = os.path.join(args.workdir, "scans")
    if not os.path.isdir(scans) or len(os.listdir(scans)) < args.epochs:
        print(f"generating {args.epochs}-epoch series...", flush=True)
        scans = generate_series(args.workdir, args.epochs)

    out_dir = os.path.join(args.workdir, "out") + os.sep
    cfg = PiecewiseICPConfig(
        path1=scans, path2=out_dir,
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05,
        set_dtinit=True, dt_init=0.05, dt_min=0.004,
        epoch_digits=4, kalman_enabled=True)

    t0 = time.perf_counter()
    ok = run_4d(cfg, 0, args.epochs, args.mode,
                ground_truth=os.path.join(args.workdir,
                                          "defined_transformations.txt"),
                shard_index=args.shard, shard_count=args.shards,
                resume=args.resume)
    wall = time.perf_counter() - t0

    summary = {"epochs": args.epochs, "mode": args.mode, "ok": ok,
               "shard": [args.shard, args.shards],
               "wall_s": round(wall, 1),
               "epochs_per_s": round((args.epochs - 1) / wall, 4)}
    err_file = os.path.join(out_dir, "TransPara_AbsError.txt")
    if os.path.exists(err_file):
        err = formats.read_abs_errors(err_file)
        summary["mean_rot_mgon"] = [round(v, 2) for v in err[:, :3].mean(0)]
        summary["mean_trans_mm"] = [round(v, 3) for v in err[:, 3:].mean(0)]
        summary["max_rot_mgon"] = round(float(err[:, :3].max()), 2)
        summary["max_trans_mm"] = round(float(err[:, 3:].max()), 3)
    print(json.dumps(summary))
    with open(os.path.join(args.workdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
