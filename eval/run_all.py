"""Run every evaluation workload in ONE long-lived process.

One process holds the card for the whole batch (a JAX process reserves
most of the card's memory), so the full evaluation — pairwise benchmark
with both ICP variants, golden 4D runs for the requested pair modes —
executes in a single device session and writes one combined JSON report.

Usage: python eval/run_all.py [--modes 0 -1] [--epochs 20] [--skip-bench]
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


def run_pair_bench(report):
    import dataclasses

    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import formats, read_pcd
    from piecewise_icp.models.pairwise import register_pair
    from piecewise_icp.ops.transform import matrix_to_params_gon

    cfg = PiecewiseICPConfig(
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05, set_dtinit=True,
        dt_init=0.05, dt_min=0.004)
    pts1 = read_pcd(f"{DATA}/Epoch_001.pcd")
    pts2 = read_pcd(f"{DATA}/Epoch_002.pcd")
    _, gt = formats.read_ground_truth_transforms(GT)

    out = {}
    cells = [("reference", {}), ("symmetric", {"icp_variant": "symmetric"})]
    for variant, over in cells:
        c = dataclasses.replace(cfg, **over)
        t0 = time.perf_counter()
        r = register_pair(pts1, pts2, c, sor_mult=cfg.sor_std_mult_4d)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = register_pair(pts1, pts2, c, sor_mult=cfg.sor_std_mult_4d)
        warm = time.perf_counter() - t0
        err = (matrix_to_params_gon(r.trans_mat)
               - matrix_to_params_gon(gt[1]))
        out[variant] = {
            "rot_err_mgon": round(float(np.abs(err[:3]).max() * 1000), 2),
            "trans_err_mm": round(float(np.abs(err[3:]).max() * 1000), 3),
            "warm_s": round(warm, 2), "cold_s": round(cold, 2)}
        print(f"[run_all] pair bench {variant}: {out[variant]}", flush=True)
    report["pair_bench"] = out


def run_mode(report, mode, epochs, kalman=True, icp_variant="reference",
             resume=False):
    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import formats
    from piecewise_icp.models.four_d import run_4d
    from piecewise_icp.ops.transform import matrix_to_params_gon

    tag = f"mode{mode}" + ("" if icp_variant == "reference"
                           else f"_{icp_variant}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           f"results_{tag}/")
    cfg = PiecewiseICPConfig(
        path1=DATA, path2=out_dir,
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05, set_dtinit=True,
        dt_init=0.05, dt_min=0.004, kalman_enabled=kalman,
        icp_variant=icp_variant)
    t0 = time.perf_counter()
    ok = run_4d(cfg, 0, epochs, mode, overlap_thd=0.75, ground_truth=GT,
                resume=resume)
    wall = time.perf_counter() - t0
    entry = {"ok": ok, "wall_s": round(wall, 1),
             "epochs_per_s": round((epochs - 1) / wall, 4)}
    err_file = os.path.join(out_dir, "TransPara_AbsError.txt")
    if os.path.exists(err_file):
        err = formats.read_abs_errors(err_file)
        entry["mean_rot_mgon"] = [round(v, 2) for v in err[:, :3].mean(0)]
        entry["mean_trans_mm"] = [round(v, 3) for v in err[:, 3:].mean(0)]
        entry["max_rot_mgon"] = [round(v, 2) for v in err[:, :3].max(0)]
        entry["max_trans_mm"] = [round(v, 3) for v in err[:, 3:].max(0)]
    smoothed_file = os.path.join(out_dir, "TransPara_AbsError_smoothed.txt")
    if os.path.exists(smoothed_file):
        err_s = formats.read_abs_errors(smoothed_file)
        entry["kalman_smoothed"] = {
            "mean_rot_mgon": [round(v, 2) for v in err_s[:, :3].mean(0)],
            "mean_trans_mm": [round(v, 3) for v in err_s[:, 3:].mean(0)],
            "max_rot_mgon": [round(v, 2) for v in err_s[:, :3].max(0)],
            "max_trans_mm": [round(v, 3) for v in err_s[:, 3:].max(0)]}
    # direct diff vs the reference's chained goldens (adaptive mode only)
    ref_chained = f"{REF}/results/4DPCReg/TransMatrices_toRef.txt"
    ours_chained = os.path.join(out_dir, "TransMatrices_toRef.txt")
    if mode == -1 and os.path.exists(ref_chained) \
            and os.path.exists(ours_chained):
        _, ours_tm, _ = formats.read_trans_matrices(ours_chained, epochs - 1)
        _, ref_tm, _ = formats.read_trans_matrices(ref_chained, epochs - 1)
        diffs = np.array([
            np.abs(matrix_to_params_gon(a) - matrix_to_params_gon(b)) * 1000
            for a, b in zip(ours_tm, ref_tm)])
        entry["vs_reference_transforms"] = {
            "max_rot_mgon": [round(v, 2) for v in diffs[:, :3].max(0)],
            "max_trans_mm": [round(v, 3) for v in diffs[:, 3:].max(0)]}
    report[tag] = entry
    print(f"[run_all] {tag}: {entry}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", type=int, nargs="*", default=[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--variants", nargs="*", default=["reference"])
    ap.add_argument("--matrix", default=None,
                    help="comma-separated mode:variant cells, e.g. "
                         "'0:reference,-1:symmetric' (overrides "
                         "--modes/--variants)")
    ap.add_argument("--scale", type=int, default=0,
                    help="also run the N-epoch scale-demo campaign")
    ap.add_argument("--rockfall", action="store_true",
                    help="also run BASELINE configs 3/4 on the simulated "
                         "rockfall series (eval/rockfall_sim.py)")
    ap.add_argument("--mesh-check", action="store_true",
                    help="verify a 1-device-mesh registration reproduces "
                         "the default path (Pallas under shard_map)")
    ap.add_argument("--resume", action="store_true",
                    help="reuse per-pair npz checkpoints from a previous "
                         "campaign (recompute chaining/smoothing/errors "
                         "only)")
    ap.add_argument("--smoke", action="store_true",
                    help="kernel-equality smoke: register ONE pair and "
                         "diff the transform against eval/smoke_golden."
                         "json (MUST be run after any ops/ or native/ "
                         "commit; ~1 min warm)")
    ap.add_argument("--update-smoke", action="store_true",
                    help="rewrite the smoke golden at the current HEAD")
    args = ap.parse_args()

    from piecewise_icp.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    report = {}
    if args.smoke or args.update_smoke:
        rc = run_smoke(report, update=args.update_smoke)
        _write_report(report)
        return rc
    if not args.skip_bench:
        run_pair_bench(report)
    if args.matrix:
        cells = []
        for c in args.matrix.split(","):
            if not c:
                continue
            parts = c.split(":")
            cells.append((int(parts[0]), parts[1]))
    else:
        cells = [(m, v) for m in args.modes for v in args.variants]
    for mode, variant in cells:
        run_mode(report, mode, args.epochs, icp_variant=variant,
                 resume=args.resume)
    if args.mesh_check:
        # 1-device-mesh pairwise registration must reproduce the default
        # path (validates the kernels under shard_map on the accelerator)
        import jax
        from jax.sharding import Mesh

        from piecewise_icp.config import PiecewiseICPConfig
        from piecewise_icp.io import formats, read_pcd
        from piecewise_icp.models.pairwise import register_pair
        from piecewise_icp.ops.transform import matrix_to_params_gon

        cfg = PiecewiseICPConfig(
            set_res_svsize=True, res1=0.005, res2=0.005,
            svsize1=0.05, svsize2=0.05, set_dtinit=True,
            dt_init=0.05, dt_min=0.004)
        pts1 = read_pcd(f"{DATA}/Epoch_001.pcd")
        pts2 = read_pcd(f"{DATA}/Epoch_002.pcd")
        r0 = register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d)
        mesh = Mesh(np.array(jax.devices()[:1]), ("pt",))
        r1 = register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d,
                           mesh=mesh)
        diff = np.abs(matrix_to_params_gon(r1.trans_mat)
                      - matrix_to_params_gon(r0.trans_mat))
        report["mesh_check"] = {
            "max_rot_diff_mgon": round(float(diff[:3].max() * 1000), 4),
            "max_trans_diff_mm": round(float(diff[3:].max() * 1000), 4)}
        print(f"[run_all] mesh_check: {report['mesh_check']}", flush=True)
    if args.rockfall:
        import rockfall_sim

        report["rockfall"] = rockfall_sim.run()
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "rockfall_report.json"), "w") as f:
            json.dump(report["rockfall"], f, indent=2)
    if args.scale:
        import scale_demo

        scans = os.path.join("/tmp/pwicp_scale", "scans")
        if not os.path.isdir(scans) or len(os.listdir(scans)) < args.scale:
            print(f"[run_all] generating {args.scale}-epoch series",
                  flush=True)
            scale_demo.generate_series("/tmp/pwicp_scale", args.scale)
        from piecewise_icp.config import PiecewiseICPConfig
        from piecewise_icp.io import formats
        from piecewise_icp.models.four_d import run_4d

        out_dir = "/tmp/pwicp_scale/out/"
        gt_file = "/tmp/pwicp_scale/defined_transformations.txt"
        cfg = PiecewiseICPConfig(
            path1=scans, path2=out_dir, set_res_svsize=True,
            res1=0.005, res2=0.005, svsize1=0.05, svsize2=0.05,
            set_dtinit=True, dt_init=0.05, dt_min=0.004,
            epoch_digits=4, kalman_enabled=True)
        # epoch-fleet DP demo: two shards executed sequentially in this
        # one device process; shard 1 finds shard 0's durable per-pair
        # checkpoints on disk and finalises.  Same
        # mechanics as N concurrent hosts on a shared filesystem.
        t0 = time.perf_counter()
        ok0 = run_4d(cfg, 0, args.scale, 1, ground_truth=gt_file,
                     shard_index=0, shard_count=2)
        t_shard0 = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok1 = run_4d(cfg, 0, args.scale, 1, ground_truth=gt_file,
                     shard_index=1, shard_count=2)
        t_shard1 = time.perf_counter() - t0
        wall = t_shard0 + t_shard1
        entry = {"ok": bool(ok0 and ok1), "wall_s": round(wall, 1),
                 "epochs_per_s": round((args.scale - 1) / wall, 4),
                 "shard0_s": round(t_shard0, 1),
                 "shard1_s": round(t_shard1, 1),
                 "fleet": "2 shards sequential + checkpoint finalise"}
        err_file = os.path.join(out_dir, "TransPara_AbsError.txt")
        if os.path.exists(err_file):
            err = formats.read_abs_errors(err_file)
            entry["mean_rot_mgon"] = [round(v, 2)
                                      for v in err[:, :3].mean(0)]
            entry["mean_trans_mm"] = [round(v, 3)
                                      for v in err[:, 3:].mean(0)]
        smoothed = os.path.join(out_dir, "TransPara_AbsError_smoothed.txt")
        if os.path.exists(smoothed):
            err_s = formats.read_abs_errors(smoothed)
            entry["kalman_smoothed_mean_rot_mgon"] = [
                round(v, 2) for v in err_s[:, :3].mean(0)]
        report[f"scale_{args.scale}"] = entry
        print(f"[run_all] scale_{args.scale}: {entry}", flush=True)

    _write_report(report)
    print(json.dumps(report))
    return 0


def _head_commit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=10).stdout.strip()
    except OSError:
        return "unknown"


def _write_report(report: dict) -> None:
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "run_all_report.json")
    # merge into the standing report so partial matrices never clobber
    # previously recorded cells; stamp provenance at every write
    merged = {}
    if os.path.exists(out):
        try:
            with open(out) as f:
                merged = json.load(f)
        except (OSError, ValueError):
            merged = {}
    merged.update(report)
    merged["generated_at"] = {
        "commit": _head_commit(),
        "round": int(os.environ.get("PWICP_ROUND", "5")),
        "note": "stamped automatically by eval/run_all.py at write time",
    }
    with open(out, "w") as f:
        json.dump(merged, f, indent=2)


def run_smoke(report: dict, update: bool = False) -> int:
    """Kernel-equality smoke (VERDICT r4 item 6): ONE warm pair, transform
    diffed against the stored golden.  Cheap enough to run after EVERY
    commit touching ops/ or native/; fails loudly on drift."""
    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import read_pcd
    from piecewise_icp.models.pairwise import register_pair
    from piecewise_icp.ops.transform import matrix_to_params_gon

    cfg = PiecewiseICPConfig(
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05, set_dtinit=True,
        dt_init=0.05, dt_min=0.004)
    pts1 = read_pcd(f"{DATA}/Epoch_001.pcd")
    pts2 = read_pcd(f"{DATA}/Epoch_002.pcd")
    r = register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d)
    params = matrix_to_params_gon(r.trans_mat)
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "smoke_golden.json")
    entry = {"commit": _head_commit(),
             "params_gon_m": [round(float(v), 8) for v in params]}
    if update or not os.path.exists(golden_path):
        with open(golden_path, "w") as f:
            json.dump(entry, f, indent=1)
        report["smoke"] = {**entry, "status": "golden written"}
        print(f"[run_all] smoke golden written: {entry}", flush=True)
        return 0
    with open(golden_path) as f:
        golden = json.load(f)
    diff = np.abs(params - np.array(golden["params_gon_m"]))
    rot_mgon = float(diff[:3].max() * 1000)
    trans_mm = float(diff[3:].max() * 1000)
    ok = rot_mgon < 1.0 and trans_mm < 0.05
    report["smoke"] = {**entry, "vs_golden_commit": golden["commit"],
                       "rot_diff_mgon": round(rot_mgon, 3),
                       "trans_diff_mm": round(trans_mm, 4),
                       "status": "ok" if ok else "DRIFT"}
    print(f"[run_all] smoke: {report['smoke']}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
