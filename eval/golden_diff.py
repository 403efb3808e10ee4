"""Per-pair golden diff vs the reference's shipped results.

The reference ships 19 per-pair transform files per mode in
``python/results/4DPCReg/`` (``<ts>_{Adaptive,Fixed,Direct2Ref}_TransMatrix.txt``,
written by Registration.cpp:528-545).  Round 1 only diffed the *chained*
transforms; this tool compares pair-by-pair, attributing deviation per pair:

  * ours vs reference golden  (the parity target: <1 mm / ~1.1 mgon)
  * ours vs ground truth      (is our estimate actually wrong?)
  * reference vs ground truth (or is the reference's?)

For adaptive mode the reference's RegPairFile.txt is not shipped; the
target epoch of each golden pair is inferred by matching the golden
transform against every candidate GT relative transform
T_rel = GT_i · GT_j^-1 (deviations are ~mgon; plans differ by ~0.5 gon —
unambiguous).

Usage: python eval/golden_diff.py [--results-root eval] [--json out.json]
Host-only (numpy); no accelerator needed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from piecewise_icp.io.formats import (  # noqa: E402
    read_ground_truth_transforms,
    read_reg_pairs,
    read_trans_matrix_report,
)
from piecewise_icp.ops.transform import matrix_to_angles  # noqa: E402

REF_DIR = pathlib.Path("/root/reference/python/results/4DPCReg")
GT_PATH = pathlib.Path(
    "/root/reference/python/data/data_synthetic/defined_transformations.txt")

MODES = {  # mode id -> (results dir suffix, per-pair file tag)
    "-1": ("results_mode-1", "Adaptive"),
    "-1p": ("results_mode-1_propagate", "Adaptive"),
    "1": ("results_mode1", "Fixed"),
    "3": ("results_mode3", "Fixed"),
    "0": ("results_mode0", "Direct2Ref"),
}

# The reference's shipped "Fixed" goldens were produced with pairMode=3
# (stride 3, early sources clamped to the reference epoch) — verified by
# matching each golden transform against all candidate GT relative
# transforms (best target = max(1, src-3) for every file, errors ~10-40
# mgon vs >300 mgon for every other candidate).
REF_FIXED_STRIDE = 3

ARC_TO_MGON = 1000.0 * 200.0 / np.pi


def params_of(tm: np.ndarray) -> np.ndarray:
    """[Rx,Ry,Rz] in mgon + [tx,ty,tz] in mm, reference angle convention."""
    ang = np.asarray(matrix_to_angles(tm), dtype=np.float64)
    return np.concatenate([ang * ARC_TO_MGON, tm[:3, 3] * 1000.0])


def param_diff(tm_a: np.ndarray, tm_b: np.ndarray) -> np.ndarray:
    """Per-parameter |diff| of two transforms (mgon / mm)."""
    return np.abs(params_of(tm_a) - params_of(tm_b))


def gt_relative(gt: dict, src: int, tgt: int) -> np.ndarray:
    """GT transform registering epoch ``src`` onto epoch ``tgt``.

    ``defined_transformations.txt`` gives GT_j mapping cloud_j back to the
    reference frame (cloud_1 = GT_j(cloud_j)), so the transform registering
    src onto tgt is GT_tgt^-1 · GT_src (GT_1 = identity — pair (2,1) is
    GT_2 itself, matching the shipped golden).  GT matrices are linearized
    rotations (I + skew); invert numerically.
    """
    return np.linalg.inv(gt[tgt]) @ gt[src]


def infer_ref_plan(ref_mats: dict, gt: dict) -> dict:
    """Infer the reference's adaptive target epoch per source epoch."""
    plan = {}
    for src, tm in ref_mats.items():
        best, best_err = None, np.inf
        for tgt in gt:
            if tgt >= src:
                continue
            err = np.max(param_diff(tm, gt_relative(gt, src, tgt)))
            if err < best_err:
                best, best_err = tgt, err
        plan[src] = best
    return plan


def load_pair_files(directory: pathlib.Path, tag: str) -> dict:
    out = {}
    for f in directory.glob(f"*_{tag}_TransMatrix.txt"):
        ts = int(f.name.split("_")[0])
        out[ts] = read_trans_matrix_report(f)["trans_mat"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-root", default=str(pathlib.Path(__file__).parent))
    ap.add_argument("--json", default=None)
    ap.add_argument("--modes", default="-1,1,0")
    args = ap.parse_args()
    root = pathlib.Path(args.results_root)

    gt_ts, gt_tm = read_ground_truth_transforms(GT_PATH)
    gt = dict(zip(gt_ts, gt_tm))

    report = {}
    for mode in args.modes.split(","):
        subdir, tag = MODES[mode]
        ours_dir = root / subdir
        if not ours_dir.exists():
            print(f"[mode {mode}] {ours_dir} missing — skipped")
            continue
        ref_mats = load_pair_files(REF_DIR, tag)
        our_mats = load_pair_files(ours_dir, tag)

        if tag == "Adaptive":
            ref_plan = infer_ref_plan(ref_mats, gt)
            our_plan = read_reg_pairs(ours_dir / "RegPairFile.txt")
            # our RegPairFile uses 0-based epoch indices; timestamps are 1-based
            our_plan = {s + 1: t + 1 for s, t in our_plan.items()}
        elif tag == "Fixed":
            ref_plan = {ts: max(1, ts - REF_FIXED_STRIDE) for ts in ref_mats}
            stride = int(mode)
            our_plan = {ts: max(1, ts - stride) for ts in ref_mats}
        else:
            ref_plan = {ts: 1 for ts in ref_mats}
            our_plan = dict(ref_plan)

        rows = []
        hdr = (f"{'src':>4} {'tgt(ref/ours)':>13} | "
               f"{'ours-vs-ref maxR':>16} {'maxT':>6} | "
               f"{'ours-vs-GT maxR':>15} {'maxT':>6} | "
               f"{'ref-vs-GT maxR':>14} {'maxT':>6}")
        print(f"\n=== mode {mode} ({tag}) ===  [mgon / mm]")
        print(hdr)
        for src in sorted(ref_mats):
            rt, ot = ref_plan.get(src), our_plan.get(src)
            row = {"src": src, "ref_tgt": rt, "our_tgt": ot,
                   "plan_match": rt == ot}
            if src in our_mats:
                d_gt_ref = param_diff(ref_mats[src], gt_relative(gt, src, rt))
                row["ref_vs_gt"] = d_gt_ref.tolist()
                d_gt_our = param_diff(our_mats[src], gt_relative(gt, src, ot))
                row["ours_vs_gt"] = d_gt_our.tolist()
                if rt == ot:
                    d = param_diff(our_mats[src], ref_mats[src])
                    row["ours_vs_ref"] = d.tolist()
                    print(f"{src:>4} {rt!s:>6}/{ot!s:<6} | "
                          f"{d[:3].max():16.2f} {d[3:].max():6.3f} | "
                          f"{d_gt_our[:3].max():15.2f} {d_gt_our[3:].max():6.3f} | "
                          f"{d_gt_ref[:3].max():14.2f} {d_gt_ref[3:].max():6.3f}")
                else:
                    print(f"{src:>4} {rt!s:>6}/{ot!s:<6} | "
                          f"{'PLAN-MISMATCH':>23} | "
                          f"{d_gt_our[:3].max():15.2f} {d_gt_our[3:].max():6.3f} | "
                          f"{d_gt_ref[:3].max():14.2f} {d_gt_ref[3:].max():6.3f}")
            else:
                print(f"{src:>4} {rt!s:>6}/{ot!s:<6} | ours missing")
            rows.append(row)

        matched = [r for r in rows if r.get("ours_vs_ref")]
        summary = {}
        if matched:
            arr = np.array([r["ours_vs_ref"] for r in matched])
            summary = {
                "n_matched_pairs": len(matched),
                "n_plan_mismatch": sum(1 for r in rows if not r["plan_match"]),
                "max_rot_mgon": float(arr[:, :3].max()),
                "mean_rot_mgon": float(arr[:, :3].mean()),
                "max_trans_mm": float(arr[:, 3:].max()),
                "mean_trans_mm": float(arr[:, 3:].mean()),
            }
            garr = np.array([r["ours_vs_gt"] for r in rows if "ours_vs_gt" in r])
            rarr = np.array([r["ref_vs_gt"] for r in rows if "ref_vs_gt" in r])
            summary["ours_vs_gt_mean_rot_mgon"] = float(garr[:, :3].mean())
            summary["ref_vs_gt_mean_rot_mgon"] = float(rarr[:, :3].mean())
            summary["ours_vs_gt_mean_trans_mm"] = float(garr[:, 3:].mean())
            summary["ref_vs_gt_mean_trans_mm"] = float(rarr[:, 3:].mean())
            print(f"summary: ours-vs-ref max {summary['max_rot_mgon']:.2f} mgon"
                  f" / {summary['max_trans_mm']:.3f} mm over "
                  f"{len(matched)} matched pairs"
                  f" ({summary['n_plan_mismatch']} plan mismatches)")
            print(f"         mean rot vs GT: ours "
                  f"{summary['ours_vs_gt_mean_rot_mgon']:.2f}, ref "
                  f"{summary['ref_vs_gt_mean_rot_mgon']:.2f} mgon; "
                  f"mean trans vs GT: ours "
                  f"{summary['ours_vs_gt_mean_trans_mm']:.3f}, ref "
                  f"{summary['ref_vs_gt_mean_trans_mm']:.3f} mm")
        report[f"mode{mode}"] = {"pairs": rows, "summary": summary}

    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(report, indent=1))
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
