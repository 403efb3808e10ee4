"""4D (time-series) registration orchestration.

Mirrors ``PiecewiseICP_4D_call`` (Registration.cpp:17-215): scan the epoch
folder, plan registration pairs (direct / fixed-interval / adaptive), run
the pairwise registrations, persist per-pair results as the durable unit of
work (TransMatrices.txt / TransParameters.txt, the reference's
checkpoint-resume grain), chain every epoch to the reference epoch with
rigorous covariance propagation, optionally smooth the trajectory with the
Kalman filter (paper feature, absent from the reference code), and run the
accuracy analysis against ground truth when available.

Pair modes (python/main.py:27-35):
    0   all scans registered directly to the reference epoch
    > 0 fixed interval (register to epoch i+1-pairMode)
    < 0 adaptive interval via overlap-ratio search
"""

from __future__ import annotations

import functools
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import PiecewiseICPConfig
from ..io import formats, read_pcd, scan_epoch_folder
from ..ops.preprocess import overlap_ratio_grid
from ..ops.transform import matrix_to_params_gon
from ..utils.errors import PwICPError
from ..utils.logging import PhaseTimer, log
from .chaining import absolute_errors, chain_to_reference
from .kalman import kalman_smooth_transforms
from .pairwise import prepare_target, register_pair, \
    write_pair_report

def _mode_name(pair_mode: int) -> str:
    if pair_mode == 0:
        return "Direct2Ref_"
    return "Fixed_" if pair_mode > 0 else "Adaptive_"


@functools.lru_cache(maxsize=8)
def _load_cloud_cached(path: str) -> np.ndarray:
    return read_pcd(path)


def adaptive_pair_sequence(file_list: Sequence[str], start_epoch: int,
                           dt_init: float, ratio_thd: float,
                           batch_window: int = 4
                           ) -> Tuple[Dict[int, int], Dict[int, float]]:
    """Adaptive registration-pair planning
    (``calAdaptivePairSequence``, Registration.cpp:552-589).

    For each source epoch j, advance the target from the last chosen target
    until the overlap ratio (fraction of C2C NN distances < DTinit,
    :593-614) exceeds the threshold.  Returns {source: target} in indices
    relative to ``start_epoch`` plus the measured ratios.

    Parallel reformulation (SURVEY §7 step 5): the reference reloads both
    clouds and runs a full sequential NN search per candidate — O(epochs²)
    loads on the campaign's critical path.  Here every epoch is loaded once
    and gridded once (grids are reused across all sources that scan it),
    candidate overlaps are evaluated through the exact grid kernel
    (``overlap_ratio_grid``: bit-identical ratio at ~1% of the arithmetic),
    and each scan step dispatches a whole window of candidates to the
    device before the host blocks — the plan and ratios are identical to
    the sequential scan because candidates are still consumed in order.
    """
    from ..ops.grid_nn import build_grid
    from ..ops.preprocess import overlap_ratio

    pairs: Dict[int, int] = {}
    ratios: Dict[int, float] = {}
    clouds: Dict[int, np.ndarray] = {}
    grids: Dict[int, object] = {}

    def cloud(i: int) -> np.ndarray:
        if i not in clouds:
            clouds[i] = read_pcd(file_list[i])
        return clouds[i]

    def grid_of(i: int):
        # None = dense grid infeasible (DTinit cells too small for the
        # scene extent, e.g. long-range TLS) -> brute overlap for this
        # target; identical ratios either way
        if i not in grids:
            try:
                grids[i] = build_grid(cloud(i), h=dt_init)
            except ValueError:
                grids[i] = None
        return grids[i]

    def eval_overlap(t: int, src):
        g = grid_of(t)
        if g is None:
            return overlap_ratio(jnp.asarray(cloud(t)), src, dt_init)
        return overlap_ratio_grid(g, src, dt_init)

    idx_target = start_epoch
    for j in range(start_epoch + 1, len(file_list)):
        # targets advance monotonically -> earlier epochs never needed again
        for old in [k for k in list(clouds) if k < idx_target]:
            clouds.pop(old, None)
            grids.pop(old, None)
        src = jnp.asarray(cloud(j))
        ratio = 0.0
        i = idx_target
        first_probe = True
        while i < j:
            if first_probe:
                # the previous pair's target usually still passes — probe
                # it alone before fanning out (building windows of grids
                # that get discarded costs compiles and loads)
                window = [i]
                first_probe = False
            else:
                window = list(range(i, min(i + batch_window, j)))
            # dispatch the window asynchronously, then read in order
            pending = [(t, eval_overlap(t, src)) for t in window]
            hit = False
            for t, r in pending:
                ratio = float(r)
                idx_target = t
                if ratio > ratio_thd:
                    hit = True
                    break
            if hit:
                break
            i = window[-1] + 1
        pairs[j - start_epoch] = idx_target - start_epoch
        ratios[j - start_epoch] = ratio
        log.info("adaptive pair: %d -> %d (overlap %.1f%%)",
                 j - start_epoch, idx_target - start_epoch, 100 * ratio)
    return pairs, ratios


def _find_ground_truth(cfg: PiecewiseICPConfig,
                       input_folder: str,
                       explicit: Optional[str]) -> Optional[str]:
    """Resolve the ground-truth transform file (the reference hard-codes
    'data/data_synthetic/defined_transformations.txt',
    Registration.cpp:210)."""
    candidates = []
    if explicit:
        candidates.append(explicit)
    candidates.append("data/data_synthetic/defined_transformations.txt")
    parent = pathlib.Path(input_folder).parent
    candidates.append(str(parent / "defined_transformations.txt"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


def piecewise_icp_4d_call(confile: str, start_epoch: int, epoch_num: int,
                          pair_mode: int, overlap_thd: float = 0.75,
                          ground_truth: Optional[str] = None,
                          shard_index: int = 0, shard_count: int = 1,
                          resume: bool = False, finalize: bool = True,
                          mesh=None, **overrides) -> bool:
    """Drop-in equivalent of the reference C ABI entry
    ``PiecewiseICP_4D_call`` (Registration.h:36)."""
    try:
        cfg = PiecewiseICPConfig.from_reference_file(confile, **overrides)
    except (OSError, ValueError) as e:
        log.error("cannot read configuration file: %s", e)
        return False
    return run_4d(cfg, start_epoch, epoch_num, pair_mode, overlap_thd,
                  ground_truth=ground_truth, shard_index=shard_index,
                  shard_count=shard_count, resume=resume, finalize=finalize,
                  mesh=mesh)


def run_4d(cfg: PiecewiseICPConfig, start_epoch: int, epoch_num: int,
           pair_mode: int, overlap_thd: float = 0.75,
           ground_truth: Optional[str] = None,
           shard_index: int = 0, shard_count: int = 1,
           resume: bool = False, finalize: bool = True,
           mesh=None) -> bool:
    """Run the 4D campaign, optionally as one shard of an epoch fleet.

    Epoch-level data parallelism (new vs the strictly serial reference,
    SURVEY.md §2.4): every pairwise registration is independent given the
    pair plan, so a fleet of hosts splits the pair list into CONTIGUOUS
    ranges (``shard_index``/``shard_count``) over a shared filesystem —
    contiguous rather than round-robin so consecutive pairs inside one
    shard share their epoch preparation (the source of pair k is the
    target of pair k+1 in fixed-stride mode; round-robin re-segmented
    every epoch on two shards, the round-2 2.3x imbalance).  Each
    finished pair is persisted as ``pairs/pair_NNNN.npz`` — the durable
    unit of work — so any shard (or a later ``resume=True`` run) can
    pick up where a crashed one stopped, and whichever invocation sees
    the full set performs the chaining/smoothing/accuracy finalisation.

    ``mesh`` (a ``jax.sharding.Mesh``) runs every pairwise registration
    multi-chip — the two parallelism axes compose: epoch-level DP across
    hosts (this fleet sharding) × point-level sharding across the chips of
    each host's mesh.
    """
    timer = PhaseTimer()
    input_folder, out_folder = cfg.path1, cfg.path2
    os.makedirs(out_folder, exist_ok=True)
    pairs_dir = os.path.join(out_folder, "pairs")
    os.makedirs(pairs_dir, exist_ok=True)

    files, times = scan_epoch_folder(input_folder, cfg.epoch_prefix,
                                     cfg.epoch_digits)
    log.info("%d scan files extracted from %s", len(files), input_folder)
    epoch_num = min(epoch_num, len(files))

    # ---- pair planning (adaptive mode, Registration.cpp:54-61) ----
    reg_pairs: Optional[Dict[int, int]] = None
    pair_file = os.path.join(out_folder, "RegPairFile.txt")
    if pair_mode < 0:
        if resume and os.path.exists(pair_file):
            # the plan depends only on the input scans + DTinit/threshold,
            # so a resumed (or re-registered) campaign reuses the durable
            # plan instead of re-running the O(epochs) overlap search
            reg_pairs = formats.read_reg_pairs(pair_file)
        else:
            with timer.phase("pair_planning"):
                reg_pairs, _ = adaptive_pair_sequence(
                    files[:epoch_num], start_epoch, cfg.dt_init,
                    overlap_thd)
            formats.write_reg_pairs(pair_file, reg_pairs)

    # ---- per-pair registrations (Registration.cpp:89-187) ----
    mode_name = _mode_name(pair_mode)
    n_pairs = max(epoch_num - 1 - start_epoch, 0)
    chunk = -(-n_pairs // max(shard_count, 1))

    def _owner(step: int) -> int:
        """Contiguous-range pair assignment: shard s owns steps
        [s*chunk+1, (s+1)*chunk]."""
        return min((step - 1) // max(chunk, 1), shard_count - 1)

    epoch_states: Dict[int, object] = {}  # epoch idx -> TargetState
    ts_list: List[int] = []
    tm_list: List[Optional[np.ndarray]] = []
    vcm_list: List[Optional[np.ndarray]] = []
    failed: List[int] = []
    missing: List[int] = []

    def _ref_of(i: int) -> int:
        step = i - start_epoch + 1
        if pair_mode > 0:
            return start_epoch if pair_mode >= step else i + 1 - pair_mode
        if pair_mode < 0:
            return start_epoch + reg_pairs[i + 1 - start_epoch]
        return start_epoch

    # one-epoch lookahead: while pair k registers (device-dominated), a
    # single worker thread prepares pair k+1's epoch states — the host
    # side of preprocessing+segmentation (voxel grid, seeds, host kNN,
    # uploads) hides behind the running registration.  Device dispatches
    # from both threads serialize in the runtime of this one process.
    from concurrent.futures import ThreadPoolExecutor
    prefetch_pool = ThreadPoolExecutor(max_workers=1)
    pending: Dict[int, object] = {}

    prev_direct_tm: Optional[np.ndarray] = None
    for i in range(start_epoch, epoch_num - 1):
        step = i - start_epoch + 1
        ref_idx = _ref_of(i)
        ts_list.append(times[i + 1])
        pair_npz = os.path.join(pairs_dir, f"pair_{step:04d}.npz")

        # resume / other-shard pairs come from the durable per-pair files
        if os.path.exists(pair_npz) and (resume
                                         or _owner(step) != shard_index):
            d = np.load(pair_npz)
            tm_list.append(d["tm"])
            vcm_list.append(d["vcm"])
            if bool(d.get("failed", False)):
                failed.append(step)
            else:
                prev_direct_tm = d["tm"]
            continue
        if _owner(step) != shard_index:
            tm_list.append(None)
            vcm_list.append(None)
            missing.append(step)
            continue

        log.info("=== pair %d: epoch %d (target) <- epoch %d (source) ===",
                 step, times[ref_idx], times[i + 1])
        try:
            # each epoch is preprocessed + segmented ONCE (in its own
            # centroid frame) and reused as target and source via pure
            # translation — the reference recomputes both sides per pair
            # (Registration.cpp:402-436)
            for idx in (ref_idx, i + 1):
                if idx not in epoch_states:
                    for old in [k for k in epoch_states if k < ref_idx]:
                        del epoch_states[old]  # targets advance monotonically
                    fut = pending.pop(idx, None)
                    epoch_states[idx] = fut.result() if fut is not None \
                        else prepare_target(
                            _load_cloud_cached(files[idx]), cfg,
                            cfg.sor_std_mult_4d)
            # queue the NEXT owned pair's missing epochs on the worker
            nxt = i + 1
            if nxt < epoch_num - 1 \
                    and _owner(nxt - start_epoch + 1) == shard_index:
                for idx in (_ref_of(nxt), nxt + 1):
                    if idx not in epoch_states and idx not in pending:
                        pending[idx] = prefetch_pool.submit(
                            prepare_target, _load_cloud_cached(files[idx]),
                            cfg, cfg.sor_std_mult_4d)
            # chain warm start for direct-to-reference pairs: epoch i+1
            # sits next to epoch i, so the previous direct estimate is a
            # near-perfect initial guess for a pair whose raw
            # misalignment would otherwise be basin-ambiguous
            t0_init = (prev_direct_tm
                       if pair_mode == 0 and cfg.warm_start_direct
                       else None)
            with timer.phase("pair", step=step):
                result = register_pair(None, None, cfg,
                                       sor_mult=cfg.sor_std_mult_4d,
                                       target_state=epoch_states[ref_idx],
                                       source_state=epoch_states[i + 1],
                                       mesh=mesh,
                                       initial_transform=t0_init)
            tm, vcm, was_failed = result.trans_mat, result.vcm, False
            prev_direct_tm = tm
            prefix = os.path.join(out_folder, f"{times[i + 1]}_{mode_name}")
            write_pair_report(prefix, result)
        except PwICPError as e:
            log.error("step %d failed (%s); skipping to next", step, e)
            failed.append(step)
            # placeholder keeps chaining indices aligned; flagged by the
            # huge variance (reference drops the block instead,
            # Registration.cpp:145-147, which corrupts its chaining read)
            tm, vcm, was_failed = np.eye(4), np.eye(6) * 1e6, True
        tm_list.append(tm)
        vcm_list.append(vcm)
        np.savez(pair_npz, tm=tm, vcm=vcm, failed=was_failed,
                 ts=times[i + 1])

    prefetch_pool.shutdown(wait=True)

    if missing:
        log.info("shard %d/%d: %d pairs done here; %d pairs belong to "
                 "other shards and are not yet on disk — skipping "
                 "finalisation (re-run with resume=True once all shards "
                 "finish)", shard_index, shard_count,
                 sum(t is not None for t in tm_list), len(missing))
        return len(failed) == 0
    if not finalize:
        return len(failed) == 0

    # durable per-pair stream (checkpoint grain)
    formats.write_trans_matrices(os.path.join(out_folder, "TransMatrices.txt"),
                                 ts_list, tm_list, vcm_list)
    with open(os.path.join(out_folder, "TransParameters.txt"), "w") as f:
        f.write(formats.TRANS_PARA_HEADER + "\n")
        for ts, tm, vcm in zip(ts_list, tm_list, vcm_list):
            f.write(formats.format_trans_para_row(
                ts, matrix_to_params_gon(tm), vcm) + "\n")

    # ---- chain to reference epoch (Registration.cpp:192-203) ----
    with timer.phase("chaining"):
        chained_t, chained_v = chain_to_reference(tm_list, vcm_list,
                                                  pair_mode, reg_pairs)
    formats.write_trans_matrices(
        os.path.join(out_folder, "TransMatrices_toRef.txt"),
        ts_list, chained_t, chained_v)
    with open(os.path.join(out_folder, "TransParameters_toRef.txt"), "w") as f:
        f.write(formats.TRANS_PARA_HEADER + "\n")
        for ts, tm, vcm in zip(ts_list, chained_t, chained_v):
            f.write(formats.format_trans_para_row(
                ts, matrix_to_params_gon(tm), vcm) + "\n")

    # ---- Kalman smoothing (paper feature; BASELINE config 4) ----
    smooth = None
    if cfg.kalman_enabled:
        with timer.phase("kalman"):
            smooth = kalman_smooth_transforms(chained_t, chained_v,
                                              cfg.kalman_process_noise)
        formats.write_trans_matrices(
            os.path.join(out_folder, "TransMatrices_toRef_smoothed.txt"),
            ts_list, smooth.trans_mats,
            [c for c in smooth.covariances])
        with open(os.path.join(out_folder,
                               "TransParameters_toRef_smoothed.txt"),
                  "w") as f:
            f.write(formats.TRANS_PARA_HEADER + "\n")
            for ts, tm, vcm in zip(ts_list, smooth.trans_mats,
                                   smooth.covariances):
                f.write(formats.format_trans_para_row(
                    ts, matrix_to_params_gon(tm), vcm) + "\n")

    # ---- accuracy analysis vs ground truth (Registration.cpp:205-211) ----
    gt_path = _find_ground_truth(cfg, input_folder, ground_truth)
    if gt_path:
        _, gt_mats = formats.read_ground_truth_transforms(gt_path)
        gt_slice = gt_mats[start_epoch + 1: start_epoch + 1 + len(chained_t)]
        errors = absolute_errors(chained_t, gt_slice)
        formats.write_abs_errors(
            os.path.join(out_folder, "TransPara_AbsError.txt"), errors)
        log.info("mean abs errors (mgon/mm): %s",
                 np.array2string(errors.mean(axis=0), precision=3))
        if smooth is not None:
            # raw-vs-smoothed measurement (VCM-weighted RTS benefit)
            errors_s = absolute_errors(smooth.trans_mats, gt_slice)
            formats.write_abs_errors(
                os.path.join(out_folder, "TransPara_AbsError_smoothed.txt"),
                errors_s)
            log.info("mean abs errors, smoothed (mgon/mm): %s",
                     np.array2string(errors_s.mean(axis=0), precision=3))

    timer.dump(os.path.join(out_folder, "phase_timings.jsonl"))
    if failed:
        log.warning("failed pairs: %s", failed)
    return len(failed) == 0
