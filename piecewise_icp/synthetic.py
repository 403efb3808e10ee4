"""Seeded synthetic scan pairs at the reference's synthetic scale.

The reference's ``configuration_4d.txt`` registers scans of an undulating
terrain with planar facets at res 5 mm, SV 5 cm, DTinit 5 cm, DTmin 4 mm
(~176k points per epoch).  Its data is not shipped here, so this module
generates the same kind of scene from a seed: a 2 m x 2 m surface sampled
on a jittered ``n_side`` x ``n_side`` raster (n_side = 420 gives ~176k
points at ~4.8 mm spacing), scanned twice with independent sampling and
noise, the second scan moved by a known rigid transform.
"""

from __future__ import annotations

import os

import numpy as np

# (Rx, Ry, Rz [rad], tx, ty, tz [m]) of the second scan: mgon- and
# mm-scale, like the reference's defined_transformations.txt
PAIR_PARAMS = np.array([0.001, -0.0015, 0.002, 0.004, -0.003, 0.002])


def terrain(rng: np.random.Generator, n_side: int = 100, extent: float = 2.0,
            noise: float = 3e-4) -> np.ndarray:
    """Undulating surface with planar pyramid facets — all 6 DOF observable
    (same family as the reference's synthetic benchmark scenes)."""
    u = np.linspace(0.0, extent, n_side)
    xx, yy = np.meshgrid(u, u)
    xx = xx + rng.normal(scale=extent / n_side / 6, size=xx.shape)
    yy = yy + rng.normal(scale=extent / n_side / 6, size=yy.shape)
    zz = (0.04 * np.sin(2.0 * xx) * np.cos(1.5 * yy)
          + 0.015 * np.sin(3.1 * yy) + 0.05 * xx - 0.03 * yy)
    for cx, cy, amp, w in ((0.5, 0.55, 0.35, 0.42), (1.5, 0.5, 0.3, 0.38),
                           (0.6, 1.5, 0.32, 0.40), (1.45, 1.5, 0.28, 0.36)):
        zz += amp * np.maximum(
            0.0, 1.0 - np.maximum(np.abs(xx - cx), np.abs(yy - cy)) / w)
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    pts += rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def synthetic_pair(seed: int = 0, n_side: int = 420
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(target, source, T) with source = T · (an independent scan of the
    target's surface).  A correct registration of source onto target
    returns inv(T)."""
    from .ops.transform import apply_transform_np, params_to_matrix

    rng = np.random.default_rng(seed)
    t_true = params_to_matrix(PAIR_PARAMS)
    target = terrain(rng, n_side=n_side)
    source = apply_transform_np(terrain(rng, n_side=n_side).astype(
        np.float64), t_true).astype(np.float32)
    return target, source, t_true


def pair_config(path1: str, path2: str):
    """The reference's ``configuration_4d.txt`` values for this scene."""
    from .config import PiecewiseICPConfig

    return PiecewiseICPConfig(path1=path1, path2=path2, set_res_svsize=True,
                              res1=0.005, res2=0.005, svsize1=0.05,
                              svsize2=0.05, set_dtinit=True, dt_init=0.05,
                              dt_min=0.004)


def write_pair(out_dir: str, seed: int = 0, n_side: int = 420
               ) -> tuple[str, np.ndarray]:
    """Write the pair as ``Epoch_001.pcd`` / ``Epoch_002.pcd`` plus the
    11-line configuration; returns (config path, T)."""
    from .io import write_pcd

    os.makedirs(out_dir, exist_ok=True)
    target, source, t_true = synthetic_pair(seed, n_side)
    p1 = os.path.join(out_dir, "Epoch_001.pcd")
    p2 = os.path.join(out_dir, "Epoch_002.pcd")
    write_pcd(p1, target)
    write_pcd(p2, source)
    conf = os.path.join(out_dir, "configuration_pair.txt")
    pair_config(p1, p2).to_reference_file(conf)
    return conf, t_true


def write_series(out_dir: str, n_epochs: int = 6, seed: int = 0,
                 n_side: int = 420) -> str:
    """Write ``scans/Epoch_001..N.pcd`` (independent scans of one surface,
    epoch k moved by inv(G_k) of a random walk of mgon/mm steps) plus the
    ground truth ``defined_transformations.txt`` in the reference format;
    returns the scan folder."""
    from .io import write_pcd
    from .ops.transform import apply_transform_np, params_to_matrix

    rng = np.random.default_rng(seed)
    scans = os.path.join(out_dir, "scans")
    os.makedirs(scans, exist_ok=True)
    gt = [np.eye(4)]
    for _ in range(1, n_epochs):
        step = params_to_matrix(np.concatenate([
            rng.normal(scale=1e-3, size=3), rng.normal(scale=3e-3, size=3)]))
        gt.append(gt[-1] @ step)
    lines = []
    for k in range(n_epochs):
        pts = terrain(rng, n_side=n_side).astype(np.float64)
        write_pcd(os.path.join(scans, f"Epoch_{k + 1:03d}.pcd"),
                  apply_transform_np(pts, np.linalg.inv(gt[k])).astype(
                      np.float32))
        lines.append(str(k + 1))
        lines.extend(" ".join(f"{v:.12f}" for v in row) for row in gt[k])
    with open(os.path.join(out_dir, "defined_transformations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return scans
