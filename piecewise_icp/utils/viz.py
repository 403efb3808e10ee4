"""Visualization exports.

The reference pops interactive PCLVisualizer windows (CommonFunc.cpp:456-493,
Segmentation.cpp:164-190) gated by the ``isVisual`` config flag.  Headless
accelerator hosts have no display, so this build exports the same views as
colored PCD files any viewer (CloudCompare, Open3D, ...) opens:

* :func:`export_colored_patches` — each patch in a random color with black
  centroids (the patch-visualization view, Segmentation.cpp:164-190);
* :func:`export_stable_unstable` — stable areas orange, unstable blue
  (the stage-3 classification view, Registration.cpp:937-939);
* :func:`export_cloud_pair` — target black, source red (the pre/post
  registration views, Registration.cpp:299-300, :335-337).
"""

from __future__ import annotations

import pathlib

import numpy as np


def _write_rgb_pcd(path, points: np.ndarray, rgb: np.ndarray) -> None:
    """Write an xyzrgb PCD (binary) with PCL's packed-float RGB field."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    packed = (rgb[:, 0].astype(np.uint32) << 16 \
              | rgb[:, 1].astype(np.uint32) << 8 \
              | rgb[:, 2].astype(np.uint32))
    rec = np.empty(n, dtype=np.dtype(
        {"names": ["x", "y", "z", "rgb"],
         "formats": [np.float32, np.float32, np.float32, np.uint32]}))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["rgb"] = packed
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F U\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def export_colored_patches(path: str | pathlib.Path, points: np.ndarray,
                           labels: np.ndarray, seed: int = 0) -> None:
    """Patch membership as random colors; unassigned points grey."""
    rng = np.random.default_rng(seed)
    n_patches = int(labels.max()) + 1 if labels.size else 0
    palette = rng.integers(30, 250, size=(max(n_patches, 1), 3),
                           dtype=np.uint8)
    rgb = np.full((len(points), 3), 128, dtype=np.uint8)
    assigned = labels >= 0
    rgb[assigned] = palette[labels[assigned]]
    _write_rgb_pcd(path, points, rgb)


def export_stable_unstable(path: str | pathlib.Path, points: np.ndarray,
                           stable_mask: np.ndarray) -> None:
    """Stable areas orange (255,128,0), unstable steel blue (46,117,181) —
    the reference's stage-3 color scheme (Registration.cpp:939)."""
    rgb = np.empty((len(points), 3), dtype=np.uint8)
    rgb[stable_mask] = (255, 128, 0)
    rgb[~stable_mask] = (46, 117, 181)
    _write_rgb_pcd(path, points, rgb)


def export_cloud_pair(path: str | pathlib.Path, target: np.ndarray,
                      source: np.ndarray) -> None:
    """Target black, source red — the two-cloud comparison view."""
    pts = np.vstack([target, source]).astype(np.float32)
    rgb = np.vstack([np.zeros((len(target), 3), np.uint8),
                     np.tile(np.array([255, 0, 0], np.uint8),
                             (len(source), 1))])
    _write_rgb_pcd(path, pts, rgb)


def export_three_clouds(path: str | pathlib.Path, target: np.ndarray,
                        source: np.ndarray,
                        registered: np.ndarray) -> None:
    """Target red, source green, registered source blue — the post-
    registration three-cloud view (visualizeThreePC, CommonFunc.cpp:474-493,
    with the color scheme of its call sites Registration.cpp:336-337,
    :487-488)."""
    pts = np.vstack([target, source, registered]).astype(np.float32)
    rgb = np.vstack([
        np.tile(np.array([255, 0, 0], np.uint8), (len(target), 1)),
        np.tile(np.array([0, 255, 0], np.uint8), (len(source), 1)),
        np.tile(np.array([0, 0, 255], np.uint8), (len(registered), 1))])
    _write_rgb_pcd(path, pts, rgb)
