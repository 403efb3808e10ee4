from .eigh3 import cov3_from_points, eigh3, eigvals3, smallest_eigvec3
from .grid_nn import GridIndex, build_grid, grid_knn, grid_nn1, \
    grid_percentile
from .nn import knn, nn1
from .preprocess import (estimate_resolution, overlap_ratio, percentile_c2c,
                         preprocess_cloud, sor_filter_mask, voxel_downsample)
from . import segment_ops, transform

__all__ = [
    "GridIndex", "build_grid", "grid_knn", "grid_nn1", "grid_percentile",
    "cov3_from_points", "eigh3", "eigvals3", "smallest_eigvec3",
    "knn", "nn1",
    "estimate_resolution", "overlap_ratio", "percentile_c2c",
    "preprocess_cloud", "sor_filter_mask", "voxel_downsample",
    "segment_ops", "transform",
]
