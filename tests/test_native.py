"""Tests for the native host runtime: kNN graph + supervoxel segmentation."""

import numpy as np
import pytest

from piecewise_icp import native


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("native library could not be built")
    return True


class TestKnnGraph:
    def test_matches_brute_force(self, lib_ok, rng):
        pts = rng.normal(size=(500, 3)).astype(np.float32)
        k = 8
        idx = native.knn_graph(pts, k)
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        ref = np.argsort(d2, axis=1, kind="stable")[:, :k]
        # self must be first
        np.testing.assert_array_equal(idx[:, 0], np.arange(500))
        # compare by distance (ties may reorder indices)
        got_d = np.take_along_axis(d2, idx, axis=1)
        ref_d = np.take_along_axis(d2, ref, axis=1)
        np.testing.assert_allclose(got_d, ref_d, atol=1e-10)

    def test_clustered_density(self, lib_ok, rng):
        # wildly non-uniform density — grid ring expansion must stay exact
        a = rng.normal(scale=0.01, size=(300, 3))
        b = rng.normal(scale=5.0, size=(200, 3)) + 20.0
        pts = np.vstack([a, b]).astype(np.float32)
        idx = native.knn_graph(pts, 5)
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        ref_d = np.sort(d2, axis=1)[:, :5]
        got_d = np.take_along_axis(d2, idx, axis=1)
        np.testing.assert_allclose(got_d, ref_d, atol=1e-8)

    def test_k_larger_than_cloud(self, lib_ok, rng):
        pts = rng.normal(size=(4, 3)).astype(np.float32)
        idx = native.knn_graph(pts, 6)
        assert (idx[:, :4] >= 0).all()
        assert (idx[:, 4:] == -1).all()


class TestGridSample:
    def test_count_unit_grid(self, lib_ok):
        # 27 points on a 3x3x3 integer lattice, resolution 1.0 → dims are
        # int(len/res)+1 = 3 per axis; every lattice point its own voxel
        g = np.stack(np.meshgrid(*[np.arange(3.0)] * 3),
                     axis=-1).reshape(-1, 3).astype(np.float32)
        assert native.grid_sample_count(g, 1.0) == 27
        assert native.grid_sample_count(g, 10.0) == 1


class TestSupervoxelPropagate:
    """Seeded metric label propagation — the framework's segmenter."""

    @staticmethod
    def _two_plane_cloud(rng, n_side=24):
        """Two perpendicular planes meeting at an edge."""
        u = np.linspace(0, 1, n_side)
        g = np.stack(np.meshgrid(u, u), axis=-1).reshape(-1, 2)
        plane1 = np.column_stack([g[:, 0], g[:, 1], np.zeros(len(g))])
        plane2 = np.column_stack([g[:, 0], np.zeros(len(g)), g[:, 1] + 1e-3])
        pts = np.vstack([plane1, plane2]).astype(np.float32)
        pts += rng.normal(scale=1e-4, size=pts.shape).astype(np.float32)
        n1 = np.tile([0.0, 0.0, 1.0], (len(g), 1))
        n2 = np.tile([0.0, 1.0, 0.0], (len(g), 1))
        normals = np.vstack([n1, n2]).astype(np.float32)
        return pts, normals

    def test_labels_valid_and_spatially_coherent(self, lib_ok, rng):
        pts, normals = self._two_plane_cloud(rng)
        nbr = native.knn_graph(pts, 10)
        labels, nsv = native.supervoxel_propagate(pts, normals, nbr,
                                                  resolution=0.3)
        n = pts.shape[0]
        assert labels.shape == (n,)
        assert labels.min() >= 0
        assert labels.max() < nsv
        assert 2 <= nsv < n
        # supervoxels should respect the normal discontinuity: few labels
        # span both planes
        half = n // 2
        l1 = set(labels[:half].tolist())
        l2 = set(labels[half:].tolist())
        frac_shared = len(l1 & l2) / max(len(l1 | l2), 1)
        assert frac_shared < 0.2

    def test_seed_count_matches_grid_sample(self, lib_ok, rng):
        # seed-per-occupied-voxel => supervoxel count equals GridSample's K
        # (grid_sample.h:49-75 semantics) when no component is orphaned
        pts = rng.uniform(size=(2000, 2)).astype(np.float32)
        z = (0.05 * pts[:, 0]
             + rng.normal(scale=0.002, size=2000)).astype(np.float32)
        cloud = np.column_stack([pts, z]).astype(np.float32)
        nbr = native.knn_graph(cloud, 16)
        normals = native.pca_normals(cloud, nbr)
        labels, nsv = native.supervoxel_propagate(cloud, normals, nbr,
                                                  resolution=0.15)
        assert nsv == native.grid_sample_count(cloud, 0.15)
        assert len(np.unique(labels)) == nsv

    def test_patch_sizes_reasonable(self, lib_ok, rng):
        pts, normals = self._two_plane_cloud(rng, n_side=30)
        nbr = native.knn_graph(pts, 10)
        labels, nsv = native.supervoxel_propagate(pts, normals, nbr,
                                                  resolution=0.25)
        counts = np.bincount(labels, minlength=nsv)
        # average patch should have a sensible number of members
        assert counts.mean() > 5

    def test_deterministic(self, lib_ok, rng):
        pts = rng.uniform(size=(2000, 3)).astype(np.float32)
        nbr = native.knn_graph(pts, 12)
        normals = native.pca_normals(pts, nbr)
        a, ka = native.supervoxel_propagate(pts, normals, nbr, 0.2)
        b, kb = native.supervoxel_propagate(pts, normals, nbr, 0.2)
        assert ka == kb
        np.testing.assert_array_equal(a, b)
