"""Device segmentation (grid k-NN graph + jitted label propagation) vs the
native host twin — same seeds, same metric, same contract."""

import numpy as np
import pytest

from piecewise_icp import native
from piecewise_icp.models.segmentation_device import (
    normals_from_graph, propagate_seeds, supervoxel_propagate_device)
from piecewise_icp.ops.grid_nn import build_grid, grid_self_knn


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("native library could not be built")
    return True


def _surface_cloud(rng, n=4000, extent=(2.0, 1.5)):
    xy = (rng.uniform(size=(n, 2)) * np.array(extent)).astype(np.float32)
    z = (0.15 * np.sin(xy[:, 0] * 3) * np.cos(xy[:, 1] * 2)
         + rng.normal(scale=0.002, size=n))
    return np.column_stack([xy, z]).astype(np.float32)


class TestSeeds:
    def test_count_matches_grid_sample(self, lib_ok, rng):
        pts = _surface_cloud(rng)
        for res in (0.1, 0.23, 0.5):
            seeds = propagate_seeds(pts, res)
            assert len(seeds) == native.grid_sample_count(pts, res)
            assert len(np.unique(seeds)) == len(seeds)

    def test_seed_is_nearest_to_voxel_centre(self, rng):
        pts = rng.uniform(size=(500, 3)).astype(np.float32)
        res = 0.25
        seeds = propagate_seeds(pts, res)
        mn = pts.astype(np.float64).min(0)
        dims = ((pts.astype(np.float64).max(0) - mn) / res).astype(
            np.int64) + 1
        cell = np.clip((pts - mn) / res, 0, dims - 1).astype(np.int64)
        lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        ctr = mn + (cell + 0.5) * res
        d2c = ((pts - ctr) ** 2).sum(1)
        for s in seeds[:50]:
            same = lin == lin[s]
            assert d2c[s] <= d2c[same].min() + 1e-12


def _native_graph(pts, k):
    nbr = native.knn_graph(pts, k)
    return nbr, native.pca_normals(pts, nbr)


class TestDeviceKnnGraph:
    def test_graph_matches_native(self, lib_ok, rng):
        pts = _surface_cloud(rng, n=3000)
        k = 10
        grid = build_grid(pts, 0.08)
        nbr, dist = (np.asarray(a) for a in grid_self_knn(grid, k))
        n = grid.n_real
        # map device (sorted-order) results back to original order
        d_orig = np.empty((n, k), np.float32)
        d_orig[grid.ids[:n]] = dist[:n]
        ref = native.knn_graph(pts, k)
        d2 = ((pts[:, None, :].astype(np.float64)
               - pts[None, :, :].astype(np.float64)) ** 2).sum(-1)
        ref_d = np.sqrt(np.take_along_axis(d2, ref, axis=1))
        np.testing.assert_allclose(d_orig, ref_d, rtol=1e-4, atol=1e-6)


class TestDevicePropagation:
    """The XLA propagation against ``native.supervoxel_propagate`` on the
    SAME graph and normals: the same partition, point for point, up to
    metric near-ties that f32 (device) and the host's mixed precision can
    order differently."""

    @pytest.mark.parametrize("k,svres", [(12, 0.2), (20, 0.12), (8, 0.35)])
    def test_matches_native_on_same_graph(self, lib_ok, rng, k, svres):
        pts = _surface_cloud(rng, n=3500)
        nbr, normals = _native_graph(pts, k)
        lab_h, k_h = native.supervoxel_propagate(pts, normals, nbr,
                                                 resolution=svres)
        lab_d, k_d = supervoxel_propagate_device(pts, normals, nbr, svres)
        assert k_d == k_h
        assert (lab_d == lab_h).mean() > 0.995

    def test_orphans_and_isolated_points(self, lib_ok):
        # a 700-point chain (edges to i-1 and i+1) in ONE voxel, seeded at
        # its far end: the 256-round cap leaves the rest of the chain
        # unlabelled for the orphan sweep, and one point with no edges
        # stays an isolated singleton
        m = 700
        chain = np.column_stack([np.arange(m) * 1e-3, np.zeros(m),
                                 np.zeros(m)])
        pts = np.vstack([chain, [[-1.0, -1.0, -1.0]]]).astype(np.float32)
        i = np.arange(m)
        nbr = np.full((m + 1, 3), -1, np.int32)
        nbr[:m, 0] = i
        nbr[1:m, 1] = i[:-1]
        nbr[:m - 1, 2] = i[1:]
        nbr[m, 0] = m
        normals = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (m + 1, 1))
        lab_h, k_h = native.supervoxel_propagate(pts, normals, nbr,
                                                 resolution=10.0)
        lab_d, k_d = supervoxel_propagate_device(pts, normals, nbr, 10.0)
        assert k_h == 2                     # one supervoxel + the singleton
        assert k_d == k_h
        np.testing.assert_array_equal(lab_d, lab_h)

    def test_padded_seed_slots_are_inert(self, rng):
        import jax.numpy as jnp

        from piecewise_icp.models.segmentation_device import (
            propagate_labels)

        pts = _surface_cloud(rng, n=1500)
        grid = build_grid(pts, 0.08)
        nbr, _ = grid_self_knn(grid, 8)
        p = jnp.asarray(grid.points)
        nrm = normals_from_graph(p, nbr)
        seeds = propagate_seeds(grid.points[:grid.n_real], 0.25)
        padded = np.concatenate([seeds, np.full(64, -1, np.int32)])
        a = np.asarray(propagate_labels(p, nrm, nbr, jnp.asarray(seeds),
                                        jnp.float32(0.4 / 0.25)))
        b = np.asarray(propagate_labels(p, nrm, nbr, jnp.asarray(padded),
                                        jnp.float32(0.4 / 0.25)))
        np.testing.assert_array_equal(a, b)
        assert b[:grid.n_real].max() < len(seeds)
        assert (b[grid.n_real:] == -1).all()      # padding rows unlabelled


class TestDeviceSegmentation:
    def test_matches_host_propagate(self, lib_ok, rng):
        """End to end on the device graph (exact k-NN, device normals) vs
        the host pipeline: same graph up to distance ties, normals equal
        to f32 rounding, so the partitions agree almost everywhere."""
        import jax.numpy as jnp

        pts = _surface_cloud(rng, n=3500)
        res, svres, k = 0.02, 0.2, 12
        grid = build_grid(pts, max(1.2 * np.sqrt(k / np.pi), 3.0) * res)
        nbr_s, _ = grid_self_knn(grid, k)
        n = grid.n_real
        nrm_s = np.asarray(normals_from_graph(jnp.asarray(grid.points),
                                              nbr_s))[:n]
        ids = grid.ids[:n]
        row_of = np.empty(n, np.int64)
        row_of[ids] = np.arange(n)
        nbr_d = np.asarray(ids)[np.asarray(nbr_s)[:n]][row_of]
        nrm_d = nrm_s[row_of]
        lab_d, k_d = supervoxel_propagate_device(pts, nrm_d, nbr_d, svres)
        nbr_h, nrm_h = _native_graph(pts, k)
        lab_h, k_h = native.supervoxel_propagate(pts, nrm_h, nbr_h,
                                                 resolution=svres)
        assert abs(k_d - k_h) <= 2
        agree = (lab_d == lab_h).mean()
        assert agree > 0.97, f"label agreement only {agree:.3f}"

    def test_full_patch_pipeline_device_impl(self, rng):
        from piecewise_icp.config import PiecewiseICPConfig
        from piecewise_icp.models.segmentation import build_patches

        pts = _surface_cloud(rng, n=3000)
        cfg_h = PiecewiseICPConfig(segmentation_impl="native",
                                   knn_normals=12, min_patch_points=10)
        cfg_d = PiecewiseICPConfig(segmentation_impl="jax",
                                   knn_normals=12, min_patch_points=10)
        ps_h = build_patches(pts, 0.2, cfg_h, resolution=0.02)
        ps_d = build_patches(pts, 0.2, cfg_d, resolution=0.02)
        # identical seeding => same patch universe; boundary flips may move
        # patches across the min-size/planarity gates
        assert abs(ps_d.num_patches - ps_h.num_patches) <= 8
        # nearest-centroid matching: the shared patches carry (nearly)
        # identical statistics
        d2 = ((ps_d.centroids[:, None, :] -
               ps_h.centroids[None, :, :]) ** 2).sum(-1)
        j = d2.argmin(1)
        close = d2[np.arange(len(j)), j] < (0.02) ** 2
        assert close.mean() > 0.85
        np.testing.assert_allclose(ps_d.std_bp[close],
                                   ps_h.std_bp[j[close]],
                                   rtol=0.3, atol=5e-4)


class TestFusedSegmentation:
    def test_fused_matches_staged_partition(self, lib_ok, rng):
        """The one-program fused segmentation (normals + propagation +
        patch stats) must produce the SAME supervoxel partition as the
        staged device twin run on the same graph."""
        import jax.numpy as jnp

        from piecewise_icp.config import PiecewiseICPConfig
        from piecewise_icp.models.segmentation_device import (
            segment_patches_device)

        pts = _surface_cloud(rng, n=3000)
        res, svres, k = 0.02, 0.2, 12
        cfg = PiecewiseICPConfig(knn_normals=k, min_patch_points=10)
        ps, nsv_f = segment_patches_device(pts, svres, k, res, cfg)
        grid = build_grid(pts, max(1.2 * np.sqrt(k / np.pi), 3.0) * res)
        nbr_s, _ = grid_self_knn(grid, k)
        n = grid.n_real
        nrm_s = np.asarray(normals_from_graph(jnp.asarray(grid.points),
                                              nbr_s))[:n]
        ids = grid.ids[:n]
        row_of = np.empty(n, np.int64)
        row_of[ids] = np.arange(n)
        nbr = np.asarray(ids)[np.asarray(nbr_s)[:n]][row_of]
        lab_s, nsv_s = supervoxel_propagate_device(pts, nrm_s[row_of], nbr,
                                                   svres)
        assert nsv_f == nsv_s
        # partition equality on points belonging to valid patches: every
        # fused patch maps to exactly one staged supervoxel and vice versa
        sel = ps.labels >= 0
        pairs = set(zip(ps.labels[sel].tolist(), lab_s[sel].tolist()))
        assert len(pairs) == ps.num_patches
        assert len({b for _, b in pairs}) == ps.num_patches
        assert ps.centroids.shape == (ps.num_patches, 3)
        assert np.isfinite(ps.std_bp).all()
        assert (ps.counts >= cfg.min_patch_points).all()


class TestDeviceNormals:
    def test_normals_vs_native(self, lib_ok, rng):
        import jax.numpy as jnp

        pts = _surface_cloud(rng, n=2500)
        k = 10
        grid = build_grid(pts, 0.08)
        nbr_s, _ = grid_self_knn(grid, k)
        n = grid.n_real
        nrm = np.asarray(normals_from_graph(jnp.asarray(grid.points),
                                            nbr_s))[:n]
        nat = native.pca_normals(grid.points[:n], native.knn_graph(
            grid.points[:n], k))
        dots = np.abs((nrm * nat).sum(1))
        assert np.percentile(dots, 50) > 0.9999
        assert np.percentile(dots, 5) > 0.99
