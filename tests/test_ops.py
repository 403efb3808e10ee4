"""Tests for device ops: transforms, eigh3, NN kernels, segment reductions,
preprocessing — each validated against exact numpy brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from piecewise_icp.ops import transform as tf
from piecewise_icp.ops.eigh3 import cov3_from_points, eigh3, eigvals3
from piecewise_icp.ops.nn import knn, nn1
from piecewise_icp.ops import segment_ops as seg
from piecewise_icp.ops.preprocess import (estimate_resolution,
                                              overlap_ratio, percentile_c2c,
                                              preprocess_cloud,
                                              sor_filter_mask,
                                              voxel_downsample)


class TestTransform:
    def test_angles_roundtrip(self, rng):
        for _ in range(20):
            x = np.concatenate([rng.normal(scale=0.3, size=3),
                                rng.normal(scale=2.0, size=3)])
            m = tf.params_to_matrix(x)
            ang = tf.matrix_to_angles(m)
            np.testing.assert_allclose(ang, x[:3], atol=1e-12)
            p = tf.matrix_to_params_gon(m)
            np.testing.assert_allclose(p[3:], x[3:], atol=1e-12)

    def test_angles_roundtrip_large_angles(self, rng):
        # params_to_matrix is the EXACT inverse of matrix_to_angles at any
        # magnitude (it is not a small-angle approximation) — the property
        # the Kalman smoother's matrix reconstruction relies on
        for _ in range(50):
            x = np.concatenate([rng.uniform(-1.4, 1.4, size=3),
                                rng.normal(scale=10.0, size=3)])
            m = tf.params_to_matrix(x)
            np.testing.assert_allclose(tf.matrix_to_angles(m), x[:3],
                                       atol=1e-11)
            # and the matrix is a proper rotation
            R = m[:3, :3]
            np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)

    def test_gimbal_lock_branch(self):
        # ry = -pi/2 makes m20 = 1 exactly
        m = np.eye(4)
        m[:3, :3] = np.array([[0.0, 0.0, -1.0],
                              [0.0, 1.0, 0.0],
                              [1.0, 0.0, 0.0]])
        ang = tf.matrix_to_angles(m)
        assert ang[2] == 0.0
        assert np.isfinite(ang).all()

    def test_adjoint_structure(self, rng):
        x = np.concatenate([rng.normal(scale=0.1, size=3),
                            rng.normal(scale=1.0, size=3)])
        m = tf.params_to_matrix(x)
        ad = tf.adjoint_6x6(m)
        R = m[:3, :3]
        np.testing.assert_allclose(ad[:3, :3], R)
        np.testing.assert_allclose(ad[3:, 3:], R)
        np.testing.assert_allclose(ad[:3, 3:], 0)
        np.testing.assert_allclose(ad[3:, :3], tf.skew(m[:3, 3]) @ R)

    def test_apply_matches_numpy(self, rng):
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        m = tf.params_to_matrix([0.01, -0.02, 0.03, 0.5, -0.1, 0.2])
        a = tf.apply_transform_np(pts, m)
        b = np.asarray(tf.apply_transform(jnp.asarray(pts), jnp.asarray(m)))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_jax_params_to_matrix_matches_host(self):
        x = np.array([0.02, -0.01, 0.05, 1.0, 2.0, -3.0])
        a = tf.params_to_matrix(x)
        b = np.asarray(tf.params_to_matrix_jax(jnp.asarray(x, jnp.float64)))
        np.testing.assert_allclose(a, b, atol=1e-7)

    def test_bb_corner_change(self):
        m = tf.params_to_matrix([0, 0, 0, 1.0, 0, 0])
        bb_min = jnp.array([0.0, 0.0, 0.0])
        bb_max = jnp.array([1.0, 1.0, 1.0])
        chg = tf.bounding_box_corner_change(bb_min, bb_max, jnp.asarray(m))
        assert float(chg) == pytest.approx(1.0, abs=1e-6)


class TestEigh3:
    def test_eigvals_match_numpy(self, rng):
        pts = rng.normal(size=(64, 30, 3))
        cov, _ = cov3_from_points(jnp.asarray(pts))
        vals = np.asarray(eigvals3(cov))
        for i in range(64):
            ref = np.linalg.eigvalsh(np.asarray(cov)[i])[::-1]
            np.testing.assert_allclose(vals[i], ref, rtol=1e-4, atol=1e-7)

    def test_smallest_eigvec_is_plane_normal(self, rng):
        # points on the plane z = 0.3x - 0.2y + noise
        n = 200
        xy = rng.normal(size=(n, 2))
        z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + rng.normal(scale=1e-4, size=n)
        pts = np.column_stack([xy, z])
        cov, _ = cov3_from_points(jnp.asarray(pts)[None])
        vals, vec = eigh3(cov)
        normal = np.asarray(vec[0])
        expected = np.array([-0.3, 0.2, 1.0])
        expected /= np.linalg.norm(expected)
        cosang = abs(np.dot(normal, expected))
        assert cosang > 0.99999

    def test_degenerate_isotropic(self):
        cov = jnp.eye(3)[None] * 2.0
        vals, vec = eigh3(cov)
        np.testing.assert_allclose(np.asarray(vals[0]), [2, 2, 2], atol=1e-6)
        assert np.isfinite(np.asarray(vec)).all()

    def test_masked_cov(self, rng):
        pts = rng.normal(size=(1, 50, 3))
        mask = np.zeros((1, 50), dtype=bool)
        mask[0, :30] = True
        cov_m, mean_m = cov3_from_points(jnp.asarray(pts), jnp.asarray(mask))
        cov_r, mean_r = cov3_from_points(jnp.asarray(pts[:, :30]))
        np.testing.assert_allclose(np.asarray(cov_m), np.asarray(cov_r),
                                   rtol=1e-5, atol=1e-7)


def _brute_nn(q, t):
    d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1), np.sqrt(d2.min(1))


class TestNN:
    def test_nn1_matches_brute(self, rng):
        q = rng.normal(size=(300, 3)).astype(np.float32)
        t = rng.normal(size=(500, 3)).astype(np.float32)
        idx, dist = nn1(jnp.asarray(q), jnp.asarray(t), q_tile=64, t_tile=128)
        ridx, rdist = _brute_nn(q, t)
        np.testing.assert_array_equal(np.asarray(idx), ridx)
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-5)

    def test_nn1_masks(self, rng):
        q = rng.normal(size=(100, 3)).astype(np.float32)
        t = rng.normal(size=(200, 3)).astype(np.float32)
        t_mask = np.zeros(200, dtype=bool)
        t_mask[:50] = True
        q_mask = np.ones(100, dtype=bool)
        q_mask[10:20] = False
        idx, dist = nn1(jnp.asarray(q), jnp.asarray(t),
                        jnp.asarray(q_mask), jnp.asarray(t_mask),
                        q_tile=32, t_tile=64)
        ridx, rdist = _brute_nn(q, t[:50])
        valid = q_mask
        np.testing.assert_array_equal(np.asarray(idx)[valid], ridx[valid])
        assert np.isinf(np.asarray(dist)[~valid]).all()
        assert (np.asarray(idx) < 50).all()

    def test_knn_matches_brute(self, rng):
        q = rng.normal(size=(120, 3)).astype(np.float32)
        t = rng.normal(size=(400, 3)).astype(np.float32)
        k = 7
        idx, dist = knn(jnp.asarray(q), jnp.asarray(t), k,
                        q_tile=32, t_tile=64)
        d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
        ref_idx = np.argsort(d2, axis=1)[:, :k]
        ref_d = np.sqrt(np.take_along_axis(d2, ref_idx, axis=1))
        np.testing.assert_allclose(np.asarray(dist), ref_d, atol=1e-5)
        # indices may differ on exact ties; compare via distances
        got_d = np.sqrt(np.take_along_axis(d2, np.asarray(idx), axis=1))
        np.testing.assert_allclose(got_d, ref_d, atol=1e-5)

    def test_knn_self_query_includes_self(self, rng):
        pts = rng.normal(size=(64, 3)).astype(np.float32)
        idx, dist = knn(jnp.asarray(pts), jnp.asarray(pts), 3,
                        q_tile=32, t_tile=32)
        np.testing.assert_array_equal(np.asarray(idx)[:, 0], np.arange(64))
        np.testing.assert_allclose(np.asarray(dist)[:, 0], 0.0, atol=1e-6)

    def test_nn1_large_coordinates_precision(self, rng):
        # mm-scale separations on clouds offset by tens of metres — the
        # regime where the matmul distance identity fails in f32
        base = rng.normal(scale=30.0, size=(500, 3)).astype(np.float32)
        q = base + rng.normal(scale=0.002, size=(500, 3)).astype(np.float32)
        idx, dist = nn1(jnp.asarray(q), jnp.asarray(base))
        d_exact = np.linalg.norm(
            q.astype(np.float64) - base[np.asarray(idx)], axis=1)
        np.testing.assert_allclose(np.asarray(dist), d_exact,
                                   rtol=1e-3, atol=2e-6)


class TestSegmentOps:
    def test_mean_and_count(self, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        labels = rng.integers(0, 5, size=100).astype(np.int32)
        labels[:10] = -1  # dropped
        mean = np.asarray(seg.segment_mean(jnp.asarray(pts),
                                           jnp.asarray(labels), 5))
        cnt = np.asarray(seg.segment_count(jnp.asarray(labels), 5))
        for s in range(5):
            m = labels == s
            assert cnt[s] == m.sum()
            np.testing.assert_allclose(mean[s], pts[m].mean(0), rtol=1e-5)

    def test_argmax_argmin(self, rng):
        vals = rng.normal(size=(200,)).astype(np.float32)
        labels = rng.integers(0, 8, size=200).astype(np.int32)
        amax = np.asarray(seg.segment_argmax(jnp.asarray(vals),
                                             jnp.asarray(labels), 8))
        amin = np.asarray(seg.segment_argmin(jnp.asarray(vals),
                                             jnp.asarray(labels), 8))
        for s in range(8):
            m = np.where(labels == s)[0]
            if len(m):
                assert vals[amax[s]] == vals[m].max()
                assert vals[amin[s]] == vals[m].min()

    def test_cov3(self, rng):
        pts = rng.normal(size=(300, 3)).astype(np.float32)
        labels = rng.integers(0, 4, size=300).astype(np.int32)
        cov, mean, cnt = seg.segment_cov3(jnp.asarray(pts),
                                          jnp.asarray(labels), 4)
        for s in range(4):
            sel = pts[labels == s]
            ref = np.cov(sel.T, bias=True)
            np.testing.assert_allclose(np.asarray(cov)[s], ref,
                                       rtol=1e-4, atol=1e-6)


class TestPreprocess:
    def test_voxel_downsample_centroids(self):
        pts = np.array([[0.1, 0.1, 0.1], [0.3, 0.3, 0.3],  # same voxel @0.5
                        [1.1, 0.0, 0.0]], dtype=np.float32)
        out = voxel_downsample(pts, 0.5)
        assert out.shape == (2, 3)
        np.testing.assert_allclose(out[0], [0.2, 0.2, 0.2], atol=1e-6)
        np.testing.assert_allclose(out[1], [1.1, 0.0, 0.0], atol=1e-6)

    def test_voxel_downsample_reduces(self, rng):
        pts = rng.normal(size=(5000, 3)).astype(np.float32)
        out = voxel_downsample(pts, 0.5)
        assert 0 < out.shape[0] < 5000

    def test_sor_removes_outlier(self, rng):
        pts = rng.normal(scale=0.1, size=(500, 3)).astype(np.float32)
        pts[0] = [50.0, 50.0, 50.0]  # blatant outlier
        keep = np.asarray(sor_filter_mask(jnp.asarray(pts), None, k=10,
                                          std_mult=2.0))
        assert not keep[0]
        assert keep[1:].mean() > 0.9

    def test_resolution(self):
        # regular grid spacing 0.1
        g = np.stack(np.meshgrid(*[np.arange(5) * 0.1] * 3),
                     axis=-1).reshape(-1, 3).astype(np.float32)
        res = estimate_resolution(jnp.asarray(g))
        assert res == pytest.approx(0.1, rel=1e-4)

    def test_percentile_matches_reference_semantics(self, rng):
        t = rng.normal(size=(200, 3)).astype(np.float32)
        s = rng.normal(size=(150, 3)).astype(np.float32)
        p = float(percentile_c2c(jnp.asarray(t), jnp.asarray(s), 0.75))
        _, d = _brute_nn(s, t)
        ref = np.sort(d)[int(150 * 0.75)]
        assert p == pytest.approx(ref, rel=1e-5)

    def test_overlap_ratio(self, rng):
        t = rng.uniform(size=(500, 3)).astype(np.float32)
        s_in = t[:300] + rng.normal(scale=1e-4, size=(300, 3)).astype(np.float32)
        s_out = (t[:200] + 10.0).astype(np.float32)
        s = np.vstack([s_in, s_out])
        r = float(overlap_ratio(jnp.asarray(t), jnp.asarray(s), 0.05))
        assert r == pytest.approx(0.6, abs=0.01)

    def test_overlap_ratio_grid_matches_brute(self, rng):
        from piecewise_icp.ops.grid_nn import build_grid
        from piecewise_icp.ops.preprocess import overlap_ratio_grid

        t = rng.uniform(size=(800, 3)).astype(np.float32) * 2.0
        s = (t[:500] + rng.normal(scale=0.03, size=(500, 3))
             .astype(np.float32))
        s = np.vstack([s, (t[:100] + 5.0).astype(np.float32)])
        for dt in (0.02, 0.05, 0.15):
            brute = float(overlap_ratio(jnp.asarray(t), jnp.asarray(s), dt))
            grid = build_grid(t, h=dt)
            fast = float(overlap_ratio_grid(grid, jnp.asarray(s), dt))
            assert fast == pytest.approx(brute, abs=1e-7), dt

    def test_native_sor_matches_device_stat(self, rng):
        pytest.importorskip("piecewise_icp.native")
        from piecewise_icp import native
        from piecewise_icp.ops.nn import knn as brute_knn

        if not native.available():
            pytest.skip("native lib unavailable")
        pts = rng.normal(size=(3000, 3)).astype(np.float32)
        k = 14
        mean_native = native.sor_mean_dist(pts, k)
        _, d = brute_knn(jnp.asarray(pts), jnp.asarray(pts), k + 1)
        mean_dev = np.asarray(d)[:, 1:].mean(axis=1)
        np.testing.assert_allclose(mean_native, mean_dev, rtol=2e-5,
                                   atol=1e-7)

    def test_device_sor_mask_matches_native(self, rng):
        """The device SOR (exact grid k-NN with straggler fallback, one
        threshold program) must reproduce the native OpenMP statistic's
        keep decision exactly."""
        pytest.importorskip("piecewise_icp.native")
        from piecewise_icp import native
        from piecewise_icp.ops.preprocess import sor_filter_mask

        if not native.available():
            pytest.skip("native lib unavailable")
        from util import terrain_cloud

        pts = terrain_cloud(rng, n_side=70)          # ~4.9k surface points
        # salt with far outliers that SOR must drop
        out = rng.uniform(low=-1.0, high=3.0, size=(24, 3)).astype(
            np.float32)
        out[:, 2] += 5.0
        pts = np.vstack([pts, out])
        assert len(pts) > 4096                       # the grid path
        res = 0.033
        k, mult = 14, 2.7
        keep_dev = np.asarray(sor_filter_mask(jnp.asarray(pts), None, k=k,
                                              std_mult=mult, resolution=res))
        mean_native = native.sor_mean_dist(pts, k).astype(np.float64)
        mu = mean_native.mean()
        var = ((mean_native - mu) ** 2).sum() / max(len(mean_native) - 1, 1)
        keep_native = mean_native <= mu + mult * np.sqrt(var)
        assert keep_native.sum() < len(pts)          # outliers removed
        np.testing.assert_array_equal(keep_dev, keep_native)

    def test_preprocess_pipeline_runs(self, rng):
        pts = rng.normal(scale=1.0, size=(2000, 3)).astype(np.float32)
        out = preprocess_cloud(pts, 0.1, sor_k=10, sor_mult=2.7)
        assert out.shape[0] > 100
        assert out.shape[1] == 3
