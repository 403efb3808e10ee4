"""Visualization-export tests: colored PCDs parse back correctly."""

import numpy as np

from piecewise_icp.io import read_pcd
from piecewise_icp.utils import viz


class TestVizExports:
    def test_colored_patches_roundtrip(self, tmp_path, rng):
        pts = rng.normal(size=(500, 3)).astype(np.float32)
        labels = rng.integers(-1, 5, size=500).astype(np.int32)
        p = tmp_path / "patches.pcd"
        viz.export_colored_patches(p, pts, labels)
        back = read_pcd(p)  # xyz fields survive the rgb extension
        np.testing.assert_allclose(back, pts, atol=1e-6)

    def test_stable_unstable_colors(self, tmp_path, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        mask = np.zeros(100, dtype=bool)
        mask[:40] = True
        p = tmp_path / "stable.pcd"
        viz.export_stable_unstable(p, pts, mask)
        raw = p.read_bytes()
        assert b"FIELDS x y z rgb" in raw
        # parse the rgb column: stable = orange 0xFF8000
        import io
        hdr_end = raw.index(b"DATA binary\n") + len(b"DATA binary\n")
        rec = np.frombuffer(raw[hdr_end:], dtype=np.dtype(
            {"names": ["x", "y", "z", "rgb"],
             "formats": [np.float32] * 3 + [np.uint32]}), count=100)
        assert (rec["rgb"][:40] == 0xFF8000).all()
        assert (rec["rgb"][40:] == (46 << 16 | 117 << 8 | 181)).all()

    def test_cloud_pair(self, tmp_path, rng):
        t = rng.normal(size=(50, 3)).astype(np.float32)
        s = rng.normal(size=(30, 3)).astype(np.float32)
        p = tmp_path / "pair.pcd"
        viz.export_cloud_pair(p, t, s)
        back = read_pcd(p)
        assert back.shape == (80, 3)


def test_three_clouds_export(tmp_path, rng):
    from piecewise_icp.io import read_pcd
    from piecewise_icp.utils import viz

    t = rng.normal(size=(40, 3)).astype(np.float32)
    s = rng.normal(size=(30, 3)).astype(np.float32)
    r = s + 0.01
    p = tmp_path / "three.pcd"
    viz.export_three_clouds(p, t, s, r)
    pts = read_pcd(str(p))
    assert pts.shape == (100, 3)
    np.testing.assert_allclose(pts[:40], t, atol=1e-6)
    np.testing.assert_allclose(pts[70:], r, atol=1e-6)
