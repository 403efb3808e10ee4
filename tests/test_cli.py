"""CLI smoke tests — drive __main__.main() in-process on tiny data."""

import os

import numpy as np
import pytest

from piecewise_icp.__main__ import main
from piecewise_icp.io import formats, write_pcd

from test_4d import _make_series
from util import make_pair, small_test_config


class TestCLI:
    def test_pair_subcommand(self, tmp_path, rng):
        params = np.array([0.001, -0.001, 0.001, 0.002, -0.003, 0.002])
        c1, c2, _ = make_pair(rng, params, n_side=60)
        p1, p2 = tmp_path / "a.pcd", tmp_path / "b.pcd"
        write_pcd(p1, c1)
        write_pcd(p2, c2)
        cfg = small_test_config(path1=str(p1), path2=str(p2))
        conf = tmp_path / "conf.txt"
        cfg.to_reference_file(conf)
        rc = main(["pair", "--config", str(conf),
                   "--out", str(tmp_path) + os.sep])
        assert rc == 0
        assert (tmp_path / "TransMatrix.txt").exists()

    def test_pair_subcommand_bad_config(self, tmp_path):
        rc = main(["pair", "--config", "/no/such.txt",
                   "--out", str(tmp_path) + os.sep])
        assert rc == 1

    def test_4d_subcommand_with_flags(self, tmp_path, rng):
        data_dir, gt = _make_series(tmp_path, rng, 3)
        out_dir = tmp_path / "out"
        cfg = small_test_config(path1=str(data_dir),
                                path2=str(out_dir) + os.sep)
        conf = tmp_path / "conf.txt"
        cfg.to_reference_file(conf)
        # NOTE: reference-format config files do not carry this build's
        # extras, so the CLI run uses default pads — exercise defaults here
        rc = main(["4d", "--config", str(conf), "--epochs", "3",
                   "--mode", "0", "--kalman",
                   "--ground-truth",
                   str(tmp_path / "defined_transformations.txt")])
        assert rc == 0
        assert (out_dir / "TransParameters_toRef_smoothed.txt").exists()
        err = formats.read_abs_errors(out_dir / "TransPara_AbsError.txt")
        assert err.shape == (2, 6)
