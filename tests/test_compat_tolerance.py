"""Tolerance-mode (compat="tolerance") vs bit-exact preprocess.

The north-star acceptance window is <1 px BEV / <0.5 deg yaw vs the reference
binaries (BASELINE.json:5) — not bit-exactness.  Tolerance mode swaps the
ground-grid in-order fold for a matmul segment-sum (pctpu/ops/ground.py::
_grid_sums_tolerance) whose sector averages differ from the sequential C++
accumulation by ~1e-5 relative.  These tests demonstrate that across the
differential fuzz regimes the divergence never escapes the window: labels and
both BEV images are pixel-identical to the bit-exact mode.
"""

import numpy as np
import pytest

from pctpu.config import GroundConfig, get_sensor_params
from pctpu.ops.bev import fused_multi_single_bev
from pctpu.ops.ground import (
    _grid_sums_bitexact,
    _grid_sums_tolerance,
    mark_ground,
)
from pctpu.ops.ordering import get_ordered_cloud

from .test_fuzz_differential import REGIMES, _regime_points
from .test_ops_preprocess import SMALL, to_cloud


@pytest.mark.slow
@pytest.mark.parametrize("regime", range(len(REGIMES)))
def test_tolerance_pixel_identical_across_fuzz_regimes(regime):
    """Labels and BEVs from tolerance mode match bit-exact mode exactly on
    every differential fuzz fixture (the ~1e-5 sector-average divergence sits
    far inside the 0.30 m rooftop-veto threshold for these regimes)."""
    n, neg1, z_lo, z_hi, r_lo, r_hi = REGIMES[regime]
    for seed in range(8):
        rng = np.random.default_rng(1000 * regime + seed)
        pts = _regime_points(rng, n, neg1, z_lo, z_hi, r_lo, r_hi, SMALL)
        ordered = get_ordered_cloud(to_cloud(pts), SMALL)
        exact, _ = mark_ground(ordered, SMALL, compat="bitexact")
        tol, _ = mark_ground(ordered, SMALL, compat="tolerance")
        np.testing.assert_array_equal(
            np.asarray(tol.label), np.asarray(exact.label),
            err_msg=f"labels diverge (regime {regime}, seed {seed})",
        )
        em, es = fused_multi_single_bev(exact, SMALL.height_res)
        tm, ts = fused_multi_single_bev(tol, SMALL.height_res)
        np.testing.assert_array_equal(np.asarray(tm), np.asarray(em))
        np.testing.assert_array_equal(np.asarray(ts), np.asarray(es))


def test_tolerance_sector_averages_within_window():
    """The matmul segment-sum reproduces the in-order sector *averages* to
    ~1e-5 relative — the documented tolerance-mode divergence bound."""
    cfg = GroundConfig()
    rng = np.random.default_rng(0)
    p = 20_000
    srow = rng.integers(0, cfg.grid_rows, p).astype(np.int32)
    scol = rng.integers(0, cfg.grid_cols, p).astype(np.int32)
    z = rng.uniform(-2.5, 0.5, p).astype(np.float32)
    ground = rng.random(p) < 0.6
    sector = srow * cfg.grid_cols + scol
    exact = np.asarray(_grid_sums_bitexact(sector, z, ground, cfg))
    tol = np.asarray(_grid_sums_tolerance(srow, scol, z, ground, cfg))
    avg_exact = exact[:, 0] / exact[:, 1]
    avg_tol = tol[:, 0] / tol[:, 1]
    np.testing.assert_allclose(avg_tol, avg_exact, rtol=0, atol=1e-4)
    # counts are integer-valued f32 sums plus the epsilon: exact either way
    np.testing.assert_allclose(tol[:, 1], exact[:, 1], rtol=0, atol=1e-5)


def test_preprocess_batch_tolerance_full_sensor():
    """Full-geometry smoke: preprocess_batch(compat="tolerance") produces
    byte-identical BEVs to bit-exact mode on an HDL_32E-sized cloud."""
    from pctpu.ops.preprocess import preprocess_batch

    params = get_sensor_params("HDL_32E")
    rng = np.random.default_rng(42)
    pts = _regime_points(rng, 600, 0.15, -2.5, 4.0, 2.0, 90.0, params)
    cloud = to_cloud(pts)
    import jax

    batch = jax.tree.map(lambda x: np.asarray(x)[None], cloud)
    le, me, se = preprocess_batch(batch, params, compat="bitexact")
    lt, mt, st = preprocess_batch(batch, params, compat="tolerance")
    np.testing.assert_array_equal(np.asarray(lt.label), np.asarray(le.label))
    np.testing.assert_array_equal(np.asarray(mt), np.asarray(me))
    np.testing.assert_array_equal(np.asarray(st), np.asarray(se))


def test_mark_ground_rejects_unknown_compat():
    pts = _regime_points(np.random.default_rng(0), 5, 0.0, -2.5, 4.0, 2.0,
                         60.0, SMALL)
    ordered = get_ordered_cloud(to_cloud(pts), SMALL)
    with pytest.raises(ValueError, match="compat"):
        mark_ground(ordered, SMALL, compat="fast")


@pytest.mark.slow
def test_run_multi_bev_tolerance_outputs_byte_identical(tmp_path):
    """End-to-end: the flagship pipeline in tolerance mode writes
    byte-identical artifacts to the bit-exact default on a mini KITTI tree
    (CLI flag --compat=tolerance)."""
    import filecmp
    import os

    from tests.fixtures import make_kitti_tree

    from pctpu.pipelines.multi_bev import run_multi_bev
    from pctpu.pipelines.selectors import run_kitti_select

    trees = {}
    for compat in ("bitexact", "tolerance"):
        root = str(tmp_path / compat)
        make_kitti_tree(root, num_frames=3, spacing=3.0)
        run_kitti_select(root, 2.0)
        sel = os.path.join(root, "selected_keyframes_2.00m")
        out = run_multi_bev(sel, "HDL_64E", batch_size=2, write_pngs=False,
                            compat=compat)
        assert out.num_clouds == 3
        trees[compat] = sel
    for sub in ("output_multi_bev/binary", "output_single_bev/csv",
                "non_ground_point_cloud"):
        a = os.path.join(trees["bitexact"], sub)
        b = os.path.join(trees["tolerance"], sub)
        files = sorted(os.listdir(a))
        assert files == sorted(os.listdir(b))
        for f in files:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                               shallow=False), f"{sub}/{f}"
