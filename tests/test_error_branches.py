"""Small guard/error/fallback branches surfaced by the line-coverage sweep
(tests/covtrace.py): config validation raises, cloud helper utilities,
loader edge contracts, and the non-default preprocess/NN branches."""

import os

import numpy as np
import pytest


def test_parse_sensor_type_unknown_raises():
    from pctpu.config import parse_sensor_type

    with pytest.raises(ValueError, match="Unknown sensor type"):
        parse_sensor_type("VLP_16")


def test_ground_config_rejects_non_pow2_cell():
    from pctpu.config import GroundConfig

    with pytest.raises(ValueError, match="power of two"):
        GroundConfig(cell_size=3.0)


def test_bev_configs_reject_non_pow2_height_scale():
    from pctpu.config import SingleBevConfig

    with pytest.raises(ValueError, match="power of two"):
        SingleBevConfig(height_scale=3.0)


def test_make_cloud_rejects_bad_shapes():
    from pctpu.cloud import make_cloud

    xyz = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError, match="exceed capacity"):
        make_cloud(xyz, capacity=3)
    with pytest.raises(ValueError, match="field length"):
        make_cloud(xyz, intensity=np.zeros(4, np.float32))


def test_cloud_helpers_round_trip():
    from pctpu.cloud import empty_cloud, make_cloud, stack_clouds, to_numpy

    e = empty_cloud(7)
    assert int(e.count) == 7 and e.xyz.shape == (7, 3)
    assert not np.any(np.asarray(e.xyz))  # default-constructed PCL points

    rng = np.random.default_rng(0)
    c1 = make_cloud(rng.normal(size=(4, 3)).astype(np.float32), capacity=6)
    c2 = make_cloud(rng.normal(size=(6, 3)).astype(np.float32))
    s = stack_clouds([c1, c2])
    assert s.xyz.shape == (2, 6, 3)
    np.testing.assert_array_equal(np.asarray(s.count), [4, 6])

    d = to_numpy(c1)
    assert d["count"] == 4 and d["xyz"].shape == (6, 3)
    np.testing.assert_array_equal(d["xyz"], np.asarray(c1.xyz))


def test_bev_cell_np_matches_jax_twin():
    from pctpu.ops.rounding import bev_cell, bev_cell_np

    # half-away-zero knife edges incl. negatives and the .5 grid points
    coords = np.array(
        [-112.0, -111.5, -0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 59.49999,
         59.5, 111.5, 112.0], np.float32)
    got_np = bev_cell_np(coords, 112.0, 1.0)
    got_jx = np.asarray(bev_cell(coords, 112.0, 1.0))
    np.testing.assert_array_equal(got_np, got_jx)


def test_assign_rings_empty_and_negative_start():
    from pctpu.io.kitti import assign_rings

    row, col, assigned = assign_rings(np.zeros((0, 4), np.float32))
    assert len(row) == 0 and len(col) == 0 and len(assigned) == 0

    # first azimuth <= 0: ring starts unassigned (-1) and resets to 0 at the
    # first upward zero crossing (KittiPointCloudSelect.cpp ring logic)
    pts = np.array(
        [[1.0, -0.1, 0.0, 0.0],  # az < 0 → ring -1
         [1.0, -0.05, 0.0, 0.0],
         [1.0, 0.1, 0.0, 0.0],   # crossing → reset to ring 0
         [1.0, 0.2, 0.0, 0.0]], np.float32)
    row, col, assigned = assign_rings(pts)
    assert row[0] == -1  # point 0 is never assigned
    assert not assigned[0] and not assigned[1]
    assert np.all(row[2:] == 0) and np.all(assigned[2:])


def test_read_timestamps_rejects_garbage(tmp_path):
    from pctpu.io.kitti import read_timestamps

    p = tmp_path / "times.txt"
    p.write_text("12.75 13.5\n")
    assert read_timestamps(str(p)) == [12, 13]  # std::stoll prefix parse
    p.write_text("abc\n")
    with pytest.raises(ValueError, match="unparseable timestamp"):
        read_timestamps(str(p))


def test_icp_sharded_requires_mesh():
    import jax.numpy as jnp

    from pctpu.config import FINE_ICP
    from pctpu.ops.icp import icp

    pts = jnp.zeros((8, 3), jnp.float32)
    mask = jnp.ones((8,), bool)
    with pytest.raises(ValueError, match="needs a mesh"):
        icp(pts, mask, pts, mask, jnp.eye(4), FINE_ICP, nn_impl="sharded",
            mesh=None)


def test_sharded_nn_rejects_indivisible_target():
    import jax

    from pctpu.parallel.mesh import make_mesh, sharded_nn_1

    if len(jax.devices()) < 2:
        pytest.skip("needs >1 device")
    mesh = make_mesh(n_data=len(jax.devices()) // 2, n_points=2)
    run = sharded_nn_1(mesh)
    q = np.zeros((4, 3), np.float32)
    t = np.zeros((9, 3), np.float32)  # odd: not divisible by 2 shards
    with pytest.raises(ValueError, match="must divide the target"):
        run(q, np.ones(4, bool), t, np.ones(9, bool))


def test_distributed_initialize_single_process_is_noop():
    from pctpu.parallel.distributed import initialize

    # must not touch jax.distributed (which would try to bind a coordinator)
    initialize("localhost:9999", num_processes=1, process_id=0)


def test_profiler_trace_enabled(tmp_path):
    import jax.numpy as jnp

    from pctpu.runtime.profiler import trace

    with trace("unit", enabled=True, trace_dir=str(tmp_path)):
        jnp.arange(4).sum().block_until_ready()
    # jax.profiler.trace wrote its session dir
    assert os.listdir(str(tmp_path))


def test_preprocess_unfused_branch_matches_ops():
    """preprocess_cloud with mismatched BEV grids takes the unfused
    multi_bev + single_bev branch; outputs equal the direct op calls."""
    import jax.numpy as jnp

    from pctpu.cloud import make_cloud
    from pctpu.config import (
        GroundConfig,
        MultiBevConfig,
        SensorParams,
        SingleBevConfig,
    )
    from pctpu.ops.bev import fused_bev_compatible, multi_bev, single_bev
    from pctpu.ops.preprocess import preprocess_cloud

    params = SensorParams(n_scan=8, horizon_scan=32, ground_upper_scan=6,
                          height_res=0.5)
    single_cfg = SingleBevConfig(max_range=100.0)  # 201-px grid vs multi's 225
    multi_cfg = MultiBevConfig()
    assert not fused_bev_compatible(multi_cfg, single_cfg)

    rng = np.random.default_rng(2)
    n = 120
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-2.2, 3.0, n).astype(np.float32)
    cloud = make_cloud(
        xyz,
        row=rng.integers(0, params.n_scan, n).astype(np.int32),
        col=rng.integers(0, params.horizon_scan, n).astype(np.int32),
        label=np.full(n, -2, np.int32),
        capacity=params.grid_size,
    )
    labeled, multi_img, single_img = preprocess_cloud(
        cloud, params, GroundConfig(), multi_cfg, single_cfg)
    np.testing.assert_array_equal(
        np.asarray(multi_img),
        np.asarray(multi_bev(labeled, params.height_res, multi_cfg)))
    np.testing.assert_array_equal(
        np.asarray(single_img),
        np.asarray(single_bev(labeled, single_cfg)))


def test_cli_common_flag_parse_errors(capsys):
    from pctpu.cli._common import int_kw, path_kw

    assert int_kw({"n": "4"}, "n", 1) == 4
    with pytest.raises(SystemExit):
        int_kw({"pair_batch": "two"}, "pair_batch", 1)
    assert path_kw({}, "report") is None
    assert path_kw({"report": "true"}, "report", default="/tmp/r.txt") \
        == "/tmp/r.txt"
    assert path_kw({"report": "x.txt"}, "report") == "x.txt"
    with pytest.raises(SystemExit):
        path_kw({"report": ""}, "report")
    capsys.readouterr()


def test_pcd_header_and_mode_errors(tmp_path):
    from pctpu.io.pcd import (
        FieldSpec,
        read_pcd,
        read_pcd_point_count,
        write_pcd,
    )

    fx = (FieldSpec("x", np.float32, 1),)
    with pytest.raises(ValueError, match="width\\*height"):
        write_pcd(str(tmp_path / "bad.pcd"),
                  {"x": np.zeros(5, np.float32)}, fields=fx, width=2, height=2)

    p = tmp_path / "noheader.pcd"
    p.write_bytes(b"VERSION 0.7\nDATA binary\n")
    with pytest.raises(ValueError, match="no POINTS line"):
        read_pcd_point_count(str(p))

    good = tmp_path / "ok.pcd"
    write_pcd(str(good), {"x": np.arange(3, dtype=np.float32)}, fields=fx)
    blob = good.read_bytes().replace(b"DATA binary", b"DATA base85")
    bad = tmp_path / "mode.pcd"
    bad.write_bytes(blob)
    with pytest.raises(ValueError, match="unsupported PCD DATA mode"):
        read_pcd(str(bad))


def test_load_cloud_pcd_plain_xyz_defaults(tmp_path):
    from pctpu.io.pcd import FieldSpec, load_cloud_pcd, write_pcd

    pts = np.arange(9, dtype=np.float32).reshape(3, 3)
    fxyz = tuple(FieldSpec(n, np.float32, 1) for n in ("x", "y", "z"))
    write_pcd(str(tmp_path / "xyz.pcd"),
              {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}, fields=fxyz)
    c = load_cloud_pcd(str(tmp_path / "xyz.pcd"), capacity=5)
    assert int(c.count) == 3 and c.xyz.shape == (5, 3)
    np.testing.assert_array_equal(np.asarray(c.xyz)[:3], pts)
    assert not np.any(np.asarray(c.intensity))  # missing fields default zero
    assert not np.any(np.asarray(c.label))


def test_png_shape_and_format_errors():
    from pctpu.io.png import (
        decode_gray_png,
        encode_gray_png,
        encode_rgb_png,
    )

    with pytest.raises(ValueError, match="2-D image"):
        encode_gray_png(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8"):
        encode_rgb_png(np.zeros((2, 2), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_gray_png(b"JFIF....definitely-not-png")
    # color-type mismatch: gray decoder fed a truecolor PNG
    rgb = encode_rgb_png(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="color type"):
        decode_gray_png(rgb)


def test_csvfmt_dtype_branches():
    from pctpu.io.csvfmt import format_csv, format_csv_bytes

    with pytest.raises(ValueError, match="2-D matrix"):
        format_csv(np.zeros(3, np.float32))
    with pytest.raises(TypeError, match="unsupported dtype"):
        format_csv(np.zeros((2, 2), np.complex64))

    # %d integer formatter (int16 path)
    assert format_csv(np.array([[-3, 40000 - 65536]], np.int16)) \
        == "-3, -25536"

    # glibc %g prints sign-set NaN as "-nan"; plain NaN as "nan" — both
    # paths (native emits the same bytes, test_native_io checks identity)
    m = np.array([[np.nan, -np.nan, 1.5]], np.float32)
    assert format_csv_bytes(m) == b"nan, -nan, 1.5"


def test_ground_rejects_too_high_ground_rows():
    from pctpu.config import GroundConfig, SensorParams
    from pctpu.ops.ground import mark_ground

    from pctpu.cloud import empty_cloud

    params = SensorParams(n_scan=8, horizon_scan=16, ground_upper_scan=7,
                          height_res=0.5)
    with pytest.raises(ValueError, match="at least two rows above"):
        mark_ground(empty_cloud(params.grid_size), params, GroundConfig())


def test_fused_bev_asserts_compatible_configs():
    from pctpu.cloud import empty_cloud
    from pctpu.config import MultiBevConfig, SingleBevConfig
    from pctpu.ops.bev import fused_multi_single_bev

    with pytest.raises(AssertionError, match="matching multi/single"):
        fused_multi_single_bev(
            empty_cloud(16), 0.25, MultiBevConfig(),
            SingleBevConfig(max_range=100.0))


def test_nn_1_jit_wrapper_matches_nn_1():
    from pctpu.ops.knn import nn_1, nn_1_jit

    rng = np.random.default_rng(6)
    q = rng.normal(size=(40, 3)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    qm = np.ones(40, bool)
    tm = np.ones(64, bool)
    d1, i1 = nn_1(q, qm, t, tm)
    d2, i2 = nn_1_jit(q, qm, t, tm)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_select_major_frames_empty():
    from pctpu.ops.select import select_major_frames

    assert select_major_frames(np.zeros((0, 3), np.float32)) == []


def test_render_unknown_view_raises():
    from pctpu.ops.render import Layer, render_snapshot

    layer = Layer(xyz=np.zeros((4, 3), np.float32), color=(255, 0, 0))
    with pytest.raises(ValueError, match="unknown view"):
        render_snapshot([layer], img_size=64, view="isometric")


def test_pallas_nn_kernel_arg_validation():
    from pctpu.ops.pallas_knn import pallas_nn_1_pruned

    q = np.zeros((8, 3), np.float32)
    t = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match="powers of two"):
        pallas_nn_1_pruned(q, np.ones(8, bool), t, np.ones(8, bool),
                           tq=96, interpret=True)


def test_logging_helpers_print(capsys):
    from pctpu.utils import logging as log

    log.red("failure text")
    log.error("error text")
    out = capsys.readouterr()
    assert "failure text" in out.out
    assert "error text" in out.out + out.err


def test_reset_dir_clears_unless_resume(tmp_path):
    from pctpu.pipelines.multi_bev import _reset_dir

    d = tmp_path / "out"
    d.mkdir()
    (d / "stale.bin").write_bytes(b"x")
    _reset_dir(str(d), resume=True)
    assert (d / "stale.bin").exists()
    _reset_dir(str(d), resume=False)
    assert d.is_dir() and not list(d.iterdir())
