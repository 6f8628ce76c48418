"""chip_smoke.py off the card: its input generators, its comparisons, its
result line, and its refusal to run anywhere but on a GPU."""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_registration_scene_has_known_transform():
    xyz1, xyz2, lab, yaw, (tx, ty) = cs.registration_scene(3)
    n = 40 * cs.CLUSTER_POINTS + cs.GROUND_POINTS
    assert xyz1.shape == xyz2.shape == (n, 3) and lab.shape == (n,)
    assert set(np.unique(lab)) == {-2, 0}
    th = math.radians(yaw)
    rot = np.array([[math.cos(th), -math.sin(th), 0],
                    [math.sin(th), math.cos(th), 0], [0, 0, 1]])
    moved = xyz1 @ rot.T + np.array([tx, ty, 0.0])
    assert np.abs(moved - xyz2).max() < 0.1  # 1 cm noise
    other = cs.registration_scene(4)
    assert not np.array_equal(other[0], xyz1)  # every pair distinct


def test_write_registration_tree_round_trips(tmp_path, monkeypatch):
    from pctpu.io.pcd import read_pcd_point_count
    from pctpu.pipelines.registration import load_match_results

    monkeypatch.setattr(cs, "GROUND_POINTS", 500)
    monkeypatch.setattr(cs, "CLUSTER_POINTS", 10)
    truths = cs.write_registration_tree(str(tmp_path), 2, seed=1)
    matches = load_match_results(str(tmp_path / "match_result.txt"))
    assert [(m.query_idx, m.match_idx) for m in matches] == [(0, 1), (2, 3)]
    for m, (yaw, _, _) in zip(matches, truths):
        assert abs(m.angle_guess - yaw) <= 3.0 + 1e-4
    for i in range(4):
        assert read_pcd_point_count(
            str(tmp_path / "clouds" / f"{i:06d}.pcd")) == 900


def test_write_bev_tree_is_dense_selector_layout(tmp_path):
    from pctpu.config import get_sensor_params
    from pctpu.io.pcd import read_pcd

    cs.write_bev_tree(str(tmp_path), 1, seed=0)
    params = get_sensor_params("HDL_64E")
    data, _ = read_pcd(str(tmp_path / "keyframe_point_cloud" / "000000.pcd"))
    assert len(data["x"]) == params.grid_size == 64 * 2083
    valid = data["label"] == -2
    assert 110_000 < valid.sum() < 130_000
    slot = np.arange(params.grid_size)
    np.testing.assert_array_equal(data["row"][valid], (slot // 2083)[valid])
    assert not data["x"][~valid].any()  # empty slots all zero
    assert (tmp_path / "keyframe_pose.csv").read_text().count("\n") == 1


def test_tree_digest_sees_files_and_changes(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "x.bin").write_bytes(b"1")
    (tmp_path / "top.csv").write_text("2")
    d = cs.tree_digest(str(tmp_path), ("a", "top.csv", "missing"))
    assert sorted(d) == ["a/b/x.bin", "top.csv"]
    (tmp_path / "top.csv").write_text("3")
    assert cs.tree_digest(str(tmp_path), ("a", "top.csv")) != d


def test_tolerance_window_accepts_flip_explained_pixels():
    labels = np.zeros(50_000, np.int32)
    multi = np.zeros(100, np.uint8)
    single = np.zeros((10, 10), np.uint8)
    exact = (labels, multi, single)
    lab2, m2, s2 = labels.copy(), multi.copy(), single.copy()
    lab2[7] = -2
    m2[3] = 255
    s2[1, 1] = 255
    assert cs.check_tolerance_window(exact, (lab2, m2, s2), 50_000) == (1, 2)
    m2[4] = 255  # a second multi-BEV pixel for one flip
    with pytest.raises(AssertionError, match="BEV pixels"):
        cs.check_tolerance_window(exact, (lab2, m2, s2), 50_000)
    lab3 = labels.copy()
    lab3[:10] = -2  # more flips than the knife edge explains
    with pytest.raises(AssertionError, match="label flips"):
        cs.check_tolerance_window(exact, (lab3, multi, single), 50_000)


def test_pair_errors_wrap_yaw():
    th = math.radians(179.9)
    tf = np.eye(4)
    tf[:2, :2] = [[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]]
    tf[:2, 3] = [1.0, 2.0]
    yaw_err, t_err = cs.pair_errors(tf, (-179.9, 1.0, 2.05))
    assert yaw_err == pytest.approx(0.2, abs=1e-9)
    assert t_err == pytest.approx(0.05, abs=1e-9)


def test_device_check_fails_on_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.check_device()


def test_result_line_format(monkeypatch, capsys):
    """With every phase stubbed the last stdout line is exactly the result
    object, carrying the device as JAX reports it."""
    monkeypatch.setattr(cs, "check_device", lambda: ("gpu", "NVIDIA H100", 1))
    for name in ("phase_bev", "phase_registration"):
        monkeypatch.setattr(cs, name, lambda work, seed: None)
    for name in ("phase_nn", "phase_oracle"):
        monkeypatch.setattr(cs, name, lambda: None)
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().split("\n")[-1]
    assert json.loads(last) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100",
                               "count": 1}}


def test_script_fails_without_gpu():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_script_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path),
               {"PYTHONPATH": "", "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
