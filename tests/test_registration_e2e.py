"""End-to-end two-stage registration on synthetic structured scenes."""

import math
import os

import numpy as np
import pytest

from pctpu.cloud import make_cloud
from pctpu.config import RegistrationConfig
from pctpu.pipelines.registration import (
    load_match_results,
    register_pair,
    run_batch_top_part_registration,
)


def synth_scene(rng, n_clusters=12):
    """Buildings (label -2, ≥20 pts per 20 m cell) + dense ground points.

    Dense enough that the coarse stage anchors within the fine stage's 1 m
    correspondence radius — sparser scenes are legitimately marginal for the
    reference algorithm too (1 m maxCorr vs multi-metre point spacing)."""
    pts = []
    labels = []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-50, 50, 2)
        n = 150
        pts.append(
            np.stack(
                [
                    cx + rng.normal(0, 2.5, n),
                    cy + rng.normal(0, 2.5, n),
                    rng.uniform(0, 9, n),
                ],
                axis=1,
            )
        )
        labels.append(np.full(n, -2))
    n_ground = 1500
    pts.append(
        np.stack(
            [
                rng.uniform(-70, 70, n_ground),
                rng.uniform(-70, 70, n_ground),
                rng.uniform(-2.0, -1.9, n_ground),
            ],
            axis=1,
        )
    )
    labels.append(np.zeros(n_ground))
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(labels).astype(np.int32),
    )


def rigid(xyz, yaw_deg, t):
    th = math.radians(yaw_deg)
    c, s = math.cos(th), math.sin(th)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return xyz @ r.T + np.asarray(t, np.float32)


@pytest.mark.slow
def test_register_pair_recovers_relative_yaw():
    rng = np.random.default_rng(0)
    xyz, labels = synth_scene(rng)
    # cloud_2 = scene seen from a pose rotated 25° and shifted
    true_yaw = 25.0
    xyz2 = rigid(xyz, true_yaw, [2.0, -1.0, 0.0]) + rng.normal(
        0, 0.01, xyz.shape
    ).astype(np.float32)
    c1 = make_cloud(xyz, label=labels, capacity=4096)
    c2 = make_cloud(xyz2, label=labels, capacity=4096)

    best, fine = register_pair(c1, c2, angle_guess_deg=20.0, flat_cap=4096)
    t_fine = np.asarray(fine.transform)
    yaw = math.degrees(math.atan2(t_fine[1, 0], t_fine[0, 0]))
    assert abs(yaw - true_yaw) < 0.5
    assert float(fine.fitness) < 1.5
    np.testing.assert_allclose(t_fine[:2, 3], [2.0, -1.0], atol=0.3)


@pytest.mark.slow
def test_register_pair_180_flip_guess():
    # guess off by ~180°: the second coarse guess (θ+180°) must win
    rng = np.random.default_rng(1)
    xyz, labels = synth_scene(rng)
    true_yaw = 10.0
    xyz2 = rigid(xyz, true_yaw, [1.0, 0.5, 0.0]).astype(np.float32)
    c1 = make_cloud(xyz, label=labels, capacity=4096)
    c2 = make_cloud(xyz2, label=labels, capacity=4096)
    best, fine = register_pair(c1, c2, angle_guess_deg=true_yaw - 180.0, flat_cap=4096)
    t_fine = np.asarray(fine.transform)
    yaw = math.degrees(math.atan2(t_fine[1, 0], t_fine[0, 0]))
    assert abs(yaw - true_yaw) < 1.0


@pytest.mark.slow
def test_batch_driver_outputs_report(tmp_path):
    from pctpu.io.pcd import write_pcd

    rng = np.random.default_rng(2)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 15.0, [1.0, 2.0, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, xyz2, labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 15.0\n")
    report = tmp_path / "report.txt"

    reports = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report), flat_cap=4096
    )
    assert len(reports) == 1
    assert reports[0].success
    text = report.read_text().strip().split()
    assert len(text) == 2  # "diff_xy diff_yaw"
    assert float(text[0]) < 1.0

    matches = load_match_results(str(match_file))
    assert matches[0].query_idx == 0 and matches[0].angle_guess == 15.0


@pytest.mark.slow
def test_pair_batched_driver_matches_sequential(tmp_path):
    from pctpu.io.pcd import write_pcd
    from pctpu.pipelines.registration import run_batch_top_part_registration

    rng = np.random.default_rng(3)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 12.0, [0.5, 1.0, 0.0]).astype(np.float32)
    xyz3 = rigid(xyz, -8.0, [-1.0, 0.5, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, xyz2, labels)
    dump(2, xyz3, labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 12.0\n0 2 -8.0\n2 1 20.0\n")

    cap = len(xyz)
    seq = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(tmp_path / "r1.txt"),
        flat_cap=4096, capacity=cap, pair_batch=1,
    )
    bat = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(tmp_path / "r2.txt"),
        flat_cap=4096, capacity=cap, pair_batch=2,  # 3 pairs → padded tail
    )
    assert [r.success for r in seq] == [r.success for r in bat]
    for a, b in zip(seq, bat):
        if a.success:
            np.testing.assert_allclose(a.transform_fine, b.transform_fine, atol=2e-3)


def test_default_pair_batch_is_backend_aware(monkeypatch):
    """pair_batch=None resolves to 16 on a GPU (the benched vmapped
    pipeline) and 1 on the CPU, so the reference argv contract gets the fast
    path on the hardware it helps."""
    import pctpu.pipelines.registration as regmod
    from pctpu.runtime import platform

    for name, want in (("gpu", 16), ("cpu", 1)):
        monkeypatch.setattr(
            regmod, "platform_choice",
            lambda name=name: platform.platform_choice(name),
        )
        assert regmod.default_pair_batch() == want


@pytest.mark.slow
def test_auto_pair_batch_reports_match_sequential(tmp_path, monkeypatch):
    """pair_batch=None routed to the batched pipeline (as on a GPU) writes a
    byte-identical report to the explicit sequential run — the padding
    equivalence that makes the platform default safe."""
    import pctpu.pipelines.registration as regmod
    from pctpu.io.pcd import write_pcd

    rng = np.random.default_rng(13)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 9.0, [0.8, -0.6, 0.0]).astype(np.float32)
    xyz3 = rigid(xyz, -17.0, [-0.4, 1.1, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, xyz2, labels)
    dump(2, xyz3, labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 9.0\n0 2 -17.0\n2 1 26.0\n")

    seq = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(tmp_path / "r1.txt"),
        flat_cap=4096, pair_batch=1,
    )
    # route the None default to the batched pipeline, as the GPU default does
    monkeypatch.setattr(regmod, "default_pair_batch", lambda: 2)
    auto = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(tmp_path / "r2.txt"),
        flat_cap=4096, pair_batch=None,
    )
    assert (tmp_path / "r1.txt").read_bytes() == (tmp_path / "r2.txt").read_bytes()
    assert [r.success for r in seq] == [r.success for r in auto]
    for a, b in zip(seq, auto):
        np.testing.assert_array_equal(a.transform_fine, b.transform_fine)


@pytest.mark.slow
def test_registration_precision_sweep():
    """North-star fidelity evidence: across many synthetic scenes with known
    ground-truth transforms, the recovered yaw stays well under the 0.5 deg
    target and translation under 10 cm (p100 over the sweep)."""
    yaw_errs, t_errs = [], []
    for seed in range(20):
        rng = np.random.default_rng(500 + seed)
        xyz, labels = synth_scene(rng)
        true_yaw = float(rng.uniform(-60, 60))
        tx, ty = rng.uniform(-3, 3, 2)
        xyz2 = rigid(xyz, true_yaw, [tx, ty, 0.0]) + rng.normal(
            0, 0.01, xyz.shape
        ).astype(np.float32)
        c1 = make_cloud(xyz, label=labels, capacity=4096)
        c2 = make_cloud(xyz2, label=labels, capacity=4096)
        guess = true_yaw + float(rng.uniform(-8, 8))
        best, fine = register_pair(c1, c2, angle_guess_deg=guess, flat_cap=4096)
        if float(fine.fitness) > 1.5:
            continue  # reference-classified failure: excluded like the C++
        t_fine = np.asarray(fine.transform)
        yaw = math.degrees(math.atan2(t_fine[1, 0], t_fine[0, 0]))
        yaw_errs.append(abs(yaw - true_yaw))
        t_errs.append(float(np.hypot(t_fine[0, 3] - tx, t_fine[1, 3] - ty)))
    assert len(yaw_errs) >= 16, f"only {len(yaw_errs)} pairs classified success"
    assert max(yaw_errs) < 0.5, (max(yaw_errs), sorted(yaw_errs)[-3:])
    assert max(t_errs) < 0.10, (max(t_errs), sorted(t_errs)[-3:])


@pytest.mark.slow
def test_pair_batch_auto_capacity(tmp_path):
    """pair_batch without an explicit capacity derives one from PCD headers."""
    from pctpu.pipelines.registration import run_batch_top_part_registration

    rng = np.random.default_rng(11)
    xyz, labels = synth_scene(rng)
    cloud_dir = tmp_path / "clouds"
    cloud_dir.mkdir()
    save_cloud_pcd = __import__("pctpu.io.pcd", fromlist=["save_cloud_pcd"]).save_cloud_pcd
    save_cloud_pcd(str(cloud_dir / "000000.pcd"),
                   make_cloud(xyz, label=labels, capacity=4096))
    save_cloud_pcd(str(cloud_dir / "000001.pcd"),
                   make_cloud(rigid(xyz, 12.0, [1.0, 0.0, 0.0]), label=labels,
                              capacity=4096))
    mf = tmp_path / "match_result.txt"
    mf.write_text("0 1 12.0\n1 0 -12.0\n")
    reports = run_batch_top_part_registration(
        str(mf), str(cloud_dir), flat_cap=4096, pair_batch=2,
        report_path=str(tmp_path / "r.txt"),
    )
    assert len(reports) == 2 and all(r.success for r in reports)


@pytest.mark.slow
def test_whole_registration_batched_matches_sequential(tmp_path):
    """run_batch_whole_registration with pair_batch / devices mirrors the
    sequential path (same counts), exercising the shared batching plumbing
    (/root/reference/BatchWholeRegistration.cpp:311-418)."""
    import jax

    from pctpu.io.pcd import write_pcd
    from pctpu.pipelines.registration import run_batch_whole_registration

    rng = np.random.default_rng(5)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 6.0, [0.5, 0.5, 0.0]).astype(np.float32)
    xyz3 = rigid(xyz, -4.0, [-0.5, 1.0, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, xyz2, labels)
    dump(2, xyz3, labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 6.0\n0 2 -4.0\n2 1 10.0\n")

    seq = run_batch_whole_registration(
        str(match_file), str(cloud_dir),
        report_path=str(tmp_path / "w1.txt"), pair_batch=1,
    )
    bat = run_batch_whole_registration(
        str(match_file), str(cloud_dir),
        report_path=str(tmp_path / "w2.txt"), pair_batch=2,  # padded tail
    )
    assert seq == bat
    assert seq[0] + seq[1] == 3
    # the reference-quirk report file exists and stays empty
    assert (tmp_path / "w2.txt").read_text() == ""

    if len(jax.devices()) >= 2:
        mesh_counts = run_batch_whole_registration(
            str(match_file), str(cloud_dir),
            report_path=str(tmp_path / "w3.txt"), pair_batch=2, devices=2,
        )
        assert mesh_counts == seq


@pytest.mark.slow
def test_register_pairs_pipelined_matches_plain():
    """The software-pipelined stream produces exactly register_pairs'
    results per batch (same programs and buckets; only wall-clock
    interleaving differs)."""
    from pctpu.pipelines.registration import (
        register_pairs,
        register_pairs_pipelined,
    )

    rng = np.random.default_rng(9)
    xyz, labels = synth_scene(rng, n_clusters=8)
    cap = 4096
    c1 = make_cloud(xyz[:3500], label=labels[:3500], capacity=cap)
    c2 = make_cloud(rigid(xyz[:3500], 10.0, [0.5, -0.5, 0.0]),
                    label=labels[:3500], capacity=cap)
    batches = [[(c1, c2, 10.0)] * 2, [(c2, c1, -10.0)] * 2,
               [(c1, c2, 10.0)] * 2]
    cfg = RegistrationConfig()
    plain = [register_pairs(b, cfg, flat_cap=2048) for b in batches]
    # depth > 1 keeps several dispatch chains in flight; results must be
    # identical at every depth (same programs + buckets, different
    # wall-clock interleaving), including depth >= number of batches
    for depth in (1, 2, 5):
        piped = list(register_pairs_pipelined(
            iter([lambda b=b: b for b in batches]), cfg, flat_cap=2048,
            depth=depth))
        assert len(piped) == len(plain)
        for pb, qb in zip(plain, piped):
            for (b1, f1), (b2, f2) in zip(pb, qb):
                np.testing.assert_array_equal(np.asarray(b1.transform),
                                              np.asarray(b2.transform))
                np.testing.assert_array_equal(np.asarray(f1.transform),
                                              np.asarray(f2.transform))
                assert float(f1.fitness) == float(f2.fitness)
    with pytest.raises(ValueError, match="depth"):
        list(register_pairs_pipelined(iter([]), cfg, depth=0))


@pytest.mark.slow
def test_pipelined_speculation_mispredict_matches_plain(monkeypatch):
    """Speculative bucket dispatch (BucketSpec) under a forced mispredict:
    batch 2's clouds land in different coarse AND fine buckets than batch
    1's, so the speculative dispatches must be discarded and re-run at the
    correct bucket — per-batch results stay exactly register_pairs'.  A
    third batch repeating batch 2's shapes then hits."""
    import pctpu.pipelines.registration as regmod
    from pctpu.pipelines.registration import (
        register_pairs,
        register_pairs_pipelined,
    )

    captured = {}
    orig_spec = regmod.BucketSpec

    class CaptureSpec(orig_spec):
        def __init__(self):
            super().__init__()
            captured["spec"] = self

    monkeypatch.setattr(regmod, "BucketSpec", CaptureSpec)

    rng = np.random.default_rng(21)
    xyz_s, lab_s = synth_scene(rng, n_clusters=3)
    xyz_l, lab_l = synth_scene(rng, n_clusters=12)
    small_1 = make_cloud(xyz_s, label=lab_s, capacity=4096)
    small_2 = make_cloud(rigid(xyz_s, 8.0, [0.4, -0.3, 0.0]),
                         label=lab_s, capacity=4096)
    # 4x-duplicated large scene → different coarse pow2 bucket and (with the
    # bigger capacity) different fine bucket than the small batch
    xyz_big = np.concatenate(
        [xyz_l + np.array([dx, dy, 0], np.float32)
         for dx, dy in ((0, 0), (140, 0), (0, 140), (140, 140))]
    )
    lab_big = np.concatenate([lab_l] * 4)
    big_1 = make_cloud(xyz_big, label=lab_big, capacity=16384)
    big_2 = make_cloud(rigid(xyz_big, -12.0, [0.7, 0.6, 0.0]),
                       label=lab_big, capacity=16384)
    batches = [
        [(small_1, small_2, 8.0)],
        [(big_1, big_2, -12.0)],
        [(big_2, big_1, 12.0)],
    ]
    cfg = RegistrationConfig()
    plain = [register_pairs(b, cfg, flat_cap=8192) for b in batches]
    piped = list(register_pairs_pipelined(
        iter([lambda b=b: b for b in batches]), cfg, flat_cap=8192))
    assert len(piped) == len(plain)
    for pb, qb in zip(plain, piped):
        for (b1, f1), (b2, f2) in zip(pb, qb):
            np.testing.assert_array_equal(np.asarray(b1.transform),
                                          np.asarray(b2.transform))
            np.testing.assert_array_equal(np.asarray(f1.transform),
                                          np.asarray(f2.transform))
            assert float(f1.fitness) == float(f2.fitness)
    spec = captured["spec"]
    # batch 1 → no prediction; batch 2 → both stages mispredict; batch 3 →
    # both stages hit (same shapes as batch 2)
    assert spec.misses >= 1, (spec.hits, spec.misses)
    assert spec.hits >= 1, (spec.hits, spec.misses)


@pytest.mark.slow
def test_coarse_mispredict_invalidates_speculative_fine(monkeypatch):
    """Coarse bucket mispredicts while the fine bucket HITS: the speculative
    fine was seeded with the MISPREDICTED coarse winners, so it must be
    re-dispatched even though its own bucket matched — keeping it would
    silently return a fine ICP started from the wrong guesses
    (_dispatch_batch_speculative's downstream-invalidation rule)."""
    import pctpu.pipelines.registration as regmod
    from pctpu.pipelines.registration import (
        register_pairs,
        register_pairs_pipelined,
    )

    captured = {}
    orig_spec = regmod.BucketSpec

    class CaptureSpec(orig_spec):
        def __init__(self):
            super().__init__()
            captured["spec"] = self
            self.coarse_seq: list[int] = []
            self.fine_seq: list[int] = []

        def record(self, predicted, actual):
            # record() is called once per stage in bucket order within a
            # batch (coarse then fine) — reconstruct per-stage sequences
            if len(self.coarse_seq) == len(self.fine_seq):
                self.coarse_seq.append(actual)
            else:
                self.fine_seq.append(actual)
            return super().record(predicted, actual)

    monkeypatch.setattr(regmod, "BucketSpec", CaptureSpec)

    cap = 16384
    rng = np.random.default_rng(33)

    def scene(n_clusters, n_extra_ground_bands):
        xyz, lab = synth_scene(rng, n_clusters=n_clusters)
        for k in range(n_extra_ground_bands):
            # extra z-bands of ground: inflate the FULL-cloud voxel count
            # (fine bucket) without adding any top-part (coarse) points
            ng = 6000
            z0 = -1.7 + 0.2 * k
            band = np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                             rng.uniform(z0, z0 + 0.1, ng)], 1).astype(np.float32)
            xyz = np.concatenate([xyz, band])
            lab = np.concatenate([lab, np.zeros(ng, np.int32)])
        return xyz, lab.astype(np.int32)

    # batch A: many clusters (60×~30 kept ≈ 1.8k top-part points → coarse
    # bucket 2048, ~10.5k full-cloud voxel points); batch B: few clusters
    # (coarse bucket at the 1024 floor) + extra ground bands so the fine
    # bucket stays in batch A's 8192-multiple (~14k voxel points → 16384)
    xa, la = scene(60, n_extra_ground_bands=0)
    xb, lb = scene(3, n_extra_ground_bands=2)
    a1 = make_cloud(xa, label=la, capacity=cap)
    a2 = make_cloud(rigid(xa, -9.0, [0.5, 0.4, 0.0]), label=la, capacity=cap)
    b1 = make_cloud(xb, label=lb, capacity=cap)
    b2 = make_cloud(rigid(xb, 7.0, [-0.4, 0.6, 0.0]), label=lb, capacity=cap)
    batches = [[(a1, a2, -9.0)], [(b1, b2, 7.0)]]
    cfg = RegistrationConfig()
    plain = [register_pairs(b, cfg, flat_cap=8192) for b in batches]
    piped = list(register_pairs_pipelined(
        iter([lambda b=b: b for b in batches]), cfg, flat_cap=8192))
    for pb, qb in zip(plain, piped):
        for (b1r, f1), (b2r, f2) in zip(pb, qb):
            np.testing.assert_array_equal(np.asarray(b1r.transform),
                                          np.asarray(b2r.transform))
            np.testing.assert_array_equal(np.asarray(f1.transform),
                                          np.asarray(f2.transform))
            assert float(f1.fitness) == float(f2.fitness)
    spec = captured["spec"]
    # the scenario's precondition: coarse buckets differ across the batches,
    # fine buckets match — otherwise this test isn't exercising the
    # downstream-invalidation path and must be re-tuned
    assert spec.coarse_seq[0] != spec.coarse_seq[1], spec.coarse_seq
    assert spec.fine_seq[0] == spec.fine_seq[1], spec.fine_seq


@pytest.mark.slow
def test_pipelined_driver_propagates_loader_errors(tmp_path):
    """A missing PCD in a later chunk must raise cleanly out of the
    pipelined driver (the worker-thread exception propagates via the
    future), never hang or silently drop pairs."""
    from pctpu.io.pcd import write_pcd
    from pctpu.pipelines.registration import run_batch_top_part_registration

    rng = np.random.default_rng(6)
    xyz, labels = synth_scene(rng)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)
    n = len(xyz)
    write_pcd(
        str(cloud_dir / "000000.pcd"),
        {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "intensity": np.ones(n, np.float32),
            "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
            "t": np.zeros(n, np.uint32), "label": labels.astype(np.int16),
        },
    )
    match_file = tmp_path / "match_result.txt"
    # second chunk references cloud 7 which does not exist
    match_file.write_text("0 0 0.0\n0 0 0.0\n0 7 5.0\n")
    with pytest.raises((FileNotFoundError, OSError)):
        run_batch_top_part_registration(
            str(match_file), str(cloud_dir), flat_cap=2048,
            capacity=len(xyz), pair_batch=2,
            report_path=str(tmp_path / "r.txt"),
        )


def test_filter_resumed_consumes_duplicates_as_multiset(tmp_path):
    """A match file with duplicate pairs (which the reference processes
    twice) must only skip as many occurrences as the progress file records."""
    from pctpu.pipelines.registration import MatchResult, _filter_resumed

    report = tmp_path / "rep.txt"
    matches = [MatchResult(0, 1, 10.0), MatchResult(0, 1, 10.0),
               MatchResult(2, 3, -5.0)]
    # no resume: everything runs, report truncated
    remaining, mode = _filter_resumed(matches, str(report), resume=False)
    assert remaining == matches and mode == "w"
    # resume with no progress file: everything runs
    remaining, mode = _filter_resumed(matches, str(report), resume=True)
    assert remaining == matches and mode == "w"
    # one of the two duplicate (0,1) runs is recorded -> exactly one skipped
    (tmp_path / "rep.txt.progress").write_text("0 1\n")
    report.write_text("stub\n")
    remaining, mode = _filter_resumed(matches, str(report), resume=True)
    assert remaining == [MatchResult(0, 1, 10.0), MatchResult(2, 3, -5.0)]
    assert mode == "a"


@pytest.mark.slow
def test_batch_driver_resume(tmp_path):
    """--resume on the registration driver: a completed run resumes to a
    no-op; a partially-recorded run re-registers only the missing pairs and
    appends their report lines (crash-safe §5.4 policy extended to the
    report-stream tools)."""
    from pctpu.io.pcd import write_pcd

    rng = np.random.default_rng(21)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 14.0, [1.0, 0.5, 0.0]).astype(np.float32)
    xyz3 = rigid(xyz, -9.0, [-0.5, 1.0, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, xyz2, labels)
    dump(2, xyz3, labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 14.0\n0 2 -9.0\n")
    report = tmp_path / "report.txt"
    progress = tmp_path / "report.txt.progress"

    full = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report), flat_cap=4096
    )
    assert len(full) == 2
    report_bytes = report.read_bytes()
    assert progress.read_text().splitlines() == ["0 1", "0 2"]

    # resume over a completed run: nothing to do, files untouched
    again = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report),
        flat_cap=4096, resume=True,
    )
    assert again == []
    assert report.read_bytes() == report_bytes
    assert progress.read_text().splitlines() == ["0 1", "0 2"]

    # crash after pair 1: progress + report hold only its line; resume runs
    # only pair 2 and reproduces the full report byte-for-byte
    lines = report_bytes.splitlines(keepends=True)
    report.write_bytes(b"".join(lines[:1]))
    progress.write_text("0 1\n")
    rest = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report),
        flat_cap=4096, resume=True,
    )
    assert len(rest) == 1 and rest[0].query_idx == 0 and rest[0].match_idx == 2
    assert report.read_bytes() == report_bytes
    assert progress.read_text().splitlines() == ["0 1", "0 2"]

    # a fresh non-resume run truncates both files (reference semantics)
    run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report), flat_cap=4096
    )
    assert report.read_bytes() == report_bytes


@pytest.mark.slow
def test_whole_registration_resume(tmp_path):
    """Resume for the ablation driver: progress sidecar recorded, a resumed
    run skips completed pairs and the empty report file is preserved."""
    from pctpu.io.pcd import save_cloud_pcd
    from pctpu.pipelines.registration import run_batch_whole_registration

    rng = np.random.default_rng(22)
    xyz, labels = synth_scene(rng)
    cloud_dir = tmp_path / "clouds"
    cloud_dir.mkdir()
    save_cloud_pcd(str(cloud_dir / "000000.pcd"),
                   make_cloud(xyz, label=labels, capacity=4096))
    save_cloud_pcd(str(cloud_dir / "000001.pcd"),
                   make_cloud(rigid(xyz, 5.0, [0.5, 0.0, 0.0]), label=labels,
                              capacity=4096))
    mf = tmp_path / "match_result.txt"
    mf.write_text("0 1 5.0\n1 0 -5.0\n")
    report = tmp_path / "rep3d.txt"

    counts = run_batch_whole_registration(
        str(mf), str(cloud_dir), report_path=str(report), capacity=4096
    )
    assert sum(counts) == 2
    assert report.read_bytes() == b""  # created-but-never-written quirk
    progress = tmp_path / "rep3d.txt.progress"
    assert progress.read_text().splitlines() == ["0 1", "1 0"]

    counts2 = run_batch_whole_registration(
        str(mf), str(cloud_dir), report_path=str(report), capacity=4096,
        resume=True,
    )
    assert counts2 == (0, 0)
    assert report.read_bytes() == b""
    assert progress.read_text().splitlines() == ["0 1", "1 0"]


@pytest.mark.slow
def test_batch_driver_resume_with_pair_batch(tmp_path):
    """--resume composes with the pipelined pair_batch path: filtering
    happens before chunking, so a resumed run re-chunks only the remaining
    pairs (including a padded short tail)."""
    from pctpu.io.pcd import write_pcd

    rng = np.random.default_rng(23)
    xyz, labels = synth_scene(rng)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, rigid(xyz, 8.0, [1.0, 0.0, 0.0]), labels)
    dump(2, rigid(xyz, -6.0, [0.0, 1.0, 0.0]), labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 8.0\n0 2 -6.0\n1 2 -14.0\n")
    report = tmp_path / "report.txt"
    cap = len(xyz)

    full = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report),
        flat_cap=4096, capacity=cap, pair_batch=2,
    )
    assert len(full) == 3
    progress = tmp_path / "report.txt.progress"
    assert progress.read_text().splitlines() == ["0 1", "0 2", "1 2"]
    full_lines = report.read_text().splitlines()

    # first chunk (2 pairs) completed, crash before the tail chunk
    progress.write_text("0 1\n0 2\n")
    n_success_first = sum(1 for r in full[:2] if r.success)
    report.write_text(
        "".join(line + "\n" for line in full_lines[:n_success_first])
    )
    rest = run_batch_top_part_registration(
        str(match_file), str(cloud_dir), report_path=str(report),
        flat_cap=4096, capacity=cap, pair_batch=2, resume=True,
    )
    assert [(r.query_idx, r.match_idx) for r in rest] == [(1, 2)]
    # the resumed tail (1 pair into a pair_batch=2 program) reproduces the
    # same report lines the uninterrupted run produced
    assert report.read_text().splitlines() == full_lines
    assert progress.read_text().splitlines() == ["0 1", "0 2", "1 2"]


@pytest.mark.slow
def test_resume_capacity_from_full_match_list(tmp_path, capsys):
    """Auto-derived capacity comes from the FULL (pre-resume) match list, so
    a resumed run pads exactly like the run it continues even when the pairs
    referencing the biggest cloud are already done."""
    from pctpu.io.pcd import save_cloud_pcd

    rng = np.random.default_rng(31)
    xyz, labels = synth_scene(rng)          # ~3k points
    big = np.concatenate([xyz] * 4)         # ~12k points -> capacity 16384
    big_labels = np.concatenate([labels] * 4)
    cloud_dir = tmp_path / "clouds"
    cloud_dir.mkdir()
    save_cloud_pcd(str(cloud_dir / "000000.pcd"), make_cloud(big, label=big_labels))
    save_cloud_pcd(str(cloud_dir / "000001.pcd"),
                   make_cloud(rigid(big, 7.0, [0.5, 0.0, 0.0]), label=big_labels))
    save_cloud_pcd(str(cloud_dir / "000002.pcd"), make_cloud(xyz, label=labels))
    save_cloud_pcd(str(cloud_dir / "000003.pcd"),
                   make_cloud(rigid(xyz, -5.0, [0.0, 0.5, 0.0]), label=labels))
    mf = tmp_path / "match_result.txt"
    mf.write_text("0 1 7.0\n2 3 -5.0\n")
    report = tmp_path / "report.txt"

    run_batch_top_part_registration(
        str(mf), str(cloud_dir), report_path=str(report), flat_cap=4096
    )
    first = [line for line in capsys.readouterr().out.splitlines()
             if "capacity auto-derived" in line]
    assert first, "expected the capacity log line"

    # pair (0,1) — the one touching the big clouds — is done; resume must
    # still derive the ORIGINAL capacity, not one from the small remainder
    (tmp_path / "report.txt.progress").write_text("0 1\n")
    run_batch_top_part_registration(
        str(mf), str(cloud_dir), report_path=str(report), flat_cap=4096,
        resume=True,
    )
    resumed = [line for line in capsys.readouterr().out.splitlines()
               if "capacity auto-derived" in line]
    assert resumed == first


def test_driver_coarse_only_and_failure_branches(tmp_path):
    """The two early-exit consumer branches of the top-part driver:
    use_refinement=False (coarse only, no report line) and
    fitness > failure_fitness ("3D ICP Failed.", failure count, NaN
    precision; /root/reference/BatchTopPartRegistration.cpp:507-541) —
    plus the whole-registration failure count."""
    from pctpu.config import WHOLE_ICP, RegistrationConfig
    from pctpu.io.pcd import write_pcd
    from pctpu.pipelines.registration import (
        run_batch_top_part_registration,
        run_batch_whole_registration,
    )

    rng = np.random.default_rng(11)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 10.0, [1.0, 0.5, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)

    def dump(idx, pts, labs):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labs.astype(np.int16),
            },
        )

    dump(0, xyz, labels)
    dump(1, xyz2, labels)
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 10.0\n")

    # coarse only: fine is None → success=False report row, empty report file
    rep = tmp_path / "coarse.txt"
    reports = run_batch_top_part_registration(
        str(match_file), str(cloud_dir),
        cfg=RegistrationConfig(use_refinement=False),
        report_path=str(rep), flat_cap=4096,
    )
    assert len(reports) == 1 and not reports[0].success
    assert np.isnan(reports[0].fitness_fine) and np.isnan(reports[0].diff_yaw)
    assert rep.read_text() == ""
    assert (tmp_path / "coarse.txt.progress").read_text() == "0 1\n"

    # failure gate: any fitness beats failure_fitness=-1 → failure branch
    rep2 = tmp_path / "fail.txt"
    reports = run_batch_top_part_registration(
        str(match_file), str(cloud_dir),
        cfg=RegistrationConfig(failure_fitness=-1.0),
        report_path=str(rep2), flat_cap=4096,
    )
    assert len(reports) == 1 and not reports[0].success
    assert np.isfinite(reports[0].fitness_fine)  # fine ran, gate rejected it
    assert np.isnan(reports[0].diff_yaw)
    assert rep2.read_text() == ""
    assert (tmp_path / "fail.txt.progress").read_text() == "0 1\n"

    counts = run_batch_whole_registration(
        str(match_file), str(cloud_dir),
        cfg=RegistrationConfig(fine=WHOLE_ICP, failure_fitness=-1.0),
        report_path=str(tmp_path / "whole.txt"),
    )
    assert counts == (0, 1)


def test_whole_registration_cli_main(tmp_path):
    """The CLI shim end to end in-process: argv contract of
    /root/reference/BatchWholeRegistration.cpp:311-321 plus the pctpu
    extension flags, and the usage exit."""
    import pytest as _pytest

    from pctpu.cli.batch_whole_registration import main
    from pctpu.io.pcd import write_pcd

    rng = np.random.default_rng(3)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 5.0, [0.5, -0.5, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)
    for idx, pts in ((0, xyz), (1, xyz2)):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labels.astype(np.int16),
            },
        )
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 5.0\n1 0 -5.0\n")
    report = tmp_path / "whole_report.txt"

    rc = main([str(match_file), str(cloud_dir), f"--report={report}",
               "--pair-batch=2"])
    assert rc == 0
    assert report.read_text() == ""  # created-but-never-written quirk
    assert sorted((report.parent / (report.name + ".progress"))
                  .read_text().splitlines()) == ["0 1", "1 0"]

    with _pytest.raises(SystemExit):
        main([])  # usage


def test_register_pairs_coarse_only_and_shard_guards():
    """register_pairs with use_refinement=False yields (best, None) per
    pair; the mesh path rejects pair counts that don't divide the data
    axis; register_pair's point_mesh rejects indivisible capacities."""
    import jax

    from pctpu.cloud import make_cloud
    from pctpu.config import RegistrationConfig
    from pctpu.pipelines.registration import register_pair, register_pairs

    rng = np.random.default_rng(9)
    xyz, labels = synth_scene(rng)
    c1 = make_cloud(xyz, label=labels.astype(np.int32), capacity=4096)
    xyz2 = rigid(xyz, 8.0, [0.5, 0.0, 0.0]).astype(np.float32)
    c2 = make_cloud(xyz2, label=labels.astype(np.int32), capacity=4096)

    results = register_pairs(
        [(c1, c2, 8.0), (c2, c1, -8.0)],
        cfg=RegistrationConfig(use_refinement=False), flat_cap=4096)
    assert len(results) == 2
    for best, fine in results:
        assert fine is None
        assert np.isfinite(float(best.fitness))

    if len(jax.devices()) >= 4:
        from pctpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_data=4, n_points=1)
        with pytest.raises(ValueError, match="multiple of the mesh data axis"):
            register_pairs([(c1, c2, 8.0)] * 3, flat_cap=4096, mesh=mesh)

        pmesh = make_mesh(n_data=1, n_points=3)  # 4096 % 3 != 0
        with pytest.raises(ValueError, match="multiple of the 'points' axis"):
            register_pair(c1, c2, 8.0, flat_cap=4096, point_mesh=pmesh)


def test_register_pair_sequential_coarse_only():
    """The unbatched register_pair honors use_refinement=False too
    (/root/reference/BatchTopPartRegistration.cpp USE_REFINEMENT=false
    ablation: coarse transform is the result, no fine stage)."""
    from pctpu.cloud import make_cloud
    from pctpu.config import RegistrationConfig
    from pctpu.pipelines.registration import register_pair

    rng = np.random.default_rng(10)
    xyz, labels = synth_scene(rng)
    c1 = make_cloud(xyz, label=labels.astype(np.int32), capacity=4096)
    xyz2 = rigid(xyz, 5.0, [0.3, 0.1, 0.0]).astype(np.float32)
    c2 = make_cloud(xyz2, label=labels.astype(np.int32), capacity=4096)

    best, fine = register_pair(
        c1, c2, 5.0, cfg=RegistrationConfig(use_refinement=False),
        flat_cap=4096)
    assert fine is None
    assert best.transform.shape == (4, 4)


def test_prepare_driver_rounds_pair_batch_to_devices(tmp_path):
    """pair_batch is rounded up to a multiple of --devices so every chunk
    shards evenly (pipelines/registration.py driver preamble)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >1 device")

    from pctpu.io.pcd import write_pcd
    from pctpu.pipelines.registration import run_batch_whole_registration

    rng = np.random.default_rng(12)
    xyz, labels = synth_scene(rng)
    xyz2 = rigid(xyz, 4.0, [0.2, 0.2, 0.0]).astype(np.float32)
    cloud_dir = tmp_path / "clouds"
    os.makedirs(cloud_dir)
    for idx, pts in ((0, xyz), (1, xyz2)):
        n = len(pts)
        write_pcd(
            str(cloud_dir / f"{idx:06d}.pcd"),
            {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.ones(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": labels.astype(np.int16),
            },
        )
    match_file = tmp_path / "match_result.txt"
    match_file.write_text("0 1 4.0\n1 0 -4.0\n0 1 4.0\n")

    # pair_batch=3 with devices=2 → rounded to 4; padded tail still correct
    counts = run_batch_whole_registration(
        str(match_file), str(cloud_dir),
        report_path=str(tmp_path / "r.txt"), pair_batch=3, devices=2)
    assert sum(counts) == 3
