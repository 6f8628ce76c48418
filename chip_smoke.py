"""Smoke run of pctpu's two main paths on a GPU, through the CLIs a user
calls, at production sizes, with every output checked.

    python chip_smoke.py [--seed=N]       # one GPU
    python chip_smoke.py --four-cards     # the --devices=4 mesh paths only

Phases (one process; no child process touches JAX):

* device: fails unless JAX's first device is a GPU; prints its kind, the
  device count and ``nvidia-smi``'s name and power limit;
* bev: 64 HDL-64E clouds on the full 64 x 2083 grid (~120k valid points
  each, the selector tools' dense layout) through
  ``batch_multi_bev_gen.main``: bit-exact mode byte-compared with the native
  oracle (native/ref_oracle.cpp) and with its own rerun, tolerance mode
  held to the D1 window (README);
* registration: 16 distinct ~60k-point pairs with known yaw and shift
  through ``batch_top_part_registration.main`` at the default pair batch:
  every pair inside the north-star window, reruns byte-identical;
* nn: the fine-stage NN kernel against ``ops.knn.nn_1`` at 49k x 49k,
  thresholded and not;
* oracle: 3 small pairs (capacity 4096) against the f64 two-stage oracle
  ``tests/ref_impl.two_stage_ref``.

``--four-cards`` runs only both CLIs with ``--devices=4`` and on device 0
alone on the same inputs, byte-compares the two, and shows each card's
peak memory.  Each phase prints its wall time, compile time and peak device
memory; the last line is one JSON object with the device.  Any failed
check raises, so the exit code is non-zero and no result line is printed.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_CLOUDS = 64  # 8 batches of 8, the multi-BEV batch
N_PAIRS = 16  # one pair batch
CAPACITY = 65536  # registration cloud capacity
NN_POINTS = 49_000
GROUND_POINTS = 48_000  # per registration scene, plus 40 clusters
CLUSTER_POINTS = 300
ORACLE_SEEDS = (0, 1, 2)  # tests/test_twostage_differential scenes

_compile_s = [0.0]


def _on_event(event: str, duration: float, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


class Phase:
    """Prints a phase's wall time, compile time and peak device memory."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _compile_s[0]
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            import jax

            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                     for d in jax.local_devices()]
            print(json.dumps({
                "phase": self.name,
                "wall_s": round(time.perf_counter() - self.t0, 3),
                "compile_s": round(_compile_s[0] - self.c0, 3),
                "peak_bytes_in_use": peaks,
            }), flush=True)


def check_device():
    """The first JAX device must be a GPU; returns (platform, kind, count)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"device_kind={devs[0].device_kind} count={len(devs)}", flush=True)
    return devs[0].platform, devs[0].device_kind, len(devs)


# --- inputs ----------------------------------------------------------------


def write_bev_tree(root: str, n_clouds: int, seed: int) -> None:
    """A selected-keyframe tree of HDL-64E clouds in the selector tools'
    layout (dense 64 x 2083 grid, slot = row * 2083 + col, empty slots all
    zero with label 0, ~120k valid points) plus its pose file."""
    from bench import _write_bench_tree

    _write_bench_tree(root, n_clouds, seed0=seed)


def registration_scene(seed: int):
    """One ~60k-point scene: 40 vertical clusters (label -2, the top part)
    over 48k ground points (label 0), and its copy under a known yaw and
    shift with 1 cm noise.  Returns (xyz1, xyz2, labels, yaw_deg, (tx, ty))."""
    rng = np.random.default_rng(seed)
    pts, labels = [], []
    for _ in range(40):
        cx, cy = rng.uniform(-60, 60, 2)
        n = CLUSTER_POINTS
        pts.append(np.stack([cx + rng.normal(0, 2.5, n),
                             cy + rng.normal(0, 2.5, n),
                             rng.uniform(0, 9, n)], 1))
        labels.append(np.full(n, -2))
    ng = GROUND_POINTS
    pts.append(np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                         rng.uniform(-2.0, -1.9, ng)], 1))
    labels.append(np.zeros(ng))
    xyz = np.concatenate(pts).astype(np.float32)
    lab = np.concatenate(labels).astype(np.int32)
    yaw = float(rng.uniform(-60, 60))
    tx, ty = (float(v) for v in rng.uniform(-3, 3, 2))
    th = math.radians(yaw)
    rot = np.array([[math.cos(th), -math.sin(th), 0],
                    [math.sin(th), math.cos(th), 0], [0, 0, 1]], np.float32)
    xyz2 = (xyz @ rot.T + np.float32([tx, ty, 0])
            + rng.normal(0, 0.01, xyz.shape)).astype(np.float32)
    return xyz, xyz2, lab, yaw, (tx, ty)


def _pair(seed: int, k: int):
    """Pair ``k`` of a match list: (xyz1, xyz2, labels, yaw guess within
    ±3°, truth = (yaw_deg, tx, ty))."""
    xyz1, xyz2, lab, yaw, (tx, ty) = registration_scene(seed * 1000 + k)
    guess = yaw + float(np.random.default_rng(k).uniform(-3, 3))
    return xyz1, xyz2, lab, guess, (yaw, tx, ty)


def registration_pairs(n: int, seed: int):
    """``n`` distinct scenes as device clouds: [(c1, c2, guess, truth)]."""
    from pctpu.cloud import make_cloud

    out = []
    for k in range(n):
        xyz1, xyz2, lab, guess, truth = _pair(seed, k)
        out.append((make_cloud(xyz1, label=lab, capacity=CAPACITY),
                    make_cloud(xyz2, label=lab, capacity=CAPACITY),
                    guess, truth))
    return out


def write_registration_tree(root: str, n_pairs: int, seed: int):
    """Clouds 2k and 2k+1 of pair k as PCDs plus ``match_result.txt``
    (``query match yaw_guess``).  Returns the truths [(yaw, tx, ty)]."""
    from pctpu.io.pcd import write_pcd

    cloud_dir = os.path.join(root, "clouds")
    os.makedirs(cloud_dir, exist_ok=True)
    truths, lines = [], []
    for k in range(n_pairs):
        xyz1, xyz2, lab, guess, truth = _pair(seed, k)
        for idx, xyz in ((2 * k, xyz1), (2 * k + 1, xyz2)):
            n = len(xyz)
            write_pcd(os.path.join(cloud_dir, f"{idx:06d}.pcd"), {
                "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                "intensity": np.zeros(n, np.float32),
                "row": np.zeros(n, np.uint16), "col": np.zeros(n, np.uint16),
                "t": np.zeros(n, np.uint32), "label": lab.astype(np.int16),
            })
        lines.append(f"{2 * k} {2 * k + 1} {guess:.6f}\n")
        truths.append(truth)
    with open(os.path.join(root, "match_result.txt"), "w") as f:
        f.writelines(lines)
    return truths


# --- checks ----------------------------------------------------------------


def tree_digest(root: str, subdirs) -> dict[str, str]:
    """sha256 of every file at or under ``root/<subdir>``, keyed by relative
    path."""
    paths = []
    for sub in subdirs:
        top = os.path.join(root, sub)
        if os.path.isfile(top):
            paths.append(top)
        for dirpath, _, files in os.walk(top):
            paths.extend(os.path.join(dirpath, f) for f in files)
    out = {}
    for p in paths:
        with open(p, "rb") as fh:
            out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


BEV_OUTPUTS = ("output_multi_bev", "output_single_bev",
               "non_ground_point_cloud", "keyframe_label.csv")


def read_bev_artifacts(root: str, idx: int):
    """(labels, multi-BEV bytes, single-BEV matrix) one run wrote for cloud
    ``idx``."""
    from pctpu.io.pcd import read_pcd

    ng, _ = read_pcd(os.path.join(root, "non_ground_point_cloud",
                                  f"{idx:06d}.pcd"))
    with open(os.path.join(root, "output_multi_bev", "binary",
                           f"{idx:06d}.bin"), "rb") as f:
        multi = np.frombuffer(f.read(), np.uint8)
    with open(os.path.join(root, "output_single_bev", "csv",
                           f"{idx:06d}.csv")) as f:
        single = np.array([[int(v) for v in r.split(",")]
                           for r in f.read().strip().split("\n")], np.uint8)
    return ng["label"].astype(np.int32), multi, single


def check_tolerance_window(exact, tol, n_points: int) -> tuple[int, int]:
    """D1 window: tolerance-mode sums only move sector averages by ~1e-5
    relative, so a label may flip at the 0.30 m veto knife-edge only, and
    each flipped point moves at most one pixel of each BEV.  Returns
    (label flips, BEV pixels changed)."""
    (l0, m0, s0), (l1, m1, s1) = exact, tol
    flips = int((l0 != l1).sum())
    changed_m = int((m0 != m1).sum())
    changed_s = int((s0 != s1).sum())
    assert flips <= max(1, n_points // 10_000), f"{flips} label flips"
    assert changed_m <= flips and changed_s <= flips, (
        f"{changed_m}/{changed_s} BEV pixels changed for {flips} label flips"
    )
    return flips, changed_m + changed_s


def pair_errors(transform, truth) -> tuple[float, float]:
    """(|yaw error| in degrees, translation error in metres)."""
    yaw, tx, ty = truth
    tf = np.asarray(transform, np.float64)
    err = math.degrees(math.atan2(tf[1, 0], tf[0, 0])) - yaw
    err = (err + 180.0) % 360.0 - 180.0
    return abs(err), float(math.hypot(tf[0, 3] - tx, tf[1, 3] - ty))


def run_registration_cli(match_file: str, cloud_dir: str, report: str,
                         extra=()):
    """``batch_top_part_registration.main`` as a user calls it; returns the
    per-pair reports the pipeline produced along with the written bytes."""
    import pctpu.cli.batch_top_part_registration as cli

    captured = []
    run = cli.run_batch_top_part_registration

    def keep(*a, **k):
        captured.append(run(*a, **k))
        return captured[-1]

    cli.run_batch_top_part_registration = keep
    try:
        assert cli.main([match_file, cloud_dir, f"--report={report}",
                         *extra]) == 0
    finally:
        cli.run_batch_top_part_registration = run
    with open(report, "rb") as f:
        return captured[0], f.read()


def run_bev_cli(root: str, *extra):
    from pctpu.cli.batch_multi_bev_gen import main

    assert main([root, "HDL_64E", *extra]) == 0


# --- phases ----------------------------------------------------------------


def phase_bev(work: str, seed: int) -> None:
    from pctpu.config import get_sensor_params
    from tests import native_oracle

    root = os.path.join(work, "bev")
    write_bev_tree(root, N_CLOUDS, seed)
    params = get_sensor_params("HDL_64E")
    with Phase("bev_bitexact"):
        run_bev_cli(root, "--compat=bitexact")
    first = tree_digest(root, BEV_OUTPUTS)
    exact = [read_bev_artifacts(root, i) for i in range(N_CLOUDS)]
    with Phase("bev_oracle_compare"):
        assert native_oracle.available(), "native oracle did not build"
        report = native_oracle.compare_kitti_artifacts(
            root, params, range(N_CLOUDS))
        bad = [r for r in report if not r.startswith("BYTES-OK")]
        assert not bad, f"bit-exact BEV differs from the oracle: {bad[:5]}"
        print(f"bev: {len(report)} artifacts byte-identical to the native "
              f"oracle over {N_CLOUDS} clouds", flush=True)
    with Phase("bev_tolerance"):
        run_bev_cli(root, "--compat=tolerance")
    flips = changed = 0
    for i in range(N_CLOUDS):
        f, c = check_tolerance_window(
            exact[i], read_bev_artifacts(root, i),
            len(exact[i][0]))
        flips, changed = flips + f, changed + c
    print(f"bev: tolerance mode within D1 over {N_CLOUDS} clouds "
          f"({flips} label flips, {changed} BEV pixels changed)", flush=True)
    with Phase("bev_bitexact_rerun"):
        run_bev_cli(root, "--compat=bitexact")
    again = tree_digest(root, BEV_OUTPUTS)
    assert again == first, "bit-exact rerun is not byte-identical"
    print(f"bev: rerun byte-identical ({len(first)} files)", flush=True)
    shutil.rmtree(root)


def phase_registration(work: str, seed: int) -> None:
    from pctpu.pipelines.registration import default_pair_batch

    root = os.path.join(work, "reg")
    truths = write_registration_tree(root, N_PAIRS, seed)
    match = os.path.join(root, "match_result.txt")
    clouds = os.path.join(root, "clouds")
    print(f"registration: default pair batch {default_pair_batch()}",
          flush=True)
    with Phase("registration"):
        reports, blob = run_registration_cli(
            match, clouds, os.path.join(root, "r1.txt"))
    worst_yaw = worst_t = 0.0
    for rep, truth in zip(reports, truths, strict=True):
        assert rep.success, f"pair {rep.query_idx} failed: {rep}"
        e_yaw, e_t = pair_errors(rep.transform_fine, truth)
        assert e_yaw < 0.5, f"pair {rep.query_idx}: yaw error {e_yaw}°"
        assert e_t < 0.1, f"pair {rep.query_idx}: shift error {e_t} m"
        worst_yaw, worst_t = max(worst_yaw, e_yaw), max(worst_t, e_t)
    print(f"registration: {len(reports)} pairs inside <0.5° "
          f"(worst yaw error {worst_yaw:.4g}°, worst shift error "
          f"{worst_t:.4g} m)", flush=True)
    with Phase("registration_rerun"):
        _, blob2 = run_registration_cli(
            match, clouds, os.path.join(root, "r2.txt"))
    assert blob2 == blob, "registration rerun report differs"
    print(f"registration: rerun report byte-identical ({len(blob)} bytes)",
          flush=True)
    shutil.rmtree(root)


def phase_nn() -> None:
    import jax
    import jax.numpy as jnp

    from pctpu.ops.knn import nn_1_jit
    from pctpu.ops.pallas_knn import (
        check_against_nn_1,
        pallas_nn_1_pruned,
        spatial_sort,
    )

    rng = np.random.default_rng(7)
    pts = rng.uniform(-70, 70, (NN_POINTS, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 8, NN_POINTS).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.5, pts.shape)).astype(np.float32)
    ones = jnp.ones(NN_POINTS, bool)
    q, qm, _ = spatial_sort(jnp.asarray(pts), ones)
    t, tm, _ = spatial_sort(jnp.asarray(tgt), ones)
    with Phase("nn"):
        ref = jax.device_get(nn_1_jit(q, qm, t, tm))
        for md in (1.0, None):
            got = jax.device_get(
                pallas_nn_1_pruned(q, qm, t, tm, max_distance=md))
            swaps = check_against_nn_1(t, ref, got, max_distance=md)
            print(f"nn: kernel == nn_1 at {NN_POINTS}x{NN_POINTS}, "
                  f"max_distance={md} ({swaps} winner swaps inside the "
                  "score window)", flush=True)


def phase_oracle() -> None:
    from tests import ref_impl
    from tests.test_twostage_differential import (
        assert_two_stage_matches,
        run_production,
        to_dicts,
        twostage_scene,
    )

    with Phase("oracle"):
        for seed in ORACLE_SEEDS:
            xyz1, lab1, xyz2, lab2, guess, _ = twostage_scene(seed)
            ref = ref_impl.two_stage_ref(to_dicts(xyz1, lab1),
                                         to_dicts(xyz2, lab2), guess)
            best, fine = run_production(xyz1, lab1, xyz2, lab2, guess,
                                        capacity=4096, flat_cap=4096)
            assert_two_stage_matches(best, fine, ref)
        print(f"oracle: {len(ORACLE_SEEDS)} pairs match the f64 two-stage "
              "oracle", flush=True)


def phase_four_cards(work: str, seed: int) -> None:
    """Both CLIs with --devices=4 against device 0 alone, byte for byte."""
    import jax

    assert len(jax.devices()) >= 4, "--four-cards needs 4 devices"
    root = os.path.join(work, "bev4")
    write_bev_tree(root, 32, seed)
    with Phase("bev_devices4"):
        run_bev_cli(root, "--devices=4")
    four = tree_digest(root, BEV_OUTPUTS)
    with Phase("bev_device0"):
        run_bev_cli(root)
    assert tree_digest(root, BEV_OUTPUTS) == four, (
        "multi-BEV --devices=4 differs from one device"
    )
    print(f"four-cards: multi-BEV --devices=4 byte-identical to one device "
          f"({len(four)} files)", flush=True)
    # the default pair batch is per device: 4 x 16 pairs give every card
    # the batch one card runs, and one card runs them as 4 batches
    reg = os.path.join(work, "reg4")
    write_registration_tree(reg, 4 * N_PAIRS, seed)
    match = os.path.join(reg, "match_result.txt")
    clouds = os.path.join(reg, "clouds")
    with Phase("registration_devices4"):
        _, blob4 = run_registration_cli(match, clouds,
                                        os.path.join(reg, "r4.txt"),
                                        ["--devices=4"])
    with Phase("registration_device0"):
        _, blob1 = run_registration_cli(match, clouds,
                                        os.path.join(reg, "r1.txt"))
    assert blob4 == blob1, "registration --devices=4 report differs"
    print(f"four-cards: registration --devices=4 report byte-identical to "
          f"one device ({4 * N_PAIRS} pairs, {len(blob1)} bytes)", flush=True)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.local_devices()]
    print(f"four-cards: peak bytes in use per device {peaks}", flush=True)
    assert all(p > 100 * 2**20 for p in peaks[:4]), (
        "a device of the mesh did no work"
    )


def main(argv: list[str]) -> int:
    seed = next((int(a.split("=", 1)[1]) for a in argv
                 if a.startswith("--seed=")), 0)
    import jax

    from pctpu.runtime.platform import enable_compile_cache

    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    platform, kind, count = check_device()
    work = tempfile.mkdtemp(prefix="pctpu_smoke_")
    try:
        if "--four-cards" in argv:
            phase_four_cards(work, seed)
        else:
            phase_bev(work, seed)
            phase_registration(work, seed)
            phase_nn()
            phase_oracle()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
