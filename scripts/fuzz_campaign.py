"""Long-running differential fuzz campaign: fresh-seed sweeps of the fused
preprocess (ordering → ground marking → multi/single BEV) against the
plain-loop oracle (tests/ref_impl.py), plus the registration prep ops.

This is the out-of-suite big brother of tests/test_fuzz_differential.py: the
suite pins a fixed seed set for CI determinism; this script walks fresh seed
ranges for hours to hunt bit-parity knife edges the fixed set misses
(rounds 2-3 each ran ~1000-seed campaigns this way; divergences found become
pinned regression seeds in the suite).

Checks per case:
  * bit-exact mode labels / multi BEV / single BEV == oracle (hard failure);
  * tolerance mode vs bit-exact mode (reported: label flips are allowed by
    the BASELINE.json:5 acceptance window but we record every occurrence and
    the resulting BEV pixel delta so the "pixel-identical so far" claim
    stays measured, not assumed).

Usage:  python -m scripts.fuzz_campaign --start 20000 --cases 500 [--sensors]
Exit status: 1 on any bit-exact divergence, else 0.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # repo root (tests/ is a package there)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=20000,
                    help="first seed (use fresh ranges per campaign)")
    ap.add_argument("--cases", type=int, default=500,
                    help="cases per regime")
    ap.add_argument("--sensors", action="store_true",
                    help="also run full-grid sensor-preset cases (slow oracle)")
    ap.add_argument("--prep-every", type=int, default=4,
                    help="run voxel/topflatten oracles every Nth case")
    ap.add_argument("--icp", type=int, default=0,
                    help="also run N per-iteration ICP differential cases "
                         "per estimation mode (filtered knife-edge sweep)")
    ap.add_argument("--normals", type=int, default=0,
                    help="also run N normals2d cases per search mode "
                         "(radius + setKSearch vs the PCL loop oracles)")
    ap.add_argument("--misc", type=int, default=0,
                    help="also run N float-BEV + PCA2D oracle cases")
    ap.add_argument("--twostage", type=int, default=0,
                    help="also run N end-to-end two-stage registration "
                         "differential cases (register_pair vs the composed "
                         "plain-loop oracle; every 3rd case adds the "
                         "whole-cloud ablation glue; ~25-40 s/case)")
    ap.add_argument("--adversarial", type=int, default=0,
                    help="also run N adversarial real-log SHAPE cases "
                         "(over-capacity clouds via host compaction, dropped "
                         "azimuth sectors, degenerate all/zero-ground "
                         "scenes) vs the plain-loop oracle on the FULL "
                         "uncompacted point list")
    ap.add_argument("--native", type=int, default=0,
                    help="also run N cases per regime against the native C++ "
                         "oracle (native/ref_oracle.cpp): pctpu vs C++ "
                         "byte-diff every case (fast), plus the Python "
                         "oracle as a third implementation every 4th case")
    ap.add_argument("--kitti-raw", type=int, default=0,
                    help="also run N raw-variant KITTI structuring cases "
                         "(assign_rings_raw + structure_cloud) byte-diffed "
                         "vs the plain-loop oracle, mixing clean sweeps, "
                         "noise, zero-azimuth knife edges and ring overflow")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from pctpu.ops.bev import fused_multi_single_bev
    from pctpu.ops.ground import mark_ground
    from pctpu.ops.ordering import get_ordered_cloud
    from pctpu.ops.topflatten import extract_top_and_flatten
    from pctpu.ops.voxel import voxel_downsample

    from tests import ref_impl
    from tests.test_fuzz_differential import REGIMES, _regime_points
    from tests.test_ops_preprocess import SMALL, ordered_ref_arrays, to_cloud

    t0 = time.time()
    failures = 0
    tol_label_flips = 0
    tol_bev_px = 0
    n_done = 0

    for case in range(args.cases):
        for regime, (n, neg1, z_lo, z_hi, r_lo, r_hi) in enumerate(REGIMES):
            seed = args.start + 100_000 * regime + case
            rng = np.random.default_rng(seed)
            pts = _regime_points(rng, n, neg1, z_lo, z_hi, r_lo, r_hi, SMALL)

            ref_cloud, _ = ordered_ref_arrays(pts, SMALL)
            ref_impl.mark_ground_ref(
                ref_cloud, SMALL.n_scan, SMALL.horizon_scan,
                SMALL.ground_upper_scan,
            )
            ref_labels = np.array([p["label"] for p in ref_cloud], np.int32)
            ref_multi = ref_impl.multi_bev_ref(ref_cloud, SMALL.height_res)
            ref_single = ref_impl.single_bev_ref(ref_cloud)

            ordered = get_ordered_cloud(to_cloud(pts), SMALL)
            labeled, _ = mark_ground(ordered, SMALL)
            fm, fs = fused_multi_single_bev(labeled, SMALL.height_res)

            ok = (
                np.array_equal(np.asarray(labeled.label), ref_labels)
                and np.array_equal(np.asarray(fm), ref_multi)
                and np.array_equal(np.asarray(fs), ref_single)
            )
            if not ok:
                failures += 1
                print(f"FAIL bitexact regime={regime} seed={seed}", flush=True)

            # tolerance mode vs bit-exact mode
            lab_t, _ = mark_ground(ordered, SMALL, compat="tolerance")
            fm_t, fs_t = fused_multi_single_bev(lab_t, SMALL.height_res)
            flips = int(np.sum(np.asarray(lab_t.label) != np.asarray(labeled.label)))
            if flips:
                tol_label_flips += flips
                dpx = int(np.sum(np.asarray(fm_t) != np.asarray(fm))) + int(
                    np.sum(np.asarray(fs_t) != np.asarray(fs))
                )
                tol_bev_px += dpx
                print(
                    f"TOL-DIVERGE regime={regime} seed={seed} "
                    f"label_flips={flips} bev_px={dpx}",
                    flush=True,
                )

            if case % args.prep_every == 0:
                prng = np.random.default_rng(seed ^ 0x5EED)
                p3 = prng.uniform(-60, 60, (400, 3)).astype(np.float32)
                p3[:, 2] = prng.uniform(-2, 10, 400).astype(np.float32)
                ref_v = ref_impl.voxel_ref(p3, 0.2)
                out, valid, count = voxel_downsample(p3, np.ones(400, bool), 0.2)
                if int(count) != len(ref_v) or not np.allclose(
                    np.asarray(out)[: int(count)], ref_v, atol=1e-5
                ):
                    failures += 1
                    print(f"FAIL voxel seed={seed}", flush=True)
                from tests.test_ops_registration import (
                    scene_cloud,
                    to_cloud as reg_to_cloud,
                )

                scene = scene_cloud(prng)
                ref_f = np.asarray(
                    ref_impl.top_flatten_ref(scene), np.float32
                ).reshape(-1, 3)
                xyz, mask, cnt = extract_top_and_flatten(
                    reg_to_cloud(scene, capacity=1024)
                )
                got = np.asarray(xyz)[np.asarray(mask)]

                def lexsorted(a):
                    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]

                if int(cnt) != len(ref_f) or not np.array_equal(
                    lexsorted(got), lexsorted(ref_f)
                ):
                    failures += 1
                    print(f"FAIL topflatten seed={seed}", flush=True)

            n_done += 1

        if case % 10 == 9:
            rate = n_done / (time.time() - t0)
            print(
                f"[{time.time() - t0:7.0f}s] {n_done} cases "
                f"({rate:.1f}/s) failures={failures} "
                f"tol_flips={tol_label_flips} tol_bev_px={tol_bev_px}",
                flush=True,
            )

    if args.sensors:
        from pctpu.config import get_sensor_params

        for i, sensor in enumerate(("HDL_32E", "HDL_64E", "OS1_64")):
            params = get_sensor_params(sensor)
            rng = np.random.default_rng(args.start + 900_000 + i)
            pts = _regime_points(rng, 600, 0.15, -2.5, 4.0, 2.0, 90.0, params)
            ref_cloud, _ = ordered_ref_arrays(pts, params)
            ref_impl.mark_ground_ref(
                ref_cloud, params.n_scan, params.horizon_scan,
                params.ground_upper_scan,
            )
            ordered = get_ordered_cloud(to_cloud(pts), params)
            labeled, _ = mark_ground(ordered, params)
            ref_labels = np.array([p["label"] for p in ref_cloud], np.int32)
            if not np.array_equal(np.asarray(labeled.label), ref_labels):
                failures += 1
                print(f"FAIL sensor={sensor}", flush=True)
            fm, fs = fused_multi_single_bev(labeled, params.height_res)
            if not np.array_equal(
                np.asarray(fm), ref_impl.multi_bev_ref(ref_cloud, params.height_res)
            ) or not np.array_equal(
                np.asarray(fs), ref_impl.single_bev_ref(ref_cloud)
            ):
                failures += 1
                print(f"FAIL sensor BEV={sensor}", flush=True)
            print(f"sensor {sensor} ok", flush=True)

    if args.icp:
        failures += run_icp_sweep(args.start, args.icp)
    if args.normals:
        failures += run_normals_sweep(args.start, args.normals)
    if args.misc:
        failures += run_misc_sweep(args.start, args.misc)
    if args.twostage:
        failures += run_twostage_sweep(args.start, args.twostage)
    if args.adversarial:
        failures += run_adversarial_sweep(args.start, args.adversarial)
    if args.native:
        failures += run_native_sweep(args.start, args.native)
    if args.kitti_raw:
        failures += run_kitti_raw_sweep(args.start, args.kitti_raw)

    print(
        f"DONE: {n_done} cases in {time.time() - t0:.0f}s, "
        f"failures={failures}, tolerance label flips={tol_label_flips} "
        f"(bev px delta {tol_bev_px})",
        flush=True,
    )
    return 1 if failures else 0


def run_adversarial_sweep(start: int, n_cases: int) -> int:
    """Adversarial real-log SHAPE sweep (VERDICT r3 item 4's fuzz leg).

    Each case builds a pathological cloud the happy-path regimes never
    produce — larger than the grid capacity (exercising the host last-wins
    compaction, pctpu.ops.ordering.compact_last_wins), with dropped azimuth
    sectors (contiguous col ranges absent), heavy duplicate-cell pressure,
    and degenerate all-ground / zero-ground z distributions — then runs the
    full preprocess (compaction → ordering → ground → fused BEV) against
    the plain-loop Python oracle applied to the FULL uncompacted point
    list.  Bit-exact equality is a hard failure."""
    import time

    import numpy as np

    from pctpu.ops.bev import fused_multi_single_bev
    from pctpu.ops.ground import mark_ground
    from pctpu.ops.ordering import compact_last_wins, get_ordered_cloud

    from tests import ref_impl
    from tests.test_ops_preprocess import SMALL, to_cloud

    g = SMALL.grid_size
    failures = 0
    t0 = time.time()
    for case in range(n_cases):
        seed = start + 700_000 + case
        rng = np.random.default_rng(seed)
        shape = case % 4
        n = int(rng.integers(g + 1, 3 * g))  # always over capacity
        rows = rng.integers(-1, SMALL.n_scan + 1, n)
        # dropped azimuth sectors: one or two contiguous col bands absent
        cols = rng.integers(-1, SMALL.horizon_scan + 1, n)
        for _ in range(int(rng.integers(1, 3))):
            lo = int(rng.integers(0, SMALL.horizon_scan - 2))
            hi = lo + int(rng.integers(1, SMALL.horizon_scan // 3))
            dead = (cols >= lo) & (cols < hi)
            cols[dead] = (hi + 1) % SMALL.horizon_scan
        if shape == 1:  # all-ground: flat plane
            z = rng.uniform(-1.95, -1.85, n)
        elif shape == 2:  # zero-ground: steep wall band
            z = 2.0 + 0.8 * (SMALL.n_scan - rows)
        else:
            z = rng.uniform(-2.5, 4.0, n)
        r = rng.uniform(2.0, 60.0, n)
        az = rng.uniform(-np.pi, np.pi, n)
        pts = [
            {"x": float(np.float32(r[i] * np.cos(az[i]))),
             "y": float(np.float32(r[i] * np.sin(az[i]))),
             "z": float(np.float32(z[i])),
             "intensity": -1.0 if rng.random() < 0.2
             else float(np.float32(rng.random())),
             "row": int(rows[i]), "col": int(cols[i]),
             "t": int(rng.integers(0, 1000)), "label": -2}
            for i in range(n)
        ]

        ref_cloud = ref_impl.ordered_cloud_ref(
            pts, SMALL.n_scan, SMALL.horizon_scan
        )
        ref_impl.mark_ground_ref(
            ref_cloud, SMALL.n_scan, SMALL.horizon_scan,
            SMALL.ground_upper_scan,
        )
        ref_labels = np.array([p["label"] for p in ref_cloud], np.int32)
        ref_multi = ref_impl.multi_bev_ref(ref_cloud, SMALL.height_res)
        ref_single = ref_impl.single_bev_ref(ref_cloud)

        fields = {
            k: np.array([p[k] for p in pts]) for k in
            ("x", "y", "z", "intensity", "row", "col", "t", "label")
        }
        compacted, n_keep = compact_last_wins(fields, n, SMALL)
        assert n_keep <= g
        cpts = [
            {k: (float(v[i]) if v.dtype.kind == "f" else int(v[i]))
             for k, v in compacted.items()}
            for i in range(n_keep)
        ]
        ordered = get_ordered_cloud(to_cloud(cpts, capacity=g), SMALL)
        labeled, _ = mark_ground(ordered, SMALL)
        fm, fs = fused_multi_single_bev(labeled, SMALL.height_res)
        if not (
            np.array_equal(np.asarray(labeled.label), ref_labels)
            and np.array_equal(np.asarray(fm), ref_multi)
            and np.array_equal(np.asarray(fs), ref_single)
        ):
            failures += 1
            print(f"FAIL adversarial shape={shape} seed={seed}", flush=True)
        if case % 20 == 19:
            print(
                f"adversarial [{time.time() - t0:6.0f}s] {case + 1} cases "
                f"failures={failures}",
                flush=True,
            )
    print(f"adversarial: {n_cases} cases, failures={failures}", flush=True)
    return failures


def run_native_sweep(start: int, n_cases: int) -> int:
    """Triple-agreement sweep against the native C++ oracle.

    Every case byte-diffs pctpu's preprocess against native/ref_oracle.cpp
    (microseconds per case, so this leg covers far more seeds per hour than
    the Python-oracle legs); every 4th case additionally runs the Python
    plain-loop oracle so all THREE independent implementations are compared
    on the same inputs.  Also diffs float-BEV and top-flatten (in exact
    reference order) against their native transcriptions every 4th case.
    Returns the number of divergences.
    """
    import time

    import numpy as np

    from pctpu.config import FloatBevConfig
    from pctpu.ops.bev import float_bev, fused_multi_single_bev
    from pctpu.ops.ground import mark_ground
    from pctpu.ops.ordering import get_ordered_cloud
    from pctpu.ops.topflatten import extract_top_and_flatten

    from tests import native_oracle
    from tests.test_fuzz_differential import REGIMES, _regime_points
    from tests.test_ops_preprocess import SMALL, to_cloud
    from tests.test_ops_registration import (
        scene_cloud,
        to_cloud as reg_to_cloud,
    )

    if not native_oracle.available():
        print("native oracle build unavailable — leg skipped", flush=True)
        return 0

    failures = n_done = 0
    t0 = time.time()
    for case in range(n_cases):
        for regime, (n, neg1, z_lo, z_hi, r_lo, r_hi) in enumerate(REGIMES):
            seed = start + 500_000 + 100_000 * regime + case
            rng = np.random.default_rng(seed)
            pts = _regime_points(rng, n, neg1, z_lo, z_hi, r_lo, r_hi, SMALL)

            nat_labels, nat_multi, nat_single, nat_xyz = (
                native_oracle.preprocess(pts, SMALL)
            )
            ordered = get_ordered_cloud(to_cloud(pts), SMALL)
            labeled, _ = mark_ground(ordered, SMALL)
            fm, fs = fused_multi_single_bev(labeled, SMALL.height_res)
            if not (
                np.array_equal(np.asarray(ordered.xyz), nat_xyz)
                and np.array_equal(np.asarray(labeled.label), nat_labels)
                and np.array_equal(np.asarray(fm), nat_multi)
                and np.array_equal(np.asarray(fs), nat_single)
            ):
                failures += 1
                print(f"FAIL native-vs-pctpu regime={regime} seed={seed}",
                      flush=True)

            if case % 4 == 0:
                from tests.test_native_oracle import _python_oracle

                py_labels, py_multi, py_single, _ = _python_oracle(pts, SMALL)
                if not (
                    np.array_equal(nat_labels, py_labels)
                    and np.array_equal(nat_multi, py_multi)
                    and np.array_equal(nat_single, py_single)
                ):
                    failures += 1
                    print(f"FAIL native-vs-python regime={regime} seed={seed}",
                          flush=True)
            n_done += 1

        if case % 4 == 0:
            prng = np.random.default_rng(start + 500_000 + case)
            scene = scene_cloud(prng)
            xyz = np.array(
                [[p["x"], p["y"], p["z"]] for p in scene], np.float32
            )
            lab = np.array([p["label"] for p in scene], np.int32)
            cloud = reg_to_cloud(scene, capacity=1024)
            for fg in (False, True):
                nat_f = native_oracle.float_bev(xyz, lab, fg)
                got_f = np.asarray(
                    float_bev(cloud, FloatBevConfig(filter_ground=fg))
                )
                if not np.array_equal(got_f, nat_f):
                    failures += 1
                    print(f"FAIL native float_bev filt={fg} case={case}",
                          flush=True)
            nat_t = native_oracle.top_flatten(xyz, lab)
            out, mask, cnt = extract_top_and_flatten(cloud)
            got_t = np.asarray(out)[np.asarray(mask)]
            if int(cnt) != len(nat_t) or not np.array_equal(got_t, nat_t):
                failures += 1
                print(f"FAIL native top_flatten case={case}", flush=True)

        if case % 20 == 19:
            rate = n_done / (time.time() - t0)
            print(
                f"native [{time.time() - t0:6.0f}s] {n_done} cases "
                f"({rate:.1f}/s) failures={failures}",
                flush=True,
            )
    print(f"native: {n_done} cases, failures={failures}", flush=True)
    return failures


def run_misc_sweep(start: int, n_cases: int) -> int:
    """float-BEV (both CloudManip/BatchCloudManip ground-filter variants) and
    PCA2D fit (with/without indices) against their loop oracles."""
    import numpy as np

    from pctpu.cloud import make_cloud
    from pctpu.config import FloatBevConfig
    from pctpu.ops.bev import float_bev
    from pctpu.ops.pca2d import PCA2D

    from tests import ref_impl

    failures = 0
    for case in range(n_cases):
        seed = start + case
        rng = np.random.default_rng(seed)
        n = int(rng.integers(30, 500))
        pts = [
            {"x": float(np.float32(rng.uniform(-110, 110))),
             "y": float(np.float32(rng.uniform(-110, 110))),
             "z": float(np.float32(rng.uniform(-2.5, 6.0))),
             "intensity": 0.5, "row": 0, "col": 0, "t": 0,
             "label": 0 if rng.random() < 0.3 else -2}
            for _ in range(n)
        ]
        cloud = make_cloud(
            np.array([[p["x"], p["y"], p["z"]] for p in pts], np.float32),
            label=np.array([p["label"] for p in pts], np.int32),
        )
        for filt in (False, True):
            ref = ref_impl.float_bev_ref(pts, filter_ground=filt)
            got = np.asarray(float_bev(cloud, FloatBevConfig(filter_ground=filt)))
            if not np.array_equal(got, ref.astype(np.float32)):
                failures += 1
                print(f"FAIL float_bev filt={filt} seed={seed}", flush=True)

        p2 = rng.normal(0, [rng.uniform(0.5, 4.0), rng.uniform(0.1, 2.0)],
                        (max(n, 4), 2)).astype(np.float32)
        xyz = np.concatenate([p2, np.zeros((len(p2), 1), np.float32)], axis=1)
        indices = (np.sort(rng.choice(len(p2), max(3, len(p2) // 2),
                                      replace=False))
                   if case % 2 else None)
        ref_mean, ref_w, ref_v = ref_impl.pca2d_ref(xyz, indices)
        pca = PCA2D()
        pca.set_input_cloud(xyz)
        pca.set_indices(indices)
        ok = (
            np.allclose(np.asarray(pca.get_mean()), ref_mean, atol=1e-4)
            and np.allclose(np.asarray(pca.get_eigen_values()), ref_w,
                            rtol=1e-3, atol=1e-2)
        )
        v = np.asarray(pca.get_eigen_vectors())
        for col in range(2):
            d = min(np.linalg.norm(v[:, col] - ref_v[:, col]),
                    np.linalg.norm(v[:, col] + ref_v[:, col]))
            ok = ok and d < 1e-2
        if not ok:
            failures += 1
            print(f"FAIL pca2d seed={seed}", flush=True)
    print(f"misc (float_bev + pca2d): {n_cases} cases, failures={failures}",
          flush=True)
    return failures


def normals_scene(seed: int):
    """The normals-sweep scene: anisotropic cluster + noisy line (the
    L2-suite shape) with varied density and scale per seed.  Module-level so
    the suite can rebuild pinned knife-edge seeds (tests/test_l2_api.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 200))
    a = rng.normal(0, [rng.uniform(0.5, 4.0), rng.uniform(0.1, 1.0)],
                   (n // 2, 2))
    t = rng.uniform(-5, 5, n - n // 2)
    b = np.stack([t, rng.uniform(-1, 1) * t + rng.normal(0, 0.1, len(t))], 1)
    p2 = np.concatenate([a, b]).astype(np.float32)
    xyz = np.concatenate([p2, np.zeros((n, 1), np.float32)], axis=1)
    return p2, xyz


def run_normals_sweep(start: int, n_cases: int) -> int:
    """Fresh-seed normals2d differential sweep, radius and setKSearch modes.

    Validity masks must match the oracle exactly; normals match up to the
    eigen-solver sign within 5e-3 (the suite's tolerance —
    exact-perpendicular viewpoint ties are sign-ambiguous in PCL too).

    Neighbor-selection knife edges (ledger D3: a point whose exact d² sits
    within the matmul-form score's rounding window of the decision boundary —
    the radius r², or the k-th-neighbor distance in setKSearch mode) are
    EXPLAINED, not just tolerated: the divergence is accepted only when the
    plain oracle recomputed on the alternative neighbor set reproduces the
    op's normal (ref_impl.normals2d_knife_edge_sets).  First hit: campaign
    seeds 1300004 (k=2 near-tied 2nd neighbor, d²-gap 5.4e-7) and 1300047
    (radius-4 boundary point at |d²−r²|=4.3e-6), both explained and pinned
    in the suite.  Returns the number of UNEXPLAINED divergences.
    """
    import numpy as np

    from pctpu.ops.normals2d import normals_2d, normals_2d_knn

    from tests import ref_impl

    failures = 0
    knife_edges = 0
    radii = (1.0, 2.0, 4.0)
    ks = (2, 5, 9, 30)
    for case in range(n_cases):
        seed = start + case
        p2, xyz = normals_scene(seed)
        n = len(p2)
        mask = np.ones(n, bool)

        # conditioning-aware tolerance: the op assembles each neighborhood
        # scatter from uncentered f32 moments (S = Σppᵀ − c·μμᵀ, see
        # ops/normals2d.py) whose ~|p−c|²·cnt·2⁻²³ cancellation error is
        # amplified by 1/(λ₁−λ₀) in the eigenvector — a near-isotropic
        # neighborhood (gap → 0) has an ill-defined normal direction in BOTH
        # stacks (first seen at fuzz seed 800381: gap ratio 0.69, d=0.007)
        bbox_c = 0.5 * (p2.min(axis=0) + p2.max(axis=0))
        r_sq = float(np.max(np.sum((p2 - bbox_c) ** 2, axis=1)))

        def allowed(i, neighborhood):
            sel = neighborhood.astype(np.float64)
            mu = sel.mean(axis=0)
            d = sel - mu
            w = np.linalg.eigvalsh(d.T @ d)
            gap = max(float(w[1] - w[0]), 1e-12)
            amp = r_sq * len(sel) * 2.0**-23 / gap
            return max(5e-3, min(0.1, 4.0 * amp))

        # decision-boundary rounding window of the op's matmul-form scores
        # (|t|² − 2q·t + q² over bbox-centered coords): ~|p−c|²·2⁻²³
        # absolute, with headroom for the sum order.  Scaled PER (query,
        # candidate) pair — max(|p_i−c|², |p_j−c|²), not the scene-wide
        # maximum, so points near the bbox center don't get a window far
        # wider than their actual rounding error (ADVICE r4: a genuine
        # neighbor-selection bug there must not hide behind the scene's
        # worst-case window)
        r2_pts = np.sum((p2.astype(np.float64) - bbox_c) ** 2, axis=1)

        def win_for(i):
            return 32.0 * np.maximum(r2_pts[i], r2_pts) * 2.0 ** -23

        def check(name, nrm, ok, ref_n, ref_ok, nbr_of, alt_sets):
            nonlocal failures, knife_edges
            if not np.array_equal(np.asarray(ok), ref_ok):
                failures += 1
                print(f"FAIL normals {name} seed={seed}: validity mask",
                      flush=True)
                return
            ours = np.asarray(nrm)[:, :2]
            for i in np.flatnonzero(ref_ok):
                d = min(np.linalg.norm(ours[i] - ref_n[i]),
                        np.linalg.norm(ours[i] + ref_n[i]))
                if d < 5e-3 or d < allowed(i, nbr_of(i)):
                    continue
                explained = False
                for alt in alt_sets(i):
                    alt_n = ref_impl.normal2d_from_set(p2, i, alt)
                    if alt_n is None:
                        continue
                    d_alt = min(np.linalg.norm(ours[i] - alt_n),
                                np.linalg.norm(ours[i] + alt_n))
                    if d_alt < 5e-3 or d_alt < allowed(i, p2[alt]):
                        explained = True
                        break
                if explained:
                    knife_edges += 1
                    print(f"KNIFE-EDGE normals {name} seed={seed} i={i} "
                          f"d={d:.4g} (oracle on the boundary-window "
                          f"neighbor swap matches)", flush=True)
                    continue
                failures += 1
                print(f"FAIL normals {name} seed={seed} i={i} d={d}",
                      flush=True)
                break

        d2_all = np.sum(
            (p2.astype(np.float64)[None] - p2.astype(np.float64)[:, None]) ** 2,
            axis=2,
        )

        r = radii[case % len(radii)]
        nrm, _, ok = normals_2d(xyz, mask, radius=r)
        ref_n, ref_ok = ref_impl.normals2d_ref(xyz, radius=r)
        check(f"radius={r}", nrm, ok, ref_n, ref_ok,
              lambda i, r=r: p2[d2_all[i] < r * r],
              lambda i, r=r: ref_impl.normals2d_knife_edge_sets(
                  p2, i, win_for(i), radius=r))

        k = ks[case % len(ks)]
        nrm, _, ok = normals_2d_knn(xyz, mask, k)
        ref_n, ref_ok = ref_impl.normals2d_knn_ref(xyz, k)
        check(f"k={k}", nrm, ok, ref_n, ref_ok,
              lambda i, k=k: p2[np.argsort(d2_all[i], kind="stable")[:k]],
              lambda i, k=k: ref_impl.normals2d_knife_edge_sets(
                  p2, i, win_for(i), k=k))
    print(f"normals2d: {n_cases} cases per mode, failures={failures}, "
          f"knife_edges={knife_edges} (explained)", flush=True)
    return failures


def run_icp_sweep(start: int, target_asserted: int) -> int:
    """Fresh-seed per-iteration ICP differential sweep, both estimation modes.

    Reuses the suite's knife-edge filter (tests/test_icp_differential.py): a
    seed only asserts when the f64 oracle's exit iteration and convergence
    flag are stable under a 1e-6 perturbation AND no MSE plateau makes the
    1e-12 absolute exit an f32-vs-f64 coin flip.  Walks seeds until
    ``target_asserted`` cases asserted per mode (or 5× that many were
    examined).  Returns the number of divergences.
    """
    import numpy as np

    from pctpu.config import IcpConfig

    from tests import ref_impl
    from tests.test_icp_differential import (
        _plane_scene,
        assert_traces_match,
        run_both,
        scene,
    )

    failures = 0
    for mode in ("point", "plane"):
        asserted = examined = 0
        seed = start
        while asserted < target_asserted and examined < 5 * target_asserted:
            seed += 1
            examined += 1
            guess = np.eye(4, dtype=np.float32)
            if mode == "point":
                yaw = 2.0 + (seed % 11) * 1.7
                shift = (0.2 + 0.04 * (seed % 6), -0.25 + 0.09 * (seed % 4),
                         0.05 * (seed % 3))
                src, tgt = scene(seed, yaw_deg=yaw, shift=shift)
                cfg = IcpConfig(max_correspondence_distance=4.0,
                                max_iterations=8)
                nrm = ok = None
            else:
                yaw = 1.5 + (seed % 7) * 1.3
                shift = (0.1 + 0.05 * (seed % 5), -0.15 + 0.07 * (seed % 4), 0.0)
                src, tgt, nrm, ok = _plane_scene(seed, yaw, shift)
                cfg = IcpConfig(max_correspondence_distance=10.0,
                                max_iterations=4, point_to_plane=True)

            def oracle(s):
                return ref_impl.icp_ref(
                    s, tgt, guess, cfg.max_correspondence_distance,
                    cfg.max_iterations, cfg.transformation_epsilon,
                    cfg.euclidean_fitness_epsilon, tgt_normals=nrm,
                    normal_ok=ok,
                )

            ref_a = oracle(src)
            ref_b = oracle(src + np.float32(1e-6))
            if (len(ref_a["trace"]) != len(ref_b["trace"])
                    or ref_a["converged"] != ref_b["converged"]):
                continue
            mses = [m for _, m, _ in ref_a["trace"] if np.isfinite(m)]
            # plateau filter margin: the f32 stack's MSE carries ~1 ulp
            # (1.2e-7 relative) of rounding, so consecutive f64 MSEs closer
            # than a few f32 ulps can round EQUAL in f32 and trip the 1e-12
            # absolute exit one iteration early (first seen at fuzz seed
            # 800479, oracle diff 4.3e-10 ≈ 2 ulps) — require ≥ 5e-7
            if any(abs(b - a) < 5e-7 * max(b, 1e-9)
                   for a, b in zip(mses, mses[1:])):
                continue

            try:
                res, trace, ref = run_both(src, tgt, guess, cfg,
                                           tgt_normals=nrm, normal_ok=ok)
                atol = 1e-3 if mode == "point" else 3e-3
                # score-domain d² window of the NN kernel (see
                # assert_traces_match docstring)
                win = 8.0 * float(np.max(np.sum(tgt * tgt, axis=1))) * 2.0**-23
                assert_traces_match(trace, ref, atol_t=atol, rtol_mse=atol,
                                    atol_mse=win)
                assert bool(res.converged) == ref["converged"]
                if mode == "point":
                    np.testing.assert_allclose(
                        float(res.fitness), ref["fitness"], rtol=2e-3,
                        atol=1e-7,
                    )
            except AssertionError as e:
                failures += 1
                print(f"FAIL icp mode={mode} seed={seed}: {e}", flush=True)
            asserted += 1
        print(
            f"icp {mode}: asserted {asserted}/{examined} examined "
            f"(seeds {start + 1}..{seed})",
            flush=True,
        )
    return failures


def run_twostage_sweep(start: int, target_asserted: int) -> int:
    """Fresh-seed END-TO-END two-stage registration differential: the
    production ``register_pair`` vs the composed plain-loop oracle
    (``ref_impl.two_stage_ref`` — every stage oracle glued the way the
    reference's main() glues the stages,
    /root/reference/BatchTopPartRegistration.cpp:356-532).

    Covers the glue the per-stage legs can't: the f32 guess chain, coarse
    best-of-two selection, fine-stage seeding, success classification, and
    the report arithmetic on both stacks' transforms.  Knife-edge scenes
    (oracle outcome unstable under a 1e-6 perturbation) are skipped, same
    policy as the per-iteration ICP leg.  Returns the divergence count.
    """
    import time

    from tests.test_twostage_differential import (
        assert_two_stage_matches,
        assert_whole_matches,
        oracle_stable,
        run_production,
        run_production_whole,
        twostage_scene,
        whole_oracle_stable,
    )

    failures = asserted = examined = 0
    seed = start
    t0 = time.time()
    while asserted < target_asserted and examined < 5 * target_asserted:
        seed += 1
        examined += 1
        xyz1, lab1, xyz2, lab2, guess, _ = twostage_scene(seed)
        ref, stable = oracle_stable(xyz1, lab1, xyz2, lab2, guess)
        if not stable:
            continue
        try:
            best, fine = run_production(xyz1, lab1, xyz2, lab2, guess)
            assert_two_stage_matches(best, fine, ref)
        except AssertionError as e:
            failures += 1
            print(f"FAIL twostage seed={seed}: {str(e)[:400]}", flush=True)
        if asserted % 3 == 0:
            # every 3rd case also runs the whole-cloud ablation glue
            # (register_whole_pairs vs ref_impl.whole_ref) on the same scene
            ref_w, stable_w = whole_oracle_stable(xyz1, lab1, xyz2, lab2, guess)
            if stable_w:
                try:
                    fine_w = run_production_whole(xyz1, lab1, xyz2, lab2, guess)
                    assert_whole_matches(fine_w, ref_w)
                except AssertionError as e:
                    failures += 1
                    print(f"FAIL whole seed={seed}: {str(e)[:400]}", flush=True)
        asserted += 1
        if asserted % 5 == 0:
            print(
                f"twostage: {asserted}/{examined} examined "
                f"({(time.time() - t0) / asserted:.1f} s/case) "
                f"failures={failures}",
                flush=True,
            )
    print(
        f"twostage: asserted {asserted}/{examined} examined "
        f"(seeds {start + 1}..{seed}), failures={failures}",
        flush=True,
    )
    return failures


def run_kitti_raw_sweep(start: int, n_cases: int) -> int:
    """Fresh-seed byte-diff of the raw-variant KITTI structuring
    (pctpu.io.kitti.assign_rings_raw + structure_cloud) against the
    plain-loop oracle (tests/ref_impl.kitti_raw_structured_ref).

    Scan regimes rotate per case: clean descending sweeps (reference-shaped
    rings), pure noise (spurious unguarded rings), azimuth knife edges
    (points exactly on the +x axis, az == 0, and tiny ±y jitter around the
    crossing), and >64-ring overflow.  Empty scans every 16th case."""
    from pctpu.io import kitti

    from tests import ref_impl

    failures = 0
    for case in range(n_cases):
        seed = start + case
        rng = np.random.default_rng(seed)
        regime = case % 4
        if case % 16 == 15:
            scan = np.zeros((0, 4), np.float32)
        elif regime == 0:
            rings = int(rng.integers(1, 10))
            per = int(rng.integers(5, 900))
            pts = []
            for k in range(rings):
                az = np.linspace(179.0, -179.0, per) + rng.normal(0, 0.5, per)
                r = rng.uniform(2.0, 70.0, per)
                pts.append(np.stack([
                    r * np.cos(np.radians(az)), r * np.sin(np.radians(az)),
                    rng.uniform(-2, 6, per), rng.random(per)], 1))
            scan = np.concatenate(pts).astype(np.float32)
        elif regime == 1:
            scan = rng.normal(0, 25, (int(rng.integers(1, 2500)), 4)).astype(
                np.float32)
        elif regime == 2:
            n = int(rng.integers(4, 400))
            x = rng.uniform(1.0, 50.0, n)
            y = np.where(rng.random(n) < 0.5, 0.0,
                         rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-8, -1, n))
            scan = np.stack([x, y, rng.uniform(-2, 6, n), rng.random(n)],
                            1).astype(np.float32)
        else:
            per = int(rng.integers(2, 30))
            pts = []
            for k in range(int(rng.integers(60, 90))):
                az = np.linspace(170.0, -170.0, per)
                r = rng.uniform(2.0, 70.0, per)
                pts.append(np.stack([
                    r * np.cos(np.radians(az)), r * np.sin(np.radians(az)),
                    rng.uniform(-2, 6, per), rng.random(per)], 1))
            scan = np.concatenate(pts).astype(np.float32)
        got = kitti.structure_cloud(scan, rings=kitti.assign_rings_raw(scan))
        want = ref_impl.kitti_raw_structured_ref(scan)
        for k in want:
            if not np.array_equal(got[k], want[k]):
                failures += 1
                print(f"FAIL kitti_raw field={k} seed={seed} regime={regime}",
                      flush=True)
                break
    print(f"kitti_raw structuring: {n_cases} cases, failures={failures}",
          flush=True)
    return failures


if __name__ == "__main__":
    sys.exit(main())
