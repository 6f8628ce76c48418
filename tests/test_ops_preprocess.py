"""Differential tests: vectorized device ops vs plain-loop oracle (ref_impl)."""

import numpy as np
import pytest

from pctpu.cloud import make_cloud
from pctpu.config import (
    FloatBevConfig,
    GroundConfig,
    MultiBevConfig,
    SensorParams,
    SingleBevConfig,
)
from pctpu.ops.bev import float_bev, multi_bev, single_bev
from pctpu.ops.ground import mark_ground
from pctpu.ops.ordering import get_ordered_cloud

from . import ref_impl

SMALL = SensorParams(n_scan=16, horizon_scan=32, ground_upper_scan=10, height_res=0.5)


def random_points(rng, n, params, intensity_neg1_frac=0.2):
    pts = []
    for _ in range(n):
        r = float(rng.uniform(2.0, 60.0))
        az = float(rng.uniform(-np.pi, np.pi))
        pts.append(
            {
                "x": float(np.float32(r * np.cos(az))),
                "y": float(np.float32(r * np.sin(az))),
                "z": float(np.float32(rng.uniform(-2.5, 4.0))),
                "intensity": -1.0 if rng.random() < intensity_neg1_frac else float(np.float32(rng.random())),
                "row": int(rng.integers(-1, params.n_scan + 1)),
                "col": int(rng.integers(-1, params.horizon_scan + 1)),
                "t": int(rng.integers(0, 1000)),
                "label": -2,
            }
        )
    return pts


def to_cloud(points, capacity=None):
    n = len(points)
    return make_cloud(
        np.array([[p["x"], p["y"], p["z"]] for p in points], np.float32).reshape(n, 3),
        intensity=np.array([p["intensity"] for p in points], np.float32),
        row=np.array([p["row"] for p in points], np.int32),
        col=np.array([p["col"] for p in points], np.int32),
        t=np.array([p["t"] for p in points], np.uint32),
        label=np.array([p["label"] for p in points], np.int32),
        capacity=capacity,
    )


def ordered_ref_arrays(points, params):
    ref = ref_impl.ordered_cloud_ref(points, params.n_scan, params.horizon_scan)
    xyz = np.array([[p["x"], p["y"], p["z"]] for p in ref], np.float32)
    return ref, xyz


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordering_matches_reference(seed):
    rng = np.random.default_rng(seed)
    points = random_points(rng, 300, SMALL)
    ref, ref_xyz = ordered_ref_arrays(points, SMALL)
    ours = get_ordered_cloud(to_cloud(points), SMALL)
    np.testing.assert_array_equal(np.asarray(ours.xyz), ref_xyz)
    np.testing.assert_array_equal(
        np.asarray(ours.intensity), [p["intensity"] for p in ref]
    )
    np.testing.assert_array_equal(np.asarray(ours.label), [p["label"] for p in ref])
    np.testing.assert_array_equal(np.asarray(ours.row), [p["row"] for p in ref])


def test_ordering_last_point_wins():
    pts = random_points(np.random.default_rng(3), 4, SMALL)
    for p in pts:
        p["row"], p["col"] = 5, 7  # all collide
    ours = get_ordered_cloud(to_cloud(pts), SMALL)
    idx = 5 * SMALL.horizon_scan + 7
    assert float(np.asarray(ours.x)[idx]) == pts[-1]["x"]


def test_ordering_padding_points_ignored():
    pts = random_points(np.random.default_rng(4), 10, SMALL)
    cloud_padded = to_cloud(pts, capacity=64)  # 54 zero-padding slots
    cloud_exact = to_cloud(pts)
    a = get_ordered_cloud(cloud_padded, SMALL)
    b = get_ordered_cloud(cloud_exact, SMALL)
    np.testing.assert_array_equal(np.asarray(a.xyz), np.asarray(b.xyz))


@pytest.mark.parametrize("seed,neg1", [(0, 0.2), (1, 0.0), (2, 1.0), (3, 0.5)])
def test_ground_marking_matches_reference(seed, neg1):
    rng = np.random.default_rng(seed)
    # ground-like scene: low-z ring points plus some towers
    points = random_points(rng, 400, SMALL, intensity_neg1_frac=neg1)
    for p in points:
        if rng.random() < 0.6:
            p["z"] = float(np.float32(rng.uniform(-2.1, -1.7)))  # ground band
    ref_cloud, _ = ordered_ref_arrays(points, SMALL)
    gm_ref = ref_impl.mark_ground_ref(
        ref_cloud, SMALL.n_scan, SMALL.horizon_scan, SMALL.ground_upper_scan
    )
    ordered = get_ordered_cloud(to_cloud(points), SMALL)
    labeled, gm = mark_ground(ordered, SMALL)
    np.testing.assert_array_equal(np.asarray(gm), gm_ref)
    np.testing.assert_array_equal(
        np.asarray(labeled.label), [p["label"] for p in ref_cloud]
    )


def test_ground_kitti_intensity_quirk():
    # KITTI-selected clouds have intensity = -1 on every real point → every
    # swept pair whose lower point is real is invalid, so no swept-row cell
    # can keep a ground mark (SURVEY.md §2.4.2).  The one reference leak:
    # row r_min-1 is written by the sweep's top row but never re-checked
    # (BatchMultiBevGen.cpp:140,181), so it may still be marked via empty
    # cells — we preserve that bit-for-bit.
    rng = np.random.default_rng(7)
    points = random_points(rng, 300, SMALL, intensity_neg1_frac=1.0)
    ordered = get_ordered_cloud(to_cloud(points), SMALL)
    labeled, gm = mark_ground(ordered, SMALL)
    gm = np.asarray(gm)
    r_min = SMALL.n_scan - SMALL.ground_upper_scan
    # real points (intensity -1) in swept rows always fail the validity test,
    # so no swept *real* cell keeps a ground mark (empty cells have
    # intensity 0 and can still be marked — they are not real points)
    lab = np.asarray(labeled.label).reshape(SMALL.n_scan, SMALL.horizon_scan)
    orig = np.asarray(ordered.label).reshape(SMALL.n_scan, SMALL.horizon_scan)
    assert not np.any((orig[r_min:] == -2) & (lab[r_min:] == 0))
    assert not np.any((orig[r_min:] == -2) & (gm[r_min:] == 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_bev_rasters_match_reference(seed):
    rng = np.random.default_rng(seed)
    points = random_points(rng, 500, SMALL, intensity_neg1_frac=0.1)
    for p in points:
        if rng.random() < 0.5:
            p["z"] = float(np.float32(rng.uniform(-2.1, -1.7)))
    ref_cloud, _ = ordered_ref_arrays(points, SMALL)
    ref_impl.mark_ground_ref(
        ref_cloud, SMALL.n_scan, SMALL.horizon_scan, SMALL.ground_upper_scan
    )
    ordered = get_ordered_cloud(to_cloud(points), SMALL)
    labeled, _ = mark_ground(ordered, SMALL)

    multi_ref = ref_impl.multi_bev_ref(ref_cloud, SMALL.height_res)
    ours_multi = multi_bev(labeled, SMALL.height_res, MultiBevConfig())
    np.testing.assert_array_equal(np.asarray(ours_multi), multi_ref)

    single_ref = ref_impl.single_bev_ref(ref_cloud)
    ours_single = single_bev(labeled, SingleBevConfig())
    np.testing.assert_array_equal(np.asarray(ours_single), single_ref)

    for filt in (True, False):
        fb_ref = ref_impl.float_bev_ref(ref_cloud, filter_ground=filt)
        ours_fb = float_bev(labeled, FloatBevConfig(filter_ground=filt))
        np.testing.assert_allclose(np.asarray(ours_fb), fb_ref, rtol=0, atol=0)


def test_bev_permutation_invariance():
    rng = np.random.default_rng(9)
    points = random_points(rng, 200, SMALL, intensity_neg1_frac=0.0)
    # unique cells so ordering can't differ under permutation
    seen = set()
    uniq = []
    for p in points:
        key = (p["row"], p["col"])
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    a = get_ordered_cloud(to_cloud(uniq), SMALL)
    b = get_ordered_cloud(to_cloud(list(reversed(uniq))), SMALL)
    la, _ = mark_ground(a, SMALL)
    lb, _ = mark_ground(b, SMALL)
    np.testing.assert_array_equal(
        np.asarray(multi_bev(la, SMALL.height_res)),
        np.asarray(multi_bev(lb, SMALL.height_res)),
    )


def test_full_sensor_shapes_compile():
    # HDL_64E-sized shapes go through the fused path (CPU jax, one cloud)
    from pctpu.config import get_sensor_params
    from pctpu.ops.preprocess import preprocess_cloud

    params = get_sensor_params("HDL_64E")
    rng = np.random.default_rng(0)
    n = 5000
    pts = random_points(rng, n, params, intensity_neg1_frac=0.1)
    cloud = to_cloud(pts, capacity=params.grid_size)
    labeled, multi, single = preprocess_cloud(cloud, params)
    assert multi.shape == (24, 224, 224)
    assert single.shape == (224, 224)
    assert labeled.capacity == params.grid_size


@pytest.mark.parametrize("sensor", ["HDL_32E", "OS1_64"])
def test_other_sensor_presets_compile(sensor):
    from pctpu.config import get_sensor_params
    from pctpu.ops.preprocess import preprocess_cloud

    params = get_sensor_params(sensor)
    rng = np.random.default_rng(0)
    pts = random_points(rng, 2000, params, intensity_neg1_frac=0.1)
    cloud = to_cloud(pts, capacity=params.grid_size)
    labeled, multi, single = preprocess_cloud(cloud, params)
    assert multi.shape == (24, 224, 224)
    assert labeled.capacity == params.grid_size


def test_boundary_value_parity():
    """Adversarial f32/f64 boundary cases (from code review): values where a
    missing intermediate f32 store flips a sector or a pixel height."""
    # x = 0.99999994: f32(x+75.0) rounds UP to 76.0 → sector 38, not 37
    pts = [
        {"x": float(np.float32(0.99999994)), "y": 0.0,
         "z": float(np.float32(0.24999997)), "intensity": 0.5,
         "row": 8, "col": 3, "t": 0, "label": -2},
        {"x": -1.0, "y": 1.0, "z": float(np.float32(-1.9)), "intensity": 0.5,
         "row": 9, "col": 3, "t": 0, "label": -2},
    ]
    ref_cloud, _ = ordered_ref_arrays(pts, SMALL)
    gm_ref = ref_impl.mark_ground_ref(
        ref_cloud, SMALL.n_scan, SMALL.horizon_scan, SMALL.ground_upper_scan
    )
    ordered = get_ordered_cloud(to_cloud(pts), SMALL)
    labeled, gm = mark_ground(ordered, SMALL)
    np.testing.assert_array_equal(np.asarray(gm), gm_ref)

    # z = 0.24999997: f32(z+2) == 2.25 exactly → height 9, not 8
    sref = ref_impl.single_bev_ref(ref_cloud)
    ours = single_bev(labeled, SingleBevConfig())
    np.testing.assert_array_equal(np.asarray(ours), sref)
    assert sref.max() == 9  # the boundary value itself


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_bev_matches_separate_ops(seed):
    from pctpu.ops.bev import fused_multi_single_bev

    rng = np.random.default_rng(seed)
    points = random_points(rng, 600, SMALL, intensity_neg1_frac=0.1)
    for p in points:
        if rng.random() < 0.5:
            p["z"] = float(np.float32(rng.uniform(-2.1, -1.7)))
        if rng.random() < 0.05:
            p["z"] = float(np.float32(rng.uniform(50.0, 70.0)))  # layer OOR
    ordered = get_ordered_cloud(to_cloud(points), SMALL)
    labeled, _ = mark_ground(ordered, SMALL)
    fm, fs = fused_multi_single_bev(labeled, SMALL.height_res)
    np.testing.assert_array_equal(
        np.asarray(fm), np.asarray(multi_bev(labeled, SMALL.height_res))
    )
    np.testing.assert_array_equal(np.asarray(fs), np.asarray(single_bev(labeled)))


def test_fused_bev_matches_reference_oracle(seed=5):
    from pctpu.ops.bev import fused_multi_single_bev

    rng = np.random.default_rng(seed)
    points = random_points(rng, 500, SMALL, intensity_neg1_frac=0.1)
    ref_cloud, _ = ordered_ref_arrays(points, SMALL)
    ref_impl.mark_ground_ref(
        ref_cloud, SMALL.n_scan, SMALL.horizon_scan, SMALL.ground_upper_scan
    )
    ordered = get_ordered_cloud(to_cloud(points), SMALL)
    labeled, _ = mark_ground(ordered, SMALL)
    fm, fs = fused_multi_single_bev(labeled, SMALL.height_res)
    np.testing.assert_array_equal(
        np.asarray(fm), ref_impl.multi_bev_ref(ref_cloud, SMALL.height_res)
    )
    np.testing.assert_array_equal(np.asarray(fs), ref_impl.single_bev_ref(ref_cloud))


def test_fused_bev_edge_values():
    """Height saturation at 255 (sentinel key ordering) and empty cloud."""
    from pctpu.cloud import make_cloud
    from pctpu.ops.bev import fused_multi_single_bev

    pts = [
        # z high enough that clamp(int((z+2)*4)) saturates at 255
        {"x": 3.0, "y": 4.0, "z": 62.0, "intensity": 0.5,
         "row": 2, "col": 2, "t": 0, "label": -2},
        {"x": 3.0, "y": 4.0, "z": 1.0, "intensity": 0.5,
         "row": 2, "col": 3, "t": 0, "label": -2},
    ]
    ordered = get_ordered_cloud(to_cloud(pts), SMALL)
    labeled = ordered  # keep labels -2 (no ground pass)
    fm, fs = fused_multi_single_bev(labeled, SMALL.height_res)
    np.testing.assert_array_equal(
        np.asarray(fm), np.asarray(multi_bev(labeled, SMALL.height_res))
    )
    np.testing.assert_array_equal(np.asarray(fs), np.asarray(single_bev(labeled)))
    assert np.asarray(fs).max() == 255

    empty = make_cloud(np.zeros((0, 3), np.float32), capacity=16)
    fm, fs = fused_multi_single_bev(empty, SMALL.height_res)
    assert int(np.asarray(fm).sum()) == 0 and int(np.asarray(fs).sum()) == 0


def test_fused_bev_single_cell_run():
    """Every point in ONE BEV cell: the longest possible same-cell run, so the
    log-step segmented OR must propagate across all of its shift distances."""
    from pctpu.ops.bev import fused_multi_single_bev

    rng = np.random.default_rng(11)
    n = SMALL.grid_size
    pts = []
    for i in range(n):
        pts.append(
            {
                "x": 3.2, "y": 4.1,
                "z": float(np.float32(rng.uniform(-1.5, 9.0))),
                "intensity": 0.5,
                "row": i // SMALL.horizon_scan,
                "col": i % SMALL.horizon_scan,
                "t": 0, "label": -2,
            }
        )
    ordered = get_ordered_cloud(to_cloud(pts), SMALL)
    fm, fs = fused_multi_single_bev(ordered, SMALL.height_res)
    np.testing.assert_array_equal(
        np.asarray(fm), np.asarray(multi_bev(ordered, SMALL.height_res))
    )
    np.testing.assert_array_equal(np.asarray(fs), np.asarray(single_bev(ordered)))
    # the one occupied cell ORs several distinct layers together
    assert (np.asarray(fm) > 0).sum() > 1


def test_fused_bev_power_of_two_runs():
    """Same-cell run lengths straddling the scan's shift boundaries
    (1, 2, 3, 4, 7, 8, 9, 16, 31, 32, 33, ...)."""
    from pctpu.ops.bev import fused_multi_single_bev

    rng = np.random.default_rng(12)
    lengths = [1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33, 64]
    pts = []
    slot = 0
    for li, length in enumerate(lengths):
        # one distinct BEV cell per run
        x = float(np.float32(-40.0 + 6.0 * li))
        for _ in range(length):
            pts.append(
                {
                    "x": x, "y": 2.0,
                    "z": float(np.float32(rng.uniform(-1.5, 9.0))),
                    "intensity": 0.5,
                    "row": slot // SMALL.horizon_scan,
                    "col": slot % SMALL.horizon_scan,
                    "t": 0, "label": -2,
                }
            )
            slot += 1
    ordered = get_ordered_cloud(to_cloud(pts), SMALL)
    fm, fs = fused_multi_single_bev(ordered, SMALL.height_res)
    np.testing.assert_array_equal(
        np.asarray(fm), np.asarray(multi_bev(ordered, SMALL.height_res))
    )
    np.testing.assert_array_equal(np.asarray(fs), np.asarray(single_bev(ordered)))


def test_preordered_fast_path_matches_general():
    """is_grid_ordered detection + the slot-0 fix-up fast path."""
    from pctpu.ops.ordering import is_grid_ordered
    from pctpu.ops.preprocess import preprocess_cloud

    rng = np.random.default_rng(7)
    points = random_points(rng, 300, SMALL, intensity_neg1_frac=0.1)
    raw = to_cloud(points)
    ordered = get_ordered_cloud(raw, SMALL)  # selector-style dense layout
    assert not is_grid_ordered(raw, SMALL)
    assert is_grid_ordered(ordered, SMALL)

    slow = preprocess_cloud(ordered, SMALL, assume_ordered=False)
    fast = preprocess_cloud(ordered, SMALL, assume_ordered=True)
    for a, b in zip(jax_tree_leaves(slow), jax_tree_leaves(fast)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_preordered_fast_path_slot0_semantics():
    """A dense cloud with a real point at cell (0,0) still loses slot 0 to
    the trailing all-zero cells, exactly like the reference's last-wins
    scatter (/root/reference/BatchMultiBevGen.cpp:94-117)."""
    from pctpu.ops.ordering import is_grid_ordered
    from pctpu.ops.preprocess import _reorder_preordered

    g = SMALL.grid_size
    xyz = np.zeros((g, 3), np.float32)
    xyz[0] = [5.0, 1.0, -1.9]  # real point at row 0, col 0
    row = np.zeros(g, np.int32)
    col = np.zeros(g, np.int32)
    label = np.zeros(g, np.int32)
    label[0] = -2
    cloud = make_cloud(xyz, row=row, col=col, label=label)
    assert is_grid_ordered(cloud, SMALL)
    general = get_ordered_cloud(cloud, SMALL)
    fast = _reorder_preordered(cloud, SMALL)
    np.testing.assert_array_equal(np.asarray(general.xyz), np.asarray(fast.xyz))
    np.testing.assert_array_equal(np.asarray(general.label), np.asarray(fast.label))
    assert np.asarray(fast.xyz)[0].tolist() == [0.0, 0.0, 0.0]  # zeros won


def test_rooftop_margin_strictness_threshold():
    """The veto must stay a STRICT f64 comparison for any margin: f32(0.30)
    > 0.30 makes >= f32(0.30) equivalent, but an exactly representable
    margin (0.25) needs one nextafter step."""
    from pctpu.ops.ground import _strict_gt_f32_threshold

    d030 = _strict_gt_f32_threshold(0.30)
    assert d030 == np.float32(0.30) and float(d030) > 0.30
    d025 = _strict_gt_f32_threshold(0.25)
    assert d025 == np.nextafter(np.float32(0.25), np.float32(np.inf))
    assert not (np.float32(0.25) >= d025)  # d == margin exactly: kept
    # margins below their f32 rounding (f32(m) < m) also stay strict
    m = 0.1  # f32(0.1) > 0.1; pick one with f32(m) < m: 0.3 is >, try 0.7?
    for m in (0.1, 0.2, 0.25, 0.3, 0.4, 0.5, 0.7):
        d0 = _strict_gt_f32_threshold(m)
        assert float(d0) > m  # strictly above the f64 margin
        below = np.nextafter(d0, np.float32(-np.inf))
        assert not (float(below) > m)  # and the next f32 down is not


@pytest.mark.parametrize("seed", [0, 1])
def test_ground_marking_custom_margin_matches_oracle(seed):
    """Differential check with a non-default, exactly-f32-representable
    rooftop margin (0.25)."""
    from pctpu.config import GroundConfig

    rng = np.random.default_rng(seed)
    points = random_points(rng, 400, SMALL, intensity_neg1_frac=0.1)
    ref_cloud, _ = ordered_ref_arrays(points, SMALL)
    ref_impl.mark_ground_ref(
        ref_cloud, SMALL.n_scan, SMALL.horizon_scan, SMALL.ground_upper_scan,
        rooftop_margin=0.25,
    )
    ordered = get_ordered_cloud(to_cloud(points), SMALL)
    labeled, _ = mark_ground(ordered, SMALL, GroundConfig(rooftop_margin=0.25))
    ref_labels = np.array([p["label"] for p in ref_cloud], np.int32)
    np.testing.assert_array_equal(np.asarray(labeled.label), ref_labels)


def test_count_epsilon_accumulation_order_knife_edge():
    """The C++ count accumulator STARTS at 0.01 and increments per point, so
    for ≥32 points the denominator differs by 1 ulp from exact_count + 0.01.
    This scene is engineered so that 1 ulp flips a rooftop veto: 32 ground
    points at z=1.0013 in one 2 m sector (33 slots are laid out, but the
    boundary cell (15,16) has no valid pair and never marks), and a
    neighbor-sector ground point at z=1.3009875 that is vetoed under the
    sequential order but kept under the post-hoc epsilon (exhaustive f32
    search)."""
    v = np.float32(1.0013)
    z_knife = np.float32(1.3009875)

    # confirm the engineered flip still holds for these exact constants
    acc = np.float32(0.01)
    s = np.float32(0.0)
    for _ in range(32):
        acc = np.float32(acc + np.float32(1.0))
        s = np.float32(s + v)
    avg_seq = np.float32(s / acc)
    avg_post = np.float32(s / np.float32(np.float32(32) + np.float32(0.01)))
    thr = np.float32(0.30)  # f32(0.30) > 0.30 in f64 → d0 = f32(0.30)
    assert (np.float32(z_knife - avg_seq) >= thr) != (
        np.float32(z_knife - avg_post) >= thr
    ), "search invariant broke; re-derive constants"

    pts = []
    # 33 points in sector (38, 25): x=1.5, y=1.0; rows 14/15 so the pair
    # slope test (dz=0) marks them all ground
    slots = [(15, c) for c in range(17)] + [(14, c) for c in range(16)]
    for row, col in slots:
        pts.append({"x": 1.5, "y": 1.0, "z": float(v), "intensity": 0.5,
                    "row": row, "col": col, "t": 0, "label": -2})
    # knife-edge pair in the adjacent sector (39, 25): x=3.5
    for row in (14, 15):
        pts.append({"x": 3.5, "y": 1.0, "z": float(z_knife), "intensity": 0.5,
                    "row": row, "col": 20, "t": 0, "label": -2})
    # shield the knife's OTHER three neighbor sectors with mid-height ground
    # (an in-grid EMPTY sector has avg = 0/0.01 = 0 and would veto the knife
    # regardless of A's average): z=1.4 → knife - 1.4 < 0.3, no veto
    for (sx, sy), cols in ((( 5.5, 1.0), (22, 23)),
                           (( 3.5, -1.0), (24, 25)),
                           (( 3.5, 3.0), (26, 27))):
        for col in cols:
            for row in (14, 15):
                pts.append({"x": sx, "y": sy, "z": 1.4, "intensity": 0.5,
                            "row": row, "col": col, "t": 0, "label": -2})

    ref_cloud, _ = ordered_ref_arrays(pts, SMALL)
    ref_impl.mark_ground_ref(
        ref_cloud, SMALL.n_scan, SMALL.horizon_scan, SMALL.ground_upper_scan
    )
    ordered = get_ordered_cloud(to_cloud(pts), SMALL)
    labeled, _ = mark_ground(ordered, SMALL)
    ref_labels = np.array([p["label"] for p in ref_cloud], np.int32)
    np.testing.assert_array_equal(np.asarray(labeled.label), ref_labels)


def test_negative_zero_slot_takes_general_path():
    """A slot that is value-zero but holds -0.0 is a REAL point: the
    reference's last-wins scatter stores its 0x80000000 byte pattern, so the
    host gate must reject the fast path for such clouds (bit parity)."""
    from pctpu.ops.ordering import arrays_grid_ordered, is_grid_ordered

    g = SMALL.grid_size
    xyz = np.zeros((g, 3), np.float32)
    zeros_i = np.zeros(g, np.int32)
    base = make_cloud(xyz, row=zeros_i, col=zeros_i)  # all-zero slots
    assert is_grid_ordered(base, SMALL)

    xyz2 = xyz.copy()
    xyz2[g - 1, 0] = -0.0  # bit pattern 0x80000000, still == 0.0
    c = make_cloud(xyz2, row=zeros_i, col=zeros_i)
    assert not is_grid_ordered(c, SMALL)
    arrays = {
        "xyz": xyz2, "intensity": np.zeros(g, np.float32),
        "row": np.zeros(g, np.uint16), "col": np.zeros(g, np.uint16),
        "t": np.zeros(g, np.uint32), "label": np.zeros(g, np.int16),
        "count": g,
    }
    assert not arrays_grid_ordered(arrays, SMALL)
    arrays["xyz"] = xyz
    assert arrays_grid_ordered(arrays, SMALL)

    # and the general path preserves the -0.0 byte pattern at cell 0
    # (last-wins: the final slot's -0.0 point overwrites cell (0,0))
    general = get_ordered_cloud(c, SMALL)
    assert np.asarray(general.xyz)[0, 0] == 0.0
    assert np.signbit(np.asarray(general.xyz)[0, 0])


def jax_tree_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)
