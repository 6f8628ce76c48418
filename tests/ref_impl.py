"""Independent plain-loop transcriptions of the reference semantics, used as
differential-test oracles for the vectorized device ops.

These follow the C++ control flow literally (sequential loops, in-place
writes) so that any vectorization mistake in pctpu.ops shows up as a diff.
Small inputs only — they are deliberately slow.
"""

from __future__ import annotations

import math

import numpy as np


def c_round(v: float) -> int:
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


def _bev_cell(coord: float, max_range: float, interval: float = 1.0) -> int:
    """round((coord + MAX_RANGE)/interval + 0.5) with the C++ mixed
    precision: the inner expression is f32, the +0.5 promotes to double."""
    t = np.float32(np.float32(coord) + np.float32(max_range)) / np.float32(interval)
    return c_round(float(t) + 0.5)


def kitti_raw_structured_ref(points: np.ndarray) -> dict[str, np.ndarray]:
    """Literal transcription of the raw-variant selector's structuring loop
    (/root/reference/KittiRawPointCloudSelect.cpp:155-206): azimuth per
    point, ring++ on every upward zero crossing (no length guard), column
    from C round of the semi-positive azimuth, sequential overwrite into the
    dense 64×2083 grid with label=-2 / intensity=-1.  UB is resolved the
    way pctpu documents it: ``t`` zero-filled, no trailing EOF point."""
    n_scan, h = 64, 2083
    n = len(points)
    az = np.empty(n, np.float32)
    for i in range(n):
        # std::atan2's FLOAT overload (both selectors share the expression,
        # KittiPointCloudSelect.cpp:189-193), then /M_PI*180.0f promotes to
        # double, stored into a float vector (:156-160)
        a32 = np.arctan2(np.float32(points[i, 1]), np.float32(points[i, 0]))
        az[i] = np.float32(float(a32) / math.pi * 180.0)
    grid = {
        "x": np.zeros(n_scan * h, np.float32),
        "y": np.zeros(n_scan * h, np.float32),
        "z": np.zeros(n_scan * h, np.float32),
        "intensity": np.zeros(n_scan * h, np.float32),
        "row": np.zeros(n_scan * h, np.uint16),
        "col": np.zeros(n_scan * h, np.uint16),
        "t": np.zeros(n_scan * h, np.uint32),
        "label": np.zeros(n_scan * h, np.int16),
    }
    if n == 0:
        return grid
    ring = 0 if az[0] > 0 else -1
    for i in range(1, n):
        if az[i - 1] <= 0 and az[i] > 0:
            ring += 1
        # makeAngleSemiPositive is f32 (:105-114); the divide promotes to
        # double (360.0 literal), std::round, cast to int (:187-188)
        a = az[i]
        if a >= 360.0:
            a = np.float32(a - np.float32(360.0))
        elif a < 0:
            a = np.float32(a + np.float32(360.0))
        col = c_round(float(a) / (360.0 / h))
        if 0 <= ring < n_scan:
            if col >= h:
                col -= h
            elif col < 0:
                col += h
            cell = ring * h + col
            grid["x"][cell] = points[i, 0]
            grid["y"][cell] = points[i, 1]
            grid["z"][cell] = points[i, 2]
            grid["intensity"][cell] = -1.0
            grid["row"][cell] = ring
            grid["col"][cell] = col
            grid["label"][cell] = -2
    return grid


def ordered_cloud_ref(points: list[dict], n_scan: int, horizon_scan: int) -> list[dict]:
    """getOrderedCloud (/root/reference/BatchMultiBevGen.cpp:94-117)."""
    zero = {"x": 0.0, "y": 0.0, "z": 0.0, "intensity": 0.0, "row": 0, "col": 0, "t": 0, "label": 0}
    out = [dict(zero) for _ in range(n_scan * horizon_scan)]
    for p in points:
        r, c = p["row"], p["col"]
        if r < 0 or r >= n_scan or c < 0 or c >= horizon_scan:
            continue
        out[r * horizon_scan + c] = dict(p)
    return out


def mark_ground_ref(
    cloud: list[dict],
    n_scan: int,
    horizon_scan: int,
    ground_upper_scan: int,
    grid_rows: int = 75,
    grid_cols: int = 50,
    rooftop_margin: float = 0.30,
) -> np.ndarray:
    # NB: the +75/+50 belonging() offsets below are the C++ constants tied to
    # the default 75x50 grid; passing other grid dims changes only the clamp
    # bounds, not the offsets (no C++ counterpart exists for other grids)
    """markGroundPoints (/root/reference/BatchMultiBevGen.cpp:119-252).

    Mutates labels in `cloud` and returns the ground mat.
    """
    h = horizon_scan
    gm = np.zeros((n_scan, h), np.int8)
    heights = np.zeros((grid_rows, grid_cols), np.float32)
    counts = np.full((grid_rows, grid_cols), 0.01, np.float32)

    for col in range(h):
        for row in range(n_scan - 1, n_scan - ground_upper_scan - 1, -1):
            lower = row * h + col
            upper = (row - 1) * h + col
            if cloud[upper]["intensity"] == -1:
                tmp_col = (col + 2) % h
                upper = (row - 1) * h + tmp_col
            if cloud[upper]["intensity"] == -1:
                tmp_col = math.fmod(col - 2, h)  # C++ % truncates toward zero
                upper = (row - 1) * h + int(tmp_col)
            if cloud[upper]["intensity"] == -1 and row >= 2:
                upper = (row - 2) * h + col
            if cloud[lower]["intensity"] == -1 or cloud[upper]["intensity"] == -1:
                gm[row, col] = -1
                continue
            dx = np.float32(cloud[upper]["x"]) - np.float32(cloud[lower]["x"])
            dy = np.float32(cloud[upper]["y"]) - np.float32(cloud[lower]["y"])
            dz = np.float32(cloud[upper]["z"]) - np.float32(cloud[lower]["z"])
            # the C++ stores the double atan2 result into a `float angle`
            # (BatchMultiBevGen.cpp:126,173) before the f32 <= 10.0f compare
            angle = np.float32(
                math.atan2(dz, math.sqrt(dx * dx + dy * dy)) * 180.0 / math.pi
            )
            if abs(angle) <= 10.0:
                gm[row, col] = 1
                gm[row - 1, col] = 1

    def belonging(idx):
        # `float normalized_x = x + 75.0` stores the double sum into a float
        # before the double /2.0 floor (BatchMultiBevGen.h:78-81)
        nx = np.float32(np.float32(cloud[idx]["x"]) + np.float64(75.0))
        ny = np.float32(np.float32(cloud[idx]["y"]) + np.float64(50.0))
        sx = int(math.floor(float(nx) / 2.0))
        sy = int(math.floor(float(ny) / 2.0))
        return min(max(sx, 0), grid_rows - 1), min(max(sy, 0), grid_cols - 1)

    for row in range(n_scan):
        for col in range(h):
            if gm[row, col] != 1:
                continue
            sr, sc = belonging(row * h + col)
            heights[sr, sc] += np.float32(cloud[row * h + col]["z"])
            counts[sr, sc] += 1

    avg = heights / counts

    for row in range(n_scan):
        for col in range(h):
            idx = row * h + col
            sr, sc = belonging(idx)
            for dr, dc in ((-1, 0), (0, 1), (0, -1), (1, 0)):
                nr, nc = sr + dr, sc + dc
                if nr < 0 or nr >= grid_rows or nc < 0 or nc >= grid_cols:
                    continue
                # f32 difference promoted to f64, compared to the double margin
                if float(np.float32(cloud[idx]["z"]) - avg[nr, nc]) > rooftop_margin:
                    gm[row, col] = 0
                    break
            if gm[row, col] == 1:
                cloud[idx]["label"] = 0
    return gm


def multi_bev_ref(cloud: list[dict], height_res: float) -> np.ndarray:
    """computeAndSaveMultiBev rasterization (:261-292)."""
    max_range, size, layers = 112, 224, 24
    img = np.zeros((layers, size, size), np.uint8)
    for p in cloud:
        x = _bev_cell(p["x"], max_range)
        y = _bev_cell(p["y"], max_range)
        # all-f32 chain: z/HEIGHT_RES + 2.0f, round(float)
        layer = c_round(
            float(np.float32(np.float32(p["z"]) / np.float32(height_res)) + np.float32(2.0))
        )
        if x < 0 or x >= size or y < 0 or y >= size or layer < 0 or layer >= layers or p["label"] == 0:
            continue
        if img[layer, x, y] == 0:
            img[layer, x, y] = 255
    return img


def single_bev_ref(cloud: list[dict]) -> np.ndarray:
    """computeAndSaveSingleBev rasterization (:331-356)."""
    max_range, size = 112, 224
    img = np.zeros((size, size), np.uint8)
    for p in cloud:
        x = _bev_cell(p["x"], max_range)
        y = _bev_cell(p["y"], max_range)
        # LIDAR_TO_GROUND_HEIGHT is a float: z+2 rounds to f32, then *4.0 in
        # double and int() truncation (BatchMultiBevGen.cpp:345-346)
        height = int(float(np.float32(np.float32(p["z"]) + np.float32(2.0))) * 4.0)
        height = min(max(0, height), 255)
        if x < 0 or x >= size or y < 0 or y >= size or p["label"] == 0:
            continue
        if img[x, y] < height:
            img[x, y] = height
    return img


def float_bev_ref(cloud: list[dict], filter_ground: bool) -> np.ndarray:
    """saveAsMat rasterization (/root/reference/BatchCloudManip.cpp:201-239)."""
    max_range, size = 100, 201
    img = np.zeros((size, size), np.float32)
    for p in cloud:
        x = _bev_cell(p["x"], max_range)
        y = _bev_cell(p["y"], max_range)
        if x < 0 or x >= size or y < 0 or y >= size:
            continue
        if filter_ground and p["label"] == 0:
            continue
        if p["z"] + 2.0 > img[x, y]:
            img[x, y] = p["z"] + 2.0
    return img


def top_flatten_ref(cloud: list[dict]) -> list[tuple[float, float, float]]:
    """extractTopAndFlatten (/root/reference/BatchTopPartRegistration.cpp:90-147)."""
    num_grid = 10
    max_radius = 100.0
    grid_res = 2.0 * max_radius / num_grid
    min_pts = 20
    grid: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(cloud):
        if p["label"] == 0:
            continue
        gx = c_round(float(np.float32(np.float32(p["x"]) + np.float32(max_radius)) / np.float32(grid_res)))
        gy = c_round(float(np.float32(np.float32(p["y"]) + np.float32(max_radius)) / np.float32(grid_res)))
        if gx < 0 or gx >= num_grid or gy < 0 or gy >= num_grid:
            continue
        grid.setdefault((gx, gy), []).append(i)
    out = []
    for gx in range(num_grid):
        for gy in range(num_grid):
            idxs = grid.get((gx, gy), [])
            n = len(idxs)
            needed = c_round(float(np.float32(np.float32(0.2) * np.float32(n))))
            if n < min_pts:
                continue
            idxs = sorted(idxs, key=lambda i: -cloud[i]["z"])
            for i in idxs[:needed]:
                out.append((cloud[i]["x"], cloud[i]["y"], 0.0))
    return out


def voxel_ref(points: np.ndarray, leaf: float) -> np.ndarray:
    """pcl::VoxelGrid semantics: per-voxel centroid, output ordered by
    ascending flat voxel index relative to the cloud minimum."""
    points = np.asarray(points, np.float32)
    inv = np.float32(1.0 / leaf)
    minb = np.floor(points.min(axis=0) * inv).astype(np.int64)
    maxb = np.floor(points.max(axis=0) * inv).astype(np.int64)
    div = maxb - minb + 1
    ijk = np.floor(points * inv).astype(np.int64) - minb
    key = ijk[:, 0] + ijk[:, 1] * div[0] + ijk[:, 2] * div[0] * div[1]
    out = []
    for k in np.unique(key):  # unique returns sorted keys
        sel = points[key == k]
        # PCL accumulates the centroid sequentially in f32 (Vector4f += per
        # point) then divides — np.mean's pairwise f32 sum can differ by ulps
        acc = np.zeros(3, np.float32)
        for q in sel:
            acc = (acc + q).astype(np.float32)
        out.append(acc / np.float32(len(sel)))
    return np.asarray(out, np.float32)


def normal2d_from_set(points: np.ndarray, i: int, nbr_idx) -> np.ndarray | None:
    """Oracle per-point 2-D normal on an EXPLICIT neighbor index set,
    mirroring normals2d_ref / normals2d_knn_ref's member math (2-pt
    perpendicular, else PCA minor eigvec, viewpoint flip toward origin).

    Used by the knife-edge explainer: when the vectorized op and the plain
    oracle disagree at a neighbor-selection boundary (ledger D3), the
    divergence is EXPLAINED iff the oracle recomputed on the op's plausible
    alternative neighbor set reproduces the op's normal."""
    pts = np.asarray(points, np.float64)[:, :2]
    nbr_idx = np.asarray(nbr_idx, int)
    if len(nbr_idx) < 2:
        return None
    d2 = np.sum((pts[nbr_idx] - pts[i]) ** 2, axis=1)
    order = nbr_idx[np.argsort(d2, kind="stable")]
    if len(order) == 2:
        vect = pts[order[0]] - pts[order[1]]
        nv = np.linalg.norm(vect)
        if nv == 0.0:
            return None
        vect = vect / nv
        nrm = np.array([-vect[1], vect[0]])
    else:
        sel = pts[order]
        mu = sel.mean(axis=0)
        d = sel - mu
        w, v = np.linalg.eigh(d.T @ d)
        nrm = v[:, 0]
    if np.dot(-pts[i], nrm) < 0:
        nrm = -nrm
    return nrm


def normals2d_knife_edge_sets(
    points: np.ndarray, i: int, win: float,
    radius: float | None = None, k: int | None = None,
    max_ambiguous: int = 5,
):
    """Yield neighbor index sets reachable by reclassifying points whose
    exact d² lies within ``win`` of the decision boundary (ledger D3).
    ``win`` may be a scalar or a per-candidate (N,) array (the matmul score's
    rounding error scales with max(|query−c|², |candidate−c|²), so callers
    can scale the window per pair instead of scene-wide).

    Radius mode: boundary = r² (strict-< membership); each ambiguous point
    may be in or out.  kNN mode: boundary = the exact k-th neighbor's d²;
    near-tied candidates may replace in-set members (the set size stays k).
    Yields only sets different from the exact one; gives up (yields
    nothing) past ``max_ambiguous`` candidates — an explainer, not a prover.
    """
    import itertools

    pts = np.asarray(points, np.float64)[:, :2]
    d2 = np.sum((pts - pts[i]) ** 2, axis=1)
    if radius is not None:
        r2 = float(radius) * float(radius)
        exact = np.flatnonzero(d2 < r2)
        amb = np.flatnonzero(np.abs(d2 - r2) <= win)
        if not len(amb) or len(amb) > max_ambiguous:
            return
        certain = np.setdiff1d(exact, amb)
        exact_key = set(exact.tolist())
        for take in range(len(amb) + 1):
            for sub in itertools.combinations(amb.tolist(), take):
                alt = np.union1d(certain, np.array(sub, int))
                if len(alt) >= 2 and set(alt.tolist()) != exact_key:
                    yield alt
    else:
        kk = min(int(k), len(pts))
        if kk < 2:
            return
        order = np.argsort(d2, kind="stable")
        boundary = d2[order[kk - 1]]
        amb = np.flatnonzero(np.abs(d2 - boundary) <= win)
        if not len(amb) or len(amb) > max_ambiguous:
            return
        amb_key = set(amb.tolist())
        certain = [j for j in order[:kk].tolist() if j not in amb_key]
        need = kk - len(certain)
        if need < 0:
            return
        exact_key = set(order[:kk].tolist())
        for sub in itertools.combinations(sorted(amb_key), need):
            alt = np.array(certain + list(sub), int)
            if set(alt.tolist()) != exact_key:
                yield alt


def normals2d_ref(points: np.ndarray, radius: float = 2.0):
    """Normal2dEstimation + PCA2D loops (see pctpu/ops/normals2d.py docstring).

    Returns (normals (N,2), valid (N,)); invalid = <2 neighbors (NaN in PCL).
    """
    points = np.asarray(points, np.float64)[:, :2]
    n = len(points)
    normals = np.zeros((n, 2))
    valid = np.zeros(n, bool)
    for i in range(n):
        d2 = np.sum((points - points[i]) ** 2, axis=1)
        # strict <: FLANN RadiusResultSet excludes the exact boundary
        nbr = np.flatnonzero(d2 < radius * radius)
        if len(nbr) < 2:
            continue
        if len(nbr) == 2:
            order = nbr[np.argsort(d2[nbr], kind="stable")]
            vect = points[order[0]] - points[order[1]]
            vect = vect / np.linalg.norm(vect)
            nrm = np.array([-vect[1], vect[0]])
        else:
            sel = points[nbr]
            mu = sel.mean(axis=0)
            d = sel - mu
            scatter = d.T @ d
            w, v = np.linalg.eigh(scatter)  # ascending
            nrm = v[:, 0]  # minor eigenvector
        vp = -points[i]
        if np.dot(vp, nrm) < 0:
            nrm = -nrm
        normals[i] = nrm
        valid[i] = True
    return normals, valid


# ---------------------------------------------------------------------------
# PCL registration oracle: pcl::IterativeClosestPoint[WithNormals] as
# configured by the reference (/root/reference/BatchTopPartRegistration.cpp:
# 192-247, performCoarseIcp/performFineIcp), transcribed as plain loops.
#
# Semantics encoded (PCL Registration/DefaultConvergenceCriteria):
#  * per iteration: 1-NN correspondences of the transformed source in the
#    target, rejected when squared distance > max_correspondence_distance²;
#  * < 3 correspondences → converged=false, loop breaks BEFORE estimating;
#  * estimation: point-to-point = Umeyama SVD without scale
#    (TransformationEstimationSVD); point-to-plane = the linearized LLS system
#    rows [s×n, n], b = n·(t−s), angles into Rz(γ)Ry(β)Rx(α)
#    (TransformationEstimationPointToPlaneLLS);
#  * final = inc · final, starting from the guess;
#  * hasConverged() order: max iterations → converged; cosθ ≥ 1−ε_t and
#    ‖t‖² ≤ ε_t → converged; |MSE−prev| < 1e-12 or /prev < ε_fitness →
#    converged (MSE = mean squared distance over accepted correspondences);
#  * fitness = getFitnessScore(default max_range): mean squared 1-NN distance
#    of ALL transformed source points against the full target.
#
# Divergence shared with pctpu.ops.icp (documented there): targets with
# undefined normals are excluded from point-to-plane correspondences instead
# of NaN-poisoning the solve like PCL would.


def _nn_1_ref(q, target, target_ok):
    best_i, best_d = 0, float("inf")
    for j in range(len(target)):
        if not target_ok[j]:
            continue
        d = float((q[0] - target[j][0]) ** 2 + (q[1] - target[j][1]) ** 2
                  + (q[2] - target[j][2]) ** 2)
        if d < best_d:
            best_d, best_i = d, j
    return best_i, best_d


def _estimate_svd_ref(src, tgt):
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    mu_s = src.mean(axis=0)
    mu_t = tgt.mean(axis=0)
    h = (src - mu_s).T @ (tgt - mu_t)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    s = np.diag([1.0, 1.0, d])
    r = vt.T @ s @ u.T
    t = mu_t - r @ mu_s
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m.astype(np.float32)


def _estimate_p2pl_ref(src, tgt, nrm):
    ata = np.zeros((6, 6))
    atb = np.zeros(6)
    for s, t, n in zip(np.asarray(src, np.float64), np.asarray(tgt, np.float64),
                       np.asarray(nrm, np.float64)):
        a = np.concatenate([np.cross(s, n), n])
        ata += np.outer(a, a)
        atb += a * (n @ (t - s))
    x = np.linalg.solve(ata + 1e-12 * np.eye(6), atb)
    al, be, ga, tx, ty, tz = x
    ca, sa = math.cos(al), math.sin(al)
    cb, sb = math.cos(be), math.sin(be)
    cg, sg = math.cos(ga), math.sin(ga)
    m = np.array(
        [
            [cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca, tx],
            [sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca, ty],
            [-sb, cb * sa, cb * ca, tz],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    return m.astype(np.float32)


def icp_ref(
    src,
    tgt,
    guess,
    max_correspondence_distance,
    max_iterations,
    transformation_epsilon=0.0,
    euclidean_fitness_epsilon=-math.inf,
    tgt_normals=None,
    normal_ok=None,
):
    """Plain-loop PCL ICP.  Returns a dict with the final state and the
    per-iteration trace [(final_transform f32 4x4, mse, ncorr)]."""
    src = np.asarray(src, np.float32)
    tgt = np.asarray(tgt, np.float32)
    final = np.asarray(guess, np.float32).copy()
    max_d2 = float(max_correspondence_distance) ** 2
    corr_ok = [True] * len(tgt) if normal_ok is None else list(normal_ok)
    prev_mse = float(np.finfo(np.float32).max)
    converged = False
    trace = []

    # PCL's loop is a do-while: at least one iteration runs even
    # when max_iterations == 0 (converging via the iterations criterion)
    # PCL transforms the WORKING cloud in place each iteration
    # (transformCloud(input_transformed, input_transformed, transformation_)),
    # accumulating f32 rounding per step, rather than re-applying the
    # composed final transform to the original points
    moved = (src @ np.asarray(guess, np.float32)[:3, :3].T
             + np.asarray(guess, np.float32)[:3, 3]).astype(np.float32)
    for it in range(1, max(max_iterations, 1) + 1):
        pairs = []
        for i in range(len(moved)):
            j, d2 = _nn_1_ref(moved[i], tgt, corr_ok)
            if d2 <= max_d2:
                pairs.append((i, j, d2))
        if len(pairs) < 3:
            converged = False
            trace.append((final.copy(), float("nan"), len(pairs)))
            break
        s_sel = np.array([moved[i] for i, _, _ in pairs], np.float32)
        t_sel = np.array([tgt[j] for _, j, _ in pairs], np.float32)
        if tgt_normals is not None:
            n_sel = np.array([tgt_normals[j] for _, j, _ in pairs], np.float32)
            inc = _estimate_p2pl_ref(s_sel, t_sel, n_sel)
        else:
            inc = _estimate_svd_ref(s_sel, t_sel)
        final = (inc.astype(np.float32) @ final).astype(np.float32)
        inc32 = inc.astype(np.float32)
        moved = (moved @ inc32[:3, :3].T + inc32[:3, 3]).astype(np.float32)
        mse = float(np.mean([d2 for _, _, d2 in pairs]))
        trace.append((final.copy(), mse, len(pairs)))

        if it >= max_iterations:  # with max=0 the single do-while pass hits this
            converged = True
            break
        cos_angle = 0.5 * (float(inc[0, 0]) + float(inc[1, 1]) + float(inc[2, 2]) - 1.0)
        trans_sqr = float(np.sum(inc[:3, 3] ** 2))
        if cos_angle >= 1.0 - transformation_epsilon and trans_sqr <= transformation_epsilon:
            converged = True
            break
        if abs(mse - prev_mse) < 1e-12:
            converged = True
            break
        if abs(mse - prev_mse) / prev_mse < euclidean_fitness_epsilon:
            converged = True
            break
        prev_mse = mse

    moved = src @ final[:3, :3].T + final[:3, 3]
    all_ok = [True] * len(tgt)
    if len(moved) == 0:
        # pcl::Registration::getFitnessScore returns
        # std::numeric_limits<double>::max() when no point is accepted
        fitness = float(np.finfo(np.float64).max)
    else:
        fitness = 0.0
        for i in range(len(moved)):
            _, d2 = _nn_1_ref(moved[i], tgt, all_ok)
            fitness += d2
        fitness /= len(moved)
    return {
        "converged": converged,
        "fitness": fitness,
        "transform": final,
        "trace": trace,
    }


def normals2d_knn_ref(points: np.ndarray, k: int):
    """setKSearch-mode Normal2dEstimation loops
    (/root/reference/src/Normal2dEstimation.cpp:29-38 nearestKSearch branch).
    Returns (normals (N,2), valid (N,))."""
    points = np.asarray(points, np.float64)[:, :2]
    n = len(points)
    normals = np.zeros((n, 2))
    valid = np.zeros(n, bool)
    for i in range(n):
        d2 = np.sum((points - points[i]) ** 2, axis=1)
        order = np.argsort(d2, kind="stable")[: min(k, n)]
        if len(order) < 2:
            continue
        if len(order) == 2:
            vect = points[order[0]] - points[order[1]]
            vect = vect / np.linalg.norm(vect)
            nrm = np.array([-vect[1], vect[0]])
        else:
            sel = points[order]
            mu = sel.mean(axis=0)
            d = sel - mu
            scatter = d.T @ d
            w, v = np.linalg.eigh(scatter)
            nrm = v[:, 0]
        vp = -points[i]
        if np.dot(vp, nrm) < 0:
            nrm = -nrm
        normals[i] = nrm
        valid[i] = True
    return normals, valid


def pca2d_ref(points: np.ndarray, indices=None):
    """PCA2D::initCompute + project loops (/root/reference/src/PCA2D.cpp:8-42,
    :81-108).  Returns (mean (2,), eigenvalues desc (2,), eigenvectors (2,2)
    columns desc)."""
    p2 = np.asarray(points, np.float64)[:, :2]
    if indices is not None:
        p2 = p2[np.asarray(indices)]
    mean = p2.mean(axis=0)
    d = p2 - mean
    scatter = d.T @ d  # unnormalized, like cloud_demean * cloud_demean^T
    w, v = np.linalg.eigh(scatter)  # ascending
    return mean, w[::-1].copy(), v[:, ::-1].copy()


def _guess_angle_ref(angle_guess_deg: float, offset_deg: float = 0.0) -> float:
    """The reference's mixed f32/f64 guess chain
    (/root/reference/BatchTopPartRegistration.cpp:416-420): the parsed guess
    is a C float, ``(angle + 180.0f) / 180.0f`` evaluates in f32, and only
    the ``* M_PI`` promotes to double."""
    a = np.float32(angle_guess_deg)
    if offset_deg:
        a = np.float32(a + np.float32(offset_deg))
    return float(np.float32(a / np.float32(180.0))) * math.pi


def _yaw4_ref(yaw_rad: float) -> np.ndarray:
    t = np.eye(4, dtype=np.float64)
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    t[0, 0], t[0, 1] = c, -s
    t[1, 0], t[1, 1] = s, c
    return t.astype(np.float32)


def two_stage_ref(
    cloud_src: list[dict],
    cloud_tgt: list[dict],
    guess_deg: float,
    voxel_leaf: float = 0.2,
    normal_radius: float = 2.0,
    failure_fitness: float = 1.5,
):
    """Composed plain-loop oracle for the FULL two-stage top-part
    registration (/root/reference/BatchTopPartRegistration.cpp:356-532):
    extractTopAndFlatten + VoxelGrid on both clouds, 2-D normals on the
    target, coarse point-to-plane ICP from both yaw guesses {theta,
    theta+180 deg} with the best fitness winning (tie -> second guess,
    :464), then full-cloud VoxelGrid + fine point-to-point ICP seeded by
    the winner, and the fitness <= 1.5 success classification (:508-510).

    Inputs are dict clouds ({x, y, z, label}); the full clouds for the fine
    stage are ALL points (the reference voxel-grids the loaded cloud
    unfiltered, :483-487).  Returns a dict with both coarse results, the
    winner index, the fine result, and the success flag.  Everything
    downstream of the per-stage oracles composes those oracles verbatim, so
    a divergence here that no per-stage test catches is a *glue* bug
    (stage wiring, guess chain, best-of-two, seeding)."""
    flat_s = np.asarray(top_flatten_ref(cloud_src), np.float32).reshape(-1, 3)
    flat_t = np.asarray(top_flatten_ref(cloud_tgt), np.float32).reshape(-1, 3)
    vs = voxel_ref(flat_s, voxel_leaf)
    vt = voxel_ref(flat_t, voxel_leaf)
    nrm2, ok_t = normals2d_ref(vt[:, :2], radius=normal_radius)
    # z=0 third component: the reference's PointNormal clouds carry 3-D
    # normals with normal_z = 0 after Normal2dEstimation
    nrm_t = np.concatenate(
        [np.asarray(nrm2, np.float32), np.zeros((len(nrm2), 1), np.float32)], 1
    )
    coarse = []
    for off in (0.0, 180.0):
        guess = _yaw4_ref(_guess_angle_ref(guess_deg, off))
        coarse.append(
            icp_ref(
                vs, vt, guess, 10.0, 10,
                tgt_normals=nrm_t, normal_ok=ok_t,
            )
        )
    # the C++ ternary (:464): strict < keeps the first, tie picks the second
    best_i = 0 if coarse[0]["fitness"] < coarse[1]["fitness"] else 1
    best = coarse[best_i]

    full_s = np.asarray(
        [(p["x"], p["y"], p["z"]) for p in cloud_src], np.float32
    )
    full_t = np.asarray(
        [(p["x"], p["y"], p["z"]) for p in cloud_tgt], np.float32
    )
    fvs = voxel_ref(full_s, voxel_leaf)
    fvt = voxel_ref(full_t, voxel_leaf)
    fine = icp_ref(
        fvs, fvt, best["transform"], 1.0, 100,
        transformation_epsilon=1e-6, euclidean_fitness_epsilon=0.01,
    )
    return {
        "coarse": coarse,
        "best_i": best_i,
        "best": best,
        "fine": fine,
        "success": fine["fitness"] <= failure_fitness,
        "flat_counts": (len(flat_s), len(flat_t)),
        "voxel_counts": (len(vs), len(vt), len(fvs), len(fvt)),
    }


def whole_ref(
    cloud_src: list[dict],
    cloud_tgt: list[dict],
    guess_deg: float,
    voxel_leaf: float = 0.2,
    failure_fitness: float = 1.5,
):
    """Composed whole-cloud ablation oracle
    (/root/reference/BatchWholeRegistration.cpp:342-412): full-cloud
    VoxelGrid + direct 3-D point-to-point ICP from the yaw guess with the
    looser params (maxCorr 4 m, 200 iters, eps_t 1e-6, eps_f 0.001,
    :232-235) and the same fitness <= 1.5 classification."""
    full_s = np.asarray(
        [(p["x"], p["y"], p["z"]) for p in cloud_src], np.float32
    )
    full_t = np.asarray(
        [(p["x"], p["y"], p["z"]) for p in cloud_tgt], np.float32
    )
    fvs = voxel_ref(full_s, voxel_leaf)
    fvt = voxel_ref(full_t, voxel_leaf)
    guess = _yaw4_ref(_guess_angle_ref(guess_deg))
    fine = icp_ref(
        fvs, fvt, guess, 4.0, 200,
        transformation_epsilon=1e-6, euclidean_fitness_epsilon=0.001,
    )
    return {"fine": fine, "success": fine["fitness"] <= failure_fitness}
