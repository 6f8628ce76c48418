"""Batched 2-D normal estimation: radius neighborhoods + closed-form 2×2 PCA.

Reproduces Normal2dEstimation + PCA2D
(/root/reference/src/Normal2dEstimation.cpp:106-190,228-263,
/root/reference/src/PCA2D.cpp:8-42) for z=0 clouds:

  * neighbors = radius search (includes the point itself);
  * < 2 neighbors → NaN normal (the reference's computePointNormal2d NaN
    branch, Normal2dEstimation.cpp:230-233);
  * exactly 2 → perpendicular of the segment (self − other), :235-247;
  * ≥ 3 → minor eigenvector of the unnormalized 2×2 scatter of the demeaned
    neighborhood (PCA2D.cpp:28-37), curvature = λ_min/(λ_0+λ_1);
  * flip toward the viewpoint (origin), :305-318.

Design: the per-point kd-tree radius query + Eigen solve becomes tiled
mask matmuls: per query tile, a (tile, P) radius mask contracts against the
(P, 6) moment matrix [x, y, x², xy, y², 1], and the 2×2
eigenproblem is solved in closed form — no loops, no trees.

All coordinates are first shifted by the cloud's bbox center: the scatter is
assembled from uncentered moments (sxx = Σx² − cnt·mx²), which cancels
catastrophically far from the origin (measured ~10× normal-accuracy loss for
a wall at (95, 40) m vs the reference's demeaned PCA2D).  The scatter,
2-point segment, and viewpoint flip are all translation-invariant, so
shifting points AND viewpoint by one global center restores full f32
relative accuracy without changing the semantics.

Note on curvature: the reference's pcl::Normal overload computes "curvature"
from eigen*vector* matrix entries (Normal2dEstimation.cpp:261) — an apparent
bug; the value is never consumed downstream (ICP point-to-plane uses only
normals), so we store the eigenvalue ratio λ₁/(λ₀+λ₁) instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pctpu.ops.eig2 import eig2_sym_values, eig2_sym_vector

_BIG = 3e38


def _centered(xyz: jnp.ndarray, mask: jnp.ndarray, viewpoint):
    """Shift 2-D coordinates and viewpoint by the valid-point bbox center
    (see the module docstring: controls Σx² − cnt·mx² cancellation)."""
    p2 = xyz[:, :2]
    mins = jnp.min(jnp.where(mask[:, None], p2, _BIG), axis=0)
    maxs = jnp.max(jnp.where(mask[:, None], p2, -_BIG), axis=0)
    center = jnp.where(maxs >= mins, 0.5 * (mins + maxs), 0.0)
    vx, vy = viewpoint
    return p2 - center, (vx - center[0], vy - center[1])


def _moment_matrix(p2c: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """(P, 6) per-point moments [x, y, x², x·y, y², 1], masked to zero."""
    x = p2c[:, 0]
    y = p2c[:, 1]
    moments = jnp.stack([x, y, x * x, x * y, y * y, jnp.ones_like(x)], axis=1)
    return jnp.where(mask[:, None], moments, 0.0)


def _sums_to_normal(sums: jnp.ndarray):
    """Neighborhood moment sums → (minor-eigvec normal, curvature)."""
    cnt = jnp.maximum(sums[:, 5], 1.0)
    mx = sums[:, 0] / cnt
    my = sums[:, 1] / cnt
    # unnormalized scatter of demeaned points: S = Σpᵢpᵢᵀ − c·μμᵀ
    sxx = sums[:, 2] - cnt * mx * mx
    sxy = sums[:, 3] - cnt * mx * my
    syy = sums[:, 4] - cnt * my * my
    lam_max, lam_min = eig2_sym_values(sxx, sxy, syy)
    v = eig2_sym_vector(sxx, sxy, syy, lam_min)  # minor eigvec = normal
    curv = lam_min / jnp.maximum(lam_max + lam_min, 1e-30)
    return v, curv


def _finalize_normals(qt_c, other_c, count_i, v, curv, qm, vpc):
    """Shared tail of both modes: 2-neighbor perpendicular, coincident-pair
    gate, viewpoint flip, and invalid zeroing.

    * exactly 2 neighbors → perpendicular of (self − other),
      Normal2dEstimation.cpp:235-247, curvature 0;
    * coincident duplicate pair → NaN in the reference (divide by norm 0,
      :236-241) → excluded under pctpu's documented NaN-normal policy.
      Coincidence tests exact COORDINATE equality (not ‖seg‖ == 0): it is
      then invariant to which of several distance-tied neighbors the argmin
      picked, so plain and GSPMD-sharded compilations agree;
    * flip toward the viewpoint (:305-318), zero invalid normals.
    """
    seg = qt_c - other_c
    seg_n = jnp.linalg.norm(seg, axis=1, keepdims=True)
    seg = seg / jnp.maximum(seg_n, 1e-30)
    pair_normal = jnp.stack([-seg[:, 1], seg[:, 0]], axis=1)

    normal = jnp.where((count_i == 2)[:, None], pair_normal, v)
    curv = jnp.where(count_i == 2, 0.0, curv)
    coincident = jnp.all(other_c == qt_c, axis=1)
    ok = qm & (count_i >= 2) & ~((count_i == 2) & coincident)

    vp = jnp.stack([vpc[0] - qt_c[:, 0], vpc[1] - qt_c[:, 1]], axis=1)
    cos_t = jnp.sum(vp * normal, axis=1)
    normal = jnp.where((cos_t < 0)[:, None], -normal, normal)
    normal = jnp.where(ok[:, None], normal, 0.0)
    return normal, curv, ok


def _neighbor_prep(xyz, mask, viewpoint, tile):
    """Shared setup for both neighborhood kernels: bbox centering, per-point
    moment rows, masked squared norms, and tile padding.  The third mapped
    operand is each tile's base query index, so kernels can address their
    own (exact-zero) self column by INDEX."""
    n = xyz.shape[0]
    p2c, vpc = _centered(xyz, mask, viewpoint)
    moments = _moment_matrix(p2c, mask)
    t_sq_masked = jnp.where(mask, jnp.sum(p2c * p2c, axis=1), jnp.inf)
    rem = (-n) % tile
    tiles = (
        jnp.pad(p2c, ((0, rem), (0, 0))).reshape(-1, tile, 2),
        jnp.pad(mask, (0, rem)).reshape(-1, tile),
        jnp.arange((n + rem) // tile, dtype=jnp.int32) * tile,
    )
    return n, p2c, vpc, moments, t_sq_masked, tiles


def _tile_dist2(qt, base, p2c, t_sq_masked):
    """Expanded-matmul squared distances with an EXACT zero self column.

    ``|q|² − 2 q·t + |t|²`` as a matmul carries absolute error
    ~|p−c|²·2⁻²³ (~6e-4 at 100 m from the bbox center), so the query's own
    column — whose true distance is exactly 0 — could otherwise lose the
    self slot to a near-coincident neighbor, or fall outside a tiny search
    radius.  Forcing d[i, base+i] = 0 by index makes every
    self-classification exact, like the kd-tree's; the residual error then
    affects only genuine neighbors sitting within that window of the radius
    boundary (see ``normals_2d``).  Padded rows address past the cloud and
    their updates drop."""
    prec = jax.lax.Precision.HIGHEST  # full f32 accumulation (see ops/knn.py)
    d = (
        jnp.sum(qt * qt, axis=1, keepdims=True)
        - 2.0 * jnp.matmul(qt, p2c.T, precision=prec)
        + t_sq_masked[None, :]
    )
    t = qt.shape[0]
    return d.at[jnp.arange(t), base + jnp.arange(t)].set(0.0, mode="drop")


def _tiles_epilogue(normal, curv, ok, n):
    normal = normal.reshape(-1, 2)[:n]
    normals3 = jnp.concatenate([normal, jnp.zeros((n, 1), jnp.float32)], axis=1)
    return normals3, curv.reshape(-1)[:n], ok.reshape(-1)[:n]


@functools.partial(jax.jit, static_argnames=("tile",))
def normals_2d(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    radius: float = 2.0,
    viewpoint: tuple[float, float] = (0.0, 0.0),
    tile: int = 512,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (normals (N,3) float32 with z=0, curvature (N,), valid (N,)).

    valid is False for padding and for <2-neighbor points (NaN in the
    reference); their normal is (0,0,0) here so downstream masking is clean.

    Boundary window (documented divergence): the self column is exact
    (``_tile_dist2``), but other points' squared distances carry
    ~|p−c|²·2⁻²³ absolute error, so a neighbor whose true d² lies within
    that window of r² can classify differently than the kd-tree's exact
    test — the same measure-zero class as the documented transcendental
    noise floor.
    """
    r2 = jnp.float32(radius * radius)
    n, p2c, vpc, moments, t_sq_masked, tiles = _neighbor_prep(
        xyz, mask, viewpoint, tile
    )
    prec = jax.lax.Precision.HIGHEST

    def one_tile(args):
        qt, qm, base = args  # (tile, 2), (tile,), ()
        d = _tile_dist2(qt, base, p2c, t_sq_masked)
        # STRICT <: FLANN/nanoflann RadiusResultSet::addPoint uses
        # `dist < radius` on squared distances (nanoflann.hpp:249-250),
        # so a neighbor at exactly the search radius is excluded
        nbr = (d < r2) & qm[:, None]  # (tile, P)
        nbr_f = nbr.astype(jnp.float32)
        sums = jnp.matmul(nbr_f, moments, precision=prec)  # (tile, 6)
        v, curv = _sums_to_normal(sums)

        # the 2-neighbor "other" point = nearest neighbor excluding self;
        # self is addressed by index (exact), not by argmin on noisy scores
        t = qt.shape[0]
        masked_d = jnp.where(nbr, d, jnp.inf)
        d_no_self = masked_d.at[
            jnp.arange(t), base + jnp.arange(t)
        ].set(jnp.inf, mode="drop")
        other_idx = jnp.argmin(d_no_self, axis=1)

        count_i = jnp.sum(nbr, axis=1)
        return _finalize_normals(qt, p2c[other_idx], count_i, v, curv, qm, vpc)

    normal, curv, ok = jax.lax.map(one_tile, tiles)
    return _tiles_epilogue(normal, curv, ok, n)


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def normals_2d_knn(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    viewpoint: tuple[float, float] = (0.0, 0.0),
    tile: int = 512,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """setKSearch mode: the neighborhood is the k nearest points (self
    included, like pcl::search::KdTree::nearestKSearch —
    /root/reference/src/Normal2dEstimation.cpp:29-38, :106-190).

    Returns (normals (N,3) z=0, curvature (N,), valid (N,)); valid is False
    for padding and for neighborhoods of < 2 points (k < 2 or fewer valid
    points than 2 in the cloud — NaN in the reference).  Like
    nearestKSearch, k clamps to the cloud size when it exceeds it.
    """
    n = xyz.shape[0]
    k = min(k, n)
    _, p2c, vpc, moments, t_sq_masked, tiles = _neighbor_prep(
        xyz, mask, viewpoint, tile
    )

    def one_tile(args):
        qt, qm, base = args
        d = _tile_dist2(qt, base, p2c, t_sq_masked)
        neg_d, idx = jax.lax.top_k(-d, k)  # ascending distance order
        picked = jnp.isfinite(neg_d) & qm[:, None]  # drop masked fill-ins
        count_i = jnp.sum(picked, axis=1)

        sums = jnp.sum(
            jnp.where(picked[:, :, None], moments[idx], 0.0), axis=1
        )  # (tile, 6)
        v, curv = _sums_to_normal(sums)

        # nearestKSearch order is ascending and the self column is exactly 0
        # (_tile_dist2), so idx[:, 0] is self and idx[:, 1] the 2-neighbor
        # "other" point
        return _finalize_normals(qt, p2c[idx[:, 1]], count_i, v, curv, qm, vpc)

    normal, curv, ok = jax.lax.map(one_tile, tiles)
    return _tiles_epilogue(normal, curv, ok, n)


class Normal2dEstimation:
    """API-parity facade over the vectorized kernels, mirroring the installed
    pcl_norm_2d library interface (/root/reference/include/Normal2dEstimation.h:
    48-130): set_input_cloud / set_indices / set_radius_search / set_k_search
    / set_view_point / compute.

    Like the reference, exactly one of radius or k must be set
    (Normal2dEstimation.cpp:117-124), and with indices both the query set AND
    the search tree restrict to the subset (the kd-tree is built on
    ``(m_in_cloud, m_indices)``, :126).  compute() returns
    (normals (N,3), curvature (N,), valid (N,)) where entry i corresponds to
    indices[i] (the reference writes normal_cloud->points[idx] for idx over
    the indices vector); entries past len(indices) are zero.
    """

    def __init__(self) -> None:
        self._xyz = None
        self._indices = None
        self._radius = 0.0
        self._k = 0
        self._viewpoint = (0.0, 0.0)

    def set_input_cloud(self, xyz) -> None:
        self._xyz = jnp.asarray(xyz, jnp.float32)

    def set_indices(self, indices) -> None:
        self._indices = None if indices is None else jnp.asarray(indices, jnp.int32)

    def set_radius_search(self, radius: float) -> None:
        self._radius = float(radius)

    def set_k_search(self, k: int) -> None:
        self._k = int(k)

    def set_view_point(self, vx: float, vy: float) -> None:
        self._viewpoint = (float(vx), float(vy))

    def compute(self):
        if self._xyz is None:
            raise RuntimeError("You have to set a cloud before ask any result !")
        if self._k == 0 and self._radius == 0.0:
            raise RuntimeError(
                "You must call once either setRadiusSearch or setKSearch !"
            )
        if self._k != 0 and self._radius != 0.0:
            raise RuntimeError(
                "You must call once either setRadiusSearch or setKSearch (not both) !"
            )
        xyz = self._xyz
        n = xyz.shape[0]
        if self._indices is not None:
            sub = xyz[self._indices]
            m = jnp.ones((sub.shape[0],), bool)
        else:
            sub = xyz
            m = jnp.ones((n,), bool)
        if self._k:
            nrm, curv, ok = normals_2d_knn(sub, m, self._k, self._viewpoint)
        else:
            nrm, curv, ok = normals_2d(sub, m, self._radius, self._viewpoint)
        if self._indices is not None:
            out_n = jnp.zeros((n, 3), jnp.float32).at[: sub.shape[0]].set(nrm)
            out_c = jnp.zeros((n,), jnp.float32).at[: sub.shape[0]].set(curv)
            out_ok = jnp.zeros((n,), bool).at[: sub.shape[0]].set(ok)
            return out_n, out_c, out_ok
        return nrm, curv, ok
