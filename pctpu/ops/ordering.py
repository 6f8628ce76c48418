"""Cylindrical ordering: scatter points into the dense (N_SCAN, Horizon_SCAN)
range-image grid.

Reproduces ``getOrderedCloud`` (/root/reference/BatchMultiBevGen.cpp:94-117):
points with out-of-bounds row/col are dropped; cells never hit stay all-zero
(default-constructed); when several points map to one cell the **last** one in
input order wins.

Design: the sequential "last wins" rule becomes one ``segment_max`` over
point indices followed by a single row gather: all eight point fields are
bitcast-packed into one (P, 8) int32 matrix and fetched with one gather
instead of eight.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pctpu.cloud import Cloud
from pctpu.config import SensorParams


def _grid_ordered_core(
    xyz: np.ndarray, intensity: np.ndarray, row: np.ndarray, col: np.ndarray,
    t: np.ndarray, label: np.ndarray, count: int, params: SensorParams,
) -> bool:
    """Shared predicate behind is_grid_ordered / arrays_grid_ordered.

    A slot counts as *empty* only when its float fields are **bit**-zero
    (+0.0): a -0.0 coordinate is a real point the reference's last-wins
    scatter would store byte-for-byte (0x80000000), so such clouds must take
    the general ordering kernel to keep bit parity.
    """
    g = params.grid_size
    if xyz.shape[0] != g or count != g:
        return False
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    xyz_bits = np.ascontiguousarray(np.asarray(xyz, np.float32)).view(np.uint32)
    inten_bits = np.ascontiguousarray(
        np.asarray(intensity, np.float32)
    ).view(np.uint32)
    is_zero = (
        (row == 0) & (col == 0) & (np.asarray(label) == 0)
        & (np.asarray(t) == 0)
        & (inten_bits == 0) & (xyz_bits == 0).all(axis=1)
    )
    in_place = (
        (row >= 0) & (row < params.n_scan)
        & (col >= 0) & (col < params.horizon_scan)
        & (row * params.horizon_scan + col == np.arange(g))
    )
    return bool(np.all(is_zero | in_place))


def is_grid_ordered(cloud: Cloud, params: SensorParams) -> bool:
    """Host-side check: is this cloud already in dense sensor-grid layout?

    True when the cloud has exactly ``grid_size`` points and every slot ``i``
    holds either an all-(bit-)zero point (an empty cell, label 0) or an
    in-bounds point with ``row*H + col == i`` — the layout the selector
    binaries write (/root/reference/KittiPointCloudSelect.cpp:240).  For such
    inputs ``getOrderedCloud`` reduces to a slot-0 fix-up (see
    ``pctpu.ops.preprocess._reorder_preordered``), letting the pipelines skip
    the scatter+gather ordering kernel.
    """
    return _grid_ordered_core(
        np.asarray(cloud.xyz), np.asarray(cloud.intensity),
        np.asarray(cloud.row), np.asarray(cloud.col), np.asarray(cloud.t),
        np.asarray(cloud.label), int(cloud.count), params,
    )


def arrays_grid_ordered(arrays: dict, params: SensorParams) -> bool:
    """``is_grid_ordered`` for the loader's SoA dict form (narrow dtypes,
    see pctpu.runtime.loader.load_xyzirct_arrays)."""
    return _grid_ordered_core(
        arrays["xyz"], arrays["intensity"], arrays["row"], arrays["col"],
        arrays["t"], arrays["label"], int(arrays["count"]), params,
    )


def compact_last_wins(data: dict, n: int, params: SensorParams) -> tuple[dict, int]:
    """Host-side pre-reduction for clouds LARGER than the pipeline's fixed
    grid capacity: keep only each grid cell's last-wins winner, in input
    order.

    ``getOrderedCloud`` (/root/reference/BatchMultiBevGen.cpp:94-117) retains
    at most one point per cell — the last in input order — and drops
    out-of-bounds points, so for any raw cloud, ordering(winners) ==
    ordering(raw) exactly: the compacted cloud (≤ grid_size points) routes
    through the same on-device ordering kernel and reproduces the
    reference's single-pass result bit-for-bit, where naive truncation to
    capacity would lose late-arriving winners.  ``data`` is a pcd field dict
    (1-D arrays, ≥ n long); returns (compacted field dict, winner count).
    """
    rows = np.asarray(data["row"][:n], np.int64)
    cols = np.asarray(data["col"][:n], np.int64)
    ib = (
        (rows >= 0) & (rows < params.n_scan)
        & (cols >= 0) & (cols < params.horizon_scan)
    )
    cell = rows[ib] * params.horizon_scan + cols[ib]
    winner = np.full(params.grid_size, -1, np.int64)
    # ufunc.at is defined for repeated indices: per-cell max input index ==
    # the reference's last-wins overwrite order
    np.maximum.at(winner, cell, np.flatnonzero(ib))
    keep = np.sort(winner[winner >= 0])
    return {k: np.asarray(v)[:n][keep] for k, v in data.items()}, len(keep)


def get_ordered_cloud(cloud: Cloud, params: SensorParams) -> Cloud:
    """Order a padded cloud into the dense sensor grid.

    Returns a Cloud of capacity ``params.grid_size`` whose slot ``r*H + c``
    holds the last input point with (row, col) == (r, c), or zeros.
    """
    g = params.grid_size
    p = cloud.capacity
    in_bounds = (
        (cloud.row >= 0)
        & (cloud.row < params.n_scan)
        & (cloud.col >= 0)
        & (cloud.col < params.horizon_scan)
        & cloud.valid_mask()
    )
    cell = cloud.row * params.horizon_scan + cloud.col
    cell = jnp.where(in_bounds, cell, g)  # dropped points land in a spare slot

    point_idx = jnp.arange(p, dtype=jnp.int32)
    winner = jax.ops.segment_max(point_idx, cell, num_segments=g + 1)[:g]
    occupied = winner >= 0
    src = jnp.where(occupied, winner, 0)

    # one packed row gather instead of one gather per field
    packed = jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(cloud.xyz, jnp.int32),
            jax.lax.bitcast_convert_type(cloud.intensity, jnp.int32)[:, None],
            cloud.row[:, None],
            cloud.col[:, None],
            jax.lax.bitcast_convert_type(cloud.t, jnp.int32)[:, None],
            cloud.label[:, None],
        ],
        axis=1,
    )  # (P, 8) int32
    taken = jnp.where(occupied[:, None], packed[src], 0)

    return Cloud(
        xyz=jax.lax.bitcast_convert_type(taken[:, 0:3], jnp.float32),
        intensity=jax.lax.bitcast_convert_type(taken[:, 3], jnp.float32),
        row=taken[:, 4],
        col=taken[:, 5],
        t=jax.lax.bitcast_convert_type(taken[:, 6], jnp.uint32),
        label=taken[:, 7],
        count=jnp.asarray(g, jnp.int32),
    )
