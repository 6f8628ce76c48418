"""Top-part extraction: keep the top 20% (by z) of each 20 m grid cell,
project to z = 0.

Reproduces ``extractTopAndFlatten``
(/root/reference/BatchTopPartRegistration.cpp:90-147): 10×10 grid over
±100 m with C-round cell indexing (so x ≥ 90 m rounds to cell 10 and is
dropped, :113-116); ground (label==0) skipped; cells with < 20 points
skipped; per cell keep round(0.2*n) points sorted by z descending; output
iterates cells in (gx, gy) row-major order, z-descending within a cell.

Design: the per-cell sort becomes one global lexsort by (cell, -z); a
point's rank inside its cell is its sorted position minus the cell's start
offset, and selection is ``rank < k(cell)`` — fixed shapes, no ragged
buckets.  The compacted output preserves the reference's exact point order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pctpu.cloud import Cloud
from pctpu.config import TopFlattenConfig
from pctpu.ops.rounding import c_round


def extract_top_and_flatten(
    cloud: Cloud, cfg: TopFlattenConfig = TopFlattenConfig()
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (xyz (N,3) with z=0, valid mask (N,), count) — compacted to the
    front in reference order, zero-padded."""
    ncell = cfg.num_grid_x * cfg.num_grid_y
    gx = c_round((cloud.x + cfg.max_radius_x) / cfg.grid_res_x).astype(jnp.int32)
    gy = c_round((cloud.y + cfg.max_radius_y) / cfg.grid_res_y).astype(jnp.int32)
    ok = (
        (cloud.label != 0)
        & (gx >= 0) & (gx < cfg.num_grid_x)
        & (gy >= 0) & (gy < cfg.num_grid_y)
        & cloud.valid_mask()
    )
    cell = jnp.where(ok, gx * cfg.num_grid_y + gy, ncell)
    p = cloud.capacity

    # global sort: cell ascending, z descending (stable → original order on
    # ties).  Payload-carrying multi-operand sort: x/y ride the sort
    # instead of being fetched through argsort indices afterwards.
    cell_s, _, x_s, y_s = jax.lax.sort(
        [cell, -cloud.z, cloud.x, cloud.y], num_keys=2, is_stable=True
    )

    # per-point run geometry from boundary scans (no scatters):
    # rank inside the cell and the cell's total count
    i = jnp.arange(p, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), cell_s[1:] != cell_s[:-1]]
    )
    is_end = jnp.concatenate([cell_s[1:] != cell_s[:-1], jnp.ones((1,), bool)])
    run_start = jax.lax.cummax(jnp.where(is_start, i, 0))
    run_end = jnp.flip(jax.lax.cummin(jnp.flip(jnp.where(is_end, i, p))))
    rank = i - run_start
    count_pt = (run_end - run_start + 1).astype(jnp.float32)
    # C++: round(0.2f * n) — the f32 literal product (latent-only at
    # realistic cell sizes, but transcribed faithfully)
    k_pt = c_round(jnp.float32(cfg.top_fraction) * count_pt).astype(jnp.int32)
    k_pt = jnp.where(count_pt >= cfg.min_grid_points, k_pt, 0)
    keep = (rank < k_pt) & (cell_s < ncell)

    # compact kept points to the front, preserving sorted (reference) order
    nkept = jnp.sum(keep.astype(jnp.int32))
    _, x_c, y_c = jax.lax.sort(
        [(~keep).astype(jnp.int32), x_s, y_s], num_keys=1, is_stable=True
    )
    keep_c = i < nkept
    xyz = jnp.stack(
        [
            jnp.where(keep_c, x_c, 0.0),
            jnp.where(keep_c, y_c, 0.0),
            jnp.zeros((p,), jnp.float32),  # flatten (:140-143)
        ],
        axis=1,
    )
    return xyz, keep_c, nkept
