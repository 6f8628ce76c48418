"""BEV rasterization: multi-layer occupancy, uint8 height, float max-height.

Design: per-point loops with in-place image writes become single
scatter-max ops over flattened cell indices — commutative, order-independent,
and batchable with vmap.  Grid indexing uses C ``round()`` semantics
(half away from zero) to stay pixel-exact with the reference.

Reference semantics:
  * multi-layer (/root/reference/BatchMultiBevGen.cpp:261-321): 24 layers of
    224×224 uint8; x = round((px+112)/res + 0.5); layer = round(z/HEIGHT_RES
    + 2.0); ground (label==0) and out-of-range skipped; occupied = 255.
  * single-layer (ibid:331-373): per-cell max of clamp(int((z+2)*4), 0, 255),
    ground skipped.
  * float BEV (/root/reference/BatchCloudManip.cpp:201-239,
    CloudManip.cpp:79-109): 201×201 float max of z+2 (init 0); ground
    skipped only in the batch variant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pctpu.cloud import Cloud
from pctpu.config import FloatBevConfig, MultiBevConfig, SingleBevConfig
from pctpu.ops.rounding import bev_cell, c_round


def _cell_xy(px, py, max_range, interval):
    return bev_cell(px, max_range, interval), bev_cell(py, max_range, interval)


def multi_bev(
    cloud: Cloud, height_res: float, cfg: MultiBevConfig = MultiBevConfig()
) -> jnp.ndarray:
    """(num_layers, mat, mat) uint8 occupancy BEV.

    ``height_res`` is the sensor's HEIGHT_RES (metres per layer,
    /root/reference/src/Utility.cpp:101-116)."""
    s = cfg.mat_size
    nl = cfg.num_layers
    cx, cy = _cell_xy(cloud.x, cloud.y, cfg.max_range, cfg.interval)
    layer = c_round(cloud.z / height_res + cfg.lidar_to_ground_height).astype(jnp.int32)
    ok = (
        (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s)
        & (layer >= 0) & (layer < nl)
        & (cloud.label != 0)
        & cloud.valid_mask()
    )
    flat = jnp.where(ok, layer * s * s + cx * s + cy, nl * s * s)
    img = jnp.zeros((nl * s * s + 1,), jnp.uint8).at[flat].max(jnp.uint8(255))
    return img[:-1].reshape(nl, s, s)


def single_bev(cloud: Cloud, cfg: SingleBevConfig = SingleBevConfig()) -> jnp.ndarray:
    """(mat, mat) uint8 max-height BEV."""
    s = cfg.mat_size
    cx, cy = _cell_xy(cloud.x, cloud.y, cfg.max_range, cfg.interval)
    # C++ computes int((z + LIDAR_TO_GROUND_HEIGHT) * 4.0): the offset is a
    # *float* 2.0f, so z+2 rounds to f32 first; the ×4.0 double multiply is
    # exact for the default power-of-two scale, so the all-f32 chain below is
    # bit-exact (/root/reference/BatchMultiBevGen.cpp:345-346).
    height = jnp.trunc(
        (cloud.z + jnp.float32(cfg.lidar_to_ground_height))
        * jnp.float32(cfg.height_scale)
    ).astype(jnp.int32)
    height = jnp.clip(height, 0, 255).astype(jnp.uint8)
    ok = (
        (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s)
        & (cloud.label != 0)
        & cloud.valid_mask()
    )
    flat = jnp.where(ok, cx * s + cy, s * s)
    img = (
        jnp.zeros((s * s + 1,), jnp.uint8)
        .at[flat]
        .max(jnp.where(ok, height, jnp.uint8(0)))
    )
    return img[:-1].reshape(s, s)


def fused_bev_compatible(
    multi_cfg: MultiBevConfig, single_cfg: SingleBevConfig
) -> bool:
    """Whether the two BEV configs share one (cell, grid) geometry."""
    return (
        multi_cfg.max_range == single_cfg.max_range
        and multi_cfg.interval == single_cfg.interval
        and multi_cfg.mat_size == single_cfg.mat_size
        and multi_cfg.mat_size <= 2047
        and multi_cfg.num_layers <= 24
    )


def fused_multi_single_bev(
    cloud: Cloud,
    height_res: float,
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Both flagship rasters from ONE sorted pass — no scatters.

    Semantics are exactly ``(multi_bev(...), single_bev(...))`` (see the
    per-op docstrings / /root/reference/BatchMultiBevGen.cpp:261-373); the
    two scatter-max rasters become sorted-run reductions:

      1. one key sort of ``(cell << 9) | (height << 1) | sentinel`` with a
         per-point layer-occupancy bit as payload — one sentinel element per
         output cell sorts *after* that cell's points, so after the sort each
         cell's sentinel sits at the end of its run;
      2. a segmented OR scan accumulates the run's occupancy bits (the
         single-BEV max height needs no scan: the key sort already placed the
         run's max-height point immediately before the sentinel);
      3. a second sort compacts the per-sentinel results into dense cell
         order (sentinels are already cell-ordered, so a plain key sort on
         ``is_sentinel ? cell : BIG`` is a stable compaction).

    Both reductions (OR, max) are commutative, so the result is
    permutation-invariant like the scatter formulation.
    """
    assert fused_bev_compatible(multi_cfg, single_cfg), (
        "fused raster needs matching multi/single BEV grid geometry"
    )
    s = multi_cfg.mat_size
    nl = multi_cfg.num_layers
    cells = s * s

    cx, cy = _cell_xy(cloud.x, cloud.y, multi_cfg.max_range, multi_cfg.interval)
    cell = cx * s + cy
    ok_single = (
        (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s)
        & (cloud.label != 0)
        & cloud.valid_mask()
    )
    layer = c_round(
        cloud.z / height_res + multi_cfg.lidar_to_ground_height
    ).astype(jnp.int32)
    ok_multi = ok_single & (layer >= 0) & (layer < nl)
    height = jnp.trunc(
        (cloud.z + jnp.float32(single_cfg.lidar_to_ground_height))
        * jnp.float32(single_cfg.height_scale)
    ).astype(jnp.int32)
    height = jnp.clip(height, 0, 255)

    # pass 1: key sort.  Real keys carry (cell, height, 0); one sentinel per
    # cell carries (cell, 255, 1) so it sorts after every real entry of its
    # cell; invalid points get cells << 9 (past every sentinel).
    key = jnp.where(ok_single, (cell << 9) | (height << 1), cells << 9)
    sent_key = (jnp.arange(cells, dtype=jnp.int32) << 9) | (255 << 1) | 1
    keys = jnp.concatenate([key, sent_key])
    bit = jnp.where(
        ok_multi,
        jnp.left_shift(jnp.uint32(1), (8 + jnp.clip(layer, 0, nl - 1)).astype(jnp.uint32)),
        jnp.uint32(0),
    )
    bits = jnp.concatenate([bit, jnp.zeros((cells,), jnp.uint32)])
    sk, sb = jax.lax.sort([keys, bits], num_keys=1)

    # pass 2: segmented OR scan over same-cell runs, as an unrolled
    # Hillis-Steele log-step loop.  Equal cells at distance `shift` imply the
    # whole span between them is one run (keys are sorted), so the equality
    # guard is a correct segment boundary.  Unlike `lax.associative_scan`
    # with a (key, value) tuple carrier, which materializes its interleaved
    # slices, these shifted ORs fuse into a handful of elementwise passes.
    cellof = sk >> 9
    orbits = sb
    total = sk.shape[0]
    shift = 1
    while shift < total:
        same = jnp.concatenate(
            [jnp.zeros((shift,), bool), cellof[:-shift] == cellof[shift:]]
        )
        prev = jnp.concatenate([jnp.zeros((shift,), jnp.uint32), orbits[:-shift]])
        orbits = orbits | jnp.where(same, prev, jnp.uint32(0))
        shift *= 2

    is_sent = (sk & 1) == 1
    prev_h = jnp.concatenate([jnp.zeros((1,), jnp.int32), (sk >> 1) & 255])[:-1]
    prev_cell = jnp.concatenate([jnp.full((1,), -1, jnp.int32), cellof])[:-1]
    maxh = jnp.where(prev_cell == cellof, prev_h, 0).astype(jnp.uint32)
    payload = (orbits & jnp.uint32(0xFFFFFF00)) | maxh

    # pass 3: compact the (cell-ordered) sentinels to the front.
    key2 = jnp.where(is_sent, cellof, jnp.int32(0x7FFFFFFF))
    _, packed = jax.lax.sort([key2, payload], num_keys=1)
    packed = packed[:cells]

    occ = packed >> jnp.uint32(8)
    multi_img = (
        ((occ[None, :] >> jnp.arange(nl, dtype=jnp.uint32)[:, None]) & 1)
        .astype(jnp.uint8)
        * jnp.uint8(255)
    ).reshape(nl, s, s)
    single_img = (packed & jnp.uint32(0xFF)).astype(jnp.uint8).reshape(s, s)
    return multi_img, single_img


def float_bev(cloud: Cloud, cfg: FloatBevConfig = FloatBevConfig()) -> jnp.ndarray:
    """(mat, mat) float32 max(z + 2) BEV (zero-initialised)."""
    s = cfg.mat_size
    cx, cy = _cell_xy(cloud.x, cloud.y, cfg.max_range, cfg.interval)
    ok = (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s) & cloud.valid_mask()
    if cfg.filter_ground:
        ok &= cloud.label != 0
    val = cloud.z + cfg.lidar_to_ground_height
    flat = jnp.where(ok, cx * s + cy, s * s)
    img = (
        jnp.zeros((s * s + 1,), jnp.float32)
        .at[flat]
        .max(jnp.where(ok, val, 0.0))
    )
    return img[:-1].reshape(s, s)
