"""Fused per-cloud preprocessing: ordering + ground marking + BEV rasters.

This is the hot loop of the flagship pipeline
(the reference's BatchMultiBevGen.cpp:727-757).  The whole per-cloud
body is one jitted function over fixed-size padded arrays; the batch
dimension is vmapped and (in pipelines) sharded over the device mesh — pure
data parallelism, no cross-device collectives in the hot path (SURVEY.md §5.8).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pctpu.cloud import Cloud
from pctpu.config import (
    GroundConfig,
    MultiBevConfig,
    SensorParams,
    SingleBevConfig,
)
from pctpu.ops.bev import (
    fused_bev_compatible,
    fused_multi_single_bev,
    multi_bev,
    single_bev,
)
from pctpu.ops.ground import mark_ground
from pctpu.ops.ordering import get_ordered_cloud


@functools.partial(
    jax.jit,
    static_argnames=("params", "ground_cfg", "multi_cfg", "single_cfg",
                     "assume_ordered", "compat"),
)
def preprocess_cloud(
    cloud: Cloud,
    params: SensorParams,
    ground_cfg: GroundConfig = GroundConfig(),
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
    assume_ordered: bool = False,
    compat: str = "bitexact",
) -> tuple[Cloud, jnp.ndarray, jnp.ndarray]:
    """One cloud → (labeled ordered cloud, multi-BEV u8, single-BEV u8).

    ``assume_ordered=True`` is the production fast path: the selector tools
    emit clouds already scattered onto the dense sensor grid
    (/root/reference/KittiPointCloudSelect.cpp:240 — slot ``row*H + col``
    holds the point, empty slots all-zero), so re-running ``getOrderedCloud``
    is the identity except at slot 0, where every all-zero slot competes for
    cell (0, 0) and the last one wins.  The caller must have verified the
    layout host-side (``pctpu.ops.ordering.is_grid_ordered``).
    """
    if assume_ordered:
        ordered = _reorder_preordered(cloud, params)
    else:
        ordered = get_ordered_cloud(cloud, params)
    labeled, _ = mark_ground(ordered, params, ground_cfg, compat=compat)
    if fused_bev_compatible(multi_cfg, single_cfg):
        multi_img, single_img = fused_multi_single_bev(
            labeled, params.height_res, multi_cfg, single_cfg
        )
    else:
        multi_img = multi_bev(labeled, params.height_res, multi_cfg)
        single_img = single_bev(labeled, single_cfg)
    return labeled, multi_img, single_img


def _reorder_preordered(cloud: Cloud, params: SensorParams) -> Cloud:
    """getOrderedCloud on an already-grid-ordered cloud.

    Equals the input except slot 0: all-zero slots carry (row, col) = (0, 0),
    so under the reference's last-wins scatter
    (/root/reference/BatchMultiBevGen.cpp:94-117) the last all-zero slot — if
    any exists — overwrites cell 0.  An all-zero overwrite is itself all-zero,
    so the update is "zero slot 0 iff any slot beyond 0 is all-zero".
    """
    zero_slot = (
        (cloud.row == 0)
        & (cloud.col == 0)
        & jnp.all(cloud.xyz == 0.0, axis=1)
        & (cloud.intensity == 0.0)
        & (cloud.t == 0)
        & (cloud.label == 0)
    )
    any_zero = jnp.any(zero_slot[1:])
    keep0 = ~any_zero

    def zero_first(arr):
        # select, not multiply: ×0 would turn negatives into -0.0 and leave
        # NaN/Inf in place, diverging byte-wise from the scatter path
        return arr.at[0].set(jnp.where(keep0, arr[0], jnp.zeros_like(arr[0])))

    return Cloud(
        xyz=zero_first(cloud.xyz),
        intensity=zero_first(cloud.intensity),
        row=zero_first(cloud.row),
        col=zero_first(cloud.col),
        t=zero_first(cloud.t),
        label=zero_first(cloud.label),
        count=jnp.asarray(params.grid_size, jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("params", "ground_cfg", "multi_cfg", "single_cfg",
                     "assume_ordered", "compat"),
)
def preprocess_batch(
    clouds: Cloud,
    params: SensorParams,
    ground_cfg: GroundConfig = GroundConfig(),
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
    assume_ordered: bool = False,
    compat: str = "bitexact",
) -> tuple[Cloud, jnp.ndarray, jnp.ndarray]:
    """Batched variant: every Cloud field carries a leading batch axis."""
    fn = functools.partial(
        preprocess_cloud,
        params=params,
        ground_cfg=ground_cfg,
        multi_cfg=multi_cfg,
        single_cfg=single_cfg,
        assume_ordered=assume_ordered,
        compat=compat,
    )
    return jax.vmap(fn)(clouds)
