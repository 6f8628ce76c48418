"""Deterministic voxel-grid centroid downsampling (PCL VoxelGrid semantics).

Reproduces ``pcl::VoxelGrid`` with leaf 0.2
(/root/reference/BatchTopPartRegistration.cpp:342-346): voxel index
ijk = floor(coord / leaf) offset by the cloud min; one output point per
occupied voxel = the centroid of its points; outputs ordered by ascending
flat voxel index (PCL sorts its index vector).

Design: dynamic voxel counts become a fixed-size sort + segment mean: sort
points by voxel key, detect segment heads, fold each voxel's points in order
(``ops/segment.py``), and compact — all static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pctpu.ops.segment import ordered_segment_sum


def voxel_downsample(
    xyz: jnp.ndarray, mask: jnp.ndarray, leaf: float
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(xyz (N,3), valid (N,), leaf) → (centroids (N,3), valid (N,), count).

    Centroids are compacted to the front in ascending-voxel order.
    """
    n = xyz.shape[0]
    inv = 1.0 / leaf
    big = jnp.float32(1e30)
    guarded = jnp.where(mask[:, None], xyz, big)
    mins = jnp.min(guarded, axis=0)
    ijk = jnp.floor(xyz * inv).astype(jnp.int32)
    min_b = jnp.floor(mins * inv).astype(jnp.int32)
    maxs = jnp.max(jnp.where(mask[:, None], xyz, -big), axis=0)
    max_b = jnp.floor(maxs * inv).astype(jnp.int32)
    div = max_b - min_b + 1
    # int32-overflow guard: pcl::VoxelGrid bails out when dx*dy*dz exceeds
    # INT32_MAX; here extents clamp instead (stray far returns land in
    # boundary voxels rather than aliasing unrelated cells).  The clamp is
    # shape-aware: x/y cap at 4096 cells each, and z gets whatever of the
    # 2³⁰-key budget remains — so e.g. a 100×100×60 m cloud at leaf 0.2
    # (500×500×300 cells) is EXACT, and the divergence only bites where
    # PCL itself is near its own int32 bail-out (documented).
    dxy_cap = jnp.int32(4096)
    dx = jnp.minimum(div[0], dxy_cap)
    dy = jnp.minimum(div[1], dxy_cap)
    dz = jnp.minimum(div[2], jnp.maximum(jnp.int32(1 << 30) // (dx * dy), 1))
    div = jnp.stack([dx, dy, dz])
    rel = jnp.clip(ijk - min_b, 0, div - 1)
    key = rel[:, 0] + rel[:, 1] * div[0] + rel[:, 2] * div[0] * div[1]
    sentinel = div[0] * div[1] * div[2]
    key = jnp.where(mask, key, sentinel)

    # payload-carrying stable sort (x/y/z ride the sort instead of being
    # gathered through an argsort permutation)
    key_s, x_s, y_s, z_s, m_s = jax.lax.sort(
        [key, xyz[:, 0], xyz[:, 1], xyz[:, 2], mask.astype(jnp.int32)],
        num_keys=1,
        is_stable=True,
    )
    xyz_s = jnp.stack([x_s, y_s, z_s], axis=1)
    mask_s = m_s.astype(bool)

    head = jnp.concatenate(
        [jnp.ones((1,), bool), key_s[1:] != key_s[:-1]]
    ) & mask_s
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1  # segment id per sorted point
    seg = jnp.where(mask_s, seg, n - 1)  # park padding in the last slot

    # coordinate sums fold in sorted (= stable input) order per voxel; the
    # counts are integer adds, exact in any order
    fold_ids = jnp.where(mask_s, seg, n)
    ssum = ordered_segment_sum(xyz_s, fold_ids, n)
    scount = jnp.zeros((n + 1,), jnp.int32).at[fold_ids].add(1)[:n]
    scount = scount.astype(jnp.float32)
    nvox = jnp.sum(head.astype(jnp.int32))
    valid = jnp.arange(n) < nvox
    centroids = jnp.where(
        valid[:, None], ssum / jnp.maximum(scount, 1.0)[:, None], 0.0
    )
    return centroids, valid, nvox
