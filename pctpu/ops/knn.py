"""Nearest-neighbor queries as blocked brute-force distance matmuls.

The reference uses kd-trees (nanoflann for pose queries, pcl::search::KdTree
for ICP correspondences and normal neighborhoods).  Here exact NN is dense
distance algebra: ||q-t||² = ||q||² + ||t||² - 2·q·tᵀ, tiled over the query
axis so only one (tile, T) distance block exists at a time.  ``nn_1`` is the
plain reference and the CPU path; on a GPU the fine-stage search runs the
pruned kernel in ``ops/pallas_knn.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_INF = jnp.float32(jnp.inf)
# Full f32 accumulation: the default (bf16-class) matmul precision corrupts
# squared distances by ~1e-1, which flips NN winners and poisons ICP.
_PREC = jax.lax.Precision.HIGHEST


def _pad_rows(x: jnp.ndarray, multiple: int) -> jnp.ndarray:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        pad = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, pad)
    return x


def nn_1(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    tile: int = 512,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """1-NN of each query point in target.

    Returns (index (Q,) int32, squared distance (Q,) float32); masked-out
    targets are +inf away, masked-out queries return index 0 / +inf.
    """
    query = jnp.asarray(query)
    query_mask = jnp.asarray(query_mask)
    target = jnp.asarray(target)
    target_mask = jnp.asarray(target_mask)
    q = query.shape[0]
    qp = _pad_rows(query, tile)
    qmask = _pad_rows(query_mask, tile)
    t_sq = jnp.sum(target * target, axis=1)
    t_sq = jnp.where(target_mask, t_sq, _INF)

    def one_tile(args):
        qt, qm = args
        d = (
            jnp.sum(qt * qt, axis=1, keepdims=True)
            - 2.0 * jnp.matmul(qt, target.T, precision=_PREC)
            + t_sq[None, :]
        )
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        # re-derive the winner's distance directly: the expansion carries an
        # absolute error ~|p|²·2⁻²⁴ that would floor fitness scores
        diff = qt - target[idx]
        best = jnp.sum(diff * diff, axis=1)
        best = jnp.where(qm & target_mask[idx], best, _INF)
        return idx, best

    tiles_q = qp.reshape(-1, tile, 3)
    tiles_m = qmask.reshape(-1, tile)
    idx, dist = jax.lax.map(one_tile, (tiles_q, tiles_m))
    return idx.reshape(-1)[:q], dist.reshape(-1)[:q]


def knn(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    k: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """k-NN for small target sets (pose tables): full (Q, T) matrix + top_k.

    Returns (indices (Q, k'), squared distances (Q, k')) ascending, with
    k' = min(k, T) like pcl nearestKSearch (fewer targets than requested →
    the available ones).  Winner distances are re-derived exactly from the
    coordinates: the ||q||²−2qt+||t||² expansion carries ~|p|²·2⁻²⁴ absolute
    error (can even go negative near self-matches), which matters when the
    caller compares against thresholds like keyframe_interval².
    """
    k = min(k, target.shape[0])
    d = (
        jnp.sum(query * query, axis=1, keepdims=True)
        - 2.0 * jnp.matmul(query, target.T, precision=_PREC)
        + jnp.where(target_mask, jnp.sum(target * target, axis=1), _INF)[None, :]
    )
    neg_d, idx = jax.lax.top_k(-d, k)
    idx = idx.astype(jnp.int32)
    diff = query[:, None, :] - target[idx]
    exact = jnp.sum(diff * diff, axis=-1)
    found = jnp.isfinite(-neg_d) & query_mask[:, None] & target_mask[idx]
    dist = jnp.where(found, exact, _INF)
    return idx, dist


@functools.partial(jax.jit, static_argnames=("tile",))
def nn_1_jit(query, query_mask, target, target_mask, tile: int = 512):
    return nn_1(query, query_mask, target, target_mask, tile)
