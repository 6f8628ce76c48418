"""Exact 1-NN over spatially sorted clouds: a Pallas kernel for the GPU
(Triton route) that prunes far tile pairs by bounding box.

The registration hot op is, per ICP iteration, a (Q, T) squared-distance
problem.  The plain XLA version (``ops/knn.py::nn_1``, kept as the
reference and the CPU path) writes a (tile, T) distance block to device
memory for every query tile and reduces it afterwards.  This kernel never
materializes distances: one program owns a tile of queries, walks the target
tiles in a loop, and keeps the running (min, argmin) in registers.  Both
clouds are Morton-sorted (``spatial_sort``), so tiles are compact boxes and
most tile pairs are provably too far apart to hold a winner:

  * static threshold (ICP correspondence NN): a target tile whose box is
    further than max_correspondence_distance from the query tile's box
    cannot produce an accepted correspondence — queries whose true NN lies
    beyond the threshold get d² = +inf, which the ICP weights to zero anyway
    (the reference's BatchTopPartRegistration.cpp:199-239 semantics);
  * dynamic bound (fitness NN, no threshold): a target tile further than the
    worst current best of the query tile cannot improve any query.  Target
    tiles are visited starting from the diagonal (sorted clouds ⇒ spatially
    aligned), so the bound tightens after the first few near tiles.

The contraction has depth 3, so it runs as f32 FMAs on the CUDA cores; the
tensor cores (and TF32) never enter.  For the argmin it suffices to minimize
|t|² − 2·q·t (|q|² is constant per query); the winner's exact distance is
re-derived from its coordinates at the end.

Reference equivalents: pcl::search::KdTree 1-NN inside ICP correspondence
estimation (/root/reference/BatchTopPartRegistration.cpp:199-239) and
nanoflann queries (/root/reference/BatchMultiBevGen.cpp:534-613).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BIG = 3e38  # python float: a jnp constant would be captured by the kernel


def morton_sort_key(xyz: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """16-bit 2-D Morton code over (x, y) — a cheap locality-preserving sort
    key.  Masked points get the maximum key so they sort to the end."""
    lo = jnp.min(jnp.where(mask[:, None], xyz, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], xyz, -jnp.inf), axis=0)
    span = jnp.maximum(hi - lo, 1e-6)
    q = jnp.clip(((xyz - lo) / span * 255.0).astype(jnp.int32), 0, 255)

    def spread(v):  # interleave 8 bits with zeros
        v = (v | (v << 4)) & 0x0F0F
        v = (v | (v << 2)) & 0x3333
        v = (v | (v << 1)) & 0x5555
        return v

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1)
    return jnp.where(mask, key, jnp.int32(0x7FFFFFFF))


def spatial_sort(xyz: jnp.ndarray, mask: jnp.ndarray):
    """Sort points by Morton code; returns (xyz_sorted, mask_sorted, order)."""
    key = morton_sort_key(xyz, mask)
    order = jnp.argsort(key)
    return xyz[order], mask[order], order


def spatial_sort_payload(xyz: jnp.ndarray, mask: jnp.ndarray, *extras):
    """Morton sort carrying payload columns through the sort (one sort
    instead of an argsort plus a gather per column).  Returns
    (xyz_s, mask_s, *extras_s); each extra may be (N,) or (N, K) (sorted
    column-wise)."""
    key = morton_sort_key(xyz, mask)
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2], mask.astype(jnp.int32)]
    splits = []
    for e in extras:
        if e.ndim == 1:
            splits.append((len(cols), 1, e.dtype))
            cols.append(e.astype(jnp.float32) if e.dtype == jnp.bool_ else e)
        else:
            splits.append((len(cols), e.shape[1], e.dtype))
            cols.extend(e[:, j] for j in range(e.shape[1]))
    out = jax.lax.sort([key] + cols, num_keys=1)
    xyz_s = jnp.stack(out[1:4], axis=1)
    mask_s = out[4].astype(bool)
    extras_s = []
    for start, width, dt in splits:
        if width == 1:
            extras_s.append(out[1 + start].astype(dt))
        else:
            extras_s.append(jnp.stack(out[1 + start : 1 + start + width], axis=1).astype(dt))
    return (xyz_s, mask_s, *extras_s)


def _tile_bboxes(xyz: jnp.ndarray, mask: jnp.ndarray, tile: int) -> jnp.ndarray:
    """(6, n_tiles) f32: rows [minx miny minz maxx maxy maxz]; fully masked
    tiles get an impossible box (min=+big, max=-big) so every gap test skips
    them."""
    n = xyz.shape[0]
    nt = n // tile
    x = xyz.reshape(nt, tile, 3)
    m = mask.reshape(nt, tile, 1)
    mins = jnp.min(jnp.where(m, x, _BIG), axis=1)
    maxs = jnp.max(jnp.where(m, x, -_BIG), axis=1)
    return jnp.concatenate([mins.T, maxs.T], axis=0)


def _diag_tile(i, j, nq_t, nt_t):
    """Target tile visited at step j by query tile i: a diagonal start, so
    spatially aligned tiles come first."""
    return (i * nt_t // nq_t + j) % nt_t


def _nn_kernel(qb_ref, tb_ref, thr_ref, q_ref, t_ref, val_ref, idx_ref, *,
               nq_t: int, nt_t: int, tq: int, tt: int):
    """One program per query tile; an in-kernel loop over target tiles.

    ``q_ref`` (4, qp): x, y, z, valid.  ``t_ref`` (4, tp): x, y, z, |t|²
    (+big for masked targets).  ``qb_ref``/``tb_ref`` (6, n_tiles): boxes.
    Writes the per-query best d² estimate (−big for masked queries, +big
    when no tile was visited) and its global target index.
    """
    i = pl.program_id(0)
    qs = pl.ds(i * tq, tq)
    qx, qy, qz = q_ref[0, qs], q_ref[1, qs], q_ref[2, qs]
    q2 = qx * qx + qy * qy + qz * qz
    # masked queries start at -big: they never update and never hold the
    # dynamic bound open
    best = jnp.where(q_ref[3, qs] > 0.5, _BIG, -_BIG)
    arg = jnp.zeros((tq,), jnp.int32)
    thr = thr_ref[0]
    q_lo = [qb_ref[d, i] for d in range(3)]
    q_hi = [qb_ref[3 + d, i] for d in range(3)]

    def visit(carry):
        best, arg, jj = carry
        ts = pl.ds(jj * tt, tt)
        tx, ty, tz = t_ref[0, ts], t_ref[1, ts], t_ref[2, ts]
        cross = (qx[:, None] * tx[None, :] + qy[:, None] * ty[None, :]
                 + qz[:, None] * tz[None, :])
        score = t_ref[3, ts][None, :] - 2.0 * cross
        tile_best = jnp.min(score, axis=1) + q2
        tile_arg = jnp.argmin(score, axis=1).astype(jnp.int32) + jj * tt
        # equal scores break toward the LOWEST global index (the kd-tree /
        # ops.knn.nn_1 convention), whatever the visit order
        better = (tile_best < best) | ((tile_best == best) & (tile_arg < arg))
        return jnp.where(better, tile_best, best), jnp.where(better, tile_arg, arg)

    def step(j, carry):
        best, arg, bound = carry
        jj = _diag_tile(i, j, nq_t, nt_t)
        gap = jnp.float32(0.0)
        for d in range(3):
            g = jnp.maximum(
                jnp.maximum(tb_ref[d, jj] - q_hi[d], q_lo[d] - tb_ref[3 + d, jj]),
                0.0,
            )
            gap = gap + g * g

        def hit(c):
            b, a = visit((c[0], c[1], jj))
            # the bound only moves when a tile was visited, so it rides the
            # loop carry instead of being re-reduced every step
            return b, a, jnp.minimum(thr, jnp.max(b))

        return jax.lax.cond(gap <= bound, hit, lambda c: c, (best, arg, bound))

    best, arg, _ = jax.lax.fori_loop(
        0, nt_t, step, (best, arg, jnp.minimum(thr, jnp.max(best)))
    )
    val_ref[qs] = best
    idx_ref[qs] = arg


def _planes(xyz, n_pad: int, fourth):
    """(N,3) → (4, n_pad) planes [x, y, z, fourth] with zero padding."""
    n = xyz.shape[0]
    return jnp.zeros((4, n_pad), jnp.float32).at[:, :n].set(
        jnp.concatenate([xyz.T, fourth[None]], axis=0)
    )


@functools.partial(
    jax.jit,
    static_argnames=("max_distance", "tq", "tt", "num_warps", "interpret"),
)
def pallas_nn_1_pruned(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    max_distance: float | None = None,
    tq: int = 64,
    tt: int = 32,
    num_warps: int = 2,
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """1-NN with tile pruning, exact up to score-domain ties.  Both clouds
    MUST be spatially sorted (``spatial_sort``) for the pruning to bite.

    Returns (index (Q,) int32, squared distance (Q,) f32) like
    ``ops.knn.nn_1``.  Winners are picked on f32 scores ``|t|² − 2q·t``
    (absolute error ~|p|²·2⁻²³, like the XLA blocked argmin): targets whose
    true distances differ by less than that window may resolve either way.
    Away from such ties results match the exact oracle index for index; the
    returned distance is always re-derived from the winner's coordinates.
    Queries with no target within ``max_distance`` return +inf.  vmap-safe
    (the registration stages map it over the pair batch).

    ``tq``/``tt`` are the query/target tile sizes (powers of two) and
    ``num_warps`` the warps per program; the defaults are the fastest of a
    sweep on an H100 at 16 x 49k² (PERF.md).  ``interpret=True`` runs the
    kernel in the Pallas interpreter (tests only).
    """
    if tq & (tq - 1) or tt & (tt - 1):
        raise ValueError(f"tile sizes must be powers of two, got {tq}, {tt}")
    qn, tn = query.shape[0], target.shape[0]
    qp = -(-qn // tq) * tq
    tp = -(-tn // tt) * tt
    q_planes = _planes(query, qp, query_mask.astype(jnp.float32))
    t_sq = jnp.where(target_mask, jnp.sum(target * target, axis=1), _BIG)
    t_planes = _planes(target, tp, t_sq)
    t_planes = t_planes.at[3, tn:].set(_BIG)
    q_bbox = _tile_bboxes(
        q_planes[:3].T, jnp.zeros((qp,), bool).at[:qn].set(query_mask), tq
    )
    t_bbox = _tile_bboxes(
        t_planes[:3].T, jnp.zeros((tp,), bool).at[:tn].set(target_mask), tt
    )
    thr = jnp.full(
        (1,),
        _BIG if max_distance is None else np.float32(max_distance) ** 2,
        jnp.float32,
    )
    nq_t, nt_t = qp // tq, tp // tt
    val, idx = pl.pallas_call(
        functools.partial(_nn_kernel, nq_t=nq_t, nt_t=nt_t, tq=tq, tt=tt),
        grid=(nq_t,),
        out_shape=[
            jax.ShapeDtypeStruct((qp,), jnp.float32),
            jax.ShapeDtypeStruct((qp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="nn_1_pruned",
    )(q_bbox, t_bbox, thr, q_planes, t_planes)

    idx = jnp.clip(idx[:qn], 0, tn - 1)
    found = val[:qn] < jnp.float32(_BIG) / 2
    diff = query - target[idx]
    d2 = jnp.sum(diff * diff, axis=1)
    d2 = jnp.where(query_mask & target_mask[idx] & found, d2, jnp.inf)
    return idx, d2


def check_against_nn_1(target, ref, got, max_distance: float | None = None,
                       max_swap_frac: float = 0.001) -> int:
    """Assert that ``got`` = (idx, d2) from :func:`pallas_nn_1_pruned`
    agrees with ``ref`` = ``ops.knn.nn_1``'s (idx, d2) on the same clouds.

    Both pick winners on f32 scores with absolute error ~|t|²·2⁻²³, so a
    winner may swap between targets whose exact distances lie within the
    window ``8·max|t|²·2⁻²³``; elsewhere indices and (re-derived) distances
    must be identical, and swaps must stay rare.  With ``max_distance`` the
    comparison covers the queries that ``ref`` finds inside it; beyond it
    ``got`` must report +inf or a distance past the threshold.  Returns the
    number of winner swaps."""
    t = np.asarray(target, np.float64)
    i_ref, d_ref = (np.asarray(a) for a in ref)
    i_got, d_got = (np.asarray(a) for a in got)
    window = 8.0 * float(np.max(np.sum(t * t, axis=1))) * 2.0**-23
    sel = np.isfinite(d_ref)
    if max_distance is not None:
        thr = float(np.float32(max_distance) ** 2)
        beyond = sel & (d_ref > thr)
        assert np.all(~np.isfinite(d_got[beyond])
                      | (d_got[beyond] > thr - window)), "NN beyond the gate"
        sel &= ~beyond
    swap = sel & (i_got != i_ref)
    assert np.all(np.abs(d_got[swap] - d_ref[swap]) <= window), (
        "NN winner swap outside the score window"
    )
    assert swap.sum() <= max(1, int(max_swap_frac * sel.sum())), (
        f"NN: {int(swap.sum())} winner swaps, more than near-tie noise"
    )
    same = sel & ~swap
    assert np.array_equal(d_got[same], d_ref[same]), "NN distances differ"
    return int(swap.sum())
