"""In-order segment sums: each segment's values folded one by one in point
order, so the f32 rounding sequence is that of a sequential loop.

The bit-exact ground-sector averages (the reference's BatchMultiBevGen.cpp:
187-210 accumulate z in point order) and the voxel centroids (stable input
order within a voxel, README D5/D14) both need it.  A scatter-add gives it
on the CPU backend, which applies updates in order; XLA:GPU lowers a float
scatter-add with repeated indices to atomics in no fixed order, so on a GPU
the sums would drift at the ulp level and differ from run to run.  There the
fold is a Pallas kernel (Triton route): one lane per segment walks its run
of the segment-sorted values sequentially.  Which form runs is decided by
``pctpu.runtime.platform``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pctpu.runtime.platform import platform_choice

_LANES = 128  # segments per program: one per thread at num_warps=4


def _fold_kernel(start_ref, end_ref, vals_ref, out_ref):
    """Lane s folds vals[:, start[s]:end[s]] in order into out[:, s]."""
    lanes = pl.ds(pl.program_id(0) * _LANES, _LANES)
    start = start_ref[lanes]
    end = end_ref[lanes]
    n_ch = vals_ref.shape[0]

    def body(k, accs):
        pos = start + k
        live = pos < end
        safe = jnp.where(live, pos, 0)
        # where(), not acc + 0: a dead lane must keep its value bit-for-bit
        return tuple(
            jnp.where(
                live,
                acc + plgpu.load(vals_ref.at[c, safe], mask=live, other=0.0),
                acc,
            )
            for c, acc in enumerate(accs)
        )

    zero = jnp.zeros((_LANES,), jnp.float32)
    accs = jax.lax.fori_loop(
        0, jnp.max(end - start), body, tuple(zero for _ in range(n_ch))
    )
    for c, acc in enumerate(accs):
        out_ref[c, lanes] = acc


@functools.partial(jax.jit, static_argnames=("num_segments", "interpret"))
def _fold_pallas(values, ids, num_segments: int, interpret: bool = False):
    counts = jnp.zeros((num_segments + 1,), jnp.int32).at[ids].add(1)
    counts = counts[:num_segments]  # integer adds: exact in any order
    ends = jnp.cumsum(counts)
    starts = ends - counts
    sp = -(-num_segments // _LANES) * _LANES
    starts = jnp.pad(starts, (0, sp - num_segments))
    ends = jnp.pad(ends, (0, sp - num_segments))
    out = pl.pallas_call(
        _fold_kernel,
        grid=(sp // _LANES,),
        out_shape=jax.ShapeDtypeStruct((values.shape[1], sp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ordered_segment_fold",
    )(starts, ends, values.T)
    return out[:, :num_segments].T


def ordered_segment_sum(
    values: jnp.ndarray,
    ids: jnp.ndarray,
    num_segments: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Per-segment sums of ``values`` (P, C) f32, each folded from 0.0 in
    point order: ``out[s] = (((0 + v_a) + v_b) + …)`` over the points with
    ``ids == s`` in index order.  ``ids`` (P,) int32 must be ascending (the
    points stably sorted by segment), with values in ``[0, num_segments]``;
    ``num_segments`` marks a skipped point.  Returns (num_segments, C) f32.

    ``interpret=True`` runs the GPU kernel in the Pallas interpreter (tests
    only)."""
    if interpret or platform_choice().ordered_sum == "kernel":
        return _fold_pallas(values, ids, num_segments, interpret=interpret)
    acc = jnp.zeros((num_segments + 1, values.shape[1]), jnp.float32)
    return acc.at[ids].add(values)[:num_segments]
