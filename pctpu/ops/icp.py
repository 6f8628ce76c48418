"""Iterative closest point: fixed-shape lax.while_loop with masked
correspondences, PCL-compatible estimation and convergence semantics.

Reproduces pcl::IterativeClosestPoint / IterativeClosestPointWithNormals as
configured by the reference
(/root/reference/BatchTopPartRegistration.cpp:192-247):

  * correspondence: 1-NN of each (already transformed) source point in the
    target, rejected when squared distance > max_correspondence_distance²;
  * estimation: point-to-point = Umeyama SVD (TransformationEstimationSVD),
    point-to-plane = small-angle LLS on (α,β,γ,tx,ty,tz) with the solved
    angles plugged into an exact Rz(γ)Ry(β)Rx(α) (PCL
    TransformationEstimationPointToPlaneLLS::constructTransformationMatrix);
  * per-iteration update: incremental transform composed onto the running
    final transformation, which starts at the initial guess;
  * convergence (PCL DefaultConvergenceCriteria order): max iterations →
    converged; transform-delta (cos θ ≥ 1−ε_t and ‖t‖² ≤ ε_t) → converged;
    |MSE−MSE_prev| < 1e-12 (absolute) or /MSE_prev < ε_fitness (relative) →
    converged; < 3 correspondences → NOT converged;
  * fitness = mean squared 1-NN distance of all transformed source points
    (pcl::Registration::getFitnessScore with default max_range).

Design: the loop is a ``lax.while_loop`` over fixed-size padded arrays; the
NN search is the platform's choice (``pctpu.runtime.platform``): the
bbox-pruned Pallas kernel on a GPU, the blocked matmul from pctpu.ops.knn on
the CPU; the per-iteration solve is a 3×3 SVD / 6×6 inverse — all static
shapes, so one compilation serves every pair, and pairs can be vmapped (the
two yaw guesses of the coarse stage run as one batched program).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from pctpu.config import IcpConfig
from pctpu.ops.knn import nn_1
from pctpu.ops.pallas_knn import pallas_nn_1_pruned, spatial_sort_payload
from pctpu.ops.transform import transform_xyz
from pctpu.runtime.platform import platform_choice


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IcpResult:
    converged: jnp.ndarray  # bool
    fitness: jnp.ndarray  # float32 — mean squared NN distance
    transform: jnp.ndarray  # (4, 4) float32


def _estimate_svd(src, tgt, w):
    """Umeyama (no scale), weighted by w∈{0,1} — matches PCL
    TransformationEstimationSVD on the correspondence subset."""
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mu_s = jnp.sum(src * w[:, None], axis=0) / wsum
    mu_t = jnp.sum(tgt * w[:, None], axis=0) / wsum
    sd = (src - mu_s) * w[:, None]
    td = tgt - mu_t
    h = jnp.matmul(sd.T, td, precision=jax.lax.Precision.HIGHEST)  # (3,3)
    u, _, vt = jnp.linalg.svd(h)
    d = jnp.sign(jnp.linalg.det(vt.T @ u.T))
    s = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(d)
    r = (vt.T @ s) @ u.T
    t = mu_t - r @ mu_s
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(r.astype(jnp.float32))
    m = m.at[:3, 3].set(t.astype(jnp.float32))
    return m


def _estimate_point_to_plane_lls(src, tgt, nrm, w):
    """PCL TransformationEstimationPointToPlaneLLS: solve the linearized
    point-to-plane system, then build Rz(γ)Ry(β)Rx(α)."""
    a = jnp.cross(src, nrm)  # rows: s × n
    jac = jnp.concatenate([a, nrm], axis=1)  # (N, 6)
    jac = jac * w[:, None]
    b = jnp.sum(nrm * (tgt - src), axis=1) * w
    prec = jax.lax.Precision.HIGHEST
    ata = jnp.matmul(jac.T, jac, precision=prec)
    atb = jnp.matmul(jac.T, b, precision=prec)
    x = jnp.linalg.solve(ata + 1e-12 * jnp.eye(6), atb)
    alpha, beta, gamma, tx, ty, tz = x
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    cg, sg = jnp.cos(gamma), jnp.sin(gamma)
    m = jnp.array(
        [
            [cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca, tx],
            [sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca, ty],
            [-sb, cb * sa, cb * ca, tz],
            [0.0, 0.0, 0.0, 1.0],
        ],
        jnp.float32,
    )
    return m


def _apply(m, pts):
    # transform_xyz pins precision=HIGHEST itself, so this stays full-f32
    # even if a caller ever runs outside jax.default_matmul_precision
    return transform_xyz(pts, m)


def icp(
    src_xyz: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_xyz: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    guess: jnp.ndarray,
    cfg: IcpConfig,
    tgt_normals: jnp.ndarray | None = None,
    normal_mask: jnp.ndarray | None = None,
    nn_tile: int = 512,
    nn_impl: str = "auto",
    mesh=None,
) -> IcpResult:
    """Run one ICP alignment.  All arrays fixed-size with validity masks.

    For point-to-plane, ``tgt_normals`` are the target normals and
    ``normal_mask`` marks targets with defined normals (the reference's NaN
    normals are excluded from correspondences — documented divergence that
    avoids NaN-poisoning PCL exhibits on isolated points).

    ``nn_impl`` selects the correspondence search: "xla" (blocked matmul
    argmin), "pruned" (the bbox-pruned Pallas GPU kernel over spatially
    sorted clouds, exact), "sharded" (target cloud split over ``mesh``'s
    'points' axis, all_gather reduce — the §5.7 point-axis scaling path), or
    "auto" (the platform's choice, ``pctpu.runtime.platform``).

    All matrix products trace under full-f32 precision: the platform default
    (bf16-class) corrupts transforms by ~0.4% per iteration, which compounds
    into degrees of rotation error.
    """
    with jax.default_matmul_precision("highest"):
        return _icp_impl(
            src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
            tgt_normals, normal_mask, nn_tile, nn_impl=nn_impl, mesh=mesh,
        )


def _icp_impl(
    src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig,
    tgt_normals, normal_mask, nn_tile: int, with_trace: bool = False,
    nn_impl: str = "auto", mesh=None,
):
    if nn_impl == "auto":
        nn_impl = platform_choice().nn_impl
    max_d2 = jnp.float32(cfg.max_correspondence_distance) ** 2
    eps_t = jnp.float32(cfg.transformation_epsilon)
    rot_thresh = jnp.float32(1.0 - cfg.transformation_epsilon)
    rel_mse = jnp.float32(cfg.euclidean_fitness_epsilon)
    abs_mse = jnp.float32(1e-12)

    if nn_impl == "pruned":
        # spatial sort once: pruning needs tile locality; a rigid transform
        # preserves it, so the source order holds across iterations (bboxes
        # are recomputed from transformed positions every call)
        if tgt_normals is not None:
            if normal_mask is not None:
                tgt_xyz, tgt_mask, tgt_normals, nm_s = spatial_sort_payload(
                    tgt_xyz, tgt_mask, tgt_normals,
                    normal_mask.astype(jnp.int32),
                )
                normal_mask = nm_s.astype(bool)
            else:
                tgt_xyz, tgt_mask, tgt_normals = spatial_sort_payload(
                    tgt_xyz, tgt_mask, tgt_normals
                )
        else:
            tgt_xyz, tgt_mask = spatial_sort_payload(tgt_xyz, tgt_mask)
        src_xyz, src_mask = spatial_sort_payload(src_xyz, src_mask)

        def nn_corr(q, qm, tmask):
            return pallas_nn_1_pruned(
                q, qm, tgt_xyz, tmask,
                max_distance=cfg.max_correspondence_distance,
            )

        def nn_fit(q, qm, tmask):
            return pallas_nn_1_pruned(q, qm, tgt_xyz, tmask, max_distance=None)
    elif nn_impl == "sharded":
        # point-axis scaling (SURVEY.md §5.7): the target cloud is split over
        # the mesh's 'points' axis, each shard scans its slice, and the
        # global best reduces via one small all_gather.  Winner
        # choice is identical to the single-device argmin: the (shard, local
        # index) order IS the global index order, so ties break the same way.
        if mesh is None:
            raise ValueError("nn_impl='sharded' needs a mesh with a 'points' axis")
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def _local(q, qm, t, tm):
            idx, d2 = nn_1(q, qm, t, tm, tile=nn_tile)
            shard = jax.lax.axis_index("points")
            gidx = idx + shard * t.shape[0]
            all_d2 = jax.lax.all_gather(d2, "points")  # (n_shards, Q)
            all_idx = jax.lax.all_gather(gidx, "points")
            best = jnp.argmin(all_d2, axis=0)
            qi = jnp.arange(d2.shape[0])
            return all_idx[best, qi], all_d2[best, qi]

        _sharded_nn = shard_map(
            _local,
            mesh=mesh,
            in_specs=(P(), P(), P("points"), P("points")),
            out_specs=(P(), P()),
            check_vma=False,
        )

        def nn_corr(q, qm, tmask):
            return _sharded_nn(q, qm, tgt_xyz, tmask)

        nn_fit = nn_corr
    else:

        def nn_corr(q, qm, tmask):
            return nn_1(q, qm, tgt_xyz, tmask, tile=nn_tile)

        nn_fit = nn_corr

    corr_tgt_mask = tgt_mask
    if tgt_normals is not None and normal_mask is not None:
        corr_tgt_mask = tgt_mask & normal_mask

    def one_iteration(transformed):
        idx, d2 = nn_corr(transformed, src_mask, corr_tgt_mask)
        w = (src_mask & (d2 <= max_d2)).astype(jnp.float32)
        # sanitize rejected-correspondence gathers BEFORE the estimation:
        # unmatched queries carry idx 0 (the pruned kernel's convention), and
        # a NaN coordinate/normal there would poison the solve through
        # NaN * 0 = NaN even though w masks the row (identical results for
        # finite inputs — zeroed rows contribute exact zeros either way)
        keep = w[:, None] > 0
        tgt = jnp.where(keep, tgt_xyz[idx], 0.0)
        if cfg.point_to_plane:
            assert tgt_normals is not None
            nrm = jnp.where(keep, tgt_normals[idx], 0.0)
            inc = _estimate_point_to_plane_lls(transformed, tgt, nrm, w)
        else:
            inc = _estimate_svd(transformed, tgt, w)
        return inc, w, d2, idx

    # PCL's loop is a do-while: even max_iterations=0 performs one
    # correspondence+estimation pass and reports converged via the
    # iterations criterion, so at least one iteration always runs
    min_one = max(cfg.max_iterations, 1)

    def cond(state):
        it, done = state[0], state[4]
        return (~done) & (it < min_one)

    def body(state):
        it, final_t, transformed, prev_mse, done, conv = state
        inc, w, d2, idx = one_iteration(transformed)
        ncorr = jnp.sum(w)
        enough = ncorr >= 3.0
        inc = jnp.where(enough, inc, jnp.eye(4, dtype=jnp.float32))
        final_t = inc @ final_t
        # PCL transforms the WORKING cloud incrementally
        # (transformCloud(input_transformed, input_transformed,
        # transformation_)) — per-step f32 rounding, not compose-then-apply
        transformed = _apply(inc, transformed)
        it = it + 1

        # convergence checks in PCL order
        cos_angle = 0.5 * (inc[0, 0] + inc[1, 1] + inc[2, 2] - 1.0)
        trans_sqr = jnp.sum(inc[:3, 3] ** 2)
        delta_small = (cos_angle >= rot_thresh) & (trans_sqr <= eps_t)
        # where() not d2*w: the pruned NN returns +inf for out-of-threshold
        # queries, and inf * 0 would NaN-poison the MSE
        mse = jnp.sum(jnp.where(w > 0, d2, 0.0)) / jnp.maximum(ncorr, 1.0)
        mse_abs_ok = jnp.abs(mse - prev_mse) < abs_mse
        mse_rel_ok = jnp.abs(mse - prev_mse) / jnp.maximum(prev_mse, 1e-30) < rel_mse
        converged_now = delta_small | mse_abs_ok | mse_rel_ok
        hit_max = it >= cfg.max_iterations

        new_done = done | (~enough) | converged_now | hit_max
        # < 3 correspondences → hasConverged() false (PCL aborts the loop)
        new_conv = jnp.where(done, conv, enough & (converged_now | hit_max | conv))
        return it, final_t, transformed, mse, new_done, new_conv

    guess = jnp.asarray(guess, jnp.float32)
    init = (
        jnp.int32(0),
        guess,
        _apply(guess, src_xyz),
        jnp.float32(jnp.finfo(jnp.float32).max),
        jnp.bool_(False),
        jnp.bool_(False),
    )
    trace = None
    if with_trace:
        # fixed-length scan so every iteration's state can be recorded; the
        # body is gated on `done` to keep while_loop semantics exactly
        def scan_step(state, _):
            nxt = body(state)
            nxt = jax.tree.map(lambda a, b: jnp.where(state[4], a, b), state, nxt)
            it_, t_, mse_, done_, conv_ = nxt[0], nxt[1], nxt[3], nxt[4], nxt[5]
            return nxt, {"transform": t_, "mse": mse_, "done": done_,
                         "converged": conv_, "it": it_}

        final_state, trace = jax.lax.scan(
            scan_step, init, None, length=max(cfg.max_iterations, 1)
        )
    else:
        final_state = jax.lax.while_loop(cond, body, init)
    it, final_t, conv = final_state[0], final_state[1], final_state[5]
    # (a <3-correspondence abort keeps conv False even on the last iteration,
    # matching PCL's converged_=false break)

    # fitness: mean squared NN distance over all source points (default
    # max_range → every point counts), against the plain target mask
    transformed = _apply(final_t, src_xyz)
    _, d2 = nn_fit(transformed, src_mask, tgt_mask)
    nsrc_raw = jnp.sum(src_mask.astype(jnp.float32))
    fitness = jnp.where(
        nsrc_raw > 0,
        jnp.sum(jnp.where(src_mask, d2, 0.0)) / jnp.maximum(nsrc_raw, 1.0),
        # getFitnessScore returns numeric_limits<double>::max() for no
        # accepted points — f32 max here (both clear the 1.5 failure gate)
        jnp.float32(jnp.finfo(jnp.float32).max),
    )
    result = IcpResult(converged=conv, fitness=fitness, transform=final_t)
    return (result, trace) if with_trace else result


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "nn_tile", "nn_impl", "mesh"),
)
def icp_point_to_point(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig,
                       nn_tile: int = 512, nn_impl: str = "auto",
                       mesh=None) -> IcpResult:
    return icp(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg, nn_tile=nn_tile,
               nn_impl=nn_impl, mesh=mesh)


@functools.partial(
    jax.jit, static_argnames=("cfg", "nn_tile", "nn_impl")
)
def icp_trace(
    src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig,
    tgt_normals=None, normal_mask=None, nn_tile: int = 512,
    nn_impl: str = "auto",
):
    """Debug/differential-test variant: like ``icp`` but also returns the
    per-iteration state trace (transform, MSE, done/converged flags) from a
    fixed-length scan.  Used to assert PCL-semantics agreement against the
    plain-loop oracle in tests/ref_impl.py."""
    with jax.default_matmul_precision("highest"):
        return _icp_impl(
            src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
            tgt_normals, normal_mask, nn_tile, with_trace=True, nn_impl=nn_impl,
        )


@functools.partial(jax.jit, static_argnames=("cfg", "nn_tile", "nn_impl"))
def icp_point_to_plane(
    src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals, normal_mask, guess,
    cfg: IcpConfig, nn_tile: int = 512, nn_impl: str = "auto",
) -> IcpResult:
    return icp(
        src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
        tgt_normals=tgt_normals, normal_mask=normal_mask, nn_tile=nn_tile,
        nn_impl=nn_impl,
    )
