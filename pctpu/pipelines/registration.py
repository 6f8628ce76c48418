"""Two-stage top-part registration + whole-cloud ablation drivers.

References: batch_top_part_registration
(/root/reference/BatchTopPartRegistration.cpp:311-541), top_part_registration
(/root/reference/TopPartRegistration.cpp:256-455, minus the viewer), and
batch_whole_registration (/root/reference/BatchWholeRegistration.cpp:311-418).

Design: per pair, top-part extraction + voxel + normals run as one jitted
program; the two coarse yaw guesses {θ, θ+180°} run as a single vmapped ICP
(the reference runs them sequentially, :439-457); the fine stage is one more
jitted ICP on the voxel-downsampled full clouds.  Fixed capacities make every
pair reuse the same compiled programs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from pctpu.cloud import Cloud
from pctpu.config import RegistrationConfig
from pctpu.geom.se3 import eigen_inverse3_f32, matmul3_f32, yaw_rotation_4x4
from pctpu.io.pcd import load_cloud_pcd
from pctpu.io.poses import _ostream_float  # C++ ostream<<float emulation
from pctpu.ops.icp import icp_point_to_plane, icp_point_to_point
from pctpu.ops.normals2d import normals_2d
from pctpu.ops.topflatten import extract_top_and_flatten
from pctpu.ops.voxel import voxel_downsample
from pctpu.runtime.platform import platform_choice
from pctpu.runtime.profiler import StageTimer
from pctpu.utils import logging as log


@dataclasses.dataclass
class MatchResult:
    """One row of match_result.txt
    (/root/reference/BatchTopPartRegistration.cpp:250-272)."""

    query_idx: int
    match_idx: int
    angle_guess: float


def load_match_results(path: str) -> list[MatchResult]:
    """Parse match_result.txt (``query_idx match_idx yaw_guess`` per row,
    /root/reference/BatchTopPartRegistration.cpp:250-272).

    Documented divergence: the reference's unchecked ``ss >>`` extraction
    pushes an *uninitialized* MatchResult for empty or short rows (UB,
    unreproducible); pctpu skips empty lines and raises on short ones."""
    matches = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            tok = line.split()
            if not tok:
                continue
            if len(tok) < 3:
                raise ValueError(
                    f"malformed match_result line {lineno}: {line.strip()!r} "
                    "(want 'query_idx match_idx yaw_guess')"
                )
            # the reference parses the guess into a C float (``ss >> match.
            # angle_guess``, :265-266) — keep the f32-rounded value so the
            # guess-angle chain sees identical inputs
            matches.append(
                MatchResult(int(tok[0]), int(tok[1]), float(np.float32(tok[2])))
            )
    return matches


@dataclasses.dataclass
class PairReport:
    query_idx: int
    match_idx: int
    success: bool
    fitness_coarse: float
    fitness_fine: float
    diff_xy: float
    diff_yaw: float
    transform_fine: np.ndarray


@functools.partial(jax.jit, static_argnames=("leaf",))
def _voxel_full(cloud: Cloud, leaf: float):
    return voxel_downsample(cloud.xyz, cloud.valid_mask(), leaf)


def _coarse_two_guesses(src, src_mask, tgt, tgt_mask, tgt_normals, normal_ok,
                        guesses, cfg: RegistrationConfig):
    """Both yaw guesses as one vmapped point-to-plane ICP
    (guess and guess+180°, /root/reference/BatchTopPartRegistration.cpp:416-425)."""

    def run(guess):
        return icp_point_to_plane(
            src, src_mask, tgt, tgt_mask, tgt_normals, normal_ok, guess, cfg.coarse
        )

    return jax.vmap(run)(guesses)


def _guess_angle_rad(angle_guess_deg: float, offset_deg: float = 0.0) -> float:
    """The reference's exact mixed f32/f64 guess-angle chain
    (/root/reference/BatchTopPartRegistration.cpp:416-420,
    BatchWholeRegistration.cpp:374): ``angle_guess`` is a C float
    (``ss >>``), ``(angle + 180.0f) / 180.0f`` evaluates in f32, and only
    the ``* M_PI`` promotes to double (AngleAxisd).  A pure-double chain
    differs by ~1e-6 deg for non-f32-exact guesses — enough to flip an ICP
    convergence knife-edge vs the C++ binary."""
    a = np.float32(angle_guess_deg)
    if offset_deg:
        a = np.float32(a + np.float32(offset_deg))
    return float(np.float32(a / np.float32(180.0))) * math.pi


def _guess_pair_np(angle_guess_deg: float) -> np.ndarray:
    g1 = yaw_rotation_4x4(_guess_angle_rad(angle_guess_deg)).astype(np.float32)
    g2 = yaw_rotation_4x4(
        _guess_angle_rad(angle_guess_deg, 180.0)
    ).astype(np.float32)
    return np.stack([g1, g2])


def _guess_pair(angle_guess_deg: float) -> jnp.ndarray:
    return jnp.asarray(_guess_pair_np(angle_guess_deg))


@jax.jit
def _stack_pairs(cs: list):
    """Stack a list of same-shape Clouds into one batched Cloud in ONE device
    dispatch (the naive ``jax.tree.map(jnp.stack, *cs)`` issues one dispatch
    per field per cloud, ~46 for a 16-pair batch)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cs)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _over_pairs(stage, mesh, static: tuple, *args):
    """``stage(*args, **dict(static))`` mapped over the leading pair axis.

    With a mesh, each device maps its own slice of the pairs (shard_map over
    'data'): the Pallas kernels inside the stages then run on device-local
    pairs, where the partitioner would otherwise replicate a custom call's
    operands and repeat the whole batch on every device."""
    fn = jax.vmap(functools.partial(stage, **dict(static)))
    if mesh is not None:
        from jax.sharding import PartitionSpec

        fn = jax.shard_map(
            fn, mesh=mesh, in_specs=PartitionSpec("data"),
            out_specs=PartitionSpec("data"), check_vma=False,
        )
    return fn(*args)


# --- adaptive capacity buckets ---------------------------------------------
#
# All stage programs take fixed shapes, but the flat (top-part) clouds are
# usually far smaller than their worst-case capacity, and NN/normals cost is
# quadratic in the padded size.  Each stage therefore reports its compacted
# point counts to the host, and the next stage is compiled for the smallest
# bucket that fits — identical results (padding was masked anyway), a handful
# of cached compilations, and order-of-magnitude less device work.

_BUCKET_FLOOR = 1024


def _warn_flat_cap(nkept_raw: int, flat_cap: int) -> None:
    """Warn when the fixed flat-cloud capacity dropped kept top-part points
    (the reference has no cap; raise --flat_cap to restore full parity)."""
    if nkept_raw > flat_cap:
        log.red(
            f"WARNING: top-part extraction kept {nkept_raw} points but "
            f"flat_cap={flat_cap} truncated them; coarse ICP runs on a "
            "partial flat cloud — raise --flat_cap for full parity"
        )


def _pow2_bucket(n: int, cap: int) -> int:
    b = _BUCKET_FLOOR
    while b < n:
        b *= 2
    return min(b, cap)


def _fine_bucket(n: int, cap: int, step: int = 8192) -> int:
    return min(-(-max(n, 1) // step) * step, cap)


@functools.partial(jax.jit, static_argnames=("flat_cap", "leaf"))
def _stage_flat(cloud_1: Cloud, cloud_2: Cloud, flat_cap: int, leaf: float):
    """Top-part extraction + 0.2 m voxel of the flat clouds (reference 1st
    stage prep, BatchTopPartRegistration.cpp:397-409), both clouds in one
    dispatch.  Returns compacted arrays, their counts, and a checksum that —
    once fetched — proves the dispatch fully executed (honest stage timing)."""

    def one(c):
        fx, fm, nkept = extract_top_and_flatten(c)
        return voxel_downsample(fx[:flat_cap], fm[:flat_cap], leaf), nkept

    s, nk1 = one(cloud_1)
    t, nk2 = one(cloud_2)
    chk = jnp.sum(s[0]) + jnp.sum(t[0])
    # max raw top-part count: > flat_cap means the [:flat_cap] slice dropped
    # kept points (the reference has no cap — callers warn)
    return s, t, chk, jnp.maximum(nk1, nk2)


@functools.partial(jax.jit, static_argnames=("cfg", "bucket"))
def _stage_coarse(
    s_xyz, s_mask, t_xyz, t_mask, guesses, cfg: RegistrationConfig, bucket: int
):
    """Normals + the two coarse point-to-plane ICPs + best-of-two, at bucket
    size.  The reference computes source normals as well
    (BatchTopPartRegistration.cpp:428) but PointToPlaneLLS only consumes the
    target's, so only those are built."""
    s_xyz, s_mask = s_xyz[:bucket], s_mask[:bucket]
    t_xyz, t_mask = t_xyz[:bucket], t_mask[:bucket]
    t_nrm, _, n_ok = normals_2d(t_xyz, t_mask, radius=cfg.normal_radius)
    res = _coarse_two_guesses(s_xyz, s_mask, t_xyz, t_mask, t_nrm, n_ok, guesses, cfg)
    # tie picks the second guess, like the C++ ternary (:464).  A NaN
    # fitness ranks WORST (+inf): the f32 stack's bad-guess trajectory can
    # blow up to NaN on chaotic scenes where the f64 oracle/PCL stays
    # finite (round-5 fuzz find, seed 1200196 — guess 0 converged at
    # fitness 0.149 while guess 1 NaN'd, and the raw `<` comparison picked
    # the NaN side, discarding the correct result).  Mapping NaN to +inf
    # restores the reference's pick-the-lower-fitness intent in the only
    # case where the stacks' numeric domains differ.
    fit = jnp.where(jnp.isnan(res.fitness), jnp.inf, res.fitness)
    best_i = jnp.where(fit[0] < fit[1], 0, 1)
    return jax.tree.map(lambda a: a[best_i], res)


@functools.partial(jax.jit, static_argnames=("leaf",))
def _stage_voxel_full(cloud_1: Cloud, cloud_2: Cloud, leaf: float):
    """Full-cloud voxel downsample (reference 2nd-stage prep, :483-487)."""
    a = voxel_downsample(cloud_1.xyz, cloud_1.valid_mask(), leaf)
    b = voxel_downsample(cloud_2.xyz, cloud_2.valid_mask(), leaf)
    chk = jnp.sum(a[0]) + jnp.sum(b[0])
    return a, b, chk


@functools.partial(jax.jit, static_argnames=("cfg", "bucket", "nn_impl", "mesh"))
def _stage_fine(s_xyz, s_mask, t_xyz, t_mask, guess, cfg: RegistrationConfig,
                bucket: int, nn_impl: str = "auto", mesh=None):
    return icp_point_to_point(
        s_xyz[:bucket], s_mask[:bucket], t_xyz[:bucket], t_mask[:bucket],
        guess, cfg.fine, nn_impl=nn_impl, mesh=mesh,
    )


def register_pairs(
    pairs: list[tuple[Cloud, Cloud, float]],
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
    mesh: "jax.sharding.Mesh | None" = None,
):
    """Batch several (cloud_1, cloud_2, yaw_guess_deg) pairs: each stage runs
    as one vmapped dispatch over the pair axis, with capacity buckets chosen
    from the batch maxima.  Returns a list of (best coarse, fine) numpy
    IcpResults in input order.  All clouds must share one capacity.

    With ``mesh``, the pair axis is sharded over the mesh's 'data' axis
    (len(pairs) must be a multiple of it) — pure data parallelism.  GSPMD
    may compile different f32 reduction trees per shard, so mesh results
    match the unsharded run at the ulp level (~1e-6..1e-4 in transform
    entries, tests/test_sharding.py), not bitwise; near an ICP convergence
    knife-edge the exit iteration can differ (docs/PARITY.md "capacity
    padding vs f32 reduction shape" — same mechanism), always within the
    north-star window."""
    timer = timer or StageTimer()
    c1, c2, best = _coarse_stage_batched(pairs, cfg, flat_cap, timer, mesh)
    return _pair_results(len(pairs), c1, c2, best, cfg, timer, mesh=mesh)


def _pair_results(n, c1, c2, best_dev, cfg, timer, spec=None, mesh=None):
    """Coarse winners (still ON DEVICE) → per-pair (best coarse,
    fine-or-None) numpy tuples — the optional-refinement tail shared by
    ``register_pairs`` and the pipelined stream's fine half.

    The fine stage seeds directly from the device-resident coarse
    transforms, so it dispatches WITHOUT waiting for the coarse result
    fetch; that roundtrip then resolves while the fine ICP computes.
    Identical values either way — the seed is the same array, not a numpy
    round-trip."""
    fine_dev = (
        _fine_dispatch(c1, c2, best_dev.transform, cfg, timer, spec=spec,
                       mesh=mesh)
        if cfg.use_refinement
        else None
    )
    return _fetch_pair_results(n, best_dev, fine_dev, timer)


def _fetch_pair_results(n, best_dev, fine_dev, timer):
    """Block on the device chain and assemble per-pair numpy tuples.  The
    fine fetch (the long pole — it resolves only after every enqueued
    program ran) extends the fine [TIME] total; the coarse fetch after it is
    ~free (its value completed long before).  items=0: fetch spans extend
    stage totals without double-counting pairs in the per-pair averages."""
    fine = None
    if fine_dev is not None:
        with timer.stage("fine", items=0):
            fine = jax.tree.map(np.asarray, jax.device_get(fine_dev))
    with timer.stage("coarse", items=0):
        best = jax.tree.map(np.asarray, jax.device_get(best_dev))
    if fine is None:
        return [(jax.tree.map(lambda a: a[i], best), None) for i in range(n)]
    return [
        (jax.tree.map(lambda x: x[i], best), jax.tree.map(lambda x: x[i], fine))
        for i in range(n)
    ]


def _shard_pair_batch(mesh, n, c1, c2, guesses):
    """Constrain a stacked pair batch to the mesh's 'data' axis (pure data
    parallelism over pairs).  ``n`` must divide evenly — GSPMD would
    otherwise silently replicate the ragged remainder."""
    from jax.sharding import NamedSharding, PartitionSpec

    if n % mesh.shape["data"]:
        raise ValueError(
            f"len(pairs)={n} must be a multiple of the mesh data axis "
            f"({mesh.shape['data']})"
        )
    sharding = NamedSharding(mesh, PartitionSpec("data"))
    c1 = jax.tree.map(lambda x: jax.device_put(x, sharding), c1)
    c2 = jax.tree.map(lambda x: jax.device_put(x, sharding), c2)
    return c1, c2, jax.device_put(guesses, sharding)


class BucketSpec:
    """Cross-batch capacity-bucket predictor for speculative dispatch.

    The bucket for each stage depends on on-device counts (post-voxel point
    counts), so picking it requires a host↔device stat roundtrip during
    which the device sits idle before the dependent stage can even be
    enqueued.  Scene statistics are stable
    across consecutive batches, so the previous batch's bucket almost always
    predicts the next one: with a prediction the stage is dispatched
    IMMEDIATELY at the predicted bucket (device stays busy), the stats fetch
    resolves in parallel, and only a mispredict pays a second dispatch at
    the correct bucket.  Results are bit-identical to the non-speculative
    path in all cases — speculative results are kept only when the
    predicted bucket EQUALS the one the stats dictate (a merely-sufficient
    larger bucket would change f32 reduction shapes, docs/PARITY.md
    "capacity padding vs f32 reduction shape")."""

    __slots__ = ("coarse", "fine", "hits", "misses")

    def __init__(self):
        self.coarse: int | None = None
        self.fine: int | None = None
        self.hits = 0
        self.misses = 0

    def record(self, predicted: int | None, actual: int) -> bool:
        """True when the speculative dispatch can be kept."""
        if predicted == actual:
            self.hits += 1
            return True
        if predicted is not None:
            self.misses += 1
        return False


def _coarse_stage_batched(pairs, cfg, flat_cap, timer, mesh, spec=None):
    """Stack + flat prep + both coarse ICPs for one pair batch (the
    reference's 1st-stage span).  Returns (c1, c2, best) with the coarse
    winners still ON DEVICE (fetched later, overlapped with the fine stage).

    With ``spec`` (a :class:`BucketSpec`), the coarse ICP is dispatched
    speculatively at the previous batch's bucket before the stat fetch
    resolves; see BucketSpec for the exactness argument."""
    c1 = _stack_pairs([p[0] for p in pairs])
    c2 = _stack_pairs([p[1] for p in pairs])
    guesses = jnp.asarray(np.stack([_guess_pair_np(p[2]) for p in pairs]))
    n = len(pairs)
    if mesh is not None:
        c1, c2, guesses = _shard_pair_batch(mesh, n, c1, c2, guesses)

    with timer.stage("coarse", items=n):
        s, t, chk, nk_raw = _over_pairs(
            _stage_flat, mesh,
            (("flat_cap", flat_cap), ("leaf", cfg.voxel_leaf)), c1, c2,
        )
        # one fetch per stage boundary: [max src count, max tgt count, chk,
        # max raw top-part count]
        stats_dev = jnp.stack([
            jnp.max(s[2]).astype(jnp.float32),
            jnp.max(t[2]).astype(jnp.float32),
            jnp.sum(chk),
            jnp.max(nk_raw).astype(jnp.float32),
        ])

        def run_coarse(bucket):
            return _over_pairs(
                _stage_coarse, mesh, (("cfg", cfg), ("bucket", bucket)),
                s[0], s[1], t[0], t[1], guesses,
            )

        predicted = spec.coarse if spec is not None else None
        best = run_coarse(predicted) if predicted is not None else None
        stats = np.asarray(stats_dev)
        _warn_flat_cap(int(stats[3]), flat_cap)
        bucket = _pow2_bucket(int(max(stats[0], stats[1])), flat_cap)
        if spec is not None:
            spec.coarse = bucket
        if spec is None or not spec.record(predicted, bucket):
            best = run_coarse(bucket)
        # NO fetch here: the winners stay on device so the fine stage can
        # seed and dispatch immediately; _pair_results fetches them while
        # the fine ICP computes (timer segment stays labeled "coarse")
    return c1, c2, best


def _fine_dispatch(c1, c2, guesses, cfg, timer, spec=None, mesh=None):
    """Vmapped full-cloud voxel + stats fetch + bucketed fine ICP DISPATCH
    (no result fetch) — shared by the top-part fine stage (guesses =
    device-resident coarse transforms) and the whole-cloud ablation
    (guesses = raw yaw rotations).  ``spec`` enables speculative dispatch at
    the previous batch's fine bucket (BucketSpec).  Returns the fine
    IcpResult batch still on device: in the pipelined stream this whole
    function runs on the worker thread, so its stat roundtrip and dispatch
    work hide under the PREVIOUS batch's fine device compute, and the main
    thread's only job is blocking on results."""
    n = int(guesses.shape[0])
    with timer.stage("fine", items=n):
        a, b, chk2 = _over_pairs(
            _stage_voxel_full, mesh, (("leaf", cfg.voxel_leaf),), c1, c2
        )
        stats2_dev = jnp.stack([
            jnp.max(a[2]).astype(jnp.float32),
            jnp.max(b[2]).astype(jnp.float32),
            jnp.sum(chk2),
        ])

        def run_fine(fbucket):
            return _over_pairs(
                _stage_fine, mesh, (("cfg", cfg), ("bucket", fbucket)),
                a[0], a[1], b[0], b[1], guesses,
            )

        predicted = spec.fine if spec is not None else None
        fine = run_fine(predicted) if predicted is not None else None
        stats2 = np.asarray(stats2_dev)
        fbucket = _fine_bucket(int(max(stats2[0], stats2[1])), c1.capacity)
        if spec is not None:
            spec.fine = fbucket
        if spec is None or not spec.record(predicted, fbucket):
            fine = run_fine(fbucket)
    return fine


def _dispatch_batch_speculative(pairs, cfg, flat_cap, timer, mesh,
                                spec: BucketSpec):
    """Enqueue one batch's ENTIRE device chain — flat, coarse, voxel, fine —
    back-to-back at the previous batch's capacity buckets, then resolve the
    stat fetches to verify them.  The verified path (_coarse_stage_batched +
    _fine_dispatch) blocks on the flat-stats fetch BEFORE enqueueing
    voxel + fine; when that roundtrip resolves later than the device
    finishes the coarse program, the device queue drains mid-batch.
    Enqueueing the full chain first keeps the queue nonempty across the
    whole batch span.  Bit-identical to the verified path: a speculative
    result is kept only when the predicted bucket EQUALS the stat-dictated
    one (BucketSpec) — a mispredicted stage, and every stage downstream of
    it (the fine guesses are the coarse winners), is re-dispatched at the
    verified bucket.  Cold starts (no recorded buckets) use the verified
    path, which populates the spec."""
    if spec.coarse is None or spec.fine is None or not cfg.use_refinement:
        c1, c2, best = _coarse_stage_batched(
            pairs, cfg, flat_cap, timer, mesh, spec=spec
        )
        fine = (
            _fine_dispatch(c1, c2, best.transform, cfg, timer, spec=spec,
                           mesh=mesh)
            if cfg.use_refinement
            else None
        )
        return len(pairs), best, fine

    t0 = time.perf_counter()
    c1 = _stack_pairs([p[0] for p in pairs])
    c2 = _stack_pairs([p[1] for p in pairs])
    guesses = jnp.asarray(np.stack([_guess_pair_np(p[2]) for p in pairs]))
    n = len(pairs)
    if mesh is not None:
        c1, c2, guesses = _shard_pair_batch(mesh, n, c1, c2, guesses)

    s, t, chk, nk_raw = _over_pairs(
        _stage_flat, mesh,
        (("flat_cap", flat_cap), ("leaf", cfg.voxel_leaf)), c1, c2,
    )
    stats_dev = jnp.stack([
        jnp.max(s[2]).astype(jnp.float32),
        jnp.max(t[2]).astype(jnp.float32),
        jnp.sum(chk),
        jnp.max(nk_raw).astype(jnp.float32),
    ])

    def run_coarse(bucket):
        return _over_pairs(
            _stage_coarse, mesh, (("cfg", cfg), ("bucket", bucket)),
            s[0], s[1], t[0], t[1], guesses,
        )

    pc = spec.coarse
    best = run_coarse(pc)
    t1 = time.perf_counter()

    a, b, chk2 = _over_pairs(
        _stage_voxel_full, mesh, (("leaf", cfg.voxel_leaf),), c1, c2
    )
    stats2_dev = jnp.stack([
        jnp.max(a[2]).astype(jnp.float32),
        jnp.max(b[2]).astype(jnp.float32),
        jnp.sum(chk2),
    ])

    def run_fine(fbucket, g):
        return _over_pairs(
            _stage_fine, mesh, (("cfg", cfg), ("bucket", fbucket)),
            a[0], a[1], b[0], b[1], g,
        )

    pf = spec.fine
    fine = run_fine(pf, best.transform)
    t2 = time.perf_counter()

    # --- verification (the whole chain is already enqueued) ---------------
    stats = np.asarray(stats_dev)
    _warn_flat_cap(int(stats[3]), flat_cap)
    bucket = _pow2_bucket(int(max(stats[0], stats[1])), flat_cap)
    spec.coarse = bucket
    coarse_ok = spec.record(pc, bucket)
    if not coarse_ok:
        best = run_coarse(bucket)
    t3 = time.perf_counter()
    stats2 = np.asarray(stats2_dev)
    fbucket = _fine_bucket(int(max(stats2[0], stats2[1])), c1.capacity)
    spec.fine = fbucket
    fine_ok = spec.record(pf, fbucket)
    if not (fine_ok and coarse_ok):
        # a coarse mispredict invalidates the speculative fine too: its
        # guesses were the mispredicted coarse winners
        fine = run_fine(fbucket, best.transform)
    t4 = time.perf_counter()
    timer.add("coarse", ((t1 - t0) + (t3 - t2)) * 1e3, items=n)
    timer.add("fine", ((t2 - t1) + (t4 - t3)) * 1e3, items=n)
    return n, best, fine


def register_pairs_pipelined(
    batch_loaders,
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
    mesh: "jax.sharding.Mesh | None" = None,
    depth: int = 1,
):
    """Software-pipelined batch registration over a STREAM of pair batches.

    ``batch_loaders`` yields thunks; each returns one ``register_pairs``-style
    pair list.  Batch k+1's ENTIRE dispatch chain — load + stack +
    flat/coarse + voxel + fine, including every host↔device stat
    roundtrip — runs on a worker thread while the main thread merely blocks
    on batch k's device results: all host work and dispatch latency hide
    under the previous batch's device compute, so the steady-state rate
    approaches the pure device-compute floor (the reference's per-pair loop
    /root/reference/BatchTopPartRegistration.cpp:356-532 is fully serial).
    Each stage additionally dispatches speculatively at the previous batch's
    capacity bucket (:class:`BucketSpec`) so the device isn't left idle
    during the bucket-stat roundtrip; a mispredict re-dispatches at the
    correct bucket.  Per-batch results are identical to ``register_pairs``
    (same programs, same buckets — only the wall-clock interleaving
    changes).

    ``depth`` is how many batches may have their full dispatch chain in
    flight beyond the one being fetched (device-queue depth).  ``depth=1``
    is classic one-deep pipelining; deeper keeps the device queue nonempty
    across a result-fetch stall at ~``depth`` extra batches of device
    memory.  Results are identical at any depth — only wall-clock
    interleaving changes.

    Yields one result list per batch, in order.
    """
    import collections
    import concurrent.futures

    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    timer = timer or StageTimer()
    # One BucketSpec across the stream: each stage speculatively dispatches
    # at the previous batch's bucket so the device never idles waiting on
    # the bucket-stat roundtrip (all dispatch halves run on the worker
    # thread — single writer for both fields).
    spec = BucketSpec()

    def dispatch_half(loader):
        return _dispatch_batch_speculative(
            loader(), cfg, flat_cap, timer, mesh, spec
        )

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        futs = collections.deque()
        for loader in batch_loaders:
            futs.append(ex.submit(dispatch_half, loader))
            if len(futs) > depth:
                n, best, fine_dev = futs.popleft().result()
                yield _fetch_pair_results(n, best, fine_dev, timer)
        while futs:
            n, best, fine_dev = futs.popleft().result()
            yield _fetch_pair_results(n, best, fine_dev, timer)


def register_whole_pairs(
    pairs: list[tuple[Cloud, Cloud, float]],
    cfg: RegistrationConfig,
    timer: StageTimer | None = None,
    mesh: "jax.sharding.Mesh | None" = None,
):
    """Batch several whole-cloud ablation pairs (voxel + direct fine ICP from
    the yaw guess, /root/reference/BatchWholeRegistration.cpp:342-412): both
    stages run as one vmapped dispatch over the pair axis, mirroring
    ``register_pairs`` minus the flatten/normals/coarse stage.  With ``mesh``
    the pair axis is sharded over the mesh's 'data' axis."""
    timer = timer or StageTimer()
    c1 = _stack_pairs([p[0] for p in pairs])
    c2 = _stack_pairs([p[1] for p in pairs])
    guesses = jnp.asarray(
        np.stack([
            yaw_rotation_4x4(_guess_angle_rad(p[2])).astype(np.float32)
            for p in pairs
        ])
    )
    n = len(pairs)
    if mesh is not None:
        c1, c2, guesses = _shard_pair_batch(mesh, n, c1, c2, guesses)

    fine_dev = _fine_dispatch(c1, c2, guesses, cfg, timer, mesh=mesh)
    with timer.stage("fine", items=0):
        fine = jax.tree.map(np.asarray, jax.device_get(fine_dev))
    return [jax.tree.map(lambda x: x[i], fine) for i in range(n)]


def register_pair(
    cloud_1: Cloud,
    cloud_2: Cloud,
    angle_guess_deg: float,
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
    point_mesh: "jax.sharding.Mesh | None" = None,
) -> tuple[object, object]:
    """Returns (best coarse IcpResult, fine IcpResult or None).

    ``point_mesh`` (a mesh with a 'points' axis) shards the fine-stage
    correspondence search over the target's point axis — SURVEY.md §5.7's
    long-axis scaling, for clouds too big for one chip's NN pass.

    Stage timing matches the reference's split exactly
    (BatchTopPartRegistration.cpp:471-506): "coarse" covers flat prep +
    normals + both coarse ICPs, "fine" covers the full-cloud voxel + fine
    ICP; each stage is forced to the host before its timer stops, so the
    reported numbers are measured, not apportioned."""
    timer = timer or StageTimer()
    guesses = _guess_pair(angle_guess_deg)

    with timer.stage("coarse"):
        s, t, chk, nk_raw = _stage_flat(cloud_1, cloud_2, flat_cap, cfg.voxel_leaf)
        stats = np.asarray(
            jnp.stack([s[2].astype(jnp.float32), t[2].astype(jnp.float32), chk,
                       nk_raw.astype(jnp.float32)])
        )
        _warn_flat_cap(int(stats[3]), flat_cap)
        bucket = _pow2_bucket(int(max(stats[0], stats[1])), flat_cap)
        best = _stage_coarse(s[0], s[1], t[0], t[1], guesses, cfg, bucket)
        best = jax.tree.map(np.asarray, jax.device_get(best))

    if not cfg.use_refinement:
        return best, None

    with timer.stage("fine"):
        a, b, chk2 = _stage_voxel_full(cloud_1, cloud_2, cfg.voxel_leaf)
        stats2 = np.asarray(
            jnp.stack([a[2].astype(jnp.float32), b[2].astype(jnp.float32), chk2])
        )
        fbucket = _fine_bucket(int(max(stats2[0], stats2[1])), cloud_1.capacity)
        if point_mesh is not None:
            n_pts = point_mesh.shape["points"]
            if cloud_1.capacity % n_pts:
                raise ValueError(
                    f"point_mesh needs cloud capacity ({cloud_1.capacity}) to "
                    f"be a multiple of the 'points' axis ({n_pts})"
                )
            fbucket = -(-fbucket // n_pts) * n_pts  # divisible shards
        fine = _stage_fine(
            a[0], a[1], b[0], b[1], jnp.asarray(best.transform), cfg, fbucket,
            nn_impl="auto" if point_mesh is None else "sharded",
            mesh=point_mesh,
        )
        fine = jax.tree.map(np.asarray, jax.device_get(fine))
    return best, fine


def _rotmat_to_euler_f32(r: np.ndarray) -> np.ndarray:
    """float32 euler extraction
    (/root/reference/BatchTopPartRegistration.cpp:290-309)."""
    r = np.asarray(r, np.float32)
    sy = np.sqrt(r[0, 0] * r[0, 0] + r[1, 0] * r[1, 0])
    if sy >= 1e-6:
        return np.array(
            [np.arctan2(r[2, 1], r[2, 2]), np.arctan2(-r[2, 0], sy), np.arctan2(r[1, 0], r[0, 0])],
            np.float32,
        )
    return np.array(
        [np.arctan2(-r[1, 2], r[1, 1]), np.arctan2(-r[2, 0], sy), 0.0], np.float32
    )


def _load_pair_chunk(chunk, point_cloud_dir: str, capacity: int | None,
                     pair_batch: int):
    """Load one pair_batch chunk's PCDs into ``register_pairs``-style
    (cloud_1, cloud_2, yaw_guess) tuples.  A short tail repeats its last
    LOADED pair to keep the compiled batch shape (re-loading per padded slot
    would re-read the same pcds); drivers drop the padded results by zipping
    against the unpadded chunk."""
    pairs = [
        (
            load_cloud_pcd(
                os.path.join(point_cloud_dir, f"{m.query_idx:06d}.pcd"), capacity
            ),
            load_cloud_pcd(
                os.path.join(point_cloud_dir, f"{m.match_idx:06d}.pcd"), capacity
            ),
            m.angle_guess,
        )
        for m in chunk
    ]
    pairs += [pairs[-1]] * (pair_batch - len(chunk))
    return pairs


def default_pair_batch() -> int:
    """Platform ``pair_batch`` default (``pctpu.runtime.platform``): 16 on a
    GPU (the batch the bench times), 1 on the CPU (it pays real compute per
    padded pair, so batching only helps hardware that runs the vmap in
    parallel).  Results are pair_batch-invariant up to the shared-capacity
    padding equivalence documented in ``_auto_capacity`` (all pairs pad to
    one capacity either way, so reduction shapes — and therefore reports —
    match the sequential run bit-for-bit; tested by the seq-vs-batched e2e
    equivalence tests)."""
    return platform_choice().pair_batch


def _prepare_batch_driver(match_results_filename, point_cloud_dir, report_path,
                          capacity, pair_batch, devices, process_id,
                          num_processes, resume):
    """Shared preamble of the two batch registration drivers: load the match
    list, shard it across hosts, derive the shared capacity from the FULL
    (pre-resume) list (header-only reads — a resumed run then pads exactly
    like the run it continues, and the sequential path compiles its stage
    programs once instead of once per distinct cloud size), filter resumed
    pairs, and build the optional data-parallel mesh (rounding pair_batch up
    to a multiple of the device count).  ``pair_batch=None`` resolves to
    :func:`default_pair_batch` per device: each device of a mesh then runs
    the same program on the same per-device batch as a single device does,
    so the two write the same bytes whenever their capacity buckets agree
    (a GPU's f32 reductions are compiled per batch shape, so a smaller
    per-device batch would round differently).

    Returns (matches, report_path, report_mode, capacity, pair_batch, mesh).
    """
    if pair_batch is None:
        pair_batch = default_pair_batch() * max(devices or 1, 1)
        log.info(f"pair_batch auto-selected for {jax.default_backend()}: "
                 f"{pair_batch}")
    matches = load_match_results(match_results_filename)
    from pctpu.parallel.distributed import process_shard

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    if nproc > 1:
        matches = process_shard(matches, pid, nproc)
        report_path = f"{report_path}.shard{pid}"
    if capacity is None:
        capacity = _auto_capacity(matches, point_cloud_dir)
        log.info(f"capacity auto-derived from headers: {capacity}")
    matches, report_mode = _filter_resumed(matches, report_path, resume)
    mesh = None
    if devices is not None and devices > 1:
        from pctpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_data=devices, n_points=1)
        if pair_batch % devices:
            pair_batch = -(-pair_batch // devices) * devices
    return matches, report_path, report_mode, capacity, pair_batch, mesh


def _pair_precision(t_coarse: np.ndarray, t_fine: np.ndarray) -> tuple[float, float]:
    """The precision-report Δxy/Δyaw with the reference's exact f32/f64
    arithmetic (/root/reference/BatchTopPartRegistration.cpp:512-524):

    - ``float diff_x/diff_y/diff_xy`` — all-f32 differences and sqrt;
    - ``rela_rot = fine_rot.inverse() * coarse_rot`` in Eigen f32
      (cofactor inverse + lazy-product order — ``eigen_inverse3_f32`` /
      ``matmul3_f32``, not LAPACK/BLAS whose ulp rounding differs);
    - the custom f32 euler extraction (:290-309);
    - ``float diff_yaw = angles(2) / M_PI * 180.0f`` — the division/multiply
      promote to double, the *assignment* rounds to f32, and the ±360° wrap
      then runs in f32 arithmetic (:523-525).

    Returned as Python floats holding the exact f32 values, which
    ``_ostream_float`` prints at 6 significant digits like
    ``ostream << float``."""
    diff_x = np.float32(t_fine[0, 3]) - np.float32(t_coarse[0, 3])
    diff_y = np.float32(t_fine[1, 3]) - np.float32(t_coarse[1, 3])
    diff_xy = float(np.sqrt(diff_x * diff_x + diff_y * diff_y))
    rela_rot = matmul3_f32(
        eigen_inverse3_f32(t_fine[:3, :3]), t_coarse[:3, :3]
    )
    diff_yaw = np.float32(
        float(_rotmat_to_euler_f32(rela_rot)[2]) / math.pi * 180.0
    )
    if diff_yaw > np.float32(180.0):
        diff_yaw = np.float32(diff_yaw - np.float32(360.0))
    if diff_yaw < np.float32(-180.0):
        diff_yaw = np.float32(diff_yaw + np.float32(360.0))
    return diff_xy, float(diff_yaw)


def _auto_capacity(matches: list[MatchResult], point_cloud_dir: str,
                   step: int = 8192) -> int:
    """Shared cloud capacity for pair batching: the max POINTS over every
    cloud referenced by the match list (header-only reads), rounded up to a
    ``step`` multiple for stable compilation buckets.

    NB: the padding changes f32 reduction shapes inside the ICP estimation,
    so batched results can differ at ulp level from an exact-capacity
    sequential run (and, on convergence knife-edges, exit on a different
    iteration — docs/PARITY.md "capacity padding vs f32 reduction shape").
    Any fixed capacity is reproducible run-to-run."""
    from pctpu.io.pcd import read_pcd_point_count

    idxs = {m.query_idx for m in matches} | {m.match_idx for m in matches}
    biggest = max(
        (read_pcd_point_count(os.path.join(point_cloud_dir, f"{i:06d}.pcd"))
         for i in idxs),
        default=1,
    )
    return max(-(-biggest // step) * step, step)


def _filter_resumed(matches, report_path: str, resume: bool):
    """Resume support for the report-stream drivers: drop matches recorded in
    the ``<report_path>.progress`` sidecar and pick the report open mode.

    Skipping consumes progress entries as a multiset, so a match file with
    duplicate pairs (which the reference processes twice) resumes correctly.
    Returns ``(remaining matches, report mode)``."""
    if not resume:
        return matches, "w"
    done: collections.Counter = collections.Counter()
    prog = report_path + ".progress"
    if os.path.exists(prog):
        with open(prog) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    done[(int(parts[0]), int(parts[1]))] += 1
    remaining = []
    for m in matches:
        key = (m.query_idx, m.match_idx)
        if done[key] > 0:
            done[key] -= 1
        else:
            remaining.append(m)
    if len(remaining) != len(matches):
        log.info(
            f"--resume: skipping {len(matches) - len(remaining)} "
            "already-processed pairs"
        )
    return remaining, ("a" if os.path.exists(report_path) else "w")


def run_batch_top_part_registration(
    match_results_filename: str,
    point_cloud_dir: str,
    cfg: RegistrationConfig = RegistrationConfig(),
    report_path: str = "./icp_precision_report.txt",
    capacity: int | None = None,
    flat_cap: int = 32768,
    pair_batch: int | None = None,
    devices: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    resume: bool = False,
) -> list[PairReport]:
    """The batch evaluator.  Returns per-pair reports; writes the precision
    report and prints the reference-style summary.

    ``pair_batch > 1`` runs that many pairs as one vmapped device dispatch
    (default: :func:`default_pair_batch` — 16 on a GPU, 1 on the CPU);
    ``devices=N`` additionally shards the pair axis over an N-way
    data-parallel mesh (pair_batch is rounded up to a multiple of N; by
    default it is the per-device default times N).  When
    ``capacity`` is None a shared one is derived from the PCD headers of the
    full match list — every pair (sequential or batched) then reuses the
    same compiled stage programs, and resumed runs pad identically to the
    run they continue.

    ``process_id``/``num_processes`` shard the match list across hosts
    (pctpu.parallel.distributed); each host writes
    ``<report_path>.shard<pid>`` and prints its own summary (the reference's
    single-process report contract is preserved for single-host runs).

    ``resume=True`` skips pairs listed in the ``<report_path>.progress``
    sidecar (one ``query match`` line per processed pair, flushed after its
    report line) and appends to the existing report — the §5.4
    checkpoint/resume policy extended to the report-stream tools, where the
    report itself carries no pair ids to resume from.  The report is flushed
    before the progress line, so a crash can at worst re-run (and re-append)
    the in-flight pair, never lose a recorded one.  The printed summary
    covers only the pairs processed by this invocation."""
    matches, report_path, report_mode, capacity, pair_batch, mesh = (
        _prepare_batch_driver(
            match_results_filename, point_cloud_dir, report_path, capacity,
            pair_batch, devices, process_id, num_processes, resume,
        )
    )
    timer = StageTimer()
    reports: list[PairReport] = []
    count_success = 0
    count_failure = 0

    def result_stream():
        """Yield (match, best, fine) — sequentially or pair-batched."""
        if pair_batch <= 1:
            for m in matches:
                c1 = load_cloud_pcd(
                    os.path.join(point_cloud_dir, f"{m.query_idx:06d}.pcd"), capacity
                )
                c2 = load_cloud_pcd(
                    os.path.join(point_cloud_dir, f"{m.match_idx:06d}.pcd"), capacity
                )
                best, fine = register_pair(
                    c1, c2, m.angle_guess, cfg, flat_cap=flat_cap, timer=timer
                )
                yield m, best, fine
            return
        chunks = [
            matches[start : start + pair_batch]
            for start in range(0, len(matches), pair_batch)
        ]

        # software pipeline: batch k+1 loads + runs its coarse stage on a
        # worker thread while batch k's fine stage runs here
        stream = register_pairs_pipelined(
            (
                functools.partial(
                    _load_pair_chunk, c, point_cloud_dir, capacity, pair_batch
                )
                for c in chunks
            ),
            cfg, flat_cap=flat_cap, timer=timer, mesh=mesh,
        )
        for chunk, results in zip(chunks, stream):
            for m, (best, fine) in zip(chunk, results):
                yield m, best, fine

    with open(report_path, report_mode) as report, open(
        report_path + ".progress", report_mode
    ) as progress:

        def _mark_done(m):
            progress.write(f"{m.query_idx} {m.match_idx}\n")
            progress.flush()

        for m, best, fine in result_stream():
            log.green(f"Processing match: {m.query_idx} and {m.match_idx}")
            if fine is None:  # use_refinement=False: coarse only, no report
                reports.append(
                    PairReport(m.query_idx, m.match_idx, False,
                               float(best.fitness), np.nan, np.nan, np.nan,
                               np.asarray(best.transform))
                )
                _mark_done(m)
                continue
            t_coarse = np.asarray(best.transform)
            t_fine = np.asarray(fine.transform)
            fit_fine = float(fine.fitness)
            log.info(
                f"is icp converged: {bool(fine.converged)}, fitness score: {fit_fine}"
            )

            if fit_fine > cfg.failure_fitness:
                log.red("3D ICP Failed. ")
                count_failure += 1
                reports.append(
                    PairReport(m.query_idx, m.match_idx, False, float(best.fitness),
                               fit_fine, np.nan, np.nan, t_fine)
                )
                _mark_done(m)
                continue

            diff_xy, diff_yaw = _pair_precision(t_coarse, t_fine)
            log.info(f"diff_xy: {diff_xy}, diff_yaw: {diff_yaw}")
            report.write(f"{_ostream_float(diff_xy)} {_ostream_float(diff_yaw)}\n")
            report.flush()  # before the progress mark: re-run beats lost line
            count_success += 1
            reports.append(
                PairReport(m.query_idx, m.match_idx, True, float(best.fitness),
                           fit_fine, diff_xy, diff_yaw, t_fine)
            )
            _mark_done(m)

    n = max(len(matches), 1)
    log.green(f"[TIME] Avg Tiempo for 1st Stage (coarse): {timer.totals_ms['coarse'] / n}")
    log.green(f"[TIME] Avg Tiempo for 2nd Stage (fine): {timer.totals_ms['fine'] / n}")
    total = count_success + count_failure
    sr = count_success / total if total else float("nan")
    log.info(
        f"count_success: {count_success}, count_failure: {count_failure}, SR: {sr}. "
    )
    return reports


def run_batch_whole_registration(
    match_results_filename: str,
    point_cloud_dir: str,
    cfg: RegistrationConfig | None = None,
    report_path: str = "./icp_precision_report_3d_icp_directly.txt",
    capacity: int | None = None,
    pair_batch: int | None = None,
    devices: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    resume: bool = False,
) -> tuple[int, int]:
    """Ablation: direct 3-D ICP from the yaw guess on whole downsampled
    clouds (/root/reference/BatchWholeRegistration.cpp:311-418).  The report
    file is created but — like the reference — never written to; only the
    success/failure counts are reported.  Returns (success, failure).

    ``resume=True`` skips pairs recorded in the ``<report_path>.progress``
    sidecar (same contract as ``run_batch_top_part_registration``); the
    returned/printed counts cover only this invocation's pairs.

    ``pair_batch > 1`` runs that many pairs as one vmapped device dispatch
    (default: :func:`default_pair_batch` — 16 on a GPU, 1 on the CPU; shared
    capacity auto-derived from the full match list's PCD headers
    when not given, like ``run_batch_top_part_registration``);
    ``devices=N`` shards the pair axis over an N-way data-parallel mesh —
    the same plumbing as ``run_batch_top_part_registration``.

    ``process_id``/``num_processes`` shard the match list across hosts like
    ``run_batch_top_part_registration`` (empty report per shard)."""
    from pctpu.config import WHOLE_ICP

    if cfg is None:
        cfg = RegistrationConfig(fine=WHOLE_ICP)
    matches, report_path, report_mode, capacity, pair_batch, mesh = (
        _prepare_batch_driver(
            match_results_filename, point_cloud_dir, report_path, capacity,
            pair_batch, devices, process_id, num_processes, resume,
        )
    )
    timer = StageTimer()
    count_success = 0
    count_failure = 0
    if report_mode == "w":
        open(report_path, "w").close()

    def result_stream():
        """Yield (match, fine IcpResult) — sequentially or pair-batched."""
        if pair_batch <= 1:
            for m in matches:
                c1 = load_cloud_pcd(
                    os.path.join(point_cloud_dir, f"{m.query_idx:06d}.pcd"), capacity
                )
                c2 = load_cloud_pcd(
                    os.path.join(point_cloud_dir, f"{m.match_idx:06d}.pcd"), capacity
                )
                with timer.stage("fine"):
                    guess = jnp.asarray(
                        yaw_rotation_4x4(
                            _guess_angle_rad(m.angle_guess)
                        ).astype(np.float32)
                    )
                    s_xyz, s_mask, _ = _voxel_full(c1, cfg.voxel_leaf)
                    t_xyz, t_mask, _ = _voxel_full(c2, cfg.voxel_leaf)
                    fine = icp_point_to_point(
                        s_xyz, s_mask, t_xyz, t_mask, guess, cfg.fine,
                    )
                    fine = jax.tree.map(np.asarray, jax.device_get(fine))
                yield m, fine
            return
        import concurrent.futures

        chunks = [
            matches[start : start + pair_batch]
            for start in range(0, len(matches), pair_batch)
        ]

        def load_chunk(chunk):
            return _load_pair_chunk(chunk, point_cloud_dir, capacity, pair_batch)

        # prefetch chunk k+1's PCD loads on a worker thread under chunk k's
        # device dispatch — the same overlap the top-part driver gets from
        # register_pairs_pipelined (here there is only one device stage)
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(load_chunk, chunks[0]) if chunks else None
            for k, chunk in enumerate(chunks):
                pairs = fut.result()
                fut = (
                    ex.submit(load_chunk, chunks[k + 1])
                    if k + 1 < len(chunks)
                    else None
                )
                results = register_whole_pairs(pairs, cfg, timer=timer, mesh=mesh)
                for m, fine in zip(chunk, results):
                    yield m, fine

    with open(report_path + ".progress", report_mode) as progress:
        for m, fine in result_stream():
            log.green(f"Processing match: {m.query_idx} and {m.match_idx}")
            fit = float(fine.fitness)
            log.info(
                f"is icp converged: {bool(fine.converged)}, fitness score: {fit}"
            )
            if fit > cfg.failure_fitness:
                log.red("3D ICP Failed. ")
                count_failure += 1
            else:
                log.green("3D ICP Passed. ")
                count_success += 1
            progress.write(f"{m.query_idx} {m.match_idx}\n")
            progress.flush()

    n = max(len(matches), 1)
    log.green(f"[TIME] Avg Tiempo for 2nd Stage (fine): {timer.totals_ms['fine'] / n}")
    total = count_success + count_failure
    sr = count_success / total if total else float("nan")
    log.info(
        f"count_success: {count_success}, count_failure: {count_failure}, SR: {sr}. "
    )
    return count_success, count_failure
