"""Benchmark: HDL-64E multi-BEV preprocessing throughput on one GPU.

Prints the device (JAX platform, kind and count; ``nvidia-smi`` name and
power limit), then ONE JSON line:
  {"metric": "...", "value": N, "unit": "clouds/s", "vs_baseline": N, ...}

The baseline is self-measured (the reference publishes no numbers,
BASELINE.md): a single-core C++ re-implementation of the same per-point
algorithm (native/baseline_bev.cpp) is built and timed on the host, and
vs_baseline = device clouds/s ÷ single-core clouds/s.  Device work is timed
with ``block_until_ready``; everything runs in this one process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 120_000
BATCH = 8
WARMUP_BATCHES = 2
BENCH_BATCHES = 6
BASELINE_CLOUDS = 10
K_STACK = 16  # distinct batches per timed window

# Pinned spread of the compute-only C++ baseline across earlier runs
# (best-of-3 each): the ratio's error bar is the HOST, not either code base,
# so every emitted vs_baseline carries an interval built from this spread
# union the current run's measurement.
BASELINE_HIST_MS = (7.47, 10.5)
# same, for the full-span baseline (compute + in-[TIME] artifact writes)
BASELINE_SPAN_HIST_MS = (20.7, 24.2)


def _ratio_interval(pctpu_cps: float, session_ms: float,
                    hist_ms: tuple) -> list:
    """[min, max] of pctpu_cps / baseline_cps over the union of this
    session's baseline measurement and the pinned historical spread —
    the host's measured volatility, not either code base's.
    ratio = pctpu_cps * baseline_ms / 1000."""
    lo_ms = min(session_ms, hist_ms[0])
    hi_ms = max(session_ms, hist_ms[1])
    return [round(pctpu_cps * lo_ms / 1000.0, 3),
            round(pctpu_cps * hi_ms / 1000.0, 3)]


def measure_baseline(full_span: bool = False) -> float:
    """Single-core C++ ms/cloud (same algorithm, per-point loops).

    ``full_span=True`` matches the reference's actual [TIME] bracket
    (/root/reference/BatchMultiBevGen.cpp:731-749): the timed loop then also
    performs the in-span artifact writes — layer-major .bin, per-cloud
    mkdir, 24+1 PNGs (cv::imwrite-default encoder: SUB filter, zlib level 1,
    Z_RLE), and the FMT_CSV.  ``full_span=False`` is the compute-only span
    (stronger baseline — faster than the real reference)."""
    from pctpu.runtime.native_build import build, native_source

    exe = build(native_source("baseline_bev.cpp"), ["-O2", "-std=c++14"],
                ["-lz"], shared=False)
    # best of 3 to resist host-load noise (single shared CPU core)
    import shutil
    import tempfile

    best = float("inf")
    for _ in range(3):
        argv = [exe, str(BASELINE_CLOUDS), str(N_POINTS)]
        io_dir = None
        if full_span:
            io_dir = tempfile.mkdtemp(prefix="pctpu_baseline_span_")
            argv.append(io_dir)
        try:
            out = subprocess.run(
                argv, check=True, capture_output=True, text=True
            ).stdout
        finally:
            if io_dir is not None:
                shutil.rmtree(io_dir, ignore_errors=True)
        best = min(best, float(json.loads(out)["ms_per_cloud"]))
    return best


def device_info() -> dict:
    """The device every number below was measured on: JAX's platform, kind
    and device count, and ``nvidia-smi``'s name and power limit.  Raises
    unless the first device is a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def synth_batch(params, batch: int, n_points: int, seed: int, ordered: bool = False):
    """Synthetic clouds.  ``ordered=True`` emits the selector-tool layout the
    production pipeline actually consumes (dense grid, slot = row*H + col,
    empty slots all-zero with label 0) — the fast path of preprocess_batch;
    ``ordered=False`` emits random row/col placement (the general path)."""
    import jax.numpy as jnp

    from pctpu.cloud import Cloud

    rng = np.random.default_rng(seed)
    g = params.grid_size
    rangev = rng.uniform(3, 100, (batch, g)).astype(np.float32)
    az = rng.uniform(0, 2 * np.pi, (batch, g)).astype(np.float32)
    ground = rng.random((batch, g)) < 0.5
    z = np.where(
        ground,
        rng.uniform(-2.0, -1.8, (batch, g)),
        rng.uniform(-1.0, 6.0, (batch, g)),
    ).astype(np.float32)
    xyz = np.stack([rangev * np.cos(az), rangev * np.sin(az), z], axis=-1)
    if ordered:
        mask = rng.random((batch, g)) < (n_points / g)
        slot = np.arange(g)
        row = np.broadcast_to(slot // params.horizon_scan, (batch, g)).astype(np.int32)
        col = np.broadcast_to(slot % params.horizon_scan, (batch, g)).astype(np.int32)
        count = np.full((batch,), g, np.int32)
        intensity = np.maximum(rng.random((batch, g)).astype(np.float32), 1e-3)
    else:
        mask = np.broadcast_to(np.arange(g)[None, :] < n_points, (batch, g))
        row = rng.integers(0, params.n_scan, (batch, g)).astype(np.int32)
        col = rng.integers(0, params.horizon_scan, (batch, g)).astype(np.int32)
        count = np.full((batch,), n_points, np.int32)
        intensity = rng.random((batch, g)).astype(np.float32)
    return Cloud(
        xyz=jnp.asarray(xyz * mask[..., None]),
        intensity=jnp.asarray(intensity * mask),
        row=jnp.asarray(row * mask),
        col=jnp.asarray(col * mask),
        t=jnp.zeros((batch, g), jnp.uint32),
        label=jnp.asarray(np.where(mask, -2, 0).astype(np.int32)),
        count=jnp.asarray(count),
    )


def measure_device(ordered: bool = True, sensor: str = "HDL_64E",
                   n_points: int | None = None,
                   compat: str = "bitexact") -> float:
    """Sustained on-device clouds/sec of the fused preprocess+BEV kernel:
    ``K_STACK`` distinct batches dispatched back to back, timed to
    ``block_until_ready`` of the last, best of 3 (the C++ baseline is
    best-of-3 too).  Host IO is excluded on both sides.

    ``ordered=True`` is the production path: BatchMultiBevGen's documented
    input is the selector tools' dense-grid PCDs (README.md:23-30), which the
    pipeline detects host-side (is_grid_ordered) and preprocesses without the
    ordering scatter.  ``ordered=False`` measures the general path (arbitrary
    row/col placement).  The C++ baseline runs its ordering loop either way.
    """
    import jax

    from pctpu.config import get_sensor_params
    from pctpu.ops.preprocess import preprocess_batch

    params = get_sensor_params(sensor)
    if n_points is None:
        n_points = min(N_POINTS, int(params.grid_size * 0.9))
    batches = [synth_batch(params, BATCH, n_points, seed, ordered=ordered)
               for seed in range(K_STACK)]
    run = jax.jit(lambda b: preprocess_batch(
        b, params, assume_ordered=ordered, compat=compat))
    jax.block_until_ready([run(b) for b in batches])  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready([run(b) for b in batches])
        best = min(best, time.perf_counter() - t0)
    return K_STACK * BATCH / best


def measure_write_ms(n_clouds: int = 12) -> float:
    """pctpu's per-cloud artifact-write cost (ms) for the full-span ratio.

    Writes exactly the artifacts the reference's [TIME] bracket covers —
    layer-major .bin + 24 layer PNGs + single PNG + FMT_CSV — through the
    production writer path (pipelines/multi_bev._write_outputs: ONE
    runtime/native_io.write_cloud_artifacts call per cloud from the packed
    occupancy wire format), on real rasters from one preprocessed bench
    batch.  Matches the pipeline convention (pipelines/multi_bev.py):
    full-span per-cloud = device-compute average + this per-cloud write
    average (the serial-sum convention; the pipeline itself overlaps the
    writes — see measure_pipeline_span)."""
    import shutil
    import tempfile

    import jax

    from pctpu.config import get_sensor_params
    from pctpu.ops.preprocess import preprocess_batch
    from pctpu.runtime.native_io import write_cloud_artifacts

    params = get_sensor_params("HDL_64E")
    n_points = min(N_POINTS, int(params.grid_size * 0.9))
    cloud = synth_batch(params, BATCH, n_points, seed=3, ordered=True)
    _, multi, single = jax.device_get(
        jax.jit(
            lambda b: preprocess_batch(b, params, assume_ordered=True)
        )(cloud)
    )
    multi = np.asarray(multi)
    single = np.asarray(single)
    # the pipeline ships the occupancy BEV in its packed wire format and the
    # writer expands it natively (pipelines/multi_bev._preprocess_wire)
    nl, s = multi.shape[1], multi.shape[2]
    packed = np.packbits(
        (multi != 0).reshape(BATCH, nl, s, s // 8, 8), axis=-1,
        bitorder="little",
    ).reshape(BATCH, nl, s, s // 8)
    io_dir = tempfile.mkdtemp(prefix="pctpu_span_")
    try:
        for sub in ("binary", "image", "single_image", "single_csv"):
            os.makedirs(os.path.join(io_dir, sub), exist_ok=True)
        # warm one cloud (dlopen of libpctpu_io, page cache)
        write_cloud_artifacts(
            os.path.join(io_dir, "binary", "warm.bin"),
            os.path.join(io_dir, "image", "warm/"),
            os.path.join(io_dir, "single_image", "warm.png"),
            os.path.join(io_dir, "single_csv", "warm.csv"),
            single[0], packed=packed[0],
        )
        # best of 3 like measure_baseline: ext4 dirty-page writeback on the
        # shared host throttles bursts unpredictably (up to ~4x)
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            for i in range(n_clouds):
                b = i % BATCH
                short = f"{rep}_{i:06d}"
                write_cloud_artifacts(
                    os.path.join(io_dir, "binary", short + ".bin"),
                    os.path.join(io_dir, "image", short + "/"),
                    os.path.join(io_dir, "single_image", short + ".png"),
                    os.path.join(io_dir, "single_csv", short + ".csv"),
                    single[b], packed=packed[b],
                )
            best = min(best, time.perf_counter() - t0)
    finally:
        shutil.rmtree(io_dir, ignore_errors=True)
    return best * 1000.0 / n_clouds


def _write_bench_tree(root: str, n_clouds: int, seed0: int,
                      sensor: str = "HDL_64E") -> None:
    """A selected-keyframe tree of bench-shaped clouds (the production input
    layout the selector tools emit: dense grid, empty slots all-zero with
    label 0), for the end-to-end pipeline span measurement."""
    from pctpu.config import get_sensor_params
    from pctpu.geom.se3 import Pose6f
    from pctpu.io.pcd import write_pcd
    from pctpu.io.poses import format_pose_entry

    params = get_sensor_params(sensor) if isinstance(sensor, str) else sensor
    n_points = min(N_POINTS, int(params.grid_size * 0.9))
    os.makedirs(os.path.join(root, "keyframe_point_cloud"), exist_ok=True)
    lines = []
    idx = 0
    for seed in range(seed0, seed0 + (n_clouds + BATCH - 1) // BATCH):
        batch = synth_batch(params, BATCH, n_points, seed, ordered=True)
        xyz = np.asarray(batch.xyz)
        intensity = np.asarray(batch.intensity)
        row = np.asarray(batch.row).astype(np.uint16)
        col = np.asarray(batch.col).astype(np.uint16)
        label = np.asarray(batch.label).astype(np.int16)
        for b in range(BATCH):
            if idx >= n_clouds:
                break
            write_pcd(
                os.path.join(root, "keyframe_point_cloud", f"{idx:06d}.pcd"),
                {
                    "x": xyz[b, :, 0], "y": xyz[b, :, 1], "z": xyz[b, :, 2],
                    "intensity": intensity[b], "row": row[b], "col": col[b],
                    "t": np.zeros(xyz.shape[1], np.uint32), "label": label[b],
                },
                width=xyz.shape[1],
            )
            lines.append(format_pose_entry(
                idx, Pose6f.from_matrix(np.eye(3), np.array([3.0 * idx, 0, 0]))
            ))
            idx += 1
    with open(os.path.join(root, "keyframe_pose.csv"), "w") as f:
        f.writelines(lines)


def measure_pipeline_span(n_clouds: int = 64, sensor: str = "HDL_64E") -> dict:
    """End-to-end `run_multi_bev` measured span.

    Runs the REAL tool (prefetch loader → jitted batch kernel → AsyncWriter,
    write_pngs=True, tolerance compat) over `n_clouds` bench-shaped HDL-64E
    clouds: a warm tree first (jit cache + writer lib), then one timed tree.
    The pipeline's own loop wall is the published span — the BEV writes
    overlap device compute in it, unlike the serial-sum convention."""
    import shutil
    import tempfile

    from pctpu.pipelines.multi_bev import run_multi_bev

    warm_dir = tempfile.mkdtemp(prefix="pctpu_pipe_warm_")
    timed_dir = tempfile.mkdtemp(prefix="pctpu_pipe_")
    try:
        _write_bench_tree(warm_dir, BATCH, seed0=100, sensor=sensor)
        _write_bench_tree(timed_dir, n_clouds, seed0=200, sensor=sensor)
        run_multi_bev(warm_dir, sensor, batch_size=BATCH, compat="tolerance")
        out = run_multi_bev(
            timed_dir, sensor, batch_size=BATCH, compat="tolerance"
        )
        assert out.num_clouds == n_clouds
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
        shutil.rmtree(timed_dir, ignore_errors=True)

    wall_ms = out.wall_ms_per_cloud
    device_ms = out.avg_device_ms_per_cloud  # includes in-stage transfers
    write_ms = out.avg_bev_write_ms_per_cloud
    hidden_pct = max(
        0.0, 100.0 * (1.0 - max(wall_ms - device_ms, 0.0) / max(write_ms, 1e-9))
    )
    return {
        "pipeline_full_span_clouds_per_sec": round(1000.0 / wall_ms, 3),
        "pipeline_wall_ms_per_cloud": round(wall_ms, 3),
        "pipeline_device_ms_per_cloud_incl_transfers": round(device_ms, 3),
        "pipeline_bev_write_ms_per_cloud": round(write_ms, 3),
        "pipeline_serial_sum_ms_per_cloud": round(device_ms + write_ms, 3),
        "pipeline_write_overlap_hidden_pct": round(hidden_pct, 1),
    }


def _stage_ms(fn, args, reps: int = 10) -> float:
    """Median ms per call of the jitted ``fn(*args)``, each call timed to
    ``block_until_ready``, after one warm (compiling) call."""
    import statistics

    import jax

    run = jax.jit(fn)
    jax.block_until_ready(run(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def utilization_block(tol_cps: float | None = None,
                      exact_cps: float | None = None,
                      sensor: str = "HDL_64E") -> dict:
    """Per-stage device time vs measured primitive peaks.

    Each hot stage of the preprocess kernel is timed standalone at kernel
    shapes (batch=BATCH, HDL-64E grid), each primitive peak is measured
    fresh on the same device in the same run, and
    `pct_of_primitive_peak = bound / measured`, so a regression in any stage
    shows up as a dropping percentage in bench_details.json.  The
    stage probes are cross-checked against the end-to-end kernel: the sum
    of (BEV + tolerance grid + sweep) is emitted next to the measured
    full-kernel ms/cloud (from `tol_cps`) as `stage_sum_vs_kernel`.
    """
    import jax
    import jax.numpy as jnp

    from pctpu.config import GroundConfig, get_sensor_params
    from pctpu.ops.bev import fused_multi_single_bev
    from pctpu.ops.ground import (
        _belonging_grid,
        _grid_sums_bitexact,
        _grid_sums_tolerance,
        mark_ground,
    )

    params = get_sensor_params(sensor) if isinstance(sensor, str) else sensor
    cfg = GroundConfig()
    n_points = min(N_POINTS, int(params.grid_size * 0.9))
    batch = synth_batch(params, BATCH, n_points, seed=3, ordered=True)
    g = params.grid_size
    swept = min((params.ground_upper_scan + 1) * params.horizon_scan, g)

    # ---- measured primitive peaks (this session, this chip) ----
    def f_sort(keys, payload):
        sk, sp = jax.vmap(
            lambda a, b: jax.lax.sort([a, b], num_keys=1)
        )(keys, payload)
        return (sk[:, 0].sum().astype(jnp.float32)
                + sp[:, -1].sum(dtype=jnp.uint32).astype(jnp.float32))

    from pctpu.config import MultiBevConfig

    s_bev = MultiBevConfig().mat_size
    L = g + s_bev * s_bev  # fused-BEV sort length: points + one sentinel/cell
    rng = np.random.default_rng(11)
    keys = jnp.asarray(rng.integers(0, 1 << 24, (BATCH, L), dtype=np.int32))
    payload = jnp.asarray(
        rng.integers(0, 1 << 30, (BATCH, L), dtype=np.int64).astype(np.uint32)
    )
    sort_ms = _stage_ms(f_sort, (keys, payload))
    sort_ns = sort_ms * 1e6 / (BATCH * L * 2)  # per element per operand

    def f_scatter(idx, vals):
        out = jax.vmap(
            lambda i, p: jnp.zeros((8192, 2), jnp.float32).at[i].add(p)
        )(idx, vals)
        return jnp.sum(out)

    idx = jnp.asarray(rng.integers(0, 8192, (BATCH, swept), dtype=np.int32))
    vals = jnp.asarray(rng.random((BATCH, swept, 2), np.float32))
    scatter_ms = _stage_ms(f_scatter, (idx, vals))
    scatter_ns = scatter_ms * 1e6 / (BATCH * swept)  # per 2-wide update row

    def f_matmul(a, b):
        return jnp.sum(
            jax.lax.dot(a, b, precision=jax.lax.Precision.HIGHEST)
        )

    mm = 1024
    a = jnp.asarray(rng.random((mm, mm), np.float32))
    b = jnp.asarray(rng.random((mm, mm), np.float32))
    matmul_ms = _stage_ms(f_matmul, (a, b))
    matmul_tmacs = mm**3 / (matmul_ms * 1e-3) / 1e12  # f32 MAC/s (HIGHEST)

    def f_hbm(x):
        return jnp.sum(x)

    big = jnp.asarray(rng.random((1 << 25,), np.float32))  # 128 MB
    hbm_ms = _stage_ms(f_hbm, (big,))
    hbm_gbps = big.nbytes / (hbm_ms * 1e-3) / 1e9  # one read pass (fused sum)

    # ---- measured stage times at kernel shapes (ms per cloud) ----
    labeled = jax.vmap(lambda c: mark_ground(c, params, cfg)[0])(batch)

    def f_bev(lb):
        m, s = jax.vmap(
            lambda c: fused_multi_single_bev(c, params.height_res)
        )(lb)
        return jnp.float32(
            jnp.sum(m, dtype=jnp.int32) + jnp.sum(s, dtype=jnp.int32)
        )

    bev_ms = _stage_ms(f_bev, (labeled,)) / BATCH

    def _grid_args():
        x = batch.xyz[:, :swept, 0]
        y = batch.xyz[:, :swept, 1]
        z = batch.xyz[:, :swept, 2]
        srow, scol = jax.vmap(lambda xx, yy: _belonging_grid(xx, yy, cfg))(x, y)
        ground = batch.label[:, :swept] == -2
        return srow, scol, z, ground

    srow, scol, z, ground = _grid_args()
    sector = srow * cfg.grid_cols + scol

    def f_grid_exact(sec, zz, gg):
        out = jax.vmap(
            lambda s_, z_, g_: _grid_sums_bitexact(s_, z_, g_, cfg)
        )(sec, zz, gg)
        return jnp.sum(out)

    grid_exact_ms = _stage_ms(f_grid_exact, (sector, z, ground)) / BATCH

    def f_grid_tol(sr, sc, zz, gg):
        out = jax.vmap(
            lambda r_, c_, z_, g_: _grid_sums_tolerance(r_, c_, z_, g_, cfg)
        )(sr, sc, zz, gg)
        return jnp.sum(out)

    grid_tol_ms = _stage_ms(f_grid_tol, (srow, scol, z, ground)) / BATCH

    def f_mark(compat):
        def f(bb):
            lb, gm = jax.vmap(
                lambda c: mark_ground(c, params, cfg, compat=compat)
            )(bb)
            return jnp.float32(
                jnp.sum(lb.label) + jnp.sum(gm, dtype=jnp.int32)
            )

        return f

    mark_tol_ms = _stage_ms(f_mark("tolerance"), (batch,)) / BATCH
    mark_exact_ms = _stage_ms(f_mark("bitexact"), (batch,)) / BATCH

    # ---- primitive bounds per stage ----
    bev_bound = 2 * L * 2 * sort_ns / 1e6  # two sorts, 2 operands each
    scatter_bound = swept * scatter_ns / 1e6  # one 2-wide update per point
    macs = swept * 2 * cfg.grid_rows * cfg.grid_cols  # (P,2R)@(P,C)
    grid_tol_bound = macs / (matmul_tmacs * 1e12) * 1e3
    # ~30 elementwise passes over the swept planes (x,y,z,... shifted
    # candidates), read+write each
    sweep_bound = 30 * (swept * 4 * 2) / (hbm_gbps * 1e9) * 1e3

    def row(measured, bound):
        return {
            "measured_ms_per_cloud": round(measured, 4),
            "primitive_bound_ms": round(bound, 4),
            "pct_of_primitive_peak": round(100.0 * bound / measured, 1)
            if measured > 0 else None,
        }

    out = {
        "primitive_peaks": {
            "sort_ns_per_elem_per_operand": round(sort_ns, 3),
            "scatter_ns_per_update_row": round(scatter_ns, 3),
            "matmul_f32_highest_tmacs": round(matmul_tmacs, 3),
            "hbm_read_gbps": round(hbm_gbps, 1),
        },
        # full ground-marking in each compat mode (sweep + veto + its grid
        # accumulation as XLA actually fuses them) — a stage's percentage
        # over 100 means the kernel formulation beats the generic primitive
        # probe (banded scatter / narrow sort keys)
        "stages": {
            "fused_multi_single_bev": row(bev_ms, bev_bound),
            "mark_ground_bitexact": row(
                mark_exact_ms, scatter_bound + sweep_bound
            ),
            "mark_ground_tolerance": row(
                mark_tol_ms, grid_tol_bound + sweep_bound
            ),
        },
        # the grid accumulations timed in isolation (their standalone cost
        # exceeds their marginal cost inside mark_ground — the one-hot /
        # index build fuses with the sweep there)
        "substages_isolated": {
            "ground_grid_scatter_bitexact": row(grid_exact_ms, scatter_bound),
            "ground_grid_matmul_tolerance": row(grid_tol_ms, grid_tol_bound),
        },
        "stage_sum_tolerance_ms": round(bev_ms + mark_tol_ms, 4),
    }
    if tol_cps:
        kernel_ms = 1000.0 / tol_cps
        out["kernel_tolerance_ms_per_cloud"] = round(kernel_ms, 4)
        out["stage_sum_vs_kernel"] = round(
            out["stage_sum_tolerance_ms"] / kernel_ms, 3
        )
    if exact_cps and tol_cps:
        # the bit-exact kernel swaps the matmul grid for the ordered fold
        out["kernel_bitexact_ms_per_cloud"] = round(1000.0 / exact_cps, 4)
    return out


def measure_registration_baseline(n_pairs: int = 5) -> dict:
    """Single-core C++ two-stage ICP ms/pair on the bench scene
    (native/baseline_registration.cpp — same algorithm as the reference,
    grid NN standing in for PCL's kd-tree, which favors the baseline).
    Returns the binary's JSON (best ms_per_pair of 3 runs)."""
    from pctpu.runtime.native_build import build, native_source

    exe = build(native_source("baseline_registration.cpp"),
                ["-O2", "-std=c++14"], shared=False)
    best = None
    for _ in range(3):
        out = json.loads(
            subprocess.run(
                [exe, str(n_pairs)], check=True, capture_output=True, text=True
            ).stdout
        )
        if best is None or out["ms_per_pair"] < best["ms_per_pair"]:
            best = out
    assert best["successes"] == best["n_pairs"], best
    # the timing comparison is only fair if the baseline SOLVES the scene:
    # its recovered transform must match the known (17°, (1.5, −2)) inside
    # the north-star window, like the pctpu on-chip precision gate
    assert abs(best["last_fine_yaw_deg"] - 17.0) < 0.5, best
    assert abs(best["last_fine_tx"] - 1.5) < 0.1, best
    assert abs(best["last_fine_ty"] + 2.0) < 0.1, best
    return best


def verify_on_device() -> str:
    """On-device verification gate.

    The Pallas kernels' compiled form is otherwise exercised only by
    ``chip_smoke.py`` (the CPU suite runs them with ``interpret=True``), so
    this gate diffs them against their plain references on the device:

    1. the fine-stage NN kernel vs ``nn_1`` at 49k², both the thresholded
       (1 m correspondence gate) and the unthresholded fitness pass
       (correspondence semantics
       /root/reference/BatchTopPartRegistration.cpp:199-239);
    2. the fused sort-based BEV vs the scatter-based ops at full HDL-64E
       shapes, in both compat modes — byte-identical rasters;
    3. three small pairs through the two-stage registration vs the f64
       oracle ``tests/ref_impl.two_stage_ref``.

    Returns "ok" or raises AssertionError.
    """
    import jax

    from chip_smoke import _on_event, phase_nn, phase_oracle
    from pctpu.config import get_sensor_params
    from pctpu.ops.bev import fused_multi_single_bev, multi_bev, single_bev
    from pctpu.ops.ground import mark_ground
    from pctpu.ops.ordering import get_ordered_cloud

    # the phases print their compile time from JAX's compile events
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    phase_nn()

    # --- fused vs unfused preprocess BEVs at HDL-64E, both compat modes ----
    # Stages compile as SEPARATE programs, and the BEV programs are shared
    # across the two compat modes.
    params = get_sensor_params("HDL_64E")
    cloud = synth_batch(params, 1, min(N_POINTS, params.grid_size), seed=11)
    one = jax.tree.map(lambda x: x[0], cloud)
    ordered = jax.jit(lambda c: get_ordered_cloud(c, params))(one)
    _mark = jax.jit(
        lambda c, compat: mark_ground(c, params, compat=compat),
        static_argnames=("compat",),
    )
    _fused = jax.jit(lambda c: fused_multi_single_bev(c, params.height_res))
    _multi = jax.jit(lambda c: multi_bev(c, params.height_res))
    _single = jax.jit(single_bev)
    for compat in ("bitexact", "tolerance"):
        labeled, _ = _mark(ordered, compat)
        fm, fs = jax.device_get(_fused(labeled))
        m, s = jax.device_get((_multi(labeled), _single(labeled)))
        assert np.array_equal(fm, m), f"fused multi BEV ({compat})"
        assert np.array_equal(fs, s), f"fused single BEV ({compat})"

    phase_oracle()
    return "ok"


def measure_registration(return_stages: bool = False, depth: int = 1):
    """Fused two-stage registration pairs/sec on ~60k-point synthetic scenes
    (``chip_smoke.registration_scene``; every pair distinct), run as the
    batch driver runs them: 16-pair batches through the pipelined stream,
    batch k+1's coarse stage overlapping batch k's fine stage.

    ``return_stages=True`` also returns the measured per-pair stage wall
    times (the reference's two [TIME] spans) from the pipelined run.
    ``depth`` is the pipeline's device-queue depth."""
    from chip_smoke import registration_pairs
    from pctpu.config import RegistrationConfig
    from pctpu.pipelines.registration import (
        register_pairs,
        register_pairs_pipelined,
    )
    from pctpu.runtime.profiler import StageTimer

    n_pairs = 16  # the GPU default pair batch
    # 6 batches: the pipeline needs one batch of ramp-up before coarse/fine
    # halves fully overlap.  Inputs are built on the device outside the
    # timed region (production pairs stream from the loader thread).
    n_batches = 6
    built = [[p[:3] for p in registration_pairs(n_pairs, seed=1 + k)]
             for k in range(n_batches)]
    # flat_cap matches the CLI default (cli/batch_top_part_registration.py):
    # the bench measures the out-of-the-box configuration, not a tuned one
    cfg = RegistrationConfig()
    register_pairs(built[0], cfg, flat_cap=32768)  # compile
    stage_timer = StageTimer()
    t0 = time.perf_counter()
    for _ in register_pairs_pipelined(
        iter([lambda b=b: b for b in built]), cfg, flat_cap=32768,
        timer=stage_timer, depth=depth,
    ):
        pass
    pps = n_batches * n_pairs / (time.perf_counter() - t0)
    if return_stages:
        stages = {
            k: round(stage_timer.average_ms(k), 3)
            for k in sorted(stage_timer.totals_ms)
        }
        return pps, stages
    return pps


def main() -> int:
    from pctpu.runtime.platform import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    print(json.dumps({"device": device}), flush=True)
    if "--verify" in sys.argv:
        # standalone gate: on-device kernel diffs + oracle pairs, no
        # throughput measurement
        print(json.dumps({"verify": verify_on_device(), "device": device}))
        return 0
    details = "--details" in sys.argv
    baseline_ms = measure_baseline()
    baseline_cps = 1000.0 / baseline_ms
    # span-matched baseline: the reference's real [TIME] bracket includes the
    # per-cloud artifact writes (bin + 24+1 PNGs + csv); both sides get their
    # write cost added for the full-span ratio
    baseline_span_ms = measure_baseline(full_span=True)
    baseline_span_cps = 1000.0 / baseline_span_ms
    # headline: the tolerance-compat production path (the measured throughput
    # mode; <1 px BEV divergence — the north star's acceptance window,
    # BASELINE.json:5).  The bit-exact default mode is reported alongside.
    tol_cps = measure_device(ordered=True, compat="tolerance")
    exact_cps = measure_device(ordered=True, compat="bitexact")
    write_ms = measure_write_ms()
    tol_span_cps = 1000.0 / (1000.0 / tol_cps + write_ms)
    exact_span_cps = 1000.0 / (1000.0 / exact_cps + write_ms)
    # the tool's OWN measured end-to-end span (writes overlapped via
    # AsyncWriter)
    pipe = measure_pipeline_span()
    verify = verify_on_device()
    if details:
        general_cps = measure_device(ordered=False)
        general_tol_cps = measure_device(ordered=False, compat="tolerance")
        hdl32_cps = measure_device(ordered=True, sensor="HDL_32E")
        os1_cps = measure_device(ordered=True, sensor="OS1_64")
        pairs_per_sec, reg_stages = measure_registration(return_stages=True)
        reg_base = measure_registration_baseline()
        reg_base_pps = 1000.0 / reg_base["ms_per_pair"]
        with open(os.path.join(REPO, "bench_details.json"), "w") as f:
            json.dump(
                {
                    "hdl64e_multibev_clouds_per_sec_tolerance": round(tol_cps, 3),
                    "hdl64e_multibev_clouds_per_sec_bitexact": round(exact_cps, 3),
                    "hdl64e_multibev_general_path_clouds_per_sec": round(general_cps, 3),
                    "hdl64e_multibev_general_path_clouds_per_sec_tolerance": round(
                        general_tol_cps, 3
                    ),
                    "hdl32e_multibev_clouds_per_sec": round(hdl32_cps, 3),
                    "os1_64_multibev_clouds_per_sec": round(os1_cps, 3),
                    "baseline_single_core_clouds_per_sec": round(baseline_cps, 3),
                    "baseline_ms_per_cloud": baseline_ms,
                    "baseline_full_span_clouds_per_sec": round(
                        baseline_span_cps, 3
                    ),
                    "baseline_full_span_ms_per_cloud": baseline_span_ms,
                    "pctpu_bev_write_ms_per_cloud": round(write_ms, 3),
                    "full_span_clouds_per_sec_tolerance": round(tol_span_cps, 3),
                    "full_span_clouds_per_sec_bitexact": round(
                        exact_span_cps, 3
                    ),
                    "vs_baseline_full_span": round(
                        tol_span_cps / baseline_span_cps, 3
                    ),
                    "vs_baseline_full_span_bitexact": round(
                        exact_span_cps / baseline_span_cps, 3
                    ),
                    "registration_pairs_per_sec_65k": round(pairs_per_sec, 3),
                    "registration_stage_wall_ms_per_pair": reg_stages,
                    "registration_baseline_single_core_pairs_per_sec": round(
                        reg_base_pps, 3
                    ),
                    "registration_baseline_ms_per_pair": reg_base["ms_per_pair"],
                    "registration_baseline_stage_ms": {
                        "coarse": reg_base["coarse_ms"],
                        "fine": reg_base["fine_ms"],
                    },
                    "registration_vs_baseline": round(
                        pairs_per_sec / reg_base_pps, 3
                    ),
                    **pipe,
                    "vs_baseline_interval": _ratio_interval(
                        tol_cps, baseline_ms, BASELINE_HIST_MS
                    ),
                    "vs_baseline_full_span_interval": _ratio_interval(
                        tol_span_cps, baseline_span_ms, BASELINE_SPAN_HIST_MS
                    ),
                    "baseline_ms_spread": [
                        min(baseline_ms, BASELINE_HIST_MS[0]),
                        max(baseline_ms, BASELINE_HIST_MS[1]),
                    ],
                    "utilization": utilization_block(tol_cps, exact_cps),
                    "verify": verify,
                    "device": device,
                },
                f,
                indent=2,
            )
    print(
        json.dumps(
            {
                "metric": "hdl64e_multibev_clouds_per_sec",
                "value": round(tol_cps, 3),
                "unit": "clouds/s",
                "vs_baseline": round(tol_cps / baseline_cps, 3),
                "compat": "tolerance",
                "bitexact_clouds_per_sec": round(exact_cps, 3),
                "bitexact_vs_baseline": round(exact_cps / baseline_cps, 3),
                # span-matched ratio: both sides include the reference's
                # in-[TIME] artifact writes (bin + 24+1 PNGs + csv)
                "full_span_clouds_per_sec": round(tol_span_cps, 3),
                "baseline_full_span_clouds_per_sec": round(
                    baseline_span_cps, 3
                ),
                "vs_baseline_full_span": round(
                    tol_span_cps / baseline_span_cps, 3
                ),
                # ratio error bars over the host's measured baseline spread
                # (session ∪ pinned history; pctpu absolute clouds/s is the
                # stable cross-run number)
                "vs_baseline_interval": _ratio_interval(
                    tol_cps, baseline_ms, BASELINE_HIST_MS
                ),
                "vs_baseline_full_span_interval": _ratio_interval(
                    tol_span_cps, baseline_span_ms, BASELINE_SPAN_HIST_MS
                ),
                # the production tool's own measured end-to-end span
                # (run_multi_bev loop wall: writes overlap device compute)
                "pipeline_full_span_clouds_per_sec": pipe[
                    "pipeline_full_span_clouds_per_sec"
                ],
                "pipeline_write_overlap_hidden_pct": pipe[
                    "pipeline_write_overlap_hidden_pct"
                ],
                "verify": verify,
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
