"""Time each hand-written Pallas kernel against the plain XLA version it
replaces, on the GPU, at the widths the pipelines run, and check that the
two agree.

    python scripts/kernel_timing.py [--quick] [--out=FILE]

* fine-stage NN: ``pallas_nn_1_pruned`` against ``ops.knn.nn_1`` on a
  49k x 49k spatially sorted scene, thresholded (1 m, the correspondence
  search) and not (the fitness pass), alone and vmapped over 16 pairs; then
  a sweep of tile sizes and warps;
* in-order segment fold (``ops/segment.py``) against a scatter-add: the
  bit-exact ground-sector sums of 8 HDL-64E clouds and the voxel sums of
  32 65k-point clouds, each checked against a sequential numpy fold, and
  the scatter re-run to see whether its sums change from run to run;
* end to end: the 16-pair registration step with either NN, and the
  bit-exact multi-BEV batch with either sum, in turns (A B B A).

``--quick`` skips the tile sweep.  Prints one JSON object per line;
``--out`` also writes them to a file.  Needs a GPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RESULTS: list[dict] = []
NN_POINTS = 49_000
PAIRS = 16
BEV_BATCH = 8
VOXEL_CLOUDS = 32


def emit(**rec):
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def timed_ms(fn, *args, reps: int = 10) -> float:
    """Median wall ms of ``fn(*args)`` to completion, after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


@contextlib.contextmanager
def platform_override(**fields):
    """Run with some of the GPU platform choices replaced (and every jit
    cache dropped on entry and exit, so traces pick the change up)."""
    import dataclasses

    import jax

    from pctpu.runtime import platform

    saved = platform._CHOICES["gpu"]
    platform._CHOICES["gpu"] = dataclasses.replace(saved, **fields)
    jax.clear_caches()
    try:
        yield
    finally:
        platform._CHOICES["gpu"] = saved
        jax.clear_caches()


def nn_scene(n: int = NN_POINTS, seed: int = 7):
    import jax.numpy as jnp

    from pctpu.ops.pallas_knn import spatial_sort

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-70, 70, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 8, n).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    q, qm, _ = spatial_sort(jnp.asarray(pts), jnp.ones(n, bool))
    t, tm, _ = spatial_sort(jnp.asarray(tgt), jnp.ones(n, bool))
    return q, qm, t, tm


def nn_phase(quick: bool):
    import functools

    import jax
    import jax.numpy as jnp

    from pctpu.ops.knn import nn_1_jit
    from pctpu.ops.pallas_knn import check_against_nn_1, pallas_nn_1_pruned

    q, qm, t, tm = nn_scene()
    ref = jax.device_get(nn_1_jit(q, qm, t, tm))
    for md in (1.0, None):
        got = jax.device_get(pallas_nn_1_pruned(q, qm, t, tm, max_distance=md))
        swaps = check_against_nn_1(t, ref, got, max_distance=md)
        emit(phase="nn_check", n=int(q.shape[0]), max_distance=md, swaps=swaps)

    # 16 pairs, as the registration stages vmap it: the pairs differ by a
    # shift so no two rows are the same problem
    shift = jnp.arange(PAIRS, dtype=jnp.float32)[:, None, None] * 1e-3
    qb = q[None] + shift
    tb = jnp.broadcast_to(t, (PAIRS,) + t.shape)
    qmb = jnp.broadcast_to(qm, (PAIRS,) + qm.shape)
    tmb = jnp.broadcast_to(tm, (PAIRS,) + tm.shape)
    xla_b = jax.jit(jax.vmap(nn_1_jit))
    ref_b = jax.device_get(xla_b(qb, qmb, tb, tmb))
    for md in (1.0, None):
        kern_b = jax.jit(jax.vmap(functools.partial(
            pallas_nn_1_pruned, max_distance=md)))
        got_b = jax.device_get(kern_b(qb, qmb, tb, tmb))
        for k in (0, PAIRS - 1):
            check_against_nn_1(t, (ref_b[0][k], ref_b[1][k]),
                               (got_b[0][k], got_b[1][k]), max_distance=md)
        emit(phase="nn_time", pairs=PAIRS, max_distance=md, config="default",
             kernel_ms=timed_ms(kern_b, qb, qmb, tb, tmb),
             xla_nn_1_ms=timed_ms(xla_b, qb, qmb, tb, tmb))
    emit(phase="nn_time", pairs=1, max_distance=None, config="default",
         kernel_ms=timed_ms(functools.partial(pallas_nn_1_pruned,
                                              max_distance=None), q, qm, t, tm),
         xla_nn_1_ms=timed_ms(nn_1_jit, q, qm, t, tm))
    if quick:
        return
    for tq in (32, 64, 128, 256):
        for tt in (32, 64, 128):
            for nw in (2, 4, 8):
                row = {}
                for md in (1.0, None):
                    f = jax.jit(jax.vmap(functools.partial(
                        pallas_nn_1_pruned, max_distance=md, tq=tq, tt=tt,
                        num_warps=nw)))
                    try:
                        got = jax.device_get(f(qb, qmb, tb, tmb))
                        check_against_nn_1(t, (ref_b[0][0], ref_b[1][0]),
                                           (got[0][0], got[1][0]),
                                           max_distance=md)
                        row["thr" if md else "fit"] = timed_ms(
                            f, qb, qmb, tb, tmb, reps=5)
                    except Exception as e:  # a config the compiler refuses
                        row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                        break
                emit(phase="nn_sweep", pairs=PAIRS, tq=tq, tt=tt, num_warps=nw,
                     **row)


def ground_inputs(batch: int = BEV_BATCH, seed: int = 3):
    """The bit-exact ground-sum inputs of ``batch`` HDL-64E clouds: (sector,
    z, ground) over the swept band, as ``mark_ground`` builds them."""
    import jax
    import jax.numpy as jnp

    from bench import synth_batch
    from pctpu.config import GroundConfig, get_sensor_params
    from pctpu.ops.ground import _belonging_grid, mark_ground

    params = get_sensor_params("HDL_64E")
    cfg = GroundConfig()
    clouds = synth_batch(params, batch, 120_000, seed, ordered=True)
    _, mark = jax.jit(jax.vmap(lambda c: mark_ground(c, params, cfg)))(clouds)
    lo0 = (params.n_scan - params.ground_upper_scan - 1) * params.horizon_scan
    xyz = clouds.xyz[:, lo0:]
    ground = mark.reshape(batch, -1)[:, lo0:] == 1
    srow, scol = jax.vmap(lambda x, y: _belonging_grid(x, y, cfg))(
        xyz[..., 0], xyz[..., 1])
    return srow * cfg.grid_cols + scol, xyz[..., 2], ground, cfg


def sequential_fold(ids, vals, nseg):
    """numpy reference: ``np.add.at`` adds in index order, in f32."""
    acc = np.zeros((nseg + 1,) + vals.shape[1:], np.float32)
    np.add.at(acc, ids, vals.astype(np.float32))
    return acc[:nseg]


def fold_phase():
    import jax
    import jax.numpy as jnp

    from pctpu.ops.ground import _grid_sums_bitexact
    from pctpu.ops.segment import _fold_pallas
    from pctpu.ops.voxel import voxel_downsample

    def scatter(values, ids, nseg):
        acc = jnp.zeros((nseg + 1, values.shape[1]), jnp.float32)
        return acc.at[ids].add(values)[:nseg]

    # --- ground sectors, 8 HDL-64E clouds --------------------------------
    sector, z, ground, cfg = ground_inputs()
    nsec = cfg.grid_rows * cfg.grid_cols
    ids, zs = jax.jit(jax.vmap(lambda s, zz, g: jax.lax.sort(
        [jnp.where(g & (zz != 0.0), s, nsec), zz], num_keys=1,
        is_stable=True)))(sector, z, ground)
    ids_np, zs_np = np.asarray(ids), np.asarray(zs)
    ref = np.stack([sequential_fold(ids_np[b], zs_np[b][:, None], nsec)
                    for b in range(ids_np.shape[0])])
    kern = jax.jit(jax.vmap(lambda v, i: _fold_pallas(v, i, nsec)))
    scat = jax.jit(jax.vmap(lambda v, i: scatter(v, i, nsec)))
    vals = zs[..., None]
    got_k = np.asarray(kern(vals, ids))
    scat_runs = [np.asarray(scat(vals, ids)) for _ in range(5)]
    emit(
        phase="fold_ground", clouds=int(ids_np.shape[0]),
        points_per_cloud=int(ids_np.shape[1]),
        folded_points=int((ids_np < nsec).sum()),
        max_run=int(max(np.bincount(r[r < nsec]).max() for r in ids_np)),
        kernel_equals_sequential=bool(np.array_equal(got_k, ref)),
        scatter_sectors_differing=int(sum(
            (r != ref).any(-1).sum() for r in scat_runs[:1])),
        scatter_distinct_runs=len({r.tobytes() for r in scat_runs}),
        kernel_ms=timed_ms(kern, vals, ids),
        scatter_ms=timed_ms(scat, vals, ids),
    )
    assert np.array_equal(got_k, ref), "ground fold kernel != sequential fold"
    # the whole bit-exact sum stage, as mark_ground runs it
    stage = jax.jit(jax.vmap(lambda s, zz, g: _grid_sums_bitexact(
        s, zz, g, cfg)))
    emit(phase="ground_sums_stage", clouds=int(ids_np.shape[0]),
         kernel_path_ms=timed_ms(stage, sector, z, ground))
    with platform_override(ordered_sum="scatter"):
        stage = jax.jit(jax.vmap(lambda s, zz, g: _grid_sums_bitexact(
            s, zz, g, cfg)))
        emit(phase="ground_sums_stage", clouds=int(ids_np.shape[0]),
             scatter_path_ms=timed_ms(stage, sector, z, ground))

    # --- voxel sums, 32 clouds of 65k points at the 0.2 m leaf ------------
    from chip_smoke import CAPACITY as cap
    from chip_smoke import registration_scene

    clouds = [registration_scene(s)[0] for s in range(VOXEL_CLOUDS)]
    xyz = np.zeros((VOXEL_CLOUDS, cap, 3), np.float32)
    mask = np.zeros((VOXEL_CLOUDS, cap), bool)
    for k, c in enumerate(clouds):
        xyz[k, : len(c)] = c
        mask[k, : len(c)] = True
    xyz, mask = jnp.asarray(xyz), jnp.asarray(mask)
    vox = jax.jit(jax.vmap(lambda x, m: voxel_downsample(x, m, 0.2)))
    runs_k = [jax.device_get(vox(xyz, mask))[0] for _ in range(5)]
    out_k = jax.device_get(vox(xyz, mask))
    t_kernel = timed_ms(vox, xyz, mask)
    with platform_override(ordered_sum="scatter"):
        vox = jax.jit(jax.vmap(lambda x, m: voxel_downsample(x, m, 0.2)))
        runs = [jax.device_get(vox(xyz, mask))[0] for _ in range(5)]
        t_scatter = timed_ms(vox, xyz, mask)
    with jax.default_device(jax.devices("cpu")[0]):
        with platform_override(ordered_sum="scatter"):
            ref = jax.device_get(jax.jit(jax.vmap(
                lambda x, m: voxel_downsample(x, m, 0.2)))(
                    np.asarray(xyz[:4]), np.asarray(mask[:4])))[0]
    got = np.asarray(out_k[0][:4])
    emit(
        phase="fold_voxel", clouds=VOXEL_CLOUDS, capacity=cap,
        voxels=int(np.asarray(out_k[2]).sum()),
        kernel_distinct_runs=len({r.tobytes() for r in runs_k}),
        scatter_distinct_runs=len({r.tobytes() for r in runs}),
        kernel_centroids_differing_from_cpu=int((got != ref).any(-1).sum()),
        kernel_max_abs_diff_from_cpu=float(np.abs(got - ref).max()),
        scatter_centroids_differing_from_cpu=int(
            (runs[0][:4] != ref).any(-1).sum()),
        kernel_path_ms=t_kernel, scatter_path_ms=t_scatter,
    )
    assert len({r.tobytes() for r in runs_k}) == 1, "voxel kernel path varies"


def e2e_phase():
    """The 16-pair registration step with either NN, and the bit-exact
    multi-BEV batch with either sum, in turns (A B B A)."""
    import jax

    from bench import synth_batch
    from chip_smoke import registration_pairs
    from pctpu.config import RegistrationConfig, get_sensor_params
    from pctpu.ops.preprocess import preprocess_batch
    from pctpu.pipelines.registration import register_pairs

    pairs = [(c1, c2, g) for c1, c2, g, _ in registration_pairs(16, seed=0)]
    cfg = RegistrationConfig()

    def reg_step():
        return register_pairs(pairs, cfg, flat_cap=32768)

    for nn in ("pruned", "xla", "xla", "pruned"):
        with platform_override(nn_impl=nn):
            reg_step()  # compile
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                reg_step()  # returns host arrays: ends after the device
                ts.append(time.perf_counter() - t0)
            emit(phase="e2e_registration", nn_impl=nn, pairs=16,
                 step_s=statistics.median(ts),
                 pairs_per_s=16 / statistics.median(ts))

    params = get_sensor_params("HDL_64E")
    batch = synth_batch(params, 8, 120_000, 5, ordered=True)
    for how in ("kernel", "scatter", "scatter", "kernel"):
        with platform_override(ordered_sum=how):
            f = jax.jit(lambda b: preprocess_batch(
                b, params, assume_ordered=True, compat="bitexact"))
            emit(phase="e2e_bev_batch", ordered_sum=how, clouds=8,
                 batch_ms=timed_ms(f, batch))
    with platform_override(ordered_sum="kernel"):
        f = jax.jit(lambda b: preprocess_batch(
            b, params, assume_ordered=True, compat="tolerance"))
        emit(phase="e2e_bev_batch", compat="tolerance", clouds=8,
             batch_ms=timed_ms(f, batch))


def main(argv: list[str]) -> int:
    import jax

    from pctpu.runtime.platform import enable_compile_cache

    enable_compile_cache()
    quick = "--quick" in argv
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    emit(phase="device", kind=dev.device_kind, count=len(jax.devices()),
         nvidia_smi=smi)
    nn_phase(quick)
    fold_phase()
    e2e_phase()
    out = next((a.split("=", 1)[1] for a in argv if a.startswith("--out=")),
               None)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in RESULTS)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
