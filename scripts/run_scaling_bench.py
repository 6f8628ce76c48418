"""Multi-device scaling harness: measure flagship throughput vs device count.

The HDL-64E preprocess+BEV pipeline is embarrassingly parallel over the
batch axis.  On a host with N GPUs this script runs the production mesh
path (`sharded_preprocess`, zero cross-device collectives) at each requested
device count, reports clouds/s + parallel efficiency, and checks the sharded
outputs stay byte-identical to the single-device run (the
tests/test_sharding.py contract, asserted on the actual hardware).  On
virtual CPU devices (``--cpu N``) it is a functional pass only.

Usage:
  python -m scripts.run_scaling_bench                    # all 2^k <= n_devices
  python -m scripts.run_scaling_bench --device-counts 1,4,8
  python -m scripts.run_scaling_bench --cpu 8            # functional, no perf
  python -m scripts.run_scaling_bench --registration     # also pairs/s scaling

Output: one JSON line per device count + a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_sharded(n_devices: int, compat: str, check_identity: bool,
                    small: bool = False) -> dict:
    """clouds/s with the batch axis sharded over an n_devices 'data' mesh.

    Like bench.measure_device (K distinct batches dispatched back to back,
    timed to ``block_until_ready``, best of 3) with the per-device batch
    held constant at bench.BATCH — weak scaling, the production regime
    (`--devices=N` splits a bigger file list, not a fixed one).
    """
    import jax

    import bench
    from pctpu.config import get_sensor_params
    from pctpu.ops.preprocess import preprocess_batch
    from pctpu.parallel.mesh import make_mesh, shard_cloud_batch

    if small:
        # functional-only geometry for virtual-CPU runs (full-grid CPU
        # compiles take minutes and prove nothing extra)
        from pctpu.config import SensorParams

        params = SensorParams(n_scan=8, horizon_scan=64, ground_upper_scan=6,
                              height_res=0.5)
        n_points = 256
    else:
        params = get_sensor_params("HDL_64E")
        n_points = min(bench.N_POINTS, int(params.grid_size * 0.9))
    mesh = make_mesh(n_data=n_devices, n_points=1)
    global_batch = bench.BATCH * n_devices
    k_stack = 4 if small else bench.K_STACK
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = NamedSharding(mesh, P("data"))
    batches = [
        jax.device_put(
            bench.synth_batch(params, global_batch, n_points, seed,
                              ordered=True), spec)
        for seed in range(k_stack)
    ]
    run = jax.jit(lambda b: preprocess_batch(b, params, assume_ordered=True,
                                             compat=compat))
    jax.block_until_ready([run(b) for b in batches])  # compile + warm
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready([run(b) for b in batches])
        dt = min(dt, time.perf_counter() - t0)
    cps = k_stack * global_batch / dt

    out = {"devices": n_devices, "clouds_per_sec": round(cps, 3),
           "compat": compat, "global_batch": global_batch}

    if check_identity and n_devices > 1:
        # byte-identity vs single-device on ONE batch (no collectives in the
        # kernel, so sharding must not change a single output byte)
        clouds = bench.synth_batch(params, global_batch, n_points, seed=99,
                                   ordered=True)
        ref = jax.jit(
            lambda c: preprocess_batch(c, params, assume_ordered=True,
                                       compat=compat)
        )(clouds)
        sharded_in = shard_cloud_batch(clouds, mesh)
        got = jax.jit(
            lambda c: preprocess_batch(c, params, assume_ordered=True,
                                       compat=compat)
        )(sharded_in)
        same = (
            np.array_equal(np.asarray(got[1]), np.asarray(ref[1]))
            and np.array_equal(np.asarray(got[2]), np.asarray(ref[2]))
            and np.array_equal(np.asarray(got[0].label), np.asarray(ref[0].label))
        )
        out["outputs_byte_identical_to_single_device"] = bool(same)
        if not same:
            out["ERROR"] = "sharded outputs diverge from single-device"
    return out


def measure_registration_sharded(n_devices: int, small: bool = False) -> dict:
    """Registration pairs/s with the pair axis sharded over 'data'
    (the batch_top_part_registration --devices path), per-device pair load
    held constant (weak scaling)."""
    import jax

    import bench
    from pctpu.cloud import make_cloud
    from pctpu.parallel.mesh import make_mesh
    from pctpu.pipelines.registration import register_pairs

    n_clusters, cluster_pts, ng, capacity, flat_cap, per_dev = (
        (6, 80, 1000, 2048, 2048, 2) if small else (40, 150, 45000, 65536, 32768, 16)
    )
    rng = np.random.default_rng(0)
    pts, labels = [], []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-60, 60, 2)
        n = cluster_pts
        pts.append(np.stack([cx + rng.normal(0, 2.5, n),
                             cy + rng.normal(0, 2.5, n),
                             rng.uniform(0, 9, n)], 1))
        labels.append(np.full(n, -2))
    pts.append(np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                         rng.uniform(-2.0, -1.9, ng)], 1))
    labels.append(np.zeros(ng))
    xyz = np.concatenate(pts).astype(np.float32)
    lab = np.concatenate(labels).astype(np.int32)
    th = np.radians(17.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]], np.float32)
    xyz2 = xyz @ rot.T + np.array([1.5, -2.0, 0], np.float32)
    c1 = jax.device_put(make_cloud(xyz, label=lab, capacity=capacity))
    c2 = jax.device_put(make_cloud(xyz2, label=lab, capacity=capacity))

    mesh = make_mesh(n_data=n_devices, n_points=1) if n_devices > 1 else None
    n_pairs = per_dev * n_devices

    def batch(off):  # distinct pairs: each source shifted by its own offset
        return [
            (c1.replace(xyz=c1.xyz + (off + i) * 1e-4), c2, 17.0)
            for i in range(n_pairs)
        ]

    register_pairs(batch(1), flat_cap=flat_cap, mesh=mesh)  # compile
    built = [batch(100 + n_pairs * i) for i in range(2)]
    t0 = time.perf_counter()
    for b in built:
        register_pairs(b, flat_cap=flat_cap, mesh=mesh)
    pps = len(built) * n_pairs / (time.perf_counter() - t0)
    return {"devices": n_devices, "registration_pairs_per_sec": round(pps, 3),
            "pair_batch": n_pairs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-counts", type=str, default=None,
                    help="comma-separated device counts (default: 2^k <= N)")
    ap.add_argument("--cpu", type=int, default=0,
                    help="force N virtual CPU devices (functional check only)")
    ap.add_argument("--compat", default="tolerance",
                    choices=("bitexact", "tolerance"))
    ap.add_argument("--registration", action="store_true",
                    help="also measure registration pairs/s scaling")
    ap.add_argument("--no-identity-check", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny sensor geometry (functional-only runs)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)
    n_avail = len(jax.devices())
    if args.device_counts:
        counts = [int(c) for c in args.device_counts.split(",")]
    else:
        counts = [1]
        while counts[-1] * 2 <= n_avail:
            counts.append(counts[-1] * 2)
    bad = [c for c in counts if c > n_avail]
    if bad:
        print(f"requested {bad} devices but only {n_avail} available",
              file=sys.stderr)
        return 1
    perf_meaningful = jax.devices()[0].platform == "gpu"
    if not perf_meaningful:
        print("# CPU backend: numbers are functional-only, not a scaling "
              "claim", flush=True)

    results = []
    for c in counts:
        r = measure_sharded(c, args.compat, not args.no_identity_check,
                            small=args.small or bool(args.cpu))
        if args.registration:
            r.update(
                measure_registration_sharded(
                    c, small=args.small or bool(args.cpu)
                )
            )
        results.append(r)
        print(json.dumps(r), flush=True)

    base = results[0]["clouds_per_sec"] / results[0]["devices"]
    summary = {
        "backend": jax.default_backend(),
        "scaling": [
            {
                "devices": r["devices"],
                "clouds_per_sec": r["clouds_per_sec"],
                "efficiency_vs_1dev": round(
                    r["clouds_per_sec"] / (base * r["devices"]), 3
                ),
            }
            for r in results
        ],
    }
    print(json.dumps(summary), flush=True)
    return 1 if any("ERROR" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
