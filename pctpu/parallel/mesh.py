"""Device-mesh utilities: data-parallel batch sharding + point-sharded NN.

The reference is single-process single-thread (SURVEY.md §5.8); pctpu's
scaling story is:

  * **data parallelism** over the cloud-batch axis for the preprocessing/BEV
    pipelines — embarrassingly parallel, zero collectives in the hot path;
  * **point-axis sharding** (the sequence-parallel analogue, SURVEY.md §5.7)
    for the registration correspondence search, where the (S, T) distance
    problem is split over target points and reduced with a min-collective;
  * ``psum`` reductions for aggregate metrics only.

All helpers take an explicit ``jax.sharding.Mesh`` so the same code runs on
one GPU, the GPUs of one host, or the CPU-device test mesh.  The mesh is a
plain (data, points) reshape of the device list: every GPU of a host reaches
every other at the same rate, so no device order is preferred.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pctpu.cloud import Cloud


def make_mesh(n_data: int | None = None, n_points: int = 1, devices=None) -> Mesh:
    """A (data, points) mesh.  Defaults to all devices on the data axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_points
    devices = devices[: n_data * n_points].reshape(n_data, n_points)
    return Mesh(devices, ("data", "points"))


def shard_cloud_batch(clouds: Cloud, mesh: Mesh) -> Cloud:
    """Place a batched Cloud with its leading axis split over 'data'."""
    sharding = NamedSharding(mesh, P("data"))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(put, clouds)


def sharded_preprocess(mesh: Mesh, params, ground_cfg, multi_cfg, single_cfg):
    """A pjit'd batched preprocess whose batch axis is split over 'data'.

    Returns a callable Cloud(batch) → (labeled, multi_bev, single_bev), with
    inputs/outputs sharded over the mesh — XLA partitions the whole fused
    kernel with zero cross-chip communication.
    """
    from pctpu.ops.preprocess import preprocess_batch

    batch_spec = NamedSharding(mesh, P("data"))

    @jax.jit
    def run(clouds: Cloud):
        # constrain the batch axis onto 'data'; XLA keeps the whole fused
        # kernel shard-local (no collectives)
        clouds = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, batch_spec), clouds
        )
        return preprocess_batch(clouds, params, ground_cfg, multi_cfg, single_cfg)

    return run


def sharded_nn_1(mesh: Mesh, tile: int = 512):
    """1-NN with the *target* cloud sharded over the 'points' axis.

    Each shard scans its slice of the target, then the global best is
    reduced by gathering per-shard (distance, index) pairs — one tiny
    all-gather over ICI instead of moving the clouds.
    """
    from jax import shard_map

    from pctpu.ops.knn import nn_1

    n_shards = mesh.shape["points"]

    def local(query, qmask, tgt_shard, tmask_shard):
        idx, d2 = nn_1(query, qmask, tgt_shard, tmask_shard, tile=tile)
        shard_id = jax.lax.axis_index("points")
        t_per = tgt_shard.shape[0]
        global_idx = idx + shard_id * t_per
        # gather per-shard candidates and reduce to the global argmin
        all_d2 = jax.lax.all_gather(d2, "points")  # (n_shards, Q)
        all_idx = jax.lax.all_gather(global_idx, "points")
        best = jnp.argmin(all_d2, axis=0)
        q = jnp.arange(d2.shape[0])
        return all_idx[best, q], all_d2[best, q]

    fn = jax.jit(shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P("points"), P("points")),
        out_specs=(P(), P()),
        check_vma=False,
    ))

    def run(query, qmask, target, tmask):
        if target.shape[0] % n_shards:
            raise ValueError(
                f"the 'points' axis ({n_shards}) must divide the target "
                f"length ({target.shape[0]}) — pad the cloud to a multiple"
            )
        return fn(query, qmask, target, tmask)

    return run


def psum_metrics(mesh: Mesh):
    """Aggregate per-shard scalar metrics (sums) across the mesh's data axis.

    The input is sharded over 'data' only (in_specs), so it is REPLICATED
    along 'points' — psum'ing over 'points' too would multiply the total by
    n_points (each points-shard holds an identical copy).  Returns the
    scalar grand total (within-shard sum + cross-shard psum)."""
    from jax import shard_map

    def local(x):
        return jax.lax.psum(jnp.sum(x), "data")

    return jax.jit(
        shard_map(
            local, mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False
        )
    )
