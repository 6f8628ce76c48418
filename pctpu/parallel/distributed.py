"""Multi-host scaling: process initialization + work partitioning.

The reference has no distributed story (single process, OpenMP commented
out — SURVEY.md §5.8).  pctpu scales the batch axis across hosts with
``jax.distributed`` + GSPMD: every host runs the same pipeline over its slice
of the file list, and aggregate metrics reduce over the global mesh.
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op for single-process runs).

    GPU hosts carry no cluster metadata JAX can read, so multi-process
    runs pass all three: ``coordinator_address`` (``host:port`` of process
    0), ``num_processes`` and this process's ``process_id``.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_shard(items: list, process_id: int | None = None,
                  num_processes: int | None = None) -> list:
    """Deterministic strided partition of a work list across hosts.

    Strided (not blocked) so per-host load stays balanced when consecutive
    clouds have similar point counts.
    """
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return items[pid::n]


def global_mesh(n_points: int = 1):
    """A (data, points) mesh spanning every device of every host."""
    from pctpu.parallel.mesh import make_mesh

    return make_mesh(n_points=n_points)
