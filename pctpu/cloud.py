"""Point-cloud data model: a structure-of-arrays pytree.

The reference stores clouds as arrays of a packed ``pcl::PointXYZIRCT`` struct
(x, y, z, intensity, row, col, t, label — see
/root/reference/BatchMultiBevGen.h:44-66).  An array-of-structs is the wrong
layout for a vector machine; here a cloud is a structure of arrays so every
field is one contiguous device array, and the whole cloud is a JAX pytree that
can be jitted, vmapped and sharded directly.

Label conventions preserved from the reference:
  * ``-2`` — not yet segmented (/root/reference/KittiPointCloudSelect.cpp:237)
  * ``0``  — ground (/root/reference/BatchMultiBevGen.cpp:245); note that
    never-hit cells of an ordered cloud are zero-initialised, so their label
    is also 0.

Clouds carry a fixed (static) point capacity; ``count`` records how many
leading points are real.  Ordered (range-image) clouds have capacity
``n_scan * horizon_scan`` and *every* slot is semantically meaningful — empty
cells are all-zero points, exactly like the default-constructed PCL points in
the reference (/root/reference/BatchMultiBevGen.cpp:98 resize).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

LABEL_UNSEGMENTED = -2
LABEL_GROUND = 0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cloud:
    """A fixed-capacity point cloud as a structure of arrays.

    Attributes:
      xyz:       (N, 3) float32 positions.
      intensity: (N,)   float32.
      row:       (N,)   int32 ring index.
      col:       (N,)   int32 azimuth bin index.
      t:         (N,)   uint32 per-point time.
      label:     (N,)   int32 segmentation label.
      count:     ()     int32 — number of real points (leading slots).
                 For dense ordered clouds count == N.
    """

    xyz: jax.Array
    intensity: jax.Array
    row: jax.Array
    col: jax.Array
    t: jax.Array
    label: jax.Array
    count: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def x(self) -> jax.Array:
        return self.xyz[..., 0]

    @property
    def y(self) -> jax.Array:
        return self.xyz[..., 1]

    @property
    def z(self) -> jax.Array:
        return self.xyz[..., 2]

    def valid_mask(self) -> jax.Array:
        """Boolean mask of real (non-padding) points.

        Supports leading batch axes like the x/y/z properties: count's
        batch dims broadcast against the point axis."""
        n = self.xyz.shape[-2]
        idx = jnp.arange(n)
        return idx < jnp.asarray(self.count)[..., None]

    def replace(self, **kwargs: Any) -> "Cloud":
        return dataclasses.replace(self, **kwargs)


def make_cloud(
    xyz: np.ndarray | jax.Array,
    intensity: np.ndarray | jax.Array | None = None,
    row: np.ndarray | jax.Array | None = None,
    col: np.ndarray | jax.Array | None = None,
    t: np.ndarray | jax.Array | None = None,
    label: np.ndarray | jax.Array | None = None,
    count: int | jax.Array | None = None,
    capacity: int | None = None,
) -> Cloud:
    """Build a Cloud, zero-padding every field up to ``capacity``.

    Padding slots are all-zero, matching default-constructed PCL points.
    """
    xyz = jnp.asarray(xyz, jnp.float32)
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")

    def _field(v, dtype):
        if v is None:
            v = jnp.zeros((n,), dtype)
        v = jnp.asarray(v, dtype)
        if v.shape[0] != n:
            raise ValueError(f"field length {v.shape[0]} != xyz length {n}")
        return jnp.pad(v, (0, capacity - n))

    xyz = jnp.pad(xyz, ((0, capacity - n), (0, 0)))
    return Cloud(
        xyz=xyz,
        intensity=_field(intensity, jnp.float32),
        row=_field(row, jnp.int32),
        col=_field(col, jnp.int32),
        t=_field(t, jnp.uint32),
        label=_field(label, jnp.int32),
        count=jnp.asarray(n if count is None else count, jnp.int32),
    )


def empty_cloud(capacity: int) -> Cloud:
    """An all-zero cloud of the given capacity (count = capacity).

    Mirrors ``output_cloud->resize(N_SCAN * Horizon_SCAN)`` in
    /root/reference/BatchMultiBevGen.cpp:98: every slot exists and is
    default-constructed (all fields zero).
    """
    return Cloud(
        xyz=jnp.zeros((capacity, 3), jnp.float32),
        intensity=jnp.zeros((capacity,), jnp.float32),
        row=jnp.zeros((capacity,), jnp.int32),
        col=jnp.zeros((capacity,), jnp.int32),
        t=jnp.zeros((capacity,), jnp.uint32),
        label=jnp.zeros((capacity,), jnp.int32),
        count=jnp.asarray(capacity, jnp.int32),
    )


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack equally-sized clouds along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *clouds)


def to_numpy(cloud: Cloud) -> dict[str, np.ndarray]:
    """Device → host transfer of all fields as a dict of numpy arrays."""
    return {
        "xyz": np.asarray(cloud.xyz),
        "intensity": np.asarray(cloud.intensity),
        "row": np.asarray(cloud.row),
        "col": np.asarray(cloud.col),
        "t": np.asarray(cloud.t),
        "label": np.asarray(cloud.label),
        "count": int(cloud.count),
    }
