"""pctpu — a JAX/XLA/Pallas LiDAR point-cloud preprocessing framework with
the capabilities of soytony/Point-Cloud-Preprocessing-Tools.

Layers (see SURVEY.md §7):
  pctpu.cloud / pctpu.config    data model + typed configuration
  pctpu.geom                    SE(3) with reference euler/slerp semantics
  pctpu.io                      pcd/bin/csv/png, dataset ingest (host side)
  pctpu.ops                     jit-able kernels on fixed-size point batches
  pctpu.pipelines               batch drivers (host loop ↔ device kernels)
  pctpu.parallel                mesh/sharding utilities (pjit/shard_map)
  pctpu.runtime                 loaders, writers, profiling
  pctpu.cli                     the ten reference-compatible entry points
"""

from pctpu.cloud import Cloud, make_cloud
from pctpu.config import (
    GroundConfig,
    MultiBevConfig,
    RegistrationConfig,
    SensorParams,
    SingleBevConfig,
    get_sensor_params,
    parse_sensor_type,
)


def __getattr__(name):
    # the pcl_norm_2d library facades (heavy imports deferred)
    if name == "Normal2dEstimation":
        from pctpu.ops.normals2d import Normal2dEstimation

        return Normal2dEstimation
    if name == "PCA2D":
        from pctpu.ops.pca2d import PCA2D

        return PCA2D
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "Cloud",
    "make_cloud",
    "GroundConfig",
    "MultiBevConfig",
    "RegistrationConfig",
    "SensorParams",
    "SingleBevConfig",
    "get_sensor_params",
    "parse_sensor_type",
    "Normal2dEstimation",
    "PCA2D",
]
