"""batch_cloud_manip: float max-height BEV for every keyframe cloud.

Reference: /root/reference/BatchCloudManip.cpp:269-335.  HDL-64E constants
are hardcoded there (N_SCAN 64, Horizon 2083, groundScanInd 50, :11-14,85);
outputs one ``output_bvm/<short>.csv`` + ``<short>.png`` (ground-filtered
201×201 float BEV, saveAsMat :201-239) and the labeled ordered cloud in
``non_ground_point_cloud/``.
"""

from __future__ import annotations

import functools
import os

import jax
import numpy as np

from pctpu.cloud import Cloud
from pctpu.config import FloatBevConfig, GroundConfig, SensorParams
from pctpu.io.csvfmt import write_csv
from pctpu.io.pcd import write_pcd
from pctpu.io.png import write_gray_png
from pctpu.ops.bev import float_bev
from pctpu.ops.ground import mark_ground
from pctpu.ops.ordering import get_ordered_cloud
from pctpu.runtime.loader import (
    batched_prefetch,
    list_pcd_files,
    load_xyzirct_arrays,
    stack_batch,
)
from pctpu.pipelines.multi_bev import _short_name as _short
from pctpu.runtime.profiler import StageTimer
from pctpu.utils import logging as log

HDL64E = SensorParams(n_scan=64, horizon_scan=2083, ground_upper_scan=50, height_res=0.25)


@functools.partial(
    jax.jit, static_argnames=("params", "ground_cfg", "bev_cfg", "compat")
)
def _process_batch(arrays: dict, params, ground_cfg, bev_cfg,
                   compat: str = "bitexact"):
    """Takes the loader's narrow-width SoA dict and widens on device — one
    dispatch for the whole batch instead of one eager dispatch per field."""
    import jax.numpy as jnp

    clouds = Cloud(
        xyz=arrays["xyz"],
        intensity=arrays["intensity"],
        row=arrays["row"].astype(jnp.int32),
        col=arrays["col"].astype(jnp.int32),
        t=arrays["t"],
        label=arrays["label"].astype(jnp.int32),
        count=arrays["count"],
    )

    def one(c):
        ordered = get_ordered_cloud(c, params)
        labeled, _ = mark_ground(ordered, params, ground_cfg, compat=compat)
        return labeled, float_bev(labeled, bev_cfg)

    return jax.vmap(one)(clouds)


def run_batch_cloud_manip(
    keyframes_root_dir: str, batch_size: int = 8, resume: bool = False,
    compat: str = "bitexact",
) -> float:
    """Returns average preprocessing+BEV milliseconds per cloud.

    ``compat="tolerance"``: one-hot matmul segment-sum ground grid (see
    pctpu.ops.ground)."""
    root = keyframes_root_dir.rstrip("/") + "/"
    in_dir = root + "keyframe_point_cloud/"
    non_ground_dir = root + "non_ground_point_cloud/"
    bvm_dir = root + "output_bvm/"
    params = HDL64E
    ground_cfg = GroundConfig()
    bev_cfg = FloatBevConfig(filter_ground=True)

    import shutil

    for d in (non_ground_dir, bvm_dir):
        if os.path.isdir(d) and not resume:
            shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)

    files = list_pcd_files(in_dir)
    if resume:
        # key on the last-written artifact (the labeled pcd) so a crash
        # mid-cloud re-runs it rather than dropping the later outputs
        files = [
            f for f in files
            if not os.path.exists(non_ground_dir + _short(f) + ".pcd")
        ]

    timer = StageTimer()
    if files:
        loader = batched_prefetch(
            files, batch_size, lambda f: load_xyzirct_arrays(f, params.grid_size)
        )
        for names, payloads in loader:
            arrays = stack_batch(payloads)
            with timer.stage("bev", items=sum(1 for n in names if n)):
                labeled, bevs = _process_batch(arrays, params, ground_cfg,
                                               bev_cfg, compat=compat)
                labeled_h, bevs_h = jax.device_get((labeled, bevs))
                for bi, name in enumerate(names):
                    if name is None:
                        continue
                    short = _short(name)
                    log.info(f"Converting file: {short}")
                    write_csv(bvm_dir + short + ".csv", bevs_h[bi])
                    write_gray_png(bvm_dir + short + ".png", bevs_h[bi])
                    xyz = np.asarray(labeled_h.xyz[bi])
                    write_pcd(
                        non_ground_dir + short + ".pcd",
                        {
                            "x": xyz[:, 0],
                            "y": xyz[:, 1],
                            "z": xyz[:, 2],
                            "intensity": np.asarray(labeled_h.intensity[bi]),
                            "row": np.asarray(labeled_h.row[bi]).astype(np.uint16),
                            "col": np.asarray(labeled_h.col[bi]).astype(np.uint16),
                            "t": np.asarray(labeled_h.t[bi]),
                            "label": np.asarray(labeled_h.label[bi]).astype(np.int16),
                        },
                    )

    avg = timer.average_ms("bev")
    log.info(timer.report_average("bev",
                                  "Average preprocessing and BEV generation"))
    log.info("Done. ")
    return avg
