"""CLI: batch_multi_bev_gen — argv contract of
/root/reference/BatchMultiBevGen.cpp:664-689."""

import sys

from pctpu.cli._common import int_kw, path_kw, split_args, usage_exit
from pctpu.pipelines.multi_bev import run_multi_bev

USAGE = """\
Usage: batch_multi_bev_gen [keyframes_root_dir] [sensor_type]

[keyframes_root_dir] should be organized as follows:
[keyframes_root_dir]
├ keyframe_point_cloud/ <- folder for selected point clouds in pcd format for each frame
├ keyframe_pose.csv <- 6-DoF pose for each frame
└ keyframe_pose_format.csv <- 6-DoF pose format description

[sensor_type] could be HDL_32E, HDL_64E or OS1_64.

This binary generates ground-removed point clouds, single & multi layer BEV
images and creates geometric distance-based labels for each point cloud.

Extensions: --resume  --batch-size=N  --no-pngs  --devices=N (data-parallel mesh)
            --num-processes=N --process-id=K --coordinator=host:port (multi-host:
            each host preprocesses a strided slice of the clouds; host 0 also
            writes keyframe_label.csv)
            --profile=DIR (capture a jax.profiler trace of the run for
            TensorBoard / xprof timeline inspection)
            --compat=bitexact|tolerance (ground-grid accumulation: bit-exact
            C++ rounding sequence (default) vs a one-hot matmul segment-sum,
            <1 px BEV divergence — README divergence D1)
"""


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(USAGE)
    nproc = int_kw(kw, "num_processes", None)
    pid = int_kw(kw, "process_id", None)
    if nproc is not None and nproc > 1 and "coordinator" in kw:
        from pctpu.parallel.distributed import initialize

        initialize(kw["coordinator"], nproc, pid)
    from pctpu.runtime.profiler import trace

    with trace("batch_multi_bev_gen", enabled="profile" in kw,
               trace_dir=path_kw(kw, "profile", "/tmp/pctpu-trace")
               or "/tmp/pctpu-trace"):
        run_multi_bev(
            pos[0],
            pos[1],
            batch_size=int_kw(kw, "batch_size", 8),
            resume=kw.get("resume", "false") == "true",
            write_pngs=kw.get("no_pngs", "false") != "true",
            devices=int_kw(kw, "devices", None),
            process_id=pid,
            num_processes=nproc,
            compat=kw.get("compat", "bitexact"),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
