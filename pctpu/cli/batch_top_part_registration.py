"""CLI: batch_top_part_registration — argv contract of
/root/reference/BatchTopPartRegistration.cpp:311-321
(``batch_top_part_registration <match_result.txt> <point_cloud_dir>``)."""

import sys

from pctpu.cli._common import int_kw, split_args, usage_exit
from pctpu.pipelines.registration import run_batch_top_part_registration


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(
            "Usage: batch_top_part_registration <match_result.txt> <point_cloud_dir>\n"
            "Extensions: --pair-batch=N (vmapped pair batching; default 16\n"
            "            on a GPU, 1 on the CPU)  --devices=N\n"
            "            (data-parallel mesh)  --capacity=N  --flat-cap=N\n"
            "            --report=PATH  --resume (skip pairs already in\n"
            "            <report>.progress)  --num-processes=N --process-id=K\n"
            "            --coordinator=host:port"
        )
    nproc = int_kw(kw, "num_processes", None)
    pid = int_kw(kw, "process_id", None)
    if nproc is not None and nproc > 1 and "coordinator" in kw:
        from pctpu.parallel.distributed import initialize

        initialize(kw["coordinator"], nproc, pid)
    run_batch_top_part_registration(
        pos[0],
        pos[1],
        report_path=kw.get("report", "./icp_precision_report.txt"),
        flat_cap=int_kw(kw, "flat_cap", 32768),
        capacity=int_kw(kw, "capacity", None),
        pair_batch=int_kw(kw, "pair_batch", None),
        devices=int_kw(kw, "devices", None),
        process_id=pid,
        num_processes=nproc,
        resume=kw.get("resume", "false") == "true",
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
