"""The flagship pipeline: batch multi/single BEV generation + labels.

Reference driver: /root/reference/BatchMultiBevGen.cpp:664-771.  Directory
contract (inputs ``keyframe_point_cloud/`` + ``keyframe_pose.csv``; outputs
``non_ground_point_cloud/``, ``output_multi_bev/{binary,image}/``,
``output_single_bev/{csv,image}/``, ``keyframe_label.csv``) is preserved
exactly, including the per-layer PNG naming ``image/<idx>/%02d.png``.

Design: the per-cloud C++ loop becomes host prefetch → one jitted batched
kernel (ordering + ground + both BEVs fused) → host writeback, with the
batch axis optionally sharded over a device mesh (pure data parallelism).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil

import jax
import numpy as np

from pctpu.cloud import Cloud
from pctpu.config import (
    GroundConfig,
    MultiBevConfig,
    SensorParams,
    SingleBevConfig,
    get_sensor_params,
)
from pctpu.io.pcd import write_pcd
from pctpu.io.poses import read_keyframe_poses, save_labels
from pctpu.ops.preprocess import preprocess_batch
from pctpu.ops.select import keyframe_labels, select_major_frames
from pctpu.runtime.loader import (
    batched_prefetch,
    list_pcd_files,
    load_xyzirct_arrays,
    stack_batch,
)
from pctpu.runtime.profiler import StageTimer
from pctpu.utils import logging as log

import jax.numpy as jnp


@functools.partial(
    jax.jit,
    static_argnames=("params", "ground_cfg", "multi_cfg", "single_cfg",
                     "assume_ordered", "compat", "mesh"),
)
def _preprocess_wire(
    arrays: dict, params, ground_cfg, multi_cfg, single_cfg,
    assume_ordered: bool = False,
    compat: str = "bitexact",
    mesh=None,
):
    """Batched preprocess with narrow host↔device wire formats.

    Inputs arrive in their on-disk widths (u16 row/col, i16 label) and widen
    on device; on the way back the occupancy BEV is bit-packed (8×) and
    integer fields are re-narrowed.  With a mesh each device preprocesses
    its own slice of the batch (shard_map over 'data'), so the Pallas
    kernels inside run on device-local clouds.
    """
    body = functools.partial(
        _preprocess_wire_local, params=params, ground_cfg=ground_cfg,
        multi_cfg=multi_cfg, single_cfg=single_cfg,
        assume_ordered=assume_ordered, compat=compat,
    )
    if mesh is not None:
        from jax.sharding import PartitionSpec

        body = jax.shard_map(
            body, mesh=mesh, in_specs=PartitionSpec("data"),
            out_specs=PartitionSpec("data"), check_vma=False,
        )
    return body(arrays)


def _preprocess_wire_local(arrays: dict, params, ground_cfg, multi_cfg,
                           single_cfg, assume_ordered, compat):
    clouds = Cloud(
        xyz=arrays["xyz"],
        intensity=arrays["intensity"],
        row=arrays["row"].astype(jnp.int32),
        col=arrays["col"].astype(jnp.int32),
        t=arrays["t"],
        label=arrays["label"].astype(jnp.int32),
        count=arrays["count"],
    )
    labeled, multi, single = preprocess_batch(
        clouds, params, ground_cfg, multi_cfg, single_cfg,
        assume_ordered=assume_ordered, compat=compat,
    )
    # occupancy → bits (little-endian within each byte, like np.unpackbits
    # with bitorder="little")
    b, nl, s, _ = multi.shape
    bits = (multi.reshape(b, nl, s, s // 8, 8) != 0).astype(jnp.uint8)
    weights = (2 ** jnp.arange(8, dtype=jnp.uint32)).astype(jnp.uint8)
    packed = jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32).astype(jnp.uint8)
    wire = {
        "xyz": labeled.xyz,
        "intensity": labeled.intensity,
        "row": labeled.row.astype(jnp.uint16),
        "col": labeled.col.astype(jnp.uint16),
        "t": labeled.t,
        "label": labeled.label.astype(jnp.int16),
    }
    return wire, packed, single


@dataclasses.dataclass
class MultiBevOutputs:
    num_clouds: int
    num_major_frames: int
    avg_ms_per_cloud: float  # reference span: device compute + BEV writeback
    avg_device_ms_per_cloud: float = 0.0
    avg_bev_write_ms_per_cloud: float = 0.0
    # measured wall of the whole processing loop (load → device → writes),
    # from before the first prefetch to after the AsyncWriter drains: the
    # tool's OWN end-to-end span, in which the BEV writes overlap device
    # compute instead of adding serially (avg_ms_per_cloud is the serial-sum
    # reference-comparable convention; this is what the tool actually takes)
    loop_wall_ms: float = 0.0

    @property
    def wall_ms_per_cloud(self) -> float:
        return self.loop_wall_ms / self.num_clouds if self.num_clouds else 0.0


def _reset_dir(path: str, resume: bool) -> None:
    """Recreate an output dir (the reference shells out rm -rf + mkdir -p,
    /root/reference/BatchMultiBevGen.cpp:39-71); with resume=True existing
    outputs are kept and finished clouds are skipped."""
    if os.path.isdir(path) and not resume:
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def _short_name(path: str) -> str:
    """Filename without dir and extension
    (/root/reference/BatchMultiBevGen.cpp:739-742)."""
    base = os.path.basename(path)
    return base[: base.rfind(".")] if "." in base else base


def run_multi_bev(
    keyframes_root_dir: str,
    sensor: str | SensorParams,
    batch_size: int = 8,
    resume: bool = False,
    write_pngs: bool = True,
    mesh: "jax.sharding.Mesh | None" = None,
    devices: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    compat: str = "bitexact",
) -> MultiBevOutputs:
    """Run the full batch_multi_bev_gen pipeline over a keyframe tree.

    ``compat="tolerance"`` swaps the ground-grid in-order fold for the matmul
    segment-sum (pctpu.ops.ground) — the measured throughput mode; outputs
    stay within the BASELINE.json:5 window (<1 px BEV) of the default
    bit-exact mode.

    ``devices=N`` (or an explicit ``mesh``) shards the batch axis over a
    data-parallel device mesh — the per-cloud kernel is embarrassingly
    parallel, so GSPMD partitions it with zero cross-chip collectives and
    throughput scales with chip count (SURVEY.md §5.8).  Outputs are
    byte-identical to the single-device run.

    ``process_id``/``num_processes`` additionally shard the *file list*
    across hosts (multi-host scaling, pctpu.parallel.distributed): each host
    preprocesses a strided slice of the clouds; the global label phase and
    output-directory reset run on host 0 only.  Defaults follow
    ``jax.process_index()/count()`` (single-process runs are unchanged); the
    CLI's ``--num_processes``/``--process_id`` flags map here.  On a shared
    filesystem without ``resume``, start host 0 first (it wipes the output
    dirs like the reference's rm -rf) or pass ``--resume`` everywhere."""
    root = keyframes_root_dir.rstrip("/") + "/"
    params = sensor if isinstance(sensor, SensorParams) else get_sensor_params(sensor)
    from pctpu.parallel.distributed import process_shard

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    if mesh is None and devices is not None and devices > 1:
        from pctpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_data=devices, n_points=1)
    sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        n_data = mesh.shape["data"]
        if batch_size % n_data:
            batch_size = -(-batch_size // n_data) * n_data
            log.info(f"batch_size rounded up to {batch_size} for {n_data}-way mesh")
        sharding = NamedSharding(mesh, PartitionSpec("data"))
    multi_cfg = MultiBevConfig()
    single_cfg = SingleBevConfig()
    ground_cfg = GroundConfig()

    in_dir = root + "keyframe_point_cloud/"
    pose_file = root + "keyframe_pose.csv"
    non_ground_dir = root + "non_ground_point_cloud/"
    bin_dir = root + "output_multi_bev/binary/"
    img_dir = root + "output_multi_bev/image/"
    single_csv_dir = root + "output_single_bev/csv/"
    single_img_dir = root + "output_single_bev/image/"
    label_file = root + "keyframe_label.csv"

    # only host 0 may wipe shared output dirs; other hosts must not delete
    # their peers' work (per-file outputs are disjoint, so keep-and-create)
    for d in (non_ground_dir, bin_dir, img_dir, single_csv_dir, single_img_dir):
        _reset_dir(d, resume or pid != 0)

    files = process_shard(list_pcd_files(in_dir), pid, nproc)
    if resume:
        # key on the LAST artifact _write_outputs produces (the labeled
        # pcd): a crash mid-task then re-runs the whole cloud instead of
        # permanently dropping the later siblings of an existing .bin
        files = [
            f for f in files
            if not os.path.exists(non_ground_dir + _short_name(f) + ".pcd")
        ]
    log.info(f"Using sensor params: {params}")

    import time

    timer = StageTimer()
    done = 0
    loop_wall_ms = 0.0
    if files:
        from pctpu.runtime.writer import AsyncWriter

        capacity = params.grid_size
        from pctpu.ops.ordering import arrays_grid_ordered

        def _load(f):
            # the grid-ordered layout check (7 full-array reductions) runs on
            # the producer thread, overlapped with device compute — not in
            # the consumer loop's critical path.  params routes over-capacity
            # clouds through the host last-wins compaction (exact
            # getOrderedCloud semantics) instead of truncation.
            a = load_xyzirct_arrays(f, capacity, params=params)
            a["_grid_ordered"] = arrays_grid_ordered(a, params)
            return a

        t_loop0 = time.perf_counter()
        loader = batched_prefetch(files, batch_size, _load)
        with AsyncWriter() as writer:
            for names, payloads in loader:
                # selector-produced clouds are already grid-ordered: skip the
                # ordering scatter+gather on device (host-verified fast path)
                ordered = all(p["_grid_ordered"] for p in payloads)
                arrays = stack_batch(
                    [{k: v for k, v in p.items() if k != "_grid_ordered"}
                     for p in payloads]
                )
                with timer.stage("preprocess+bev", items=sum(1 for n in names if n)):
                    if sharding is not None:
                        # every field carries the batch axis first: shard it
                        dev_arrays = {
                            k: jax.device_put(v, sharding) for k, v in arrays.items()
                        }
                    else:
                        dev_arrays = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
                    wire, packed, single = _preprocess_wire(
                        dev_arrays, params, ground_cfg, multi_cfg, single_cfg,
                        assume_ordered=ordered, compat=compat, mesh=mesh,
                    )
                    # one device_get for the whole batch result: the leaf
                    # transfers issue together and overlap instead of paying
                    # a serial roundtrip each.  The occupancy BEV stays in
                    # its packed wire format — the writer expands it (native,
                    # off this thread) per cloud
                    packed_h, single_h, wire_h = jax.device_get(
                        (packed, single, wire)
                    )

                for bi, name in enumerate(names):
                    if name is None:
                        continue
                    short = _short_name(name)
                    log.info(f"Converting file: {short}")
                    writer.submit(
                        functools.partial(
                            _write_outputs,
                            short,
                            wire_h,
                            bi,
                            packed_h[bi],
                            single_h[bi],
                            bin_dir,
                            img_dir,
                            single_csv_dir,
                            single_img_dir,
                            non_ground_dir,
                            write_pngs,
                            timer,
                        )
                    )
                    done += 1
        # the `with` exit joined the writer threads: every submitted write
        # has completed, so this wall covers load → device → writes
        loop_wall_ms = (time.perf_counter() - t_loop0) * 1e3

    # The reference's [TIME] span (/root/reference/BatchMultiBevGen.cpp:731-749)
    # covers getOrderedCloud → computeAndSaveSingleBev INCLUDING the BEV
    # bin/png/csv writes (the labeled-pcd save at :756 sits outside it).  The
    # writes run async here, so the comparable per-cloud number is the sum of
    # the device-compute average and the measured per-cloud BEV-write average.
    avg_device = timer.average_ms("preprocess+bev")
    avg_write = timer.average_ms("bev-write")
    avg = avg_device + avg_write
    log.info(
        "[TIME] Average preprocessing and BEV generation: "
        f"{avg} (device {avg_device} + BEV write {avg_write}, "
        "reference span BatchMultiBevGen.cpp:731-749)"
    )
    if done:
        log.info(
            "[TIME] Measured end-to-end loop wall: "
            f"{loop_wall_ms / done} ms/cloud (writes overlapped)"
        )

    # Step 2: major frames + labels (/root/reference/BatchMultiBevGen.cpp:761-765)
    # — a global computation over ALL keyframe poses; host 0 only
    if pid != 0:
        return MultiBevOutputs(
            num_clouds=done, num_major_frames=0, avg_ms_per_cloud=avg,
            avg_device_ms_per_cloud=avg_device,
            avg_bev_write_ms_per_cloud=avg_write,
            loop_wall_ms=loop_wall_ms,
        )
    poses = read_keyframe_poses(pose_file)
    log.info(f"Finish reading all keyframe pose, total {len(poses)} entries. ")
    positions = np.array([[p.x, p.y, p.z] for _, p in poses], np.float32).reshape(-1, 3)
    majors = select_major_frames(positions)
    log.info(f"One-hot label has length: {len(majors)}")
    labels = keyframe_labels(positions, majors)
    save_labels(label_file, labels)
    log.info(f"saved labels from {len(labels)} key frames. ")
    log.info("Done. ")
    return MultiBevOutputs(
        num_clouds=done, num_major_frames=len(majors), avg_ms_per_cloud=avg,
        avg_device_ms_per_cloud=avg_device, avg_bev_write_ms_per_cloud=avg_write,
        loop_wall_ms=loop_wall_ms,
    )


def _write_outputs(
    short: str,
    wire_h: dict,
    bi: int,
    packed: np.ndarray,
    single: np.ndarray,
    bin_dir: str,
    img_dir: str,
    single_csv_dir: str,
    single_img_dir: str,
    non_ground_dir: str,
    write_pngs: bool,
    timer: StageTimer | None = None,
) -> None:
    import time

    from pctpu.runtime.native_io import write_cloud_artifacts

    # BEV artifacts are INSIDE the reference's [TIME] span
    # (/root/reference/BatchMultiBevGen.cpp:294-320, 352-372): timed into the
    # "bev-write" stage.  The labeled pcd (:756) is outside it — untimed.
    # ONE native call writes the whole set (bin + layer PNGs + single PNG +
    # csv) from the packed occupancy wire format, expanded natively here on
    # the writer thread instead of on the device-loop thread.
    t0 = time.perf_counter()
    write_cloud_artifacts(
        bin_dir + short + ".bin",
        img_dir + short + "/",
        single_img_dir + short + ".png",
        single_csv_dir + short + ".csv",
        single,
        packed=packed,
        write_pngs=write_pngs,
    )
    if timer is not None:
        timer.add("bev-write", (time.perf_counter() - t0) * 1e3)

    # ground-labeled full ordered cloud (points are never deleted —
    # /root/reference/BatchMultiBevGen.cpp:754-756)
    xyz = np.asarray(wire_h["xyz"][bi])
    write_pcd(
        non_ground_dir + short + ".pcd",
        {
            "x": xyz[:, 0],
            "y": xyz[:, 1],
            "z": xyz[:, 2],
            "intensity": np.asarray(wire_h["intensity"][bi]),
            "row": np.asarray(wire_h["row"][bi]),
            "col": np.asarray(wire_h["col"][bi]),
            "t": np.asarray(wire_h["t"][bi]),
            "label": np.asarray(wire_h["label"][bi]),
        },
        width=xyz.shape[0],
    )
