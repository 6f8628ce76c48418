"""ctypes loader for the native differential oracle (native/ref_oracle.cpp).

Builds the shared library on first use (pctpu/runtime/native_build.py) and
exposes numpy-in/numpy-out wrappers for the three transcribed chains.
Test-only — this is evidence infrastructure, not product code: the library
is a THIRD independent implementation of the reference semantics (C++ float
arithmetic natively, where tests/ref_impl.py must emulate it with numpy
casts), diffed byte-for-byte against both the Python oracle and the pctpu
ops in tests/test_native_oracle.py, the fuzz-campaign --native leg and
chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from pctpu.runtime.native_build import build, native_source

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build(
                native_source("ref_oracle.cpp"),
                ["-O2", "-std=c++14", "-ffp-contract=off"],
            ))
            lib.pctpu_ref_preprocess.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.pctpu_ref_preprocess.restype = ctypes.c_int
            lib.pctpu_ref_float_bev.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.pctpu_ref_float_bev.restype = ctypes.c_int
            lib.pctpu_ref_top_flatten.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.pctpu_ref_top_flatten.restype = ctypes.c_int64
            _lib = lib
        except Exception as exc:
            # never silently degrade the evidence tier to a no-op success:
            # surface the g++ diagnostic so a broken oracle build is visible
            # in campaign/parity logs (callers still treat None as "skip")
            import sys

            detail = ""
            if isinstance(exc, subprocess.CalledProcessError):
                detail = (exc.stderr or b"").decode(errors="replace")[-2000:]
            print(
                f"native_oracle: build/load failed: {exc}\n{detail}",
                file=sys.stderr,
            )
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def preprocess(points: list[dict], params):
    """Run the native ordering+ground+BEV chain on a dict-point list (the
    fuzz fixtures' format).  Returns (labels (grid,) i32, multi u8, single u8,
    ordered_xyz (grid,3) f32)."""
    n = len(points)
    xyz = np.array([[p["x"], p["y"], p["z"]] for p in points], np.float32)
    return preprocess_arrays(
        xyz.reshape(n, 3),
        np.asarray([p["intensity"] for p in points], np.float32),
        np.asarray([p["row"] for p in points], np.int32),
        np.asarray([p["col"] for p in points], np.int32),
        np.asarray([p["label"] for p in points], np.int32),
        params,
    )


def preprocess_arrays(xyz, intensity, row, col, label, params):
    """Array-input variant of :func:`preprocess` (e.g. fields read straight
    from a PCD)."""
    lib = _load()
    assert lib is not None
    n = len(xyz)
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(n, 3)
    intensity = np.ascontiguousarray(intensity, np.float32)
    row = np.ascontiguousarray(row, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    label = np.ascontiguousarray(label, np.int32)
    grid = params.n_scan * params.horizon_scan
    labels_out = np.empty(grid, np.int32)
    multi = np.empty(24 * 224 * 224, np.uint8)
    single = np.empty(224 * 224, np.uint8)
    ordered_xyz = np.empty(grid * 3, np.float32)
    rc = lib.pctpu_ref_preprocess(
        xyz.ctypes.data, intensity.ctypes.data, row.ctypes.data,
        col.ctypes.data, label.ctypes.data, n,
        params.n_scan, params.horizon_scan, params.ground_upper_scan,
        params.height_res,
        labels_out.ctypes.data, multi.ctypes.data, single.ctypes.data,
        ordered_xyz.ctypes.data,
    )
    assert rc == 0
    return (
        labels_out,
        multi.reshape(24, 224, 224),
        single.reshape(224, 224),
        ordered_xyz.reshape(grid, 3),
    )


def compare_kitti_artifacts(tree: str, params, indices) -> list[str]:
    """Byte-diff the artifacts a multi-BEV pipeline run WROTE under ``tree``
    (multi-BEV .bin, single-BEV csv, non-ground PCD labels) against this
    oracle run on the same input keyframes.  One source of truth for the
    pipeline test (tests/test_native_oracle.py) and the parity harness's
    fallback tier (scripts/run_reference_parity.py).  Returns report lines
    ("BYTES-OK <what>" / "BYTES-DIFF <what>")."""
    import os

    from pctpu.io.pcd import read_pcd

    report = []
    for i in indices:
        data, _ = read_pcd(
            os.path.join(tree, "keyframe_point_cloud", f"{i:06d}.pcd")
        )
        xyz = np.stack([data["x"], data["y"], data["z"]], axis=1)
        labels, multi, single, _ = preprocess_arrays(
            xyz, data["intensity"], data["row"].astype(np.int32),
            data["col"].astype(np.int32), data["label"].astype(np.int32),
            params,
        )
        blob = open(
            os.path.join(tree, "output_multi_bev", "binary", f"{i:06d}.bin"),
            "rb",
        ).read()
        ok = np.array_equal(np.frombuffer(blob, np.uint8), multi.reshape(-1))
        report.append(("BYTES-OK " if ok else "BYTES-DIFF ")
                      + f"native/multi_bev/{i:06d}.bin")
        csv_text = open(
            os.path.join(tree, "output_single_bev", "csv", f"{i:06d}.csv")
        ).read()
        csv_mat = np.array(
            [[int(v) for v in r.split(",")] for r in
             csv_text.strip().split("\n")], np.uint8,
        )
        ok = np.array_equal(csv_mat, single)
        report.append(("BYTES-OK " if ok else "BYTES-DIFF ")
                      + f"native/single_bev/{i:06d}.csv")
        ng, _ = read_pcd(
            os.path.join(tree, "non_ground_point_cloud", f"{i:06d}.pcd")
        )
        ok = np.array_equal(ng["label"].astype(np.int32), labels)
        report.append(("BYTES-OK " if ok else "BYTES-DIFF ")
                      + f"native/labels/{i:06d}.pcd")
    return report


def float_bev(xyz: np.ndarray, label: np.ndarray, filter_ground: bool):
    """Native saveAsMat float BEV.  Returns (201, 201) f32."""
    lib = _load()
    assert lib is not None
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    label = np.ascontiguousarray(label, np.int32)
    out = np.empty(201 * 201, np.float32)
    rc = lib.pctpu_ref_float_bev(
        xyz.ctypes.data, label.ctypes.data, len(xyz),
        1 if filter_ground else 0, out.ctypes.data,
    )
    assert rc == 0
    return out.reshape(201, 201)


def top_flatten(xyz: np.ndarray, label: np.ndarray):
    """Native extractTopAndFlatten.  Returns (k, 3) f32 in reference order."""
    lib = _load()
    assert lib is not None
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    label = np.ascontiguousarray(label, np.int32)
    cap = max(len(xyz), 1)
    out = np.empty(cap * 3, np.float32)
    k = lib.pctpu_ref_top_flatten(
        xyz.ctypes.data, label.ctypes.data, len(xyz), out.ctypes.data, cap
    )
    assert k >= 0
    return out[: 3 * k].reshape(k, 3)
