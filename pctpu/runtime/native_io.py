"""ctypes bindings for the native IO accelerator (native/pctpu_io.cpp).

Falls back to the pure-Python writers when the shared library cannot be
built.  The library is built on first use (g++ + zlib,
``pctpu/runtime/native_build.py``); artifacts produced through either path
decode identically (tests/test_native_io.py).
"""

from __future__ import annotations

import ctypes
import os
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
            lib = ctypes.CDLL(build(native_source("pctpu_io.cpp"), ["-O2"],
                                    ["-lz"]))
            lib.pctpu_write_png.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p,
            ]
            lib.pctpu_write_png.restype = ctypes.c_int
            lib.pctpu_write_multi_bev.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.pctpu_write_multi_bev.restype = ctypes.c_int
            lib.pctpu_write_cloud_artifacts.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.pctpu_write_cloud_artifacts.restype = ctypes.c_int
            lib.pctpu_lzf_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ]
            lib.pctpu_lzf_decompress.restype = ctypes.c_long
            lib.pctpu_format_csv_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.pctpu_format_csv_f32.restype = ctypes.c_long
            lib.pctpu_format_csv_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.pctpu_format_csv_u8.restype = ctypes.c_long
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write an 8-bit grayscale PNG (native if possible, else Python)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        from pctpu.ops.rounding import cv_saturate_u8

        img = cv_saturate_u8(img)
    lib = _load()
    if lib is not None:
        rc = lib.pctpu_write_png(
            img.ctypes.data, img.shape[0], img.shape[1], level, path.encode()
        )
        if rc == 0:
            return
    from pctpu.io.png import write_gray_png

    write_gray_png(path, img, compress_level=level)


def write_multi_bev(
    bin_path: str,
    img_dir: str,
    multi: np.ndarray,
    level: int = 1,
    write_pngs: bool = True,
) -> None:
    """Write one cloud's multi-BEV bin + per-layer PNGs."""
    multi = np.ascontiguousarray(multi, np.uint8)
    layers, h, w = multi.shape
    lib = _load()
    if lib is not None:
        rc = lib.pctpu_write_multi_bev(
            multi.ctypes.data, layers, h, w,
            bin_path.encode(), img_dir.rstrip("/").encode(), level,
            1 if write_pngs else 0,
        )
        if rc == 0:
            return
    # Python fallback
    with open(bin_path, "wb") as f:
        f.write(multi.tobytes())
    if write_pngs:
        os.makedirs(img_dir, exist_ok=True)
        from pctpu.io.png import write_gray_png

        for layer in range(layers):
            write_gray_png(
                os.path.join(img_dir, f"{layer:02d}.png"), multi[layer], level
            )


def write_cloud_artifacts(
    bin_path: str,
    img_dir: str,
    single_png_path: str,
    single_csv_path: str,
    single: np.ndarray,
    multi: np.ndarray | None = None,
    packed: np.ndarray | None = None,
    level: int = 1,
    write_pngs: bool = True,
) -> None:
    """Write one cloud's ENTIRE in-[TIME] artifact set in one native call
    (/root/reference/BatchMultiBevGen.cpp:295-320, 352-372): layer-major
    .bin + per-layer PNGs + single-BEV PNG + FMT_CSV.

    Pass either ``multi`` (unpacked (L, H, W) u8 of 0/255) or ``packed``
    ((L, H, W//8) u8, np.unpackbits bitorder="little" semantics — the
    pipeline's wire format, expanded natively off the main thread).  Falls
    back to the per-artifact writers (byte-identical outputs,
    tests/test_native_io.py)."""
    single = np.ascontiguousarray(single, np.uint8)
    sh, sw = single.shape
    lib = _load()
    if lib is not None:
        if packed is not None:
            packed = np.ascontiguousarray(packed, np.uint8)
            nl, h, w8 = packed.shape
            rc = lib.pctpu_write_cloud_artifacts(
                packed.ctypes.data, None, nl, h, w8 * 8,
                single.ctypes.data, sh, sw,
                bin_path.encode(), img_dir.rstrip("/").encode(),
                single_png_path.encode() if write_pngs else None,
                single_csv_path.encode(),
                level, 1 if write_pngs else 0,
            )
        else:
            multi_c = np.ascontiguousarray(multi, np.uint8)
            nl, h, w = multi_c.shape
            rc = lib.pctpu_write_cloud_artifacts(
                None, multi_c.ctypes.data, nl, h, w,
                single.ctypes.data, sh, sw,
                bin_path.encode(), img_dir.rstrip("/").encode(),
                single_png_path.encode() if write_pngs else None,
                single_csv_path.encode(),
                level, 1 if write_pngs else 0,
            )
        if rc == 0:
            return
    # Python fallback: per-artifact writers (same bytes)
    if multi is None:
        w = packed.shape[-1] * 8
        multi = np.unpackbits(
            np.ascontiguousarray(packed, np.uint8).reshape(-1), bitorder="little"
        ).reshape(packed.shape[0], -1, w) * np.uint8(255)
    write_multi_bev(bin_path, img_dir, multi, level=level, write_pngs=write_pngs)
    if write_pngs:
        write_png(single_png_path, single, level=level)
    from pctpu.io.csvfmt import write_csv

    write_csv(single_csv_path, single)


def format_csv_f32(mat: np.ndarray, precision: int) -> bytes | None:
    """Native OpenCV-FMT_CSV float formatting ("%.<p>g", ", ", row "\\n").
    Returns None when the library is unavailable (caller falls back to the
    byte-identical Python formatter)."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.float32)
    h, w = mat.shape
    # worst case per value: sign + 8 significant + dot + e+XX + sep ≈ 24
    cap = h * w * (precision + 20) + h + 16
    out = np.empty(cap, np.uint8)
    n = lib.pctpu_format_csv_f32(
        mat.ctypes.data, h, w, precision, out.ctypes.data, cap
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def format_csv_u8(mat: np.ndarray) -> bytes | None:
    """Native OpenCV-FMT_CSV uint8 formatting ("%3d", ", ", row "\\n").
    Returns None when the library is unavailable (caller falls back to the
    byte-identical numpy LUT path)."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.uint8)
    h, w = mat.shape
    cap = h * w * 5
    out = np.empty(cap, np.uint8)
    n = lib.pctpu_format_csv_u8(mat.ctypes.data, h, w, out.ctypes.data, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def lzf_decompress(data: bytes, expected_size: int) -> bytes | None:
    """Native liblzf decompression; None when the library is unavailable or
    the stream doesn't decode to exactly expected_size (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(expected_size, np.uint8)
    src = np.frombuffer(data, np.uint8)
    n = lib.pctpu_lzf_decompress(
        src.ctypes.data, len(data), out.ctypes.data, expected_size
    )
    if n != expected_size:
        return None
    return out.tobytes()
