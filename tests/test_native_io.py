"""Native IO accelerator parity: artifacts identical across native/Python."""

import numpy as np
import pytest

from pctpu.io.png import read_gray_png
from pctpu.runtime.native_io import native_available, write_multi_bev, write_png


def test_native_png_decodes_identically(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (224, 224), np.uint8)
    p = str(tmp_path / "a.png")
    write_png(p, img)
    assert np.array_equal(read_gray_png(p), img)
    cv2 = pytest.importorskip("cv2")
    assert np.array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img)


def test_native_multi_bev_outputs(tmp_path):
    rng = np.random.default_rng(1)
    multi = (rng.random((24, 32, 32)) > 0.8).astype(np.uint8) * 255
    bin_path = str(tmp_path / "c.bin")
    img_dir = str(tmp_path / "imgs")
    write_multi_bev(bin_path, img_dir, multi)
    blob = np.fromfile(bin_path, np.uint8).reshape(24, 32, 32)
    assert np.array_equal(blob, multi)
    for layer in (0, 13, 23):
        png = read_gray_png(str(tmp_path / "imgs" / f"{layer:02d}.png"))
        assert np.array_equal(png, multi[layer])


def test_native_lib_builds():
    # informational: both paths are correct, but the native one should load
    # in this image (g++ + zlib available)
    assert native_available()


def test_native_lib_compile_and_rebuild(tmp_path, monkeypatch):
    """The on-demand g++ build branch (native_io.py::_load): an absent
    library is compiled from source via atomic temp+rename under a name
    keyed on the source's content, a library for other source content (even
    a newer file) is never loaded, an edited source gets a fresh build, and
    a broken source degrades to None so every caller falls back to the
    pure-Python writers."""
    import glob
    import os
    import shutil

    import pctpu.runtime.native_build as nb
    import pctpu.runtime.native_io as nio

    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path / "build"))

    def reload():
        monkeypatch.setattr(nio, "_lib", None)
        monkeypatch.setattr(nio, "_tried", False)
        return nio.native_available()

    src = str(tmp_path / "pctpu_io.cpp")
    shutil.copy(nb.native_source("pctpu_io.cpp"), src)
    monkeypatch.setattr(nio, "native_source", lambda name: src)
    assert reload()  # compiled from source on demand
    (lib_path,) = glob.glob(str(tmp_path / "build" / "pctpu_io-*.so"))
    assert not glob.glob(lib_path + ".build.*")  # temp renamed away
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    nio.write_png(str(tmp_path / "fresh.png"), img)
    assert np.array_equal(read_gray_png(str(tmp_path / "fresh.png")), img)

    # a newer library under another key (another checkout's build) is
    # ignored; editing the source builds a second library beside the first
    stray = str(tmp_path / "build" / "pctpu_io-0000000000000000.so")
    with open(stray, "w") as f:
        f.write("not a library")
    with open(src, "a") as f:
        f.write("\n// edited\n")
    assert reload()
    libs = set(glob.glob(str(tmp_path / "build" / "pctpu_io-*.so")))
    assert len(libs - {stray, lib_path}) == 1
    assert os.path.getsize(stray) == len("not a library")

    # broken source: build fails quietly, native_available() -> False
    bad_src = tmp_path / "bad.cpp"
    bad_src.write_text("this is not C++")
    monkeypatch.setattr(nio, "native_source", lambda name: str(bad_src))
    assert not reload()


def test_native_lzf_matches_python():
    """Native liblzf decoder == the pure-Python fallback, incl. backrefs."""
    import pctpu.runtime.native_io as nio

    if not nio.native_available():
        import pytest

        pytest.skip("native lib unavailable")

    # literal-only stream
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 255, 100_000, dtype=np.uint8).tobytes()
    from .test_pcd import _lzf_compress_literals

    comp = _lzf_compress_literals(payload)
    assert nio.lzf_decompress(comp, len(payload)) == payload

    # back-reference stream (overlapping copy)
    stream = bytes([0x02]) + b"XYZ" + bytes([0xE0, 0x00, 0x02])
    assert nio.lzf_decompress(stream, 12) == b"XYZXYZXYZXYZ"

    # corrupt stream: native returns None (caller falls back / errors)
    assert nio.lzf_decompress(stream, 13) is None


def test_python_fallbacks_match_native(tmp_path, monkeypatch):
    """With the native library unavailable, every native_io entry point
    falls back to the pure-Python writers and produces byte-identical
    artifacts (the module's stated contract)."""
    import pctpu.runtime.native_io as nio
    from pctpu.io.csvfmt import format_csv

    if not nio.native_available():
        pytest.skip("native lib unavailable (nothing to compare against)")

    rng = np.random.default_rng(4)
    img_f = rng.uniform(-20, 300, (31, 33)).astype(np.float32)  # saturating
    multi = (rng.integers(0, 2, (3, 16, 16), dtype=np.uint8)) * 255
    mat = rng.uniform(-1e4, 1e4, (7, 5)).astype(np.float32)
    row = mat[:1]  # exercises the single-row (no trailing newline) branch

    nio.write_png(str(tmp_path / "native.png"), img_f)
    nio.write_multi_bev(str(tmp_path / "native.bin"),
                        str(tmp_path / "native_img"), multi)
    native_csv = format_csv(mat)
    native_row = format_csv(row)
    assert nio.format_csv_f32(mat, 4) is not None

    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_tried", True)
    assert not nio.native_available()
    assert nio.format_csv_f32(mat, 4) is None
    assert nio.lzf_decompress(b"\x00x", 1) is None

    nio.write_png(str(tmp_path / "py.png"), img_f)
    nio.write_multi_bev(str(tmp_path / "py.bin"), str(tmp_path / "py_img"),
                        multi)
    assert (tmp_path / "py.png").read_bytes() \
        == (tmp_path / "native.png").read_bytes()
    assert (tmp_path / "py.bin").read_bytes() \
        == (tmp_path / "native.bin").read_bytes()
    for layer in range(3):
        assert (tmp_path / "py_img" / f"{layer:02d}.png").read_bytes() \
            == (tmp_path / "native_img" / f"{layer:02d}.png").read_bytes()
    assert format_csv(mat) == native_csv
    assert format_csv(row) == native_row


def test_write_cloud_artifacts_paths_identical(tmp_path, monkeypatch):
    """The one-call artifact writer (native, packed or unpacked input) and
    its Python fallback produce byte-identical artifact sets (bin + layer
    PNGs + single PNG + csv)."""
    import pctpu.runtime.native_io as nio

    if not nio.native_available():
        pytest.skip("native lib unavailable (nothing to compare against)")

    rng = np.random.default_rng(7)
    multi = (rng.random((24, 32, 32)) > 0.8).astype(np.uint8) * 255
    # edge densities exercise the packed encoder's run-chunking: an all-zero
    # layer (one maximal zero run), an all-set layer (255-runs split by the
    # per-row filter bytes), and a row-boundary-straddling block
    multi[3] = 0
    multi[11] = 255
    multi[17, 1:3] = 255
    packed = np.packbits(
        (multi != 0).reshape(24, 32, 4, 8), axis=-1, bitorder="little"
    ).reshape(24, 32, 4)
    single = rng.integers(0, 256, (32, 32), np.uint8)

    def run(tag, **kw):
        d = tmp_path / tag
        d.mkdir()
        nio.write_cloud_artifacts(
            str(d / "c.bin"), str(d / "img"), str(d / "s.png"),
            str(d / "s.csv"), single, **kw,
        )
        blobs = {"bin": (d / "c.bin").read_bytes(),
                 "png": (d / "s.png").read_bytes(),
                 "csv": (d / "s.csv").read_bytes()}
        for layer in range(24):
            blobs[f"l{layer}"] = (d / "img" / f"{layer:02d}.png").read_bytes()
        return blobs

    native_packed = run("np", packed=packed)
    native_unpacked = run("nu", multi=multi)
    assert native_packed == native_unpacked
    assert np.array_equal(
        np.frombuffer(native_packed["bin"], np.uint8).reshape(24, 32, 32),
        multi,
    )

    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_tried", True)
    py_packed = run("pp", packed=packed)
    py_unpacked = run("pu", multi=multi)
    assert py_packed == native_packed
    assert py_unpacked == native_packed


def test_write_cloud_artifacts_no_pngs(tmp_path):
    """write_pngs=False writes bin + csv only (the pipeline's --no-pngs
    mode): no image dir contents, no single PNG."""
    import pctpu.runtime.native_io as nio

    rng = np.random.default_rng(8)
    multi = (rng.random((4, 16, 16)) > 0.5).astype(np.uint8) * 255
    single = rng.integers(0, 256, (16, 16), np.uint8)
    d = tmp_path
    nio.write_cloud_artifacts(
        str(d / "c.bin"), str(d / "img"), str(d / "s.png"), str(d / "s.csv"),
        single, multi=multi, write_pngs=False,
    )
    assert (d / "c.bin").exists() and (d / "s.csv").exists()
    assert not (d / "s.png").exists()
    assert not (d / "img").exists() or not any((d / "img").iterdir())


def test_format_csv_f32_cap_guard(monkeypatch):
    """A native formatter reporting overflow (n < 0) yields None so the
    caller falls back to the byte-identical Python path."""
    import pctpu.runtime.native_io as nio

    class _Stub:
        @staticmethod
        def pctpu_format_csv_f32(*args):
            return -1

    monkeypatch.setattr(nio, "_lib", _Stub())
    monkeypatch.setattr(nio, "_tried", True)
    assert nio.format_csv_f32(np.ones((2, 2), np.float32), 4) is None
