"""scripts/run_reference_parity.py: graceful skip without PCL, and the CLI
invocation path the harness uses (catches missing-import class of bugs)."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parity_harness_skips_gracefully_without_pcl():
    # the CLI subprocesses the harness spawns keep their compiles in the
    # program's own persistent cache (pctpu.runtime.platform)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_reference_parity.py")],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    # on a PCL machine this runs the full reference comparison; here it must
    # say why that tier is unavailable and fall back to the native-C++-oracle
    # tier, whose artifact comparisons must all agree; with no working C++
    # toolchain at all the fallback itself degrades to a loud skip (exit 0)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (
        "parity report" in r.stdout
        or ("native-oracle tier report" in r.stdout
            and "0 diverging" in r.stdout)
        or "nothing to compare" in r.stdout
    ), r.stdout[-2000:]


def test_batch_cloud_manip_cli_runs(tmp_path):
    """The harness drives batch_cloud_manip via argv — the CLI must actually
    run (a missing int_kw import made every real invocation NameError).

    The pipeline leg runs main() in-process: a fresh ``python -m`` subprocess
    cannot share the suite's jit cache (1-device topology vs the suite's 8
    virtual devices) and pays a >20-minute cold XLA CPU compile of the
    133k-capacity kernel on this 1-core box.  The subprocess entry itself is
    still exercised below via the jit-free usage path."""
    from pctpu.cli.batch_cloud_manip import main
    from pctpu.cloud import make_cloud
    from pctpu.io.pcd import save_cloud_pcd

    root = tmp_path / "tree"
    (root / "keyframe_point_cloud").mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = 300
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-2.2, 3.0, n).astype(np.float32)
    c = make_cloud(
        xyz,
        intensity=rng.random(n).astype(np.float32),
        row=rng.integers(0, 64, n).astype(np.int32),
        col=rng.integers(0, 2083, n).astype(np.int32),
        label=np.full(n, -2, np.int32),
    )
    save_cloud_pcd(str(root / "keyframe_point_cloud" / "000000.pcd"), c)
    assert main([str(root), "--batch-size=2"]) == 0
    assert (root / "output_bvm").is_dir()

    # the python -m entry point: missing argv exits 1 with the usage line
    # before any jit work, so the subprocess leg stays cheap
    r = subprocess.run(
        [sys.executable, "-m", "pctpu.cli.batch_cloud_manip"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300,
    )
    assert r.returncode == 1
    assert "Usage: batch_cloud_manip" in r.stdout
