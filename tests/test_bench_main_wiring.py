"""bench.main() wiring test: every measurement stubbed, the JSON result line
and bench_details.json must carry their keys (pipeline span, ratio
intervals, utilization, the device), and a failed measurement must fail the
run instead of being reported beside the others."""

import json

import pytest


@pytest.fixture
def stubbed_bench(monkeypatch, tmp_path):
    import bench

    monkeypatch.setattr(
        bench, "device_info",
        lambda: {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                 "count": 1, "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
    )
    monkeypatch.setattr(
        bench, "measure_baseline",
        lambda full_span=False: 24.0 if full_span else 9.0,
    )
    monkeypatch.setattr(
        bench, "measure_device",
        lambda ordered=True, sensor="HDL_64E", n_points=None,
        compat="bitexact": 700.0 if compat == "bitexact" else 1200.0,
    )
    monkeypatch.setattr(bench, "measure_write_ms", lambda *a, **k: 3.0)
    monkeypatch.setattr(bench, "verify_on_device", lambda: "ok")
    monkeypatch.setattr(
        bench, "measure_pipeline_span",
        lambda *a, **k: {
            "pipeline_full_span_clouds_per_sec": 150.0,
            "pipeline_wall_ms_per_cloud": 6.67,
            "pipeline_device_ms_per_cloud_incl_transfers": 5.0,
            "pipeline_bev_write_ms_per_cloud": 3.0,
            "pipeline_serial_sum_ms_per_cloud": 8.0,
            "pipeline_write_overlap_hidden_pct": 44.0,
        },
    )
    monkeypatch.setattr(
        bench, "measure_registration",
        lambda return_stages=False, depth=1, **k:
        (40.0, {"fine": 18.0}) if return_stages else 40.0,
    )
    monkeypatch.setattr(
        bench, "measure_registration_baseline",
        lambda *a, **k: {"ms_per_pair": 65.0, "coarse_ms": 10.0,
                         "fine_ms": 55.0},
    )
    monkeypatch.setattr(
        bench, "utilization_block",
        lambda *a, **k: {"primitive_peaks": {}, "stages": {},
                         "substages_isolated": {},
                         "stage_sum_tolerance_ms": 0.6},
    )
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    return bench


def _run_main(bench, monkeypatch, capsys, argv):
    monkeypatch.setattr(bench.sys, "argv", argv)
    assert bench.main() == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    return json.loads(lines[-1])


def test_main_json_line_keys(stubbed_bench, monkeypatch, capsys):
    out = _run_main(stubbed_bench, monkeypatch, capsys, ["bench.py"])
    assert out["metric"] == "hdl64e_multibev_clouds_per_sec"
    assert out["value"] == 1200.0
    assert out["unit"] == "clouds/s"
    # ratio intervals span the session + pinned-history baseline spread
    lo, hi = out["vs_baseline_interval"]
    assert lo <= out["vs_baseline"] <= hi
    lo_fs, hi_fs = out["vs_baseline_full_span_interval"]
    assert lo_fs <= out["vs_baseline_full_span"] <= hi_fs
    # the tool's own measured overlapped span rides the main line
    assert out["pipeline_full_span_clouds_per_sec"] == 150.0
    assert out["pipeline_write_overlap_hidden_pct"] == 44.0
    # every result names the device it ran on
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["nvidia_smi"].endswith("700.00 W")


def test_main_survives_pipeline_span_failure(stubbed_bench, monkeypatch,
                                             capsys):
    """A failed phase fails the bench: it raises, and no result line is
    printed for the other phases' numbers."""
    def boom(*a, **k):
        raise RuntimeError("device wedged")

    monkeypatch.setattr(stubbed_bench, "measure_pipeline_span", boom)
    monkeypatch.setattr(stubbed_bench.sys, "argv", ["bench.py"])
    with pytest.raises(RuntimeError, match="device wedged"):
        stubbed_bench.main()
    assert '"metric"' not in capsys.readouterr().out


def test_main_details_block(stubbed_bench, monkeypatch, capsys, tmp_path):
    _run_main(stubbed_bench, monkeypatch, capsys, ["bench.py", "--details"])
    with open(tmp_path / "bench_details.json") as f:
        det = json.load(f)
    for key in (
        "pipeline_full_span_clouds_per_sec", "vs_baseline_interval",
        "vs_baseline_full_span_interval", "baseline_ms_spread",
        "utilization", "registration_vs_baseline",
        "full_span_clouds_per_sec_tolerance",
    ):
        assert key in det, key
    assert det["utilization"]["stage_sum_tolerance_ms"] == 0.6
    lo, hi = det["baseline_ms_spread"]
    assert lo <= 9.0 <= hi


def test_device_info_refuses_the_cpu():
    """The bench measures a GPU or nothing: no CPU fallback."""
    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.device_info()
