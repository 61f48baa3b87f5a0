"""The compat_fse cell: a traced run on the CPU (the frame layer over the
CLI's host twins) is correct and reports the metrics that read the frame
layer's and the FSE codec's spans, and those spans name the idle gaps."""
from h100_bench import harness

CELL = "compat_fse.p80_16m"
SPAN_METRICS = {"compat.decompress_checksum_ms_per_mib",
                "compat.decompress_host_ms_per_mib"}
# readers of the compress side: listed once compress_gbps lists the cell
COMPRESS_METRICS = {"compat.compress_checksum_ms_per_mib",
                    "compat.compress_host_ms_per_mib", "compat.compress_roofline_pct"}


def test_traced_run_reports_the_span_metrics(tiny_root, bench, tmp_path):
    r = harness.run(CELL, 2**31 + 19, 0.2, True, device="cpu", root=tiny_root,
                    bench=bench, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    for name in SPAN_METRICS:
        assert r["metrics"][name]["value"] > 0, name
    # every per-layer metric the cell lists that a run without a device can
    # read; the roofline needs CUDA kernels in the trace
    listed = {m["name"] for m in harness.metrics_for(bench, CELL, True)}
    assert listed - SPAN_METRICS == {"compat.decompress_roofline_pct"}
    assert set(r["metrics"]) == SPAN_METRICS
    # the host twins open no codec spans; the frame layer's name the gaps
    labels = {label for label, _s in r["breakdown"]["idle_gaps"]}
    assert {"frame.c_checksum", "frame.d_checksum"} <= labels, labels


def test_compress_readers_read_the_cell(tiny_root, bench, tmp_path):
    """The compress side's readers, listed for the cell as a benchmark that
    reports its compress_gbps would list them, read its spans."""
    assert not COMPRESS_METRICS & {m["name"] for m in bench["per_layer"]}
    ext = dict(bench, per_layer=bench["per_layer"] + [
        {"name": n, "unit": "%" if n.endswith("_pct") else "ms/MiB", "workloads": [CELL]}
        for n in sorted(COMPRESS_METRICS)])
    r = harness.run(CELL, 2**31 + 23, 0.2, True, device="cpu", root=tiny_root,
                    bench=ext, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    for name in COMPRESS_METRICS - {"compat.compress_roofline_pct"}:
        assert r["metrics"][name]["value"] > 0, name
    assert "compat.compress_roofline_pct" not in r["metrics"]


def test_untraced_run_reports_the_end_to_end_metrics(tiny_root, bench):
    r = harness.run(CELL, 5, 0.1, False, device="cpu", root=tiny_root, bench=bench)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"decompress_gbps", "ratio", "setup_s"}
    assert r["metrics"]["ratio"]["value"] > 5
