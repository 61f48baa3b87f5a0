"""The metrics that read the program's own spans: a traced run on the CPU
reports them, beside every per-layer metric the cell reported before."""
import pytest

from h100_bench import harness

NEW = {"turbo_resident.p80_64m": {"resident.decompress_host_ms_per_mib",
                                  "resident.decompress_h2d_ms_per_mib"},
       "turbo_speed.p80_1m": {"api.prep_byte_ms_per_mib", "api.prep_wires_ms_per_mib"}}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_the_span_metrics(cell, tiny_root, bench, tmp_path):
    r = harness.run(cell, 2**31 + 17, 0.2, True, device="cpu", root=tiny_root,
                    bench=bench, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    for name in NEW[cell]:
        assert r["metrics"][name]["value"] > 0, name
    # the per-layer metrics the cell lists that a run without a device can
    # read (the kernels.* and device.* ones need CUDA events in the trace)
    listed = {m["name"] for m in harness.metrics_for(bench, cell, True)}
    host = {n for n in listed if not n.startswith(("kernels.", "device."))}
    assert NEW[cell] <= host
    assert host == set(r["metrics"])
    # the program's spans name the breakdown's gaps
    assert any(label.startswith(("turbo.", "resident."))
               for label, _s in r["breakdown"]["idle_gaps"])
