"""The check of the check: a run of each cell on the CPU (the program's
plain kernels) is correct as it is, and comes out not correct with each
fault of faults.py planted under its timed path."""
import pytest

from h100_bench import harness
from h100_bench.faults import FAULTS

CELLS = harness.cell_names()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_root, bench):
    r = harness.run(cell, 2**31 + 99, 0.5, False, device="cpu", root=tiny_root,
                    bench=bench)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, tiny_root, bench):
    r = harness.run(cell, 2**31 + 98, 0.5, False, device="cpu", root=tiny_root,
                    bench=bench, fault=fault)
    assert not r["correct"], (fault, r["checks"])


def test_traced_run_on_the_cpu(tiny_root, bench, tmp_path):
    r = harness.run("turbo_speed.p80_64m", 3, 0.1, True, device="cpu",
                    root=tiny_root, bench=bench, trace_dir=tmp_path)
    assert r["correct"]
    # the stage-second metrics that BENCHMARK.json lists for the cell, and no other
    listed = {m["name"] for m in harness.metrics_for(bench, "turbo_speed.p80_64m", True)}
    assert {k for k in r["metrics"] if k.startswith("api.")} == {
        "api.decompress_host_ms_per_mib"} == {k for k in listed if k.startswith("api.")}
    # no device in the trace: no device metric, never a zero
    assert not any(k.startswith(("kernels.", "device.")) for k in r["metrics"])
    assert r["device"]["window_s"] > 0


@pytest.mark.gpu
def test_cell_on_the_card(cuda, bench):
    r = harness.run("turbo_speed.p80_1m", 5, 1.0, False, device=cuda, bench=bench)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
