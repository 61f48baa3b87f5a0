"""The decode-batch metrics (kernels.decode_batch_ms_per_mib,
kernels.decode_batch_roofline_pct): a synthetic trace's kernels count only
where they start inside the program's span turbo.d_batch; and a traced
run of their cells on the CPU marks that span, is correct, and reports
neither metric, since a run without a device has no kernels to read."""
import json
import shutil

import pytest

from h100_bench import harness
from h100_bench.loops.roundtrip import Call
from h100_bench.tests.conftest import BENCH
from h100_bench.trace import TraceData

METRICS = ("kernels.decode_batch_ms_per_mib", "kernels.decode_batch_roofline_pct")
CELLS = ("turbo_ratio.p80_64m", "turbo_speed.p02_64m")
MiB = 1 << 20


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# one decompress call: a batch span holding a 400 us kernel; a 50 us kernel
# before the span and a 70 us one after it, both ignored
EVENTS = [_ev("bench.decompress", "user_annotation", 0, 1000),
          _ev("turbo.d_parse", "user_annotation", 10, 90),
          _ev("fill", "kernel", 50, 50),
          _ev("turbo.d_batch", "user_annotation", 120, 680),
          _ev("turbo.d_stage", "user_annotation", 120, 80),
          _ev("turbo.d_kernel", "user_annotation", 220, 10),
          _ev("rans_decode_flat", "kernel", 250, 400),
          _ev("copy", "kernel", 850, 70)]
CALLS = [Call("compress", 0, 1.0, 1.5, 2 * MiB, MiB // 4, True),
         Call("decompress", 0, 2.0, 2.25, MiB // 4, 2 * MiB, True)]


def _read(name, events):
    work = harness.load_module(BENCH / "work" / "codec_io.py")
    rec = harness.Record(CALLS, [2 * MiB], 1.0,
                         None if events is None else TraceData(events),
                         None, 3.35e12, work)
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read(rec)


def test_kernels_inside_the_batch_span_count():
    assert _read(METRICS[0], EVENTS) == pytest.approx(0.4 / 2)   # ms per MiB
    nbytes = MiB // 4 + 2 * MiB
    assert _read(METRICS[1], EVENTS) == pytest.approx(
        100 * nbytes / 3.35e12 / 400e-6)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("events", [None, [e for e in EVENTS if e["name"] != "turbo.d_batch"],
                                    [e for e in EVENTS if e["cat"] != "kernel"]],
                         ids=["untraced", "no_span", "no_kernel"])
def test_nothing_to_read_gives_nothing(name, events):
    assert _read(name, events) is None


def test_the_metrics_list_only_the_new_cells(bench):
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert tuple(listed[name]["workloads"]) == CELLS
        assert listed[name]["moves"] == "decompress_gbps"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_marks_the_batches(cell, tiny_root, bench, tmp_path):
    # 64 KiB a call: a Proba02 group that small still codes (9000 bytes go raw)
    root = tmp_path / "h100_bench"
    shutil.copytree(tiny_root, root)
    path = root / "traffic" / f"{harness.find_cell(cell, root).spec['traffic']}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    call_bytes=1 << 16, pool=2)))
    r = harness.run(cell, 2**33 + 5, 0.2, True, device="cpu", root=root,
                    bench=bench, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    assert not set(METRICS) & set(r["metrics"])        # device-only readers
    trace = TraceData.load(tmp_path / f"trace-{cell}.json")
    batches = trace.intervals("turbo.d_batch")
    calls = trace.intervals("bench.decompress")
    assert batches and calls
    assert all(any(s <= bs and be <= e for s, e in calls) for bs, be in batches)
