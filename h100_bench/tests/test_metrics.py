"""Metric arithmetic on a synthetic record."""
import pytest

from h100_bench import harness
from h100_bench.loops.roundtrip import Call
from h100_bench.tests.conftest import BENCH
from h100_bench.trace import TraceData


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [_ev("bench.compress", "user_annotation", 0, 100),
          _ev("api.c_prep", "user_annotation", 0, 40),
          _ev("enc", "kernel", 10, 10), _ev("enc", "kernel", 50, 10),
          _ev("Memcpy DtoH", "gpu_memcpy", 90, 5),
          _ev("bench.decompress", "user_annotation", 200, 100),
          _ev("api.d_parse", "user_annotation", 200, 40),
          _ev("dec", "kernel", 250, 40),
          _ev("cudaLaunchKernel", "cuda_runtime", 49, 1)]
CALLS = [Call("compress", 0, 1.0, 1.5, 1000, 200, True),
         Call("decompress", 0, 2.0, 2.25, 200, 1000, True),
         Call("compress", 1, 3.0, 3.5, 3000, 0, False)]


def record(trace=True, stages=None):
    work = harness.load_module(BENCH / "work" / "codec_io.py")
    return harness.Record(CALLS, [1000, 3000], 12.5,
                          TraceData(EVENTS) if trace else None, stages, 1.2e9, work)


def read(name, rec):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read(rec)


def test_trace_sums():
    t = TraceData(EVENTS)
    assert t.kernel_us(t.intervals("bench.compress")) == 20
    assert t.busy_us(t.intervals("bench.compress")) == 25
    assert t.window() == (0, 300)
    assert t.top_device_ops()[0] == ["dec", 40e-6]
    gaps = dict(t.idle_gaps())
    assert gaps["outside any marked range"] == pytest.approx(100e-6)  # [100,200]
    assert gaps["api.d_parse"] == pytest.approx(40e-6)     # [200,240]
    assert gaps["bench.decompress"] == pytest.approx(20e-6)  # [240,250], [290,300]
    assert gaps["api.c_prep"] == pytest.approx(30e-6)      # [0,10] and [20,40]
    assert gaps["bench.compress"] == pytest.approx(45e-6)  # [40,50], [60,90], [95,100]


def test_host_clock_metrics():
    rec = record(trace=False)
    assert read("compress_gbps", rec) == pytest.approx(1000 / 1.0 / 1e9)
    assert read("decompress_gbps", rec) == pytest.approx(1000 / 0.25 / 1e9)
    assert read("ratio", rec) == pytest.approx(5.0)
    assert read("decompress_p95_ms", rec) == pytest.approx(250.0)
    assert read("setup_s", rec) == 12.5


def test_trace_metrics():
    rec = record(stages={"c_prep": 0.5, "c_stage": 0.1, "c_frames": 0.1,
                         "c_kernel": 9.0, "d_parse": 0.2})
    mib = 1000 / (1 << 20)
    # 1200 bytes at 1.2e9 B/s is 1 us, over 20 us of kernels
    assert read("kernels.compress_roofline_pct", rec) == pytest.approx(5.0)
    assert read("kernels.decompress_roofline_pct", rec) == pytest.approx(100 * 1 / 40)
    assert read("device.compress_idle_pct", rec) == pytest.approx(75.0)
    assert read("device.decompress_idle_pct", rec) == pytest.approx(60.0)
    assert read("api.compress_host_ms_per_mib", rec) == pytest.approx(700 / mib)
    assert read("api.decompress_host_ms_per_mib", rec) == pytest.approx(200 / mib)
    assert read("resident.host_ms_per_mib", rec) is None


def test_nothing_to_read_gives_nothing():
    rec = record(trace=False)
    for name in ("kernels.compress_roofline_pct", "device.decompress_idle_pct",
                 "api.compress_host_ms_per_mib", "resident.host_ms_per_mib"):
        assert read(name, rec) is None
    no_device = harness.Record(CALLS, [1000, 3000], 1.0, TraceData(EVENTS[:2]),
                               None, 1.2e9, rec.work)
    assert read("kernels.compress_roofline_pct", no_device) is None
    assert read("device.compress_idle_pct", no_device) is None
