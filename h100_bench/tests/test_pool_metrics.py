"""The metrics of the encode pool (api.pool_ms_per_mib, api.pool_parallelism,
api.pool_cpu_pct): they list the one host cell that reports compress_gbps,
and a traced CPU run of it, made to have several groups a call and a pool
of four threads, reports all three."""
import json
import os
import shutil

import pytest

from h100_bench import harness
from h100_bench.tests.conftest import BENCH

POOL_METRICS = ("api.pool_ms_per_mib", "api.pool_parallelism", "api.pool_cpu_pct")
GROUP = 4096
GROUPS = 3


@pytest.fixture(scope="module")
def pool_root(tmp_path_factory):
    """A copy of the benchmark's folder whose turbo_speed calls are three
    4 KiB groups each."""
    root = tmp_path_factory.mktemp("bench") / "h100_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = root / "configs" / "turbo_speed.json"
    c = json.loads(cfg.read_text())
    c["compress_args"]["group_size"] = GROUP
    cfg.write_text(json.dumps(c))
    for path in root.glob("traffic/*.json"):
        t = json.loads(path.read_text())
        t.update(call_bytes=GROUPS * GROUP, stream_bytes=1 << 17, pool=min(t["pool"], 6))
        path.write_text(json.dumps(t))
    return root


def test_pool_metrics_listed_in_the_compress_cell(bench):
    compress, = [m for m in bench["end_to_end"] if m["name"] == "compress_gbps"]
    for name in POOL_METRICS:
        m, = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == ["turbo_speed.p80_1m"]
        assert set(m["workloads"]) <= set(compress["workloads"])
        assert m["layer"] == "entry points (turbo/api.py)"
        assert m["moves"] == "compress_gbps"


def test_traced_run_with_a_pool_reports_the_pool_metrics(
        pool_root, bench, tmp_path, monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    r = harness.run("turbo_speed.p80_1m", 2**31 + 29, 0.2, True, device="cpu",
                    root=pool_root, bench=bench, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    got = {name: r["metrics"][name]["value"] for name in POOL_METRICS}
    assert all(v > 0 for v in got.values()), got
    # no more items in flight than a call has groups; no more CPU than wall
    assert got["api.pool_parallelism"] <= GROUPS * 1.01, got
    assert got["api.pool_cpu_pct"] <= 105, got
