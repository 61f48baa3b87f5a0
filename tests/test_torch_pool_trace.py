"""The encode pool's items under torch.profiler (turbo/api.py's _map): each
item is a "turbo.pool.<name>" span on the thread that ran it, inside the
calling thread's stage span, and its wall and CPU seconds are summed in
api.pool_seconds.  Untraced, _map is what it was: no thread-state library,
no clock reads.  Without the library, a traced map still gives the same
frames, its workers' spans dropped."""
import json
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from finitestateentropy_tpu_torch.turbo import api
from finitestateentropy_tpu_torch.utils import debug, generate_proba, profiler_tls

GROUP = 1 << 14
CODED = 5          # Proba80 groups; one RLE group follows, which is not staged


@pytest.fixture(scope="module")
def data() -> bytes:
    return generate_proba(80, CODED * GROUP) + b"\3" * GROUP


@pytest.fixture(scope="module")
def untraced(data) -> bytes:
    return api.turbo_compress_device(data, GROUP, device="cpu")


@pytest.fixture
def pool_of(monkeypatch):
    """Set the host's core count that _map sizes its pool by; the prep of a
    group is slowed, so the pool's threads all take items at once."""
    prep = api.prep_group

    def slow(ch, table_log):
        time.sleep(0.01)
        return prep(ch, table_log)

    monkeypatch.setattr(api, "prep_group", slow)

    def set_cores(n: int):
        monkeypatch.setattr(api.os, "cpu_count", lambda: n)
    return set_cores


def _traced(data: bytes, tmp_path):
    """(frame, the caller's tid, [(name, tid, start_us, end_us)] of the spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = api.turbo_compress_device(data, GROUP, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    caller, = {t for n, t, _s, _e in spans if n == "turbo.compress"}
    return out, caller, spans


def _inside(span, outers) -> bool:
    _n, _t, s, e = span
    return any(s0 <= s and e <= e0 for _n0, _t0, s0, e0 in outers)


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def test_pool_spans_lie_on_the_workers_inside_the_callers_stage(
        data, untraced, pool_of, tmp_path):
    pool_of(4)
    out, caller, spans = _traced(data, tmp_path)
    assert out == untraced
    preps, stages = _named(spans, "turbo.pool.prep"), _named(spans, "turbo.pool.stage")
    assert len(preps) == CODED + 1                    # one a group
    assert len(stages) == CODED                       # one a staged group
    assert len({t for _n, t, _s, _e in preps} - {caller}) >= 2
    assert all(_inside(sp, _named(spans, "turbo.c_prep")) for sp in preps)
    assert all(_inside(sp, _named(spans, "turbo.c_stage")) for sp in stages)
    # plan_encode's own spans nest in the item's, on the item's thread
    for name in ("turbo.prep.byte", "turbo.prep.quad"):
        inner = _named(spans, name)
        assert inner and all(
            _inside(sp, [p for p in preps if p[1] == sp[1]]) for sp in inner), name
    assert len(_named(spans, "turbo.prep.byte")) == CODED + 1


def test_one_worker_opens_the_spans_on_the_calling_thread(
        data, untraced, pool_of, tmp_path, monkeypatch):
    def refuse():
        raise AssertionError("the thread-state library loaded for one worker")

    monkeypatch.setattr(profiler_tls, "_load", refuse)
    pool_of(1)
    out, caller, spans = _traced(data, tmp_path)
    assert out == untraced
    pool = [sp for sp in spans if sp[0].startswith("turbo.pool.")]
    assert len(pool) == 2 * CODED + 1
    assert {t for _n, t, _s, _e in pool} == {caller}


def test_untraced_map_loads_nothing_and_reads_no_clock(
        data, untraced, pool_of, monkeypatch):
    def refuse(*_a):
        raise AssertionError("untraced _map reached the traced path")

    monkeypatch.setattr(profiler_tls, "_load", refuse)
    monkeypatch.setattr(api.time, "thread_time_ns", refuse)
    monkeypatch.setattr(api, "_map_traced", refuse)
    before = dict(api.pool_seconds)
    pool_of(4)
    assert api.turbo_compress_device(data, GROUP, device="cpu") == untraced
    assert api.pool_seconds == before


def test_without_the_library_the_workers_run_unjoined(
        data, untraced, pool_of, tmp_path, monkeypatch, capsys):
    """A compiler that is not there: the build fails, debuglog says so
    once, and traced compresses give the same frames, with no pool span
    on any thread but the caller's."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(profiler_tls, "_lib", None)
    monkeypatch.setattr(profiler_tls, "_tried", False)
    monkeypatch.setattr(debug, "g_debuglevel", 1)
    pool_of(4)
    for _ in range(2):
        out, caller, spans = _traced(data, tmp_path)
        assert out == untraced
        assert {t for n, t, _s, _e in spans if n.startswith("turbo.pool.")} <= {caller}
    assert capsys.readouterr().err.count("profiler_tls unavailable") == 1


def test_pool_seconds_count_every_item(data, untraced, pool_of, tmp_path):
    pool_of(4)
    before = dict(api.pool_seconds)
    _traced(data, tmp_path)
    got = {k: api.pool_seconds[k] - before[k] for k in before}
    assert got["items"] == (CODED + 1) + CODED        # groups + staged groups
    assert got["calls"] >= 2                          # the prep, each stage batch
    assert 0 < got["cpu"] <= got["wall"] * 1.05


def test_a_workers_exception_reaches_the_caller(data, pool_of, monkeypatch):
    def boom(_ch, _table_log):
        raise ValueError("prep failed")

    pool_of(4)
    monkeypatch.setattr(api, "prep_group", boom)
    before = dict(api.pool_seconds)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="prep failed"):
            api.turbo_compress_device(data, GROUP, device="cpu")
    # the map is counted; items not yet started when one raised are cancelled
    assert api.pool_seconds["calls"] == before["calls"] + 1
    assert 1 <= api.pool_seconds["items"] - before["items"] <= CODED + 1
