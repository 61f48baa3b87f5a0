"""The port's program spans (utils/trace.py): free when no profiler runs,
and under torch.profiler every entry point's stages nested in its entry's
span, with the names the benchmark's span metrics read.  The entries: the
TurboRANS entry points, the resident pipeline, and the frame layer
(io/frame.py) over the FSE and Huff0 device codecs (models/)."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from finitestateentropy_tpu_torch.io.frame import compress_bytes, decompress_bytes
from finitestateentropy_tpu_torch.models import fse_codec, get_batch_codec
from finitestateentropy_tpu_torch.turbo import api
from finitestateentropy_tpu_torch.turbo.device_api import (
    rans_compress_resident, rans_decompress_resident)
from finitestateentropy_tpu_torch.utils import generate_proba, trace

REPO = Path(__file__).resolve().parent.parent
GROUP = 1 << 15

HOST_SPANS = {"turbo.compress": {"turbo.c_prep", "turbo.c_stage", "turbo.c_h2d",
                                 "turbo.c_kernel", "turbo.c_d2h", "turbo.c_frames",
                                 "turbo.prep.byte", "turbo.prep.pair",
                                 "turbo.prep.quad", "turbo.prep.pick",
                                 "turbo.pool.prep", "turbo.pool.stage"},
              "turbo.decompress": {"turbo.d_parse", "turbo.d_stage", "turbo.d_h2d",
                                   "turbo.d_batch", "turbo.d_kernel", "turbo.d_d2h",
                                   "turbo.d_copy", "turbo.d_join"}}
RESIDENT_SPANS = {"resident.compress": {"resident.slice", "resident.hist",
                                        "resident.norm", "resident.tables",
                                        "resident.pad", "resident.encode",
                                        "resident.d2h", "resident.frames"},
                  "resident.decompress": {"resident.d_parse", "resident.d_h2d",
                                          "resident.d_stage", "resident.d_kernel",
                                          "resident.d_err", "resident.d_join"}}
FRAME_C = {"frame.c_blocks", "frame.c_write", "frame.c_checksum"}
FRAME_D = {"frame.d_read", "frame.d_blocks", "frame.d_write", "frame.d_checksum"}
CODEC_C = ("c_prep", "c_stage", "c_h2d", "c_encode", "c_d2h", "c_frames")
CODEC_D = ("d_parse", "d_h2d", "d_tables", "d_decode", "d_d2h", "d_out")
COMPAT_SPANS = {codec: {"frame.compress": FRAME_C | {f"{codec}.{s}" for s in CODEC_C + extra},
                        "frame.decompress": FRAME_D | {f"{codec}.{s}" for s in CODEC_D}}
                for codec, extra in (("fse", ("c_tables",)), ("huf", ()))}
# the benchmark's metrics that read program spans
SPAN_METRICS = ("resident.host_ms_per_mib", "resident.decompress_host_ms_per_mib",
                "resident.decompress_h2d_ms_per_mib", "api.prep_byte_ms_per_mib",
                "api.prep_wires_ms_per_mib", "compat.compress_checksum_ms_per_mib",
                "compat.compress_host_ms_per_mib", "compat.decompress_checksum_ms_per_mib",
                "compat.decompress_host_ms_per_mib", "kernels.decode_batch_ms_per_mib",
                "kernels.decode_batch_roofline_pct", "api.pool_ms_per_mib",
                "api.pool_parallelism")


def _data() -> bytes:
    """Four groups: Proba80 twice, an RLE group and a near-uniform (raw) one."""
    rng = np.random.default_rng(5)
    return (generate_proba(80, 2 * GROUP) + b"\7" * GROUP
            + rng.integers(0, 256, GROUP, dtype=np.uint8).tobytes())


def _host(data: bytes):
    blob = api.turbo_compress_device(data[:GROUP], GROUP, device="cpu")
    assert api.turbo_decompress_device(blob, device="cpu") == data[:GROUP]
    return blob


def _resident(data: bytes):
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    blob = rans_compress_resident(x, GROUP)
    assert rans_decompress_resident(blob, device="cpu").numpy().tobytes() == data
    return blob


def _compat(codec: str):
    """A frame round trip through a device codec's plain versions, in 1 KiB
    blocks (the plain chains step a symbol at a time): coded, RLE and raw
    blocks."""
    def run(data: bytes):
        comp, decomp = get_batch_codec(codec, block_size=1024, device="cpu")
        frame = compress_bytes(data, codec, 0, comp)
        assert decompress_bytes(frame, decomp) == data
        return frame
    return run


ENTRIES = {"host": (_host, HOST_SPANS), "resident": (_resident, RESIDENT_SPANS),
           "fse": (_compat("fse"), COMPAT_SPANS["fse"]),
           "huf": (_compat("huf"), COMPAT_SPANS["huf"])}


def _traced(run, tmp_path):
    """(the run's result, [(name, start_us, end_us)] of its spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(_data())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return out, spans


@pytest.fixture(scope="module")
def emitted(tmp_path_factory) -> set:
    """Every span name the entry points emit."""
    names = set()
    for run, _expect in ENTRIES.values():
        _out, spans = _traced(run, tmp_path_factory.mktemp("trace"))
        names |= {n for n, _s, _e in spans}
    return names


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_profiler_never_enters_record_function(entry, monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(trace, "record_function", boom)
    assert trace.span("x") is trace.span("y")      # the one shared no-op
    ENTRIES[entry][0](_data())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_stage_span_nests_in_its_entry_span(entry, tmp_path):
    run, expect = ENTRIES[entry]
    blob, spans = _traced(run, tmp_path)
    assert blob == run(_data())                    # traced frames are the same
    for outer, inner in expect.items():
        calls = [(s, e) for n, s, e in spans if n == outer]
        assert len(calls) == 1, (outer, calls)
        (s0, e0), = calls
        seen = {n for n, s, e in spans if s0 <= s and e <= e0 and n != outer}
        assert inner <= seen, (outer, inner - seen)
    named = {n for n, _s, _e in spans}
    assert named <= set(expect) | set().union(*expect.values())


@pytest.mark.parametrize("traced", [False, True])
def test_stage_spans_without_a_sync(traced, monkeypatch, tmp_path):
    """_stage with stage_seconds None syncs nothing, traced or not, and
    under a profiler is the span "turbo.<stage>"."""
    def no_sync(*_a):
        raise AssertionError("torch.cuda.synchronize with stage_seconds None")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(api, "stage_seconds", None)

    def run(_data):
        with api._stage("c_kernel", torch.device("cuda")):
            pass

    if not traced:
        run(None)
        return
    _out, spans = _traced(run, tmp_path)
    assert [n for n, _s, _e in spans] == ["turbo.c_kernel"]


@pytest.mark.parametrize("traced", [False, True])
def test_codec_stage_spans_without_a_sync(traced, monkeypatch, tmp_path):
    """The compat codecs' _stage with stage_seconds None syncs nothing, even
    for a device stage, and under a profiler is the span it names."""
    def no_sync(*_a):
        raise AssertionError("torch.cuda.synchronize with stage_seconds None")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(fse_codec, "stage_seconds", None)

    def run(_data):
        with fse_codec._stage("fse.c_encode", torch.device("cuda"), sync=True):
            pass

    if not traced:
        run(None)
        return
    _out, spans = _traced(run, tmp_path)
    assert [n for n, _s, _e in spans] == ["fse.c_encode"]


@pytest.mark.parametrize("codec", sorted(COMPAT_SPANS))
def test_codec_stage_seconds_keep_their_names(codec, monkeypatch):
    """stage_seconds, on, times every stage of a round trip under its bare
    name (the Huff0 codec's too, into the FSE module's dict)."""
    monkeypatch.setattr(fse_codec, "stage_seconds", {})
    ENTRIES[codec][0](_data())
    spans = set().union(*COMPAT_SPANS[codec].values())
    assert sorted(fse_codec.stage_seconds) == sorted(
        n.split(".", 1)[1] for n in spans if n.startswith(codec + "."))
    assert min(fse_codec.stage_seconds.values()) >= 0


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metrics_read_emitted_names(metric, emitted):
    """A metric's span names are among those the program emits: a rename
    on either side fails here, not silently in the benchmark."""
    tree = ast.parse((REPO / "h100_bench" / "metrics" / f"{metric}.py").read_text())
    names = {c.value for c in ast.walk(tree) if isinstance(c, ast.Constant)
             and isinstance(c.value, str)
             and c.value.startswith(("turbo.", "resident.", "frame.", "fse."))}
    assert names and names <= emitted, names - emitted
