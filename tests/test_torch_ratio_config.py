"""The best-ratio deployment, the CLI's `-T --ratio -G 4M` (the benchmark's
configuration turbo_ratio): ratio-mode frames of 2 and 4 MiB groups equal
the per-group twin and decode, through the port and through the
benchmark's plain reader (h100_bench/reference/turbo_rans.py), to their
input; the reader refuses altered v1 frames; api.decode_routes names the
route each decode batch took; and the benchmark's cells of this
configuration and of Proba02 run correct on the CPU at tiny traffic."""
import json
import shutil
from pathlib import Path

import pytest

from finitestateentropy_tpu_torch.turbo import api
from finitestateentropy_tpu_torch.turbo.rans import _HDR, rans_compress
from h100_bench import harness
from h100_bench.reference.turbo_rans import decode_frames
from h100_bench.traffic.proba_pool import proba_stream

REPO = Path(__file__).resolve().parent.parent
CONFIG = json.loads((REPO / "h100_bench" / "configs" / "turbo_ratio.json").read_text())
MiB = 1 << 20
# group size -> input length: two 2 MiB groups and a tail; a 4 MiB group and
# a ragged multi-MiB tail that splits at its 1 MiB boundary (group_spans)
SIZES = {2 * MiB: 4 * MiB + 300_000, 4 * MiB: 5 * MiB + 12_345}


def _ratio_args(group_size: int) -> dict:
    return dict(CONFIG["compress_args"], group_size=group_size)


@pytest.fixture(scope="module")
def frames() -> dict:
    """group size -> (input, the port's ratio-mode frame of it)."""
    out = {}
    for gs, n in SIZES.items():
        data = proba_stream(80, n, 2**31 + gs).tobytes()
        out[gs] = data, api.turbo_compress_device(data, **_ratio_args(gs),
                                                  device="cpu")
    return out


def test_the_configuration_is_the_clis_best_ratio_setting():
    assert CONFIG["compress_args"]["group_size"] == api.MAX_GROUP == 4 * MiB
    assert CONFIG["compress_args"]["steptots"] is False
    assert api.mode_flags(0, False, False, -1, -1) == (11, 0, 0)


@pytest.mark.parametrize("gs", sorted(SIZES))
def test_frames_equal_the_per_group_twin(gs, frames):
    data, blob = frames[gs]
    spans = api.group_spans(len(data), gs)
    assert len(spans) == 3 and spans[0][1] == gs
    twin = b"".join(rans_compress(data[st:st + ln], steptots=False)
                    for st, ln in spans)
    assert blob == twin
    assert len(data) / len(blob) > 8.6


@pytest.mark.parametrize("gs", sorted(SIZES))
def test_the_port_and_the_reference_decode_them(gs, frames):
    data, blob = frames[gs]
    assert api.turbo_decompress_device(blob, device="cpu") == data
    assert decode_frames([blob]) == [data]


def _v1_frame():
    """A one-group ratio-mode frame and its input, with the offsets of its
    initial states and its payload."""
    data = proba_stream(80, 100_000, 7).tobytes()
    blob = api.turbo_compress_device(data, **_ratio_args(MiB), device="cpu")
    _magic, n, csize, tlog, flags, nc_len = _HDR.unpack_from(blob, 0)
    assert (n, tlog, flags) == (len(data), 11, 0)       # coded, no section
    init = _HDR.size + (nc_len + 3) // 4 * 4
    payload = init + 4 * 1024
    assert len(blob) == payload + 2 * csize
    return data, blob, init, payload


def _flip_payload_halfword(blob, _init, payload):
    b = bytearray(blob)
    mid = payload + (len(blob) - payload) // 4 * 2
    b[mid] ^= 0x5A
    b[mid + 1] ^= 0xA5
    return bytes(b)


def _truncate_payload(blob, _init, _payload):
    return blob[:-2]


def _alter_initial_state(blob, init, _payload):
    b = bytearray(blob)
    b[init + 4 * 300 + 1] ^= 0x10
    return bytes(b)


@pytest.mark.parametrize("alter", [_flip_payload_halfword, _truncate_payload,
                                   _alter_initial_state])
def test_the_reference_refuses_altered_v1_frames(alter):
    data, blob, init, payload = _v1_frame()
    assert decode_frames([blob]) == [data]
    (got,) = decode_frames([alter(blob, init, payload)])
    assert got is None or got != data


def _route_counts(blob: bytes, data: bytes) -> dict:
    """{route: (batches, groups)} that decode_routes counted during one
    decompress of blob, for the routes it counted."""
    before = {r: dict(c) for r, c in api.decode_routes.items()}
    assert api.turbo_decompress_device(blob, device="cpu") == data
    return {r: (c["batches"] - before[r]["batches"], c["groups"] - before[r]["groups"])
            for r, c in api.decode_routes.items() if c != before[r]}


@pytest.mark.parametrize("mode", ["ratio", "speed"])
def test_decode_routes_name_the_route(mode):
    data = proba_stream(80, 3 * 65536 + 20_000, 11).tobytes()
    steptots = mode == "speed"
    blob = api.turbo_compress_device(data, 65536, steptots=steptots,
                                     device="cpu")
    _pieces, batches = api.plan_decode(api.parse_groups(blob))
    routes = _route_counts(blob, data)
    assert sum(b for b, _g in routes.values()) == len(batches) == 2
    assert sum(g for _b, g in routes.values()) == 4
    if steptots:
        assert set(routes) <= {"v2", "w"}
    else:
        assert set(routes) == {"flat"}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark's folder with its traffic cut to a few KiB a
    call (as h100_bench/tests/conftest.py cuts it)."""
    root = tmp_path_factory.mktemp("bench") / "h100_bench"
    shutil.copytree(REPO / "h100_bench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in root.glob("traffic/*.json"):
        t = json.loads(path.read_text())
        t.update(call_bytes=9000, stream_bytes=1 << 17, pool=min(t["pool"], 6))
        path.write_text(json.dumps(t))
    return root


@pytest.mark.parametrize("cell", ["turbo_ratio.p80_64m", "turbo_speed.p02_64m"])
def test_the_new_cells_run_correct_on_the_cpu(cell, tiny_root):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert cell in {w["name"] for w in bench["workloads"]}
    r = harness.run(cell, 2**31 + 29, 0.1, False, device="cpu", root=tiny_root,
                    bench=bench)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert {"decompress_gbps", "ratio", "setup_s"} == set(r["metrics"])
