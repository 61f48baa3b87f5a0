"""The in-place parse of TurboRANS frames.

parse_groups and parse_groups16 read a frame through one memoryview and
hand each group's parser a view at the group's offset.  Held here: the
parsed groups equal each group's own parse of its bytes; a payload is a
view of the frame, so nothing copies the rest of it; a cut or flipped
frame raises what the JAX package's parse loop raises on the same bytes,
or parses to equal groups; the decode entries and pack_stream_words take
the views as they took bytes.
"""
import numpy as np
import pytest

import finitestateentropy_tpu.turbo.rans as j_rans
import finitestateentropy_tpu.turbo.rans16 as j_rans16
import finitestateentropy_tpu.turbo.rans_kernels as j_kern
from finitestateentropy_tpu_torch.turbo import api, device_api, tables
from finitestateentropy_tpu_torch.turbo.pair import pair_compress
from finitestateentropy_tpu_torch.turbo.quad import quad_compress
from finitestateentropy_tpu_torch.turbo.rans import (FLAG_PAIR, FLAG_QUAD,
                                                     FLAG_RAW, FLAG_RLE,
                                                     FLAG_ROWS4, FLAG_TOTALS,
                                                     _HDR, parse_rans_group,
                                                     rans_compress)
from finitestateentropy_tpu_torch.turbo.rans16 import (parse_rans16_group,
                                                       rans16_compress)
from finitestateentropy_tpu_torch.utils.probagen import generate_proba

CORPORA = {"p80": 80, "p14": 14, "p02": 2}
SIZES = (16384, 9001, 32768, 4096, 1)


def _wire(data: bytes, k: int) -> bytes:
    """Group k of a corpus frame: byte, pair and quad in turn, the byte
    wire where a pair or quad group is ineligible."""
    blob = (None, pair_compress, quad_compress)[k % 3]
    blob = blob and blob(data)
    return blob if blob is not None else rans_compress(data)


def _corpus_groups(p: int) -> tuple[list[bytes], bytes]:
    data = generate_proba(p, sum(SIZES))
    cuts = np.cumsum((0,) + SIZES)
    chunks = [data[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    return [_wire(c, k) for k, c in enumerate(chunks)], data


def _mixed_groups() -> tuple[list[bytes], bytes]:
    """Raw, RLE, byte (rows4, totals, v1), pair (rows, v1) and quad."""
    p80 = generate_proba(80, 1 << 16)
    rng = np.random.default_rng(18)
    chunks = [
        (rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(), rans_compress),
        (b"\x07" * 7000, rans_compress),
        (p80[:20000], rans_compress),
        (p80[20000:30000], lambda d: rans_compress(d, totals_only=True)),
        (p80[30000:41000], lambda d: rans_compress(d, steptots=False)),
        (p80[41000:53000], pair_compress),
        (p80[53000:59000], lambda d: pair_compress(d, steptots=False)),
        (p80, quad_compress),
    ]
    groups = [twin(d) for d, twin in chunks]
    assert None not in groups
    return groups, b"".join(d for d, _twin in chunks)


def _u16_groups(alphabet: str) -> list[bytes]:
    """Coded (speed and ratio), RLE and raw U16 groups."""
    rng = np.random.default_rng(7)
    top = 1023 if alphabet == "u16" else 4095
    s = np.clip((rng.pareto(1.1, 30000) * 80).astype(np.int64), 0, top)
    s = s.astype(np.uint16)
    return [rans16_compress(s[:20000]), rans16_compress(s[20000:], False),
            rans16_compress(np.full(3000, 9, np.uint16)),
            rans16_compress(rng.integers(0, 4096, 3000).astype(np.uint16))]


FRAMES = {name: (lambda p=p: _corpus_groups(p)) for name, p in CORPORA.items()}
FRAMES["mixed"] = _mixed_groups


def _same(a, b) -> bool:
    """Slot-by-slot equality of parsed groups: arrays by dtype and values,
    bytes and memoryviews by their bytes."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (bytes, memoryview)):
        return isinstance(b, (bytes, memoryview)) and bytes(a) == bytes(b)
    return a == b


def _address(buf) -> int:
    return np.frombuffer(buf, np.uint8).__array_interface__["data"][0]


def _jax_parse(blob: bytes, parse=j_rans.parse_rans_group) -> list:
    """The JAX package's parse loop (turbo/api.py, both decompress
    entries): every group parsed from a copy of the rest of the frame."""
    groups, pos = [], 0
    while pos < len(blob):
        g, used = parse(blob[pos:])
        groups.append(g)
        pos += used
    return groups


def _outcome(fn, blob):
    try:
        return "ok", fn(blob)
    except Exception as e:  # noqa: BLE001 - the exception type is compared
        return type(e).__name__, None


def _parity(blob: bytes, port=api.parse_groups,
            jax=j_rans.parse_rans_group) -> None:
    """The port's parse raises the same exception type as the JAX
    package's loop on these bytes, or both return equal groups."""
    got, want = _outcome(port, blob), _outcome(lambda b: _jax_parse(b, jax), blob)
    assert got[0] == want[0], (got[0], want[0])
    if got[0] == "ok":
        assert _same(got[1], want[1])


@pytest.mark.parametrize("name", list(FRAMES))
def test_parse_groups_equal_each_groups_parse(name):
    parts, _data = FRAMES[name]()
    blob = b"".join(parts)
    got = api.parse_groups(blob)
    assert len(got) == len(parts)
    for g, part in zip(got, parts):
        want, used = parse_rans_group(bytes(part))
        assert used == len(part) and _same(g, want)
        assert isinstance(want[7], bytes)     # bytes in, bytes out


@pytest.mark.parametrize("name", list(FRAMES))
def test_parse_groups_payloads_view_the_frame(name):
    parts, _data = FRAMES[name]()
    blob = b"".join(parts)
    base = _address(blob)
    start = 0
    for g, part in zip(api.parse_groups(blob), parts):
        assert isinstance(g[7], memoryview) and g[7].obj is blob
        # the payload sits in the frame's own memory: after a raw or RLE
        # group's header, at the end of a coded group
        at = (start + _HDR.size if g[3] & (FLAG_RAW | FLAG_RLE)
              else start + len(part) - len(g[7]))
        assert _address(g[7]) == base + at
        start += len(part)


def test_parse_groups_mixed_frame_has_every_section():
    parts, _data = _mixed_groups()
    flags = [g[3] for g in api.parse_groups(b"".join(parts))]
    assert flags[0] & FLAG_RAW and flags[1] & FLAG_RLE
    assert flags[2] & FLAG_ROWS4 and flags[3] == FLAG_TOTALS
    assert flags[4] == 0
    assert flags[5] & FLAG_PAIR and flags[6] & FLAG_PAIR
    assert flags[7] & FLAG_QUAD


@pytest.mark.parametrize("alphabet", ["u16", "u16x"])
def test_parse_groups16_equal_each_groups_parse(alphabet):
    parts = _u16_groups(alphabet)
    blob = b"".join(parts)
    got = api.parse_groups16(blob)
    assert [g[3] & 3 for g in got] == [0, 0, 2, 1]
    for g, part in zip(got, parts):
        want, used = parse_rans16_group(bytes(part))
        assert used == len(part) and _same(g, want)
        assert isinstance(g[7], memoryview) and g[7].obj is blob
    _parity(blob, api.parse_groups16, j_rans16.parse_rans16_group)


@pytest.mark.parametrize("name", ["p80", "mixed"])
def test_cut_frames_match_jax(name):
    """Cut at every group boundary and at a seeded sample of offsets
    inside the groups (the headers among them)."""
    parts, _data = FRAMES[name]()
    blob = b"".join(parts)
    starts = np.cumsum([0] + [len(p) for p in parts])
    rng = np.random.default_rng(1800 + len(blob))
    cuts = set(int(s) for s in starts)
    for s in starts[:-1]:
        cuts.update(int(s) + k for k in (1, 8, 15, 16, 17, 20))
    cuts.update(int(c) for c in rng.integers(1, len(blob), 40))
    for cut in sorted(c for c in cuts if c <= len(blob)):
        _parity(blob[:cut])


def _rows4_span(part: bytes) -> tuple[int, int]:
    """[start, end) of a rows4 group's step-count section: after the init
    states, before the payload."""
    g, used = parse_rans_group(part)
    start = part.find(g[6].tobytes()) + len(g[6]) * 4
    return start, used - 2 * g[1]


@pytest.mark.parametrize("name", ["p14", "mixed"])
def test_flipped_headers_match_jax(name):
    parts, _data = FRAMES[name]()
    blob = b"".join(parts)
    starts = np.cumsum([0] + [len(p) for p in parts])
    rng = np.random.default_rng(1801)
    for s in starts[:-1]:
        for k in range(_HDR.size):
            for x in (0x01, 0x80, int(rng.integers(1, 256))):
                b = bytearray(blob)
                b[int(s) + k] ^= x
                _parity(bytes(b))


@pytest.mark.parametrize("name", ["p80", "mixed"])
def test_flipped_rows4_sections_match_jax(name):
    parts, _data = FRAMES[name]()
    blob = b"".join(parts)
    rng = np.random.default_rng(1802)
    pos, n_rows4 = 0, 0
    for part in parts:
        if parse_rans_group(part)[0][3] & FLAG_ROWS4:
            n_rows4 += 1
            a, b_ = _rows4_span(part)
            # the escape count, the escape records and a sample of counts
            offs = set(range(a, min(a + 12, b_)))
            offs.update(int(o) for o in rng.integers(a, b_, 12))
            for o in sorted(offs):
                for x in (0x01, 0xF0, 0xFF):
                    b = bytearray(blob)
                    b[pos + o] ^= x
                    _parity(bytes(b))
        pos += len(part)
    assert n_rows4 >= 2


def test_decode_entries_take_views():
    """The staging, raw, RLE and U16 consumers of the views decode each
    frame as before (plain versions on the CPU)."""
    parts, data = _mixed_groups()
    assert api.turbo_decompress_device(b"".join(parts), device="cpu") == data
    byte_parts = parts[:5]
    lens = (5000, 7000, 20000, 10000, 11000)
    out = device_api.rans_decompress_resident(b"".join(byte_parts), device="cpu")
    assert out.numpy().tobytes() == data[:sum(lens)]
    u16 = _u16_groups("u16x")
    want = np.concatenate([j_rans16.rans16_decompress(p) for p in u16])
    got = api.turbo16_decompress_device(b"".join(u16), device="cpu")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_pack_stream_words_view_equals_bytes(tail):
    payload = generate_proba(80, 4 * 300 + tail)
    framed = b"\xaa" * 5 + payload + b"\x55" * 7
    view = memoryview(framed)[5:5 + len(payload)]
    srows = tables.stream_word_rows(2 * 300 + 16)
    want = tables.pack_stream_words(payload, srows)
    assert np.array_equal(tables.pack_stream_words(view, srows), want)
    assert np.array_equal(j_kern.pack_stream_words(payload, srows), want)
    assert want.dtype == np.int32 and want.shape == (srows, 128)
