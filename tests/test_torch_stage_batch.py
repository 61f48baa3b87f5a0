"""The decode stager, api.stage_decode_batch, stages a batch as one batch.

It builds every group's decode table in one pass over the batch and
copies the payloads, init states and sections in one pass of slice
copies, on the calling thread.  Held here: its seven outputs equal, array
for array and dtype for dtype, the per-group staging it replaced (each
table from tables.pack_*_dtable, the words from pack_stream_words, the
init views and the sections), for every wire (byte, pair, quad, u16,
u16x), section kind (0 none, 1 totals, 2 rows), tableLog from 5 to 12
(13 for u16x), batches of 1, 2 and 64 groups with unequal payloads, and
frames that mix wires with raw and RLE groups; norms the parsers never
give reach the per-group packers; a corrupt frame raises the type the
per-group staging raised; no thread is started; stage_counts counts
batches and groups.
"""
import concurrent.futures
import threading
from functools import lru_cache

import numpy as np
import pytest

from finitestateentropy_tpu_torch.refimpl.ncount import fse_write_ncount
from finitestateentropy_tpu_torch.refimpl.norm import fse_normalize_count
from finitestateentropy_tpu_torch.turbo import api, tables
from finitestateentropy_tpu_torch.turbo.format import TURBO_LANES
from finitestateentropy_tpu_torch.turbo.pair import pair_compress
from finitestateentropy_tpu_torch.turbo.quad import quad_compress
from finitestateentropy_tpu_torch.turbo.rans import rans_compress
from finitestateentropy_tpu_torch.turbo.rans16 import (
    FLAG_STEPTOTS as FL16_STEPTOTS, RANS16_MAGIC, _HDR as HDR16, _pad_n16,
    parse_rans16_group, rans16_compress)
from finitestateentropy_tpu_torch.utils.probagen import generate_proba

TLOGS = (5, 6, 7, 10, 11, 12)
U16X_TLOGS = (7, 12, 13)
PACKERS = {"byte": lambda g, t: tables.pack_rans_dtable(g[4], t),
           "pair": lambda g, t: tables.pack_pair_dtable(g[4], g[9], t),
           "quad": lambda g, t: tables.pack_quad_dtable(g[4], g[9], t),
           "u16": lambda g, t: tables.pack_rans16_dtable(g[4], t),
           "u16x": lambda g, t: tables.pack_rans16x_dtable(g[4], t)}


def per_group_stage(groups, idxs, n_pad, tlog, wire, kind):
    """The staging stage_decode_batch replaced: each group's table,
    words, init states and section in turn."""
    G = len(idxs)
    hrows = api._round8(max((groups[i][1] + 127) // 128 for i in idxs) + 16)
    srows = tables.stream_word_rows(hrows)
    T = n_pad // TURBO_LANES
    tbl = np.zeros((G, tables.tch_of(wire, tlog), 128), np.int32)
    init = np.zeros((G, 8, 128), np.int32)
    hws = np.zeros((G, srows, 128), np.int32)
    cs = np.zeros(G, np.int32)
    tots = (None if kind == 0 else
            np.zeros((G, T) if kind == 1 else (G, T, 8), np.int32))
    for j, i in enumerate(idxs):
        g = groups[i]
        tbl[j] = PACKERS[wire](g, tlog)
        init[j] = g[6].view(np.int32).reshape(8, 128)
        hws[j] = tables.pack_stream_words(g[7], srows)
        cs[j] = g[1]
        if kind:
            tots[j] = g[8]
    return cs, tbl, init, hws, tots, api._wire_t4(wire, n_pad), hrows


def _skewed(k: int, n: int, seed: int) -> bytes:
    """n bytes over k symbols, geometric weights that the seed varies."""
    rng = np.random.default_rng(seed)
    w = (0.4 + 0.1 * (seed % 3)) ** np.arange(k) + 0.02
    return rng.choice(k, n, p=w / w.sum()).astype(np.uint8).tobytes()


def _byte_like(wire: str, tlog: int, kind: int, seed: int) -> bytes:
    """One group of the byte, pair or quad wire at tableLog tlog: a
    small alphabet below tableLog 10 so that the minimum tableLog allows
    it, enough symbols above it that the optimal tableLog keeps it."""
    n = 90000 if wire != "byte" else 40000
    k = 2 if tlog < 10 else {"byte": 40, "pair": 12, "quad": 4}[wire]
    data = _skewed(k, n - 64 * (seed % 5), seed)
    if wire == "byte":
        return rans_compress(data, tlog, steptots=kind != 0,
                             totals_only=kind == 1)
    if wire == "pair":
        return pair_compress(data, tlog, steptots=kind == 2)
    return quad_compress(data, tlog)


def _u16_group(wire: str, tlog: int, kind: int, seed: int, n: int = 20000) -> bytes:
    """A U16 group at any tableLog: a norm of a few symbols up to max_sv
    (above 1023 on u16x), its NCount, and seeded init states, section and
    payload; the stager only copies the latter, so they need not decode."""
    rng = np.random.default_rng(seed)
    max_sv = int(rng.integers(1024, 4096) if wire == "u16x"
                 else rng.integers(8, 1024))
    total = min(1 << (tlog - 1), 4096)
    syms = np.unique(np.concatenate([rng.integers(0, max_sv, min(6, total) - 1),
                                     [max_sv]]))
    count = np.zeros(max_sv + 1, np.int64)
    count[syms] = 1
    count[syms[0]] += total - len(syms)
    norm, got = fse_normalize_count(tlog, count, total, max_sv, max_table_log=13)
    assert got == tlog
    ncount = fse_write_ncount(norm, max_sv, tlog)
    cs = int(rng.integers(200, 6000))
    T = _pad_n16(n) // TURBO_LANES
    sect = rng.integers(0, 256, T * 8, dtype=np.uint8).tobytes() if kind else b""
    return (HDR16.pack(RANS16_MAGIC, n, cs, tlog, FL16_STEPTOTS if kind else 0,
                       len(ncount))
            + ncount + b"\0" * (-len(ncount) % 4)
            + rng.integers(0, 256, 4 * TURBO_LANES, dtype=np.uint8).tobytes()
            + sect + rng.integers(0, 256, 2 * cs, dtype=np.uint8).tobytes())


def _group(wire, tlog, kind, seed):
    return (_u16_group(wire, tlog, kind, seed) if wire.startswith("u16")
            else _byte_like(wire, tlog, kind, seed))


def _u16_mixed() -> bytes:
    """Coded u16 and u16x groups (speed and ratio), RLE and raw."""
    rng = np.random.default_rng(7)
    s = np.clip((rng.pareto(1.1, 30000) * 80).astype(np.int64), 0, 4095)
    s = s.astype(np.uint16)
    return b"".join([rans16_compress(np.minimum(s[:12000], 1023)),
                     rans16_compress(s[12000:24000]),
                     rans16_compress(s[24000:], False),
                     rans16_compress(np.full(3000, 9, np.uint16)),
                     rans16_compress(rng.integers(0, 4096, 3000).astype(np.uint16))])


def _corpus(p: int) -> bytes:
    """Proba p in 20 KiB groups: byte, pair and quad in turn, the byte
    wire where a pair or quad group is ineligible."""
    data = generate_proba(p, 6 * 20480)
    out = []
    for k in range(6):
        chunk = data[k * 20480 : (k + 1) * 20480]
        blob = (None, pair_compress, quad_compress)[k % 3]
        blob = blob and blob(chunk)
        out.append(blob if blob is not None else rans_compress(chunk))
    return b"".join(out)


def _mixed() -> bytes:
    """Raw, RLE, byte (rows4, totals, v1), pair (rows, v1) and quad."""
    p80 = generate_proba(80, 1 << 16)
    rng = np.random.default_rng(18)
    return b"".join([
        rans_compress(rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()),
        rans_compress(b"\x07" * 7000),
        rans_compress(p80[:20000]),
        rans_compress(p80[20000:30000], totals_only=True),
        rans_compress(p80[30000:41000], steptots=False),
        pair_compress(p80[41000:53000]),
        pair_compress(p80[53000:59000], steptots=False),
        quad_compress(p80)])


CASES = {}     # name -> (blob builder, U16 stream?, {(wire, tlog, kind, G)} that must appear)
for _w, _kinds in (("byte", (0, 1, 2)), ("pair", (0, 2)), ("quad", (2,)),
                   ("u16", (0, 2)), ("u16x", (0, 2))):
    for _t in (U16X_TLOGS if _w == "u16x" else TLOGS):
        for _k in _kinds:
            CASES[f"{_w}-t{_t}-k{_k}"] = (
                lambda w=_w, t=_t, k=_k: b"".join(_group(w, t, k, s) for s in (1, 2)),
                _w.startswith("u16"), {(_w, _t, _k, 2)})
for _w, _t, _k in (("byte", 10, 2), ("pair", 10, 2), ("quad", 10, 2),
                   ("u16", 11, 2), ("u16x", 12, 2)):
    CASES[f"{_w}-g1"] = (lambda w=_w, t=_t, k=_k: _group(w, t, k, 3),
                         _w.startswith("u16"), {(_w, _t, _k, 1)})
CASES["byte-g64"] = (lambda: b"".join(_byte_like("byte", 10, 2, s)
                                      for s in range(64)),
                     False, {("byte", 10, 2, 64)})
CASES["u16x-g64"] = (lambda: b"".join(_u16_group("u16x", 13, 2, s)
                                      for s in range(64)),
                     True, {("u16x", 13, 2, 64)})
CASES["p80"] = (lambda: _corpus(80), False, set())
CASES["p14"] = (lambda: _corpus(14), False, set())
CASES["mixed"] = (_mixed, False, set())
CASES["u16-mixed"] = (_u16_mixed, True, set())


@lru_cache(maxsize=None)
def _blob(name: str) -> bytes:
    return CASES[name][0]()


def _plan(blob: bytes, u16: bool):
    groups = (api.parse_groups(blob, parse_rans16_group) if u16
              else api.parse_groups(blob))
    _pieces, batches = (api.plan_decode16 if u16 else api.plan_decode)(groups)
    return groups, batches


def _assert_same(got, want) -> None:
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            assert a.shape == b.shape and np.array_equal(a, b)
        else:
            assert a == b and type(a) is type(b)


@pytest.mark.parametrize("name", list(CASES))
def test_stage_equals_per_group_packers(name):
    _build, u16, must = CASES[name]
    groups, batches = _plan(_blob(name), u16)
    seen = set()
    for (wire, n_pad, tlog, kind), idxs in batches.items():
        seen.add((wire, tlog, kind, len(idxs)))
        _assert_same(api.stage_decode_batch(groups, idxs, n_pad, tlog, wire, kind),
                     per_group_stage(groups, idxs, n_pad, tlog, wire, kind))
    assert must <= seen, (must, seen)
    if name == "mixed":
        assert {w for w, *_ in seen} == {"byte", "pair", "quad"}
        assert {k for _w, _t, k, _g in seen} == {0, 1, 2}
    if name == "u16-mixed":
        assert {w for w, *_ in seen} == {"u16", "u16x"}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the exception type is compared
        return type(e).__name__, None


def _parity(blob: bytes, u16: bool = False) -> None:
    """Parse and stage every batch, by the stager and by the per-group
    staging: the same exception type, or equal arrays."""
    def run(stage):
        groups, batches = _plan(blob, u16)
        return [stage(groups, idxs, *key[1:3], key[0], key[3])
                for key, idxs in batches.items()]

    got, want = _outcome(lambda: run(api.stage_decode_batch)), _outcome(
        lambda: run(per_group_stage))
    assert got[0] == want[0], (got[0], want[0])
    for g, w in zip(got[1] or (), want[1] or ()):
        _assert_same(g, w)


@pytest.mark.parametrize("name", ["byte-t10-k2", "pair-t10-k2", "quad-t10-k2",
                                  "u16x-t13-k2"])
def test_flipped_ncount_byte_matches_per_group(name):
    blob = _blob(name)
    nc_len = HDR16.unpack_from(blob, 0)[5]      # both magics: the same header
    for off in range(HDR16.size, HDR16.size + nc_len):
        for bit in (0x01, 0x10, 0x80):
            b = bytearray(blob)
            b[off] ^= bit
            _parity(bytes(b), name.startswith("u16"))


@pytest.mark.parametrize("name", ["byte-t10-k1", "pair-t7-k0", "quad-t12-k2",
                                  "u16-t10-k2"])
def test_cut_payload_matches_per_group(name):
    blob = _blob(name)
    for cut in (1, 2, 3, 5, 64, 999):
        _parity(blob[:-cut], name.startswith("u16"))


def _irregular(wire: str, tlog: int, change, stage_tlog: int = 0) -> tuple:
    """The arguments of a batch of two groups of the wire at tableLog
    tlog whose first norm change edits (a copy), staged at stage_tlog
    (tlog when 0): norms or tableLogs the parsers would refuse."""
    blob = b"".join(_group(wire, tlog, 2, s) for s in (1, 2))
    groups, batches = _plan(blob, wire.startswith("u16"))
    ((_w, n_pad, _t, kind), idxs), = batches.items()
    g = list(groups[idxs[0]])
    g[4] = change(g[4].copy())
    groups = [tuple(g)] + [groups[i] for i in idxs[1:]]
    return groups, list(range(len(groups))), n_pad, stage_tlog or tlog, wire, kind


def _bump(norm):
    norm[-1] += 1
    return norm


def _drop(norm):
    norm[np.argmax(norm)] -= 1
    return norm


def _negative(norm):
    norm[0], norm[-1] = -3, norm[-1] + norm[0] + 3
    return norm


IRREGULAR = {"byte-sum-high": ("byte", 10, _bump),
             "byte-sum-low": ("byte", 10, _drop),
             "byte-below-minus-one": ("byte", 11, _negative),
             "pair-sum-low": ("pair", 12, _drop),
             "quad-sum-high": ("quad", 7, _bump),
             "u16-sum-low": ("u16", 6, _drop),
             "u16x-sum-high": ("u16x", 13, _bump),
             "pair-tlog13": ("pair", 12, lambda n: n, 13),
             "u16x-tlog6": ("u16x", 6, lambda n: n)}


@pytest.mark.parametrize("case", list(IRREGULAR))
def test_irregular_norms_match_per_group(case):
    args = _irregular(*IRREGULAR[case])
    got = _outcome(lambda: api.stage_decode_batch(*args))
    want = _outcome(lambda: per_group_stage(*args))
    assert got[0] == want[0], (got[0], want[0])
    if got[0] == "ok":
        _assert_same(got[1], want[1])


def test_stage_starts_no_thread(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("stage_decode_batch started a thread")

    monkeypatch.setattr(api, "_map", refuse)
    monkeypatch.setattr(api, "ThreadPoolExecutor", refuse)
    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", refuse)
    monkeypatch.setattr(threading.Thread, "start", refuse)
    for name in ("byte-g64", "u16x-g64"):
        groups, batches = _plan(_blob(name), name.startswith("u16"))
        ((wire, n_pad, tlog, kind), idxs), = batches.items()
        assert len(idxs) == 64
        _assert_same(api.stage_decode_batch(groups, idxs, n_pad, tlog, wire, kind),
                     per_group_stage(groups, idxs, n_pad, tlog, wire, kind))


def test_stage_counts_batches_and_groups():
    before = dict(api.stage_counts)
    for name in ("byte-g64", "quad-g1", "u16-t5-k0"):
        groups, batches = _plan(_blob(name), name.startswith("u16"))
        for (wire, n_pad, tlog, kind), idxs in batches.items():
            api.stage_decode_batch(groups, idxs, n_pad, tlog, wire, kind)
    assert api.stage_counts == {"batches": before["batches"] + 3,
                                "groups": before["groups"] + 64 + 1 + 2}
