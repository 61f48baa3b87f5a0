"""The decompress's output buffer (turbo/api.py: _output_buffer,
_pull_rows, patch_escapes): every group written straight to its place in
one host buffer laid out as the output, and one copy of it returned.

Held against the per-group path it replaced (each group's bytes made
apart, escapes patched in its words, the pieces joined), over the same
decoded rows; on the CPU the buffer is plain host memory and the same
layout code runs."""
import sys
import threading

import numpy as np
import pytest

from finitestateentropy_tpu_torch.turbo import api
from finitestateentropy_tpu_torch.turbo.pair import apply_escapes
from finitestateentropy_tpu_torch.turbo.rans import FLAG_QUAD, FLAG_RAW, FLAG_RLE
from finitestateentropy_tpu_torch.utils import generate_proba


def compress(data, group, **kw):
    return api.turbo_compress_device(data, group, device="cpu", **kw)


def decompress(blob):
    return api.turbo_decompress_device(blob, device="cpu")


def _quad_escape_corpus(n, seed=13):
    """8 hot quads salted with 260 rare ones (tests/test_torch_pair_quad.py)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, n // 4, dtype=np.uint32) * 0x01010101
    hot[rng.choice(n // 4, size=260, replace=False)] = \
        (np.arange(260) * 9719 + 77).astype(np.uint32)
    return hot.astype("<u4").tobytes()[:n]


def _pair_escape_corpus(n, seed=3):
    """8 hot pairs salted with 400 rare ones (tests/test_torch_pair_quad.py)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, (n + 1) // 2, dtype=np.uint16) * 257
    hot[rng.choice((n + 1) // 2, size=400, replace=False)] = \
        (np.arange(400) * 7 + 300).astype(np.uint16)
    return hot.astype("<u2").tobytes()[:n]


# a quad group of 32,767 bytes whose final partial word (3 bytes) is an
# escape, followed by a decoded group that a write past it would clobber
QUAD_TAIL = _quad_escape_corpus(1 << 15)[:-4] + b"\xfe\xfd\xfc"
# byte-wire groups this large are coded: a frame carries 4 KiB of initial
# states, so a much smaller group is stored raw
BYTE_GROUP = 1 << 14


def _mixed():
    """(data, frame) of raw, RLE, pair, quad, pair, byte and quad groups,
    each part compressed apart and the frames joined.  Odd group sizes put
    the later groups at unaligned offsets.  Batches run pair, quad, byte:
    the two pair groups, apart in the output, land before the quad group
    between them; the byte part is three 16 KiB groups of one batch that
    fill their rows; the two quad groups, apart, share a batch."""
    rng = np.random.default_rng(7)
    parts = [(rng.integers(0, 256, 12_289, dtype=np.uint8).tobytes(), {}),
             (b"\7" * 1001, {}),
             (_pair_escape_corpus(20_001), dict(pair=1, quad=0)),
             (QUAD_TAIL, dict(quad=1)),
             (_pair_escape_corpus(20_001, seed=4), dict(pair=1, quad=0)),
             (generate_proba(80, 3 * BYTE_GROUP), dict(pair=0, quad=0)),
             (_quad_escape_corpus(1 << 15, seed=14)[:-4] + b"\xfa\xfb\xfc",
              dict(quad=1))]
    frame = b"".join(compress(d, BYTE_GROUP if kw.get("pair") == 0 else 1 << 15, **kw)
                     for d, kw in parts)
    return b"".join(d for d, _kw in parts), frame


def _group_bytes(wire, g, words):
    """The replaced path's bytes of one decoded group: its words with the
    escapes patched in place, cut to n."""
    n = g[0]
    flat = words.astype("<i4", copy=False).reshape(-1)
    if wire != "byte":
        dtype, k = ((np.uint32, (n + 3) // 4) if wire == "quad"
                    else (np.uint16, (n + 1) // 2))
        apply_escapes(flat.view(dtype)[:k], g[10])
    return flat.view(np.uint8)[:n].tobytes()


def _wire(g):
    return "byte" if len(g) == 9 else "quad" if g[3] & FLAG_QUAD else "pair"


def test_mixed_frame_equals_the_per_group_path(monkeypatch):
    data, frame = _mixed()
    groups = api.parse_groups(frame)
    assert {_wire(g) for g in groups if not g[3] & (FLAG_RAW | FLAG_RLE)} \
        == {"byte", "pair", "quad"}
    assert any(g[3] & FLAG_RAW for g in groups) and any(g[3] & FLAG_RLE for g in groups)
    tail = groups[3]
    assert _wire(tail) == "quad" and tail[0] % 4 == 3
    assert (tail[10][0] == tail[0] // 4).any()          # the partial word
    offs, batches = api.plan_decode(groups)
    assert any(o % 4 for o in offs[:-1])
    assert list(batches.values()) == [[2, 4], [3, 8], [5, 6, 7]]

    pulled = {}
    pull = api._pull_rows

    def spy(outw, idxs, offs, out):
        for j, i in enumerate(idxs):
            pulled[i] = outw[j].numpy().copy()
        pull(outw, idxs, offs, out)

    monkeypatch.setattr(api, "_pull_rows", spy)
    got = decompress(frame)
    assert got == data
    old = []
    for i, g in enumerate(groups):
        if g[3] & FLAG_RAW:
            old.append(bytes(g[7]))
        elif g[3] & FLAG_RLE:
            old.append(bytes([g[7][0]]) * g[0])
        else:
            old.append(_group_bytes(_wire(g), g, pulled[i]))
    assert got == b"".join(old)


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_escape_patch_stays_inside_its_group(order):
    """The tail quad's escape in place, whichever group lands first: the
    next group's first bytes, written before or after it, survive."""
    groups = api.parse_groups(compress(QUAD_TAIL, 1 << 15, quad=1))
    g, n = groups[0], groups[0][0]
    words = np.frombuffer(QUAD_TAIL + b"\0" * (4 - n % 4), "<u4").copy()
    words[g[10][0]] = 0                                 # the escaped words
    seg = np.zeros(n + 4, np.uint8)
    after = np.frombuffer(b"NEXT", np.uint8)
    if order == "reverse":
        seg[n:] = after
    seg[:n] = words.view(np.uint8)[:n]
    api.patch_escapes(g, seg[:n])
    if order == "forward":
        seg[n:] = after
    assert seg[:n].tobytes() == QUAD_TAIL and seg[n:].tobytes() == b"NEXT"


def test_results_share_no_memory_with_the_buffer():
    a = generate_proba(80, 3 * BYTE_GROUP + 5)
    b = generate_proba(50, 3 * BYTE_GROUP + 5)
    first = decompress(compress(a, BYTE_GROUP))
    assert decompress(compress(b, BYTE_GROUP)) == b
    assert first == a


def test_output_staging_counts(monkeypatch):
    monkeypatch.setattr(api, "_staging", threading.local())
    monkeypatch.setattr(api, "output_staging", dict.fromkeys(api.output_staging, 0))
    data = generate_proba(80, 2 * BYTE_GROUP + 3)
    blob = compress(data, BYTE_GROUP)
    for _ in range(3):
        assert decompress(blob) == data
    assert api.output_staging == {"pinned": 0, "host": 3, "over_cap": 0, "grown": 1}
    monkeypatch.setattr(api, "STAGING_MAX", BYTE_GROUP)
    assert decompress(blob) == data
    assert api.output_staging == {"pinned": 0, "host": 3, "over_cap": 1, "grown": 1}


def test_threads_keep_their_own_buffers(monkeypatch):
    """Callers on four threads, each a frame of its own, with the switch
    interval shortened: every result is its own input."""
    monkeypatch.setattr(api, "output_staging", dict.fromkeys(api.output_staging, 0))
    datas = [generate_proba(p, BYTE_GROUP + 17 * p) for p in (50, 60, 80, 90)]
    blobs = [compress(d, BYTE_GROUP) for d in datas]
    bad = []

    def run(k):
        for _ in range(3):
            if decompress(blobs[k]) != datas[k]:
                bad.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
    assert api.output_staging["host"] == 12
    assert api.output_staging["grown"] == 4        # one buffer a thread
