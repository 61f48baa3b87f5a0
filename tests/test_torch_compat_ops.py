"""The port's compat device ops against the JAX package's, on the same
numpy inputs: ops/bitio.py, ops/fse_tables.py, the plain versions of the
five compat kernels (ops/fse_kernels.py, ops/huf_kernels.py) and
build_dtables_x1 / pack_dtable_x2.

The JAX ops are XLA (lax.scan / fori_loop), so they run on this box's CPU
as they are.  Tolerance: exact (integer codecs; bit-exactness is the
contract), outputs compared whole: the encodes' words (zero past the
size), sizes, the decodes' bytes and err, corrupt streams included.  The
tests marked ``gpu`` hold each CUDA kernel against its plain version on
the same inputs; the JAX package is imported inside the tests that use it,
so they also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.ops import bitio, fse_kernels, fse_tables, huf_kernels
from finitestateentropy_tpu_torch.refimpl.huf import (huf_build_ctable,
                                                      huf_read_dtable_x2,
                                                      huf_read_stats,
                                                      huf_write_ctable)
from finitestateentropy_tpu_torch.refimpl.hist import hist_count
from finitestateentropy_tpu_torch.refimpl.norm import (fse_normalize_count,
                                                       fse_optimal_table_log)
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.utils import generate_proba

S = 4096                 # block size of these tests (block_size_id 2)
OUT_BYTES = 4096 + 64
FULL = 1 << 15           # the compat codecs' block size (block_size_id 5)
P80, P14, P02 = (generate_proba(p, 3 * S) for p in (80, 14, 2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev="cpu"):
    return torch.from_numpy(np.array(a)).to(dev)


def _np(t):
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _escape_block(n: int = S) -> bytes:
    """One symbol and a single rare one: the rare one gets a -1 norm."""
    b = bytearray(b"\x07" * n)
    b[n // 3] = 200
    return bytes(b)


def _small_alphabet_block(n: int = S) -> bytes:
    """Eight symbols of skewed frequencies (tableLog 5 holds them)."""
    rng = np.random.default_rng(11)
    p = np.array([40, 20, 12, 10, 8, 5, 3, 2]) / 100
    return rng.choice(8, size=n, p=p).astype(np.uint8).tobytes()


FSE_BLOCKS = {   # name -> (block, tableLog or None for the codec's)
    "p80": (P80[:S], None), "p14": (P14[:S], None), "p02": (P02[:S], None),
    "alpha8_tlog5": (_small_alphabet_block(), 5), "p80_tlog12": (P80[S:2 * S], 12),
    "escape": (_escape_block(), None), "n2": (b"\x05\x09", None),
    "n3": (b"\x01\x02\x01", None), "ragged": (P14[:1001], None),
    "p80_32k": (generate_proba(80, FULL), None), "p14_32k": (generate_proba(14, FULL), None)}


def _norm_of(block: bytes, tlog=None):
    arr = np.frombuffer(block, np.uint8)
    count = np.bincount(arr, minlength=256)
    max_sv = int(arr.max())
    tl = tlog or fse_optimal_table_log(11, len(block), max_sv)
    return fse_normalize_count(tl, count[: max_sv + 1], len(block), max_sv)


def _fse_inputs(names, width: int = S):
    B = len(names)
    width = max(width, *(len(FSE_BLOCKS[name][0]) for name in names))
    src = np.zeros((B, width), np.uint8)
    norms = np.zeros((B, 256), np.int32)
    tlogs = np.zeros(B, np.int32)
    ns = np.zeros(B, np.int32)
    for k, name in enumerate(names):
        block, tlog = FSE_BLOCKS[name]
        norm, tl = _norm_of(block, tlog)
        src[k, : len(block)] = np.frombuffer(block, np.uint8)
        norms[k, : len(norm)] = norm
        tlogs[k], ns[k] = tl, len(block)
    return src, ns, norms, tlogs


def _fse_streams(words, csize, width: int = S, pad: int = 96):
    """Encoded words -> the decode's zero-padded [B, width + pad] streams
    (a multiple of 4 past the bound), csize; a payload past the words is
    cut there (its tail was dropped)."""
    streams = np.zeros((len(csize), width + pad), np.uint8)
    raw = np.asarray(words).astype("<u4").view(np.uint8).reshape(len(csize), -1)
    for k, c in enumerate(csize):
        c = min(int(c), raw.shape[1])
        streams[k, :c] = raw[k, :c]
    return streams


HUF_BLOCKS = {"p80": P80[:S], "p14": P14[:S], "p80_odd": P80[:S - 1],
              "p80_1021": P80[5:1026], "p14_517": P14[:517], "n13": P80[100:113],
              "p02": P02[:S]}


def _huf_code(block: bytes):
    """The block's Huff0 code table and its header (the codec's tableLog)."""
    count, max_sv, _ = hist_count(block)
    tlog = fse_optimal_table_log(11, len(block), max_sv, minus=1, max_allowed=12)
    table = huf_build_ctable(count, max_sv, tlog)
    return table, huf_write_ctable(table, max_sv)


def _huf_arrays(blocks, width: int = S, codes=None):
    """src[B, width], ns, val[B, 256] u16, nb[B, 256] u8 (the encode's) and
    the headers of blocks; codes[k] (a table and its header) where given,
    else each block's own."""
    B = len(blocks)
    src = np.zeros((B, width), np.uint8)
    ns = np.zeros(B, np.int32)
    val = np.zeros((B, 256), np.uint16)
    nb = np.zeros((B, 256), np.uint8)
    headers = []
    for k, block in enumerate(blocks):
        table, header = codes[k] if codes else _huf_code(block)
        headers.append(header)
        src[k, : len(block)] = np.frombuffer(block, np.uint8)
        ns[k] = len(block)
        val[k, : len(table.val)] = table.val
        nb[k, : len(table.nb_bits)] = table.nb_bits
    return src, ns, val, nb, headers


def _huf_inputs(names):
    """src, ns, val, nb (the encode's) and the headers."""
    return _huf_arrays([HUF_BLOCKS[name] for name in names])


def _huf_decode_inputs(words, sizes, ns, headers, width: int = 2 * S // 4):
    """(streams[4B, width], csize[4B], nout[4B], tlogs[4B], weights[B, 256]);
    a stream longer than its row is cut there."""
    B = len(ns)
    raw = np.asarray(words).astype("<u4").view(np.uint8).reshape(B, 4, -1)
    streams = np.zeros((4 * B, width), np.uint8)
    csize = np.asarray(sizes).reshape(-1).astype(np.int32)
    nout = np.zeros(4 * B, np.int32)
    tlogs = np.zeros(4 * B, np.int32)
    weights = np.zeros((B, 256), np.int32)
    stats = {}
    for k in range(B):
        if headers[k] not in stats:
            stats[headers[k]] = huf_read_stats(headers[k])
        w, _rs, _nsym, tlog, _used = stats[headers[k]]
        weights[k, : len(w)] = np.frombuffer(w, np.uint8)
        seg = (int(ns[k]) + 3) // 4
        for j in range(4):
            c = min(int(csize[4 * k + j]), width, raw.shape[2])
            streams[4 * k + j, :c] = raw[k, j, :c]
            nout[4 * k + j] = seg if j < 3 else int(ns[k]) - 3 * seg
            tlogs[4 * k + j] = tlog
    return streams, csize, nout, tlogs, weights


# ---------------------------------------------------------------------------
# ops/bitio.py
# ---------------------------------------------------------------------------


def test_bitio_equal_jax():
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import bitio as j_bitio

    rng = np.random.default_rng(7)
    buf = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    words = _np(bitio.bytes_to_words(_t(buf)))
    assert np.array_equal(words, np.asarray(j_bitio.bytes_to_words(jnp.asarray(buf))))
    assert np.array_equal(_np(bitio.words_to_bytes(_t(words))), buf)
    assert np.array_equal(_np(bitio.words_to_bytes(_t(words.astype(np.uint32).view(np.int32)))),
                          buf)
    # reads at every offset and width, clamped past both ends
    w0 = words[0].astype(np.uint32)
    for bitpos in (-5, 0, 1, 31, 32, 33, 100, 480, 500, 511, 512, 600):
        for nb in (0, 1, 5, 12, 25):
            want = int(j_bitio.read_bits(jnp.asarray(w0), jnp.int32(bitpos), jnp.int32(nb)))
            got = bitio.read_bits(_t(words[0]), torch.tensor(bitpos), torch.tensor(nb))
            assert int(got) == want, (bitpos, nb)
    # pack_fields: random fields, zero-width padding, a capacity overflow
    vals = rng.integers(0, 1 << 20, (4, 50), dtype=np.uint32)
    nbs = rng.integers(0, 21, (4, 50), dtype=np.int32)
    nbs[1, 30:] = 0
    for out_words in (40, 8):
        jw, jt = j_bitio.pack_fields(jnp.asarray(vals), jnp.asarray(nbs), out_words)
        pw, pt = bitio.pack_fields(_t(vals.astype(np.int64)), _t(nbs), out_words)
        assert np.array_equal(_np(pw), np.asarray(jw)) and np.array_equal(_np(pt),
                                                                         np.asarray(jt))


def test_initial_bitpos_equal_jax():
    """The last byte's highbit; a last byte of 0 (missing endMark) sets bad;
    csize 0 gives bitpos 0; csize past the row clamps."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import bitio as j_bitio

    st = np.zeros((6, 16), np.uint8)
    st[0, 4] = 0x01
    st[1, 9] = 0x80
    st[2, 3] = 0x00          # missing endMark
    st[4, 15] = 0x13
    cs = np.array([5, 10, 4, 0, 16, 40], np.int32)
    jb, jbad = j_bitio.initial_bitpos(jnp.asarray(st), jnp.asarray(cs))
    pb, pbad = bitio.initial_bitpos(_t(st), _t(cs))
    assert np.array_equal(_np(pb), np.asarray(jb))
    assert np.array_equal(_np(pbad), np.asarray(jbad))
    assert _np(pb).tolist()[:5] == [32, 79, 24, 0, 124]
    assert _np(pbad).tolist()[:4] == [False, False, True, True]


def test_highbit_exact():
    x = torch.tensor([0, 1, 2, 3, 255, 256, 4095, 4096, (1 << 31) - 1, 1 << 31,
                      (1 << 32) - 1])
    assert bitio.highbit(x).tolist() == [-1, 0, 1, 1, 7, 8, 11, 12, 30, 31, 31]


# ---------------------------------------------------------------------------
# ops/fse_tables.py
# ---------------------------------------------------------------------------


def test_fse_tables_equal_jax():
    """Norms with -1 entries, tableLog 5 and 12, a one-symbol-plus-escape
    histogram, 2- and 3-symbol blocks."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import fse_tables as j_tables

    names = list(FSE_BLOCKS)
    _src, _ns, norms, tlogs = _fse_inputs(names)
    assert (norms == -1).any(axis=1)[names.index("escape")]
    assert (norms == -1).any() and {5, 12} <= set(tlogs.tolist())
    jc = j_tables.build_ctables(jnp.asarray(norms), jnp.asarray(tlogs))
    pc = fse_tables.build_ctables(_t(norms), _t(tlogs))
    for a, b in zip(pc, jc):
        assert np.array_equal(_np(a), np.asarray(b))
    jd = j_tables.build_dtables(jnp.asarray(norms), jnp.asarray(tlogs))
    pd = fse_tables.build_dtables(_t(norms), _t(tlogs))
    for a, b in zip(pd, jd):
        assert np.array_equal(_np(a), np.asarray(b))


def test_fse_dtables_equal_host_twin():
    """The device-built decode table equals refimpl.tables.build_dtable on
    the live cells (the spread's tie order: low-probability cells at the
    top, in increasing symbol and decreasing cell order)."""
    from finitestateentropy_tpu_torch.refimpl.tables import build_dtable

    names = ["p14", "p02", "escape", "alpha8_tlog5"]
    _src, _ns, norms, tlogs = _fse_inputs(names)
    ns_, sym, nb, _fast = fse_tables.build_dtables(_t(norms), _t(tlogs))
    for k, name in enumerate(names):
        norm, tl = _norm_of(*FSE_BLOCKS[name])
        dt = build_dtable(norm, len(norm) - 1, tl)
        live = 1 << tl
        assert np.array_equal(_np(sym[k])[:live], dt.symbol)
        assert np.array_equal(_np(nb[k])[:live], dt.nb_bits)
        assert np.array_equal(_np(ns_[k])[:live], dt.new_state)


# ---------------------------------------------------------------------------
# C1 / C2: the FSE encode and decode (plain versions vs JAX)
# ---------------------------------------------------------------------------


FSE_NAMES = ["p80", "p14", "p02", "p80_tlog12", "escape", "n2", "n3", "ragged"]
# name -> (blocks, their row width = max_syms = max_out, out_bytes)
FSE_BATCHES = {
    "small": (FSE_NAMES, S, OUT_BYTES),
    # whole blocks of the codecs' size: a chain of 16 Ki steps a state
    "full_32k": (["p80_32k", "p14_32k"], FULL, 36000),
    # payloads past out_bytes: the words past the 150th are dropped and
    # csize still counts them (p80 fits, p14 and p02 do not)
    "overflow": (["p80", "p14", "p02", "n3"], S, 600),
}
FSE_CASES = ("clean", "corrupt", "cursor_low")


def _fse_decode_case(streams, csize, case):
    """The decode's streams and csize in a case: "corrupt" flips a bit of
    block 1 and zeroes the endMark byte of block 2 (of the last block in a
    batch of two); "cursor_low" cuts block 0's csize to an eighth, so its
    cursor falls below bit 0 long before the last symbol."""
    st, cs = streams.copy(), csize.copy()
    if case == "corrupt":
        st[1, cs[1] // 2] ^= 0x10
        z = min(2, len(cs) - 1)
        st[z, cs[z] - 1] = 0
    elif case == "cursor_low":
        cs[0] = max(cs[0] // 8, 1)
    return st, cs


@pytest.fixture(scope="module", params=list(FSE_BATCHES))
def fse_jax(request):
    """JAX's encode of an FSE batch and its decode in each case."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import fse_kernels as j_k, fse_tables as j_t

    names, width, out_bytes = FSE_BATCHES[request.param]
    src, ns, norms, tlogs = _fse_inputs(names, width)
    ct = j_t.build_ctables(jnp.asarray(norms), jnp.asarray(tlogs))
    words, csize = j_k.fse_encode_batch(jnp.asarray(src), jnp.asarray(ns),
                                        jnp.asarray(tlogs), ct, max_syms=width,
                                        out_bytes=out_bytes)
    words, csize = np.asarray(words), np.asarray(csize)
    streams = _fse_streams(words, csize, width)
    dt = j_t.build_dtables(jnp.asarray(norms), jnp.asarray(tlogs))[:3]
    dec = {}
    for case in FSE_CASES:
        st, cs = _fse_decode_case(streams, csize, case)
        out, err = j_k.fse_decode_batch(jnp.asarray(st), jnp.asarray(cs),
                                        jnp.asarray(ns), jnp.asarray(tlogs), dt,
                                        max_out=width)
        dec[case] = (st, cs, np.asarray(out), np.asarray(err))
    return dict(batch=request.param, names=names, width=width, out_bytes=out_bytes,
                src=src, ns=ns, norms=norms, tlogs=tlogs, words=words, csize=csize,
                dec=dec)


def test_fse_encode_plain_equals_jax(fse_jax):
    j = fse_jax
    ct = fse_tables.build_ctables(_t(j["norms"]), _t(j["tlogs"]))
    words, csize = fse_kernels.fse_encode_batch(_t(j["src"]), _t(j["ns"]), _t(j["tlogs"]),
                                                ct, max_syms=j["width"],
                                                out_bytes=j["out_bytes"])
    assert np.array_equal(_np(words).view(np.uint32), j["words"])
    assert np.array_equal(_np(csize), j["csize"])
    if "n2" in j["names"]:      # n = 2: only the two flushes and the endMark
        n2 = j["names"].index("n2")
        assert j["csize"][n2] == (2 * j["tlogs"][n2] + 1 + 7) // 8
    if j["batch"] == "overflow":
        assert (j["csize"] > 4 * j["words"].shape[1]).sum() == 2
    if j["batch"] == "full_32k":
        assert (j["ns"] == FULL).all() and (j["csize"] > 4 * 128 * 4).all()


@pytest.mark.parametrize("case", FSE_CASES)
def test_fse_decode_plain_equals_jax(fse_jax, case):
    j = fse_jax
    st, cs, want_out, want_err = j["dec"][case]
    dt = fse_tables.build_dtables(_t(j["norms"]), _t(j["tlogs"]))[:3]
    out, err = fse_kernels.fse_decode_batch(_t(st), _t(cs), _t(j["ns"]),
                                            _t(j["tlogs"]), dt, max_out=j["width"])
    assert np.array_equal(_np(out), want_out) and np.array_equal(_np(err), want_err)
    whole = j["csize"] <= 4 * j["words"].shape[1]       # no word dropped
    if case == "clean":
        assert not want_err[whole].any() and want_err[~whole].all()
        for k in np.flatnonzero(whole):
            n = j["ns"][k]
            assert np.array_equal(want_out[k, :n], j["src"][k, :n])
    elif case == "corrupt":     # a flipped bit may go unseen; a missing endMark may not
        assert not want_err[0] and want_err[min(2, len(cs) - 1)]
    else:
        assert want_err[0] and not want_err[1:][whole[1:]].any()


def test_fse_decode_n_out_at_most_2_never_checks():
    """n_out <= 2 never sets the checkpoint error, and the initial-state
    parity of n = 2 picks state1 from the even index."""
    src, ns, norms, tlogs = _fse_inputs(["n2", "n2", "n3"])
    ct = fse_tables.build_ctables(_t(norms), _t(tlogs))
    words, csize = fse_kernels.fse_encode_batch(_t(src), _t(ns), _t(tlogs), ct,
                                                max_syms=S, out_bytes=OUT_BYTES)
    streams = _fse_streams(_np(words).view(np.uint32), _np(csize))
    streams[1, 0] ^= 0x01                    # a flipped state bit
    dt = fse_tables.build_dtables(_t(norms), _t(tlogs))[:3]
    out, err = fse_kernels.fse_decode_batch(_t(streams), csize, _t(ns), _t(tlogs),
                                            dt, max_out=S)
    assert not err[0] and not err[1]
    assert _np(out)[0, :2].tolist() == [5, 9]
    assert _np(out)[2, :3].tolist() == [1, 2, 1]


# ---------------------------------------------------------------------------
# C3 / C4 / C5: the Huff0 encode and decodes (plain versions vs JAX)
# ---------------------------------------------------------------------------


HUF_NAMES = list(HUF_BLOCKS)


@pytest.fixture(scope="module")
def huf_jax():
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import huf_kernels as j_k
    from finitestateentropy_tpu.refimpl.huf import huf_read_dtable_x2 as j_rd2

    src, ns, val, nb, headers = _huf_inputs(HUF_NAMES)
    seg_bytes = (S + 3) // 4 + 64
    words, sizes = j_k.huf_encode_4x_batch(jnp.asarray(src), jnp.asarray(ns),
                                           jnp.asarray(val), jnp.asarray(nb), S,
                                           seg_bytes)
    words, sizes = np.asarray(words), np.asarray(sizes)
    streams, csize, nout, tlogs, weights = _huf_decode_inputs(words, sizes, ns, headers)
    bad = streams.copy()
    bad[4 * 1 + 2, csize[6] // 2] ^= 0x40      # block 1, stream 2
    bad[4 * 2 + 0, csize[8] - 1] = 0           # block 2, stream 0: no endMark
    tl_blocks = tlogs.reshape(-1, 4)[:, 0]
    byte_t, nb_t = j_k.build_dtables_x1(jnp.asarray(weights), jnp.asarray(tl_blocks))
    x2 = np.stack([j_k.pack_dtable_x2(j_rd2(h)[0]) for h in headers])
    x2_tl = np.array([j_rd2(h)[0].table_log for h in headers], np.int32)
    dec = {}
    for name, st in (("clean", streams), ("corrupt", bad)):
        o1, e1 = j_k.huf_decode_4x1_batch(
            jnp.asarray(st), jnp.asarray(csize), jnp.asarray(nout), jnp.asarray(tlogs),
            (jnp.repeat(byte_t, 4, axis=0), jnp.repeat(nb_t, 4, axis=0)), max_seg=S // 4)
        o2, e2 = j_k.huf_decode_4x2_batch(
            jnp.asarray(st), jnp.asarray(csize), jnp.asarray(nout),
            jnp.asarray(np.repeat(x2_tl, 4)), jnp.asarray(np.repeat(x2, 4, axis=0)),
            max_seg=S // 4)
        dec[name] = (st, (np.asarray(o1), np.asarray(e1)), (np.asarray(o2), np.asarray(e2)))
    return dict(src=src, ns=ns, val=val, nb=nb, headers=headers, words=words,
                sizes=sizes, csize=csize, nout=nout, tlogs=tlogs, weights=weights,
                byte_t=np.asarray(byte_t), nb_t=np.asarray(nb_t), x2=x2, x2_tl=x2_tl,
                dec=dec)


def test_huf_encode_plain_equals_jax(huf_jax):
    j = huf_jax
    words, sizes = huf_kernels.huf_encode_4x_batch(
        _t(j["src"]), _t(j["ns"]), _t(j["val"].astype(np.int32)),
        _t(j["nb"].astype(np.int32)), S, (S + 3) // 4 + 64)
    assert np.array_equal(_np(words).view(np.uint32), j["words"])
    assert np.array_equal(_np(sizes), j["sizes"])
    # n = 13: segments of 4, the 4th 1 byte
    k = HUF_NAMES.index("n13")
    assert j["nout"][4 * k: 4 * k + 4].tolist() == [4, 4, 4, 1]


def test_huf_dtables_equal_jax(huf_jax):
    """X1 cells ordered by (weight, symbol); X2 packed tables."""
    from finitestateentropy_tpu.refimpl.huf import huf_read_dtable_x2 as j_rd2

    j = huf_jax
    tl_blocks = j["tlogs"].reshape(-1, 4)[:, 0]
    bt, nt = huf_kernels.build_dtables_x1(_t(j["weights"]), _t(tl_blocks))
    assert np.array_equal(_np(bt), j["byte_t"]) and np.array_equal(_np(nt), j["nb_t"])
    for h, want in zip(j["headers"], j["x2"]):
        dt2, _used = huf_read_dtable_x2(h)
        assert np.array_equal(huf_kernels.pack_dtable_x2(dt2), want)
        assert dt2.table_log == j_rd2(h)[0].table_log


@pytest.mark.parametrize("case", ["clean", "corrupt"])
@pytest.mark.parametrize("mode", ["x1", "x2"])
def test_huf_decode_plain_equals_jax(huf_jax, case, mode):
    j = huf_jax
    st, x1_want, x2_want = j["dec"][case]
    args = (_t(st), _t(j["csize"]), _t(j["nout"]))
    if mode == "x1":
        tables = (_t(np.repeat(j["byte_t"], 4, axis=0)), _t(np.repeat(j["nb_t"], 4, axis=0)))
        out, err = huf_kernels.huf_decode_4x1_batch(*args, _t(j["tlogs"]), tables,
                                                    max_seg=S // 4)
        want = x1_want
    else:
        out, err = huf_kernels.huf_decode_4x2_batch(
            *args, _t(np.repeat(j["x2_tl"], 4)), _t(np.repeat(j["x2"], 4, axis=0)),
            max_seg=S // 4)
        want = x2_want
    assert np.array_equal(_np(out), want[0]) and np.array_equal(_np(err), want[1])
    if case == "clean":
        assert not want[1].any()
        for k, n in enumerate(j["ns"]):
            seg = (int(n) + 3) // 4
            got = np.concatenate([want[0][4 * k + q, : (seg if q < 3 else n - 3 * seg)]
                                  for q in range(4)])
            assert np.array_equal(got, j["src"][k, :n])
    else:
        assert want[1][8] and not want[1][:4].any()


def test_huf_x2_last_symbol_rule():
    """A length-2 entry at a stream's last position writes one byte and
    clamps the cursor at 0: odd segments of Proba80 hit it."""
    src, ns, val, nb, headers = _huf_inputs(["p80_odd", "p80_1021", "p14_517"])
    words, sizes = huf_kernels.huf_encode_4x_batch(_t(src), _t(ns), _t(val.astype(np.int32)),
                                                   _t(nb.astype(np.int32)), S,
                                                   (S + 3) // 4 + 64)
    streams, csize, nout, _tl, _w = _huf_decode_inputs(_np(words).view(np.uint32),
                                                       _np(sizes), ns, headers)
    dts = [huf_read_dtable_x2(h)[0] for h in headers]
    x2 = np.repeat(np.stack([huf_kernels.pack_dtable_x2(d) for d in dts]), 4, axis=0)
    tl = np.repeat(np.array([d.table_log for d in dts], np.int32), 4)
    out, err = huf_kernels.huf_decode_4x2_batch(_t(streams), _t(csize), _t(nout), _t(tl),
                                                _t(x2), max_seg=S // 4)
    assert not _np(err).any()
    assert any(nout[r] % 2 for r in range(len(nout)))
    for k, n in enumerate(ns):
        seg = (int(n) + 3) // 4
        got = np.concatenate([_np(out)[4 * k + q, : (seg if q < 3 else n - 3 * seg)]
                              for q in range(4)])
        assert np.array_equal(got, src[k, :n])


def test_huf_x2_lookups_follow_the_codes():
    """huf_decode_4x2_lookups counts each stream's lookups as a greedy
    parse of its symbols' codes through the X2 table gives them (one or
    two symbols a lookup, one at the last position): fewer than n_out on
    Proba80, whose main symbol has a 1-bit code."""
    names = ["p80", "p80_odd", "p80_1021", "p14_517"]
    src, ns, val, nb, headers = _huf_inputs(names)
    words, sizes = huf_kernels.huf_encode_4x_batch(_t(src), _t(ns), _t(val.astype(np.int32)),
                                                   _t(nb.astype(np.int32)), S,
                                                   (S + 3) // 4 + 64)
    streams, csize, nout, _tl, _w = _huf_decode_inputs(_np(words).view(np.uint32),
                                                       _np(sizes), ns, headers)
    dts = [huf_read_dtable_x2(h)[0] for h in headers]
    x2 = np.repeat(np.stack([huf_kernels.pack_dtable_x2(d) for d in dts]), 4, axis=0)
    tl = np.repeat(np.array([d.table_log for d in dts], np.int32), 4)
    got = _np(huf_kernels.huf_decode_4x2_lookups(_t(streams), _t(csize), _t(nout), _t(tl),
                                                 _t(x2), max_seg=S // 4))
    want = []
    for k, n in enumerate(ns):
        seg, dt = (int(n) + 3) // 4, dts[k]
        for q in range(4):
            syms = src[k, q * seg: min((q + 1) * seg, int(n))]
            p = count = 0
            while p < len(syms):
                acc = bits = 0
                for s in syms[p:]:
                    if bits >= dt.table_log:
                        break
                    acc, bits = (acc << int(nb[k, s])) | int(val[k, s]), bits + int(nb[k, s])
                shift = bits - dt.table_log
                idx = acc >> shift if shift >= 0 else acc << -shift
                p += 2 if dt.length[idx] == 2 and p + 1 < len(syms) else 1
                count += 1
            want.append(count)
    assert got.tolist() == want
    assert (got <= nout).all() and (2 * got >= nout).all()
    assert got[:4].sum() < 0.75 * nout[:4].sum()       # Proba80: mostly pairs


# The Huff0 batches the GPU tests also run, held against JAX here: name ->
# (src, ns, val, nb, headers, max_block, seg_bytes, decode row bytes).
HUF_CASES = ("clean", "corrupt", "cursor_low")


def _huf_full():
    """Whole 32 KiB blocks of Proba80 and Proba14, the codec's shapes."""
    blocks = [generate_proba(p, FULL) for p in (80, 14)]
    return (*_huf_arrays(blocks, FULL), FULL, (FULL + 3) // 4 + 64, 8240)


def _huf_n_edge():
    """Blocks of n = 0, 1, 3, 13, 77, 4095 and S + 5 bytes (past max_block:
    the last segment's positions clamp into the row, a stream of seg_cap + 1
    codes loses its endMark, and its n_out exceeds max_seg) over the codes
    of 4 KiB of Proba80 and Proba14."""
    codes = [_huf_code(HUF_BLOCKS[name]) for name in ("p80", "p14")]
    lens = [0, 1, 3, 13, 77, 4095, S + 5]
    src, ns, val, nb, headers = _huf_arrays(
        [P80[:S]] * len(lens), S, [codes[k % 2] for k in range(len(lens))])
    src[1::2] = np.frombuffer(P14[:S], np.uint8)
    ns[:] = lens
    return src, ns, val, nb, headers, S, (S + 3) // 4 + 64, 2 * S // 4


def _huf_batch(batch: str):
    if batch == "full_32k":
        return _huf_full()
    if batch == "n_edge":
        return _huf_n_edge()
    return (*_huf_inputs(HUF_NAMES), S, (S + 3) // 4 + 64, 2 * S // 4)


def _huf_alter_tables(batch, tlogs, byte_t, nb_t):
    """The decode tables of a batch, one row a stream: "mixed_tables" gives
    stream 2 of block 1 block 0's table, stream 1 of block 3 a tableLog one
    lower and block 4 tableLog 13 (past the 4096-entry table), so those
    blocks' streams decode from the global tables.  numpy in, numpy out."""
    tl = tlogs.copy()
    bt, nt = np.repeat(byte_t, 4, axis=0), np.repeat(nb_t, 4, axis=0)
    if batch == "mixed_tables":
        bt[4 * 1 + 2], nt[4 * 1 + 2] = byte_t[0], nb_t[0]
        tl[4 * 3 + 1] -= 1
        tl[4 * 4: 4 * 4 + 4] = 13
    return tl, bt, nt


def _huf_alter_x2(batch, tl2, x2):
    """The X2 tables of a batch, one row a stream: "x2_tables" gives block 0
    dtLog 0 (a one-entry table), stream 2 of block 1 block 0's table,
    stream 1 of block 2 dtLog 11, block 3 dtLog 11 on every row (below 12:
    the shared form), block 4 dtLog 13 (past the 4096-entry table) and
    block 5 an entry of nbBits 13 on every row, so the streams of blocks 1,
    2, 4 and 5 decode from the global table.  numpy in, numpy out."""
    tl, tb = tl2.copy(), x2.copy()
    if batch == "x2_tables":
        tl[0:4] = 0
        tb[4 * 1 + 2] = x2[0]
        tl[4 * 2 + 1] = 11
        tl[4 * 3: 4 * 3 + 4] = 11
        tl[4 * 4: 4 * 4 + 4] = 13
        tb[4 * 5: 4 * 5 + 4, 7] = (x2[4 * 5, 7] & ~(0x3F << 16)) | (13 << 16)
    return tl, tb


def _huf_batch_nout(batch, nout, max_seg):
    """The decode's n_out: max_seg on every stream in "nout_max_seg" (the
    short blocks' streams then decode past their ends)."""
    return np.full_like(nout, max_seg) if batch == "nout_max_seg" else nout


def _huf_decode_case(streams, csize, nout, case, max_seg):
    """The decode's inputs in a case: "corrupt" flips a bit of stream 6,
    zeroes the endMark byte of stream 8 (a missing endMark), and gives
    stream 3 csize 0, stream 5 n_out 0, stream 9 n_out past max_seg and
    stream 10 a csize past its row (the cursor starts past the row's end;
    indices taken modulo the rows); "cursor_low" cuts stream 0's csize to an
    eighth, so its cursor falls below bit 0 long before the end (the
    lookups' zero fill)."""
    st, cs, no = streams.copy(), csize.copy(), nout.copy()
    R, width = st.shape
    if case == "corrupt":
        st[6 % R, min(cs[6 % R] // 2, width - 1)] ^= 0x40
        st[8 % R, min(max(cs[8 % R] - 1, 0), width - 1)] = 0
        cs[3 % R] = 0
        no[5 % R] = 0
        no[9 % R] = max_seg + 7
        cs[10 % R] = width + 100
    elif case == "cursor_low":
        cs[0] = max(cs[0] // 8, 1)
    return st, cs, no


@pytest.fixture(scope="module", params=["full_32k", "mixed_tables", "n_edge"])
def huf_jax_batch(request):
    """JAX's encode of a Huff0 batch and its X1 decode in each case."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import huf_kernels as j_k

    batch = request.param
    src, ns, val, nb, headers, max_block, seg_bytes, row_bytes = _huf_batch(batch)
    words, sizes = j_k.huf_encode_4x_batch(jnp.asarray(src), jnp.asarray(ns),
                                           jnp.asarray(val), jnp.asarray(nb), max_block,
                                           seg_bytes)
    words, sizes = np.asarray(words), np.asarray(sizes)
    streams, csize, nout, tlogs, weights = _huf_decode_inputs(words, sizes, ns, headers,
                                                              row_bytes)
    byte_t, nb_t = j_k.build_dtables_x1(jnp.asarray(weights),
                                        jnp.asarray(tlogs.reshape(-1, 4)[:, 0]))
    tl, bt, nt = _huf_alter_tables(batch, tlogs, np.asarray(byte_t), np.asarray(nb_t))
    max_seg = (max_block + 3) // 4
    dec = {}
    for case in HUF_CASES:
        st, cs, no = _huf_decode_case(streams, csize, nout, case, max_seg)
        out, err = j_k.huf_decode_4x1_batch(jnp.asarray(st), jnp.asarray(cs), jnp.asarray(no),
                                            jnp.asarray(tl), (jnp.asarray(bt), jnp.asarray(nt)),
                                            max_seg=max_seg)
        dec[case] = (st, cs, no, np.asarray(out), np.asarray(err))
    return dict(batch=batch, src=src, ns=ns, val=val, nb=nb, max_block=max_block,
                seg_bytes=seg_bytes, words=words, sizes=sizes, tl=tl, bt=bt, nt=nt,
                max_seg=max_seg, dec=dec)


def test_huf_batch_encode_plain_equals_jax(huf_jax_batch):
    """Whole 32 KiB blocks, n = 0 to past max_block."""
    j = huf_jax_batch
    words, sizes = huf_kernels.huf_encode_4x_batch_plain(
        _t(j["src"]), _t(j["ns"]), _t(j["val"].astype(np.int32)),
        _t(j["nb"].astype(np.int32)), j["max_block"], j["seg_bytes"])
    assert np.array_equal(_np(words).view(np.uint32), j["words"])
    assert np.array_equal(_np(sizes), j["sizes"])
    if j["batch"] == "n_edge":        # n = 0: four streams of the endMark alone
        assert j["sizes"][0].tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("case", HUF_CASES)
def test_huf_batch_decode_plain_equals_jax(huf_jax_batch, case):
    """The X1 decode of those batches, streams of one block with different
    tables or tableLogs, corrupt streams, csize 0 or past the row, n_out 0 or
    past max_seg, and a cursor below bit 0 long before the end."""
    j = huf_jax_batch
    st, cs, no, out_want, err_want = j["dec"][case]
    out, err = huf_kernels.huf_decode_4x1_batch_plain(
        _t(st), _t(cs), _t(no), _t(j["tl"]), (_t(j["bt"]), _t(j["nt"])), j["max_seg"])
    assert np.array_equal(_np(out), out_want) and np.array_equal(_np(err), err_want)
    if case == "clean" and j["batch"] == "full_32k":
        assert not err_want.any()
        assert np.array_equal(out_want.reshape(2, -1), j["src"])


@pytest.fixture(scope="module", params=["x2_tables", "x2_odd", "nout_max_seg"])
def huf_x2_jax_batch(request):
    """JAX's X2 decode, in each case, of the GPU test's X2 batches: tables
    that differ within a block, dtLogs 0, 11 and 13, an nbBits of 13, odd
    n_out on every stream, n_out equal to max_seg on every stream."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops import huf_kernels as j_k

    batch = request.param
    src, ns, val, nb, headers, max_block, seg_bytes, row_bytes = _huf_gpu_batch(batch)
    words, sizes = huf_kernels.huf_encode_4x_batch_plain(
        _t(src), _t(ns), _t(val.astype(np.int32)), _t(nb.astype(np.int32)), max_block,
        seg_bytes)
    streams, csize, nout, _tl, _w = _huf_decode_inputs(_np(words).view(np.uint32), _np(sizes),
                                                       ns, headers, row_bytes)
    dts = {h: huf_read_dtable_x2(h)[0] for h in set(headers)}
    x2 = np.repeat(np.stack([huf_kernels.pack_dtable_x2(dts[h]) for h in headers]), 4, axis=0)
    tl2 = np.repeat(np.array([dts[h].table_log for h in headers], np.int32), 4)
    tl2, x2 = _huf_alter_x2(batch, tl2, x2)
    max_seg = (max_block + 3) // 4
    nout = _huf_batch_nout(batch, nout, max_seg)
    dec = {}
    for case in HUF_CASES:
        st, cs, no = _huf_decode_case(streams, csize, nout, case, max_seg)
        out, err = j_k.huf_decode_4x2_batch(jnp.asarray(st), jnp.asarray(cs), jnp.asarray(no),
                                            jnp.asarray(tl2), jnp.asarray(x2), max_seg=max_seg)
        dec[case] = (st, cs, no, np.asarray(out), np.asarray(err))
    return dict(batch=batch, src=src, ns=ns, tl2=tl2, x2=x2, max_seg=max_seg, dec=dec)


@pytest.mark.parametrize("case", HUF_CASES)
def test_huf_x2_batch_decode_plain_equals_jax(huf_x2_jax_batch, case):
    """The plain X2 decode of the GPU test's X2 batches equals JAX's: the
    inputs that send the kernel's blocks to its global loop or through its
    shared form below dtLog 12, the last-symbol rule on every stream, n_out
    equal to max_seg."""
    j = huf_x2_jax_batch
    st, cs, no, out_want, err_want = j["dec"][case]
    out, err = huf_kernels.huf_decode_4x2_batch_plain(_t(st), _t(cs), _t(no), _t(j["tl2"]),
                                                      _t(j["x2"]), j["max_seg"])
    assert np.array_equal(_np(out), out_want) and np.array_equal(_np(err), err_want)
    if case == "clean" and j["batch"] == "x2_odd":
        assert (no % 2 == 1).all() and not err_want.any()
        for k, n in enumerate(j["ns"]):
            seg = (int(n) + 3) // 4
            got = np.concatenate([out_want[4 * k + q, : (seg if q < 3 else n - 3 * seg)]
                                  for q in range(4)])
            assert np.array_equal(got, j["src"][k, :n])
    elif case == "clean" and j["batch"] == "x2_tables":
        assert err_want[[0, 4 * 4, 4 * 2 + 1]].all() and not err_want[4 * 6:].any()


# ---------------------------------------------------------------------------
# on the GPU: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


def _fse_wave(B: int, width: int):
    """B blocks of `width` bytes, rotations of Proba80, 14 and 2 in turn,
    the last one cut to a third: a frame's batch at the codecs' shapes."""
    bases = [np.frombuffer(generate_proba(p, width), np.uint8) for p in (80, 14, 2)]
    norm_tl = [_norm_of(b.tobytes()) for b in bases]
    src = np.zeros((B, width), np.uint8)
    norms = np.zeros((B, 256), np.int32)
    tlogs, ns = np.zeros(B, np.int32), np.full(B, width, np.int32)
    for k in range(B):
        src[k] = np.roll(bases[k % 3], 7919 * k)
        (norm, tlogs[k]), ns[k] = norm_tl[k % 3], width if k < B - 1 else width // 3
        if k == B - 1:
            src[k, ns[k]:] = 0
            norm, tlogs[k] = _norm_of(src[k, : ns[k]].tobytes())
        norms[k, : len(norm)] = norm
    return src, ns, norms, tlogs


def _fse_gpu_batch(batch: str):
    """(src, n, norm, tlog, width, out_bytes) of a GPU test batch."""
    if batch in FSE_BATCHES:
        names, width, out_bytes = FSE_BATCHES[batch]
        return (*_fse_inputs(names, width), width, out_bytes)
    if batch == "full_32k_rows8":   # decode rows 8-byte aligned, as the codec stages them
        return _fse_gpu_batch("full_32k")
    if batch == "wave_2048":        # 64 MiB in 32 KiB blocks: one wave of CTAs
        return (*_fse_wave(2048, FULL), FULL, 36000)
    # ragged_301: 301 blocks, not a multiple of the blocks a CTA takes
    names = [FSE_NAMES[k % len(FSE_NAMES)] for k in range(300)] + ["alpha8_tlog5"]
    return (*_fse_inputs(names), S, OUT_BYTES)


def _cuda_fse_vs_plain(src, ns, norms, tlogs, width, out_bytes, dev, ctables=None,
                       dtables=None, pad=96):
    """The kernels against their plain versions on the card, the encode and
    the decode of its output (rows of width + pad bytes) in each of
    FSE_CASES; returns the encode."""
    ct = ctables or fse_tables.build_ctables(_t(norms, dev), _t(tlogs, dev))
    enc = (_t(src, dev), _t(ns, dev), _t(tlogs, dev), ct)
    kw = dict(max_syms=width, out_bytes=out_bytes)
    words, csize = fse_kernels.fse_encode_batch(*enc, **kw)
    want = fse_kernels.fse_encode_batch_plain(*enc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(words, want[0]) and torch.equal(csize, want[1])
    streams = _fse_streams(_np(words).view(np.uint32), _np(csize), width, pad)
    dt = dtables or fse_tables.build_dtables(_t(norms, dev), _t(tlogs, dev))[:3]
    for case in FSE_CASES:
        st, cs = _fse_decode_case(streams, _np(csize), case)
        dec = (_t(st, dev), _t(cs, dev), _t(ns, dev), _t(tlogs, dev), dt)
        out, err = fse_kernels.fse_decode_batch(*dec, max_out=width)
        want = fse_kernels.fse_decode_batch_plain(*dec, max_out=width)
        torch.cuda.synchronize()
        assert torch.equal(out, want[0]) and torch.equal(err, want[1]), case
        whole = _np(csize) <= 4 * words.shape[1]
        if case == "clean":
            assert not _np(err)[whole].any()
        elif case == "corrupt":
            assert _np(err)[min(2, len(cs) - 1)] and not _np(err)[0]
    return words, csize


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [*FSE_BATCHES, "full_32k_rows8", "wave_2048",
                                   "ragged_301"])
def test_cuda_fse_kernels_equal_plain(cuda, batch):
    """Small and full blocks, tableLog 5 and 12, n = 2 and 3, payloads past
    out_bytes, corrupt streams and a cursor below 0 long before the end;
    decode rows that start 8 bytes into a 16-byte unit; 2048 blocks of 32
    KiB (one wave), and 301 blocks (a ragged last CTA)."""
    rk.reset_launches()
    _cuda_fse_vs_plain(*_fse_gpu_batch(batch), cuda,
                       pad=104 if batch.endswith("rows8") else 96)
    assert {k: v for k, v in rk.launches.items() if v} == {
        "fse_encode": 1, "fse_decode": len(FSE_CASES)}


@pytest.mark.gpu
def test_cuda_fse_kernels_global_table_path(cuda):
    """A table outside the kernels' shared form sends its CTA's chains to
    the table in global memory, with the same output: a state of the encode
    table outside [2^tableLog, 2^(tableLog+1)), a decode entry of 20 bits,
    both in the cells of symbol 9, which the block gives a count but never
    uses (so the output equals the unaltered tables' too)."""
    src, ns, norms, tlogs = _fse_inputs(FSE_NAMES + ["alpha8_tlog5"])
    k = len(FSE_NAMES)
    top = int(np.argmax(norms[k]))
    norms[k, top] -= 1
    norms[k, 9] = 1
    args = (src, ns, norms, tlogs, S, OUT_BYTES, cuda)
    base = _cuda_fse_vs_plain(*args)
    st, dfs, dnb = fse_tables.build_ctables(_t(norms, cuda), _t(tlogs, cuda))
    slots = np.where(norms[k] == -1, 1, np.maximum(norms[k], 0))
    st[k, int(np.cumsum(slots)[9] - slots[9])] = 3 << int(tlogs[k])
    new_state, symbol, nb_bits = fse_tables.build_dtables(_t(norms, cuda), _t(tlogs, cuda))[:3]
    nb_bits[k][symbol[k] == 9] = 20
    assert (symbol[k] == 9).sum() == 1
    got = _cuda_fse_vs_plain(*args, ctables=(st, dfs, dnb),
                             dtables=(new_state, symbol, nb_bits))
    assert all(torch.equal(a, b) for a, b in zip(got, base))


def _huf_wave(B: int):
    """B blocks of 32 KiB, rotations of Proba80, 14 and 2 in turn, the last
    one cut to a third: the 64 MiB paths' batch at B = 2048."""
    bases = [generate_proba(p, FULL) for p in (80, 14, 2)]
    codes = [_huf_code(b) for b in bases]
    blocks = [np.roll(np.frombuffer(bases[k % 3], np.uint8), 7919 * k).tobytes()
              for k in range(B)]
    blocks[-1] = blocks[-1][: FULL // 3]
    return (*_huf_arrays(blocks, FULL, [codes[k % 3] for k in range(B - 1)]
                         + [_huf_code(blocks[-1])]), FULL, (FULL + 3) // 4 + 64, 8240)


def _huf_gpu_batch(batch: str):
    """(src, ns, val, nb, headers, max_block, seg_bytes, decode row bytes) of
    a GPU test batch."""
    if batch == "rows8":            # decode rows 8 bytes into a 16-byte unit
        return (*_huf_full()[:7], 8200)
    if batch == "rows4":            # rows 0, 4, 8 and 12 bytes into a unit
        return (*_huf_full()[:7], 8196)
    if batch == "seg_odd":          # decoded into rows of max_seg + 8 bytes
        return _huf_full()
    if batch == "wave_2048":        # 64 MiB in 32 KiB blocks: one wave of CTAs
        return _huf_wave(2048)
    if batch == "ragged_301":       # not a multiple of the blocks a CTA takes
        names = [HUF_NAMES[k % len(HUF_NAMES)] for k in range(301)]
        return (*_huf_inputs(names), S, (S + 3) // 4 + 64, 2 * S // 4)
    if batch == "x2_odd":           # every stream's n_out odd: seg 1023, the 4th 1021
        return (*_huf_arrays([P80[:S - 6], P14[:S - 6], P02[:S - 6]]), S,
                (S + 3) // 4 + 64, 2 * S // 4)
    if batch in ("x2_tables", "nout_max_seg"):
        return _huf_batch("small")
    if batch == "nb20":             # a 20-bit code: the encode's first design
        src, ns, val, nb, headers, *rest = _huf_batch("small")
        top = int(np.argmax(np.bincount(src[2, : ns[2]], minlength=256)))
        nb[2, top] = 20
        return (src, ns, val, nb, headers, *rest)
    return _huf_batch(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", ["small", "full_32k", "rows8", "rows4", "seg_odd",
                                   "wave_2048", "ragged_301", "mixed_tables", "nb20",
                                   "n_edge", "x2_tables", "x2_odd", "nout_max_seg"])
def test_cuda_huf_kernels_equal_plain(cuda, batch):
    """The encode, and the X1 and X2 decodes of its output in each of
    HUF_CASES, against their plain versions on the card: small and whole
    32 KiB blocks, decode rows that start 4, 8 or 12 bytes into a 16-byte
    unit, output rows of a width that is no multiple of 16 (the X1 decode's
    byte stores), 2048 blocks of 32 KiB (one wave), 301 blocks (a ragged last CTA),
    streams of a block with different tables or tableLogs and a tableLog
    past the table (the X1 decode's global path), a 20-bit code (the
    encode's first design), n = 0 to past max_block; X2 tables that differ
    within a block, a dtLog of 0, 11 and 13 and an nbBits of 13 (the X2
    decode's global path and its shared form below dtLog 12), odd n_out on
    every stream (the last-symbol rule on each), n_out equal to max_seg on
    every stream; corrupt streams, csize 0 or past the row, n_out 0 or past
    max_seg, a cursor below bit 0 long before the end."""
    src, ns, val, nb, headers, max_block, seg_bytes, row_bytes = _huf_gpu_batch(batch)
    rk.reset_launches()
    enc = (_t(src, cuda), _t(ns, cuda), _t(val.astype(np.int32), cuda),
           _t(nb.astype(np.int32), cuda), max_block, seg_bytes)
    words, sizes = huf_kernels.huf_encode_4x_batch(*enc)
    want = huf_kernels.huf_encode_4x_batch_plain(*enc)
    torch.cuda.synchronize()
    assert torch.equal(words, want[0]) and torch.equal(sizes, want[1])
    streams, csize, nout, tlogs, weights = _huf_decode_inputs(
        _np(words).view(np.uint32), _np(sizes), ns, headers, row_bytes)
    bt, nt = huf_kernels.build_dtables_x1(_t(weights, cuda),
                                          _t(tlogs.reshape(-1, 4)[:, 0], cuda))
    tl, bt, nt = _huf_alter_tables(batch, tlogs, _np(bt), _np(nt))
    dts = {h: huf_read_dtable_x2(h)[0] for h in set(headers)}
    x2 = np.repeat(np.stack([huf_kernels.pack_dtable_x2(dts[h]) for h in headers]), 4, axis=0)
    tl2 = np.repeat(np.array([dts[h].table_log for h in headers], np.int32), 4)
    tl2, x2 = _huf_alter_x2(batch, tl2, x2)
    max_seg = (max_block + 3) // 4 + (8 if batch == "seg_odd" else 0)
    nout = _huf_batch_nout(batch, nout, max_seg)
    for case in HUF_CASES:
        st, cs, no = _huf_decode_case(streams, csize, nout, case, max_seg)
        args = (_t(st, cuda), _t(cs, cuda), _t(no, cuda))
        x1 = (*args, _t(tl, cuda), (_t(bt, cuda), _t(nt, cuda)), max_seg)
        got = huf_kernels.huf_decode_4x1_batch(*x1)
        want = huf_kernels.huf_decode_4x1_batch_plain(*x1)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (case, "x1")
        if case == "clean" and batch in ("full_32k", "rows8", "rows4", "seg_odd", "wave_2048"):
            assert not _np(got[1]).any()
        elif case == "corrupt" and batch == "small":
            assert _np(got[1])[[3, 8]].all() and not _np(got[1])[[0, 5]].any()
        x2a = (*args, _t(tl2, cuda), _t(x2, cuda), max_seg)
        got = huf_kernels.huf_decode_4x2_batch(*x2a)
        want = huf_kernels.huf_decode_4x2_batch_plain(*x2a)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (case, "x2")
        if case == "corrupt" and batch == "small":
            assert _np(got[1])[8]
        elif case == "clean" and batch in ("full_32k", "wave_2048", "x2_odd"):
            assert not _np(got[1]).any()
    n = len(HUF_CASES)
    assert {k: v for k, v in rk.launches.items() if v} == {
        "huf_encode_4x": 1, "huf_decode_4x:x1": n, "huf_decode_4x:x2": n}
