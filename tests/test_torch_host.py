"""The port's copies of jax-free host code equal their originals.

finitestateentropy_tpu_torch keeps its own copies of the host modules it
needs (it must import nothing of the JAX package); each copy is held equal
to the original here, on the three benchmark corpora.
"""
from pathlib import Path

import numpy as np
import pytest

import finitestateentropy_tpu.refimpl.hist as j_hist
import finitestateentropy_tpu.refimpl.ncount as j_ncount
import finitestateentropy_tpu.refimpl.norm as j_norm
import finitestateentropy_tpu.refimpl.tables as j_tables
import finitestateentropy_tpu.turbo.api as j_api
import finitestateentropy_tpu.turbo.format as j_format
import finitestateentropy_tpu.turbo.kernels as j_v0
import finitestateentropy_tpu.turbo.pair as j_pair
import finitestateentropy_tpu.turbo.quad as j_quad
import finitestateentropy_tpu.turbo.rans as j_rans
import finitestateentropy_tpu.turbo.rans16 as j_rans16
import finitestateentropy_tpu.turbo.rans_kernels as j_kern
import finitestateentropy_tpu.utils.probagen as j_probagen
import finitestateentropy_tpu_torch.refimpl.hist as p_hist
import finitestateentropy_tpu_torch.refimpl.ncount as p_ncount
import finitestateentropy_tpu_torch.refimpl.norm as p_norm
import finitestateentropy_tpu_torch.refimpl.tables as p_fse_tables
import finitestateentropy_tpu_torch.turbo.api as p_api
import finitestateentropy_tpu_torch.turbo.format as p_format
import finitestateentropy_tpu_torch.turbo.kernels as p_v0
import finitestateentropy_tpu_torch.turbo.pair as p_pair
import finitestateentropy_tpu_torch.turbo.quad as p_quad
import finitestateentropy_tpu_torch.turbo.rans as p_rans
import finitestateentropy_tpu_torch.turbo.rans16 as p_rans16
import finitestateentropy_tpu_torch.turbo.tables as p_tables
import finitestateentropy_tpu_torch.utils.probagen as p_probagen

CORPORA = {"p80": 80, "p14": 14, "p02": 2}


def _corpus(name: str, n: int = 65536) -> np.ndarray:
    return np.frombuffer(j_probagen.generate_proba(CORPORA[name], n), np.uint8)


def _norm(name: str, tlog: int):
    d = _corpus(name)
    count, max_sv, _ = j_hist.hist_count(d)
    return j_norm.fse_normalize_count(tlog, count, len(d), max_sv)


@pytest.mark.parametrize("name", list(CORPORA))
def test_probagen_equal(name):
    for size in (1, 4097, 200_000):
        assert (p_probagen.generate_proba(CORPORA[name], size)
                == j_probagen.generate_proba(CORPORA[name], size))


@pytest.mark.parametrize("name", list(CORPORA))
def test_hist_normalize_ncount_equal(name):
    d = _corpus(name)
    for part in (d, d[:777]):
        jc, jm, jl = j_hist.hist_count(part)
        pc, pm, pl = p_hist.hist_count(part)
        assert np.array_equal(jc, pc) and (jm, jl) == (pm, pl)
        n = len(part)
        for tlog in range(5, 13):
            opt = j_norm.fse_optimal_table_log(tlog, n, jm)
            assert opt == p_norm.fse_optimal_table_log(tlog, n, jm)
            jn = j_norm.fse_normalize_count(opt, jc, n, jm)
            assert jn == p_norm.fse_normalize_count(opt, pc, n, pm)
            nc = j_ncount.fse_write_ncount(jn[0], jm, jn[1])
            assert nc == p_ncount.fse_write_ncount(jn[0], jm, jn[1])
            assert (j_ncount.fse_read_ncount(nc + b"\0" * 8)
                    == p_ncount.fse_read_ncount(nc + b"\0" * 8))


@pytest.mark.parametrize("T", [1, 2, 7, 40, 255])
def test_rows4_equal_including_odd_T(T):
    rng = np.random.default_rng(T)
    tots = rng.integers(0, 14, (T, 8), dtype=np.uint8)
    tots[rng.integers(0, T, 3), rng.integers(0, 8, 3)] = rng.integers(15, 130, 3)
    jp = j_rans._pack_rows4(tots)
    assert jp == p_rans._pack_rows4(tots)
    if jp is not None:
        jt, ju = j_rans._unpack_rows4(jp + b"\x07" * 5, T)
        pt, pu = p_rans._unpack_rows4(jp + b"\x07" * 5, T)
        assert np.array_equal(jt, pt) and ju == pu and np.array_equal(pt, tots)
    dense = rng.integers(15, 255, (T, 8), dtype=np.uint8)   # escape table too big
    assert j_rans._pack_rows4(dense) is None and p_rans._pack_rows4(dense) is None


@pytest.mark.parametrize("name", list(CORPORA))
def test_table_packers_equal(name):
    for want in (5, 9, 10, 11, 12):
        d = _corpus(name)
        tlog = max(want, j_norm.fse_min_table_log(len(d), int(d.max())))
        norm, tlog = _norm(name, tlog)
        jf, jm = j_kern.pack_rans_ctables(norm)
        pf, pm = p_tables.pack_rans_ctables(norm)
        assert np.array_equal(jf, pf) and np.array_equal(jm, pm)
        assert np.array_equal(j_kern.pack_rans_dtable(norm, tlog),
                              p_tables.pack_rans_dtable(norm, tlog))
        assert np.array_equal(j_rans.rans_decode_table(norm, tlog),
                              p_rans.rans_decode_table(norm, tlog))


def test_stream_words_equal():
    rng = np.random.default_rng(3)
    for hrows in (8, 24, 1040, 8208):
        assert j_kern.stream_word_rows(hrows) == p_tables.stream_word_rows(hrows)
    for n in (0, 1, 2, 3, 5, 1000, 4099):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        srows = p_tables.stream_word_rows(((n // 2 + 127) // 128 + 16 + 7) // 8 * 8)
        assert np.array_equal(j_kern.pack_stream_words(payload, srows),
                              p_tables.pack_stream_words(payload, srows))


def test_routing_helpers_equal():
    for t4 in (1, 3, 32, 64, 256, 512, 1024):
        for spc in (1, 2, 4):
            for force in (0, 1, 2, 3, 64):
                try:
                    want = j_kern._enc_chunking(t4, spc, force)
                except ValueError:
                    with pytest.raises(ValueError):
                        p_tables._enc_chunking(t4, spc, force)
                else:
                    assert p_tables._enc_chunking(t4, spc, force) == want
    for per_group in (1, 10**5, 10**6, 1_400_000, 3 * 10**6, 10**7):
        assert j_kern._pick_nway(per_group) == p_tables._pick_nway(per_group)
    # every wire (byte, pair, quad, u16, u16x) x section (rows, totals)
    wires = [{}, dict(u16=True, pair=True), dict(quad=True), dict(u16=True),
             dict(u16=True, u16x=True)]
    routes = set()
    for t4 in (1, 3, 32, 64, 256, 512, 1024):
        for hrows in (24, 1040, 4112, 8208, 16400):
            for tlog in (5, 10, 12, 13):
                for wire in wires:
                    for totals in (False, True):
                        assert (j_kern.v2_pick_nway(t4, hrows, tlog,
                                                    totals_only=totals, **wire)
                                == p_tables.v2_pick_nway(t4, hrows, tlog,
                                                         totals_only=totals, **wire))
                        for G in (1, 3, 7, 8, 9, 64):
                            for windows in (0, 1, 4, 8):
                                want = j_api._window_dispatch(
                                    windows, t4, hrows, tlog, G, totals, **wire)
                                assert want == p_api._window_dispatch(
                                    windows, t4, hrows, tlog, G, totals, **wire)
                                routes.add((tuple(wire), totals, windows,
                                            bool(want[0])))
    # both entries are reached by every wire at every windows setting but 1
    assert len(routes) == 5 * 2 * (3 * 2 + 1)
    for n in (1, 4096, 4097, 40960, 1 << 20, (1 << 20) + 1):
        assert j_api._hrows_cap(n) == p_api._hrows_cap(n)
        assert j_format._pad_n(n) == p_format._pad_n(n)
        assert j_rans16._pad_n16(n) == p_rans16._pad_n16(n)
        assert j_quad._pad_q(n) == p_quad._pad_q(n)
    assert p_rans16.RANS16_STEP_SYMS == j_rans16.RANS16_STEP_SYMS
    assert p_api.PAIR_RATIO_GIVE == j_api.PAIR_RATIO_GIVE


@pytest.mark.parametrize("name", list(CORPORA))
def test_prep_group_and_lane_views_equal(name):
    d = _corpus(name, 40960)
    for tlog in (9, 10, 12):
        for part in (d, d[:1000]):
            jp, pp = j_api._prep_group(part, tlog), p_api._prep_group(part, tlog)
            if jp is None:          # near-uniform: raw-destined in both
                assert pp is None
                continue
            assert np.array_equal(jp[0], pp[0]) and jp[1:] == pp[1:]
    assert j_api._prep_group(np.full(5000, 7, np.uint8)) is None
    assert p_api._prep_group(np.full(5000, 7, np.uint8)) is None
    m = p_format._lane_view(d)
    assert np.array_equal(m, j_format._lane_view(d))
    assert np.array_equal(p_format._unlane_view(m), j_format._unlane_view(m))


@pytest.mark.parametrize("name", list(CORPORA))
def test_numpy_twin_copy_equal(name):
    d = _corpus(name, 50000).tobytes()
    blob = j_rans.rans_compress(d)
    assert p_rans.rans_compress(d) == blob
    assert p_rans.rans_decompress(blob) == d
    jg, ju = j_rans.parse_rans_group(blob)
    pg, pu = p_rans.parse_rans_group(blob)
    assert ju == pu
    for a, b in zip(jg, pg):
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)


def _equal(a, b) -> bool:
    """Deep equality of the host modules' results (dicts, tuples, arrays)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("name", list(CORPORA))
def test_rans16_helpers_equal(name):
    d = _corpus(name, 8192).view("<u2")
    m = p_rans16._lane_view16(d)
    assert np.array_equal(m, j_rans16._lane_view16(d))
    assert np.array_equal(p_rans16._unlane_view16(m), j_rans16._unlane_view16(m))
    assert np.array_equal(p_rans16._unlane_view16(m), d)


@pytest.mark.parametrize("name", list(CORPORA))
def test_pair_copy_equal(name):
    for part in (_corpus(name), _corpus(name)[:9001]):
        assert _equal(p_pair.pair_plan(part), j_pair.pair_plan(part))
        for tlog in (0, 11, 12):
            pp = p_pair.prep_pair_group(part, tlog)
            assert _equal(pp, j_pair.prep_pair_group(part, tlog))
            blob = j_pair.pair_compress(part.tobytes(), tlog)
            assert p_pair.pair_compress(part.tobytes(), tlog) == blob
            if blob is None:
                continue
            assert _equal(p_pair.parse_pair_group(blob), j_pair.parse_pair_group(blob))
            assert _equal(p_rans.parse_rans_group(blob), j_rans.parse_rans_group(blob))
            assert p_pair.pair_decompress(blob) == part.tobytes()
            assert p_rans.rans_decompress(blob) == part.tobytes()
            assert (p_pair.predicted_bits(pp["norm"], pp["counts"], pp["tlog"])
                    == j_pair.predicted_bits(pp["norm"], pp["counts"], pp["tlog"]))
            assert np.array_equal(
                p_tables.pack_pair_dtable(pp["norm"], pp["pairs"], pp["tlog"]),
                j_kern.pack_pair_dtable(pp["norm"], pp["pairs"], pp["tlog"]))


@pytest.mark.parametrize("name", list(CORPORA) + ["p80_1MiB"])
def test_quad_copy_equal(name):
    """p80 at 1 MiB is the main path's group: quad @ 10 with escapes."""
    d = (np.frombuffer(j_probagen.generate_proba(80, 1 << 20), np.uint8)
         if name == "p80_1MiB" else _corpus(name))
    for part in (d, d[:9001]):
        assert _equal(p_quad.quad_plan(part), j_quad.quad_plan(part))
        for tlog in (0, 9, 12):
            qp = p_quad.prep_quad_group(part, tlog)
            assert _equal(qp, j_quad.prep_quad_group(part, tlog))
            blob = j_quad.quad_compress(part.tobytes(), tlog)
            assert p_quad.quad_compress(part.tobytes(), tlog) == blob
            if blob is None:
                continue
            assert _equal(p_quad.parse_quad_group(blob), j_quad.parse_quad_group(blob))
            assert _equal(p_rans.parse_rans_group(blob), j_rans.parse_rans_group(blob))
            assert p_quad.quad_decompress(blob) == part.tobytes()
            assert p_rans.rans_decompress(blob) == part.tobytes()
            assert np.array_equal(
                p_tables.pack_quad_dtable(qp["norm"], qp["quads"], qp["tlog"]),
                j_kern.pack_quad_dtable(qp["norm"], qp["quads"], qp["tlog"]))
    if name == "p80_1MiB":
        assert p_quad.quad_plan(d)["esc_id"] is not None


@pytest.mark.parametrize("name", list(CORPORA) + ["p80_1MiB"])
def test_wire_pick_equal(name):
    d = (np.frombuffer(j_probagen.generate_proba(80, 1 << 20), np.uint8)
         if name == "p80_1MiB" else _corpus(name))
    for part in (d, d[:9001]):
        prep = j_api._prep_group(part, 10)
        pp, qp = j_pair.prep_pair_group(part), j_quad.prep_quad_group(part)
        for modes in ((-1, -1), (-1, 0), (0, -1), (1, 0), (0, 1), (1, 1), (0, 0)):
            assert (p_api._pick_wire(part, prep, 10, pp, qp, *modes)
                    == j_api._pick_wire(part, prep, 10, pp, qp, *modes))
        for args in ((pp, qp), (pp, None), (None, qp), (None, None)):
            assert (p_api._wire_ests(part, prep, 10, *args)
                    == j_api._wire_ests(part, prep, 10, *args))
    if name == "p80_1MiB":
        assert p_api._pick_wire(d, prep, 10, pp, qp, -1, -1) == "quad"


def _u16_symbols(alphabet: str, n: int, seed: int = 1) -> np.ndarray:
    """The JAX package's U16 corpora (tests/test_turbo.py:287, :386)."""
    rng = np.random.default_rng(seed)
    if alphabet == "u16":
        s = np.clip((rng.pareto(1.2, n) * 50).astype(np.int64), 0, 1023)
    else:
        s = np.clip((rng.pareto(1.0, n) * 300).astype(np.int64), 0, 4095)
    return s.astype(np.uint16)


@pytest.mark.parametrize("alphabet", ["u16", "u16x"])
def test_rans16_copy_equal(alphabet):
    """The whole of turbo/rans16.py: the twin in both modes, the parser
    and the decode table."""
    for n in (20000, 3000):
        s = _u16_symbols(alphabet, n)
        for steptots in (True, False):
            blob = j_rans16.rans16_compress(s, steptots)
            assert p_rans16.rans16_compress(s, steptots) == blob
            assert _equal(p_rans16.parse_rans16_group(blob),
                          j_rans16.parse_rans16_group(blob))
            assert np.array_equal(p_rans16.rans16_decompress(blob), s)
            g = j_rans16.parse_rans16_group(blob)[0]
            if g[4] is not None:
                assert np.array_equal(p_rans16.rans16_decode_table(g[4], g[2]),
                                      j_rans16.rans16_decode_table(g[4], g[2]))
    for name in ("RANS16_MAGIC", "RANS16_MAX_SYMBOL", "RANS16_KERNEL_MAX_PACKED",
                 "FLAG_RAW", "FLAG_RLE", "FLAG_STEPTOTS"):
        assert getattr(p_rans16, name) == getattr(j_rans16, name)
    assert p_rans16._HDR.format == j_rans16._HDR.format


@pytest.mark.parametrize("alphabet", ["u16", "u16x"])
def test_u16_table_packers_equal(alphabet):
    s = _u16_symbols(alphabet, 50000)
    max_sv = int(s.max())
    count = np.bincount(s, minlength=max_sv + 1)
    for req in ((9, 10, 11) if alphabet == "u16" else (12, 13)):
        tlog = max(req, j_norm.fse_min_table_log(len(s), max_sv))
        norm, tlog = j_norm.fse_normalize_count(tlog, count, len(s), max_sv,
                                                max_table_log=13)
        if alphabet == "u16":
            assert np.array_equal(p_tables.pack_rans16_dtable(norm, tlog),
                                  j_kern.pack_rans16_dtable(norm, tlog))
            pf, pm = p_tables.pack_rans16_ctables(norm)
            jf, jm = j_kern.pack_rans16_ctables(norm)
        else:
            assert np.array_equal(p_tables.pack_rans16x_dtable(norm, tlog),
                                  j_kern.pack_rans16x_dtable(norm, tlog))
            pf, pm = p_tables.pack_rans16x_ctables(norm)
            jf, jm = j_kern.pack_rans16x_ctables(norm)
        assert np.array_equal(pf, jf) and np.array_equal(pm, jm)


@pytest.mark.parametrize("mode", ["byte", "pair", "quad", "u16", "u16x"])
def test_decode_table_height(mode):
    """tch_of, which the staging and the wrappers' shape checks read, is the
    height of the JAX package's decode table of each mode."""
    ids = np.arange(4)
    for tlog in {"u16": (5, 9, 11), "u16x": (12, 13)}.get(mode, (5, 9, 11, 12)):
        norm = np.full(4, 1 << (tlog - 2))
        tbl = {"byte": lambda: j_kern.pack_rans_dtable(norm, tlog),
               "pair": lambda: j_kern.pack_pair_dtable(norm, ids, tlog),
               "quad": lambda: j_kern.pack_quad_dtable(norm, ids, tlog),
               "u16": lambda: j_kern.pack_rans16_dtable(norm, tlog),
               "u16x": lambda: j_kern.pack_rans16x_dtable(norm, tlog)}[mode]()
        assert tbl.shape == (p_tables.tch_of(mode, tlog), 128)


def test_normalize_and_ncount_at_u16_widths():
    """The U16 codec's host math: tableLog up to 13 (max_table_log /
    max_allowed = 13) and NCount headers of alphabets up to 4095 symbols,
    equal in both packages."""
    for alphabet, n in (("u16", 50000), ("u16x", 50000), ("u16x", 1500)):
        s = _u16_symbols(alphabet, n)
        max_sv = int(s.max())
        count = np.bincount(s, minlength=max_sv + 1)
        for req in (11, 12, 13):
            opt = j_norm.fse_optimal_table_log(req, n, max_sv, max_allowed=13)
            assert opt == p_norm.fse_optimal_table_log(req, n, max_sv,
                                                       max_allowed=13)
            jn = j_norm.fse_normalize_count(opt, count, n, max_sv,
                                            max_table_log=13)
            assert jn == p_norm.fse_normalize_count(opt, count, n, max_sv,
                                                    max_table_log=13)
            nc = j_ncount.fse_write_ncount(jn[0], max_sv, jn[1])
            assert nc == p_ncount.fse_write_ncount(jn[0], max_sv, jn[1])
            assert (j_ncount.fse_read_ncount(nc + b"\0" * 8, 4095)
                    == p_ncount.fse_read_ncount(nc + b"\0" * 8, 4095))
    wide = np.ones(4096, np.int64)              # all 4096 symbols present
    jn = j_norm.fse_normalize_count(13, wide, 4096, 4095, max_table_log=13)
    assert jn == p_norm.fse_normalize_count(13, wide, 4096, 4095, max_table_log=13)
    assert jn[1] == 13
    nc = p_ncount.fse_write_ncount(jn[0], 4095, 13)
    assert nc == j_ncount.fse_write_ncount(jn[0], 4095, 13)
    assert p_ncount.fse_read_ncount(nc + b"\0" * 8, 4095)[1] == 4095


def _fields_equal(a, b) -> None:
    """Two dataclass instances (CTable, DTable, TurboGroup) field by field."""
    assert type(a).__name__ == type(b).__name__
    for k, va in vars(a).items():
        vb = vars(b)[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert (va is None) == (vb is None), k
            assert va is None or (va.dtype == vb.dtype
                                  and np.array_equal(va, vb)), k
        else:
            assert va == vb, k


@pytest.mark.parametrize("name", list(CORPORA))
def test_fse_tables_copy_equal(name):
    """refimpl/tables.py: the spread, build_ctable and build_dtable (and
    the v0 decode's packed table) equal the originals at every tableLog."""
    for want in (5, 8, 10, 11, 12):
        d = _corpus(name)
        tlog = max(want, j_norm.fse_min_table_log(len(d), int(d.max())))
        norm, tlog = _norm(name, tlog)
        msv = len(norm) - 1
        assert np.array_equal(j_tables.spread_symbols(norm, msv, tlog),
                              p_fse_tables.spread_symbols(norm, msv, tlog))
        _fields_equal(j_tables.build_ctable(norm, msv, tlog),
                      p_fse_tables.build_ctable(norm, msv, tlog))
        _fields_equal(j_tables.build_dtable(norm, msv, tlog),
                      p_fse_tables.build_dtable(norm, msv, tlog))
        if tlog <= 11:
            assert np.array_equal(j_v0.pack_dtable(norm, msv, tlog),
                                  p_v0.pack_dtable(norm, msv, tlog))
    for sym in (0, 7, 255):
        _fields_equal(j_tables.build_ctable_rle(sym), p_fse_tables.build_ctable_rle(sym))
        _fields_equal(j_tables.build_dtable_rle(sym), p_fse_tables.build_dtable_rle(sym))
    for nb in (1, 5, 8):
        _fields_equal(j_tables.build_ctable_raw(nb), p_fse_tables.build_ctable_raw(nb))
        _fields_equal(j_tables.build_dtable_raw(nb), p_fse_tables.build_dtable_raw(nb))
    for n in (0, 1, 2047, 2048, 100000):
        assert j_v0.wrows_for(n) == p_v0.wrows_for(n)


@pytest.mark.parametrize("name", list(CORPORA))
def test_v0_format_copy_equal(name):
    """turbo/format.py: the v0 frames of turbo_fse_compress, parse_group and
    turbo_fse_decompress equal the originals, with the bit packers."""
    for n in (1, 100, 12288, 65536, 200_000):
        data = _corpus(name, 200_000)[:n].tobytes()
        blob = p_format.turbo_fse_compress(data)
        assert blob == j_format.turbo_fse_compress(data)
        jg, jused = j_format.parse_group(blob)
        pg, pused = p_format.parse_group(blob)
        assert jused == pused
        _fields_equal(jg, pg)
        assert p_format.turbo_fse_decompress(blob) == data \
            == j_format.turbo_fse_decompress(blob)
    for data in (b"", b"Q" * 5000):
        blob = p_format.turbo_fse_compress(data)
        assert blob == j_format.turbo_fse_compress(data)
        assert p_format.turbo_fse_decompress(blob) == data
    rng = np.random.default_rng(9)
    nbs = rng.integers(0, 12, 3000)
    vals = rng.integers(0, 1 << 11, 3000, dtype=np.uint64).astype(np.uint32)
    jw, jt = j_format._pack_bits_forward(vals, nbs)
    pw, pt = p_format._pack_bits_forward(vals, nbs)
    assert jt == pt and np.array_equal(jw, pw)
    offs = np.concatenate([[0], np.cumsum(nbs)[:-1]])
    assert np.array_equal(j_format._read_fields(jw, offs, nbs),
                          p_format._read_fields(pw, offs, nbs))
    for k in ("TURBO_MAGIC", "TURBO_LANES", "TURBO_STEP_SYMS", "TURBO_TABLELOG",
              "FLAG_RAW", "FLAG_RLE"):
        assert getattr(p_format, k) == getattr(j_format, k)


def test_xxhash32_copy_equal():
    """utils/xxhash32.py: the oracle vectors of tests/data_xxh_vectors.txt
    and the original's hashes of the corpora, with seeds."""
    import finitestateentropy_tpu.utils.xxhash32 as j_xxh
    import finitestateentropy_tpu_torch.utils.xxhash32 as p_xxh

    vectors = (Path(__file__).parent / "data_xxh_vectors.txt").read_text()
    buf, s = bytearray(1031), 2654435761
    for i in range(len(buf)):
        s = (s * 2654435761 + 2246822519) & 0xFFFFFFFF
        buf[i] = (s >> 11) & 0xFF
    for line in vectors.splitlines():
        ln, seed, h32, _h64 = line.split()
        assert p_xxh.xxh32(bytes(buf[: int(ln)]), int(seed)) == int(h32, 16)
    for name in CORPORA:
        for n in (0, 15, 16, 4097, 65536):
            d = _corpus(name)[:n]
            for seed in (0, 1, 2654435761):
                assert p_xxh.xxh32(d, seed) == j_xxh.xxh32(d, seed)


def test_jobs_copy_equal(tmp_path):
    """io/jobs.py: the metrics record and the manifest of a job, and the
    streams of the same compressor, equal the original's."""
    import finitestateentropy_tpu.io.jobs as j_jobs
    import finitestateentropy_tpu_torch.io.jobs as p_jobs

    assert p_jobs.MANIFEST_SUFFIX == j_jobs.MANIFEST_SUFFIX
    for m in ({}, dict(groups_done=3, bytes_in=3000, bytes_out=700,
                       seconds=0.5)):
        assert p_jobs.JobMetrics(**m).as_dict() == j_jobs.JobMetrics(**m).as_dict()
    src = tmp_path / "in.bin"
    src.write_bytes(_corpus("p14", 200_000).tobytes())
    for mod, out in ((p_jobs, "p.tfse"), (j_jobs, "j.tfse")):
        mod.compress_file_resumable(src, tmp_path / out, group_size=65536,
                                    compress_group=p_rans.rans_compress,
                                    max_groups=2)
        mod.compress_file_resumable(src, tmp_path / out, group_size=65536,
                                    compress_group=p_rans.rans_compress)
    assert (tmp_path / "p.tfse").read_bytes() == (tmp_path / "j.tfse").read_bytes()
    assert p_jobs.job_status(tmp_path / "p.tfse") == j_jobs.job_status(tmp_path / "j.tfse")
    assert p_jobs.job_status(tmp_path / "none.tfse") is None


def test_native_copy_equal():
    """native.py: the port's bindings load the same library and give the
    original's outputs: both encoders, the group prep, the decoders on
    byte, pair and quad frames, the u16 codec and the header walk."""
    import finitestateentropy_tpu.native as j_native
    import finitestateentropy_tpu_torch.native as p_native

    if not (p_native.available() and j_native.available()):
        pytest.skip("native/libturbofse.so could not be built")
    assert p_native._LIB == j_native._LIB
    data = b"".join(_corpus(n, 100_000).tobytes() for n in CORPORA) + b"R" * 5000
    for group in (65536, 1 << 20):
        a = p_native.rans_compress_native(data, group_size=group)
        assert a == j_native.rans_compress_native(data, group_size=group)
        assert p_native.rans_decompress_native(a) == data
        for tlog in (0, 9, 12):
            b = p_native.rans_compress2_native(data, group, tlog)
            assert b == j_native.rans_compress2_native(data, group, tlog)
            assert p_native.rans_decompress_native(b) == data
    for name in CORPORA:
        chunk = _corpus(name).tobytes()
        for tlog in (10, 11):
            got = p_native.prep_group_native(chunk, tlog)
            want = j_native.prep_group_native(chunk, tlog)
            assert got[1:] == want[1:] and np.array_equal(got[0], want[0])
    assert p_native.prep_group_native(b"Q" * 1000) is None
    # default-flag frames of the port mix pair / quad / byte groups
    mixed = p_api.turbo_compress_device(data, 65536, device="cpu")
    assert p_native._walk_groups(mixed) == j_native._walk_groups(mixed)
    assert p_native.rans_decompress_native(mixed) == data
    sym = np.clip((np.random.default_rng(0).pareto(1.2, 300_000) * 50)
                  .astype(np.int64), 0, 1023).astype(np.uint16)
    blob16 = p_native.rans16_compress_native(sym, 1 << 17)
    assert blob16 == j_native.rans16_compress_native(sym, 1 << 17)
    assert p_native._walk_groups16(blob16) == len(sym)
    assert np.array_equal(p_native.rans16_decompress_native(blob16), sym)


# ---------------------------------------------------------------------------
# the compat codecs' host copies: config, refimpl/{bitstream, blocktypes,
# fse, huf, zlibh}, io/frame.py, models/select.py
# ---------------------------------------------------------------------------


def test_config_constants_equal():
    import finitestateentropy_tpu.config as j_config
    import finitestateentropy_tpu_torch.config as p_config

    names = [n for n in dir(p_config) if n.isupper()]
    assert {"FSE_MAX_SYMBOL_VALUE", "HUF_TABLELOG_MAX", "FIO_MAGIC_HUF",
            "FIO_BLOCKSIZEID_DEFAULT", "BT_CRC"} <= set(names)
    for n in names:
        assert getattr(p_config, n) == getattr(j_config, n), n
    for size in (0, 1, 4096, 32768, 65536):
        for f in ("fse_blockbound", "fse_compressbound", "huf_blockbound",
                  "huf_compressbound", "fse_tablestep"):
            assert getattr(p_config, f)(size) == getattr(j_config, f)(size)


def test_bitstream_copy_equal():
    """BitWriter / BitReader: the same bytes and the same reads."""
    from finitestateentropy_tpu.refimpl import bitstream as j_bs
    from finitestateentropy_tpu_torch.refimpl import bitstream as p_bs

    rng = np.random.default_rng(4)
    fields = [(int(rng.integers(0, 1 << 12)), int(rng.integers(0, 13)))
              for _ in range(3000)]
    out = []
    for bs in (j_bs, p_bs):
        w = bs.BitWriter(16000)
        for i, (v, nb) in enumerate(fields):
            w.add_bits(v, nb)
            if i % 3 == 2:
                w.flush()
        size = w.close()
        out.append(w.bytes(size))
    assert out[0] == out[1] and len(out[0]) > 1000
    reads = []
    for bs in (j_bs, p_bs):
        r = bs.BitReader(out[0])
        got = []
        for _v, nb in fields[:200]:
            got.append(r.read_bits(nb))
            if len(got) % 4 == 0:
                got.append(r.reload())
        reads.append(got)
    assert reads[0] == reads[1]


@pytest.mark.parametrize("name", list(CORPORA))
def test_fse_huf_zlibh_twins_equal(name):
    import finitestateentropy_tpu.refimpl.fse as j_fse
    import finitestateentropy_tpu.refimpl.huf as j_huf
    import finitestateentropy_tpu.refimpl.zlibh as j_zlibh
    import finitestateentropy_tpu_torch.refimpl.fse as p_fse
    import finitestateentropy_tpu_torch.refimpl.huf as p_huf
    import finitestateentropy_tpu_torch.refimpl.zlibh as p_zlibh

    data = _corpus(name, 20000).tobytes()
    for part in (data, data[:777], data[:13]):
        r, jr = p_fse.fse_compress(part), j_fse.fse_compress(part)
        assert (int(r.kind), r.data) == (int(jr.kind), jr.data)
        if r.data:
            assert p_fse.fse_decompress(r.data, len(part)) == part
        r, jr = p_huf.huf_compress(part), j_huf.huf_compress(part)
        assert (int(r.kind), r.data) == (int(jr.kind), jr.data)
        if r.data:
            assert p_huf.huf_decompress(r.data, len(part)) == part
            assert (p_huf.huf_decompress_4x2(r.data, len(part))
                    == j_huf.huf_decompress_4x2(r.data, len(part)) == part)
            pt, pu = p_huf.huf_read_dtable_x2(r.data)
            jt, ju = j_huf.huf_read_dtable_x2(r.data)
            assert pu == ju and pt.table_log == jt.table_log
            assert np.array_equal(pt.nb_bits, jt.nb_bits)
        z = p_zlibh.zlibh_compress(part)
        assert z == j_zlibh.zlibh_compress(part)
        assert p_zlibh.zlibh_decompress(z, len(part)) == part


@pytest.mark.parametrize("name", list(CORPORA))
def test_frame_and_select_copies_equal(name):
    from finitestateentropy_tpu.io import frame as j_fio
    from finitestateentropy_tpu.models import select as j_select
    from finitestateentropy_tpu_torch.io import frame as p_fio
    from finitestateentropy_tpu_torch.models import select as p_select

    data = _corpus(name, 3 * 4096 + 1000).tobytes() + b"\x01" * 5000
    for codec in ("fse", "huf", "zlibh"):
        blob = p_fio.compress_bytes(data, codec, 2)
        assert blob == j_fio.compress_bytes(data, codec, 2)
        assert p_fio.decompress_bytes(blob) == data == j_fio.decompress_bytes(blob)
    blocks = p_fio.split_blocks(data, 4096)
    assert blocks == j_fio.split_blocks(data, 4096)
    assert p_select.choose_codec(blocks) == j_select.choose_codec(blocks)
    count, max_sv, _ = p_hist.hist_count(blocks[0])
    for est in ("huf_estimate_block", "fse_estimate_block"):
        assert (getattr(p_select, est)(count, max_sv, 4096)
                == getattr(j_select, est)(count, max_sv, 4096))
    assert p_fio.MAGIC_BY_CODEC == j_fio.MAGIC_BY_CODEC


def test_blocktypes_copy_equal():
    from finitestateentropy_tpu.refimpl import blocktypes as j_bt
    from finitestateentropy_tpu_torch.refimpl import blocktypes as p_bt

    assert [(k.name, int(k)) for k in p_bt.Kind] == [(k.name, int(k)) for k in j_bt.Kind]
    for ctor in ("raw", "rle"):
        assert int(getattr(p_bt.BlockResult, ctor)().kind) == int(getattr(j_bt.BlockResult,
                                                                          ctor)().kind)
    assert p_bt.BlockResult.compressed(b"ab").data == b"ab"


# ---------------------------------------------------------------------------
# refimpl/fseu16.py and utils/xxhash64.py
# ---------------------------------------------------------------------------


def _u16_dist(seed: int, n: int, mod: int = 286) -> np.ndarray:
    """tests/test_refimpl_u16.py's distance stream (log2-bucketed pareto)."""
    rng = np.random.default_rng(seed)
    return (rng.pareto(1.2, n) * 8).astype(np.uint16) % mod


def _u16_equal(j_u16, p_u16, sym, **kw) -> None:
    """fse_compress_u16 and the decode of its output: the same kind and
    bytes, the same symbols back, or the same error (each package raises
    its own errors.FSEError)."""
    try:
        jr = j_u16.fse_compress_u16(sym, **kw)
    except Exception as e:                           # noqa: BLE001
        with pytest.raises(Exception) as got:
            p_u16.fse_compress_u16(sym, **kw)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return
    pr = p_u16.fse_compress_u16(sym, **kw)
    assert (int(pr.kind), pr.data) == (int(jr.kind), jr.data)
    if pr.data:
        msv = kw.get("max_symbol_value") or 286
        back = p_u16.fse_decompress_u16(pr.data, len(sym), max_symbol_value=max(msv, 286))
        assert np.array_equal(back, j_u16.fse_decompress_u16(
            jr.data, len(sym), max_symbol_value=max(msv, 286)))
        assert np.array_equal(back, sym)


@pytest.mark.parametrize("name", list(CORPORA))
def test_fseu16_copy_equal(name):
    """The U16 twin on the corpora read as byte symbols and as 12-bit
    symbols (pairs of bytes), at the default and explicit tableLogs."""
    import finitestateentropy_tpu.refimpl.fseu16 as j_u16
    import finitestateentropy_tpu_torch.refimpl.fseu16 as p_u16

    d = _corpus(name, 40000)
    wide = ((d[0::2].astype(np.uint16) << 4) | (d[1::2] & 15)).astype(np.uint16)
    for sym, kw in ((d.astype(np.uint16), {}), (d[:777].astype(np.uint16), {}),
                    (wide, dict(max_symbol_value=4095)),
                    (wide, dict(max_symbol_value=4095, table_log=13)),
                    (wide, {})):                     # symbols past 286: raises
        _u16_equal(j_u16, p_u16, sym, **kw)
    jc = j_u16.count_u16(wide, 4095)
    pc = p_u16.count_u16(wide, 4095)
    assert np.array_equal(jc[0], pc[0]) and jc[1:] == pc[1:]


def test_fseu16_copy_equal_on_u16_cases():
    """tests/test_refimpl_u16.py's cases: its distance streams, the wide
    alphabet, RLE, oversized symbols and garbage input to the decoder."""
    import finitestateentropy_tpu.refimpl.fseu16 as j_u16
    import finitestateentropy_tpu_torch.refimpl.fseu16 as p_u16

    for seed, n in ((0, 20000), (1, 4097), (2, 100), (3, 65536), (9, 12345)):
        _u16_equal(j_u16, p_u16, _u16_dist(seed, n))
    rng = np.random.default_rng(7)
    wide = rng.integers(0, 286, 30000, dtype=np.uint16)
    wide[::3] = 5
    _u16_equal(j_u16, p_u16, wide)
    rle = p_u16.fse_compress_u16(np.full(1000, 77, np.uint16))
    assert int(rle.kind) == int(j_u16.fse_compress_u16(np.full(1000, 77, np.uint16)).kind)
    for sym, msv in ((np.array([5, 10, 300], np.uint16), 200),
                     (np.array([5, 4000], np.uint16), 0)):
        _u16_equal(j_u16, p_u16, sym, max_symbol_value=msv)
    for _ in range(100):
        g = rng.integers(0, 256, int(rng.integers(2, 200)), dtype=np.uint8).tobytes()
        outs = []
        for mod in (j_u16, p_u16):
            try:
                outs.append(mod.fse_decompress_u16(g, 4096))
            except Exception as e:                   # noqa: BLE001
                outs.append(f"{type(e).__name__}: {e}")
        if isinstance(outs[0], str):
            assert outs[0] == outs[1]
        else:
            assert np.array_equal(outs[0], outs[1])


def test_xxhash64_copy_equal():
    """utils/xxhash64.py: the oracle vectors of tests/data_xxh_vectors.txt
    and the original's hashes of the corpora, with seeds."""
    import finitestateentropy_tpu.utils.xxhash64 as j_xxh
    import finitestateentropy_tpu_torch.utils.xxhash64 as p_xxh

    vectors = (Path(__file__).parent / "data_xxh_vectors.txt").read_text()
    buf, s = bytearray(1031), 2654435761
    for i in range(len(buf)):
        s = (s * 2654435761 + 2246822519) & 0xFFFFFFFF
        buf[i] = (s >> 11) & 0xFF
    checked = 0
    for line in vectors.splitlines():
        ln, seed, _h32, h64 = line.split()
        assert p_xxh.xxh64(bytes(buf[: int(ln)]), int(seed)) == int(h64, 16)
        checked += 1
    assert checked == 33
    assert p_xxh.xxh64(b"") == 0xEF46DB3751D8E999
    for name in CORPORA:
        for n in (0, 7, 31, 32, 4097, 65536):
            d = _corpus(name)[:n]
            for seed in (0, 1, (1 << 64) - 1):
                assert p_xxh.xxh64(d, seed) == j_xxh.xxh64(d, seed)
                assert p_xxh.xxh64(d.tobytes(), seed) == j_xxh.xxh64(d.tobytes(), seed)
