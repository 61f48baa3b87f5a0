"""The port's copies of jax-free host code equal their originals.

finitestateentropy_tpu_torch keeps its own copies of the host modules it
needs (it must import nothing of the JAX package); each copy is held equal
to the original here, on the three benchmark corpora.
"""
import numpy as np
import pytest

import finitestateentropy_tpu.refimpl.hist as j_hist
import finitestateentropy_tpu.refimpl.ncount as j_ncount
import finitestateentropy_tpu.refimpl.norm as j_norm
import finitestateentropy_tpu.turbo.api as j_api
import finitestateentropy_tpu.turbo.format as j_format
import finitestateentropy_tpu.turbo.rans as j_rans
import finitestateentropy_tpu.turbo.rans_kernels as j_kern
import finitestateentropy_tpu.utils.probagen as j_probagen
import finitestateentropy_tpu_torch.refimpl.hist as p_hist
import finitestateentropy_tpu_torch.refimpl.ncount as p_ncount
import finitestateentropy_tpu_torch.refimpl.norm as p_norm
import finitestateentropy_tpu_torch.turbo.api as p_api
import finitestateentropy_tpu_torch.turbo.format as p_format
import finitestateentropy_tpu_torch.turbo.rans as p_rans
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
            try:
                want = j_kern._enc_chunking(t4, spc)
            except ValueError:
                with pytest.raises(ValueError):
                    p_tables._enc_chunking(t4, spc)
            else:
                assert p_tables._enc_chunking(t4, spc) == want
    for per_group in (1, 10**5, 10**6, 1_400_000, 3 * 10**6, 10**7):
        assert j_kern._pick_nway(per_group) == p_tables._pick_nway(per_group)
    for t4 in (1, 3, 32, 64, 256, 512, 1024):
        for hrows in (24, 1040, 4112, 8208, 16400):
            for tlog in (5, 10, 12):
                assert (j_kern.v2_pick_nway(t4, hrows, tlog)
                        == p_tables.v2_pick_nway(t4, hrows, tlog))
                for G in (1, 3, 7, 8, 9, 64):
                    for windows in (0, 1, 4):
                        assert (j_api._window_dispatch(windows, t4, hrows, tlog, G, False)
                                == p_api._window_dispatch(windows, t4, hrows, tlog, G))
    for n in (1, 4096, 4097, 40960, 1 << 20, (1 << 20) + 1):
        assert j_api._hrows_cap(n) == p_api._hrows_cap(n)
        assert j_format._pad_n(n) == p_format._pad_n(n)


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
