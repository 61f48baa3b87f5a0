"""The port's device ops (ops/hist.py, ops/norm.py, ops/rans_tables.py)
against the JAX package's ops on the same numpy inputs, and against the
port's host twins (refimpl/hist.py, refimpl/norm.py, turbo/tables.py).

The cases are those of tests/test_device_norm.py: the corpora, tableLog
9-13 fuzz, the RLE and too-small flags, the reference fuzzer's corners and
normalizeM2 on Proba02, plus a 4 MiB group's total (2^22), which the JAX
op does not take.  The JAX package is imported inside the tests that use
it, so the tests marked ``gpu`` also run where JAX is not installed.
Tolerance: exact (integer ops).
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.errors import FSEError
from finitestateentropy_tpu_torch.ops.hist import (hist_count_batch,
                                                   hist_count_masked)
from finitestateentropy_tpu_torch.ops.norm import fse_normalize_batch
from finitestateentropy_tpu_torch.ops.rans_tables import (
    pack_rans_ctables_batch, pack_rans_dtable_batch)
from finitestateentropy_tpu_torch.refimpl import norm as p_norm
from finitestateentropy_tpu_torch.refimpl.hist import hist_count
from finitestateentropy_tpu_torch.turbo.tables import (pack_rans_ctables,
                                                       pack_rans_dtable)
from finitestateentropy_tpu_torch.utils import generate_proba


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _oracle(count, total, tlog):
    """(norm[256], flag) by the port's refimpl/norm.py."""
    nz = np.nonzero(count)[0]
    max_sv = int(nz.max()) if len(nz) else 0
    if count.max() == total:
        return None, 1
    try:
        norm, _ = p_norm.fse_normalize_count(tlog, count[: max_sv + 1], total,
                                             max_sv, max_table_log=13)
    except FSEError as e:
        return None, 3 if "too small for distribution" in str(e) else 2
    out = np.zeros(256, np.int64)
    out[: max_sv + 1] = norm
    return out, 0


def _port(counts, totals, tlog, device="cpu"):
    norm, flags = fse_normalize_batch(torch.as_tensor(counts, device=device),
                                      torch.as_tensor(totals, device=device),
                                      tlog)
    assert norm.dtype == flags.dtype == torch.int32
    return norm.cpu().numpy(), flags.cpu().numpy()


def _jax(counts, totals, tlog):
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops.norm import fse_normalize_batch as j_norm

    norm, flags = j_norm(jnp.asarray(counts, jnp.int32),
                         jnp.asarray(totals, jnp.int32), tlog)
    return np.asarray(norm), np.asarray(flags)


def _check(counts, totals, tlog, with_jax=True):
    """The port's op equals the refimpl oracle (flags, and the norm of the
    rows that normalize) and, where the JAX op takes the totals, JAX's."""
    norm, flags = _port(counts, totals, tlog)
    for g in range(len(totals)):
        want, fwant = _oracle(counts[g].astype(np.int64), int(totals[g]), tlog)
        assert flags[g] == fwant, (g, tlog, flags[g], fwant, totals[g])
        if fwant == 0:
            assert np.array_equal(norm[g], want), (
                g, tlog, np.nonzero(norm[g] != want)[0][:8])
    if with_jax:
        j_norm, j_flags = _jax(counts, totals, tlog)
        assert np.array_equal(flags, j_flags)
        ok = flags == 0
        assert np.array_equal(norm[ok], j_norm[ok])
    return norm, flags


def _counts_of(chunks):
    counts = np.zeros((len(chunks), 256), np.int64)
    totals = np.zeros(len(chunks), np.int64)
    for i, ch in enumerate(chunks):
        c, _, _ = hist_count(np.frombuffer(ch, np.uint8), 255)
        counts[i, : len(c)] = c
        totals[i] = len(ch)
    return counts, totals


def _corpus_chunks():
    chunks = []
    for p in (80, 14, 2):
        d = generate_proba(p)
        chunks += [d[i : i + 65536] for i in range(0, 524288, 65536)]
    noise = bytes(np.random.default_rng(3).integers(0, 256, 1 << 18,
                                                    dtype=np.uint8))
    return chunks + [noise[i : i + 65536] for i in range(0, len(noise), 65536)]


def _fuzz_rows(tlog, n=300):
    """Randomized distributions spanning skews, sparse alphabets, low
    counts and power-law tails (tests/test_device_norm.py)."""
    rng = np.random.default_rng(42 + tlog)
    rows, totals = [], []
    for it in range(n):
        nsym = int(rng.integers(2, 257))
        kind = it % 5
        if kind == 0:
            w = rng.uniform(0.3, 0.95) ** np.arange(nsym)
        elif kind == 1:
            w = 1.0 + rng.uniform(0, 0.1, nsym)
        elif kind == 2:
            w = 1.0 / (1 + np.arange(nsym)) ** rng.uniform(0.5, 2.5)
        elif kind == 3:
            w = np.full(nsym, 1.0)
            w[0] = nsym * rng.uniform(1, 50)
        else:
            w = rng.uniform(0, 1, nsym) * (rng.uniform(0, 1, nsym) > 0.5)
            w[0] = max(w[0], 0.1)
        total = int(rng.integers(max(300, 1 << (tlog - 1)), 1 << 20))
        cnt = np.floor(w / w.sum() * total).astype(np.int64)
        cnt[0] += total - cnt.sum()
        if cnt.max() == total:
            cnt[0] -= 1
            cnt[min(1, nsym - 1)] += 1
        row = np.zeros(256, np.int64)
        row[np.sort(rng.choice(256, nsym, replace=False))] = cnt
        rows.append(row)
        totals.append(total)
    return np.array(rows), np.array(totals)


def _corner_rows():
    """The reference fuzzer's crafted corners (fuzzer.c:333-363): one huge
    symbol and many tiny ones, two dominant symbols, all-low-but-one."""
    rows = []
    r = np.zeros(256, np.int64)
    r[0] = 1 << 19
    r[1:129] = 1
    rows.append(r.copy())
    r = np.zeros(256, np.int64)
    r[0] = r[1] = 1 << 18
    r[2:10] = 3
    rows.append(r.copy())
    r = np.full(256, 2, np.int64)
    r[17] = 100000
    rows.append(r)
    rows = np.array(rows)
    return rows, rows.sum(axis=1)


def _flag_rows():
    counts = np.zeros((4, 256), np.int64)
    counts[0, 7] = 5000                      # RLE
    counts[1, :2] = [700, 324]               # fine at tableLog 10
    counts[2, 128:192] = 16                  # 64 symbols x 16 = 1024
    counts[3, 200:202] = 3000                # maxSV 201: tableLog 5 too small
    return counts, np.array([5000, 1024, 1024, 6000])


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


def test_hist_equals_jax_and_refimpl():
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops.hist import hist_count_masked as j_hist

    data = np.stack([np.frombuffer(generate_proba(p)[:40000], np.uint8)
                     for p in (80, 14, 2, 50)])
    lens = np.array([40000, 1000, 777, 5], np.int32)
    got = hist_count_masked(torch.from_numpy(data), 40000,
                            torch.from_numpy(lens)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, 256)
    assert np.array_equal(got, np.asarray(j_hist(jnp.asarray(data), 40000,
                                                 jnp.asarray(lens))))
    for g, n in enumerate(lens):
        c, _, _ = hist_count(data[g, :n], 255)
        assert np.array_equal(got[g, : len(c)], c) and not got[g, len(c):].any()
    whole = hist_count_batch(torch.from_numpy(data)).numpy()
    assert np.array_equal(whole, np.asarray(j_hist(jnp.asarray(data), 40000)))
    with pytest.raises(ValueError, match="max_len"):
        hist_count_masked(torch.from_numpy(data), 100)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tlog", [10, 11, 12])
def test_norm_matches_jax_and_twin_on_corpora(tlog):
    _check(*_counts_of(_corpus_chunks()), tlog)


@pytest.mark.parametrize("tlog", [9, 10, 11, 12, 13])
def test_norm_fuzz_random_distributions(tlog):
    _check(*_fuzz_rows(tlog), tlog)


def test_norm_rle_and_too_small_flags():
    counts, totals = _flag_rows()
    _, flags = _check(counts[:3], totals[:3], 10)
    assert flags[:2].tolist() == [1, 0]
    _, flags = _check(counts, totals, 5)
    assert flags[0] == 1 and flags[3] == 3


def test_norm_reference_fuzzer_corners():
    for tlog in (9, 10, 11, 12):
        _check(*_corner_rows(), tlog)


def test_norm_m2_fallback_on_proba02(monkeypatch):
    """Proba02 at the speed-mode tableLog takes normalizeM2 for every group:
    count the twin's M2 calls while the oracle runs."""
    calls = []
    m2 = p_norm._normalize_m2
    monkeypatch.setattr(p_norm, "_normalize_m2",
                        lambda *a: calls.append(1) or m2(*a))
    d = generate_proba(2)
    counts, totals = _counts_of([d[i : i + 65536] for i in range(0, 262144, 65536)])
    _check(counts, totals, 10)
    assert len(calls) == 4


def test_norm_total_of_a_4mib_group():
    """total = 2^22 (a 4 MiB group): the int64 op has no 2^22 bound."""
    for seed, p in ((0, 80), (1, 14), (2, 2)):
        d = np.frombuffer(generate_proba(p, 1 << 22), np.uint8)
        c, _, _ = hist_count(d, 255)
        counts = np.zeros((1, 256), np.int64)
        counts[0, : len(c)] = c
        for tlog in (10, 11, 12):
            _check(counts, np.array([1 << 22]), tlog, with_jax=False)
    rows, totals = _fuzz_rows(11, n=40)
    rows[:, 0] += (1 << 22) - totals                 # lift every total to 2^22
    _check(rows, np.full(len(rows), 1 << 22), 11, with_jax=False)


def test_norm_first_maximum_ties():
    """Two equal top counts: the largest symbol takes the first maximum, as
    the reference's scan does."""
    counts = np.zeros((2, 256), np.int64)
    counts[0, [3, 9]] = 4000
    counts[0, 20:30] = 7
    counts[1, :] = 2
    counts[1, [40, 41]] = 50000
    _check(counts, counts.sum(axis=1), 10)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _norm_rows(tlog):
    """Normalized rows at tlog (three corpora; below tableLog 9, eight-symbol
    alphabets, as the corpora need more) and a delta row."""
    rows = []
    rng = np.random.default_rng(tlog)
    for p in (80, 14, 2):
        chunk = np.frombuffer(generate_proba(p)[:65536], np.uint8)
        if tlog < 9:
            chunk = chunk & 7 if p != 2 else rng.integers(0, 8, 5000, np.uint8)
        count, max_sv, _ = hist_count(chunk, 255)
        norm, _ = p_norm.fse_normalize_count(tlog, count[: max_sv + 1],
                                             len(chunk), max_sv)
        rows.append(norm)
    full = np.zeros((4, 256), np.int32)
    for g, norm in enumerate(rows):
        full[g, : len(norm)] = norm
    full[3, 77] = 1 << tlog
    return full, rows + [full[3, :78]]


@pytest.mark.parametrize("tlog", [5, 9, 10, 11, 12])
def test_table_packers_match_jax_and_host(tlog):
    import jax.numpy as jnp

    from finitestateentropy_tpu.ops.rans_tables import (
        pack_rans_ctables_batch as j_ctab, pack_rans_dtable_batch as j_dtab)

    full, norms = _norm_rows(tlog)
    fc, mg = (t.numpy() for t in pack_rans_ctables_batch(torch.from_numpy(full)))
    j_fc, j_mg = (np.asarray(t) for t in j_ctab(jnp.asarray(full)))
    assert np.array_equal(fc, j_fc) and np.array_equal(mg, j_mg)
    dt = pack_rans_dtable_batch(torch.from_numpy(full), tlog).numpy()
    if tlog >= 7:           # the JAX op needs 2^tlog >= 128
        assert np.array_equal(dt, np.asarray(j_dtab(jnp.asarray(full), tlog)))
    for g, norm in enumerate(norms):
        h_fc, h_mg = pack_rans_ctables(norm)
        used = len(norm)        # entries past maxSV are never read
        assert np.array_equal(fc[g].reshape(-1)[:used], h_fc.reshape(-1)[:used])
        assert np.array_equal(mg[g].reshape(-1)[:used], h_mg.reshape(-1)[:used])
        assert np.array_equal(dt[g], pack_rans_dtable(norm, tlog))


# ---------------------------------------------------------------------------
# on the GPU: the same ops on CUDA tensors equal their CPU runs
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_device_ops_equal_cpu(cuda):
    data = np.stack([np.frombuffer(generate_proba(p, 1 << 20), np.uint8)
                     for p in (80, 14, 2, 50)])
    lens = np.array([1 << 20, 1000, 777, 5], np.int32)
    x, n = torch.from_numpy(data), torch.from_numpy(lens)
    cpu = hist_count_masked(x, 1 << 20, n)
    assert torch.equal(hist_count_masked(x.to(cuda), 1 << 20, n.to(cuda)).cpu(), cpu)
    for tlog in (9, 10, 11, 12, 13):
        counts, totals = _fuzz_rows(tlog)
        c_norm, c_flags = _port(counts, totals, tlog)
        g_norm, g_flags = _port(counts, totals, tlog, cuda)
        assert np.array_equal(c_flags, g_flags) and np.array_equal(c_norm, g_norm)
    counts, totals = _counts_of(_corpus_chunks())
    assert all(np.array_equal(a, b) for a, b in
               zip(_port(counts, totals, 10), _port(counts, totals, 10, cuda)))
    full, _ = _norm_rows(12)
    for c_t, g_t in zip(pack_rans_ctables_batch(torch.from_numpy(full)),
                        pack_rans_ctables_batch(torch.from_numpy(full).to(cuda))):
        assert torch.equal(c_t, g_t.cpu())
    assert torch.equal(pack_rans_dtable_batch(torch.from_numpy(full), 12),
                       pack_rans_dtable_batch(torch.from_numpy(full).to(cuda), 12).cpu())
