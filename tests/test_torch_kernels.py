"""The port's TurboRANS kernels: plain PyTorch versions against the JAX
package, and the CUDA kernels against their plain versions.

The JAX package is imported inside the tests that use it, so the tests
marked ``gpu`` also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
Tolerance is 0 throughout: the codec is integer and bit-exact.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (_hrows_cap, _prep_group,
                                                    stage_decode_batch,
                                                    stage_encode_batch)
from finitestateentropy_tpu_torch.turbo.format import _pad_n
from finitestateentropy_tpu_torch.turbo.rans import (parse_rans_group,
                                                     rans_compress)
from finitestateentropy_tpu_torch.turbo.state import to_tensors
from finitestateentropy_tpu_torch.utils import generate_proba

CORPORA = {"p80": 80, "p14": 14, "p02": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


def _encode_batch(datas, tlog=10):
    """Port-staged encode inputs for equal-size groups."""
    n_pad = _pad_n(len(datas[0]))
    items = []
    for i, d in enumerate(datas):
        ch = np.frombuffer(d, np.uint8)
        items.append((i, ch, _prep_group(ch, tlog)))
    fc, mg, srcw = stage_encode_batch(items, n_pad)
    return fc, mg, srcw, n_pad // 4096, _hrows_cap(n_pad)


def _decode_batch(blobs):
    """Port-staged decode inputs for twin frames of one padded size."""
    groups = [parse_rans_group(b)[0] for b in blobs]
    n_pad = _pad_n(groups[0][0])
    cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
        groups, list(range(len(groups))), n_pad, groups[0][2])
    return (dict(csize_hw=cs, tables=tbl, init_states=init, streams=hws,
                 steptots=tots), t4, hrows, groups[0][2])


def _halfwords(stream, csize):
    return stream.reshape(-1).view(np.uint16)[:csize]


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("n", [40960, 262144])
def test_plain_encode_matches_jax_twin(name, n):
    from finitestateentropy_tpu.turbo.rans import (parse_rans_group as j_parse,
                                                   rans_compress as j_compress)

    data = generate_proba(CORPORA[name], n)
    _n, csize, _tl, _fl, _norm, _msv, init, payload, stots = \
        j_parse(j_compress(data))[0]
    fc, mg, srcw, t4, hcap = _encode_batch([data])
    ins = to_tensors("cpu", fc_tables=fc, magic_tables=mg, src_words=srcw)
    stream, fin, cs, st = rk.rans_encode2(
        ins["fc_tables"], ins["magic_tables"], ins["src_words"], t4, hcap, 10)
    assert int(cs[0]) == csize
    assert _halfwords(stream[0].numpy(), csize).tobytes() == payload
    fin = fin[0].numpy().reshape(-1).view(np.uint32)
    assert np.array_equal(fin, init)
    assert (fin >= 1 << 31).any()       # states >= 2^31 went through the math
    assert np.array_equal(st[0].numpy(), stots)


@pytest.mark.parametrize("name", list(CORPORA))
def test_plain_decode_matches_jax_twin(name):
    from finitestateentropy_tpu.turbo.rans import rans_compress as j_compress

    datas = [generate_proba(CORPORA[name], 262144)[i * 65536:(i + 1) * 65536]
             for i in range(3)]
    arrays, t4, hrows, tlog = _decode_batch([j_compress(d) for d in datas])
    ins = to_tensors("cpu", **arrays)
    for entry in (rk.rans_decode_v2, rk.rans_decode_plain):
        out, err = entry(ins["csize_hw"], ins["tables"], ins["init_states"],
                         ins["streams"], ins["steptots"], t4, hrows, tlog)
        assert err.tolist() == [0, 0, 0]
        assert [out[j].numpy().tobytes() for j in range(3)] == datas


def test_mulhi_and_u32_helpers_at_extremes():
    vals = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
            0xFFFFFFFF]
    a = torch.tensor([v for v in vals for _ in vals], dtype=torch.int64)
    b = torch.tensor([v for _ in vals for v in vals], dtype=torch.int64)
    want = [(x * y) >> 32 for x, y in zip(a.tolist(), b.tolist())]
    assert rk._mulhi32(a, b).tolist() == want
    assert rk._u32(rk._i32(a)).tolist() == a.tolist()


def _step_reference(x, tbl, hw, cursor, roff, tlog):
    """One decode step in Python ints (u32 semantics)."""
    out, flags = [], []
    for k in range(1024):
        slot = x[k] & ((1 << tlog) - 1)
        e = tbl[slot]
        out.append(e & 0xFF)
        x[k] = (((e >> 8) & 0xFFF) * (x[k] >> tlog) + slot - (e >> 20)) & 0xFFFFFFFF
        flags.append(x[k] < 1 << 16)
    for r in range(8):
        rank = roff[r]
        for c in range(128):
            k = r * 128 + c
            if flags[k]:
                rank += 1
                pos = min(max(cursor - rank, 0), len(hw) - 1)
                x[k] = ((x[k] << 16) | hw[pos]) & 0xFFFFFFFF
    return out


def test_decode_steps_from_states_above_2_31():
    from finitestateentropy_tpu_torch.turbo.tables import pack_rans_dtable

    tlog = 10
    rng = np.random.default_rng(31)
    tbl = pack_rans_dtable(np.array([600, 300, 100, -1, 23], np.int32), tlog)
    init = rng.integers(1 << 31, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    streams = rng.integers(-2**31, 2**31, (1, 24, 128), dtype=np.int64).astype(np.int32)
    steptots = rng.integers(0, 40, (1, 4, 8)).astype(np.int32)
    csize = np.array([int(steptots.sum()) + 5], np.int32)   # also trips `bad`
    ins = to_tensors("cpu", csize_hw=csize, tables=tbl[None],
                     init_states=init.reshape(1, 8, 128), streams=streams,
                     steptots=steptots)
    out, err = rk.rans_decode_v2(ins["csize_hw"], ins["tables"],
                                 ins["init_states"], ins["streams"],
                                 ins["steptots"], 1, 24, tlog)
    # Python-int reference of the same four steps
    x = [int(v) for v in init]
    t_u32 = [int(v) for v in tbl.reshape(-1).view(np.uint32)]
    hw = [int(v) for v in streams.reshape(-1).view(np.uint16)]
    totals = steptots[0].sum(axis=1)
    cursor = int(csize[0])
    syms = []
    for t in range(4):
        roff = np.concatenate([[0], np.cumsum(steptots[0, t])[:-1]])
        syms.append(_step_reference(x, t_u32, hw, cursor, roff, tlog))
        cursor -= int(totals[t])
    word = [syms[0][k] | syms[1][k] << 8 | syms[2][k] << 16 | syms[3][k] << 24
            for k in range(1024)]
    got = out[0].numpy().reshape(-1).view(np.uint32).tolist()
    assert got == word
    assert err.tolist() == [1]


def test_state_carry_matches_jax_encode_interpret():
    """One interpret-mode JAX encode (rans_encode2, rowloc=True) and the
    port's encode on identical inputs, carried over by turbo/state.py."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.api import _prep_group as j_prep
    from finitestateentropy_tpu.turbo.rans_kernels import (
        pack_rans_ctables as j_pack, rans_encode2 as j_encode2)

    d = np.frombuffer(generate_proba(80, 40960), np.uint8)
    norm, _msv, _nc, mfs = j_prep(d, 10)
    fc, mg = j_pack(norm)
    pad = np.full(40960, mfs, np.uint8)
    pad[:len(d)] = d
    srcw = pad.view("<u4").view(np.int32).reshape(1, 80, 128)
    hcap = _hrows_cap(40960)
    want = [np.asarray(a) for a in j_encode2(
        jnp.asarray(fc[None]), jnp.asarray(mg[None]), jnp.asarray(srcw), 10,
        hcap, True, False, 10, True, 0, True)]
    ins = to_tensors("cpu", fc_tables=fc[None], magic_tables=mg[None],
                     src_words=srcw)
    got = [a.numpy() for a in rk.rans_encode2(
        ins["fc_tables"], ins["magic_tables"], ins["src_words"], 10, hcap, 10)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    cs = int(want[2][0])
    assert int(got[2][0]) == cs
    # the payload; JAX leaves the words past csize unwritten
    assert np.array_equal(_halfwords(got[0], cs), _halfwords(want[0], cs))
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[3], want[3])


def test_state_carry_matches_jax_decode_w_interpret():
    """One interpret-mode JAX rans_decode_w and the port's entry on
    identical inputs (a clean group and a corrupt one)."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans import rans_compress as j_compress
    from finitestateentropy_tpu.turbo.rans_kernels import rans_decode_w as j_w

    datas = [generate_proba(14, 131072), generate_proba(80, 131072)]
    arrays, t4, hrows, tlog = _decode_batch([j_compress(d) for d in datas])
    arrays["streams"][1, 3, 5] ^= 0x40000       # corrupt group 1
    j_out, j_err = j_w(*(jnp.asarray(arrays[k]) for k in (
        "csize_hw", "tables", "init_states", "streams", "steptots")),
        t4, hrows, 1, tlog, 32, True)
    ins = to_tensors("cpu", **arrays)
    out, err = rk.rans_decode_w(ins["csize_hw"], ins["tables"],
                                ins["init_states"], ins["streams"],
                                ins["steptots"], t4, hrows, 1, tlog, 32)
    assert (np.asarray(j_err) != 0).tolist() == (err.numpy() != 0).tolist() \
        == [False, True]
    assert np.array_equal(out[0].numpy(), np.asarray(j_out)[0])
    assert out[0].numpy().tobytes() == datas[0]


def test_decode_w_keeps_its_shape_rule():
    arrays, t4, hrows, tlog = _decode_batch([rans_compress(generate_proba(80, 40960))])
    ins = to_tensors("cpu", **arrays)
    with pytest.raises(AssertionError):
        rk.rans_decode_w(*ins.values(), t4, hrows, 8, tlog, 32)


def test_encode_keeps_chunking_rule():
    ins = to_tensors("cpu", fc_tables=np.zeros((1, 2, 128), np.int32),
                     magic_tables=np.zeros((1, 2, 128), np.int32),
                     src_words=np.zeros((1, 300 * 8, 128), np.int32))
    with pytest.raises(ValueError, match="multiple of 256"):
        rk.rans_encode2(*ins.values(), 300, _hrows_cap(300 * 4096))


@pytest.mark.gpu
def test_cuda_encode_matches_plain(cuda):
    datas = [generate_proba(p, 262144) for p in (80, 14, 2)]
    fc, mg, srcw, t4, hcap = _encode_batch(datas)
    ins = to_tensors(cuda, fc_tables=fc, magic_tables=mg, src_words=srcw)
    args = (ins["fc_tables"], ins["magic_tables"], ins["src_words"], t4, hcap, 10)
    before = rk.launches["rans_encode2"]
    got = rk.rans_encode2(*args)
    torch.cuda.synchronize()
    assert rk.launches["rans_encode2"] == before + 1
    want = rk.rans_encode2_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for j, d in enumerate(datas):
        twin = parse_rans_group(rans_compress(d))[0]
        assert int(got[2][j]) == twin[1]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["rans_decode_v2", "rans_decode_w"])
def test_cuda_decode_matches_plain(cuda, entry):
    datas = [generate_proba(p, 262144) for p in (80, 14, 2)]
    arrays, t4, hrows, tlog = _decode_batch([rans_compress(d) for d in datas])
    arrays["streams"][2, 1, 7] ^= 0x100          # corrupt the last group
    ins = to_tensors(cuda, **arrays)
    args = (ins["csize_hw"], ins["tables"], ins["init_states"],
            ins["streams"], ins["steptots"], t4, hrows)
    before = rk.launches[entry]
    if entry == "rans_decode_w":
        out, err = rk.rans_decode_w(*args, 8, tlog, 64)
    else:
        out, err = rk.rans_decode_v2(*args, tlog)
    torch.cuda.synchronize()
    assert rk.launches[entry] == before + 1
    p_out, p_err = rk.rans_decode_plain(*args, tlog)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 0, 1]
    assert [out[j].cpu().numpy().tobytes() for j in range(2)] == datas[:2]
