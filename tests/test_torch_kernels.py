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
from finitestateentropy_tpu_torch.turbo.api import (STAGE_BATCH, _hrows_cap,
                                                    _prep_group, _wire_t4,
                                                    parse_groups, plan_decode,
                                                    plan_encode,
                                                    stage_decode_batch)
from finitestateentropy_tpu_torch.turbo.format import _pad_n
from finitestateentropy_tpu_torch.turbo.rans import (parse_rans_group,
                                                     rans_compress)
from finitestateentropy_tpu_torch.turbo.state import to_tensors
from finitestateentropy_tpu_torch.turbo.tables import pack_quad_dtable
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
    fc, mg, srcw = STAGE_BATCH["byte"](items, n_pad)
    return fc, mg, srcw, n_pad // 4096, _hrows_cap(n_pad)


def _decode_batch(blobs):
    """Port-staged decode inputs for twin frames of one padded size."""
    groups = [parse_rans_group(b)[0] for b in blobs]
    n_pad = _pad_n(groups[0][0])
    kind = groups[0][8].ndim                  # 2 rows wire, 1 totals wire
    cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
        groups, list(range(len(groups))), n_pad, groups[0][2], "byte", kind)
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
        ins["fc_tables"], ins["magic_tables"], ins["src_words"], t4, hcap,
        tlog=10)
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
                         ins["streams"], ins["steptots"], t4, hrows, tlog=tlog)
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


def _step_reference(x, tbl, hw, cursor, roff, tlog, lut=None):
    """One decode step in Python ints (u32 semantics); lut: the pair / quad
    id LUT (the LUT modes), None for the byte wire."""
    out, flags = [], []
    mask = (1 << tlog) - 1
    for k in range(1024):
        slot = x[k] & mask
        e = tbl[slot]
        if lut is None:
            out.append(e & 0xFF)
            x[k] = (((e >> 8) & 0xFFF) * (x[k] >> tlog) + slot - (e >> 20)) & 0xFFFFFFFF
        else:
            out.append(lut[e >> 2 * tlog])
            x[k] = (((e >> tlog) & mask) * (x[k] >> tlog) + (e & mask)) & 0xFFFFFFFF
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
                                 ins["steptots"], 1, 24, tlog=tlog)
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


@pytest.mark.parametrize("mode", ["pair", "quad"])
def test_lut_decode_steps_from_states_above_2_31(mode):
    """The LUT modes: pair values pack as two u16 per word, quad values are
    the whole u32 word, often >= 2^31 (the plain version masks them in
    int64)."""
    tlog, spc = 10, rk.SPC[mode]
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 1 << (16 if mode == "pair" else 32), 5,
                        dtype=np.uint64).astype(np.uint32)
    vals[0] |= 0x80000000 if mode == "quad" else 0x8000
    tbl = pack_quad_dtable(np.array([600, 300, 100, -1, 23], np.int32), vals,
                           tlog)
    init = rng.integers(1 << 31, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    streams = rng.integers(-2**31, 2**31, (1, 24, 128), dtype=np.int64).astype(np.int32)
    steptots = rng.integers(0, 40, (1, 4, 8)).astype(np.int32)
    csize = np.array([int(steptots.sum())], np.int32)
    ins = to_tensors("cpu", csize_hw=csize, tables=tbl[None],
                     init_states=init.reshape(1, 8, 128), streams=streams,
                     steptots=steptots)
    modes = dict(u16=mode == "pair", pair=mode == "pair", quad=mode == "quad")
    out, _err = rk.rans_decode_v2(ins["csize_hw"], ins["tables"],
                                  ins["init_states"], ins["streams"],
                                  ins["steptots"], 4 // spc, 24, tlog=tlog,
                                  **modes)
    x = [int(v) for v in init]
    t_u32 = [int(v) for v in tbl.reshape(-1).view(np.uint32)]
    lut = t_u32[-256:]
    hw = [int(v) for v in streams.reshape(-1).view(np.uint16)]
    totals = steptots[0].sum(axis=1)
    cursor = int(csize[0])
    vs = []
    for t in range(4):
        roff = np.concatenate([[0], np.cumsum(steptots[0, t])[:-1]])
        vs.append(_step_reference(x, t_u32, hw, cursor, roff, tlog, lut))
        cursor -= int(totals[t])
    got = out[0].numpy().reshape(-1).view(np.uint32).tolist()
    if mode == "quad":
        want = [v for step in vs for v in step]
    else:
        want = [vs[2 * t2][k] | vs[2 * t2 + 1][k] << 16
                for t2 in range(2) for k in range(1024)]
    assert got == want
    assert max(want) >= 1 << 31


def _mode_batches(data, group, **flags):
    """The port's encode and decode batches of data at these flags, keyed
    by wire: ({wire: (encode args)}, {wire: (decode arrays, t4, hrows,
    tlog)}) of the first batch of each wire."""
    from finitestateentropy_tpu_torch.turbo.api import turbo_compress_device

    _n, _f, batches = plan_encode(data, group, 10, **flags)
    enc = {}
    for (wire, n_pad, tlog), items in batches.items():
        fc, mg, srcw = STAGE_BATCH[wire](items, n_pad)
        enc.setdefault(wire, (fc, mg, srcw, _wire_t4(wire, n_pad),
                              _hrows_cap(n_pad), tlog))
    groups = parse_groups(turbo_compress_device(data, group, device="cpu",
                                                **flags))
    dec = {}
    for (wire, n_pad, tlog, kind), idxs in plan_decode(groups)[1].items():
        cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
            groups, idxs, n_pad, tlog, wire, kind)
        dec.setdefault(wire, (dict(csize_hw=cs, tables=tbl, init_states=init,
                                   streams=hws, steptots=tots), t4, hrows,
                              tlog))
    return enc, dec


def test_mode_batches_cover_pair_and_quad():
    """The CPU half of the GPU mode tests below: the batches they launch
    exist, and the plain versions decode them."""
    enc, dec = _mode_batches(generate_proba(80, 2 << 20), 1 << 20, quad=0)
    assert set(enc) == set(dec) == {"pair"}
    enc, dec = _mode_batches(generate_proba(80, 9000), 9000, quad=1)
    assert set(enc) == set(dec) == {"quad"}
    arrays, t4, hrows, tlog = dec["quad"]
    assert arrays["steptots"].shape[1] == 3         # odd T
    ins = to_tensors("cpu", **arrays)
    out, err = rk.rans_decode_plain(*ins.values(), t4, hrows, tlog, quad=True)
    assert err.tolist() == [0]


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
        ins["fc_tables"], ins["magic_tables"], ins["src_words"], 10, hcap,
        False, False, 10, True, 0, True)]
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
    before = rk.launches["rans_encode2:byte"]
    got = rk.rans_encode2(*args[:5], tlog=10, rowloc=True)
    torch.cuda.synchronize()
    assert rk.launches["rans_encode2:byte"] == before + 1
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
    before = rk.launches[f"{entry}:byte"]
    if entry == "rans_decode_w":
        out, err = rk.rans_decode_w(*args, 8, tlog, 64)
    else:
        out, err = rk.rans_decode_v2(*args, tlog=tlog)
    torch.cuda.synchronize()
    assert rk.launches[f"{entry}:byte"] == before + 1
    p_out, p_err = rk.rans_decode_plain(*args, tlog)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 0, 1]
    assert [out[j].cpu().numpy().tobytes() for j in range(2)] == datas[:2]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,flags,tlog", [
    ("pair", dict(quad=0), 9), ("pair", dict(quad=0, pair_table_log=12), 12),
    ("quad", dict(), 10), ("quad", dict(quad=1, quad_table_log=12), 12)])
def test_cuda_mode_encode_matches_plain(cuda, mode, flags, tlog):
    datas = generate_proba(80, 2 << 20) + generate_proba(90, 1 << 20)
    enc, _dec = _mode_batches(datas, 1 << 20, **flags)
    fc, mg, srcw, t4, hcap, btlog = enc[mode]
    assert btlog == tlog
    ins = to_tensors(cuda, fc_tables=fc, magic_tables=mg, src_words=srcw)
    args = (ins["fc_tables"], ins["magic_tables"], ins["src_words"], t4, hcap,
            tlog)
    modes = dict(u16=mode == "pair", quad=mode == "quad", rowloc=True)
    before = rk.launches[f"rans_encode2:{mode}"]
    got = rk.rans_encode2(*args[:5], tlog=tlog, **modes)
    torch.cuda.synchronize()
    assert rk.launches[f"rans_encode2:{mode}"] == before + 1
    want = rk.rans_encode2_plain(*args, **modes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["rans_decode_v2", "rans_decode_w"])
@pytest.mark.parametrize("mode,flags", [
    ("pair", dict(quad=0)), ("pair", dict(quad=0, pair_table_log=12)),
    ("quad", dict()), ("quad", dict(quad=1, quad_table_log=12))])
def test_cuda_mode_decode_matches_plain(cuda, entry, mode, flags):
    datas = generate_proba(80, 2 << 20) + generate_proba(90, 1 << 20)
    _enc, dec = _mode_batches(datas, 1 << 20, **flags)
    arrays, t4, hrows, tlog = dec[mode]
    assert arrays["tables"].shape[0] == 3
    arrays["streams"][2, 1, 7] ^= 0x100          # corrupt the last group
    ins = to_tensors(cuda, **arrays)
    args = (*ins.values(), t4, hrows)
    modes = dict(u16=mode == "pair", pair=mode == "pair", quad=mode == "quad")
    key = f"{entry}:{mode}"
    before = rk.launches[key]
    if entry == "rans_decode_w":
        out, err = rk.rans_decode_w(*args, 8, tlog, 64 if mode == "pair" else 128,
                                    **modes)
    else:
        out, err = rk.rans_decode_v2(*args, tlog=tlog, **modes)
    torch.cuda.synchronize()
    assert rk.launches[key] == before + 1
    p_out, p_err = rk.rans_decode_plain(*args, tlog, **modes)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 0, 1]


@pytest.mark.gpu
def test_cuda_quad_odd_T_matches_plain(cuda):
    enc, dec = _mode_batches(generate_proba(80, 9000), 9000, quad=1)
    fc, mg, srcw, t4, hcap, tlog = enc["quad"]
    ins = to_tensors(cuda, fc_tables=fc, magic_tables=mg, src_words=srcw)
    args = (*ins.values(), t4, hcap, tlog)
    for g, w in zip(rk.rans_encode2(*args[:5], tlog=tlog, quad=True),
                    rk.rans_encode2_plain(*args, quad=True)):
        assert torch.equal(g, w)
    arrays, t4, hrows, tlog = dec["quad"]
    ins = to_tensors(cuda, **arrays)
    got = rk.rans_decode_v2(*ins.values(), t4, hrows, tlog=tlog, quad=True)
    want = rk.rans_decode_plain(*ins.values(), t4, hrows, tlog, quad=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[1].tolist() == [0]


# ---------------------------------------------------------------------------
# The flat-rank decode (v1 and totals wires) and the U16 modes
# ---------------------------------------------------------------------------


def _flat_reference(x, tbl, hw, cursor, tlog, mode):
    """One flat-rank decode step in Python ints (u32 semantics): the rank
    runs over all 1024 lanes.  Returns (values, step total)."""
    out, flags = [], []
    mask = (1 << tlog) - 1
    plane = max(1 << tlog, 128)
    for k in range(1024):
        slot = x[k] & mask
        e = tbl[slot]
        if mode == "byte":
            out.append(e & 0xFF)
            x[k] = ((e >> 8) & 0xFFF) * (x[k] >> tlog) + slot - (e >> 20)
        elif mode == "u16":
            out.append(e & 0x3FF)
            x[k] = ((e >> 10) & 0x7FF) * (x[k] >> tlog) + slot - (e >> 21)
        else:                                     # u16x
            out.append(tbl[plane + slot])
            x[k] = (e >> 13) * (x[k] >> tlog) + (e & 0x1FFF)
        x[k] &= 0xFFFFFFFF
        flags.append(x[k] < 1 << 16)
    rank = 0
    for k in range(1024):
        if flags[k]:
            rank += 1
            pos = min(max(cursor - rank, 0), len(hw) - 1)
            x[k] = ((x[k] << 16) | hw[pos]) & 0xFFFFFFFF
    return out, rank


@pytest.mark.parametrize("entry,mode", [("rans_decode", "byte"),
                                        ("rans_decode", "u16"),
                                        ("rans_decode", "u16x"),
                                        ("rans_decode_v2", "byte")])
def test_flat_decode_steps_from_states_above_2_31(entry, mode):
    """Four steps of the flat-rank decode (v1: the cursor chain from csize;
    rans_decode_v2 with [G,T] totals: shipped cursors) against Python ints,
    from random states >= 2^31, in the byte, u16 and u16x table modes."""
    from finitestateentropy_tpu_torch.turbo.tables import (pack_rans16_dtable,
                                                           pack_rans16x_dtable,
                                                           pack_rans_dtable)

    rng = np.random.default_rng(41)
    norm = np.array([600, 300, 100, -1, 23], np.int32)
    tlog, spc = (12, 2) if mode == "u16x" else (10, rk.SPC[mode])
    if mode == "u16x":          # symbols past 1023 need the split table
        norm = np.zeros(1500, np.int32)
        norm[[0, 7, 1030, 1499]] = [3000, 1000, 95, 1]
        tbl = pack_rans16x_dtable(norm, tlog)
    else:
        tbl = (pack_rans_dtable if mode == "byte" else pack_rans16_dtable)(norm, tlog)
    init = rng.integers(1 << 31, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    streams = rng.integers(-2**31, 2**31, (1, 24, 128), dtype=np.int64).astype(np.int32)
    csize = np.array([3000], np.int32)
    totals = rng.integers(0, 300, (1, 4)).astype(np.int32)
    ins = to_tensors("cpu", csize_hw=csize, tables=tbl[None],
                     init_states=init.reshape(1, 8, 128), streams=streams,
                     steptots=totals)
    args = (ins["csize_hw"], ins["tables"], ins["init_states"], ins["streams"])
    u16 = dict(u16=mode != "byte", u16x=mode == "u16x")
    if entry == "rans_decode":
        out, err = rk.rans_decode(*args, 4 // spc, 24, tlog=tlog, **u16)
    else:
        out, err = rk.rans_decode_v2(*args, ins["steptots"], 1, 24, tlog=tlog)
    x = [int(v) for v in init]
    t_u32 = [int(v) for v in tbl.reshape(-1).view(np.uint32)]
    hw = [int(v) for v in streams.reshape(-1).view(np.uint16)]
    cursor, vals = int(csize[0]), []
    for t in range(4):
        if entry == "rans_decode_v2":
            cursor = int(csize[0]) - int(totals[0, :t].sum())
        step, total = _flat_reference(x, t_u32, hw, cursor, tlog, mode)
        vals.append(step)
        cursor -= total
    bits = 32 // spc
    want = [sum(vals[spc * t4 + p][k] << (bits * p) for p in range(spc))
            for t4 in range(4 // spc) for k in range(1024)]
    assert out[0].numpy().reshape(-1).view(np.uint32).tolist() == want
    assert err.tolist() == [1]     # random streams never end well-formed


def test_plain_v1_and_totals_decode_match_jax_interpret():
    """Interpret-mode JAX rans_decode (v1 byte) and rans_decode_v2 with
    [G,T] totals (_rans_decode_v2t_kernel) against the port's entries on
    the same two groups, one corrupted in its payload: the clean group's
    output and err != 0 agree."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans import rans_compress as j_compress
    from finitestateentropy_tpu.turbo.rans_kernels import (
        rans_decode as j_v1, rans_decode_v2 as j_v2)

    datas = [generate_proba(80, 40960), generate_proba(14, 40960)]
    for kw, kind in ((dict(steptots=False), 0), (dict(totals_only=True), 1)):
        groups = [parse_rans_group(j_compress(d, **kw))[0] for d in datas]
        assert (groups[0][6] >= 1 << 31).any()
        cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
            groups, [0, 1], 40960, groups[0][2], "byte", kind)
        hws[1, 3, 5] ^= 0x40000                  # corrupt group 1
        j_in = [jnp.asarray(a) for a in (cs, tbl, init, hws)]
        ins = to_tensors("cpu", csize_hw=cs, tables=tbl, init_states=init,
                         streams=hws)
        args = (ins["csize_hw"], ins["tables"], ins["init_states"],
                ins["streams"])
        if kind == 0:
            j_out, j_err = j_v1(*j_in, t4, hrows, True, False, groups[0][2])
            out, err = rk.rans_decode(*args, t4, hrows, False, False,
                                      groups[0][2])
        else:
            j_out, j_err = j_v2(*j_in, jnp.asarray(tots), t4, hrows, True,
                                groups[0][2])
            steptots = to_tensors("cpu", steptots=tots)["steptots"]
            out, err = rk.rans_decode_v2(*args, steptots, t4, hrows, False,
                                         groups[0][2])
        assert (np.asarray(j_err) != 0).tolist() == (err.numpy() != 0).tolist() \
            == [False, True]
        assert np.array_equal(out[0].numpy(), np.asarray(j_out)[0])
        assert out[0].numpy().tobytes() == datas[0]


def test_decode_mode_rules():
    arrays, t4, hrows, tlog = _decode_batch([rans_compress(generate_proba(80, 40960))])
    ins = to_tensors("cpu", **arrays)
    tots = ins["steptots"].sum(dim=2).to(torch.int32)
    with pytest.raises(ValueError, match="byte-only"):
        rk.rans_decode_v2(ins["csize_hw"], ins["tables"], ins["init_states"],
                          ins["streams"], tots, t4 * 2, hrows, tlog=tlog,
                          u16=True)
    with pytest.raises(ValueError, match="tableLog"):
        rk.rans_decode(*list(ins.values())[:4], t4, hrows, tlog=13)


def _v1_batch(mode, n=262144):
    """3-group v1 decode arrays of each mode, from the port's numpy twins."""
    from finitestateentropy_tpu_torch.turbo.api import plan_decode16
    from finitestateentropy_tpu_torch.turbo.pair import pair_compress
    from finitestateentropy_tpu_torch.turbo.rans16 import (parse_rans16_group,
                                                           rans16_compress)

    if mode in ("u16", "u16x"):
        rng = np.random.default_rng(3)
        hi, scale, a = (1023, 50, 1.2) if mode == "u16" else (4095, 300, 1.0)
        syms = [np.clip((rng.pareto(a, n // 2) * scale).astype(np.int64), 0,
                        hi).astype(np.uint16) for _ in range(3)]
        groups = parse_groups(b"".join(rans16_compress(s, False) for s in syms),
                              parse_rans16_group)
        ((wire, n_pad, tlog, kind), idxs), = plan_decode16(groups)[1].items()
        cs, tbl, init, hws, _t, t4, hrows = stage_decode_batch(
            groups, idxs, n_pad, tlog, wire, kind)
    else:
        twin = pair_compress if mode == "pair" else rans_compress
        datas = [generate_proba(p, n) for p in (80, 50, 90)]   # pair-eligible
        groups = parse_groups(b"".join(twin(d, steptots=False) for d in datas))
        ((wire, n_pad, tlog, kind), idxs), = plan_decode(groups)[1].items()
        assert (wire, kind) == (mode, 0)
        cs, tbl, init, hws, _t, t4, hrows = stage_decode_batch(
            groups, idxs, n_pad, tlog, wire, kind)
    return (dict(csize_hw=cs, tables=tbl, init_states=init, streams=hws), t4,
            hrows, tlog)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["byte", "pair", "u16", "u16x"])
def test_cuda_v1_decode_matches_plain(cuda, mode):
    arrays, t4, hrows, tlog = _v1_batch(mode)
    arrays["streams"][2, 1, 7] ^= 0x100          # corrupt the last group
    ins = to_tensors(cuda, **arrays)
    flags = dict(u16=mode != "byte", pair=mode == "pair", u16x=mode == "u16x")
    before = rk.launches[f"rans_decode:{mode}"]
    out, err = rk.rans_decode(*ins.values(), t4, hrows, tlog=tlog, **flags)
    torch.cuda.synchronize()
    assert rk.launches[f"rans_decode:{mode}"] == before + 1
    p_out, p_err = rk.rans_decode_v1_plain(*ins.values(), t4, hrows,
                                           tlog=tlog, **flags)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 0, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["rans_decode_v2", "rans_decode_w"])
def test_cuda_totals_decode_matches_plain(cuda, entry):
    datas = [generate_proba(p, 262144) for p in (80, 14, 2)]
    arrays, t4, hrows, tlog = _decode_batch(
        [rans_compress(d, totals_only=True) for d in datas])
    assert arrays["steptots"].ndim == 2
    arrays["streams"][2, 1, 7] ^= 0x100          # corrupt the last group
    ins = to_tensors(cuda, **arrays)
    args = (*ins.values(), t4, hrows)
    before = rk.launches[f"{entry}:totals"]
    if entry == "rans_decode_w":
        out, err = rk.rans_decode_w(*args, 8, tlog, 64)
    else:
        out, err = rk.rans_decode_v2(*args, tlog=tlog)
    torch.cuda.synchronize()
    assert rk.launches[f"{entry}:totals"] == before + 1
    p_out, p_err = rk.rans_decode_plain(*args, tlog)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 0, 1]


def _u16_batches(alphabet, n=1 << 18, G=3):
    """rans_encode inputs and rows-wire decode arrays of G U16 groups."""
    from finitestateentropy_tpu_torch.turbo.api import (plan_decode16,
                                                        plan_encode16)
    from finitestateentropy_tpu_torch.turbo.rans16 import (parse_rans16_group,
                                                           rans16_compress)

    rng = np.random.default_rng(8)
    hi, scale, a = (1023, 50, 1.2) if alphabet == "u16" else (4095, 300, 1.0)
    s = np.clip((rng.pareto(a, G * n) * scale).astype(np.int64), 0,
                hi).astype(np.uint16)
    _c, _f, batches = plan_encode16(s, n, True)
    ((n_pad, big, tlog), items), = batches.items()
    fc, mg, srcw = STAGE_BATCH["u16x" if big else "u16"](items, n_pad)
    enc = (fc, mg, srcw, n_pad // 2048, (n_pad // 128 + 16 + 7) // 8 * 8, tlog)
    groups = parse_groups(b"".join(rans16_compress(s[i:i + n])
                                   for i in range(0, len(s), n)),
                          parse_rans16_group)
    ((wire, n_pad, tlog, kind), idxs), = plan_decode16(groups)[1].items()
    cs, tbl, init, hws, tots, t2, hrows = stage_decode_batch(
        groups, idxs, n_pad, tlog, wire, kind)
    dec = (dict(csize_hw=cs, tables=tbl, init_states=init, streams=hws,
                steptots=tots), t2, hrows, tlog)
    return enc, dec


def test_u16_batches_cover_both_alphabets():
    """The CPU half of the U16 GPU tests below: their batches have the
    8- and 32-chunk tables and tableLog 11 and 13."""
    for alphabet, nch, tl in (("u16", 8, 11), ("u16x", 32, 13)):
        enc, dec = _u16_batches(alphabet, 16384, 2)
        assert enc[0].shape == (2, nch, 128) and enc[5] == dec[3] == tl
        assert dec[0]["tables"].shape[1] == (1 << tl) // 128 * (1 if nch == 8 else 2)


@pytest.mark.gpu
@pytest.mark.parametrize("alphabet", ["u16", "u16x"])
def test_cuda_encode16_matches_plain(cuda, alphabet):
    (fc, mg, srcw, t2, hcap, tlog), _dec = _u16_batches(alphabet)
    ins = to_tensors(cuda, fc_tables=fc, magic_tables=mg, src_words=srcw)
    args = (*ins.values(), t2, hcap, True, tlog)
    before = rk.launches[f"rans_encode:{alphabet}"]
    got = rk.rans_encode(*args[:5], False, *args[5:])
    torch.cuda.synchronize()
    assert rk.launches[f"rans_encode:{alphabet}"] == before + 1
    for g, w in zip(got, rk.rans_encode_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["rans_decode_v2", "rans_decode_w"])
@pytest.mark.parametrize("alphabet", ["u16", "u16x"])
def test_cuda_u16_decode_matches_plain(cuda, alphabet, entry):
    _enc, (arrays, t2, hrows, tlog) = _u16_batches(alphabet)
    arrays["streams"][2, 1, 7] ^= 0x100          # corrupt the last group
    ins = to_tensors(cuda, **arrays)
    args = (*ins.values(), t2, hrows)
    flags = dict(u16=True, u16x=alphabet == "u16x")
    key = f"{entry}:{alphabet}"
    before = rk.launches[key]
    if entry == "rans_decode_w":
        out, err = rk.rans_decode_w(*args, 8, tlog, 64, **flags)
    else:
        out, err = rk.rans_decode_v2(*args, tlog=tlog, **flags)
    torch.cuda.synchronize()
    assert rk.launches[key] == before + 1
    p_out, p_err = rk.rans_decode_plain(*args, tlog, **flags)
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 0, 1]
