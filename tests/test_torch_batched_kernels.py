"""The batched encode (csrc/rans_encode.cu) and the staged rows-wire decode
(csrc/rans_decode.cu) against their plain versions, bit for bit, at the
shapes their design makes hard: step counts that are not a multiple of the
16-step batch, a single source word, odd quad step counts, 4 MiB byte
groups (4096 steps), one group and more groups than the card has SMs,
states >= 2^31, u16x tables at tableLog 13 beside the stream windows, a
stream too short for the payload, no step counts, and corrupt frames whose
stream indices fall outside the staged window.

Inputs are synthetic: random normalized counts of each mode's alphabet and
symbols drawn from them, made with numpy from a seed.  The decode reads
what the encode wrote.  The tests marked ``gpu`` run on the card
(``python -m pytest --noconftest -m gpu tests/test_torch_batched_kernels.py``);
the others hold the inputs' round trip through the plain versions on the
CPU.  Tolerance is 0: the codec is integer and bit-exact.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.tables import (pack_pair_dtable,
                                                       pack_quad_dtable,
                                                       pack_rans16_ctables,
                                                       pack_rans16_dtable,
                                                       pack_rans16x_ctables,
                                                       pack_rans16x_dtable,
                                                       pack_rans_ctables,
                                                       pack_rans_dtable)

# mode -> (tableLog, alphabet size)
ALPHABET = {"byte": (11, 200), "pair": (10, 256), "quad": (10, 256),
            "u16": (11, 1000), "u16x": (13, 4000)}
ENC_FLAGS = {"byte": {}, "pair": dict(u16=True), "quad": dict(quad=True),
             "u16": dict(u16=True), "u16x": dict(u16=True)}
DEC_FLAGS = {"byte": {}, "pair": dict(u16=True, pair=True),
             "quad": dict(quad=True), "u16": dict(u16=True),
             "u16x": dict(u16=True, u16x=True)}
# (mode, groups, source words per lane): 20 byte steps (not a multiple of
# 16), one word (T = spc), odd quad T, 4 MiB byte groups, 200 groups, u16x
# at tableLog 13
CASES = [("byte", 3, 5), ("byte", 1, 1), ("pair", 1, 1), ("quad", 3, 1),
         ("quad", 3, 9), ("byte", 2, 1024), ("pair", 200, 8), ("u16", 1, 37),
         ("u16x", 3, 13), ("quad", 64, 40)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


def _inputs(mode: str, G: int, t4: int, seed: int = 0):
    """(fc, mg, srcw, dtbl, values): G groups of random counts over the
    mode's alphabet, t4 source words per lane of symbols drawn from them;
    values[G, t4*8, 128] i32 is what the decode must give back."""
    rng = np.random.default_rng(seed)
    tlog, nsym = ALPHABET[mode]
    spc = rk.SPC[mode]
    fcs, mgs, dtbls, srcs, vals = [], [], [], [], []
    for _ in range(G):
        p = rng.dirichlet(np.full(nsym, 0.3))
        norm = 1 + rng.multinomial((1 << tlog) - nsym, p)
        syms = rng.choice(nsym, size=t4 * 1024 * spc, p=norm / norm.sum())
        if mode in ("byte", "pair", "quad"):
            fc, mg = pack_rans_ctables(norm)
        else:
            fc, mg = (pack_rans16_ctables if mode == "u16"
                      else pack_rans16x_ctables)(norm)
        if mode == "byte":
            dtbl, v = pack_rans_dtable(norm, tlog), syms
        elif mode == "pair":
            lut = rng.integers(0, 1 << 16, 256).astype(np.uint16)
            dtbl, v = pack_pair_dtable(norm, lut, tlog), lut[syms]
        elif mode == "quad":
            lut = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
            dtbl, v = pack_quad_dtable(norm, lut, tlog), lut[syms]
        else:
            dtbl = (pack_rans16_dtable(norm, tlog) if mode == "u16"
                    else pack_rans16x_dtable(norm, tlog))
            v = syms
        # symbol p of a word sits at bit 32/spc*p, as the lanes lay them out
        per_word = 32 // spc
        dt = {8: "<u1", 16: "<u2", 32: "<u4"}[per_word]
        words = syms.reshape(t4, spc, 1024).transpose(0, 2, 1).astype(dt)
        srcs.append(words.reshape(-1).view("<u4").view(np.int32).reshape(t4 * 8, 128))
        out = v.reshape(t4, spc, 1024).transpose(0, 2, 1).astype(dt)
        vals.append(out.reshape(-1).view("<u4").view(np.int32).reshape(t4 * 8, 128))
        fcs.append(fc), mgs.append(mg), dtbls.append(dtbl)
    return (np.stack(fcs), np.stack(mgs), np.stack(srcs), np.stack(dtbls),
            np.stack(vals))


def _encode_args(dev, mode, G, t4, hcap=None):
    fc, mg, srcw, dtbl, vals = _inputs(mode, G, t4)
    tlog = ALPHABET[mode][0]
    # room for one halfword per lane-step: the stream never runs out
    hcap = hcap or (rk.SPC[mode] * t4 * 8 + 16 + 7) // 8 * 8
    ins = [torch.from_numpy(a).to(dev) for a in (fc, mg, srcw)]
    return (*ins, t4, hcap, tlog), dtbl, vals


def _decode(dev, entry, mode, enc, dtbl, t4, hcap, tlog, **kw):
    """Decode arguments from an encode's output [stream, finals, csize,
    stots]; entry(...) and the plain version's (out, err)."""
    stream, fin, csize, stots = enc
    args = (csize, torch.from_numpy(dtbl).to(dev), fin, stream, stots, t4,
            hcap)
    got = entry(*args, tlog=tlog, **DEC_FLAGS[mode], **kw)
    want = rk.rans_decode_plain(*args, tlog=tlog, **DEC_FLAGS[mode])
    return got, want


@pytest.mark.parametrize("mode", list(ALPHABET))
def test_inputs_round_trip_through_plain(mode):
    """The CPU half of the GPU tests below: the synthetic inputs of each
    mode go through the plain encode and back through the plain decode,
    T = 20 byte steps included (not a multiple of the batch)."""
    t4 = 5 if mode == "byte" else 2
    args, dtbl, vals = _encode_args("cpu", mode, 2, t4)
    enc = rk.rans_encode2(*args[:5], tlog=args[5], **ENC_FLAGS[mode])
    assert (rk._u32(enc[1]) >= 1 << 31).any()
    (out, err), (p_out, p_err) = _decode("cpu", rk.rans_decode_v2, mode, enc,
                                         dtbl, t4, args[4], args[5])
    assert err.tolist() == [0, 0]
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert np.array_equal(out.numpy(), vals)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,G,t4", CASES)
def test_cuda_batched_encode_matches_plain(cuda, mode, G, t4):
    args, _dtbl, _vals = _encode_args(cuda, mode, G, t4)
    flags = ENC_FLAGS[mode]
    for steptots in (True, False):
        got = rk.rans_encode2(*args[:5], tlog=args[5], **flags, steptots=steptots, rowloc=True)
        want = rk.rans_encode2_plain(*args, **flags, steptots=steptots)
        torch.cuda.synchronize()
        assert (got[3] is None) == (not steptots)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    if rk.SPC[mode] * t4 >= 16:             # a few steps cannot reach 2^31
        assert (rk._u32(got[1]) >= 1 << 31).any()
    if mode in ("byte", "u16", "u16x"):     # the v1 layout: one halfword per i32
        v1 = (*args[:5], mode != "byte", args[5])
        got = rk.rans_encode(*args[:5], False, mode != "byte", args[5])
        for g, w in zip(got, rk.rans_encode_plain(*v1)):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["byte", "quad", "u16x"])
def test_cuda_batched_encode_short_stream_matches_plain(cuda, mode):
    """A stream of 16 halfword rows (4096 halfwords): the halfwords past
    it are dropped, csize still counts them."""
    args, _dtbl, _vals = _encode_args(cuda, mode, 3, 40 if mode == "quad" else 9,
                                      hcap=16)
    got = rk.rans_encode2(*args[:5], tlog=args[5], **ENC_FLAGS[mode])
    want = rk.rans_encode2_plain(*args, **ENC_FLAGS[mode])
    torch.cuda.synchronize()
    assert int(got[2].min()) > got[0][0].numel() * 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,G,t4", CASES)
def test_cuda_staged_decode_matches_plain(cuda, mode, G, t4):
    args, dtbl, vals = _encode_args(cuda, mode, G, t4)
    enc = rk.rans_encode2_plain(*args, **ENC_FLAGS[mode])
    hcap, tlog = args[4], args[5]
    entries = [rk.rans_decode_v2]
    S = 128 // rk.SPC[mode]
    if t4 % S == 0:                         # the windowed entry's shape rule
        entries.append(lambda *a, **k: rk.rans_decode_w(*a[:7], 8, k.pop("tlog"),
                                                        S, **k))
    for entry in entries:
        (out, err), (p_out, p_err) = _decode(cuda, entry, mode, enc, dtbl, t4,
                                             hcap, tlog)
        torch.cuda.synchronize()
        assert torch.equal(out, p_out) and torch.equal(err, p_err)
        assert not err.any()
        assert np.array_equal(out.cpu().numpy(), vals)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(ALPHABET))
@pytest.mark.parametrize("fault", ["payload", "row_count", "huge_step", "random"])
def test_cuda_staged_decode_corrupt_group_matches_plain(cuda, mode, fault):
    """Group 1 of 3 corrupted: flipped payload bits, a row count moved by
    3000 in the middle of a batch (its row reads below the staged window),
    a step total past 16*1024 (a window larger than the buffer), or random
    states >= 2^31, stream and counts.  out and err equal the plain
    version's; only group 1 is flagged."""
    t4 = 64 // rk.SPC[mode]
    args, dtbl, _vals = _encode_args(cuda, mode, 3, t4)
    stream, fin, csize, stots = rk.rans_encode2_plain(*args, **ENC_FLAGS[mode])
    stream, fin, csize, stots = (a.clone() for a in (stream, fin, csize, stots))
    rng = np.random.default_rng(11)
    if fault == "payload":
        q = int(csize[1]) // 4
        stream[1].view(-1)[q:q + 8] ^= 0x01000100
    elif fault == "row_count":
        stots[1, 21, 3] += 3000
    elif fault == "huge_step":
        stots[1, 5, 0] += 40000
    else:
        fin[1] = torch.from_numpy(rng.integers(1 << 31, 1 << 32, (8, 128), dtype=np.uint64)
                                  .astype(np.uint32).view(np.int32)).to(cuda)
        stream[1] = torch.from_numpy(rng.integers(-2**31, 2**31, stream.shape[1:],
                                                  dtype=np.int64).astype(np.int32)).to(cuda)
        stots[1] = torch.from_numpy(rng.integers(0, 129, stots.shape[1:])
                                    .astype(np.int32)).to(cuda)
    (out, err), (p_out, p_err) = _decode(cuda, rk.rans_decode_v2, mode,
                                         (stream, fin, csize, stots), dtbl, t4,
                                         args[4], args[5])
    torch.cuda.synchronize()
    assert torch.equal(out, p_out) and torch.equal(err, p_err)
    assert err.tolist() == [0, 1, 0]
