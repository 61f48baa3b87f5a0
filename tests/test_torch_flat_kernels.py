"""The flat-rank decode (csrc/rans_decode_flat.cu: rans_decode on v1
frames, rans_decode_v2 and rans_decode_w on the totals wire) and the v0
TurboFSE decode (csrc/turbo_fse_decode.cu) against their plain versions,
bit for bit, at the shapes their design makes hard: step counts that are
not a multiple of the 8-step batch, a single source word, one group, three
and more groups than fit one block per SM at once, streams of many ring
chunks, u16x tables at tableLog 13 beside the ring, and corrupt groups
(flipped payload bits, a shipped step total past 8*1024, random states and
streams, compressed sizes that drive the cursor negative or past the
stream).  out, err (and the residues and end cursors of the bare kernel)
equal the plain version's; only the corrupted group is flagged.

Inputs are synthetic rANS groups (tests/test_torch_batched_kernels.py's
generator) and v0 frames of the reference corpora.  The tests marked
``gpu`` run on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_flat_kernels.py``); the others hold the same inputs'
round trips through the plain versions on the CPU.  Tolerance is 0: the
codecs are integer and bit-exact.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.turbo import kernels as v0
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.format import (parse_group,
                                                       turbo_fse_compress)
from finitestateentropy_tpu_torch.utils import generate_proba
from test_torch_batched_kernels import ALPHABET, DEC_FLAGS, ENC_FLAGS, _inputs

V1_MODES = ("byte", "pair", "u16", "u16x")
# (mode, groups, source words per lane): one word (T = spc < the batch),
# 20 byte steps or 26 u16 steps (not a multiple of the batch), 64 groups,
# and 1024 byte steps of ~7-bit symbols (about 55 ring chunks)
V1_CASES = [(m, G, t4) for m in V1_MODES for G, t4 in ((1, 1), (3, 5), (64, 2), (3, 13))]
V1_CASES.append(("byte", 3, 256))
FAULTS = ("payload", "huge_step", "random", "csize_big", "csize_negative")
# the shipped step total pushed past the batch is the totals wire's fault
CORRUPT_CASES = [(m, f) for m in V1_MODES + ("totals",) for f in FAULTS
                 if f != "huge_step" or m == "totals"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


def _group(mode, G, t4, dev, seed=0):
    """(csize, dtbl, finals, stream, stots[G,T,8], tlog, values) of G groups
    encoded by the plain encode (the wire the flat decodes read)."""
    fc, mg, srcw, dtbl, vals = _inputs(mode, G, t4, seed)
    tlog = ALPHABET[mode][0]
    hcap = (rk.SPC[mode] * t4 * 8 + 16 + 7) // 8 * 8
    stream, fin, csize, stots = rk.rans_encode2_plain(
        *(torch.from_numpy(a) for a in (fc, mg, srcw)), t4, hcap, tlog,
        **ENC_FLAGS[mode])
    return ([a.to(dev) for a in (csize, torch.from_numpy(dtbl), fin, stream)],
            stots.to(dev), hcap, tlog, vals)


def _corrupt(fault, arrays, stots, seed=11):
    """Group 1 corrupted in place; arrays = [csize, dtbl, finals, stream]."""
    csize, _dtbl, fin, stream = arrays
    rng = np.random.default_rng(seed)
    if fault == "payload":
        q = int(csize[1]) // 4
        stream[1].view(-1)[q:q + 8] ^= 0x01000100
    elif fault == "huge_step":                  # a window past K*1024 halfwords
        stots[1, min(5, stots.shape[1] - 1), 0] += 40000
    elif fault == "random":
        fin[1] = torch.from_numpy(rng.integers(1 << 31, 1 << 32, (8, 128), dtype=np.uint64)
                                  .astype(np.uint32).view(np.int32)).to(fin.device)
        stream[1] = torch.from_numpy(rng.integers(-2**31, 2**31, stream.shape[1:],
                                                  dtype=np.int64).astype(np.int32)).to(fin.device)
        stots[1] = torch.from_numpy(rng.integers(0, 129, stots.shape[1:])
                                    .astype(np.int32)).to(fin.device)
    elif fault == "csize_big":                  # the cursor starts past the stream
        csize[1] = 2**31 - 5
    else:                                       # the cursor goes negative at once
        csize[1] = 100


def _v1(arrays, t4, hcap, tlog, mode, entry=rk.rans_decode):
    return entry(*arrays, t4, hcap, tlog=tlog,
                 **{k: v for k, v in DEC_FLAGS[mode].items() if k != "quad"})


def _totals(arrays, stots, t4, hcap, tlog, entry):
    tots = stots.sum(dim=2).to(torch.int32)
    if entry == "rans_decode_w":
        return rk.rans_decode_w(*arrays, tots, t4, hcap, 8, tlog, 32)
    return getattr(rk, entry)(*arrays, tots, t4, hcap, tlog)


def _v0_batch(sizes_corpora, dev):
    """turbo_fse_decode inputs of v0 frames of one padded size."""
    datas = [generate_proba(p, n) for n, p in sizes_corpora]
    cs, tbl, init, st, t4, wrows = v0.stage_groups(
        [parse_group(turbo_fse_compress(d))[0] for d in datas])
    ins = [torch.from_numpy(a).to(dev) for a in (cs, tbl, init, st)]
    return ins, t4, wrows, datas


# ---------------------------------------------------------------------------
# CPU: the inputs of the GPU tests, through the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", V1_MODES)
def test_v1_inputs_round_trip_through_plain(mode):
    t4 = 5 if mode == "byte" else 13
    arrays, _st, hcap, tlog, vals = _group(mode, 2, t4, "cpu")
    out, err = _v1(arrays, t4, hcap, tlog, mode)
    assert err.tolist() == [0, 0]
    assert np.array_equal(out.numpy(), vals)


@pytest.mark.parametrize("entry", ["rans_decode_v2", "rans_decode_w"])
def test_totals_inputs_round_trip_through_plain(entry):
    t4 = 32 if entry == "rans_decode_w" else 5   # the windowed entry's shape rule
    arrays, stots, hcap, tlog, vals = _group("byte", 2, t4, "cpu")
    out, err = _totals(arrays, stots, t4, hcap, tlog, entry)
    assert err.tolist() == [0, 0]
    assert np.array_equal(out.numpy(), vals)


@pytest.mark.parametrize("fault", FAULTS)
def test_corrupt_inputs_flag_only_their_group_through_plain(fault):
    arrays, stots, hcap, tlog, _vals = _group("byte", 3, 8, "cpu")
    _corrupt(fault, arrays, stots)
    _out, err = (_totals(arrays, stots, 8, hcap, tlog, "rans_decode_v2")
                 if fault == "huge_step" else _v1(arrays, 8, hcap, tlog, "byte"))
    assert err.tolist() == [0, 1, 0]


def test_v0_inputs_round_trip_through_plain():
    ins, t4, wrows, datas = _v0_batch([(12288, 80), (12288, 14)], "cpu")
    assert (4 * t4) % 8                         # not a multiple of the batch
    out, err = v0.turbo_fse_decode(*ins, t4, wrows)
    assert err.tolist() == [0, 0]
    for j, d in enumerate(datas):
        assert out[j].numpy().tobytes()[:len(d)] == d


# ---------------------------------------------------------------------------
# GPU: the kernels against the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode,G,t4", V1_CASES)
def test_cuda_flat_v1_decode_matches_plain(cuda, mode, G, t4):
    arrays, _st, hcap, tlog, vals = _group(mode, G, t4, cuda)
    before = rk.launches[f"rans_decode:{mode}"]
    out, err = _v1(arrays, t4, hcap, tlog, mode)
    want = _v1(arrays, t4, hcap, tlog, mode, rk.rans_decode_v1_plain)
    torch.cuda.synchronize()
    assert rk.launches[f"rans_decode:{mode}"] == before + 1
    assert torch.equal(out, want[0]) and torch.equal(err, want[1])
    assert not err.any() and np.array_equal(out.cpu().numpy(), vals)


@pytest.mark.gpu
@pytest.mark.parametrize("G,t4", [(1, 1), (3, 5), (64, 8), (3, 256)])
@pytest.mark.parametrize("entry", ["rans_decode_v2", "rans_decode_w"])
def test_cuda_flat_totals_decode_matches_plain(cuda, entry, G, t4):
    if entry == "rans_decode_w" and t4 % 32:
        t4 = 32 * -(-t4 // 32)                  # the windowed entry's shape rule
    arrays, stots, hcap, tlog, vals = _group("byte", G, t4, cuda)
    before = rk.launches[f"{entry}:totals"]
    out, err = _totals(arrays, stots, t4, hcap, tlog, entry)
    want = rk.rans_decode_plain(*arrays, stots.sum(dim=2).to(torch.int32), t4, hcap,
                                tlog)
    torch.cuda.synchronize()
    assert rk.launches[f"{entry}:totals"] == before + 1
    assert torch.equal(out, want[0]) and torch.equal(err, want[1])
    assert not err.any() and np.array_equal(out.cpu().numpy(), vals)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,fault", CORRUPT_CASES)
def test_cuda_flat_decode_corrupt_group_matches_plain(cuda, mode, fault):
    """Group 1 of 3 corrupted; the bare kernel's out, residues and end
    cursor equal the plain version's, and the entry's err flags group 1."""
    wire = "byte" if mode == "totals" else mode
    t4 = 64 // rk.SPC[wire]
    arrays, stots, hcap, tlog, _vals = _group(wire, 3, t4, cuda)
    _corrupt(fault, arrays, stots)
    csize, dtbl, fin, stream = arrays
    cursors = None
    if mode == "totals":
        cursors = rk._decode_prep(csize, stots.sum(dim=2).to(torch.int32))[0]
    got = rk._decode_flat_kernel(dtbl, fin, stream, csize, cursors, t4, tlog, wire)
    want = rk._decode_plain(dtbl, fin, stream, t4, tlog, wire, cursors, None,
                            None if cursors is not None else csize)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if cursors is None:                         # saturated to i32, so never 0 wrongly
        assert torch.equal(got[2].long(), want[2].clamp(-2**31, 2**31 - 1))
    out, err = (_totals(arrays, stots, t4, hcap, tlog, "rans_decode_v2")
                if mode == "totals" else _v1(arrays, t4, hcap, tlog, wire))
    assert err.tolist() == [0, 1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["12K_x1", "12K_x3", "12K_x64", "1M_x3"])
def test_cuda_v0_decode_matches_plain_at_shapes(cuda, shape):
    n, G = {"12K_x1": (12288, 1), "12K_x3": (12288, 3), "12K_x64": (12288, 64),
            "1M_x3": ((1 << 20) + 100, 3)}[shape]
    ins, t4, wrows, datas = _v0_batch([(n, (80, 14, 50)[j % 3]) for j in range(G)],
                                      cuda)
    assert (4 * t4) % 8                         # 12 or 1028 steps
    before = rk.launches["turbo_fse_decode:v0"]
    out, err = v0.turbo_fse_decode(*ins, t4, wrows)
    want = v0.turbo_fse_decode_plain(*ins, t4, wrows)
    torch.cuda.synchronize()
    assert rk.launches["turbo_fse_decode:v0"] == before + 1
    assert torch.equal(out, want[0]) and torch.equal(err, want[1])
    assert not err.any()
    for j, d in enumerate(datas):
        assert out[j].cpu().numpy().tobytes()[:len(d)] == d


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["flip", "negative", "past_end", "near_min",
                                   "random_states"])
def test_cuda_v0_decode_corrupt_group_matches_plain(cuda, fault):
    """Group 1 of 3 corrupted: a flipped payload bit, a compressed size that
    drives the cursor negative, one past the stream's end, one near the
    i32 minimum, or random states.  out and err equal the plain version's."""
    ins, t4, wrows, _datas = _v0_batch([(300000, 80), (300000, 50), (300000, 14)],
                                       cuda)
    cs, _tbl, init, st = ins
    if fault == "flip":                         # a bit in the middle of the payload
        st[1].view(-1)[int(cs[1]) // 64] ^= 1 << 9
    elif fault == "negative":
        cs[1] = 1000
    elif fault == "past_end":
        cs[1] = 2**31 - 7
    elif fault == "near_min":
        cs[1] = -2**31 + 9
    else:
        init[1] = torch.from_numpy(np.random.default_rng(4).integers(
            -2**31, 2**31, (8, 128), dtype=np.int64).astype(np.int32)).to(cuda)
    out, err = v0.turbo_fse_decode(*ins, t4, wrows)
    want = v0.turbo_fse_decode_plain(*ins, t4, wrows)
    torch.cuda.synchronize()
    assert torch.equal(out, want[0]) and torch.equal(err, want[1])
    assert (err != 0).tolist() == [False, True, False]
