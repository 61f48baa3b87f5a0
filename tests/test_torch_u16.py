"""The port's TurboRANS-U16 codec against the JAX package.

Frames from turbo16_compress_device on the CPU (the plain PyTorch versions
of the kernels) must equal the JAX package's numpy twin rans16_compress
and its turbo16_compress_device, byte for byte, for alphabets up to 1023
(u16 tables, tableLog 11) and up to 4095 (u16x split tables, tableLog
12-13), in speed mode and in ratio mode; each package, and the native C
decoder, must read the other's frames.  The symbol corpora are the JAX
package's own (tests/test_turbo.py:287, :386).  Tolerance is 0
throughout: the codec is integer and bit-exact.
"""
import numpy as np
import pytest

from finitestateentropy_tpu.turbo.rans16 import (rans16_compress as j_twin16,
                                                 rans16_decompress as j_untwin16)
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (
    _round8, parse_groups16, plan_encode16, stage_decode16_batch,
    stage_encode16_batch, turbo16_compress_device, turbo16_decompress_device)
from finitestateentropy_tpu_torch.turbo.state import to_tensors

ALPHABETS = ("u16", "u16x")


def symbols(alphabet: str, n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if alphabet == "u16":
        s = np.clip((rng.pareto(1.2, n) * 50).astype(np.int64), 0, 1023)
    else:
        s = np.clip((rng.pareto(1.0, n) * 300).astype(np.int64), 0, 4095)
    return s.astype(np.uint16)


def compress(s, group_syms=1 << 19, **kw):
    return turbo16_compress_device(s, group_syms, device="cpu", **kw)


def decompress(blob, **kw):
    return turbo16_decompress_device(blob, device="cpu", **kw)


@pytest.mark.parametrize("steptots", [True, False])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_u16_frames_equal_jax_twin(alphabet, steptots):
    s, gs = symbols(alphabet, 40000), 16384
    port = compress(s, gs, steptots=steptots)
    twins = [j_twin16(s[i:i + gs], steptots) for i in range(0, len(s), gs)]
    assert port == b"".join(twins)
    assert np.array_equal(decompress(port), s)
    pos = 0
    for i, twin in enumerate(twins):     # the JAX twin reads the port's frames
        assert np.array_equal(j_untwin16(port[pos:pos + len(twin)]),
                              s[i * gs:(i + 1) * gs])
        pos += len(twin)
    g = parse_groups16(port)[0]
    assert (g[5] > 1023) == (alphabet == "u16x")
    assert g[2] == (11 if alphabet == "u16" else 13)
    assert (g[8] is not None) == steptots


@pytest.mark.parametrize("steptots", [True, False])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_u16_frames_equal_jax_device_interpret(alphabet, steptots):
    from finitestateentropy_tpu.turbo.api import \
        turbo16_compress_device as j_compress16

    s = symbols(alphabet, 6000, 21)
    want = j_compress16(s, interpret=True, steptots=steptots)
    assert compress(s, steptots=steptots) == want
    assert np.array_equal(decompress(want), s)


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_native_reads_port_u16_frames(alphabet):
    from finitestateentropy_tpu import native

    if not native.available():
        pytest.skip("native/libturbofse.so not built here")
    s, gs = symbols(alphabet, 50000, 4), 16384
    for steptots in (True, False):
        port = compress(s, gs, steptots=steptots)
        assert np.array_equal(native.rans16_decompress_native(port), s)
    # the native encoder writes ratio-mode frames: the port's, and it reads them
    blob = native.rans16_compress_native(s, gs)
    assert blob == port
    assert np.array_equal(decompress(blob), s)


@pytest.mark.parametrize("steptots", [True, False])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_u16_flipped_payload_raises(alphabet, steptots):
    blob = bytearray(compress(symbols(alphabet, 20000, 9), steptots=steptots))
    blob[len(blob) - 100] ^= 0xFF
    with pytest.raises(ValueError):
        decompress(bytes(blob))


def test_u16_passthrough_groups():
    """Empty, RLE and near-uniform (raw) groups are the twin's frames, a
    symbol above 4095 raises as in the twin, and groups of both alphabets
    batch apart and reassemble in order."""
    empty = np.zeros(0, np.uint16)
    assert compress(empty) == j_twin16(empty)
    assert decompress(compress(empty)).size == 0
    rle = np.full(5000, 286, np.uint16)
    assert compress(rle) == j_twin16(rle)
    assert np.array_equal(decompress(compress(rle)), rle)
    flat = np.random.default_rng(2).integers(0, 4096, 3000).astype(np.uint16)
    assert compress(flat) == j_twin16(flat)
    assert np.array_equal(decompress(compress(flat)), flat)
    with pytest.raises(ValueError, match="4095"):
        compress(np.array([5000, 1, 2], np.uint16))
    mixed = np.concatenate([symbols("u16", 6000, 3), rle[:6000],
                            symbols("u16x", 12000, 3)])
    port = compress(mixed, 6000)
    assert port == b"".join(j_twin16(mixed[i:i + 6000])
                            for i in range(0, len(mixed), 6000))
    assert np.array_equal(decompress(port), mixed)


@pytest.mark.parametrize("windows", [0, 1, 8])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_u16_routing_matches_jax_dispatch(alphabet, windows, monkeypatch):
    """Speed frames go where the JAX dispatch sends them (u16=True,
    u16x=big), ratio frames to rans_decode."""
    from finitestateentropy_tpu.turbo.api import _window_dispatch as j_dispatch
    from finitestateentropy_tpu_torch.turbo import api

    calls = []
    for name in ("rans_decode", "rans_decode_v2", "rans_decode_w"):
        entry = getattr(api, name)

        def spy(*a, _name=name, _entry=entry, **kw):
            calls.append((_name, a))
            return _entry(*a, **kw)
        monkeypatch.setattr(api, name, spy)
    s, gs = symbols(alphabet, 8 * 131072, 6), 131072
    for steptots in (True, False):
        calls.clear()
        blob = b"".join(j_twin16(s[i:i + gs], steptots)
                        for i in range(0, len(s), gs))
        assert np.array_equal(decompress(blob, windows=windows), s)
        (name, a), = calls
        if not steptots:
            assert name == "rans_decode"
            continue
        t2, hrows, G = a[5], a[6], a[1].shape[0]
        tlog = parse_groups16(blob)[0][2]
        routed = j_dispatch(windows, t2, hrows, tlog, G, False, True,
                            alphabet == "u16x")
        assert (name == "rans_decode_w") == bool(routed[0])


def _encode_inputs(s):
    """The port's staged rans_encode inputs for one group of s."""
    _n, _f, batches = plan_encode16(s, 1 << 19, True)
    ((n_pad, big, tlog), items), = batches.items()
    fc, mg, srcw = stage_encode16_batch(items, n_pad, big)
    return fc, mg, srcw, n_pad // 2048, _round8(n_pad // 128 + 16), tlog


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_plain_encode_matches_jax_rans_encode_interpret(alphabet):
    """One interpret-mode JAX rans_encode and the port's on identical
    inputs: u16 tables (8 chunks, 12-bit fields) and u16x tables (32
    chunks, 14-bit fields).  The encoder's states pass 2^31."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_encode as j_encode

    fc, mg, srcw, t2, hcap, tlog = _encode_inputs(symbols(alphabet, 4096, 5))
    assert fc.shape[1] == (8 if alphabet == "u16" else 32)
    want = [np.asarray(a) for a in j_encode(
        jnp.asarray(fc), jnp.asarray(mg), jnp.asarray(srcw), t2, hcap, True,
        True, tlog, True)]
    ins = to_tensors("cpu", fc_tables=fc, magic_tables=mg, src_words=srcw)
    got = [a.numpy() for a in rk.rans_encode(*ins.values(), t2, hcap, True,
                                             tlog, True)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    cs = int(want[2][0])
    assert int(got[2][0]) == cs
    # the payload; JAX leaves the entries past csize unwritten
    assert np.array_equal(got[0].reshape(-1)[:cs], want[0].reshape(-1)[:cs])
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])
    assert (got[1].view(np.uint32) >= 1 << 31).any()
    assert rk.rans_encode(*ins.values(), t2, hcap, True, tlog, False)[3] is None


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_plain_decode_matches_jax_rans_decode_interpret(alphabet):
    """One interpret-mode JAX rans_decode (v1) and the port's on the same
    two ratio-mode groups, one of them corrupted: the clean group's output
    and err != 0 agree.  Decoding starts from states >= 2^31."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_decode as j_decode

    n = 4096 if alphabet == "u16" else 16384   # smaller u16x groups go raw
    s = symbols(alphabet, 2 * n, 7)
    groups = parse_groups16(j_twin16(s[:n], False) + j_twin16(s[n:], False))
    assert groups[0][2] == groups[1][2] and groups[0][8] is None
    assert (groups[0][6] >= 1 << 31).any()
    cs, tbl, init, hws, tots, t2, hrows = stage_decode16_batch(
        groups, [0, 1], n, groups[0][2], False, alphabet == "u16x")
    assert tots is None
    hws[1, 2, 9] ^= 0x10000                   # corrupt group 1
    big = alphabet == "u16x"
    j_out, j_err = j_decode(*(jnp.asarray(a) for a in (cs, tbl, init, hws)),
                            t2, hrows, True, True, groups[0][2], big)
    ins = to_tensors("cpu", csize_hw=cs, tables=tbl, init_states=init,
                     streams=hws)
    out, err = rk.rans_decode(*ins.values(), t2, hrows, True, groups[0][2], big)
    assert (np.asarray(j_err) != 0).tolist() == (err.numpy() != 0).tolist() \
        == [False, True]
    assert np.array_equal(out[0].numpy(), np.asarray(j_out)[0])
    assert np.array_equal(out[0].numpy().reshape(-1).view(np.uint16)[:n], s[:n])
