"""The port's default-flag TurboRANS path against the JAX package: the pair
and quad wires, the auto wire pick, and the pair / quad modes of the
encode and decode kernels (their plain PyTorch versions, on the CPU).

Frames from finitestateentropy_tpu_torch.turbo.api with default flags must
equal, group for group, the JAX twin of the wire that the JAX package's
_pick_wire chooses; each package and the native C decoder must read the
other's frames.  Tolerance is 0 throughout: the codec is integer and
bit-exact.
"""
import numpy as np
import pytest

import finitestateentropy_tpu.turbo.api as j_api
from finitestateentropy_tpu.turbo.pair import (pair_compress as j_pair_twin,
                                               prep_pair_group as j_prep_pair)
from finitestateentropy_tpu.turbo.quad import (quad_compress as j_quad_twin,
                                               prep_quad_group as j_prep_quad)
from finitestateentropy_tpu.turbo.rans import (rans_compress as j_twin,
                                               rans_decompress as j_untwin)
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (
    _wire_pad, parse_groups, plan_decode, stage_decode_batch,
    turbo_compress_device, turbo_decompress_device)
from finitestateentropy_tpu_torch.turbo.rans import FLAG_PAIR, FLAG_QUAD
from finitestateentropy_tpu_torch.turbo.state import to_tensors
from finitestateentropy_tpu_torch.utils import generate_proba


def compress(data, **kw):
    return turbo_compress_device(data, device="cpu", **kw)


def decompress(blob, **kw):
    return turbo_decompress_device(blob, device="cpu", **kw)


def _pair_escape_corpus(n, seed=3):
    """8 hot pairs salted with 400 rare ones: the pair alphabet passes 256
    with under 2% escaping, the quad alphabet escapes more than 1% (so
    the quad wire is not eligible and the pick lands on pair, escapes
    included)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, n // 2, dtype=np.uint16) * 257
    hot[rng.choice(n // 2, size=400, replace=False)] = \
        (np.arange(400) * 7 + 300).astype(np.uint16)
    return hot.astype("<u2").tobytes()[:n]


def _quad_escape_corpus(n, seed=13):
    """8 hot quads salted with 260 rare ones: over 256 quad ids with under
    1% escaping (tests/test_quad.py's corpus)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, n // 4, dtype=np.uint32) * 0x01010101
    hot[rng.choice(n // 4, size=260, replace=False)] = \
        (np.arange(260) * 9719 + 77).astype(np.uint32)
    return hot.astype("<u4").tobytes()[:n]


def _mixed():
    """chip_smoke.py's mixed input: at 9000-byte groups it is coded pair,
    pair, quad @ 9 (T = 3, odd), then three byte groups (the second falls
    back to raw after its encode, the third is 1000 bytes)."""
    rng = np.random.default_rng(5)
    return (generate_proba(80)[:20000] + b"R" * 9000
            + bytes(rng.integers(0, 256, 12000, dtype=np.uint8))
            + generate_proba(14)[:5000])


# name -> (data, group size, the wires JAX picks)
CASES = {
    "p80": (lambda: generate_proba(80, 1 << 20), 1 << 20, ["quad"]),
    "p90": (lambda: generate_proba(90, 3 << 16), 1 << 16, ["quad"] * 3),
    "p14": (lambda: generate_proba(14, 1 << 17), 1 << 16, ["byte"] * 2),
    "p02": (lambda: generate_proba(2, 1 << 17), 1 << 16, ["byte"] * 2),
    "pair_escapes": (lambda: _pair_escape_corpus(1 << 16), 1 << 16, ["pair"]),
    "quad_escapes": (lambda: _quad_escape_corpus(1 << 16), 1 << 16, ["quad"]),
    "mixed_9000": (_mixed, 9000,
                   ["pair", "pair", "quad", "byte", "byte", "byte"]),
}


def _jax_pick_frames(data, group):
    """The JAX package's frames for default flags, from its own pick and
    its numpy twins: [(wire, frame)] per group."""
    out = []
    for i in range(0, len(data), group):
        ch = np.frombuffer(data[i:i + group], np.uint8)
        prep = j_api._prep_group(ch, 10)
        if prep is None:
            out.append(("raw", j_twin(ch.tobytes())))
            continue
        wire = j_api._pick_wire(ch, prep, 10, j_prep_pair(ch), j_prep_quad(ch),
                                -1, -1)
        twin = {"quad": j_quad_twin, "pair": j_pair_twin, "byte": j_twin}[wire]
        frame = twin(ch.tobytes())
        out.append((wire, j_twin(ch.tobytes()) if frame is None else frame))
    return out


def _frames(blob):
    from finitestateentropy_tpu_torch.turbo.rans import parse_rans_group

    out, pos = [], 0
    while pos < len(blob):
        _g, used = parse_rans_group(blob[pos:])
        out.append(blob[pos:pos + used])
        pos += used
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_default_frames_equal_jax_pick(name):
    make, group, wires = CASES[name]
    data = make()
    want = _jax_pick_frames(data, group)
    assert [w for w, _f in want] == wires
    port = compress(data, group_size=group)
    assert _frames(port) == [f for _w, f in want]
    assert decompress(port) == data
    assert b"".join(j_untwin(f) for f in _frames(port)) == data


def test_p80_main_path_is_quad_with_escapes():
    """The main path's groups (1 MiB of Proba80) are quad @ 10 with an
    escape section; quad=0 gives pair @ 9."""
    data = generate_proba(80, 1 << 20)
    g = parse_groups(compress(data))[0]
    assert len(g) == 11 and g[3] & FLAG_QUAD and g[2] == 10
    assert g[10] is not None and len(g[10][0]) > 0
    g = parse_groups(compress(data, quad=0))[0]
    assert len(g) == 11 and g[3] & FLAG_PAIR and g[2] == 9


@pytest.mark.parametrize("wire,kw,data", [
    ("quad", {}, lambda: generate_proba(90, 1 << 16)),
    ("pair", {"quad": 0}, lambda: generate_proba(80, 1 << 15))])
def test_frames_and_encode_equal_jax_interpret(wire, kw, data, monkeypatch):
    """One interpret-mode JAX compress per wire: the port's frames equal
    it, and the port's plain encode equals the JAX rans_encode2 call it
    made, on that call's inputs.  Each package decodes the other's
    frames."""
    data = data()
    calls = []
    j_encode2 = j_api.rans_encode2

    def spy(*a):
        out = j_encode2(*a)
        calls.append(([np.array(x) for x in a[:3]], a[3:],
                      [np.array(x) for x in out]))
        return out
    monkeypatch.setattr(j_api, "rans_encode2", spy)
    want = j_api.turbo_compress_device(data, group_size=len(data),
                                       interpret=True, **kw)
    port = compress(data, group_size=len(data), **kw)
    assert port == want
    g = parse_groups(port)[0]
    assert len(g) == 11 and g[3] & (FLAG_QUAD if wire == "quad" else FLAG_PAIR)
    assert decompress(want) == data and j_untwin(port) == data

    (ins, (t4, hcap, _interp, u16, tlog, *rest), j_out), = calls
    # rest: steptots, force_chunk, rowloc[, quad]
    assert u16 == (wire == "pair") and rest[2]
    assert (len(rest) == 4 and rest[3]) == (wire == "quad")
    t = to_tensors("cpu", fc_tables=ins[0], magic_tables=ins[1],
                   src_words=ins[2])
    got = [a.numpy() for a in rk.rans_encode2(
        t["fc_tables"], t["magic_tables"], t["src_words"], t4, hcap, tlog,
        u16=u16, quad=wire == "quad")]
    assert [a.shape for a in got] == [a.shape for a in j_out]
    cs = int(j_out[2][0])
    assert int(got[2][0]) == cs
    # the payload; JAX leaves the words past csize unwritten
    hw = [a.reshape(-1).view(np.uint16)[:cs] for a in (got[0], j_out[0])]
    assert np.array_equal(*hw)
    assert np.array_equal(got[1], j_out[1])
    assert np.array_equal(got[3], j_out[3])


@pytest.mark.parametrize("wire", ["pair", "quad"])
def test_plain_decode_w_equals_jax_interpret(wire):
    """One interpret-mode JAX rans_decode_w per mode and the port's entry
    on identical inputs (a clean group and a corrupt one), at the
    smallest windowed shape: 256 KiB pair groups (S = 64), 512 KiB quad
    groups (S = 128)."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_decode_w as j_w

    n, S, twin = ((1 << 18, 64, j_pair_twin) if wire == "pair"
                  else (1 << 19, 128, j_quad_twin))
    datas = [generate_proba(80, n), generate_proba(90, n)]
    groups = [parse_groups(twin(d))[0] for d in datas]
    assert all(len(g) == 11 for g in groups)
    cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
        groups, [0, 1], _wire_pad(wire, n), groups[0][2], wire)
    assert groups[1][2] == groups[0][2] and t4 % S == 0
    hws[1, 2, 9] ^= 0x10000                      # corrupt group 1
    arrays = dict(csize_hw=cs, tables=tbl, init_states=init, streams=hws,
                  steptots=tots)
    modes = dict(u16=wire == "pair", pair=wire == "pair", quad=wire == "quad")
    j_out, j_err = j_w(*(jnp.asarray(a) for a in arrays.values()), t4, hrows,
                       1, groups[0][2], S, True, modes["u16"], False,
                       modes["pair"], modes["quad"])
    t = to_tensors("cpu", **arrays)
    out, err = rk.rans_decode_w(*t.values(), t4, hrows, 1, groups[0][2], S,
                                **modes)
    assert (np.asarray(j_err) != 0).tolist() == (err.numpy() != 0).tolist() \
        == [False, True]
    assert np.array_equal(out[0].numpy(), np.asarray(j_out)[0])
    from finitestateentropy_tpu_torch.turbo.api import _group_bytes
    assert _group_bytes(wire, groups[0], out[0].numpy()) == datas[0]


def test_native_decoder_reads_port_frames():
    from finitestateentropy_tpu import native

    if not native.available():
        pytest.skip("native/libturbofse.so not built here")
    data = (generate_proba(80, 1 << 16) + _quad_escape_corpus(1 << 16)
            + _pair_escape_corpus(1 << 16) + generate_proba(14, 1 << 16)
            + _mixed())
    port = compress(data, group_size=1 << 16)
    wires = {g[3] & (FLAG_PAIR | FLAG_QUAD) for g in parse_groups(port)}
    assert wires == {0, FLAG_PAIR, FLAG_QUAD}
    assert native.rans_decompress_native(port) == data
    port = compress(_mixed(), group_size=9000)
    assert native.rans_decompress_native(port) == _mixed()


@pytest.mark.parametrize("tlog", [9, 11, 12])
def test_quad_table_logs(tlog):
    """tlog 12 makes the largest LUT-mode decode table: 4096 + 256 words
    (it needs 2^15 quads or more: the optimal-tableLog rule caps smaller
    groups lower)."""
    data = generate_proba(90, 1 << 18)
    port = compress(data, group_size=1 << 18, quad=1, quad_table_log=tlog)
    assert port == j_quad_twin(data, table_log=tlog)
    g = parse_groups(port)[0]
    assert g[2] == tlog and g[3] & FLAG_QUAD
    assert decompress(port) == data


@pytest.mark.parametrize("tlog", [11, 12])
def test_pair_table_logs(tlog):
    data = generate_proba(80, 1 << 16)
    port = compress(data, group_size=1 << 16, pair=1, quad=0,
                    pair_table_log=tlog)
    assert port == j_pair_twin(data, table_log=tlog)
    assert parse_groups(port)[0][2] == tlog
    assert decompress(port) == data


@pytest.mark.parametrize("n", [9000, 12000, 20000])
def test_quad_odd_step_counts(n):
    """Quad groups pad to 1024 ids, so 9000 and 12000 bytes are T = 3
    steps and 20000 bytes T = 5: the rows4 section and the kernels run an
    odd step count."""
    data = generate_proba(80, 1 << 16)[:n]
    port = compress(data, group_size=n, quad=1)
    assert port == j_quad_twin(data)
    g = parse_groups(port)[0]
    assert g[3] & FLAG_QUAD and g[8].shape[0] % 2 == 1
    _pieces, batches = plan_decode([g])
    assert list(batches) == [("quad", _wire_pad("quad", n), g[2], 2)]
    assert decompress(port) == data


@pytest.mark.parametrize("kw", [{}, {"quad": 0}])
def test_flipped_payload_byte_raises(kw):
    data = generate_proba(80, 1 << 16)
    blob = bytearray(compress(data, group_size=1 << 16, **kw))
    assert parse_groups(bytes(blob))[0][3] & (FLAG_QUAD | FLAG_PAIR)
    blob[-7] ^= 0x40
    with pytest.raises(ValueError):
        decompress(bytes(blob))


def test_encode_batches_key_wire_pad_and_table_log():
    """Groups batch by (wire, padded size, tableLog), so a quad group whose
    tableLog the optimal-tableLog rule lowered gets its own launch."""
    from finitestateentropy_tpu_torch.turbo.api import plan_encode

    data = _mixed()
    _n, frames, batches = plan_encode(data, 9000, 10)
    assert frames == {}
    keys = {k: [gi for gi, _ch, _p in v] for k, v in batches.items()}
    assert keys == {("pair", 6144, 9): [0, 1], ("quad", 3072, 9): [2],
                    ("byte", 12288, 10): [3, 4], ("byte", 4096, 10): [5]}
