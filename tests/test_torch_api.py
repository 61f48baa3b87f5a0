"""The port's TurboRANS entry points against the JAX package (byte wire,
ratio mode and the totals wire; tests/test_torch_pair_quad.py covers the
pair and quad speed wires, tests/test_torch_u16.py the U16 codec).

Frames from finitestateentropy_tpu_torch.turbo.api on the CPU (the plain
PyTorch versions of the kernels) must equal the JAX package's, byte for
byte, and each package must decode the other's frames.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu.turbo.api import \
    turbo_compress_device as j_compress_device
from finitestateentropy_tpu.turbo.rans import (rans_compress as j_twin,
                                               rans_decompress as j_untwin)
from finitestateentropy_tpu_torch.turbo.api import (DEFAULT_GROUP, MAX_GROUP,
                                                    split_groups,
                                                    turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.turbo.rans import (FLAG_RAW, FLAG_RLE,
                                                     parse_rans_group)
from finitestateentropy_tpu_torch.utils import generate_proba

CORPORA = {"p80": 80, "p14": 14, "p02": 2}


def compress(data, **kw):
    return turbo_compress_device(data, pair=0, quad=0, device="cpu", **kw)


def decompress(blob, **kw):
    return turbo_decompress_device(blob, device="cpu", **kw)


def _twin_groups(data, group):
    return b"".join(j_twin(data[i:i + group]) for i in range(0, len(data), group))


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("group", [40960, 131072])
def test_frames_equal_jax_twin(name, group):
    data = generate_proba(CORPORA[name], 3 * group + 12345)
    port = compress(data, group_size=group)
    assert port == _twin_groups(data, group)
    assert decompress(port) == data
    assert j_untwin(port[: len(j_twin(data[:group]))]) == data[:group]


def test_frames_equal_jax_device_interpret():
    data = generate_proba(80)[:40960]
    want = j_compress_device(data, group_size=40960, interpret=True,
                             pair=0, quad=0)
    assert compress(data, group_size=40960) == want


def test_multigroup_with_rle_and_raw_fallbacks():
    rng = np.random.default_rng(5)
    g = 16384
    data = (generate_proba(80, g) + b"R" * g
            + bytes(rng.integers(0, 256, g, dtype=np.uint8))
            + generate_proba(14, g) + generate_proba(80, 5000))
    port = compress(data, group_size=g)
    assert port == _twin_groups(data, g)
    flags, pos = [], 0
    while pos < len(port):
        grp, used = parse_rans_group(port[pos:])
        flags.append(grp[3])
        pos += used
    assert flags[1] == FLAG_RLE and flags[2] == FLAG_RAW
    assert decompress(port) == data


@pytest.mark.parametrize("windows", [0, 1, 8])
def test_decode_routing_matches_jax_dispatch(windows, monkeypatch):
    from finitestateentropy_tpu.turbo.api import _window_dispatch as j_dispatch
    from finitestateentropy_tpu_torch.turbo import api

    calls = []
    for name in ("rans_decode_v2", "rans_decode_w"):
        entry = getattr(api, name)

        def spy(*a, _name=name, _entry=entry, **kw):
            calls.append((_name, a[5], a[6], a[1].shape[0]))
            return _entry(*a, **kw)
        monkeypatch.setattr(api, name, spy)
    data = generate_proba(14, 8 * 131072)
    assert decompress(_twin_groups(data, 131072), windows=windows) == data
    assert len(calls) == 1
    name, t4, hrows, G = calls[0]
    assert (name == "rans_decode_w") == bool(
        j_dispatch(windows, t4, hrows, 10, G, False)[0])


def test_stage_seconds_cover_both_entry_points(monkeypatch):
    from finitestateentropy_tpu_torch.turbo import api

    monkeypatch.setattr(api, "stage_seconds", {})
    data = generate_proba(80, 2 * 40960) + b"R" * 40960
    assert decompress(compress(data, group_size=40960)) == data
    assert sorted(api.stage_seconds) == sorted(
        ["c_prep", "c_stage", "c_h2d", "c_kernel", "c_d2h", "c_frames",
         "d_parse", "d_stage", "d_h2d", "d_kernel", "d_d2h", "d_copy", "d_join"])
    assert min(api.stage_seconds.values()) >= 0


def test_native_decoder_reads_port_frames():
    from finitestateentropy_tpu import native

    if not native.available():
        pytest.skip("native/libturbofse.so not built here")
    data = generate_proba(80, 3 * 65536 + 999)
    port = compress(data, group_size=65536)
    assert native.rans_decompress_native(port) == data


def test_flipped_payload_byte_raises():
    data = generate_proba(80)[:40960]
    dev = bytearray(compress(data, group_size=40960))
    dev[len(dev) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        decompress(bytes(dev))


def test_group_size_and_table_log_rules():
    with pytest.raises(ValueError, match="exceeds"):
        compress(b"ab" * 100, group_size=MAX_GROUP + DEFAULT_GROUP)
    with pytest.raises(ValueError, match="multiple of 1 MiB"):
        compress(b"ab" * 100, group_size=DEFAULT_GROUP + 4096)
    for tlog in (4, 13):
        with pytest.raises(ValueError, match="tableLog"):
            compress(b"ab" * 100, table_log=tlog)
    assert compress(b"") == j_twin(b"")
    assert decompress(compress(b"")) == b""


def test_ragged_multi_mib_tail_split():
    mib = DEFAULT_GROUP
    src = np.zeros(2 * mib + mib + 5000, np.uint8)
    assert [len(c) for c in split_groups(src, 2 * mib)] == [2 * mib, mib, 5000]
    src = np.zeros(4 * mib + 2 * mib, np.uint8)   # padded tail aligned: kept
    assert [len(c) for c in split_groups(src, 4 * mib)] == [4 * mib, 2 * mib]
    data = generate_proba(80, 2 * mib + mib + 5000)
    port = compress(data, group_size=2 * mib)
    assert port == (j_twin(data[: 2 * mib]) + j_twin(data[2 * mib: 3 * mib])
                    + j_twin(data[3 * mib:]))
    assert decompress(port) == data


def _mode_twin(data, kw):
    """The JAX twin frame of data at turbo_compress_device flags kw (one
    group): ratio mode keeps an explicit pair=1 and drops the auto pick."""
    if kw.get("pair") == 1 and not kw.get("steptots", True):
        from finitestateentropy_tpu.turbo.pair import pair_compress as j_pair_twin

        blob = j_pair_twin(data, steptots=False)
        if blob is not None:
            return blob
    return j_twin(data, steptots=kw.get("steptots", True),
                  totals_only=kw.get("totals_only", False))


@pytest.mark.parametrize("kw", [dict(pair=0, quad=0, mesh=2),
                                dict(pair=0, quad=0, steptots=False),
                                dict(pair=0, quad=0, totals_only=True),
                                dict(mesh=2), dict(steptots=False),
                                dict(totals_only=True),
                                dict(pair=1, steptots=False)])
def test_unported_modes_raise(kw):
    """The modes that the first slices left unported: ratio mode and the
    totals wire write the JAX twin's frames; mesh > 1 (on a CPU mesh here)
    writes the single-device frames and decodes them back."""
    data = b"abc" * 1000
    if kw.get("mesh"):
        one = turbo_compress_device(data, device="cpu",
                                    **{k: v for k, v in kw.items() if k != "mesh"})
        port = turbo_compress_device(data, device="cpu", **kw)
        assert port == one
        assert decompress(port, mesh=kw["mesh"]) == data
        return
    port = turbo_compress_device(data, device="cpu", **kw)
    assert port == _mode_twin(data, kw)
    assert decompress(port) == data


def test_unported_frames_raise():
    """v1 (ratio mode, byte and pair) and FLAG_TOTALS frames, which the
    first slices refused, decode; so do frames decoded over a mesh."""
    from finitestateentropy_tpu.turbo.pair import pair_compress as j_pair_twin

    data = generate_proba(80, 20000)
    for blob in (j_twin(data, steptots=False), j_twin(data, totals_only=True),
                 j_pair_twin(data, steptots=False)):     # v1 pair frame
        assert decompress(blob) == data
        assert decompress(blob, mesh=2) == data
    assert decompress(compress(data), mesh=2) == data


MODES = {"ratio": dict(steptots=False), "totals": dict(totals_only=True),
         "ratio_pair": dict(pair=1, steptots=False)}


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_frames_equal_jax_twin(mode, name):
    """Ratio mode (tableLog 11, no section), the totals wire and v1 pair
    frames equal the JAX twins group for group; the JAX twin decodes the
    port's frames and the port decodes the twin's."""
    kw, group = MODES[mode], 40960
    data = generate_proba(CORPORA[name], 3 * group + 12345)
    port = turbo_compress_device(data, group, device="cpu", **kw)
    twins = [_mode_twin(data[i:i + group], kw) for i in range(0, len(data), group)]
    assert port == b"".join(twins)
    assert decompress(port) == data
    pos = 0
    for i, twin in enumerate(twins):
        assert j_untwin(port[pos:pos + len(twin)]) == data[i * group:(i + 1) * group]
        pos += len(twin)
    if name == "p80":
        g = parse_rans_group(port)[0]
        assert g[2] == (11 if mode == "ratio" else 9 if mode == "ratio_pair" else 10)
        assert (g[8] is None) == (mode != "totals")


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_frames_equal_jax_device_interpret(mode):
    data = generate_proba(80)[:40960]
    want = j_compress_device(data, group_size=40960, interpret=True,
                             **MODES[mode])
    assert turbo_compress_device(data, 40960, device="cpu", **MODES[mode]) == want
    assert decompress(want) == data


@pytest.mark.parametrize("mode", ["ratio", "totals"])
def test_native_reads_port_mode_frames(mode):
    from finitestateentropy_tpu import native

    if not native.available():
        pytest.skip("native/libturbofse.so not built here")
    data = generate_proba(80, 3 * 65536 + 999)
    port = turbo_compress_device(data, 65536, device="cpu", **MODES[mode])
    assert native.rans_decompress_native(port) == data
    if mode == "ratio":        # the native encoder writes ratio-mode frames
        blob = native.rans_compress_native(data, 65536)
        assert blob == port
        assert decompress(blob) == data


@pytest.mark.parametrize("mode", list(MODES))
def test_flipped_payload_byte_raises_in_mode(mode):
    """A totals frame cannot show a per-row mismatch, so the flip is in the
    payload: the final states (and, on v1, the end cursor) catch it."""
    data = generate_proba(80)[:40960]
    dev = bytearray(turbo_compress_device(data, 40960, device="cpu",
                                          **MODES[mode]))
    dev[len(dev) - 100] ^= 0xFF
    with pytest.raises(ValueError):
        decompress(bytes(dev))


@pytest.mark.parametrize("windows", [0, 1, 8])
@pytest.mark.parametrize("mode", ["ratio", "totals", "totals_small"])
def test_mode_routing_matches_jax_dispatch(mode, windows, monkeypatch):
    """v1 batches go to rans_decode; totals batches to the entry the JAX
    dispatch picks with totals_only=True (8 groups of 128 KiB: windowed at
    windows=0; 3 groups: resident)."""
    from finitestateentropy_tpu.turbo.api import _window_dispatch as j_dispatch
    from finitestateentropy_tpu_torch.turbo import api

    calls = []
    for name in ("rans_decode", "rans_decode_v2", "rans_decode_w"):
        entry = getattr(api, name)

        def spy(*a, _name=name, _entry=entry, **kw):
            calls.append((_name, a[1].shape[0], a))
            return _entry(*a, **kw)
        monkeypatch.setattr(api, name, spy)
    n = 3 if mode == "totals_small" else 8
    data = generate_proba(14, n * 131072)
    kw = MODES["ratio" if mode == "ratio" else "totals"]
    blob = b"".join(j_twin(data[i:i + 131072], **kw)
                    for i in range(0, len(data), 131072))
    assert decompress(blob, windows=windows) == data
    assert len(calls) == 1
    name, G, a = calls[0]
    if mode == "ratio":
        assert name == "rans_decode"
        return
    assert a[4].dim() == 2              # [G, T] step totals
    routed = j_dispatch(windows, a[5], a[6], 10, G, True)
    assert (name == "rans_decode_w") == bool(routed[0])
    if windows == 0:
        assert name == ("rans_decode_v2" if n == 3 else "rans_decode_w")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for kw in (dict(pair=0, quad=0), {}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            turbo_compress_device(b"abc" * 100, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        turbo_decompress_device(compress(b"abc" * 100))
