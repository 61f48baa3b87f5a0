"""The port's TurboRANS entry points against the JAX package (byte wire).

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
from finitestateentropy_tpu_torch.turbo.rans import (_HDR, FLAG_RAW, FLAG_RLE,
                                                     RANS_MAGIC,
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

        def spy(*a, _name=name, _entry=entry):
            calls.append((_name, a[5], a[6], a[1].shape[0]))
            return _entry(*a)
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


@pytest.mark.parametrize("kw", [dict(pair=-1, quad=0), dict(pair=1, quad=0),
                                dict(pair=0, quad=-1), dict(pair=0, quad=0, mesh=2),
                                dict(pair=0, quad=0, steptots=False),
                                dict(pair=0, quad=0, totals_only=True)])
def test_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        turbo_compress_device(b"abc" * 1000, device="cpu", **kw)


def test_unported_frames_raise():
    for flags in (32, 128):                      # FLAG_PAIR, FLAG_QUAD
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            decompress(_HDR.pack(RANS_MAGIC, 10, 0, 10, flags, 0) + b"\0" * 64)
    data = generate_proba(80, 20000)
    for kw in (dict(steptots=False), dict(totals_only=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            decompress(j_twin(data, **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        decompress(compress(data), mesh=2)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        turbo_compress_device(b"abc" * 100, pair=0, quad=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        turbo_decompress_device(compress(b"abc" * 100))
