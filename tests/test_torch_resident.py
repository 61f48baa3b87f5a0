"""The device-resident entries (turbo/device_api.py): frames, decode and
the round trips.

The resident frames are held byte-equal to two JAX-free references, the
port's host-prep path turbo_compress_device(d, pair=0, quad=0) and the
numpy twin rans_compress, which the other tests hold equal to the JAX
package; and once, on one 16 KiB group, to the JAX package's
rans_compress_resident itself (its Pallas encode runs interpreted, about
10 s a call on the CPU).  Each package decodes the other's resident
frames.  The JAX package is imported inside the tests that use it, so
the tests marked ``gpu`` also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (DEFAULT_GROUP,
                                                    split_groups,
                                                    turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.turbo.device_api import (
    _resident_batches, _resident_compress, _resident_mixed_rt,
    rans_compress_resident, rans_decompress_resident, rans_resident_roundtrip)
from finitestateentropy_tpu_torch.turbo.format import _pad_n
from finitestateentropy_tpu_torch.turbo.rans import rans_compress
from finitestateentropy_tpu_torch.utils import generate_proba

MODES = {"speed": {}, "totals": {"totals_only": True},
         "ratio": {"steptots": False}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tensor(data: bytes, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)


def _twin(data: bytes, group: int, **kw) -> bytes:
    return b"".join(rans_compress(ch.tobytes(), **kw)
                    for ch in split_groups(np.frombuffer(data, np.uint8), group))


def _check(data: bytes, group: int, device="cpu", twin=True, **kw) -> bytes:
    """The resident frames equal the host-prep path's byte-wire frames (and
    the twin's), and decode back to data on the device."""
    blob = rans_compress_resident(_tensor(data, device), group, **kw)
    assert blob == turbo_compress_device(data, group, pair=0, quad=0,
                                         device="cpu", **kw)
    if twin:
        assert blob == _twin(data, group, **kw)
    out = rans_decompress_resident(blob, device=device)
    assert out.dtype == torch.uint8 and out.device.type == torch.device(device).type
    assert out.cpu().numpy().tobytes() == data
    return blob


@pytest.mark.parametrize("mode", list(MODES))
def test_resident_frames_equal_host_path_and_twin(mode):
    # a ragged 20000-byte tail: big enough that the twin keeps tableLog 11
    # in ratio mode (it shrinks small groups' tables; the entries do not)
    _check(generate_proba(80)[: 3 * 65536 + 20000], 65536, **MODES[mode])


def test_resident_matches_jax_resident_both_ways():
    """One 16 KiB group: the JAX package's resident compress writes the
    same frame, and each package's resident decode reads the other's."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.device_api import (
        rans_compress_resident as j_compress,
        rans_decompress_resident as j_decompress)

    data = generate_proba(80)[:16384]
    blob = rans_compress_resident(_tensor(data), 16384)
    j_blob = j_compress(jnp.asarray(np.frombuffer(data, np.uint8)),
                        group_size=16384)
    assert blob == j_blob
    assert np.asarray(j_decompress(blob)).tobytes() == data
    assert rans_decompress_resident(j_blob, device="cpu").numpy().tobytes() == data


def test_resident_fallback_groups():
    """RLE, raw and small coded groups; the host decoder reads them too."""
    rng = np.random.default_rng(9)
    data = (b"Z" * 9000 + bytes(rng.integers(0, 256, 12000, np.uint8))
            + generate_proba(14)[:5000])
    blob = _check(data, 9000, twin=False)
    assert turbo_decompress_device(blob, device="cpu") == data


def test_resident_incompressible_coded_group_goes_raw():
    """A group that codes (maxCount > n >> 7) but whose frame would not be
    smaller than the group is written raw, as the host path does."""
    rng = np.random.default_rng(4)
    data = bytes(rng.integers(0, 200, 3000, np.uint8)) + b"\x07" * 40
    blob = _check(data, 4096, twin=False)
    assert blob[13] & 1                         # FLAG_RAW


def test_resident_ragged_tail_and_multi_mib_split():
    """A mid-size ragged tail encodes at its own padded size; a multi-MiB
    tail whose padded size breaks the 1 MiB rule splits at its last 1 MiB
    boundary, as api.split_groups cuts it."""
    _check(generate_proba(80)[: 65536 + 20000], 65536)
    for n, group in ((5 << 20, 2 << 20), ((3 << 20) + 300, 2 << 20),
                     (4 << 20, 4 << 20), (1000, 2 << 20), (9000, 4096)):
        count, batches = _resident_batches(n, group)
        spans = sorted((gi, st, ln) for items in batches.values()
                       for gi, st, ln in items)
        cuts = split_groups(np.zeros(n, np.uint8), group)
        assert count == len(cuts) == len(spans)
        assert [ln for _, _, ln in spans] == [len(c) for c in cuts]
        assert all(n_pad == _pad_n(ln) for n_pad, items in batches.items()
                   for _, _, ln in items)
    data = generate_proba(14, (2 << 20) + (1 << 20) + 300)
    _check(data, 2 << 20, twin=False)


def test_resident_empty_and_group_rules():
    blob = rans_compress_resident(torch.zeros(0, dtype=torch.uint8))
    assert blob == turbo_compress_device(b"", device="cpu")
    assert rans_decompress_resident(blob, device="cpu").shape == (0,)
    x = _tensor(b"tiny")
    _check(b"tiny", 2 << 20)                            # multi-MiB group, tiny input
    with pytest.raises(ValueError, match="budget"):
        rans_compress_resident(x, group_size=5 << 20)
    with pytest.raises(ValueError, match="multiple of 1 MiB"):
        rans_compress_resident(x, group_size=3 << 19)
    with pytest.raises(ValueError, match="tableLog"):
        rans_compress_resident(x, table_log=13)
    with pytest.raises(ValueError, match="1-D"):
        rans_compress_resident(x.view(2, 2))


def _tie_data() -> bytes:
    """Two bytes, a and b, tie for the top count (1500 each) among 1000
    bytes below 40, shuffled; 4000 bytes, so the group pads."""
    rng = np.random.default_rng(1)
    body = np.concatenate([np.full(1500, ord("b"), np.uint8),
                           np.full(1500, ord("a"), np.uint8),
                           rng.integers(0, 40, 1000, np.uint8)])
    return bytes(body[rng.permutation(len(body))])


def _check_tie(device="cpu"):
    """The tied group pads with the first maximum (as the host path's
    argmax), so its final states and frame match."""
    data = _tie_data()
    xp = _tensor(data, device).view(1, -1)
    lens = torch.tensor([len(data)], dtype=torch.int32, device=device)
    mfs = _resident_compress(xp, lens, _pad_n(len(data)), 10, True)[7]
    assert int(mfs[0]) == ord("a")
    _check(data, 8192, device)


def test_resident_first_maximum_pads_and_tables():
    _check_tie()


@pytest.mark.parametrize("group", [65536, 131072])
def test_resident_roundtrip_on_device(group):
    """Compress, decode and verify in device memory: 64 KiB groups decode
    through rans_decode_v2, 128 KiB ones (t4 = 32) through rans_decode_w."""
    data = generate_proba(80)[: 2 * group]
    ok, total_cs, nbytes = rans_resident_roundtrip(_tensor(data), group)
    assert ok and nbytes == len(data)
    frames = rans_compress_resident(_tensor(data), group)
    assert total_cs == sum(int.from_bytes(frames[o + 8:o + 12], "little")
                           for o in _frame_offsets(frames))
    with pytest.raises(ValueError, match="group_size"):
        rans_resident_roundtrip(_tensor(data[:-1]), group)
    bad = bytearray(data)
    bad[group: group + 4096] = b"Q" * 4096            # still coded, other stats
    ok2, _cs, _n = rans_resident_roundtrip(_tensor(bytes(bad)), group)
    assert ok2


def _frame_offsets(blob: bytes) -> list[int]:
    from finitestateentropy_tpu_torch.turbo.rans import parse_rans_group

    out, pos = [], 0
    while pos < len(blob):
        out.append(pos)
        pos += parse_rans_group(blob[pos:])[1]
    return out


def _mixed(section: int) -> bytes:
    """Groups of pure kinds by i % 4, as the JAX bench's mixed corpus:
    Proba80, Proba14, random, RLE."""
    rng = np.random.default_rng(1)
    b80, b14 = generate_proba(80), generate_proba(14)
    parts = []
    for i in range(8):
        k = i % 4
        if k in (0, 1):
            base = b80[i * 7919 % 4096:] if k == 0 else b14[i * 104729 % 4096:]
            parts.append((base * (section // len(base) + 2))[:section])
        elif k == 2:
            parts.append(bytes(rng.integers(0, 256, section, dtype=np.uint8)))
        else:
            parts.append(bytes([i & 0xFF]) * section)
    return b"".join(parts)


def test_resident_mixed_roundtrip():
    section = 16384
    x = _tensor(_mixed(section))
    G = x.shape[0] // section
    lens = torch.full((G,), section, dtype=torch.int32)
    flags = _resident_compress(x.view(G, section), lens, section, 10, True)[6]
    assert flags.tolist() == [0, 0, 4, 1] * 2
    coded = tuple(int(i) for i in np.flatnonzero(flags.numpy() == 0))
    ok, cs = _resident_mixed_rt(x, section, 10, coded)
    assert bool(ok)
    frames = rans_compress_resident(x, section)
    assert int(cs) == sum(int.from_bytes(frames[o + 8:o + 12], "little")
                          for o in _frame_offsets(frames))


def test_resident_decode_refuses_pair_quad_and_corrupt_groups():
    data = generate_proba(80)[:65536]
    multibyte = turbo_compress_device(data, 65536, device="cpu")  # quad or pair
    with pytest.raises(ValueError, match="FLAG_PAIR / FLAG_QUAD"):
        rans_decompress_resident(multibyte, device="cpu")
    for mode in MODES.values():
        blob = bytearray(rans_compress_resident(_tensor(data), 65536, **mode))
        blob[-100] ^= 0x10
        with pytest.raises(ValueError, match="corrupt"):
            rans_decompress_resident(bytes(blob), device="cpu")


def test_resident_decode_defaults_to_cuda():
    blob = rans_compress_resident(_tensor(b"abc" * 1000))
    if torch.cuda.is_available():
        assert rans_decompress_resident(blob).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rans_decompress_resident(blob)


def test_resident_counts_no_launch_on_cpu():
    rk.reset_launches()
    blob = rans_compress_resident(_tensor(generate_proba(80)[:40960]), 40960)
    rans_decompress_resident(blob, device="cpu")
    assert not any(rk.launches.values())


def test_resident_entries_follow_jax_order():
    """The resident entries name their parameters as the JAX package's, in
    its order and with its defaults; the decode adds device last.  The
    JAX package's lazy names resolve in the port's turbo package too."""
    import inspect

    from finitestateentropy_tpu.turbo import device_api as j_api

    import finitestateentropy_tpu_torch.turbo as turbo
    from finitestateentropy_tpu_torch.turbo import device_api as api

    for name, extra in (("rans_compress_resident", []),
                        ("rans_decompress_resident", ["device"]),
                        ("rans_resident_roundtrip", [])):
        port = inspect.signature(getattr(api, name)).parameters
        jax = inspect.signature(getattr(j_api, name)).parameters
        assert list(port) == list(jax) + extra
        assert all(port[k].default == jax[k].default for k in jax if k != "x")
    for name in ("rans_compress_resident", "rans_decompress_resident"):
        assert getattr(turbo, name) is getattr(api, name)


def test_resident_interpret_runs_plain_and_launch_failures_raise(monkeypatch):
    """Inputs the wrappers take for a card's: interpret=True runs the plain
    versions there (no launch counted), and a failing launch raises: no
    path gives way to a plain version on its own."""
    def refuse(*_a, **_k):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(rk, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(rk, "_launch", refuse)
    rk.reset_launches()
    data = generate_proba(80)[:2 * 8192 + 500]
    x = _tensor(data)
    blob = rans_compress_resident(x, 8192, interpret=True)
    assert blob == _twin(data, 8192)
    assert rans_decompress_resident(blob, True, "cpu").numpy().tobytes() == data
    assert rans_resident_roundtrip(x[:16384], 8192, interpret=True)[0]
    assert not any(rk.launches.values())
    with pytest.raises(RuntimeError, match="launch refused"):
        rans_compress_resident(x, 8192)
    with pytest.raises(RuntimeError, match="launch refused"):
        rans_decompress_resident(blob, device="cpu")
    with pytest.raises(RuntimeError, match="launch refused"):
        rans_resident_roundtrip(x[:16384], 8192)


# ---------------------------------------------------------------------------
# on the GPU
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_resident_frames_equal_host_path(cuda, mode):
    kw = MODES[mode]
    data = generate_proba(80, 3 * DEFAULT_GROUP + 20000)
    rk.reset_launches()
    blob = _check(data, DEFAULT_GROUP, cuda, **kw)
    want = {"speed": "rans_decode_v2:byte", "totals": "rans_decode_v2:totals",
            "ratio": "rans_decode:byte"}[mode]
    assert {k: v for k, v in rk.launches.items() if v} == {
        "rans_encode2:byte": 2, want: 2}          # two padded sizes
    assert rans_compress_resident(_tensor(data, cuda), DEFAULT_GROUP,
                                  interpret=True, **kw) == blob


@pytest.mark.gpu
def test_cuda_resident_fallbacks_tlog12_and_ties(cuda):
    """RLE and raw rows share the coded rows' encode launch with a delta
    table (at tableLog 12 its freq overflows the 12-bit field)."""
    rng = np.random.default_rng(9)
    data = (b"Z" * 9000 + bytes(rng.integers(0, 256, 12000, np.uint8))
            + generate_proba(14)[:5000])
    for tl in (9, 10, 12):
        _check(data, 9000, cuda, twin=False, table_log=tl)
    _check_tie(cuda)


@pytest.mark.gpu
def test_cuda_resident_roundtrips(cuda):
    data = generate_proba(80, 4 * DEFAULT_GROUP)
    ok, cs, n = rans_resident_roundtrip(_tensor(data, cuda), DEFAULT_GROUP)
    frames = rans_compress_resident(_tensor(data), DEFAULT_GROUP)
    assert ok and n == len(data)
    assert cs == sum(int.from_bytes(frames[o + 8:o + 12], "little")
                     for o in _frame_offsets(frames))
    section = 1 << 20
    x = _tensor(_mixed(section), cuda)
    flags = _resident_compress(x.view(8, section),
                               torch.full((8,), section, dtype=torch.int32,
                                          device=cuda), section, 10, True)[6]
    coded = tuple(int(i) for i in np.flatnonzero(flags.cpu().numpy() == 0))
    assert len(coded) == 4
    ok, _cs = _resident_mixed_rt(x, section, 10, coded)
    assert bool(ok)
