"""The port's compat codecs (models/) through the frame layer (io/frame.py)
against the JAX package's device codecs and the host twins.

On ``device="cpu"`` (the kernels' plain versions) each frame equals the
JAX device codec's frame and the JAX host twin's
(``fio.compress_bytes(..., compressor=None)``), bit for bit: FSE, Huff0
with the x1 and x2 decoders, and AutoTpuCodec, on Proba80 / Proba14 /
Proba2, a mixed corpus of raw, RLE and compressed blocks, and a ragged
tail.  Each package decodes the other's frames and the twin's; a flipped
payload byte raises CorruptionError on both sides.  Blocks are 4 KiB
(block_size_id 2), as tests/test_device_codecs.py has them.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu.io import frame as j_fio
from finitestateentropy_tpu.models import AutoTpuCodec as JAuto
from finitestateentropy_tpu.models.fse_codec import FseTpuCodec as JFse
from finitestateentropy_tpu.models.huf_codec import HufTpuCodec as JHuf
from finitestateentropy_tpu_torch.errors import CorruptionError
from finitestateentropy_tpu_torch.io import frame as fio
from finitestateentropy_tpu_torch.models import (AutoTpuCodec, FseTpuCodec,
                                                 HufTpuCodec, get_batch_codec)
from finitestateentropy_tpu_torch.utils import generate_proba

BS = 4096
BID = 2


def _mixed() -> bytes:
    """Raw, RLE and compressed blocks, and a ragged compressed tail."""
    rng = np.random.default_rng(3)
    return (generate_proba(80)[:BS] + b"\x55" * BS
            + rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
            + generate_proba(14)[:BS] + b"\x00" * 10 + generate_proba(2)[:BS]
            + generate_proba(80)[BS:BS + 777])


CORPORA = {
    "p80": generate_proba(80)[: 3 * BS + 1234],   # a compressed ragged tail
    "p14": generate_proba(14)[: 4 * BS],
    "p02": generate_proba(2)[: 4 * BS + 100],     # a raw ragged tail
    "mixed": _mixed(),
}


@pytest.fixture(scope="module")
def codecs():
    return {"fse": (FseTpuCodec(BS, device="cpu"), JFse(BS)),
            "huf": (HufTpuCodec(BS, device="cpu"), JHuf(BS)),
            "huf_x2": (HufTpuCodec(BS, decoder="x2", device="cpu"), JHuf(BS, decoder="x2"))}


@pytest.fixture(scope="module")
def frames(codecs):
    """{(codec, corpus): (port frame, JAX device frame, twin frame)}."""
    out = {}
    for codec in ("fse", "huf"):
        port, jax = codecs[codec]
        for name, data in CORPORA.items():
            out[(codec, name)] = (
                fio.compress_bytes(data, codec, BID, port.compress_blocks),
                j_fio.compress_bytes(data, codec, BID, jax.compress_blocks),
                j_fio.compress_bytes(data, codec, BID))
    return out


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("codec", ["fse", "huf"])
def test_frames_equal_jax_device_and_twin(frames, codec, name):
    port, jax, twin = frames[(codec, name)]
    assert port == jax == twin
    assert port == fio.compress_bytes(CORPORA[name], codec, BID)   # the port's twin


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("codec", ["fse", "huf", "huf_x2"])
def test_cross_decode(codecs, frames, codec, name):
    """The port's codec decodes the frame (equal to JAX's and the twin's);
    JAX's codec and both twins decode the port's."""
    port, jax = codecs[codec]
    blob = frames[(codec.split("_")[0], name)][0]
    data = CORPORA[name]
    assert fio.decompress_bytes(blob, port.decompress_blocks) == data
    assert j_fio.decompress_bytes(blob, jax.decompress_blocks) == data
    assert j_fio.decompress_bytes(blob) == data == fio.decompress_bytes(blob)


def test_mixed_corpus_holds_every_block_kind(frames):
    """The mixed frame has raw, RLE and compressed blocks, full and partial."""
    blob = frames[("fse", "mixed")][0]
    pos, kinds = 5, set()
    while blob[pos] >> 6 != 3:
        desc, full = blob[pos] >> 6, bool(blob[pos] & 0x20)
        pos += 1
        rsize = BS if full else (blob[pos] << 8) | blob[pos + 1]
        pos += 0 if full else 2
        if desc == 0:
            csize = (blob[pos] << 8) | blob[pos + 1]
            pos += 2 + csize
        else:
            pos += rsize if desc == 1 else 1
        kinds.add((desc, full))
    assert {(0, True), (1, True), (2, True), (0, False)} <= kinds


@pytest.mark.parametrize("name", ["p80", "p14", "mixed"])
def test_auto_codec_equals_jax(name):
    data = CORPORA[name]
    port, jax = AutoTpuCodec(BS, device="cpu"), JAuto(BS)
    results = port.compress_blocks(fio.split_blocks(data, BS))
    want = jax.compress_blocks(j_fio.split_blocks(data, BS))
    assert port.chosen == jax.chosen
    assert [(r.kind, r.data) for r in results] == [(r.kind, r.data) for r in want]
    blob = fio.compress_bytes(data, port.chosen, BID, AutoTpuCodec(BS, device="cpu")
                              .compress_blocks)
    assert blob == j_fio.compress_bytes(data, jax.chosen, BID)
    assert fio.decompress_bytes(blob, port.decompress_blocks) == data
    with pytest.raises(ValueError):
        AutoTpuCodec(BS, device="cpu").decompress_blocks([(b"x", 1)])


@pytest.mark.parametrize("codec", ["fse", "huf", "huf_x2"])
def test_corrupt_frames_raise_on_both_sides(codecs, codec):
    """Flipped payload bytes raise CorruptionError in the port and an error
    in JAX, and never read outside the buffer."""
    port, jax = codecs[codec]
    base = codec.split("_")[0]
    data = CORPORA["p80"]       # four blocks: a batch shape JAX has compiled
    frame = fio.compress_bytes(data, base, BID, port.compress_blocks)
    for at, flip in ((30, 0x10), (len(frame) // 2, 0x40), (len(frame) - 5, 0x01)):
        bad = bytearray(frame)
        bad[at] ^= flip
        with pytest.raises(CorruptionError):
            fio.decompress_bytes(bytes(bad), port.decompress_blocks)
        with pytest.raises(Exception):
            j_fio.decompress_bytes(bytes(bad), jax.decompress_blocks)


def test_block_size_64k_frames_equal_twin():
    """Codecs built at the frame's block size (-B 64K: block_size_id 6)
    write the twin's frames; the JAX CLI builds its device codecs at 32 KiB
    whatever -B says, and fails there (ROADMAP C)."""
    data = generate_proba(80)[:33000]       # one partial block past 32 KiB
    for codec in ("fse", "huf"):
        comp, dec = get_batch_codec(codec, 0, 1 << 16, device="cpu")
        blob = fio.compress_bytes(data, codec, 6, comp)
        assert blob == j_fio.compress_bytes(data, codec, 6)
        assert fio.decompress_bytes(blob, dec) == data


def test_codecs_default_to_cuda():
    """device=None is CUDA: without one the codecs raise (never a silent
    CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (FseTpuCodec, HufTpuCodec):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(BS)
    with pytest.raises(ValueError):
        get_batch_codec("zlibh", device="cpu")


def test_raw_rle_decisions_equal_jax():
    """The codecs' raw / RLE rules: blocks of 0-1 bytes, one repeated
    symbol, incompressible data, and tiny Huff0 blocks (< 12 bytes)."""
    rng = np.random.default_rng(9)
    blocks = [b"", b"a", b"zz", b"\x01" * 100, rng.integers(0, 256, 300, dtype=np.uint8)
              .tobytes(), generate_proba(80)[:11], generate_proba(80)[:13],
              generate_proba(80)[:40], b"ab" * 3]
    for port, jax in ((FseTpuCodec(BS, device="cpu"), JFse(BS)),
                      (HufTpuCodec(BS, device="cpu"), JHuf(BS))):
        got = port.compress_blocks(blocks)
        want = jax.compress_blocks(blocks)
        assert [(r.kind, r.data) for r in got] == [(r.kind, r.data) for r in want]
