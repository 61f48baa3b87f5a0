"""The benchmark's plain reader of `fse -h` frames (h100_bench/reference/
huf_frames.py) decodes the port's Huff0 frames, from the device codec's
plain versions and from the host twins, with both kinds of weight header,
and rejects frames that are not `fse -h` frames of their data; the Huff0
codec's `counts` tally the blocks of a round trip by how they were stored
and decoded."""
import numpy as np
import pytest

from finitestateentropy_tpu_torch.errors import CorruptionError
from finitestateentropy_tpu_torch.io.frame import compress_bytes, decompress_bytes
from finitestateentropy_tpu_torch.models import get_batch_codec, huf_codec
from finitestateentropy_tpu_torch.models.huf_codec import HufTpuCodec
from finitestateentropy_tpu_torch.utils import generate_proba, xxh32
from h100_bench.reference.huf_frames import decode_frames

RNG = np.random.default_rng(23)
CASES = {
    # one full 32 KiB block and a partial last one
    "p80": (generate_proba(80, 40_000), 5),
    "p14": (generate_proba(14, 40_000), 5),
    # 256 symbols, Zipf-skewed: the weights are FSE-coded
    "fse_weights": ((RNG.zipf(1.3, 40_000) % 256).astype(np.uint8).tobytes(), 5),
    # a near-uniform block stored raw, an RLE block, a partial coded block
    "raw_rle": (RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes() + b"\7" * 4096
                + generate_proba(80, 2000), 2),
    "bid2_partial": (generate_proba(80, 3 * 4096 + 777), 2),
    "bid6": (generate_proba(80, 70_000), 6),
}


def _frame(case: str, source: str) -> bytes:
    data, bid = CASES[case]
    compressor = (get_batch_codec("huf", block_size=1 << (10 + bid), device="cpu")[0]
                  if source == "device" else None)
    return compress_bytes(data, "huf", bid, compressor)


@pytest.mark.parametrize("source", ["device", "twin"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decodes_the_ports_frames(case, source):
    assert decode_frames([_frame(case, source)]) == [CASES[case][0]]


@pytest.mark.parametrize("case,fse_coded", [("fse_weights", True), ("p80", False),
                                            ("p14", False)])
def test_weight_header_kinds(case, fse_coded):
    """The first block is a full compressed one (descriptor 0x20, two bytes
    of payload size); its payload's first byte says how the weights are
    stored: below 128 the size of an FSE-coded stream, else 4-bit weights."""
    frame = _frame(case, "twin")
    assert frame[5] == 0x20
    assert (frame[8] < 128) == fse_coded


def test_raw_and_rle_blocks_are_present():
    frame = _frame("raw_rle", "twin")
    kinds = [frame[pos] >> 6 for pos in (5, 6 + 4096)]    # the first two descriptors
    assert kinds == [1, 2]                                # raw, then RLE


def _altered(kind: str) -> bytes:
    frame = bytearray(_frame("bid2_partial", "twin"))
    if kind == "payload":
        frame[len(frame) // 2] ^= 0x04
    elif kind == "trailer":
        frame[-1] ^= 0x01
    else:
        del frame[-7:]
    return bytes(frame)


@pytest.mark.parametrize("kind", ["payload", "trailer", "truncated"])
def test_rejects_altered_frames(kind):
    assert decode_frames([_altered(kind), _frame("bid2_partial", "twin")]) == [
        None, CASES["bid2_partial"][0]]


def test_rejects_a_frame_of_another_codec():
    data = CASES["bid2_partial"][0]
    assert decode_frames([compress_bytes(data, "fse", 2)]) == [None]


@pytest.mark.parametrize("kwargs,path", [({}, "decoded_x1"), ({"decoder": "x2"}, "decoded_x2"),
                                         ({"mesh": 2}, "decoded_mesh")])
def test_counts_tally_a_round_trip(kwargs, path):
    """Blocks: near-uniform (raw at the plan), a run (RLE), near-uniform
    with one symbol over the plan's threshold (coded, then raw: no
    saving), Proba80 (coded).  Only the coded one reaches the decode."""
    late_raw = RNG.integers(0, 256, 4096, dtype=np.uint8)
    late_raw[:48] = 0
    data = CASES["raw_rle"][0][:8192] + late_raw.tobytes() + generate_proba(80, 4096)
    codec = HufTpuCodec(block_size=4096, device="cpu", **kwargs)
    before = dict(huf_codec.counts)
    frame = compress_bytes(data, "huf", 2, codec.compress_blocks)
    assert decompress_bytes(frame, codec.decompress_blocks) == data
    want = dict(before, coded=before["coded"] + 1, raw=before["raw"] + 2,
                rle=before["rle"] + 1)
    want[path] += 1
    assert huf_codec.counts == want


def _two_symbol_frame(weight: int) -> tuple[bytes, bytes]:
    """(16 bytes of symbols 0 and 1, an `fse -h` frame of them): one block,
    the weight header giving symbol 0 `weight` (symbol 1's is implied
    equal), four streams of four 1-bit codes, symbol 0 the top half of the
    table."""
    data = bytes([0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 0, 1, 0, 0, 1])
    streams = bytes(16 | data[k] << 3 | data[k + 1] << 2 | data[k + 2] << 1 | data[k + 3]
                    for k in range(0, 16, 4))
    payload = bytes([128, weight << 4, 1, 0, 1, 0, 1, 0]) + streams
    crc = (xxh32(data) >> 5) & 0x3FFFFF
    frame = (0x183E3309).to_bytes(4, "little") + bytes([0, 0, 0, 16, 0, len(payload)])
    return data, frame + payload + bytes([0xC0 | crc >> 16, crc >> 8 & 0xFF, crc & 0xFF])


def test_decodes_a_handmade_frame():
    data, frame = _two_symbol_frame(1)
    assert decompress_bytes(frame) == data
    assert decode_frames([frame]) == [data]


def test_rejects_a_header_without_weight_one_symbols():
    """Weights 2 and 2 make a prefix code too, but HUF_readStats wants an
    even number of weight-1 symbols, at least two."""
    _data, frame = _two_symbol_frame(2)
    with pytest.raises(CorruptionError):
        decompress_bytes(frame)
    assert decode_frames([frame]) == [None]


def test_rejects_a_stream_with_bits_left():
    """One stream of the first block moved up a bit over a 0 bit below it:
    the same symbols and the same trailer, but the stream is not consumed
    to its start."""
    frame = bytearray(_frame("bid2_partial", "twin"))
    assert frame[5] == 0x20 and frame[8] >= 128       # full, 4-bit weights
    body = 8 + 1 + (frame[8] - 127 + 1) // 2          # the jump table
    end = 8 + int.from_bytes(frame[6:8], "big")
    sizes = [int.from_bytes(frame[body + 2 * k:body + 2 * k + 2], "little") for k in range(3)]
    starts = np.cumsum([body + 6] + sizes)
    lo, hi = next((a, b) for a, b in zip(starts, list(starts[1:]) + [end])
                  if frame[b - 1] < 0x80)
    v = int.from_bytes(frame[lo:hi], "little") << 1
    frame[lo:hi] = v.to_bytes(hi - lo, "little")
    with pytest.raises(CorruptionError):
        decompress_bytes(bytes(frame))
    assert decode_frames([bytes(frame)]) == [None]
