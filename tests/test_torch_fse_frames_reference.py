"""The benchmark's plain reader of `.fse` frames (h100_bench/reference/
fse_frames.py) decodes the port's frames, from the device codec's plain
versions and from the host twins, and rejects frames that are not `.fse`
frames of their data; its XXH32 is the frame layer's."""
import numpy as np
import pytest

from finitestateentropy_tpu_torch.io.frame import compress_bytes
from finitestateentropy_tpu_torch.models import get_batch_codec
from finitestateentropy_tpu_torch.utils import generate_proba, xxh32
from h100_bench.reference.fse_frames import decode_frames
from h100_bench.reference.fse_frames import xxh32 as ref_xxh32

RNG = np.random.default_rng(19)
CASES = {
    # one full 32 KiB block and a partial last one
    "p80": (generate_proba(80, 40_000), 5),
    "p14": (generate_proba(14, 40_000), 5),
    # a near-uniform block stored raw, an RLE block, a partial coded block
    "raw_rle": (RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes() + b"\7" * 4096
                + generate_proba(80, 2000), 2),
    "bid2_partial": (generate_proba(80, 3 * 4096 + 777), 2),
    "bid6": (generate_proba(80, 70_000), 6),
}


def _frame(case: str, source: str) -> bytes:
    data, bid = CASES[case]
    compressor = (get_batch_codec("fse", block_size=1 << (10 + bid), device="cpu")[0]
                  if source == "device" else None)
    return compress_bytes(data, "fse", bid, compressor)


@pytest.mark.parametrize("source", ["device", "twin"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decodes_the_ports_frames(case, source):
    assert decode_frames([_frame(case, source)]) == [CASES[case][0]]


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
    assert decode_frames([compress_bytes(data, "huf", 2)]) == [None]


def test_xxh32_is_the_frame_layers():
    rng = np.random.default_rng(7)
    for n in list(range(101)) + [1 << 20]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 0x9E3779B1):
            assert ref_xxh32(data, seed) == xxh32(data, seed), (n, seed)


def test_xxh32_of_nothing():
    assert ref_xxh32(b"") == 0x02CC5D05
