"""The reference decodes the port's frames made on the CPU, and rejects
frames that are not TurboRANS streams."""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.turbo import api, device_api
from h100_bench.reference.turbo_rans import decode_frames
from h100_bench.traffic.proba_pool import proba_stream

DATA = {p: proba_stream(p, 70_000, 11).tobytes() for p in (80, 14)}


@pytest.mark.parametrize("percent,flags", [
    (80, {}), (80, {"pair": 0, "quad": 0}), (80, {"quad": 1}), (80, {"pair": 1, "quad": 0}),
    (14, {}), (80, {"steptots": False}), (80, {"totals_only": True})])
def test_speed_config_frames(percent, flags):
    data = DATA[percent]
    frame = api.turbo_compress_device(data, 32768, **flags, device="cpu")
    assert decode_frames([frame]) == [data]


def test_resident_config_frames():
    data = DATA[80]
    frame = device_api.rans_compress_resident(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()), 32768)
    assert decode_frames([frame]) == [data]


def test_raw_and_rle_groups():
    data = bytes(range(256)) * 200 + b"z" * 30000
    frame = api.turbo_compress_device(data, 32768, device="cpu")
    assert decode_frames([frame]) == [data]


@pytest.mark.parametrize("where", [0.5, 0.9, -1])
def test_altered_frames_are_rejected(where):
    data = DATA[80]
    frame = bytearray(api.turbo_compress_device(data, 32768, device="cpu"))
    frame[int(len(frame) * where)] ^= 0x10
    assert decode_frames([bytes(frame), bytes(frame[:-2])]) == [None, None]
