"""The port's U16 stream codec (models/u16_codec.py) against the JAX
package's, after tests/test_models_select.py:55-85 and
tests/test_native.py:155-170.

The compat wire's bytes equal the JAX codec's and the host twin's; the
turbo wire's frames (the entry points on the CPU: the kernels' plain
versions) equal the JAX codec's in interpret mode; the turbo_native wire's
frames equal the JAX codec's and interchange with the turbo wire.  The
test marked ``gpu`` holds the turbo wire on the card to its CPU frames.
Tolerance is 0 throughout: the codecs are integer and bit-exact.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch import native
from finitestateentropy_tpu_torch.models import U16Codec
from finitestateentropy_tpu_torch.refimpl.fseu16 import fse_compress_u16
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (turbo16_compress_device,
                                                    turbo16_decompress_device)


def _dist_stream(n, rng):
    """tests/test_models_select.py's pareto distance stream (<= 1000)."""
    return np.minimum(rng.pareto(1.2, n) * 40, 1000).astype(np.uint16)


def _wide_stream(n, rng):
    """Symbols up to 4095 (the split u16x tables on the turbo wire)."""
    return np.clip((rng.pareto(1.0, n) * 300).astype(np.int64), 0, 4095).astype(np.uint16)


def _roundtrip(codec, streams):
    blobs = codec.compress_streams(streams)
    back = codec.decompress_streams([(b, len(s)) for b, s in zip(blobs, streams)])
    for s, o in zip(streams, back):
        assert np.array_equal(s, o)
    return blobs


def test_u16_codec_compat_roundtrip_equals_jax():
    """A distance stream, zeros (RLE), an incompressible stream and one
    past the alphabet's 4095 (stored raw): the same bytes as the JAX codec,
    and each decodes the other's."""
    from finitestateentropy_tpu.models import U16Codec as JU16Codec

    rng = np.random.default_rng(7)
    streams = [_dist_stream(5000, rng), np.zeros(100, np.uint16),
               rng.integers(0, 65536, 300, dtype=np.uint16), _wide_stream(3000, rng),
               np.array([4096, 1, 2], np.uint16)]
    blobs = _roundtrip(U16Codec(wire="compat"), streams)
    assert blobs == JU16Codec(wire="compat").compress_streams(streams)
    assert [b[0] for b in blobs] == [2, 1, 0, 2, 0]
    back = JU16Codec(wire="compat").decompress_streams(
        [(b, len(s)) for b, s in zip(blobs, streams)])
    assert all(np.array_equal(s, o) for s, o in zip(streams, back))


def test_u16_codec_compat_matches_twin_bytes():
    rng = np.random.default_rng(8)
    s = _dist_stream(4000, rng)
    blob = U16Codec(wire="compat").compress_streams([s])[0]
    twin = fse_compress_u16(s, max_symbol_value=int(s.max()))
    assert blob[0] == 2 and blob[1:] == twin.data


@pytest.mark.parametrize("alphabet", ["u16", "u16x"])
def test_u16_codec_turbo_frames_equal_jax(alphabet):
    """The turbo wire on the CPU: the JAX codec's frames (its kernels in
    interpret mode), and the round trip."""
    from finitestateentropy_tpu.models import U16Codec as JU16Codec

    rng = np.random.default_rng(9)
    s = _dist_stream(3000, rng) if alphabet == "u16" else _wide_stream(3000, rng)
    blobs = _roundtrip(U16Codec(wire="turbo", device="cpu"), [s])
    assert blobs == JU16Codec(wire="turbo", interpret=True).compress_streams([s])
    assert blobs[0] == turbo16_compress_device(s, device="cpu")


def test_u16_codec_turbo_native_interchange():
    """The turbo_native wire: the JAX codec's frames; its frames decode on
    the turbo wire, and the turbo wire's (v2) frames on it."""
    from finitestateentropy_tpu.models import U16Codec as JU16Codec

    if not native.available():
        pytest.skip("native/libturbofse.so could not be built")
    rng = np.random.default_rng(2)
    d = np.clip((rng.pareto(1.2, 1 << 15) * 50).astype(np.int64), 0, 1023).astype(np.uint16)
    c = U16Codec(wire="turbo_native")
    blobs = _roundtrip(c, [d])
    assert blobs == JU16Codec(wire="turbo_native").compress_streams([d])
    assert np.array_equal(turbo16_decompress_device(blobs[0], device="cpu")[: len(d)], d)
    dev = turbo16_compress_device(d, device="cpu")
    assert np.array_equal(c.decompress_streams([(dev, len(d))])[0], d)


@pytest.mark.gpu
def test_cuda_u16_codec_turbo_equals_cpu():
    """The turbo wire on the card (device=None is CUDA): the CPU codec's
    frames, the round trip, and the U16 kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    streams = [_dist_stream(300_000, rng), _wide_stream(200_000, rng)]
    rk.reset_launches()
    blobs = _roundtrip(U16Codec(wire="turbo"), streams)
    got = {k for k, v in rk.launches.items() if v}
    assert {"rans_encode:u16", "rans_encode:u16x"} <= got
    assert any(k.startswith("rans_decode") and k.endswith(":u16") for k in got)
    assert blobs == U16Codec(wire="turbo", device="cpu").compress_streams(streams)
