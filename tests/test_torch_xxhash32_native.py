"""utils/xxhash32.py: the native XXH32 pass (csrc/xxh32_host.c) returns the
hashes of the Python loop `_xxh32_py`, of the JAX package's `xxh32` and of
tests/data_xxh_vectors.txt for every input type; the frame layer hashes
through it, and through the Python loop when the library cannot be had."""
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import finitestateentropy_tpu.utils.xxhash32 as j_xxh
import finitestateentropy_tpu_torch.utils.xxhash32 as xxh
from finitestateentropy_tpu_torch.config import FSE_CHECKSUM_SEED
from finitestateentropy_tpu_torch.errors import CorruptionError
from finitestateentropy_tpu_torch.io.frame import compress_bytes, decompress_bytes
from finitestateentropy_tpu_torch.utils import generate_proba

REPO = Path(__file__).resolve().parent.parent
# FSE_CHECKSUM_SEED is 0; 1 and 0x9E3779B1 are the vectors' other seeds
SEEDS = (FSE_CHECKSUM_SEED, 1, 0x9E3779B1)
LENGTHS = {
    "0-64": range(65),
    "1023-1025": range(1023, 1026),
    "32767-32769": range(32767, 32770),
    "16MiB": (16 << 20,),
}
KINDS = ("bytes", "bytearray", "memoryview", "ndarray", "strided")


@functools.cache
def _proba80() -> bytes:
    return generate_proba(80, 16 << 20)


def _as(kind: str, data: bytes):
    if kind == "bytes":
        return data
    if kind == "bytearray":
        return bytearray(data)
    if kind == "memoryview":
        return memoryview(data)
    if kind == "ndarray":
        return np.frombuffer(data, np.uint8)
    wide = np.zeros(2 * len(data), np.uint8)   # every other byte: a strided slice
    wide[::2] = np.frombuffer(data, np.uint8)
    return wide[::2]


@functools.cache
def _oracles(n: int, seed: int) -> tuple[int, int]:
    data = _proba80()[:n]
    return xxh._xxh32_py(data, seed), j_xxh.xxh32(data, seed)


@pytest.fixture
def native():
    """The native library; skips only where no C compiler exists."""
    if shutil.which(os.environ.get("CC") or "cc") is None:
        pytest.skip("no C compiler: the native XXH32 cannot be built")
    lib = xxh._load()
    assert lib is not None, "a C compiler exists but the library did not load"
    return lib


@pytest.fixture
def python_only(monkeypatch, tmp_path):
    """The loader forced to fail: no compiler at the build, an empty build
    directory; restored after the test."""
    monkeypatch.setattr(xxh, "_lib", None)
    monkeypatch.setattr(xxh, "_tried", False)
    monkeypatch.setattr(xxh, "_BUILD_DIR", tmp_path / "host")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert xxh._load() is None
    return tmp_path / "host"


def _hash_native(data, seed: int) -> int:
    before = xxh.counts["native"]
    h = xxh.xxh32(data, seed)
    assert xxh.counts["native"] == before + 1
    return h


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_native_equals_python_and_jax(native, lengths, seed, kind):
    for n in LENGTHS[lengths]:
        py, jx = _oracles(n, seed)
        assert py == jx, (n, seed)
        assert _hash_native(_as(kind, _proba80()[:n]), seed) == py, (n, seed, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_native_equals_vectors(native, seed, kind):
    buf, s = bytearray(1031), 2654435761
    for i in range(len(buf)):
        s = (s * 2654435761 + 2246822519) & 0xFFFFFFFF
        buf[i] = (s >> 11) & 0xFF
    lines = [ln.split() for ln in
             (REPO / "tests" / "data_xxh_vectors.txt").read_text().splitlines()]
    lines = [(int(n), int(h32, 16)) for n, sd, h32, _h64 in lines if int(sd) == seed]
    assert len(lines) == 11
    for n, h32 in lines:
        assert _hash_native(_as(kind, bytes(buf[:n])), seed) == h32, (n, seed, kind)


def _round_trip(codec: str) -> tuple[bytes, bytes]:
    data = generate_proba(80, 9000)   # five 2 KiB blocks, the last partial
    frame = compress_bytes(data, codec, 1)
    return frame, decompress_bytes(frame)


@pytest.mark.parametrize("codec", ["fse", "huf"])
def test_frame_round_trip_hashes_natively(native, codec):
    before = dict(xxh.counts)
    frame, out = _round_trip(codec)
    assert out == generate_proba(80, 9000)
    assert xxh.counts == {"native": before["native"] + 2, "python": before["python"]}


@pytest.mark.parametrize("codec", ["fse", "huf"])
def test_frame_round_trip_falls_back_to_python(request, native, codec):
    expected = _round_trip(codec)
    build_dir = request.getfixturevalue("python_only")
    before = dict(xxh.counts)
    assert _round_trip(codec) == expected
    assert xxh.counts == {"native": before["native"], "python": before["python"] + 2}
    # the failed build left no library and nothing half-written
    assert not list(build_dir.glob("*.so")) and not list(build_dir.glob("*.tmp"))


@pytest.mark.parametrize("path", ["native", "python"])
def test_flipped_trailer_raises(request, native, path):
    if path == "python":
        request.getfixturevalue("python_only")
    frame, _ = _round_trip("fse")
    bad = frame[:-1] + bytes([frame[-1] ^ 1])
    with pytest.raises(CorruptionError, match="frame checksum mismatch"):
        decompress_bytes(bad)


_BUILDER = r"""
import sys
from pathlib import Path
import finitestateentropy_tpu_torch.utils.xxhash32 as xxh
xxh._BUILD_DIR = Path(sys.argv[1])
assert xxh._load() is not None
print(xxh.xxh32(b"Hello World", 0))
"""


def test_concurrent_builds_share_one_library(native, tmp_path):
    """Six processes asking for the library in an empty build directory at
    once: one builds under the lock, every one loads the same file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _o, e in outs]
    assert {o.strip() for o, _e in outs} == {str(0xB1FD16EE)}
    assert len(list(tmp_path.glob("libxxh32_host-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_threads_share_the_first_load_and_the_counts(native, monkeypatch):
    """Sixteen threads hashing from a cold loader: every call hashes
    natively, to the right value, and each one is counted."""
    import threading

    import time

    monkeypatch.setattr(xxh, "_lib", None)
    monkeypatch.setattr(xxh, "_tried", False)
    path_of = xxh._library_path
    # a slow first load: threads arriving meanwhile wait for it
    monkeypatch.setattr(xxh, "_library_path", lambda cc: time.sleep(0.2) or path_of(cc))
    data = _proba80()[:4099]
    want = xxh._xxh32_py(data, 1)
    before = dict(xxh.counts)
    results, interval = [], sys.getswitchinterval()

    def work():
        results.extend(xxh.xxh32(data, 1) for _ in range(200))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert results == [want] * 3200
    assert xxh.counts == {"native": before["native"] + 3200, "python": before["python"]}
