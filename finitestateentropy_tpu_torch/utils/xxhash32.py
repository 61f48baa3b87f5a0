"""XXH32 — needed for the frame checksum (reference programs/fileio.c:129,410-418).

One-shot XXH32 over the caller's buffer; streaming state not needed (frames
are hashed in one shot over the original data).  `xxh32` runs the native
pass of ``csrc/xxh32_host.c``: built with the system C compiler (``$CC``,
else ``cc``; no nvcc, no torch) the first time it hashes, never at import,
into ``build/host/`` at the root of the checkout under a name that carries
a hash of the source and flags, then loaded with ctypes and handed a
pointer to the caller's buffer, copied only when it is not contiguous.
When the library cannot be built or loaded, `_xxh32_py` hashes: the stripe
loop on plain Python ints (same results as the JAX package's numpy-scalar
loop, several times faster), which the tests also hold the native pass
against.  `counts` tallies which of the two hashed, once a call.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "xxh32_host.c"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_CFLAGS = ("-O3", "-fPIC", "-shared")
_lib = None
_tried = False
_lock = threading.Lock()   # first load and counts: one thread at a time
counts = {"native": 0, "python": 0}


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _xxh32_py(data: bytes | np.ndarray, seed: int = 0) -> int:
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    i = 0
    if n >= 16:
        nlanes = n // 16
        lanes = buf[: nlanes * 16].view("<u4").reshape(nlanes, 4)
        v = [
            (seed + _P1 + _P2) & _M32,
            (seed + _P2) & _M32,
            seed & _M32,
            (seed - _P1) & _M32,
        ]
        # per-lane sequential rounds (vector over the 4 lanes is what xxh
        # does; the stripe loop is inherently serial): plain Python ints over
        # each lane's column, several times faster than numpy scalars
        for k in range(4):
            acc = v[k]
            for x in lanes[:, k].tolist():
                acc = (acc + x * _P2) & _M32
                acc = (((acc << 13) | (acc >> 19)) * _P1) & _M32
            v[k] = acc
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M32
        i = nlanes * 16
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        w = int(buf[i]) | int(buf[i + 1]) << 8 | int(buf[i + 2]) << 16 | int(buf[i + 3]) << 24
        h = (h + w * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + int(buf[i]) * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


def _library_path(cc: str) -> Path:
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join((cc, *_CFLAGS)).encode())
    return _BUILD_DIR / f"libxxh32_host-{tag.hexdigest()[:12]}.so"


def _build(cc: str, lib: Path) -> None:
    """Compile into a temporary file and move it into place with os.replace,
    so no process loads a half-written library.  The caller holds the lock."""
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cc, *_CFLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    """The native library, built on first use; None when it cannot be had."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    cc = os.environ.get("CC") or "cc"
    try:
        path = _library_path(cc)
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_BUILD_DIR / "libxxh32_host.lock", "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)   # one process builds
                if not path.exists():
                    _build(cc, path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.CalledProcessError) as e:
        from .debug import debuglog
        debuglog(2, "native xxh32 unavailable (%s); python fallback", e)
        return None
    lib.xxh32.restype = ctypes.c_uint32
    lib.xxh32.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    _lib = lib
    return _lib


def _as_bytes(data) -> np.ndarray:
    """A uint8 view of the bytes `bytes(data)` holds, with no copy where
    `data` is contiguous."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    try:
        return np.frombuffer(data, np.uint8)
    except (TypeError, ValueError, BufferError):
        return np.frombuffer(bytes(data), np.uint8)


def xxh32(data: bytes | np.ndarray, seed: int = 0) -> int:
    with _lock:
        lib = _load()
        counts["python" if lib is None else "native"] += 1
    if lib is None:
        return _xxh32_py(data, seed)
    buf = _as_bytes(data)
    return lib.xxh32(buf.ctypes.data, buf.nbytes, seed & _M32)
