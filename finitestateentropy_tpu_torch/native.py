"""ctypes bindings for the native TurboRANS host codec (native/turbofse.cc).

The port's copy of the JAX package's native.py: it loads the same library,
native/libturbofse.so, and builds it on demand with native/build.sh and the
system compiler, under a file lock and into a temporary directory whose
library then replaces the old name at once (so no process loads a
half-written file); `available()` reports whether it could be loaded.  The
native path is the CLI's host codec (`-T --device host`), the source of
the entry points' per-group byte stats (`turbo/api.prep_group`, as in the
JAX package), and a fast oracle for the device kernels: its encoder emits ratio-mode (v1) groups
byte-identical to `rans_compress(..., steptots=False)` and speed-mode
groups byte-identical to `rans_compress(...)`, and its decoder reads every
byte, pair and quad frame.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_LIB_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB = _LIB_DIR / "libturbofse.so"
_LOCK = _LIB_DIR / "libturbofse.lock"
_VERSION = 4
_lib = None
_tried = False


def _build() -> None:
    """Build the library into a temporary directory and move it into place
    with os.replace, so no process ever loads a half-written file.  The
    caller holds the build lock."""
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=_LIB_DIR))
    try:
        for name in ("build.sh", "turbofse.cc"):
            shutil.copy2(_LIB_DIR / name, tmp / name)
        subprocess.run(["sh", str(tmp / "build.sh")], check=True,
                       capture_output=True)
        os.replace(tmp / "libturbofse.so", _LIB)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _open():
    """The loaded library at its current version, or None."""
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    return lib if getattr(lib, "tfse_version", lambda: 0)() >= _VERSION else None


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _open() if _LIB.exists() else None
    if lib is None:
        # missing, stale or half-written by a build that writes in place:
        # build under the lock (one process builds, the others wait and load)
        try:
            with open(_LOCK, "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                lib = _open() if _LIB.exists() else None
                if lib is None:
                    _build()
                    lib = _open()
        except (OSError, subprocess.CalledProcessError):
            lib = None
    if lib is None:
        from .utils.debug import debuglog
        debuglog(2, "native turbofse library unavailable; python twin fallback")
        return None
    lib.tfse_rans_compress_group.restype = ctypes.c_int64
    lib.tfse_rans_compress_group.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]
    lib.tfse_rans_decompress_group.restype = ctypes.c_int64
    lib.tfse_rans_decompress_group.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.tfse_multibyte_decompress_group.restype = ctypes.c_int64
    lib.tfse_multibyte_decompress_group.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.tfse_prep_group.restype = ctypes.c_int64
    lib.tfse_prep_group.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64)]
    lib.tfse_rans_compress.restype = ctypes.c_int64
    lib.tfse_rans_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int32]
    lib.tfse_rans_decompress.restype = ctypes.c_int64
    lib.tfse_rans_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int32]
    lib.tfse_rans16_decompress.restype = ctypes.c_int64
    lib.tfse_rans16_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int32]
    lib.tfse_rans16_compress.restype = ctypes.c_int64
    lib.tfse_rans16_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_int32]
    lib.tfse_rans_compress2.restype = ctypes.c_int64
    lib.tfse_rans_compress2.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int32]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def rans_compress_native(data: bytes, group_size: int = 1 << 20,
                         nthreads: int = 0) -> bytes:
    """Multi-group TurboRANS compress, byte-identical to the twin/device.

    Groups are independent, so the native side fans them out over a thread
    pool (nthreads <= 0 = all cores)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native turbofse library unavailable")
    group_size = max(int(group_size), 1)  # empty inputs: 1 header-only group
    ngroups = max((len(data) + group_size - 1) // group_size, 1)
    cap = len(data) + ngroups * (16 + 8192)
    dst = ctypes.create_string_buffer(cap)
    r = lib.tfse_rans_compress(data, len(data), group_size, dst, cap, nthreads)
    if r < 0:
        raise RuntimeError(f"native compress failed: {r}")
    return dst.raw[:r]


def prep_group_native(chunk: bytes, table_log: int = 11):
    """Group stats via C: returns (norm, max_sv, ncount, mfs), None for RLE,
    or the string "fallback" when the native path cannot handle the input."""
    import numpy as np

    lib = _load()
    if lib is None:
        return "fallback"
    norm = (ctypes.c_int16 * 256)()
    ncount = ctypes.create_string_buffer(512)
    meta = (ctypes.c_int64 * 3)()
    r = lib.tfse_prep_group(chunk, len(chunk), table_log, norm, ncount, meta)
    if r == 0:
        return None  # RLE
    if r != 1:
        return "fallback"
    max_sv, mfs, nc_len = int(meta[0]), int(meta[1]), int(meta[2])
    return (np.frombuffer(norm, np.int16, max_sv + 1).astype(np.int32),
            max_sv, ncount.raw[:nc_len], mfs)


def _walk_groups(blob: bytes):
    """Header-only walk: (total decoded size, pair-group spans).  Pair
    groups (FLAG_PAIR, turbo/pair.py) are located so the decompressor can
    route them to the host twin — the C codec speaks the byte wire only."""
    import struct

    pos, total = 0, 0
    pair_spans: list[tuple[int, int, int]] = []   # (start, used, out_off)
    while pos < len(blob):
        if pos + 16 > len(blob):
            raise ValueError("truncated turbo-rans stream")
        magic, n, csize_hw, tlog, flags, nc_len = struct.unpack_from(
            "<IIIBBH", blob, pos)
        if magic != 0x183EF002:
            raise ValueError("bad turbo-rans magic")
        if flags & 32:           # FLAG_PAIR: sized by the full parser
            from .turbo.pair import parse_pair_group

            _g, used = parse_pair_group(blob[pos:])
            pair_spans.append((pos, used, total))
            pos += used
        elif flags & 128:        # FLAG_QUAD: same twin-fallback routing
            from .turbo.quad import parse_quad_group

            _g, used = parse_quad_group(blob[pos:])
            pair_spans.append((pos, used, total))
            pos += used
        elif flags & 1:          # raw
            pos += 16 + n
        elif flags & 2:          # rle
            pos += 20
        else:
            n_pad = (n + 4095) // 4096 * 4096
            hdr2 = 16 + (nc_len + 3) // 4 * 4 + 4096
            if flags & 4 and flags & 16:   # FLAG_ROWS4: variable section
                if pos + hdr2 + 4 > len(blob):
                    raise ValueError("truncated turbo-rans stream")
                (n_exc,) = struct.unpack_from("<I", blob, pos + hdr2)
                sect = 4 + 4 * n_exc + (n_pad // 1024) * 4
            else:
                sect = ((n_pad // 1024) * 8 if flags & 4
                        else (n_pad // 1024) * 2 if flags & 8 else 0)
            pos += hdr2 + sect + 2 * csize_hw
        total += n
    return total, pair_spans


def rans_decompress_native(blob: bytes, nthreads: int = 0) -> bytes:
    """Multi-group threaded decompress (nthreads <= 0 = all cores).

    Multi-byte-wire groups (FLAG_PAIR / FLAG_QUAD) decode through the
    native C scalar decoder (tfse_multibyte_decompress_group), so the
    device path's pair and quad frames decode on a host without a GPU."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native turbofse library unavailable")
    total, pair_spans = _walk_groups(blob)
    if not pair_spans:
        dst = ctypes.create_string_buffer(max(total, 1))
        r = lib.tfse_rans_decompress(blob, len(blob), dst, total, nthreads)
        if r < 0:
            raise ValueError(f"native decompress failed: {r}")
        return dst.raw[:r]
    # plan (kind, src span, out span) tasks, then fan out: the C calls
    # release the GIL, so multibyte groups thread like the byte spans
    # (which the C pool threads internally)
    from concurrent.futures import ThreadPoolExecutor

    tasks = []           # (is_multibyte, start, length, out_off, out_len)
    cursor, out_off = 0, 0
    for start, used, _o in pair_spans:
        if start > cursor:
            seg_total, _ = _walk_groups(blob[cursor:start])
            tasks.append((False, cursor, start - cursor, out_off, seg_total))
            out_off += seg_total
        n_sym = int.from_bytes(blob[start + 4 : start + 8], "little")
        tasks.append((True, start, used, out_off, n_sym))
        out_off += n_sym
        cursor = start + used
    if cursor < len(blob):
        seg_total, _ = _walk_groups(blob[cursor:])
        tasks.append((False, cursor, len(blob) - cursor, out_off, seg_total))
        out_off += seg_total
    out = bytearray(out_off)
    view = memoryview(out)

    def run(task):
        is_mb, start, length, o_off, o_len = task
        seg = blob[start : start + length]
        dst = ctypes.create_string_buffer(max(o_len, 1))
        if is_mb:
            cons = ctypes.c_uint64(0)
            r = lib.tfse_multibyte_decompress_group(seg, len(seg), dst,
                                                    o_len, ctypes.byref(cons))
        else:
            r = lib.tfse_rans_decompress(seg, len(seg), dst, o_len, nthreads)
        if r < 0:
            raise ValueError(f"native decompress failed: {r}")
        if r != o_len:
            raise ValueError(
                f"native decompress size mismatch: {r} != {o_len}")
        view[o_off : o_off + r] = dst.raw[:r]
        return r

    import os

    workers = min(len(tasks), os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(run, tasks))
    else:
        for t in tasks:
            run(t)
    return bytes(out)


def _walk_groups16(blob: bytes) -> int:
    """Header-only walk of u16 frames: total decoded SYMBOLS."""
    import struct

    pos, total = 0, 0
    while pos < len(blob):
        if pos + 16 > len(blob):
            raise ValueError("truncated turbo-u16 stream")
        magic, n, csize_hw, tlog, flags, nc_len = struct.unpack_from(
            "<IIIBBH", blob, pos)
        if magic != 0x183EF003:
            raise ValueError("bad turbo-u16 magic")
        if flags & 1:            # raw
            pos += 16 + 2 * n
        elif flags & 2:          # rle
            pos += 20
        else:
            n_pad = (n + 2047) // 2048 * 2048
            sect = (n_pad // 1024) * 8 if flags & 4 else 0
            pos += 16 + (nc_len + 3) // 4 * 4 + 4096 + sect + 2 * csize_hw
        total += n
    return total


def rans16_decompress_native(blob: bytes, nthreads: int = 0):
    """Multi-group threaded u16 decompress -> np.ndarray[u16]."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native turbofse library unavailable")
    total = _walk_groups16(blob)
    dst = ctypes.create_string_buffer(max(2 * total, 1))
    r = lib.tfse_rans16_decompress(blob, len(blob), dst, total, nthreads)
    if r < 0:
        raise ValueError(f"native turbo-u16 decompress failed ({r})")
    if r != total:
        raise ValueError("native turbo-u16 decompress: size mismatch")
    return np.frombuffer(dst.raw[: 2 * total], "<u2").copy()


def rans16_compress_native(symbols, group_syms: int = 1 << 19,
                           nthreads: int = 0) -> bytes:
    """Multi-group u16 compress, byte-identical to
    rans16_compress(..., steptots=False) (ratio-mode frames)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native turbofse library unavailable")
    sym = np.ascontiguousarray(symbols, dtype="<u2")
    n = len(sym)
    group_syms = max(int(group_syms), 1)
    ngroups = max((n + group_syms - 1) // group_syms, 1)
    cap = 2 * n + ngroups * (16 + 16384)
    dst = ctypes.create_string_buffer(cap)
    r = lib.tfse_rans16_compress(sym.tobytes(), n, group_syms, dst, cap,
                                 nthreads)
    if r < 0:
        raise RuntimeError(f"native u16 compress failed: {r}")
    return dst.raw[:r]


def rans_compress2_native(data: bytes, group_size: int = 1 << 20,
                          table_log: int = 0, nthreads: int = 0) -> bytes:
    """Speed-mode multi-group compress: FLAG_STEPTOTS (+ROWS4 when
    smaller) frames byte-identical to rans_compress(data, steptots=True).
    table_log 0 = the speed default (RANS_SPEED_TABLELOG)."""
    from .turbo.rans import RANS_SPEED_TABLELOG

    lib = _load()
    if lib is None:
        raise RuntimeError("native turbofse library unavailable")
    if table_log == 0:
        table_log = RANS_SPEED_TABLELOG
    group_size = max(int(group_size), 1)
    ngroups = max((len(data) + group_size - 1) // group_size, 1)
    cap = len(data) + len(data) // 32 + ngroups * (16 + 16384)
    dst = ctypes.create_string_buffer(cap)
    r = lib.tfse_rans_compress2(data, len(data), group_size, table_log, dst,
                                cap, nthreads)
    if r < 0:
        raise RuntimeError(f"native compress2 failed: {r}")
    return dst.raw[:r]
