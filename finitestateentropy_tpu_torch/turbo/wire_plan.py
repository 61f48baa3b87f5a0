"""The multi-byte wires' plan of one group in one native pass.

`WirePlan(chunk, pair, quad)` gives what pair.prep_pair_group and
quad.prep_quad_group give for the group, the same dicts with the same
dtypes, and the group's 256 byte counts for api._pick_wire.  The counting
and the ids (the alphabets, the top 255 and the escape id, the eligibility
test, the escapes) are one pass of ``csrc/wire_plan_host.c``; the
normalisation, the NCount and the section bytes are pair.py's and quad.py's
own.  The pass runs the first time a wire or the byte counts are asked
for, so it lies inside the span of whichever asks first.

The library is built with the system C compiler (``$CC``, else ``cc``; no
nvcc, no torch) at the first plan, never at import, into ``build/host/`` at
the root of the checkout under a name that carries a hash of the source and
flags, and loaded with ctypes, which lets go of the GIL during the pass.
When it cannot be built or loaded, the plan runs the numpy preps and has no
byte counts.  `counts` tallies which of the two planned, once a group.
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

from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from . import pair as pair_mod
from . import quad as quad_mod

# the escape caps plan_encode runs with: the preps' default max_esc_frac
PAIR_ESC_FRAC = 0.02
QUAD_ESC_FRAC = 0.01

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "wire_plan_host.c"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_CFLAGS = ("-O3", "-fPIC", "-shared")
_lib = None
_tried = False
_lock = threading.Lock()   # first load and counts: one thread at a time
counts = {"native": 0, "python": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_int,
             ctypes.c_double, _P, _P,
             _P, _P, _P, _P, _P, ctypes.c_int64,
             _P, _P, _P, _P, _P, ctypes.c_int64]


def _library_path(cc: str) -> Path:
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join((cc, *_CFLAGS)).encode())
    return _BUILD_DIR / f"libwire_plan_host-{tag.hexdigest()[:12]}.so"


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
            with open(_BUILD_DIR / "libwire_plan_host.lock", "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)   # one process builds
                if not path.exists():
                    _build(cc, path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.CalledProcessError) as e:
        from ..utils.debug import debuglog
        debuglog(2, "native wire plan unavailable (%s); numpy preps", e)
        return None
    lib.wire_plan.restype = ctypes.c_int
    lib.wire_plan.argtypes = _ARGTYPES
    _lib = lib
    return _lib


def _esc_room(frac: float, n_items: int) -> int:
    """Escape records an eligible wire can hold: no more than frac * n."""
    return int(frac * n_items) + 1


def _native_pass(lib, src: np.ndarray, pair: bool, quad: bool):
    """The C pass over one group: (byte counts, pair plan, quad plan), each
    plan a pair_plan / quad_plan dict or None; None when the pass failed."""
    n = len(src)
    n_pairs, n_quads = (n + 1) // 2, (n + 3) // 4
    byte_counts = np.empty(256, np.int64)
    res = np.empty(4, np.int64)
    p_lut, q_lut = np.empty(256, np.uint16), np.empty(256, np.uint32)
    p_cnt, q_cnt = np.empty(257, np.int64), np.empty(257, np.int64)
    p_ids = np.empty(n_pairs if pair else 0, np.uint16)
    q_ids = np.empty(n_quads if quad else 0, np.uint8)
    p_room = _esc_room(PAIR_ESC_FRAC, n_pairs) if pair else 0
    q_room = _esc_room(QUAD_ESC_FRAC, n_quads) if quad else 0
    p_pos, p_val = np.empty(p_room, np.uint32), np.empty(p_room, np.uint16)
    q_pos, q_val = np.empty(q_room, np.uint32), np.empty(q_room, np.uint32)
    a = lambda x: x.ctypes.data   # noqa: E731
    rc = lib.wire_plan(a(src), n, int(pair), PAIR_ESC_FRAC, int(quad),
                       QUAD_ESC_FRAC, a(byte_counts), a(res),
                       a(p_lut), a(p_cnt), a(p_ids), a(p_pos), a(p_val), p_room,
                       a(q_lut), a(q_cnt), a(q_ids), a(q_pos), a(q_val), q_room)
    if rc:
        return None

    def plan(kept, n_esc, lut, cnt, ids, pos, val, key, n_items):
        if kept < 0:
            return None
        esc = n_esc >= 0
        return {key: lut[:kept], "ids": ids,
                "counts": cnt[: kept + esc],
                "esc_id": int(kept) if esc else None,
                "esc_pos": pos[:n_esc] if esc else None,
                "esc_val": val[:n_esc] if esc else None,
                "n_" + key: n_items}

    pp = plan(*res[:2], p_lut, p_cnt, p_ids, p_pos, p_val, "pairs", n_pairs)
    qp = plan(*res[2:], q_lut, q_cnt, q_ids, q_pos, q_val, "quads", n_quads)
    return byte_counts, pp, qp


def _prep(plan, table_log: int, lut_key: str, sections, flags: int, n: int):
    """The tail of prep_pair_group / prep_quad_group over a plan."""
    ids, cnt = plan["ids"], plan["counts"]
    max_sv = len(cnt) - 1
    tlog = min(table_log, fse_optimal_table_log(table_log, len(ids), max_sv))
    norm, tlog = fse_normalize_count(tlog, cnt, len(ids), max_sv)
    sect, nc_len = sections(plan, norm, max_sv, tlog)
    return dict(ids=ids, counts=cnt, norm=np.asarray(norm, np.int32),
                max_sv=max_sv, tlog=tlog, sections=sect, nc_len=nc_len,
                flags=flags, **{lut_key: plan[lut_key]},
                mfi=int(cnt.argmax()), n=n)


class WirePlan:
    """The pair and quad preps of one group (each only if asked for at
    construction) and its byte counts, from one native pass run at the
    first ask; the numpy preps when the library cannot be had."""

    def __init__(self, chunk: np.ndarray, pair: bool = True, quad: bool = True):
        self.src = np.ascontiguousarray(chunk, np.uint8)
        self.want = (pair, quad)
        self._done = False
        self._res = None       # (byte counts, pair plan, quad plan)

    def _run(self):
        if not self._done:
            self._done = True
            with _lock:
                lib = _load()
            if lib is not None:
                self._res = _native_pass(lib, self.src, *self.want)
            with _lock:
                counts["python" if self._res is None else "native"] += 1
        return self._res

    @property
    def byte_counts(self) -> np.ndarray | None:
        """The group's 256 byte counts (int64); None from the numpy preps."""
        r = self._run()
        return None if r is None else r[0]

    def pair(self, table_log: int = 0):
        """pair.prep_pair_group(chunk, table_log)."""
        if not self.want[0]:
            raise ValueError("the pair wire was not planned")
        r = self._run()
        if r is None:
            return pair_mod.prep_pair_group(self.src, table_log)
        if r[1] is None:
            return None
        flags = pair_mod.FLAG_PAIR | (pair_mod.FLAG_PAIRESC
                                      if r[1]["esc_id"] is not None else 0)
        return _prep(r[1], table_log or pair_mod.PAIR_TABLELOG, "pairs",
                     pair_mod._pair_sections, flags, len(self.src))

    def quad(self, table_log: int = 0):
        """quad.prep_quad_group(chunk, table_log)."""
        if not self.want[1]:
            raise ValueError("the quad wire was not planned")
        r = self._run()
        if r is None:
            return quad_mod.prep_quad_group(self.src, table_log)
        if r[2] is None:
            return None
        return _prep(r[2], table_log or quad_mod.QUAD_TABLELOG, "quads",
                     quad_mod._quad_sections, quad_mod.FLAG_QUAD, len(self.src))
