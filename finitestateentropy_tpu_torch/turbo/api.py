"""TurboRANS entry points on the GPU: whole-buffer compress / decompress.

The port of the JAX package's turbo/api.py: the speed-mode wires byte,
pair (turbo/pair.py) and quad (turbo/quad.py) with the auto pick between
them that the default flags make per group; ratio mode (v1 frames, no
section: steptots=False); the totals wire (FLAG_TOTALS: totals_only=True);
and the TurboRANS-U16 codec for 16-bit symbol alphabets
(turbo16_compress_device / turbo16_decompress_device, turbo/rans16.py).
Host side does per-group stats and table packing (histogram,
normalization, NCount; the pair / quad alphabets, ids and escapes in one
native pass, turbo/wire_plan.py); the coder chains run in the CUDA kernels
behind rans_kernels.py.  Groups of one wire, padded size and tableLog batch
into one launch.  Frames are byte-identical to the JAX package's for the
same flags.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

from ..refimpl.hist import hist_count
from ..refimpl.ncount import fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from ..parallel.mesh import Mesh, get_mesh
from ..parallel.turbo_dp import (sharded_turbo_decode, sharded_turbo_decode_v2,
                                 sharded_turbo_encode, sharded_turbo_encode_v2)
from ..utils import profiler_tls
from ..utils.debug import debuglog
from ..utils.trace import collecting, span
from .format import TURBO_LANES, _pad_n
from .pair import predicted_bits
from .quad import _pad_q
from .rans import (FLAG_QUAD, FLAG_RAW, FLAG_RLE, FLAG_ROWS4, FLAG_STEPTOTS,
                   FLAG_TOTALS, RANS_MAGIC, RANS_SPEED_TABLELOG,
                   RANS_TABLELOG, _HDR, _pack_rows4, parse_rans_group)
from .rans16 import (FLAG_STEPTOTS as FL16_STEPTOTS, RANS16_MAGIC,
                     RANS16_MAX_SYMBOL, RANS16_STEP_SYMS, _HDR as HDR16,
                     _pad_n16, parse_rans16_group, rans16_compress)
from .rans_kernels import (SPC, rans_decode, rans_decode_v2, rans_decode_w,
                           rans_encode, rans_encode2)
from .state import resolve_device, to_tensors
from .tables import (pack_pair_dtable, pack_quad_dtable, pack_rans16_ctables,
                     pack_rans16_dtable, pack_rans16x_ctables,
                     pack_rans16x_dtable, pack_rans_ctables,
                     pack_rans_dtable, stream_word_rows,
                     tch_of, v2_pick_nway)
from .wire_plan import WirePlan

DEFAULT_GROUP = 1 << 20
MAX_GROUP = 4 << 20   # the JAX encoder's VMEM bound; kept: it shapes frames

# auto dispatch gives the multi-byte wires this much predicted-size slack
# over the best candidate: the measured trades on p80 1 MiB groups (v5e,
# tools/probe_r5.py) are -2.8% ratio for 2.0x decode (pair@9: 37.5 GB/s)
# and -6.4% for 2.6x (quad@10: 47.6 GB/s) vs the byte wire's 18.5 @ 8.30
# — the reference itself ships Huff0 at -28% ratio for 3x (README.md:32-33)
PAIR_RATIO_GIVE = 0.07

# Seconds per entry-point stage (c_prep, c_stage, c_h2d, c_kernel, c_d2h,
# c_frames; d_parse, d_stage, d_h2d, d_kernel, d_d2h, d_copy, d_join),
# summed while this is a dict; None turns the timing off.  Apart from it,
# each stage is a span "turbo.<stage>" (utils/trace.py) that a running
# torch.profiler records, with no sync; no profiler, no span.
stage_seconds: dict[str, float] | None = None


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _hrows_cap(n_pad: int) -> int:
    # <= 1 halfword per symbol; round rows to a multiple of 8 + slack
    return _round8((n_pad + 127) // 128 + 16)


def _mesh_of(mesh, dev: torch.device) -> Mesh | None:
    """The entry points' mesh: a Mesh as given, else get_mesh(mesh)."""
    return mesh if isinstance(mesh, Mesh) else get_mesh(mesh, dev)


def _pad_groups(arrs, m: int):
    """Pad leading group dim to a multiple of m (dup of last group)."""
    G = arrs[0].shape[0]
    pad = (-G) % m
    if pad == 0:
        return arrs
    return [np.concatenate([a] + [a[-1:]] * pad, axis=0) for a in arrs]


def _prep_group(chunk: np.ndarray, table_log: int = RANS_TABLELOG):
    """Host stats for one group; returns None for RLE/raw-destined groups
    (RLE when every byte is equal; raw when near-uniform, the reference's
    maxCount <= srcSize>>7 heuristic, fse_compress.c:653-655)."""
    n = len(chunk)
    count, max_sv, max_count = hist_count(chunk, 255)
    if max_count == n or max_count <= (n >> 7):
        return None
    tlog = min(table_log, fse_optimal_table_log(table_log, n, max_sv))
    norm, tlog = fse_normalize_count(tlog, count[: max_sv + 1], n, max_sv)
    if tlog != table_log:
        # re-normalize at the requested static tableLog (always legal for
        # group-scale inputs)
        norm, tlog = fse_normalize_count(table_log, count[: max_sv + 1], n, max_sv)
    ncount = fse_write_ncount(norm, max_sv, tlog)
    mfs = int(count.argmax())
    return np.asarray(norm, np.int32), max_sv, ncount, mfs


def prep_group(chunk: np.ndarray, table_log: int = RANS_TABLELOG):
    """_prep_group through the native C library when it is built (the same
    stats); _prep_group when it is not, or answers "fallback"."""
    from .. import native

    if native.available():
        r = native.prep_group_native(bytes(chunk), table_log)
        if r != "fallback":
            return r  # stats tuple, or None for RLE groups
    return _prep_group(chunk, table_log)


@contextmanager
def _stage(name: str, dev: torch.device):
    """Add the wall seconds of the enclosed stage to stage_seconds[name]
    while stage_seconds is a dict; the stage then ends in a device sync,
    so kernel time lands in its own stage.  Off (None), it adds no sync.
    Either way the stage is the span "turbo.<name>" (the sync inside it)."""
    with span("turbo." + name):
        if stage_seconds is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stage_seconds[name] = (stage_seconds.get(name, 0.0)
                               + time.perf_counter() - t0)


def _map(fn, items, name: str) -> list:
    """fn over items, threaded across cores (numpy's bulk ops release the
    GIL); every result is read, so a worker's exception is raised.  With a
    profiler collecting on the calling thread (checked once), _map_traced
    names each item "turbo.pool.<name>"; without one, nothing is added."""
    workers = min(len(items), os.cpu_count() or 1)
    if collecting():
        return _map_traced(fn, items, name, workers)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, items))
    return [fn(it) for it in items]


def _map_traced(fn, items, name: str, workers: int) -> list:
    """_map under a profiler: each item is the span "turbo.pool.<name>" on
    the thread that runs it, a pool worker entering the caller's profiler
    state for it (utils/profiler_tls.py; without that library the workers'
    spans are dropped), and the items' wall and CPU seconds, read around fn
    on that thread, are added to pool_seconds."""
    label, times = "turbo.pool." + name, []
    state = profiler_tls.capture() if workers > 1 else None

    def item(it):
        with profiler_tls.joined(state), span(label):
            t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
            try:
                return fn(it)
            finally:
                times.append((time.perf_counter_ns() - t0,
                              time.thread_time_ns() - c0))

    try:
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(item, items))
        return [item(it) for it in items]
    finally:
        profiler_tls.release(state)
        with _counts_lock:
            pool_seconds["calls"] += 1
            pool_seconds["items"] += len(times)
            pool_seconds["wall"] += sum(w for w, _c in times) / 1e9
            pool_seconds["cpu"] += sum(c for _w, c in times) / 1e9


def _wire_ests(ch: np.ndarray, prep_byte, tlog_byte: int, pp, qp,
               byte_counts=None):
    """Predicted group sizes (payload + per-wire sections; the 4 KiB init
    and 16 B header are wire-independent and cancel) for the byte wire and
    — when eligible — the pair (order-1) and quad (order-3) wires.
    byte_counts: the group's 256 byte counts where a plan has them
    (wire_plan.WirePlan), else they are counted here."""
    n = len(ch)
    norm_b, max_sv, ncount_b, _mfs = prep_byte
    if byte_counts is None:
        byte_counts = np.bincount(ch, minlength=max_sv + 1)
    counts_b = byte_counts[: max_sv + 1]
    # 4 B/step rows4 steptots assumed on every side (cancels any bias)
    ests = {"byte": (predicted_bits(norm_b, counts_b, tlog_byte) / 8
                     + len(ncount_b) + 4 * (_pad_n(n) // TURBO_LANES))}
    if pp is not None:
        ests["pair"] = (predicted_bits(pp["norm"], pp["counts"], pp["tlog"])
                        / 8 + len(pp["sections"])
                        + 4 * (_pad_n16((n + 1) // 2) // TURBO_LANES))
    if qp is not None:
        ests["quad"] = (predicted_bits(qp["norm"], qp["counts"], qp["tlog"])
                        / 8 + len(qp["sections"])
                        + 4 * (_pad_q((n + 3) // 4) // TURBO_LANES))
    return ests


def _pick_wire(ch: np.ndarray, prep_byte, tlog_byte: int, pp, qp,
               pair_mode: int, quad_mode: int, byte_counts=None) -> str:
    """Auto dispatch across the byte / pair / quad wires: the FASTEST
    eligible wire whose predicted size is within PAIR_RATIO_GIVE of the
    best candidate wins (quad decodes 4 bytes/step, pair 2, byte 1 —
    the same speed-for-ratio call the reference makes shipping Huff0,
    README.md:32-33).  Force modes (mode == 1) shortcut the estimate."""
    if quad_mode == 1 and qp is not None:
        return "quad"
    if pair_mode == 1 and pp is not None:
        return "pair"
    ests = _wire_ests(ch, prep_byte, tlog_byte,
                      pp if pair_mode != 0 else None,
                      qp if quad_mode != 0 else None, byte_counts)
    best = min(ests.values())
    for wire in ("quad", "pair"):        # fastest first
        if wire in ests and ests[wire] <= best * (1 + PAIR_RATIO_GIVE):
            return wire
    return "byte"


def _wire_pad(wire: str, n: int) -> int:
    """A group of n bytes padded to whole supercycles, counted in the
    wire's symbols (bytes, pairs or quads)."""
    if wire == "quad":
        return _pad_q((n + 3) // 4)
    if wire == "pair":
        return _pad_n16((n + 1) // 2)
    return _pad_n(n)


def _wire_t4(wire: str, n_pad: int) -> int:
    """Supercycles (source / output words per lane) of a padded group."""
    return n_pad // (TURBO_LANES * SPC[wire])


def group_spans(n: int, group_size: int) -> list[tuple[int, int]]:
    """(start, length) of each group of an n-byte buffer; a ragged
    multi-MiB tail whose PADDED size breaks the 1 MiB chunking rule splits
    at its last 1 MiB boundary."""
    spans = [(i, min(group_size, n - i)) for i in range(0, n, group_size)]
    if group_size > DEFAULT_GROUP and spans and spans[-1][1] > DEFAULT_GROUP \
            and _pad_n(spans[-1][1]) % DEFAULT_GROUP:
        st, ln = spans.pop()
        cut = ln // DEFAULT_GROUP * DEFAULT_GROUP
        spans += [(st, cut), (st + cut, ln - cut)]
    return spans


def split_groups(src: np.ndarray, group_size: int) -> list[np.ndarray]:
    """Cut a buffer into groups (group_spans)."""
    return [src[st : st + ln] for st, ln in group_spans(len(src), group_size)]


# per wire: (symbol dtype, encode-table chunks, table packer); the U16
# codec's wires are u16 (symbols <= 1023) and u16x (the wide tables)
_ENC_WIRE = {"byte": (np.uint8, 2, pack_rans_ctables),
             "pair": (np.uint16, 2, pack_rans_ctables),
             "quad": (np.uint32, 2, pack_rans_ctables),
             "u16": (np.uint16, 8, pack_rans16_ctables),
             "u16x": (np.uint16, 32, pack_rans16x_ctables)}


def _stage_wire_batch(wire: str, items, n_pad: int):
    """(fc, magic, src_words) numpy inputs of the encode entries for a
    batch of (gi, chunk, prep) items of one wire and padded size (in the
    wire's symbols).  prep is the prep_group tuple (byte), the
    prep_pair_group / prep_quad_group dict (pair, quad: the group's ids
    are coded) or the _prep16_group tuple (u16, u16x).  Each group pads
    with its most frequent symbol or id: that keeps the final states,
    hence the frame, equal to the twin's."""
    G = len(items)
    dtype, nch, pack = _ENC_WIRE[wire]
    rows = n_pad * np.dtype(dtype).itemsize // 512   # 128 words of 4 bytes
    fc = np.zeros((G, nch, 128), np.int32)
    mg = np.zeros((G, nch, 128), np.int32)
    srcw = np.zeros((G, rows, 128), np.int32)

    def stage(j):
        _gi, ch, prep = items[j]
        if wire in ("pair", "quad"):
            norm, syms, fill = prep["norm"], prep["ids"], prep["mfi"]
        else:
            norm, syms, fill = prep[0], ch, prep[3]
        fc[j], mg[j] = pack(norm)  # layout is tlog-agnostic
        pad = np.full(n_pad, fill, dtype)
        pad[: len(syms)] = syms
        srcw[j] = pad.view("<u4").view(np.int32).reshape(rows, 128)

    _map(stage, range(G), "stage")
    return fc, mg, srcw


# a wire's encode inputs: STAGE_BATCH[wire](items, n_pad)
STAGE_BATCH = {w: partial(_stage_wire_batch, w) for w in _ENC_WIRE}


def _raw_frame(n: int, data: bytes) -> bytes:
    """A group stored as it is (FLAG_RAW)."""
    return _HDR.pack(RANS_MAGIC, n, 0, 0, FLAG_RAW, 0) + data


def plan_encode(data: bytes, group_size: int, table_log: int, pair: int = -1,
                quad: int = -1, pair_table_log: int = 0,
                quad_table_log: int = 0):
    """Cut data into groups, prep each one and pick its wire: returns (group
    count, {gi: frame} of the RLE and raw groups, {(wire, n_pad, tlog):
    [(gi, chunk, prep)]}: the encode kernel's batches).  prep is the
    prep_group tuple on the byte wire, the prep_pair_group /
    prep_quad_group dict on the others."""
    chunks = split_groups(np.frombuffer(data, dtype=np.uint8), group_size)

    def full_prep(ch):
        """(wire, prep), or (None, None) for an RLE / raw group."""
        with span("turbo.prep.byte"):
            p = prep_group(ch, table_log)
        if p is None:
            return None, None
        pp = qp = None
        # one native pass plans both wires, in the span of the first to ask
        plan = WirePlan(ch, pair != 0, quad != 0)
        if pair != 0:
            with span("turbo.prep.pair"):
                pp = plan.pair(pair_table_log)
        if quad != 0:
            with span("turbo.prep.quad"):
                qp = plan.quad(quad_table_log)
        if pp is None and qp is None:        # no other wire to weigh
            return "byte", p
        with span("turbo.prep.pick"):
            wire = _pick_wire(ch, p, table_log, pp, qp, pair, quad,
                              plan.byte_counts)
        return wire, {"byte": p, "pair": pp, "quad": qp}[wire]

    preps = _map(full_prep, chunks, "prep")
    frames: dict[int, bytes] = {}
    batches: dict[tuple[str, int, int], list] = {}
    for gi, (ch, (wire, prep)) in enumerate(zip(chunks, preps)):
        if prep is None:
            if (ch == ch[0]).all():  # RLE
                frames[gi] = _HDR.pack(RANS_MAGIC, len(ch), 0, 0, FLAG_RLE, 0) \
                    + bytes([ch[0]]) + b"\0" * 3
            else:                    # near-uniform: straight to raw
                frames[gi] = _raw_frame(len(ch), ch.tobytes())
            continue
        tlog = table_log if wire == "byte" else prep["tlog"]
        batches.setdefault((wire, _wire_pad(wire, len(ch)), tlog), []).append(
            (gi, ch, prep))
    return len(chunks), frames, batches


def _encode_frame(n: int, raw, tlog: int, flags: int, nc_len: int,
                  head: bytes, csize: int, words: np.ndarray, fin: np.ndarray,
                  stots: np.ndarray, sect_kind: str | None) -> bytes:
    """One byte-wire group's frame from the encode kernel's outputs, for
    the host entries and the resident pipeline alike: n the group's length
    and raw() its bytes, called only when the frame falls back to raw;
    head is what lies between the header and the init states (the padded
    NCount; pair and quad add their LUT and escapes); sect_kind the
    section after the init states: "rows" (FLAG_STEPTOTS, ROWS4-packed
    when smaller), "totals" (FLAG_TOTALS) or None (ratio mode, v1).  Raw
    when the frame would not be smaller than the group."""
    # wire payload bytes ARE the packed words little-endian
    payload = words.tobytes()[: 2 * csize]
    if sect_kind == "rows":
        packed = _pack_rows4(stots)
        if packed is not None:
            sect, fl = packed, flags | FLAG_STEPTOTS | FLAG_ROWS4
        else:
            sect, fl = stots.reshape(-1).tobytes(), flags | FLAG_STEPTOTS
    elif sect_kind == "totals":
        # 1 u16 per step (T % 4 == 0 keeps 4 B alignment)
        sect = stots.astype(np.uint16).sum(axis=1).astype("<u2").tobytes()
        fl = flags | FLAG_TOTALS
    else:
        sect, fl = b"", flags
    blob = (_HDR.pack(RANS_MAGIC, n, csize, tlog, fl, nc_len)
            + head
            + fin.reshape(-1).view(np.uint32).astype("<u4").tobytes()
            + sect
            + payload)
    if len(blob) >= n + _HDR.size:
        blob = _raw_frame(n, raw())
    return blob


def _sect_kind(steptots: bool, totals_only: bool) -> str | None:
    """The section _encode_frame writes after the init states."""
    return ("totals" if totals_only else "rows") if steptots else None


def _frame_head(wire: str, prep) -> tuple[int, int, bytes]:
    """(flags, ncount length, head bytes) of a group's frame."""
    if wire == "byte":
        ncount = prep[2]
        return 0, len(ncount), ncount + b"\0" * (-len(ncount) % 4)
    return prep["flags"], prep["nc_len"], prep["sections"]


def mode_flags(table_log: int, steptots: bool, totals_only: bool,
               pair: int, quad: int) -> tuple[int, int, int]:
    """(table_log, pair, quad) as turbo_compress_device applies its flag
    rules (JAX api.py:178-188): table_log 0 is the mode default (10 speed,
    11 ratio); the totals wire has no multi-byte variants; ratio mode has
    no quad wire and drops the auto pair pick (an explicit pair=1 stays)."""
    if table_log == 0:
        table_log = RANS_SPEED_TABLELOG if steptots else RANS_TABLELOG
    if totals_only:
        pair = quad = 0
    if not steptots:
        quad = 0
        if pair == -1:
            pair = 0
    return table_log, pair, quad


def check_byte_args(table_log: int, group_size: int) -> None:
    """Raise ValueError unless the byte-path compress can take table_log
    (its tables have 12-bit freq and cumul fields) and group_size (the JAX
    encoder's budget and 1 MiB chunking, which shape the frames)."""
    if not 5 <= table_log <= 12:
        raise ValueError(f"byte-path tableLog must be in [5, 12], got {table_log}")
    if group_size > MAX_GROUP:
        raise ValueError(
            f"group_size {group_size} exceeds the encode kernel's budget; "
            f"use <= {MAX_GROUP}")
    if group_size > DEFAULT_GROUP and group_size % DEFAULT_GROUP:
        raise ValueError(
            "group sizes above 1 MiB must be a multiple of 1 MiB "
            "(the encode kernel chunks src reads in 1 MiB spans)")


def turbo_compress_device(data: bytes, group_size: int = DEFAULT_GROUP,
                          interpret: bool = False,
                          table_log: int = 0,
                          steptots: bool = True, mesh: int | Mesh = 0,
                          totals_only: bool = False,
                          pair: int = -1,
                          pair_table_log: int = 0,
                          quad: int = -1,
                          quad_table_log: int = 0,
                          device=None) -> bytes:
    """Compress with the TurboRANS encode kernel.

    Frames equal the JAX package's turbo_compress_device with the same
    flags.  steptots=True (speed mode) ships per-step renorm counts for the
    rows-wire decode; False is ratio mode (v1 frames, no section).
    totals_only=True ships one u16 total per step instead (FLAG_TOTALS).
    table_log=0 = the mode default (10 speed / 11 ratio).  pair / quad
    select the multi-byte wires (turbo/pair.py order-1 — 2 bytes per
    decode step; turbo/quad.py order-3 — 4 bytes per step): -1 (default)
    auto-picks per group the FASTEST wire whose predicted size is within
    PAIR_RATIO_GIVE of the best candidate; 0 disables; 1 forces when
    eligible (quad beats pair when both are forced).  The totals wire has
    no multi-byte variants and quad is speed-mode only, so totals_only
    turns both off and ratio mode turns quad and the auto pair off (an
    explicit pair=1 is kept).  pair_table_log / quad_table_log = 0 pick
    the wire defaults.  mesh > 1 splits each batch's groups over that many
    devices (parallel/turbo_dp.py; the frames are the same), or warns and
    runs on one device when fewer are attached; a parallel.mesh.Mesh is
    used as given (one of a single device still runs the sharded steps).
    interpret=True runs the plain PyTorch versions of the kernels on the
    device (the counterpart of a Pallas kernel's body in the interpreter;
    the frames are the same).  The parameters take the JAX entry's
    positional order, with device last.  device: torch device for the
    kernels; None = cuda (raises without one), "cpu" runs the plain
    PyTorch versions (a mesh of CPU entries, for the tests)."""
    with span("turbo.compress"):
        dev = resolve_device(device)
        mesh_obj = _mesh_of(mesh, dev)
        table_log, pair, quad = mode_flags(table_log, steptots, totals_only,
                                           pair, quad)
        check_byte_args(table_log, group_size)
        if len(data) == 0:
            return _raw_frame(0, b"")
        with _stage("c_prep", dev):
            n_groups, results, batches = plan_encode(
                data, group_size, table_log, pair, quad, pair_table_log,
                quad_table_log)
        sect_kind = _sect_kind(steptots, totals_only)

        for (wire, n_pad, tlog), items in batches.items():
            G = len(items)
            debuglog(3, "turbo encode: %s batch of %d groups, n_pad=%d, tlog=%d",
                     wire, G, n_pad, tlog)
            with _stage("c_stage", dev):
                fc, mg, srcw = STAGE_BATCH[wire](items, n_pad)
            t4, hcap = _wire_t4(wire, n_pad), _hrows_cap(n_pad)
            if mesh_obj is None:
                with _stage("c_h2d", dev):
                    ins = to_tensors(dev, fc_tables=fc, magic_tables=mg,
                                     src_words=srcw)
                rowloc, st = encode_placement(wire, steptots, None)
                with _stage("c_kernel", dev):
                    stream, fin, csize, stots = rans_encode2(
                        ins["fc_tables"], ins["magic_tables"], ins["src_words"],
                        t4, hcap, interpret, u16=wire == "pair", tlog=tlog,
                        steptots=st, rowloc=rowloc, quad=wire == "quad")
            else:
                with _stage("c_kernel", dev):
                    stream, fin, csize, stots = _mesh_encode(
                        mesh_obj, wire, fc, mg, srcw, t4, hcap, tlog, steptots,
                        interpret)
            with _stage("c_d2h", dev):
                csize = csize[:G].cpu().numpy()
                # the payload is the first csize halfwords: copy only the words used
                used = (int(csize.max()) + 1) // 2
                stream = stream[:G].reshape(G, -1)[:, :used].cpu().numpy()
                fin = fin[:G].cpu().numpy()
                stots = (stots[:G].cpu().numpy().astype(np.uint8) if sect_kind
                         else [None] * G)
            with _stage("c_frames", dev):
                for j, (gi, ch, prep) in enumerate(items):
                    results[gi] = _encode_frame(
                        len(ch), ch.tobytes, tlog, *_frame_head(wire, prep),
                        int(csize[j]), stream[j], fin[j], stots[j], sect_kind)
        return b"".join(results[gi] for gi in range(n_groups))


def encode_placement(wire: str, steptots: bool,
                     mesh_obj: Mesh | None) -> tuple[bool, bool]:
    """(rowloc, steptots) of a batch's rans_encode2 call.  On one device
    every wire takes the row-local placement and the caller's steptots.
    Under a mesh, as the JAX package's mesh branches (JAX api.py:288-309,
    :375-390, :447-460): byte groups take the flat placement and the
    caller's steptots; pair and quad groups the row-local one, always with
    step counts (ratio-mode pair frames drop them)."""
    if mesh_obj is None:
        return True, steptots
    if wire == "byte":
        return False, steptots
    return True, True


def _mesh_encode(mesh_obj, wire: str, fc, mg, srcw, t4: int, hcap: int,
                 tlog: int, steptots: bool, interpret: bool = False):
    """A batch's encode over the mesh, as the JAX package's mesh branches
    run it: the groups padded to a multiple of the mesh size, the
    placement and steptots of encode_placement.  Returns the gathered
    (stream, finals, csize, stots or None) of the padded batch."""
    rowloc, steptots = encode_placement(wire, steptots, mesh_obj)
    padded = _pad_groups([fc, mg, srcw], mesh_obj.devices.size)
    if not steptots:
        stream, fin, csize, _tot = sharded_turbo_encode(
            mesh_obj, t4, hcap, interpret, tlog)(*padded)
        return stream, fin, csize, None
    step = sharded_turbo_encode_v2(mesh_obj, t4, hcap, interpret, tlog,
                                   u16=wire == "pair", rowloc=rowloc,
                                   quad=wire == "quad")
    stream, fin, csize, stots, _tot = step(*padded)
    return stream, fin, csize, stots


def _window_dispatch(windows: int, t_count: int, hrows: int, tlog: int,
                     G: int, totals_only: bool, u16: bool = False,
                     u16x: bool = False, pair: bool = False,
                     quad: bool = False) -> tuple[int, int]:
    """Entry choice for a speed-wire decode batch, as the JAX package's
    (api.py:494-547) makes it, so a batch reaches the same entry there and
    here: returns (nway, S) for rans_decode_w, or (0, 0) for rans_decode_v2.

    windows > 1 forces rans_decode_w at that interleave (when the shape is
    eligible); windows == 1 forces rans_decode_v2; windows == 0 picks by
    the JAX package's TPU cost model: pair and quad batches go windowed
    whenever t_count is a multiple of 128//spc; byte and totals batches iff
    7*G >= nv*pad8(G), U16 batches iff 4.5*G >= nv*pad8(G), nv the
    resident decoder's interleave (v2_pick_nway)."""
    spc = 1 if quad else 2 if u16 else 4
    smin = 128 // spc
    if t_count % smin:
        return 0, 0          # group too small / misaligned for windows
    S = smin if quad else min(
        2 * smin if t_count % (2 * smin) == 0 else smin, 64)
    if windows == 1:
        return 0, 0
    if windows > 1:
        return windows, S
    if pair or quad:
        return 8, S
    nv = v2_pick_nway(t_count, hrows, tlog, u16, totals_only, u16x, pair)
    v2_width = 4.5 if u16 else 7
    if v2_width * G >= nv * ((G + 7) // 8 * 8):
        return 8, S
    return 0, 0


_DTABLE = {"byte": lambda g, tlog: pack_rans_dtable(g[4], tlog),
           "pair": lambda g, tlog: pack_pair_dtable(g[4], g[9], tlog),
           "quad": lambda g, tlog: pack_quad_dtable(g[4], g[9], tlog),
           "u16": lambda g, tlog: pack_rans16_dtable(g[4], tlog),
           "u16x": lambda g, tlog: pack_rans16x_dtable(g[4], tlog)}

# stage_decode_batch's calls and the groups they staged, summed
stage_counts = {"batches": 0, "groups": 0}
# the decode batches and their groups by the route that decoded them:
# "flat" (v1 groups, rans_decode), "v2" (rans_decode_v2), "w"
# (rans_decode_w), "mesh" (_mesh_decode), summed
decode_routes = {r: {"batches": 0, "groups": 0}
                 for r in ("flat", "v2", "w", "mesh")}
# the items of the _map calls made under a profiler (_map_traced): calls,
# items, and the items' wall and CPU seconds on the threads that ran them,
# summed; the CPU share of the wall tells work from waits on the GIL
pool_seconds = {"calls": 0, "items": 0, "wall": 0.0, "cpu": 0.0}
_counts_lock = threading.Lock()


def _count(counts: dict, groups: int) -> None:
    """Add one batch of `groups` groups to counts (stage_counts, or a route
    of decode_routes)."""
    with _counts_lock:
        counts["batches"] += 1
        counts["groups"] += groups


def _fill_dtables(tbl: np.ndarray, groups, idxs, tlog: int, wire: str) -> None:
    """Write the batch's decode tables into tbl [G, tch_of(wire, tlog),
    128] (zeroed), equal to _DTABLE[wire] group by group, in one pass over
    the batch: the norms stacked into [G, A] freqs (zero freqs pad the
    shorter alphabets and own no slot), each symbol's fields packed once,
    and one np.repeat mapping every slot of every group to its symbol
    for the gathers.  A batch holding a norm the parsers never give (its
    freqs not summing to 2^tlog, or a field the wire cannot pack) goes to
    the per-group packers, which give the old result or raise the old
    exception."""
    G, m = len(idxs), 1 << tlog
    norms = [groups[i][4] for i in idxs]
    A = max(len(nm) for nm in norms)
    freq = np.zeros((G, A), np.int64)
    for j, nm in enumerate(norms):
        freq[j, : len(nm)] = nm
    freq[freq == -1] = 1                         # low-probability symbols
    cumul = np.cumsum(freq, axis=1)
    if (wire in ("pair", "quad") and tlog > 12 or wire == "u16x" and m % 128
            or freq.min() < 0 or (cumul[:, -1] != m).any()):
        for j, i in enumerate(idxs):
            tbl[j] = _DTABLE[wire](groups[i], tlog)
        return
    cumul -= freq
    sym = np.arange(A)
    at = np.repeat(np.arange(G * A), freq.reshape(-1)).reshape(G, m)

    def per_slot(field):
        """A field of each group's symbols ([G, A] or [A]) at each slot."""
        return np.broadcast_to(field, (G, A)).reshape(-1)[at]

    flat = tbl.reshape(G, -1)
    if wire in ("byte", "u16"):
        c_at, f_at = (20, 8) if wire == "byte" else (21, 10)
        e = per_slot((cumul << c_at) | (freq << f_at) | sym)
        flat[:, :m] = e.astype(np.uint32).view(np.int32)
    elif wire == "u16x":                         # e1 plane, then symbols
        e1 = per_slot(freq << 13) | (np.arange(m) - per_slot(cumul))
        flat[:, :m] = e1.astype(np.int32)
        flat[:, m : 2 * m] = per_slot(sym)
    else:                                        # pair, quad: + the id LUT
        e = (per_slot((sym << (2 * tlog)) | (freq << tlog))
             | (np.arange(m) - per_slot(cumul)))
        flat[:, :m] = e.astype(np.int32)
        lut = np.zeros((G, 256), np.int32 if wire == "pair" else "<u4")
        for j, i in enumerate(idxs):
            ids = groups[i][9]
            lut[j, : len(ids)] = ids
        lo = max(m // 128, 1) * 128
        flat[:, lo : lo + 256] = lut.view(np.int32)


def stage_decode_batch(groups, idxs, n_pad: int, tlog: int,
                       wire: str = "byte", kind: int = 2):
    """numpy inputs of the decode entries for a batch of parsed groups of
    one wire (byte, pair, quad; u16, u16x for the U16 codec), padded size
    (in the wire's symbols), tableLog and section kind (plan_decode,
    plan_decode16): (csize_hw, tables, init_states, streams, steptots, t4,
    hrows), steptots [G,T,8] (kind 2), [G,T] (kind 1) or None (v1).
    Staged on the calling thread: the tables in one pass over the batch
    (_fill_dtables), then one pass of slice copies into the batch arrays;
    a wire payload is already the packed word layout, so its bytes go
    straight into the words, and the words past it are zeroed.  Counted
    in stage_counts."""
    G = len(idxs)
    _count(stage_counts, G)
    t4 = _wire_t4(wire, n_pad)
    hrows = _round8(max((groups[i][1] + 127) // 128 for i in idxs) + 16)
    T = n_pad // TURBO_LANES
    srows = stream_word_rows(hrows)
    tbl = np.zeros((G, tch_of(wire, tlog), 128), np.int32)
    init = np.zeros((G, 8, 128), np.int32)
    hws = np.empty((G, srows, 128), np.int32)   # every word written below
    cs = np.zeros(G, np.int32)
    tots = (None if kind == 0 else
            np.empty((G, T) if kind == 1 else (G, T, 8), np.int32))
    _fill_dtables(tbl, groups, idxs, tlog, wire)
    words = hws.reshape(G, -1).view(np.uint8)
    for j, i in enumerate(idxs):
        g = groups[i]
        init[j] = g[6].view(np.int32).reshape(8, 128)
        payload = np.frombuffer(g[7], np.uint8)
        words[j, : len(payload)] = payload
        words[j, len(payload) :] = 0
        cs[j] = g[1]
        if kind:
            tots[j] = g[8]
    return cs, tbl, init, hws, tots, t4, hrows


def parse_groups(blob: bytes, parse=parse_rans_group) -> list:
    """Every group of a TurboRANS stream, parsed in place by parse
    (parse_rans_group; parse_rans16_group for a U16 stream): each group's
    parser reads a view of blob at the group's offset, so a payload (a raw
    group's bytes too) is a memoryview of blob, and no group copies the
    rest of the stream."""
    view, groups, pos = memoryview(blob), [], 0
    while pos < len(view):
        g, used = parse(view[pos:])
        groups.append(g)
        pos += used
    return groups


def plan_decode(groups):
    """(offsets, {(wire, n_pad, tlog, kind): [i]}: the decode entries'
    batches).  offsets [len(groups) + 1] int64: group i's bytes lie at
    offsets[i] : offsets[i + 1] of the output.  The raw and RLE groups join
    no batch.  kind is the section: 0 none (v1, ratio mode), 1 FLAG_TOTALS
    step totals, 2 FLAG_STEPTOTS row counts."""
    offs = np.zeros(len(groups) + 1, np.int64)
    batches: dict[tuple[str, int, int, int], list[int]] = {}
    for i, g in enumerate(groups):
        n, tlog, flags, steptots = g[0], g[2], g[3], g[8]
        offs[i + 1] = offs[i] + n
        if not flags & (FLAG_RAW | FLAG_RLE):
            wire = ("byte" if len(g) == 9
                    else "quad" if flags & FLAG_QUAD else "pair")
            kind = 0 if steptots is None else steptots.ndim
            batches.setdefault((wire, _wire_pad(wire, n), tlog, kind),
                               []).append(i)
    return offs, batches


# A decompress's output lands in a host buffer laid out as the output, one
# copy of which is the returned bytes.  Each thread keeps its own (pinned
# where the decode runs on CUDA, so a batch's rows arrive by DMA), grown to
# the largest output seen and never shrunk: pinning costs milliseconds, so a
# buffer is allocated only as the output outgrows it.  An output above
# STAGING_MAX takes a plain buffer of the call's own.
STAGING_MAX = 256 << 20
# the calls by the buffer they took ("pinned" or "host": the thread's kept
# buffer; "over_cap": their own) and the kept buffers allocated ("grown"),
# summed
output_staging = {"pinned": 0, "host": 0, "over_cap": 0, "grown": 0}
_staging = threading.local()


def _output_buffer(total: int, pinned: bool) -> torch.Tensor:
    """A uint8 host tensor of at least total bytes for one decompress's
    output: the calling thread's kept buffer, grown in whole MiB when the
    output outgrows it; above STAGING_MAX one of the call's own.  Counted
    in output_staging."""
    if total > STAGING_MAX:
        key, grown, buf = "over_cap", False, torch.empty(total, dtype=torch.uint8)
    else:
        key = "pinned" if pinned else "host"
        bufs = _staging.__dict__.setdefault("bufs", {})
        buf = bufs.get(key)
        grown = buf is None or buf.numel() < total
        if grown:
            bufs[key] = None                 # free the old one first
            buf = bufs[key] = torch.empty(-(-total >> 20) << 20,
                                          dtype=torch.uint8, pin_memory=pinned)
    with _counts_lock:
        output_staging[key] += 1
        output_staging["grown"] += grown
    return buf


def _pull_rows(outw: torch.Tensor, idxs, offs: np.ndarray,
               out: torch.Tensor) -> None:
    """Copy each group's bytes of a decode batch's output rows outw [>= G,
    rows, 128] to its place in out: only the n bytes a group owns, in one
    copy where the batch's groups lie back to back in the output and all
    but the last fill their rows, else in one a group.  Returns once the
    copies have landed."""
    G = len(idxs)
    rows = outw[:G].reshape(G, -1).view(torch.uint8)
    i0, i1 = idxs[0], idxs[-1]
    if i1 - i0 == G - 1 and (np.diff(offs[i0 : i1 + 1]) == rows.shape[1]).all():
        lo, hi = int(offs[i0]), int(offs[i1 + 1])
        out[lo:hi].copy_(rows.reshape(-1)[: hi - lo], non_blocking=True)
    else:
        for j, i in enumerate(idxs):
            lo, hi = int(offs[i]), int(offs[i + 1])
            out[lo:hi].copy_(rows[j, : hi - lo], non_blocking=True)
    if rows.is_cuda:
        torch.cuda.current_stream(rows.device).synchronize()


def patch_escapes(g, seg: np.ndarray) -> None:
    """Write a pair or quad group's escaped values (g[10]: word positions
    and values) into seg, the group's n decoded bytes at any alignment:
    whole words through an unaligned view, a final partial word (n not a
    multiple of the word) byte by byte, so no byte past n is written."""
    if g[10] is None or not len(g[10][0]):
        return
    w = 4 if g[3] & FLAG_QUAD else 2
    pos, vals = g[10]
    n = len(seg)
    whole = pos < n // w
    seg[: n // w * w].view(f"<u{w}")[pos[whole]] = vals[whole]
    if not whole.all():              # the partial word's last value wins
        tail = np.array(vals[~whole][-1:], f"<u{w}").view(np.uint8)
        seg[n // w * w :] = tail[: n % w]


def _write_direct(groups, offs: np.ndarray, out: np.ndarray) -> None:
    """The raw and RLE groups' bytes, from the frame, and the pair and quad
    groups' escapes, into their places in out."""
    for i, g in enumerate(groups):
        flags, seg = g[3], out[offs[i] : offs[i + 1]]
        if flags & FLAG_RAW:
            seg[:] = np.frombuffer(g[7], np.uint8)
        elif flags & FLAG_RLE:
            seg[:] = g[7][0]
        elif len(g) == 11:
            patch_escapes(g, seg)


def _decode_batch(wire: str, args, steptots, t4: int, hrows: int, tlog: int,
                  windows: int, interpret: bool = False):
    """One decode batch on one device, for every wire (byte, pair, quad,
    u16, u16x) and every entry point: v1 groups (steptots None) through
    rans_decode, the others through the entry _window_dispatch picks
    (windows=1: rans_decode_v2).  args: (csize_hw, tables, init_states,
    streams) tensors.  Counted in decode_routes."""
    modes = dict(u16=wire in ("pair", "u16", "u16x"), u16x=wire == "u16x",
                 pair=wire == "pair")
    G = args[0].shape[0]
    if steptots is None:        # v1: rank and cursor chain in the kernel
        _count(decode_routes["flat"], G)
        return rans_decode(*args, t4, hrows, interpret, tlog=tlog, **modes)
    modes["quad"] = wire == "quad"
    w_nway, w_s = _window_dispatch(windows, t4, hrows, tlog, G,
                                   steptots.dim() == 2, **modes)
    if w_nway:
        debuglog(2, "turbo decode: rans_decode_w entry (windows=%d, t4=%d, "
                    "G=%d, wire=%s)", windows, t4, G, wire)
        _count(decode_routes["w"], G)
        return rans_decode_w(*args, steptots, t4, hrows, w_nway, tlog, w_s,
                             interpret, **modes)
    _count(decode_routes["v2"], G)
    return rans_decode_v2(*args, steptots, t4, hrows, interpret, tlog, **modes)


def _mesh_decode(mesh_obj, wire: str, cs, tbl, init, hws, tots, t4: int,
                 hrows: int, tlog: int, interpret: bool = False):
    """A decode batch over the mesh, as the JAX package's mesh branch runs
    it (JAX api.py:643-670): the groups padded to a multiple of the mesh
    size; v1 groups through rans_decode, the others through
    rans_decode_v2.  Returns the gathered (out, err) of the padded
    batch.  Counted in decode_routes["mesh"] (the groups before padding)."""
    is_pair = wire == "pair"
    m = mesh_obj.devices.size
    _count(decode_routes["mesh"], len(cs))
    if tots is None:
        step = sharded_turbo_decode(mesh_obj, t4, hrows, interpret, tlog,
                                    u16=is_pair, pair=is_pair)
        outw, err, _any = step(*_pad_groups([cs, tbl, init, hws], m))
    else:
        step = sharded_turbo_decode_v2(mesh_obj, t4, hrows, interpret, tlog,
                                       u16=is_pair, pair=is_pair,
                                       quad=wire == "quad")
        outw, err, _any = step(*_pad_groups([cs, tbl, init, hws, tots], m))
    return outw, err


def turbo_decompress_device(blob: bytes, interpret: bool = False,
                            mesh: int | Mesh = 0, windows: int = 0,
                            device=None) -> bytes:
    """Decompress a TurboRANS stream with the decode kernels.

    Decodes every wire the compressor writes: byte, pair and quad
    speed-mode groups and totals groups through rans_decode_v2 or
    rans_decode_w (windows picks the entry as the JAX package does, see
    _window_dispatch; both entries run the same CUDA kernel for a wire),
    and v1 groups (ratio mode, byte or pair) through rans_decode.  mesh > 1
    splits each batch's groups over that many devices, as
    turbo_compress_device does; there, as in the JAX package, speed-wire
    batches all go through rans_decode_v2.  Every group's bytes go straight
    to their place in the calling thread's output buffer (_output_buffer)
    and the result is one copy of it.  Raises ValueError on a corrupt
    group.  interpret, device: as turbo_compress_device."""
    with span("turbo.decompress"):
        dev = resolve_device(device)
        mesh_obj = _mesh_of(mesh, dev)
        with _stage("d_parse", dev):
            groups = parse_groups(blob)
            offs, batches = plan_decode(groups)
            out = _output_buffer(int(offs[-1]), dev.type == "cuda")

        for (wire, n_pad, tlog, kind), idxs in batches.items():
            G = len(idxs)
            debuglog(3, "turbo decode: %s batch of %d groups, n_pad=%d, tlog=%d, "
                     "sect_kind=%d", wire, G, n_pad, tlog, kind)
            # one batch from its staging through the host's wait for its
            # flags and rows: the batch's kernels start on the card inside
            # this span even where the trace places the device's clock a few
            # ms early (staging and uploads launch no kernel)
            with span("turbo.d_batch"):
                with _stage("d_stage", dev):
                    cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
                        groups, idxs, n_pad, tlog, wire, kind)
                if mesh_obj is not None:
                    with _stage("d_kernel", dev):
                        outw, err = _mesh_decode(mesh_obj, wire, cs, tbl, init,
                                                 hws, tots, t4, hrows, tlog,
                                                 interpret)
                else:
                    with _stage("d_h2d", dev):
                        ins = to_tensors(dev, csize_hw=cs, tables=tbl,
                                         init_states=init, streams=hws)
                        steptots = (to_tensors(dev, steptots=tots)["steptots"]
                                    if kind else None)
                    with _stage("d_kernel", dev):
                        outw, err = _decode_batch(wire, tuple(ins.values()),
                                                  steptots, t4, hrows, tlog,
                                                  windows, interpret)
                with _stage("d_d2h", dev):
                    err = err[:G].cpu().numpy()
                    if err.any():
                        raise ValueError(
                            f"turbo-rans device decode: corrupt groups {np.nonzero(err)[0]}")
                    _pull_rows(outw, idxs, offs, out)
        with _stage("d_copy", dev):
            _write_direct(groups, offs, out.numpy())
        with _stage("d_join", dev):
            return out.numpy()[: offs[-1]].tobytes()


# ---------------------------------------------------------------------------
# TurboRANS-U16 (fseU16-class workloads: 16-bit symbols <= 4095)
# ---------------------------------------------------------------------------


def _prep16_group(chunk: np.ndarray):
    """Host stats for one U16 group: (norm, tlog, ncount, mfs), or None for
    a group the numpy twin writes (empty, RLE, or a symbol above 4095,
    which the twin refuses).  Alphabets above 1023 need tableLog 12-13
    (fseU16.c:43-48); small groups shrink via FSE_optimalTableLog."""
    n = len(chunk)
    if n == 0 or int(chunk.max()) > RANS16_MAX_SYMBOL:
        return None
    count = np.bincount(chunk, minlength=4096)
    if int(count.max()) == n:
        return None
    max_sv = int(chunk.max())
    tlog_req = (RANS_TABLELOG if max_sv <= 1023
                else 12 if max_sv <= 2047 else 13)
    tlog_opt = min(tlog_req, fse_optimal_table_log(tlog_req, n, max_sv,
                                                   max_allowed=13))
    norm, tlog = fse_normalize_count(tlog_opt, count[: max_sv + 1], n, max_sv,
                                     max_table_log=13)
    ncount = fse_write_ncount(norm, max_sv, tlog)
    return np.asarray(norm), tlog, ncount, int(count.argmax())


def plan_encode16(symbols: np.ndarray, group_syms: int, steptots: bool):
    """Cut a u16 symbol array into groups and prep each: returns (group
    count, {gi: frame} of the groups the numpy twin writes, {(n_pad, big,
    tlog): [(gi, chunk, prep)]}: rans_encode's batches; big = symbols above
    1023, the wide tables)."""
    chunks = [symbols[i : i + group_syms]
              for i in range(0, max(len(symbols), 1), group_syms)]
    preps = _map(_prep16_group, chunks, "prep16")
    frames: dict[int, bytes] = {}
    batches: dict[tuple[int, bool, int], list] = {}
    for gi, (chunk, prep) in enumerate(zip(chunks, preps)):
        if prep is None:
            frames[gi] = rans16_compress(chunk, steptots)
            continue
        big = int(chunk.max()) > 1023
        batches.setdefault((_pad_n16(len(chunk)), big, prep[1]), []).append(
            (gi, chunk, prep))
    return len(chunks), frames, batches


def turbo16_compress_device(symbols: np.ndarray, group_syms: int = 1 << 19,
                            interpret: bool = False, steptots: bool = True,
                            device=None) -> bytes:
    """Compress a u16 symbol array (symbols <= 4095) with the TurboRANS-U16
    encode kernel.

    Frames equal the JAX package's turbo16_compress_device and the numpy
    twin rans16_compress.  steptots=True (speed mode) ships per-step
    renorm counts for the rows-wire decode; False is ratio mode (v1
    frames).  interpret, device: as turbo_compress_device."""
    dev = resolve_device(device)
    symbols = np.ascontiguousarray(symbols, dtype=np.uint16)
    n_groups, results, batches = plan_encode16(symbols, group_syms, steptots)
    for (n_pad, big, tlog), items in batches.items():
        G = len(items)
        debuglog(3, "turbo16 encode: batch of %d groups, n_pad=%d, big=%s",
                 G, n_pad, big)
        fc, mg, srcw = STAGE_BATCH["u16x" if big else "u16"](items, n_pad)
        ins = to_tensors(dev, fc_tables=fc, magic_tables=mg, src_words=srcw)
        stream, fin, csize, stots = rans_encode(
            ins["fc_tables"], ins["magic_tables"], ins["src_words"],
            n_pad // RANS16_STEP_SYMS, _round8(n_pad // 128 + 16), interpret,
            u16=True, tlog=tlog, steptots=steptots)
        csize = csize.cpu().numpy()
        # one halfword per entry: copy only the entries used
        stream = stream.reshape(G, -1)[:, : int(csize.max())].cpu().numpy()
        fin = fin.cpu().numpy()
        if steptots:
            stots = stots.cpu().numpy().astype(np.uint8)
        for j, (gi, chunk, (_norm, _tl, ncount, _mfs)) in enumerate(items):
            n = len(chunk)
            cs = int(csize[j])
            sect, fl = ((stots[j].reshape(-1).tobytes(), FL16_STEPTOTS)
                        if steptots else (b"", 0))
            blob = (HDR16.pack(RANS16_MAGIC, n, cs, tlog, fl, len(ncount))
                    + ncount + b"\0" * (-len(ncount) % 4)
                    + fin[j].reshape(-1).view(np.uint32).astype("<u4").tobytes()
                    + sect
                    + stream[j, :cs].astype("<u2").tobytes())
            if len(blob) >= 2 * n + HDR16.size:
                blob = HDR16.pack(RANS16_MAGIC, n, 0, 0, 1, 0) + chunk.tobytes()
            results[gi] = blob
    return b"".join(results[gi] for gi in range(n_groups))


def plan_decode16(groups):
    """({i: u16 array} of the raw and RLE groups, {(wire, n_pad, tlog,
    kind): [i]}: the decode entries' batches, keyed as plan_decode's).
    wire is u16, or u16x when the group has symbols above 1023 (the wide
    tables); kind 0 (v1, ratio mode) or 2 (FLAG_STEPTOTS row counts)."""
    pieces: dict[int, np.ndarray] = {}
    batches: dict[tuple[str, int, int, int], list[int]] = {}
    for i, g in enumerate(groups):
        n, _cs, tlog, flags, _norm, max_sv, _init, payload, stots = g
        if flags & 1:
            pieces[i] = np.frombuffer(payload, "<u2")
        elif flags & 2:
            pieces[i] = np.full(n, np.frombuffer(payload, "<u2")[0], np.uint16)
        else:
            wire = "u16x" if max_sv > 1023 else "u16"
            kind = 0 if stots is None else stots.ndim
            batches.setdefault((wire, _pad_n16(n), tlog, kind), []).append(i)
    return pieces, batches


def turbo16_decompress_device(blob: bytes, interpret: bool = False,
                              windows: int = 0, device=None) -> np.ndarray:
    """Decompress a TurboRANS-U16 stream with the decode kernels: speed
    frames through rans_decode_v2 or rans_decode_w (windows as in
    turbo_decompress_device), ratio frames through rans_decode.  Raises
    ValueError on a corrupt group.  interpret, device: as
    turbo_compress_device."""
    dev = resolve_device(device)
    groups = parse_groups(blob, parse_rans16_group)
    pieces, batches = plan_decode16(groups)
    for (wire, n_pad, tlog, kind), idxs in batches.items():
        debuglog(3, "turbo16 decode: %s batch of %d groups, n_pad=%d, "
                 "sect_kind=%d", wire, len(idxs), n_pad, kind)
        cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
            groups, idxs, n_pad, tlog, wire, kind)
        ins = to_tensors(dev, csize_hw=cs, tables=tbl, init_states=init,
                         streams=hws)
        steptots = to_tensors(dev, steptots=tots)["steptots"] if kind else None
        outw, err = _decode_batch(wire, tuple(ins.values()), steptots, t4,
                                  hrows, tlog, windows, interpret)
        err = err.cpu().numpy()
        if err.any():
            raise ValueError(
                f"turbo-u16 device decode: corrupt groups {np.nonzero(err)[0]}")
        outw = outw.cpu().numpy()
        for j, i in enumerate(idxs):
            pieces[i] = (outw[j].astype("<i4").reshape(-1)
                         .view(np.uint16)[: groups[i][0]].copy())
    if not pieces:
        return np.zeros(0, np.uint16)
    return np.concatenate([pieces[i] for i in range(len(groups))])
