"""TurboRANS entry points on the GPU: whole-buffer compress / decompress.

The port of the JAX package's turbo/api.py for the byte wire.  Host side
does per-group stats and table packing (histogram, normalization, NCount:
O(group) numpy); the coder chains run in the CUDA kernels behind
rans_kernels.py.  Groups of equal padded size batch into one launch.
Frames are byte-identical to the JAX package's for the same flags.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

from ..refimpl.hist import hist_count
from ..refimpl.ncount import fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from ..utils.debug import debuglog
from .format import TURBO_LANES, TURBO_STEP_SYMS, _pad_n
from .rans import (FLAG_RAW, FLAG_RLE, FLAG_ROWS4, FLAG_STEPTOTS, RANS_MAGIC,
                   RANS_SPEED_TABLELOG, RANS_TABLELOG, _HDR, _pack_rows4,
                   parse_rans_group)
from .rans_kernels import rans_decode_v2, rans_decode_w, rans_encode2
from .state import resolve_device, to_tensors
from .tables import (pack_rans_ctables, pack_rans_dtable, pack_stream_words,
                     stream_word_rows, v2_pick_nway)

DEFAULT_GROUP = 1 << 20
MAX_GROUP = 4 << 20   # the JAX encoder's VMEM bound; kept: it shapes frames

# Seconds per entry-point stage (c_prep, c_stage, c_h2d, c_kernel, c_d2h,
# c_frames; d_parse, d_stage, d_h2d, d_kernel, d_d2h, d_copy, d_join),
# summed while this is a dict; None turns the timing off.
stage_seconds: dict[str, float] | None = None


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _hrows_cap(n_pad: int) -> int:
    # <= 1 halfword per symbol; round rows to a multiple of 8 + slack
    return _round8((n_pad + 127) // 128 + 16)


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


@contextmanager
def _stage(name: str, dev: torch.device):
    """Add the wall seconds of the enclosed stage to stage_seconds[name]
    while stage_seconds is a dict; the stage then ends in a device sync,
    so kernel time lands in its own stage.  Off (None), it adds no sync."""
    if stage_seconds is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stage_seconds[name] = stage_seconds.get(name, 0.0) + time.perf_counter() - t0


def _map(fn, items) -> list:
    """fn over items, threaded across cores (numpy's bulk ops release the
    GIL); every result is read, so a worker's exception is raised."""
    workers = min(len(items), os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, items))
    return [fn(it) for it in items]


def _check_modes(steptots: bool, totals_only: bool, mesh: int, pair: int,
                 quad: int) -> None:
    if pair != 0:
        raise NotImplementedError(
            "the pair wire arrives with ROADMAP.md queue A item 4; pass pair=0")
    if quad != 0:
        raise NotImplementedError(
            "the quad wire and the auto wire pick arrive with ROADMAP.md "
            "queue A item 3; pass quad=0")
    if not steptots or totals_only:
        raise NotImplementedError(
            "ratio mode (steptots=False) and the totals wire arrive with "
            "ROADMAP.md queue A item 5")
    if mesh > 1:
        raise NotImplementedError(
            "multi-device compress arrives with ROADMAP.md queue A item 9")


def split_groups(src: np.ndarray, group_size: int) -> list[np.ndarray]:
    """Cut a buffer into groups; a ragged multi-MiB tail whose PADDED size
    breaks the 1 MiB chunking rule splits at its last 1 MiB boundary."""
    chunks = [src[i : i + group_size] for i in range(0, len(src), group_size)]
    if group_size > DEFAULT_GROUP and chunks and len(chunks[-1]) > DEFAULT_GROUP \
            and _pad_n(len(chunks[-1])) % DEFAULT_GROUP:
        tail = chunks.pop()
        cut = len(tail) // DEFAULT_GROUP * DEFAULT_GROUP
        chunks.extend([tail[:cut], tail[cut:]])
    return chunks


def stage_encode_batch(items, n_pad: int):
    """(fc, magic, src_words) numpy inputs of rans_encode2 for a batch of
    (gi, chunk, prep) items of one padded size: padding with each group's
    most frequent symbol keeps the final states, hence the frame, equal to
    the twin's."""
    G = len(items)
    t4 = n_pad // TURBO_STEP_SYMS
    fc = np.zeros((G, 2, 128), np.int32)
    mg = np.zeros((G, 2, 128), np.int32)
    srcw = np.zeros((G, t4 * 8, 128), np.int32)

    def stage(j):
        _gi, ch, (norm, _max_sv, _ncount, mfs) = items[j]
        fc[j], mg[j] = pack_rans_ctables(norm)  # layout is tlog-agnostic
        pad = np.full(n_pad, mfs, np.uint8)
        pad[: len(ch)] = ch
        srcw[j] = pad.view("<u4").view(np.int32).reshape(t4 * 8, 128)

    _map(stage, range(G))
    return fc, mg, srcw


def plan_encode(data: bytes, group_size: int, table_log: int):
    """Cut data into groups and prep each one: returns (group count,
    {gi: frame} of the RLE and raw groups, {n_pad: [(gi, chunk, prep)]}:
    the encode kernel's batches, one per padded size)."""
    chunks = split_groups(np.frombuffer(data, dtype=np.uint8), group_size)
    preps = _map(lambda ch: _prep_group(ch, table_log), chunks)
    frames: dict[int, bytes] = {}
    batches: dict[int, list] = {}
    for gi, (ch, prep) in enumerate(zip(chunks, preps)):
        if prep is None:
            if (ch == ch[0]).all():  # RLE
                frames[gi] = _HDR.pack(RANS_MAGIC, len(ch), 0, 0, FLAG_RLE, 0) \
                    + bytes([ch[0]]) + b"\0" * 3
            else:                    # near-uniform: straight to raw
                frames[gi] = _HDR.pack(RANS_MAGIC, len(ch), 0, 0, FLAG_RAW, 0) \
                    + ch.tobytes()
            continue
        batches.setdefault(_pad_n(len(ch)), []).append((gi, ch, prep))
    return len(chunks), frames, batches


def _encode_frame(ch, ncount: bytes, csize: int, words: np.ndarray,
                  fin: np.ndarray, stots: np.ndarray, table_log: int) -> bytes:
    """One group's frame from the encode kernel's outputs (raw when the
    frame would not be smaller than the group)."""
    # wire payload bytes ARE the packed words little-endian
    payload = words.tobytes()[: 2 * csize]
    ncount_pad = ncount + b"\0" * (-len(ncount) % 4)
    packed = _pack_rows4(stots)
    if packed is not None:
        sect, fl = packed, FLAG_STEPTOTS | FLAG_ROWS4
    else:
        sect, fl = stots.reshape(-1).tobytes(), FLAG_STEPTOTS
    blob = (_HDR.pack(RANS_MAGIC, len(ch), csize, table_log, fl, len(ncount))
            + ncount_pad
            + fin.reshape(-1).view(np.uint32).astype("<u4").tobytes()
            + sect
            + payload)
    if len(blob) >= len(ch) + _HDR.size:
        blob = _HDR.pack(RANS_MAGIC, len(ch), 0, 0, FLAG_RAW, 0) + ch.tobytes()
    return blob


def turbo_compress_device(data: bytes, group_size: int = DEFAULT_GROUP,
                          table_log: int = 0,
                          steptots: bool = True, mesh: int = 0,
                          totals_only: bool = False,
                          pair: int = -1,
                          pair_table_log: int = 0,
                          quad: int = -1,
                          quad_table_log: int = 0,
                          device=None) -> bytes:
    """Compress with the TurboRANS encode kernel (byte wire, speed mode).

    Frames equal the JAX package's turbo_compress_device with the same
    flags.  This slice ports the byte wire only: it raises
    NotImplementedError unless pair == 0, quad == 0, steptots is True,
    totals_only is False and mesh <= 1 (pair_table_log and quad_table_log
    are then unused).  table_log=0 = the speed-mode default (10).
    device: torch device for the kernels; None = cuda (raises without
    one), "cpu" runs the plain PyTorch versions."""
    _check_modes(steptots, totals_only, mesh, pair, quad)
    dev = resolve_device(device)
    if table_log == 0:
        table_log = RANS_SPEED_TABLELOG
    if not 5 <= table_log <= 12:
        # the byte-path table packings use 12-bit freq/cumul fields
        raise ValueError(f"byte-path tableLog must be in [5, 12], got {table_log}")
    if group_size > MAX_GROUP:
        raise ValueError(
            f"group_size {group_size} exceeds the encode kernel's budget; "
            f"use <= {MAX_GROUP}")
    if group_size > DEFAULT_GROUP and group_size % DEFAULT_GROUP:
        raise ValueError(
            "group sizes above 1 MiB must be a multiple of 1 MiB "
            "(the encode kernel chunks src reads in 1 MiB spans)")
    if len(data) == 0:
        return _HDR.pack(RANS_MAGIC, 0, 0, 0, FLAG_RAW, 0)
    with _stage("c_prep", dev):
        n_groups, results, batches = plan_encode(data, group_size, table_log)

    for n_pad, items in batches.items():
        G = len(items)
        debuglog(3, "turbo encode: batch of %d groups, n_pad=%d", G, n_pad)
        with _stage("c_stage", dev):
            fc, mg, srcw = stage_encode_batch(items, n_pad)
        with _stage("c_h2d", dev):
            ins = to_tensors(dev, fc_tables=fc, magic_tables=mg, src_words=srcw)
        with _stage("c_kernel", dev):
            stream, fin, csize, stots = rans_encode2(
                ins["fc_tables"], ins["magic_tables"], ins["src_words"],
                n_pad // TURBO_STEP_SYMS, _hrows_cap(n_pad), table_log)
        with _stage("c_d2h", dev):
            csize = csize.cpu().numpy()
            # the payload is the first csize halfwords: copy only the words used
            used = (int(csize.max()) + 1) // 2
            stream = stream.reshape(G, -1)[:, :used].cpu().numpy()
            fin = fin.cpu().numpy()
            stots = stots.cpu().numpy().astype(np.uint8)
        with _stage("c_frames", dev):
            for j, (gi, ch, (_norm, _max_sv, ncount, _mfs)) in enumerate(items):
                results[gi] = _encode_frame(ch, ncount, int(csize[j]), stream[j],
                                            fin[j], stots[j], table_log)
    return b"".join(results[gi] for gi in range(n_groups))


def _window_dispatch(windows: int, t_count: int, hrows: int, tlog: int,
                     G: int) -> tuple[int, int]:
    """Entry choice for a byte-wire decode batch, as the JAX package's
    (api.py:494-547) makes it, so a batch reaches the same entry there and
    here: returns (nway, S) for rans_decode_w, or (0, 0) for rans_decode_v2.

    windows > 1 forces rans_decode_w at that interleave (when the shape is
    eligible); windows == 1 forces rans_decode_v2; windows == 0 picks by
    the JAX package's TPU cost model: rans_decode_w iff
    7*G >= nv*pad8(G), nv the resident decoder's interleave."""
    if t_count % 32:
        return 0, 0          # group too small / misaligned for windows
    S = 64 if t_count % 64 == 0 else 32
    if windows == 1:
        return 0, 0
    if windows > 1:
        return windows, S
    nv = v2_pick_nway(t_count, hrows, tlog)
    if 7 * G >= nv * ((G + 7) // 8 * 8):
        return 8, S
    return 0, 0


def stage_decode_batch(groups, idxs, n_pad: int, tlog: int):
    """numpy inputs of the decode entries for a batch of parsed byte-wire
    groups of one padded size and tableLog: (csize_hw, tables,
    init_states, streams, steptots, t4, hrows)."""
    G = len(idxs)
    t4 = n_pad // TURBO_STEP_SYMS
    hrows = _round8(max((groups[i][1] + 127) // 128 for i in idxs) + 16)
    tch = max((1 << tlog) // 128, 1)
    T = n_pad // TURBO_LANES
    srows = stream_word_rows(hrows)
    tbl = np.zeros((G, tch, 128), np.int32)
    init = np.zeros((G, 8, 128), np.int32)
    hws = np.zeros((G, srows, 128), np.int32)
    cs = np.zeros(G, np.int32)
    tots = np.zeros((G, T, 8), np.int32)

    def fill(j_i):
        # the wire payload is already the packed word layout — staging is
        # a straight byte copy
        j, i = j_i
        _n, csize_hw, _tl, _flags, norm, _msv, ini, payload, stots = groups[i]
        tbl[j] = pack_rans_dtable(norm, tlog)
        init[j] = ini.view(np.int32).reshape(8, 128)
        hws[j] = pack_stream_words(payload, srows)
        cs[j] = csize_hw
        tots[j] = stots

    _map(fill, list(enumerate(idxs)))
    return cs, tbl, init, hws, tots, t4, hrows


def parse_groups(blob: bytes) -> list:
    """Every group of a TurboRANS stream, parsed (parse_rans_group)."""
    groups, pos = [], 0
    while pos < len(blob):
        g, used = parse_rans_group(blob[pos:])
        groups.append(g)
        pos += used
    return groups


def plan_decode(groups):
    """({i: bytes} of the raw and RLE groups, {(n_pad, tlog): [i]}: the
    decode entries' batches).  Raises NotImplementedError on groups of a
    wire this slice does not port."""
    pieces: dict[int, bytes] = {}
    batches: dict[tuple[int, int], list[int]] = {}
    for i, g in enumerate(groups):
        n, tlog, flags, payload, steptots = g[0], g[2], g[3], g[7], g[8]
        if flags & FLAG_RAW:
            pieces[i] = bytes(payload)
        elif flags & FLAG_RLE:
            pieces[i] = bytes([payload[0]]) * n
        elif steptots is None or steptots.ndim != 2:
            raise NotImplementedError(
                "v1 (ratio mode) and FLAG_TOTALS groups arrive with "
                "ROADMAP.md queue A item 5")
        else:
            batches.setdefault((_pad_n(n), tlog), []).append(i)
    return pieces, batches


def turbo_decompress_device(blob: bytes, mesh: int = 0, windows: int = 0,
                            device=None) -> bytes:
    """Decompress a TurboRANS stream with the decode kernel.

    windows picks the decode entry as the JAX package does (see
    _window_dispatch); both entries run the same CUDA kernel.  Raises
    ValueError on a corrupt group and NotImplementedError on groups of a
    wire this slice does not port (pair, quad, totals, v1 ratio mode).
    device: as turbo_compress_device."""
    if mesh > 1:
        raise NotImplementedError(
            "multi-device decompress arrives with ROADMAP.md queue A item 9")
    dev = resolve_device(device)
    with _stage("d_parse", dev):
        groups = parse_groups(blob)
        pieces, batches = plan_decode(groups)

    for (n_pad, tlog), idxs in batches.items():
        G = len(idxs)
        debuglog(3, "turbo decode: batch of %d groups, n_pad=%d, tlog=%d",
                 G, n_pad, tlog)
        with _stage("d_stage", dev):
            cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
                groups, idxs, n_pad, tlog)
        with _stage("d_h2d", dev):
            ins = to_tensors(dev, csize_hw=cs, tables=tbl, init_states=init,
                             streams=hws, steptots=tots)
        args = (ins["csize_hw"], ins["tables"], ins["init_states"],
                ins["streams"], ins["steptots"], t4, hrows)
        with _stage("d_kernel", dev):
            w_nway, w_s = _window_dispatch(windows, t4, hrows, tlog, G)
            if w_nway:
                debuglog(2, "turbo decode: rans_decode_w entry (windows=%d, "
                            "t4=%d, G=%d)", windows, t4, G)
                outw, err = rans_decode_w(*args, w_nway, tlog, w_s)
            else:
                outw, err = rans_decode_v2(*args, tlog)
        with _stage("d_d2h", dev):
            err = err.cpu().numpy()
            if err.any():
                raise ValueError(
                    f"turbo-rans device decode: corrupt groups {np.nonzero(err)[0]}")
            outw = outw.cpu().numpy()
        with _stage("d_copy", dev):
            for j, i in enumerate(idxs):
                pieces[i] = outw[j].astype("<i4").tobytes()[: groups[i][0]]
    with _stage("d_join", dev):
        return b"".join(pieces[i] for i in range(len(groups)))
