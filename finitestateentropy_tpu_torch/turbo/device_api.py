"""Device-resident TurboRANS: compress and decompress data that lives in
GPU memory without sending the payload through the host.

The port of the JAX package's turbo/device_api.py.  The whole compress
pipeline runs on the tensor's device with no host sync: the histogram
(ops/hist.py) -> the normalization (ops/norm.py, bit-exact with
refimpl/norm.py, the normalizeM2 fallback included) -> the encode tables
(ops/rans_tables.py) -> padding with each group's most frequent symbol ->
the rans_encode2 kernel, row-local placement.  The host then pulls only
what the frame headers need (the normalized counts, flags, final states,
stream sizes and step counts) and the stream words up to the batch's
largest used row, in one transfer, and writes the frames (api's writer):

  compress:   _resident_compress [hist -> normalize -> tables -> pad ->
              encode] -> pull -> frames (raw groups' bytes come down too)
  decompress: the host parses the headers, pushes the payload and the
              decode tables (api's stager), one launch per batch (api's
              dispatch); the output stays on the device as a uint8 tensor
  round trip: rans_resident_roundtrip keeps even the compressed words in
              device memory (the decode tables are built on the device
              from the same normalized counts): only scalars sync

The frames are byte-identical to turbo_compress_device(d, pair=0,
quad=0) and to the numpy twin rans_compress in the same mode.  Groups
batch by padded size as the host path's, ragged tails included.

The entries run on the input's device: a CUDA tensor launches the CUDA
kernels (their plain versions on the device when interpret=True), a CPU
tensor runs the plain versions.  Each entry and each of its stages is a
span of utils/trace.py, which a running torch.profiler records and which
costs one flag test when none runs: resident.compress holds
resident.slice, hist, norm, tables, pad, encode, d2h and frames;
resident.decompress holds resident.d_parse (the headers), d_h2d (raw
groups' bytes, a batch's tables, words and step counts), d_stage (the
decode inputs staged on the host), d_kernel (the launch), d_err (the host
waits for the kernel's error flags) and d_join (the output sliced and
joined).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import GENERIC, FSEError
from ..ops.hist import hist_count_masked
from ..ops.norm import fse_normalize_batch
from ..ops.rans_tables import pack_rans_ctables_batch, pack_rans_dtable_batch
from ..refimpl.ncount import fse_write_ncount
from ..utils.trace import span
# MAX_GROUP: the JAX module's name for the group bound check_byte_args holds
from .api import (DEFAULT_GROUP, MAX_GROUP, _decode_batch, _encode_frame,  # noqa: F401
                  _frame_head, _hrows_cap, _raw_frame, _round8, _sect_kind,
                  check_byte_args, group_spans, mode_flags, parse_groups,
                  stage_decode_batch)
from .format import TURBO_STEP_SYMS, _pad_n
from .rans import FLAG_RAW, FLAG_RLE, RANS_MAGIC, RANS_SPEED_TABLELOG, _HDR
from .rans_kernels import _i32, rans_decode_v2, rans_decode_w, rans_encode2
from .state import resolve_device, to_tensors


def _resident_prep(xp: torch.Tensor, lens: torch.Tensor, n_pad: int,
                   table_log: int):
    """The device ops of the fused compress: histogram -> bit-exact
    normalization -> raw test -> most frequent symbol -> encode tables ->
    padding -> source words, on xp's device with no host sync.  xp [G,
    cols] uint8 (cols <= n_pad, a multiple of 4), lens [G] int32 valid
    lengths.

    Returns (counts [G, 256], norm [G, 256], flags [G], mfs [G], norm_s
    [G, 256], fc, magic [G, 2, 128], srcw [G, t4*8, 128]), int32.  flags:
    0 coded, 1 RLE, 2 / 3 normalization errors (the host raises, as the
    twin does), 4 near-uniform -> raw (the reference's maxCount <= n >> 7,
    fse_compress.c:653-655).  norm_s is norm on coded rows and a delta
    distribution on the rest, which keeps their tables well-formed (the
    freqs sum to the table size) so they share the encode launch."""
    G, cols = xp.shape
    dev = xp.device
    with span("resident.hist"):
        counts = hist_count_masked(xp, cols, lens)
    with span("resident.norm"):
        norm, flags = fse_normalize_batch(counts, lens, table_log)
    with span("resident.tables"):
        raw = counts.max(dim=1).values <= (lens >> 7)
        flags = torch.where((flags != 1) & raw, 4, flags)
        idx = torch.arange(256, device=dev)
        top = counts.max(dim=1, keepdim=True).values
        mfs = torch.where(counts == top, idx, 256).min(dim=1).values  # first max
        delta = torch.where(idx == mfs[:, None], 1 << table_log, 0)
        norm_s = torch.where((flags == 0)[:, None], norm, delta).to(torch.int32)
        fc, mg = pack_rans_ctables_batch(norm_s)
    with span("resident.pad"):
        mfs_u8 = mfs.to(torch.uint8)[:, None]
        pos = torch.arange(cols, device=dev)
        padded = torch.where(pos < lens[:, None], xp, mfs_u8)
        if n_pad > cols:
            padded = torch.cat([padded, mfs_u8.expand(G, n_pad - cols)], dim=1)
        # little-endian u8 -> i32 view: 4 bytes per source word
        srcw = padded.contiguous().view(torch.int32).view(
            G, n_pad // TURBO_STEP_SYMS * 8, 128)
    return (counts, norm, flags.to(torch.int32), mfs.to(torch.int32), norm_s,
            fc, mg, srcw)


def _resident_compress(xp: torch.Tensor, lens: torch.Tensor, n_pad: int,
                       table_log: int, steptots: bool, interpret: bool = False):
    """The fused compress of one batch (JAX: _resident_compress_jit): the
    device ops of _resident_prep, then the rANS encode (rans_encode2,
    row-local placement), no host sync.

    Returns (stream, finals, csize_hw, stots or None, norm_s, norm, flags,
    mfs, srcw).  Rows with flags != 0 encode with their delta table in the
    same launch: their stream output is well-formed garbage that the
    caller drops (at tableLog 12 the delta's freq 2^12 overflows the 12-bit
    field; each lane still emits at most one halfword a step, so csize
    stays within the stream's capacity)."""
    _counts, norm, flags, mfs, norm_s, fc, mg, srcw = _resident_prep(
        xp, lens, n_pad, table_log)
    with span("resident.encode"):
        stream, fin, csize, stots = rans_encode2(
            fc_tables=fc, magic_tables=mg, src_words=srcw,
            t4_count=n_pad // TURBO_STEP_SYMS, hrows_cap=_hrows_cap(n_pad),
            tlog=table_log, steptots=steptots, rowloc=True, interpret=interpret)
    return stream, fin, csize, stots, norm_s, norm, flags, mfs, srcw


def _resident_slices(x: torch.Tensor, items,
                     n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(xp [G, cols] uint8, lens [G] int32) of a batch's (gi, start,
    length) items of padded size n_pad: each group sliced from x, cols =
    the largest length rounded up to 4 (at most n_pad); past the end of
    x, zeros."""
    n = int(x.shape[0])
    cols = min(n_pad, (max(ln for _, _, ln in items) + 3) // 4 * 4)
    lens = torch.tensor([ln for _, _, ln in items], dtype=torch.int32,
                        device=x.device)
    xp = torch.stack([x[st:st + cols] if st + cols <= n
                      else F.pad(x[st:], (0, st + cols - n))
                      for _, st, _ in items])
    return xp, lens


def _resident_batches(n: int, group_size: int):
    """(group count, {n_pad: [(gi, start, length)]}): the groups of n
    bytes as turbo_compress_device cuts them (api.group_spans), batched by
    padded size."""
    spans = group_spans(n, group_size)
    batches: dict[int, list[tuple[int, int, int]]] = {}
    for gi, (st, ln) in enumerate(spans):
        batches.setdefault(_pad_n(ln), []).append((gi, st, ln))
    return len(spans), batches


def _pull_bytes(x: torch.Tensor, st: int, ln: int) -> bytes:
    """A group's bytes, pulled from the device (a raw frame's payload)."""
    return x[st:st + ln].cpu().numpy().tobytes()


def rans_compress_resident(x: torch.Tensor, group_size: int = DEFAULT_GROUP,
                           table_log: int = 0, steptots: bool = True,
                           totals_only: bool = False,
                           interpret: bool | None = None) -> bytes:
    """Compress a 1-D uint8 tensor where it lies: the payload crosses to
    the host only as compressed words (plus the header stats of each
    group, and the bytes of groups that go raw).

    The byte wire only (the resident pipeline has no pair or quad stats):
    frames equal turbo_compress_device(d, pair=0, quad=0) with the same
    flags.  table_log 0 is the mode default (10 speed, 11 ratio);
    steptots=False writes ratio-mode (v1) frames, totals_only=True the
    FLAG_TOTALS wire.  interpret=True runs the plain PyTorch versions of
    the kernels on x's device (None: False)."""
    with span("resident.compress"):
        table_log = mode_flags(table_log, steptots, totals_only, 0, 0)[0]
        check_byte_args(table_log, group_size)
        if x.dim() != 1:
            raise ValueError(f"expected a 1-D tensor, got shape {tuple(x.shape)}")
        interpret = bool(interpret)
        n = int(x.shape[0])
        if n == 0:
            return _raw_frame(0, b"")
        x = x.to(torch.uint8)
        sect_kind = _sect_kind(steptots, totals_only)
        n_groups, batches = _resident_batches(n, group_size)
        results: dict[int, bytes] = {}
        for n_pad, items in batches.items():
            with span("resident.slice"):
                xp, lens = _resident_slices(x, items, n_pad)
            stream, fin, csize, stots, _norm_s, norm, flags, mfs, _srcw = \
                _resident_compress(xp, lens, n_pad, table_log, steptots, interpret)
            with span("resident.d2h"):
                flags_np = flags.cpu().numpy()
                if ((flags_np == 2) | (flags_np == 3)).any():
                    raise FSEError(GENERIC, "normalization failed on device "
                                   f"(flags {flags_np.tolist()})")
                csize_np = csize.cpu().numpy()
                norm_np = norm.cpu().numpy()
                mfs_np = mfs.cpu().numpy()
                fin_np = fin.cpu().numpy()
                stots_np = stots.cpu().numpy().astype(np.uint8) if steptots else None
                # pull only the words the coded groups use, in one transfer
                coded = flags_np == 0
                max_cs = int(csize_np[coded].max()) if coded.any() else 0
                wrows = min(stream.shape[1],
                            max(_round8(((max_cs + 1) // 2 + 127) // 128), 8))
                stream_np = stream[:, :wrows].cpu().numpy()
            with span("resident.frames"):
                for j, (gi, st, ln) in enumerate(items):
                    if flags_np[j] == 1:   # RLE
                        results[gi] = (_HDR.pack(RANS_MAGIC, ln, 0, 0, FLAG_RLE, 0)
                                       + bytes([int(mfs_np[j])]) + b"\0" * 3)
                        continue
                    raw = partial(_pull_bytes, x, st, ln)
                    if flags_np[j] == 4:   # near-uniform: straight to raw
                        results[gi] = _raw_frame(ln, raw())
                        continue
                    norm_j = norm_np[j]
                    max_sv = int(np.nonzero(norm_j)[0].max())
                    ncount = fse_write_ncount(norm_j[: max_sv + 1].tolist(),
                                              max_sv, table_log)
                    prep = (norm_j, max_sv, ncount, int(mfs_np[j]))
                    results[gi] = _encode_frame(
                        ln, raw, table_log, *_frame_head("byte", prep),
                        int(csize_np[j]), stream_np[j], fin_np[j],
                        stots_np[j] if steptots else None, sect_kind)
        return b"".join(results[gi] for gi in range(n_groups))


def rans_decompress_resident(blob: bytes, interpret: bool | None = None,
                             device=None) -> torch.Tensor:
    """Decompress a TurboRANS byte-wire stream into device memory: the
    host sends only the payload and the decode tables; returns a 1-D
    uint8 tensor on the device.  Batches groups by (padded size,
    tableLog, section kind), one launch each: rans_decode_v2 for the rows
    and totals wires, rans_decode for v1 frames.  Raw groups go up as
    they are, RLE groups are filled on the device.  Raises ValueError on
    pair and quad groups (the resident encode never writes them; use
    turbo_decompress_device) and on a corrupt group.  device: None = cuda
    (raises without one); "cpu" runs the plain versions."""
    with span("resident.decompress"):
        dev = resolve_device(device)
        interpret = bool(interpret)
        with span("resident.d_parse"):
            groups = parse_groups(blob)
            pieces: list = [None] * len(groups)
            raws: list[int] = []
            batches: dict[tuple[int, int, int], list[int]] = {}
            for i, g in enumerate(groups):
                if len(g) != 9:
                    raise ValueError(
                        "resident decode does not support FLAG_PAIR / FLAG_QUAD "
                        "groups; use turbo_decompress_device (turbo/api.py)")
                n, _cs, tlog, flags, _norm, _msv, _init, payload, stots = g
                if flags & FLAG_RAW:
                    raws.append(i)
                elif flags & FLAG_RLE:
                    pieces[i] = torch.full((n,), payload[0], dtype=torch.uint8,
                                           device=dev)
                else:
                    kind = 0 if stots is None else stots.ndim
                    batches.setdefault((_pad_n(n), tlog, kind), []).append(i)
        with span("resident.d_h2d"):
            for i in raws:           # raw groups go up as they are
                pieces[i] = torch.from_numpy(np.frombuffer(
                    groups[i][7], np.uint8)[:groups[i][0]].copy()).to(dev)

        for (n_pad, tlog, kind), idxs in batches.items():
            G = len(idxs)
            with span("resident.d_stage"):
                cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
                    groups, idxs, n_pad, tlog, "byte", kind)
            with span("resident.d_h2d"):
                ins = to_tensors(dev, csize_hw=cs, tables=tbl, init_states=init,
                                 streams=hws)
                steptots = (to_tensors(dev, steptots=tots)["steptots"]
                            if kind else None)
            with span("resident.d_kernel"):
                # windows=1: rans_decode_v2 (rans_decode for v1 groups)
                outw, err = _decode_batch("byte", tuple(ins.values()), steptots,
                                          t4, hrows, tlog, 1, interpret)
            with span("resident.d_err"):
                err_np = err.cpu().numpy()
                if err_np.any():
                    raise ValueError(
                        f"resident decode: corrupt groups {np.nonzero(err_np)[0]}")
            with span("resident.d_join"):
                flat = outw.view(torch.uint8).view(G, -1)   # little-endian words
                for j, i in enumerate(idxs):
                    pieces[i] = flat[j, : groups[i][0]]
        with span("resident.d_join"):
            if not pieces:
                return torch.zeros(0, dtype=torch.uint8, device=dev)
            return torch.cat(pieces)


def rans_resident_roundtrip(x: torch.Tensor, group_size: int = DEFAULT_GROUP,
                            table_log: int = 0,
                            interpret: bool | None = None):
    """Compress -> decompress -> verify, all in device memory: the
    payload, tables and sections never leave it, and only scalars sync.

    Returns (ok, total csize in halfwords, nbytes).  Requires every group
    to be coded (no RLE or raw groups) and len(x) a multiple of
    group_size; raises ValueError otherwise."""
    if table_log == 0:
        table_log = RANS_SPEED_TABLELOG
    n = int(x.shape[0])
    if n == 0 or n % group_size:
        raise ValueError("roundtrip needs len(x) % group_size == 0")
    ok, cs = _resident_roundtrip(x.to(torch.uint8), group_size, table_log,
                                 bool(interpret))
    return bool(ok), int(cs), n


def _decode_resident_batch(csize, dtbl, fin, stream, stots, t4: int,
                           hcap: int, table_log: int, interpret: bool):
    """The round trips' decode of a batch the fused compress encoded: the
    windowed entry when t4 is a multiple of its 32-supercycle span (1 MiB
    groups), else rans_decode_v2.  hrows is the encode's capacity (the
    decode is sized before the csizes are known)."""
    common = dict(csize_hw=csize, tables=dtbl, init_states=fin, streams=stream,
                  steptots=stots, t4_count=t4, hrows=hcap, tlog=table_log,
                  interpret=interpret)
    if t4 % 32 == 0:
        return rans_decode_w(**common, nway=8, S=32)
    return rans_decode_v2(**common)


def _resident_mixed_rt(x: torch.Tensor, group_size: int, table_log: int,
                       coded_idx: tuple, interpret: bool = False):
    """Resident round trip of a batch of mixed groups (JAX:
    _resident_mixed_rt_jit): the fused compress classifies every group on
    the device (coded, RLE, raw); the coded ones decode through the
    windowed entry, RLE groups are rebuilt from their byte and raw groups
    from the encoder's source words.  coded_idx is the batch's coded
    groups (the caller knows them from one sync of the flags).  Returns
    (ok, total csize of the coded groups) as device scalars."""
    G = x.shape[0] // group_size
    dev = x.device
    # before the compress: a copy up from host memory waits for the queue
    ci = torch.tensor(coded_idx, dtype=torch.int64, device=dev)
    xp = x.reshape(G, group_size)
    lens = torch.full((G,), group_size, dtype=torch.int32, device=dev)
    n_pad = _pad_n(group_size)
    stream, fin, csize, stots, norm_s, _norm, flags, mfs, srcw = \
        _resident_compress(xp, lens, n_pad, table_log, True, interpret)
    t4 = n_pad // TURBO_STEP_SYMS
    out, err = _decode_resident_batch(
        csize[ci], pack_rans_dtable_batch(norm_s[ci], table_log), fin[ci],
        stream[ci], stots[ci], t4, _hrows_cap(n_pad), table_log, interpret)
    # rebuild every group in the i32 word domain and hold it against the
    # encoder's padded source words (a bijection of the input bytes)
    rle = flags == 1
    raw = flags == 4
    rle_words = _i32(mfs.to(torch.int64) * 0x01010101)[:, None, None]
    recw = torch.where(rle[:, None, None], rle_words, srcw)   # RLE | raw copy
    recw[ci] = out.view(len(coded_idx), t4 * 8, 128)
    ok = ((recw == srcw).all() & (err == 0).all()
          & ((flags == 0) | rle | raw).all())
    return ok, (csize.to(torch.int64) * (flags == 0)).sum()


def _resident_roundtrip(x: torch.Tensor, group_size: int, table_log: int,
                        interpret: bool = False):
    """The resident round trip of len(x) // group_size coded groups (JAX:
    _resident_roundtrip_jit): returns (ok, total csize) as device scalars."""
    G = x.shape[0] // group_size
    dev = x.device
    xp = x.reshape(G, group_size)
    lens = torch.full((G,), group_size, dtype=torch.int32, device=dev)
    n_pad = _pad_n(group_size)
    stream, fin, csize, stots, norm_s, _norm, flags, _mfs, srcw = \
        _resident_compress(xp, lens, n_pad, table_log, True, interpret)
    t4 = n_pad // TURBO_STEP_SYMS
    out, err = _decode_resident_batch(
        csize, pack_rans_dtable_batch(norm_s, table_log), fin, stream, stots,
        t4, _hrows_cap(n_pad), table_log, interpret)
    # word equality implies byte equality of the padded groups
    ok = ((out.view(srcw.shape) == srcw).all() & (err == 0).all()
          & (flags == 0).all())
    return ok, csize.to(torch.int64).sum()
