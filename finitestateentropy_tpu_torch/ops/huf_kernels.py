"""Batched Huff0 encode and decode: the CUDA kernels' wrappers, their
plain PyTorch versions, and the decode tables.

The JAX package's ops/huf_kernels.py runs the 4-stream encode as a
prefix-sum bit pack (no loop-carried state) and each decode stream as a
``fori_loop`` nbBits chain (huf_decompress.c:194-237) vectorized over 4*B
streams.  Here:

* ``huf_encode_4x_batch`` -> csrc/huf_encode.cu, a warp a stream (a CTA
  a block): each stream's symbols in descending position order, placed
  128 at a time by a warp scan of their widths, then its endMark; the
  kernel writes every output word;
* ``huf_decode_4x1_batch`` -> csrc/huf_decode.cu mode x1, one lane a
  stream, the four streams of a block over one table in shared memory: a
  serial chain of dtLog-bit lookups (byte, nbBits) through a register bit
  window; the kernel writes every output byte;
* ``huf_decode_4x2_batch`` -> csrc/huf_decode.cu mode x2, x1's shape:
  the same with one- or two-byte entries (pack_dtable_x2, staged as three
  byte planes), the bytes staged in shared memory and stored 16 at a time,
  the last-symbol rule of HUF_decodeLastSymbolX2 in a tail loop; the
  kernel writes every output byte.

``build_dtables_x1`` (the X1 fill ordered by (weight, symbol)) is torch
tensor ops on the inputs' device; ``pack_dtable_x2`` packs a table built
on the host (refimpl.huf.huf_read_dtable_x2), as in the JAX package.

Wire-format invariants: per-stream symbols are emitted in strictly
descending position order, an endMark closes each stream; segments are
(n+3)//4 bytes, the 4th n - 3*seg.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel, or raises, and adds one to
``rans_kernels.launches["huf_encode_4x"]``, ``["huf_decode_4x:x1"]`` or
``["huf_decode_4x:x2"]``.  Tables are taken as any integer dtype (the JAX
functions take u16 values and u8 nbBits) and read as int32 by the
kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..turbo.rans_kernels import _launch, _on_cuda, count_launch
from .bitio import bytes_to_words, initial_bitpos, pack_fields, read_bits, to_i32


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _check_encode(src_u8, n, val_table, nb_table):
    B = src_u8.shape[0]
    if src_u8.dtype != torch.uint8 or src_u8.dim() != 2:
        raise TypeError(f"src_u8: expected uint8 [B, S], got {src_u8.dtype} "
                        f"{tuple(src_u8.shape)}")
    if tuple(n.shape) != (B,):
        raise ValueError(f"n: expected shape ({B},), got {tuple(n.shape)}")
    for name, t in (("val_table", val_table), ("nb_table", nb_table)):
        if t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name}: expected [B, nsym], got {tuple(t.shape)}")


def huf_encode_4x_batch_plain(src_u8, n, val_table, nb_table, max_block: int,
                              out_seg_bytes: int):
    """Plain PyTorch version of huf_encode_4x_batch: every stream's fields
    at once ([B, 4, seg_cap+1]), then pack_fields, as the JAX function
    computes it."""
    _check_encode(src_u8, n, val_table, nb_table)
    B, S = src_u8.shape
    dev = src_u8.device
    seg_cap = (max_block + 3) // 4
    nn = n.to(torch.int64)[:, None, None]
    seg = (nn + 3) >> 2                     # floor division, as JAX's //
    k = torch.arange(4, device=dev)[None, :, None]
    start = k * seg
    seg_len = torch.where(k < 3, seg, nn - 3 * seg).clamp(min=0)
    # field e encodes position start + seg_len-1-e (descending order);
    # field seg_len is the endMark
    e = torch.arange(seg_cap + 1, device=dev)[None, None, :]
    p = (start + seg_len - 1 - e).clamp(0, S - 1)
    active = e < seg_len
    sym = torch.gather(src_u8.to(torch.int64), 1, p.reshape(B, -1)).reshape(p.shape)
    val = val_table.to(torch.int64)
    nb = nb_table.to(torch.int64)
    nsym = val.shape[1]
    vsym = torch.gather(val, 1, sym.clamp(max=nsym - 1).reshape(B, -1)).reshape(p.shape)
    bsym = torch.gather(nb, 1, sym.clamp(max=nsym - 1).reshape(B, -1)).reshape(p.shape)
    end = (e == seg_len).to(torch.int64)
    vals = torch.where(active, vsym, end)
    nbs = torch.where(active, bsym, end)
    F = seg_cap + 1
    out_words = (out_seg_bytes + 3) // 4
    words, total_bits = pack_fields(vals.reshape(B * 4, F), nbs.reshape(B * 4, F),
                                    out_words)
    csize = (total_bits + 7) >> 3
    return to_i32(words).reshape(B, 4, out_words), csize.reshape(B, 4)


def _encode_kernel(src_u8, n, val_table, nb_table, max_block: int,
                   out_seg_bytes: int):
    """The encode kernel (csrc/huf_encode.cu) on one device's tensors."""
    B, S = src_u8.shape
    dev = src_u8.device
    W = (out_seg_bytes + 3) // 4
    words = torch.empty((B, 4, W), dtype=torch.int32, device=dev)
    sizes = torch.empty((B, 4), dtype=torch.int32, device=dev)
    src = src_u8.contiguous()
    nn, val, nb = (t.to(torch.int32).contiguous() for t in (n, val_table, nb_table))
    _launch("huf_encode_launch", dev, src.data_ptr(), S, nn.data_ptr(),
            val.data_ptr(), nb.data_ptr(), val.shape[1], words.data_ptr(), W,
            sizes.data_ptr(), B, max_block)
    return words, sizes


def huf_encode_4x_batch(src_u8, n, val_table, nb_table, max_block: int,
                        out_seg_bytes: int):
    """4-stream Huff0 encode.

    src_u8[B, max_block] uint8, n[B] block lengths, val_table[B, 256]
    (u16 values), nb_table[B, 256] (u8 nbBits).  Returns
    (stream_words[B, 4, W] int32 holding the u32 words, stream_sizes[B, 4]
    int32); the words past each stream's size are 0.  The caller
    assembles the jumpTable and the concatenation."""
    _check_encode(src_u8, n, val_table, nb_table)
    if not _on_cuda(src_u8, n, val_table, nb_table):
        return huf_encode_4x_batch_plain(src_u8, n, val_table, nb_table,
                                         max_block, out_seg_bytes)
    out = _encode_kernel(src_u8, n, val_table, nb_table, max_block, out_seg_bytes)
    count_launch("huf_encode_4x")
    return out


# ---------------------------------------------------------------------------
# DTableX1 build (vectorized)
# ---------------------------------------------------------------------------


def build_dtables_x1(weights: torch.Tensor, table_log: torch.Tensor,
                     max_table_log: int = 12):
    """weights[B, 256] (0 = absent), table_log[B] -> (byte[B, T] uint8,
    nb[B, T] uint8), T = 2^max_table_log.

    Mirrors HUF_readDTableX1_wksp's fill (huf_decompress.c:151-183): cells
    ordered by ascending weight, within a weight by symbol index."""
    w = weights.to(torch.int64)
    B, nsym = w.shape
    dev = w.device
    max_size = 1 << max_table_log
    tl = table_log.to(torch.int64)[:, None]
    present = w > 0
    # (1 << w) >> 1 as int32: a shift by 32 or more gives 0
    length = torch.where(present & (w < 32), (1 << w.clamp(0, 31)) >> 1, 0)
    _, order = torch.sort(torch.where(present, w, 99999), dim=1, stable=True)
    cum = torch.cumsum(torch.gather(length, 1, order), dim=1)
    cell = torch.arange(max_size, device=dev)[None, :].expand(B, max_size)
    k = torch.searchsorted(cum.contiguous(), cell.contiguous(), right=True)
    k = k.clamp(max=nsym - 1)
    sym = torch.gather(order, 1, k)
    nb = (tl + 1 - torch.gather(w, 1, sym)) & 0xFF
    live = cell < (1 << tl)
    return (torch.where(live, sym & 0xFF, 0).to(torch.uint8),
            torch.where(live, nb, 0).to(torch.uint8))


# ---------------------------------------------------------------------------
# Decode X1 and X2 (4 streams per block, batched)
# ---------------------------------------------------------------------------


def _check_decode(streams_u8, csize, n_out, table_log, tables, max_seg):
    R, S = streams_u8.shape
    if streams_u8.dtype != torch.uint8 or S % 4 or S < 4:
        raise ValueError(f"streams_u8: uint8 [4B, S] with S a positive multiple "
                         f"of 4, got {streams_u8.dtype} {tuple(streams_u8.shape)}")
    if max_seg < 0:
        raise ValueError(f"max_seg must be >= 0, got {max_seg}")
    for name, t in (("csize", csize), ("n_out", n_out), ("table_log", table_log)):
        if tuple(t.shape) != (R,):
            raise ValueError(f"{name}: expected shape ({R},), got {tuple(t.shape)}")
    if any(t.dim() != 2 or t.shape[0] != R for t in tables):
        raise ValueError("decode tables: one [4B, T] row a stream")


def _lookup_index(words, bitpos, dt_log, T):
    """lookBitsFast with zero-fill when fewer than dtLog bits remain: the
    dtLog-bit table index at bitpos, clamped into the table."""
    avail = torch.minimum(dt_log, bitpos.clamp(min=0))
    raw = read_bits(words, bitpos - avail, avail)
    return (raw << (dt_log - avail)).clamp(0, T - 1)


def huf_decode_4x1_batch_plain(streams_u8, csize, n_out, table_log, dtable,
                               max_seg: int):
    """Plain PyTorch version of huf_decode_4x1_batch (the JAX fori_loop
    step by step over the 4B streams); steps past the longest stream change
    nothing and are skipped."""
    byte_tbl, nb_tbl = dtable
    _check_decode(streams_u8, csize, n_out, table_log, dtable, max_seg)
    R = streams_u8.shape[0]
    dev = streams_u8.device
    words = bytes_to_words(streams_u8)
    bitpos0, bad = initial_bitpos(streams_u8, csize)
    nout = n_out.to(torch.int64)
    dt_log = table_log.to(torch.int64)
    T = byte_tbl.shape[1]
    bt, nt = byte_tbl.to(torch.int64), nb_tbl.to(torch.int64)
    bitpos = bitpos0.to(torch.int64)
    out = torch.zeros((R, max_seg), dtype=torch.uint8, device=dev)
    steps = min(max_seg, int(nout.max()) if R else 0)
    for i in range(max(steps, 0)):
        active = i < nout
        v = _lookup_index(words, bitpos, dt_log, T)[:, None]
        out[:, i] = torch.where(active, torch.gather(bt, 1, v)[:, 0], 0).to(torch.uint8)
        bitpos = torch.where(active, bitpos - torch.gather(nt, 1, v)[:, 0], bitpos)
    err = (bitpos != 0) & (nout > 0)        # endOfDStream equivalent
    return out, err | (bad & (nout > 0))


def huf_decode_4x2_batch_plain(streams_u8, csize, n_out, table_log, tbl,
                               max_seg: int):
    """Plain PyTorch version of huf_decode_4x2_batch: each lookup writes 1-2
    bytes; a length-2 entry at the final position writes only its first
    byte and consumes the remaining bits (huf_decompress.c:668-682)."""
    return _decode_x2(streams_u8, csize, n_out, table_log, tbl, max_seg)[:2]


def huf_decode_4x2_lookups(streams_u8, csize, n_out, table_log, tbl,
                           max_seg: int) -> torch.Tensor:
    """The lookups each stream's X2 decode runs, int64 [4B]: the kernel's
    loop count, under n_out where two-byte entries are read (the dependent
    chain a stream's decode is bound by)."""
    return _decode_x2(streams_u8, csize, n_out, table_log, tbl, max_seg)[2]


def _decode_x2(streams_u8, csize, n_out, table_log, tbl, max_seg: int):
    """huf_decode_4x2_batch_plain's loop: (out, err, lookups a stream)."""
    _check_decode(streams_u8, csize, n_out, table_log, (tbl,), max_seg)
    R = streams_u8.shape[0]
    dev = streams_u8.device
    words = bytes_to_words(streams_u8)
    bitpos0, bad = initial_bitpos(streams_u8, csize)
    nout = n_out.to(torch.int64)
    dt_log = table_log.to(torch.int64)
    T = tbl.shape[1]
    t64 = tbl.to(torch.int64)
    bitpos = bitpos0.to(torch.int64)
    p = torch.zeros(R, dtype=torch.int64, device=dev)
    # max_seg + 1 bytes as the JAX buffer (a 2-byte write's slack), plus a
    # spare column that takes the writes past it (JAX drops them)
    out = torch.zeros((R, max_seg + 2), dtype=torch.uint8, device=dev)
    spare = max_seg + 1
    lookups = torch.zeros(R, dtype=torch.int64, device=dev)
    steps = min(max_seg, int(nout.max()) if R else 0)
    for _ in range(max(steps, 0)):
        active = p < nout
        lookups += active
        v = _lookup_index(words, bitpos, dt_log, T)[:, None]
        e = torch.gather(t64, 1, v)[:, 0]
        nb = (e >> 16) & 0x3F
        two = ((e >> 22) & 1) == 1
        is_last = two & (p == nout - 1)
        at = torch.where(active & (p <= max_seg), p, spare)
        out.scatter_(1, at[:, None], (e & 0xFF).to(torch.uint8)[:, None])
        p1 = (p + 1).clamp(max=max_seg)
        at2 = torch.where(active & two & ~is_last, p1, spare)
        out.scatter_(1, at2[:, None], ((e >> 8) & 0xFF).to(torch.uint8)[:, None])
        new_bitpos = torch.where(is_last, (bitpos - nb).clamp(min=0), bitpos - nb)
        bitpos = torch.where(active, new_bitpos, bitpos)
        step = torch.where(is_last, 1, torch.where(two, 2, 1))
        p = torch.where(active, p + step, p)
    err = ((bitpos != 0) | (p != nout)) & (nout > 0)
    return out[:, :max_seg].contiguous(), err | (bad & (nout > 0)), lookups


def _decode_kernel(streams_u8, csize, n_out, table_log, tables, max_seg: int,
                   x2: bool):
    """The decode kernel (csrc/huf_decode.cu) on one device's tensors: mode
    x1 takes (byte[R, T], nb[R, T]) uint8, mode x2 (tbl[R, T],) int32.
    Both modes write every output byte."""
    R, S = streams_u8.shape
    dev = streams_u8.device
    out = torch.empty((R, max_seg), dtype=torch.uint8, device=dev)
    err = torch.empty((R,), dtype=torch.bool, device=dev)
    st = streams_u8.contiguous()
    if st.data_ptr() % 4:           # the kernel reads the stream as u32 words
        st = st.clone()
    cs, no, tl = (t.to(torch.int32).contiguous() for t in (csize, n_out, table_log))
    if x2:
        t0 = tables[0].to(torch.int32).contiguous()
        t1 = t0
    else:
        t0, t1 = (t.to(torch.uint8).contiguous() for t in tables)
    _launch("huf_decode_launch", dev, st.data_ptr(), S, cs.data_ptr(),
            no.data_ptr(), tl.data_ptr(), t0.data_ptr(), t1.data_ptr(),
            t0.shape[1], int(x2), out.data_ptr(), max_seg, err.data_ptr(), R)
    return out, err


def huf_decode_4x1_batch(streams_u8, csize, n_out, table_log, dtable,
                         max_seg: int):
    """streams_u8[B4, S] (4 streams per block, flattened), csize[B4],
    n_out[B4] segment lengths, table_log[B4], dtable = (byte[B4, T],
    nb[B4, T]).  Returns (out[B4, max_seg] uint8, err[B4] bool)."""
    _check_decode(streams_u8, csize, n_out, table_log, dtable, max_seg)
    if not _on_cuda(streams_u8, csize, n_out, table_log, *dtable):
        return huf_decode_4x1_batch_plain(streams_u8, csize, n_out, table_log,
                                          dtable, max_seg)
    out = _decode_kernel(streams_u8, csize, n_out, table_log, dtable, max_seg,
                         False)
    count_launch("huf_decode_4x:x1")
    return out


def pack_dtable_x2(dt) -> np.ndarray:
    """Pack a host-built DTableX2 (refimpl.huf.huf_read_dtable_x2, 4096-entry
    host work like the tree build) into one int32 table:
    entry = seq_lo | seq_hi<<8 | nb_bits<<16 | (length-1)<<22."""
    e = (dt.seq_lo.astype(np.int32)
         | (dt.seq_hi.astype(np.int32) << 8)
         | (dt.nb_bits.astype(np.int32) << 16)
         | ((dt.length.astype(np.int32) - 1) << 22))
    out = np.zeros(4096, np.int32)
    out[: len(e)] = e
    return out


def huf_decode_4x2_batch(streams_u8, csize, n_out, table_log, tbl,
                         max_seg: int):
    """X2 analogue of huf_decode_4x1_batch; tbl[B4, 4096] int32 packed by
    pack_dtable_x2.  The same bytes as the X1 path (the reference's
    selector, huf_decompress.c:1029-1051, has no format effect)."""
    _check_decode(streams_u8, csize, n_out, table_log, (tbl,), max_seg)
    if not _on_cuda(streams_u8, csize, n_out, table_log, tbl):
        return huf_decode_4x2_batch_plain(streams_u8, csize, n_out, table_log,
                                          tbl, max_seg)
    out = _decode_kernel(streams_u8, csize, n_out, table_log, (tbl,), max_seg,
                         True)
    count_launch("huf_decode_4x:x2")
    return out
