"""The v0 TurboFSE decode: the CUDA kernel's wrapper and its plain version.

``turbo_fse_decode`` -> csrc/turbo_fse_decode.cu (replaces the JAX
package's turbo/kernels.py:_decode_kernel): one 8-warp block per group
advances its 1024 tANS chains (four a thread) one step at a time, the
lane's bit field placed by a prefix of nbBits over the lanes.  On CPU
tensors, or with interpret=True, it runs the plain PyTorch version;
otherwise, on CUDA tensors, it launches the kernel, or raises, and adds
one to ``rans_kernels.launches["turbo_fse_decode:v0"]``.

The v0 wire (turbo/format.py) is bit-granular, the ratio ceiling of the
lane-interleaved formats; the JAX package reaches this kernel only as its
tests compose it: turbo_fse_compress -> parse_group -> pack_dtable ->
turbo_fse_decode (stage_groups here).
"""
from __future__ import annotations

import numpy as np
import torch

from ..refimpl.tables import build_dtable
from .format import TURBO_LANES, TURBO_STEP_SYMS, TURBO_TABLELOG, _pad_n
from .rans_kernels import _check, _i32, _launch, _on_cuda, _u32, count_launch

TSIZE = 1 << TURBO_TABLELOG        # 2048
TCHUNKS = TSIZE // 128             # 16


def wrows_for(n_payload_words: int) -> int:
    """Stream rows (128 words each) for a payload; multiple of 8 with slack."""
    rows = (n_payload_words + 127) // 128 + 16
    return (rows + 7) // 8 * 8


def pack_dtable(norm, max_sv: int, table_log: int) -> np.ndarray:
    """Reference DTable -> packed [16,128] i32 (base<<16 | nb<<8 | sym)."""
    dt = build_dtable(norm, max_sv, table_log)
    packed = (
        (dt.new_state.astype(np.int64) << 16)
        | (dt.nb_bits.astype(np.int64) << 8)
        | dt.symbol.astype(np.int64)
    ).astype(np.int32)
    out = np.zeros(TSIZE, np.int32)
    out[: packed.shape[0]] = packed
    return out.reshape(TCHUNKS, 128)


def stage_groups(groups):
    """numpy inputs of turbo_fse_decode for coded v0 groups
    (format.parse_group, flags 0) of one padded size, as the JAX package's
    test stages them (tests/test_turbo.py:50-65): (csize_bits[G],
    tables[G,16,128], init_states[G,8,128], streams[G,wrows,128],
    t4_count, wrows)."""
    n_pad = _pad_n(groups[0].n_sym)
    if any(g.flags or _pad_n(g.n_sym) != n_pad for g in groups):
        raise ValueError("a batch holds coded groups of one padded size")
    words = [np.frombuffer(g.payload, "<u4") for g in groups]
    wrows = wrows_for(max(len(w) for w in words))
    streams = np.zeros((len(groups), wrows * 128), np.int32)
    for j, w in enumerate(words):
        streams[j, : len(w)] = w.view(np.int32)
    tbl = np.stack([pack_dtable(g.norm, g.max_symbol_value, g.table_log)
                    for g in groups])
    init = np.stack([g.init_states.astype(np.int32).reshape(8, 128)
                     for g in groups])
    cs = np.array([g.csize_bits for g in groups], np.int32)
    return (cs, tbl, init, streams.reshape(-1, wrows, 128),
            n_pad // TURBO_STEP_SYMS, wrows)


def _check_v0(csize_bits, tables, init_states, streams, t4_count: int,
              wrows: int) -> None:
    G = tables.shape[0]
    if t4_count < 1:
        raise ValueError(f"t4_count must be >= 1, got {t4_count}")
    _check(csize_bits, "csize_bits", (G,))
    _check(tables, "tables", (G, TCHUNKS, 128))
    _check(init_states, "init_states", (G, 8, 128))
    _check(streams, "streams", (G, wrows, 128))


def turbo_fse_decode_plain(csize_bits, tables, init_states, streams,
                           t4_count: int, wrows: int):
    """Plain PyTorch version of turbo_fse_decode's kernel (same inputs and
    outputs), over all G groups and 1024 lanes at once."""
    _check_v0(csize_bits, tables, init_states, streams, t4_count, wrows)
    G = tables.shape[0]
    T = 4 * t4_count
    tbl = tables.reshape(G, TSIZE).to(torch.int64)
    words = _u32(streams.reshape(G, -1))
    last = words.shape[1] - 1
    state = init_states.reshape(G, TURBO_LANES).to(torch.int64)
    cursor = csize_bits.to(torch.int64)[:, None]
    syms = torch.empty((G, T, TURBO_LANES), dtype=torch.int64,
                       device=tables.device)
    for t in range(T):
        e = torch.gather(tbl, 1, state & (TSIZE - 1))
        syms[:, t] = e & 0xFF
        if t == T - 1:                  # the last step reads no bits
            break
        nb = (e >> 8) & 0xF
        prefix = torch.cumsum(nb, dim=1)
        off = cursor - prefix
        wi = off >> 5                   # floor, also when off < 0
        w0 = torch.gather(words, 1, wi.clamp(0, last))
        w1 = torch.gather(words, 1, (wi + 1).clamp(0, last))
        bits = ((w0 | (w1 << 32)) >> (off & 31)) & ((1 << nb) - 1)
        state = (e >> 16) + bits
        cursor = cursor - prefix[:, -1:]
    s = syms.view(G, t4_count, 4, TURBO_LANES)
    word = s[:, :, 0] | (s[:, :, 1] << 8) | (s[:, :, 2] << 16) | (s[:, :, 3] << 24)
    return (_i32(word).view(G, t4_count * 8, 128),
            cursor[:, 0].to(torch.int32))


def _decode_v0_kernel(csize_bits, tables, init_states, streams,
                      t4_count: int):
    """The v0 kernel (csrc/turbo_fse_decode.cu)."""
    G = tables.shape[0]
    dev = tables.device
    out = torch.empty((G, t4_count * 8, 128), dtype=torch.int32, device=dev)
    err = torch.empty((G,), dtype=torch.int32, device=dev)
    cs, tbl, ini, strm = (a.contiguous() for a in
                          (csize_bits, tables, init_states, streams))
    if strm.data_ptr() % 16:        # the kernel stages the stream in 16-byte copies
        strm = strm.clone()
    _launch("turbo_fse_decode_launch", dev, cs.data_ptr(), tbl.data_ptr(),
            ini.data_ptr(), strm.data_ptr(), strm[0].numel(), out.data_ptr(),
            err.data_ptr(), G, t4_count)
    return out, err


def turbo_fse_decode(csize_bits, tables, init_states, streams,
                     t4_count: int, wrows: int, interpret: bool = False):
    """Batched v0 decode.

    csize_bits[G] i32; tables[G,16,128] i32 packed (base<<16 | nb<<8 |
    sym, pack_dtable); init_states[G,8,128] i32; streams[G,wrows,128] i32
    payload words (wrows_for).  Returns (out[G, t4_count*8, 128] i32 =
    decoded bytes, 4 per word, err[G] i32 = the final cursor, 0 = ok).
    interpret=True runs the plain version on the inputs' device."""
    _check_v0(csize_bits, tables, init_states, streams, t4_count, wrows)
    if not _on_cuda(csize_bits, tables, init_states, streams) or interpret:
        return turbo_fse_decode_plain(csize_bits, tables, init_states,
                                      streams, t4_count, wrows)
    out = _decode_v0_kernel(csize_bits, tables, init_states, streams, t4_count)
    count_launch("turbo_fse_decode:v0")
    return out
