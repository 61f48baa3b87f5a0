"""Batched FSE (tANS) encode and decode: the CUDA kernels' wrappers and
their plain PyTorch versions.

The JAX package's ops/fse_kernels.py runs each block's serial loop
(fse_compress.c:554-611, fse_decompress.c:178-238) as a ``lax.scan`` over
the symbol index, batched over the blocks.  Here each is a CUDA kernel:

* ``fse_encode_batch`` -> csrc/fse_encode.cu, up to 8 blocks a CTA with
  their tables in shared memory: two lanes of one warp a block run the two
  state chains over staged transforms, chunk by chunk, while the CTA's
  other warps stage the next chunk and place the last one's fields
  (count-then-place: a warp scan of the widths, the words stored
  coalesced);
* ``fse_decode_batch`` -> csrc/fse_decode.cu, up to 4 blocks a CTA with
  their tables in shared memory (3 bytes an entry), one lane a block
  walking both states from the endMark down through a 64-bit register
  window over the stream, whose words cp.async stages ahead.

Wire-format invariants, as the JAX kernels keep them: the 2-state
interleave (state1 on even symbol indices), backward traversal, the
initCState2 free first symbols, field emission order j = n-3..0 followed
by the state2 / state1 flushes and the endMark.

On CPU tensors a wrapper runs its plain version (the JAX scan as a Python
loop of [B]-wide tensor ops, int64 with u32 masks); on CUDA tensors it
launches its kernel, or raises, and adds one to
``rans_kernels.launches["fse_encode"]`` / ``["fse_decode"]``.  The outputs
equal the plain versions' bit for bit: the words (the encode zero-fills
past csize), csize, the decoded bytes (zero past n_out) and err.
"""
from __future__ import annotations

import torch

from ..turbo.rans_kernels import _launch, _on_cuda, count_launch
from .bitio import bytes_to_words, initial_bitpos, pack_fields, read_bits, to_i32


def _gather1(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl[B, T], idx[B] -> tbl[b, idx[b]] (clamped)."""
    idx = idx.clamp(0, tbl.shape[1] - 1)
    return torch.gather(tbl, 1, idx[:, None])[:, 0]


def pack_dtable(new_state, symbol, nb_bits) -> torch.Tensor:
    """One decode entry a state, as the JAX decode packs it: the u32
    ``(newState << 16) | (nbBits << 8) | symbol`` as an int32 pattern."""
    ns, sym, nb = (t.to(torch.int64) for t in (new_state, symbol, nb_bits))
    return to_i32((ns << 16) | (nb << 8) | sym)


def _check_decode(streams_u8, csize, n_out, table_log, dtables, max_out):
    B, S = streams_u8.shape
    if streams_u8.dtype != torch.uint8 or S % 4 or S < 4:
        raise ValueError(f"streams_u8: uint8 [B, S] with S a positive multiple "
                         f"of 4, got {streams_u8.dtype} {tuple(streams_u8.shape)}")
    if max_out % 2:
        raise ValueError(f"max_out must be even, got {max_out}")
    for name, t in (("csize", csize), ("n_out", n_out), ("table_log", table_log)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name}: expected shape ({B},), got {tuple(t.shape)}")
    if len(dtables) != 3 or any(t.dim() != 2 or t.shape[0] != B for t in dtables):
        raise ValueError("dtables: (new_state, symbol, nb_bits), each [B, T]")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def fse_decode_batch_plain(streams_u8, csize, n_out, table_log, dtables,
                           bad_init_mask=None, max_out: int = 32768):
    """Plain PyTorch version of fse_decode_batch (the JAX scan, step by
    step over [B]).  Steps past the longest block change nothing and are
    skipped."""
    _check_decode(streams_u8, csize, n_out, table_log, dtables, max_out)
    new_state, symbol, nb_bits = dtables
    B = streams_u8.shape[0]
    dev = streams_u8.device
    words = bytes_to_words(streams_u8)
    bitpos0, bad = initial_bitpos(streams_u8, csize)
    packed = pack_dtable(new_state, symbol, nb_bits).to(torch.int64) & 0xFFFFFFFF
    nout = n_out.to(torch.int64)
    tl = table_log.to(torch.int64)

    bitpos = bitpos0.to(torch.int64) - tl
    s1 = read_bits(words, bitpos, tl)
    bitpos = bitpos - tl
    s2 = read_bits(words, bitpos, tl)
    bp_check = torch.full((B,), -1, dtype=torch.int64, device=dev)
    out = torch.zeros((B, max_out), dtype=torch.uint8, device=dev)
    # the last two symbols come from the encoder's initial states, which
    # emitted no bits (FSE_initCState2); their transition reads run past the
    # stream start, as the reference's overflow-tail reads do.  Bit
    # accounting is checked after n-2 reads: bitpos must be exactly 0 there.
    steps = min(max_out // 2, (int(nout.max()) + 1) // 2 if B else 0)
    for t in range(max(steps, 0)):
        i0, i1 = 2 * t, 2 * t + 1
        a0, a1 = i0 < nout, i1 < nout
        e1 = _gather1(packed, s1)           # even symbol index -> state1
        nb0 = (e1 >> 8) & 0xFF
        bp0 = bitpos - nb0
        ns1 = (e1 >> 16) + read_bits(words, bp0, nb0)
        e2 = _gather1(packed, s2)
        nb1 = (e2 >> 8) & 0xFF
        bp1 = bp0 - nb1
        ns2 = (e2 >> 16) + read_bits(words, bp1, nb1)
        s1 = torch.where(a0, ns1, s1)
        s2 = torch.where(a1, ns2, s2)
        bp_check = torch.where(i0 == nout - 3, bp0, bp_check)
        bp_check = torch.where(i1 == nout - 3, bp1, bp_check)
        bitpos = torch.where(a1, bp1, torch.where(a0, bp0, bitpos))
        out[:, i0] = torch.where(a0, e1 & 0xFF, 0).to(torch.uint8)
        out[:, i1] = torch.where(a1, e2 & 0xFF, 0).to(torch.uint8)
    err = ((bp_check != 0) & (nout > 2)) | bad
    if bad_init_mask is not None:
        err = err | bad_init_mask.to(torch.bool)
    return out, err


def _decode_kernel(streams_u8, csize, n_out, table_log, packed, max_out: int):
    """The decode kernel (csrc/fse_decode.cu) on one device's tensors."""
    B, S = streams_u8.shape
    dev = streams_u8.device
    # the kernel writes every byte, zeros past n_out
    out = torch.empty((B, max_out), dtype=torch.uint8, device=dev)
    err = torch.empty((B,), dtype=torch.bool, device=dev)
    st = streams_u8.contiguous()
    if st.data_ptr() % 4:           # the kernel reads the stream as u32 words
        st = st.clone()
    cs, no, tl, pk = (t.to(torch.int32).contiguous()
                      for t in (csize, n_out, table_log, packed))
    _launch("fse_decode_launch", dev, st.data_ptr(), S, cs.data_ptr(),
            no.data_ptr(), tl.data_ptr(), pk.data_ptr(), pk.shape[1],
            out.data_ptr(), max_out, err.data_ptr(), B)
    return out, err


def fse_decode_batch(streams_u8, csize, n_out, table_log, dtables,
                     bad_init_mask=None, max_out: int = 32768):
    """streams_u8[B, S] uint8, csize[B], n_out[B], table_log[B],
    dtables = (new_state[B, T], symbol[B, T], nb_bits[B, T]).
    Returns (out[B, max_out] uint8, err[B] bool)."""
    _check_decode(streams_u8, csize, n_out, table_log, dtables, max_out)
    ins = (streams_u8, csize, n_out, table_log, *dtables)
    if not _on_cuda(*ins):
        return fse_decode_batch_plain(streams_u8, csize, n_out, table_log,
                                      dtables, bad_init_mask, max_out)
    out, err = _decode_kernel(streams_u8, csize, n_out, table_log,
                              pack_dtable(*dtables), max_out)
    count_launch("fse_decode")
    if bad_init_mask is not None:
        err = err | bad_init_mask.to(device=err.device, dtype=torch.bool)
    return out, err


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _check_encode(src_u8, n, table_log, ctables, out_bytes):
    B, S = src_u8.shape
    if src_u8.dtype != torch.uint8:
        raise TypeError(f"src_u8: expected uint8, got {src_u8.dtype}")
    for name, t in (("n", n), ("table_log", table_log)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name}: expected shape ({B},), got {tuple(t.shape)}")
    if len(ctables) != 3 or any(t.dim() != 2 or t.shape[0] != B for t in ctables):
        raise ValueError("ctables: (state_table, dfs, dnb), each [B, *]")
    if out_bytes < 1:
        raise ValueError(f"out_bytes must be >= 1, got {out_bytes}")


def fse_encode_batch_plain(src_u8, n, table_log, ctables, _unused=None,
                           max_syms: int = 32768, out_bytes: int = 36000):
    """Plain PyTorch version of fse_encode_batch: the JAX scan step by step
    over [B], then pack_fields.  Chain fields past the longest block are
    empty (nbBits 0) and are not generated."""
    _check_encode(src_u8, n, table_log, ctables, out_bytes)
    state_table, dfs, dnb = (t.to(torch.int64) for t in ctables)
    B = src_u8.shape[0]
    dev = src_u8.device
    src_i = src_u8.to(torch.int64)
    nn = n.to(torch.int64)
    rows = torch.arange(B, device=dev)

    def sym_at(j):
        return _gather1(src_i, j)

    def init_state(sym):
        # FSE_initCState2 (lib/fse.h:500-512)
        d = _gather1(dnb, sym)
        nb = (d + (1 << 15)) >> 16
        v = (nb << 16) - d
        return _gather1(state_table, (v >> nb) + _gather1(dfs, sym))

    # the last two symbols are absorbed by the state init: even index ->
    # state1
    j_last, j_prev = nn - 1, nn - 2
    s_last, s_prev = init_state(sym_at(j_last)), init_state(sym_at(j_prev))
    last_even = (j_last & 1) == 0
    c1 = torch.where(last_even, s_last, s_prev)
    c2 = torch.where(last_even, s_prev, s_last)

    m = (nn - 2).clamp(min=0)                         # chain fields
    width = 2 * ((max_syms + 1) // 2)
    n_fields = min(width, int(m.max()) if B else 0)
    # what does not depend on the states, for every step at once: field e
    # encodes symbol j = n-3-e with state2 (j odd) or state1 (j even)
    e_idx = torch.arange(n_fields, device=dev)
    j = nn[:, None] - 3 - e_idx
    sym = torch.gather(src_i, 1, j.clamp(0, src_i.shape[1] - 1))
    d_nb, d_fs = (torch.gather(t, 1, sym.clamp(0, t.shape[1] - 1)) for t in (dnb, dfs))
    active = e_idx < m[:, None]
    odd = (j & 1) == 1
    upd1, upd2 = active & ~odd, active & odd
    states = torch.zeros((B, n_fields), dtype=torch.int64, device=dev)
    nb_col = torch.zeros_like(states)
    for e in range(n_fields):
        state = torch.where(odd[:, e], c2, c1)
        nb = (state + d_nb[:, e]) >> 16
        nxt = _gather1(state_table, (state >> nb) + d_fs[:, e])
        c1 = torch.where(upd1[:, e], nxt, c1)
        c2 = torch.where(upd2[:, e], nxt, c2)
        states[:, e], nb_col[:, e] = state, nb
    # the JAX step stacks (nb << 16) | value in one i32
    f = to_i32((torch.where(active, nb_col, 0) << 16)
               | torch.where(active, states, 0)).to(torch.int64)
    vals = torch.zeros((B, n_fields + 3), dtype=torch.int64, device=dev)
    nbs = torch.zeros_like(vals)
    vals[:, :n_fields] = f & 0xFFFF
    nbs[:, :n_fields] = f >> 16

    # tail: flush state2, state1, the endMark (fse_compress.c:608-610) at the
    # per-block boundary m; dropped where m lies past the scan's fields
    tlog = table_log.to(torch.int64)
    for k, (v, b) in enumerate(((c2, tlog), (c1, tlog), (1, 1))):
        keep = m + k <= n_fields + 2        # JAX: m + k < width + 3
        col = (m + k).clamp(max=n_fields + 2)
        v = torch.as_tensor(v, device=dev).expand(B)
        b = torch.as_tensor(b, device=dev).expand(B)
        vals[rows, col] = torch.where(keep, v, vals[rows, col])
        nbs[rows, col] = torch.where(keep, b, nbs[rows, col])

    out_words = (out_bytes + 3) // 4
    words, total_bits = pack_fields(vals, nbs, out_words)
    return to_i32(words), ((total_bits + 7) >> 3).to(torch.int32)


def _encode_kernel(src_u8, n, table_log, ctables, max_syms: int, out_bytes: int):
    """The encode kernel (csrc/fse_encode.cu) on one device's tensors."""
    B, S = src_u8.shape
    dev = src_u8.device
    W = (out_bytes + 3) // 4
    # the kernel writes every word, zeros past csize
    words = torch.empty((B, W), dtype=torch.int32, device=dev)
    csize = torch.empty((B,), dtype=torch.int32, device=dev)
    src = src_u8.contiguous()
    nn, tl, st, dfs, dnb = (t.to(torch.int32).contiguous()
                            for t in (n, table_log, *ctables))
    _launch("fse_encode_launch", dev, src.data_ptr(), S, nn.data_ptr(),
            tl.data_ptr(), st.data_ptr(), st.shape[1], dfs.data_ptr(),
            dnb.data_ptr(), dfs.shape[1], words.data_ptr(), W,
            csize.data_ptr(), B, max_syms)
    return words, csize


def fse_encode_batch(src_u8, n, table_log, ctables, _unused=None,
                     max_syms: int = 32768, out_bytes: int = 36000):
    """src_u8[B, S] uint8, n[B], table_log[B],
    ctables = (state_table[B, T], dfs[B, nsym], dnb[B, nsym]).
    Returns (payload_words[B, W] int32 holding the u32 words, csize[B]
    int32); the payload is the first csize[b] bytes of the LE word stream,
    and the words past it are 0."""
    _check_encode(src_u8, n, table_log, ctables, out_bytes)
    if not _on_cuda(src_u8, n, table_log, *ctables):
        return fse_encode_batch_plain(src_u8, n, table_log, ctables, _unused,
                                      max_syms, out_bytes)
    out = _encode_kernel(src_u8, n, table_log, ctables, max_syms, out_bytes)
    count_launch("fse_encode")
    return out
