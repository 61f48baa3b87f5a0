"""TurboRANS kernel wrappers: the CUDA kernels and their plain PyTorch versions.

The entries keep the JAX package's names, argument order (less the
TPU-only ``interpret`` and the wires not ported yet), output shapes and
dtypes (i32 holding u32 bit patterns):

* ``rans_encode2``  -> csrc/rans_encode.cu (replaces _rans_encode_rl_kernel)
* ``rans_decode_v2`` and ``rans_decode_w`` -> csrc/rans_decode.cu (replace
  _rans_decode_v2_kernel and _rans_decode_w_kernel, which compute the same
  function; the port keeps both entries so the routing stays visible)

On CPU tensors a wrapper runs the plain PyTorch version beside it; on CUDA
tensors it launches the kernel, or raises.  ``launches`` counts kernel
launches per entry; nothing else adds to it.

The plain versions work in int64 with explicit 32-bit masks: torch's ``>>``
on int32 is arithmetic and uint32 has little support, while encoder states
lie in [2^16, 2^32).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load
from .format import TURBO_LANES
from .rans import RANS_L, RANS_TABLELOG
from .tables import _enc_chunking, stream_word_rows

launches = {"rans_encode2": 0, "rans_decode_v2": 0, "rans_decode_w": 0}

_M32 = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "rans_encode": ("rans_encode_launch",
                    [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P]),
    "rans_decode": ("rans_decode_launch",
                    [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _u32(t: torch.Tensor) -> torch.Tensor:
    """i32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & _M32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^32) -> i32 bit patterns."""
    t = t & _M32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _mulhi32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of a*b for a, b in [0, 2^32), without int64 overflow."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def _on_cuda(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return True
    raise ValueError(f"kernel inputs on {sorted(str(t.device) for t in ts)}; "
                     "expected all on the CPU or all on one CUDA device")


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _launch(lib_name: str, *args) -> None:
    fn_name, argtypes = _SIGS[lib_name]
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed (cudaError_t {rc})")


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def rans_encode2_plain(fc_tables, magic_tables, src_words, t4_count: int,
                       hrows_cap: int, tlog: int = RANS_TABLELOG):
    """Plain PyTorch version of the encode kernel (same inputs, outputs).

    Steps run in reverse over all G groups and 1024 lanes at once; flagged
    lanes scatter their halfword to cursor + total - rank (flat inclusive
    rank), unflagged lanes to a sink column that is dropped."""
    G = fc_tables.shape[0]
    dev = fc_tables.device
    T = 4 * t4_count
    srows = stream_word_rows(hrows_cap)
    nhw = srows * 256
    fc = _u32(fc_tables.reshape(G, 256))
    mg = _u32(magic_tables.reshape(G, 256))
    words = _u32(src_words.reshape(G, t4_count, TURBO_LANES))
    x = torch.full((G, TURBO_LANES), RANS_L, dtype=torch.int64, device=dev)
    cursor = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    hw = torch.zeros((G, nhw + 1), dtype=torch.int64, device=dev)
    stots = torch.zeros((G, T, 8), dtype=torch.int32, device=dev)
    shift = 32 - tlog
    for t in range(T - 1, -1, -1):
        t4, p = divmod(t, 4)
        sym = (words[:, t4] >> (8 * p)) & 0xFF
        e = torch.gather(fc, 1, sym)
        m = torch.gather(mg, 1, sym)
        f = e & 0xFFF
        cu = (e >> 12) & 0xFFF
        flag = x >= ((f << shift) & _M32)
        emit = x & 0xFFFF
        x = torch.where(flag, x >> 16, x)
        q = _mulhi32(x, m)
        r = x - q * f
        for _ in range(2):                  # the kernel's two corrections
            big = r >= f
            q = q + big
            r = torch.where(big, r - f, r)
        x = ((q << tlog) + cu + r) & _M32
        rank = torch.cumsum(flag, dim=1)
        total = rank[:, -1:]
        pos = cursor + total - rank
        pos = torch.where(flag & (pos < nhw), pos, nhw)
        hw.scatter_(1, pos, emit)
        stots[:, t] = flag.view(G, 8, 128).sum(dim=2).to(torch.int32)
        cursor = cursor + total
    pairs = hw[:, :nhw].view(G, nhw // 2, 2)
    stream = _i32(pairs[..., 0] | (pairs[..., 1] << 16)).view(G, srows, 128)
    return (stream, _i32(x).view(G, 8, 128),
            cursor[:, 0].to(torch.int32), stots)


def _encode_kernel(fc_tables, magic_tables, src_words, t4_count: int,
                   hrows_cap: int, tlog: int):
    G = fc_tables.shape[0]
    dev = fc_tables.device
    srows = stream_word_rows(hrows_cap)
    stream = torch.zeros((G, srows, 128), dtype=torch.int32, device=dev)
    finals = torch.empty((G, 8, 128), dtype=torch.int32, device=dev)
    csize = torch.empty((G,), dtype=torch.int32, device=dev)
    stots = torch.empty((G, 4 * t4_count, 8), dtype=torch.int32, device=dev)
    fc, mg, src = (a.contiguous() for a in (fc_tables, magic_tables, src_words))
    with torch.cuda.device(dev):
        _launch("rans_encode", fc.data_ptr(), mg.data_ptr(), src.data_ptr(),
                stream.data_ptr(), srows * 256, finals.data_ptr(),
                csize.data_ptr(), stots.data_ptr(), G, t4_count, tlog,
                torch.cuda.current_stream(dev).cuda_stream)
    launches["rans_encode2"] += 1
    return stream, finals, csize, stots


def rans_encode2(fc_tables, magic_tables, src_words, t4_count: int,
                 hrows_cap: int, tlog: int = RANS_TABLELOG):
    """Byte-wire encode of G groups.

    fc_tables[G,2,128] i32 ((cumul<<12)|freq); magic_tables[G,2,128] i32
    (floor(2^32/freq), clipped); src_words[G, t4_count*8, 128] i32 (4
    source bytes per word, lane layout of turbo/format.py).
    Returns (stream[G, stream_word_rows(hrows_cap), 128] i32 — 2 LE
    halfwords per word, the wire payload is these words' first csize*2
    bytes, zero beyond —, finals[G,8,128] i32, csize_hw[G] i32,
    stots[G, 4*t4_count, 8] i32 per-step per-row renorm counts)."""
    G = fc_tables.shape[0]
    _enc_chunking(t4_count, 4)          # frame-shaping rule: raises on misfit
    _check(fc_tables, "fc_tables", (G, 2, 128))
    _check(magic_tables, "magic_tables", (G, 2, 128))
    _check(src_words, "src_words", (G, t4_count * 8, 128))
    if not _on_cuda(fc_tables, magic_tables, src_words):
        return rans_encode2_plain(fc_tables, magic_tables, src_words,
                                  t4_count, hrows_cap, tlog)
    return _encode_kernel(fc_tables, magic_tables, src_words, t4_count,
                          hrows_cap, tlog)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_prep(csize_hw, steptots):
    """Cursors [G,T], row offsets [G,T,8] (exclusive prefix of the shipped
    row counts) and the cursor-consistency flag [G], as the JAX wrappers
    compute them outside Pallas (rans_kernels.py:1253-1294, :1485-1513)."""
    st = steptots.to(torch.int64)
    totals = st.sum(dim=2)
    cursors = csize_hw.to(torch.int64)[:, None] - (torch.cumsum(totals, 1) - totals)
    bad = (cursors[:, -1] - totals[:, -1]) != 0
    roff = torch.cumsum(st, dim=2) - st
    return cursors.to(torch.int32), roff.to(torch.int32), bad


def _err(res: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """err[G]: 1 where a final state is not 2^16 or the counts disagree
    with csize, else 0."""
    return ((res != 0).flatten(1).any(dim=1) | bad).to(torch.int32)


def _decode_rows_plain(tables, init_states, streams, cursors, roff,
                       t4_count: int, tlog: int):
    G = tables.shape[0]
    dev = tables.device
    T = 4 * t4_count
    tbl = _u32(tables.reshape(G, -1))
    w = _u32(streams.reshape(G, -1))
    hw = torch.stack([w & 0xFFFF, w >> 16], dim=2).reshape(G, -1)
    nhw = hw.shape[1]
    x = _u32(init_states.reshape(G, TURBO_LANES))
    cur = cursors.to(torch.int64)
    ro = roff.to(torch.int64)
    row_of_lane = torch.arange(TURBO_LANES, device=dev) // 128
    syms = torch.empty((G, T, TURBO_LANES), dtype=torch.int64, device=dev)
    mask = (1 << tlog) - 1
    for t in range(T):
        slot = x & mask
        e = torch.gather(tbl, 1, slot)
        syms[:, t] = e & 0xFF
        x = (((e >> 8) & 0xFFF) * (x >> tlog) + slot - (e >> 20)) & _M32
        flag = x < RANS_L
        within = torch.cumsum(flag.view(G, 8, 128), dim=2).view(G, TURBO_LANES)
        rank = ro[:, t][:, row_of_lane] + within
        pos = (cur[:, t : t + 1] - rank).clamp(0, nhw - 1)
        v = torch.gather(hw, 1, pos)
        x = torch.where(flag, ((x << 16) | v) & _M32, x)
    s = syms.view(G, t4_count, 4, TURBO_LANES)
    word = s[:, :, 0] | (s[:, :, 1] << 8) | (s[:, :, 2] << 16) | (s[:, :, 3] << 24)
    return (_i32(word).view(G, t4_count * 8, 128),
            _i32(x ^ RANS_L).view(G, 8, 128))


def _decode_kernel(tables, init_states, streams, cursors, roff,
                   t4_count: int, tlog: int):
    G = tables.shape[0]
    dev = tables.device
    out = torch.empty((G, t4_count * 8, 128), dtype=torch.int32, device=dev)
    res = torch.empty((G, 8, 128), dtype=torch.int32, device=dev)
    tbl, ini, strm = (a.contiguous() for a in (tables, init_states, streams))
    with torch.cuda.device(dev):
        _launch("rans_decode", tbl.data_ptr(), tbl[0].numel(), ini.data_ptr(),
                strm.data_ptr(), strm[0].numel() * 2, cursors.data_ptr(),
                roff.data_ptr(), out.data_ptr(), res.data_ptr(), G, t4_count,
                tlog, torch.cuda.current_stream(dev).cuda_stream)
    return out, res


def _check_decode(csize_hw, tables, init_states, streams, steptots,
                  t4_count: int, hrows: int, tlog: int) -> None:
    G = tables.shape[0]
    if steptots.dim() != 3:
        raise NotImplementedError(
            "totals-wire decode (FLAG_TOTALS, [G,T] steptots) arrives with "
            "ROADMAP.md queue A item 5")
    if not 5 <= tlog <= 12:
        raise ValueError(f"byte-path tableLog must be in [5, 12], got {tlog}")
    _check(csize_hw, "csize_hw", (G,))
    _check(tables, "tables", (G, max((1 << tlog) // 128, 1), 128))
    _check(init_states, "init_states", (G, 8, 128))
    _check(streams, "streams", (G, stream_word_rows(hrows), 128))
    _check(steptots, "steptots", (G, 4 * t4_count, 8))


def rans_decode_plain(csize_hw, tables, init_states, streams, steptots,
                      t4_count: int, hrows: int, tlog: int = RANS_TABLELOG):
    """Plain PyTorch version of the decode kernel behind rans_decode_v2 and
    rans_decode_w (same inputs and outputs as rans_decode_v2)."""
    _check_decode(csize_hw, tables, init_states, streams, steptots,
                  t4_count, hrows, tlog)
    cursors, roff, bad = _decode_prep(csize_hw, steptots)
    out, res = _decode_rows_plain(tables, init_states, streams, cursors, roff,
                                  t4_count, tlog)
    return out, _err(res, bad)


def _decode(entry: str, csize_hw, tables, init_states, streams, steptots,
            t4_count: int, hrows: int, tlog: int):
    _check_decode(csize_hw, tables, init_states, streams, steptots,
                  t4_count, hrows, tlog)
    cursors, roff, bad = _decode_prep(csize_hw, steptots)
    if _on_cuda(csize_hw, tables, init_states, streams, steptots):
        out, res = _decode_kernel(tables, init_states, streams, cursors, roff,
                                  t4_count, tlog)
        launches[entry] += 1
    else:
        out, res = _decode_rows_plain(tables, init_states, streams, cursors,
                                      roff, t4_count, tlog)
    return out, _err(res, bad)


def rans_decode_v2(csize_hw, tables, init_states, streams, steptots,
                   t4_count: int, hrows: int, tlog: int = RANS_TABLELOG):
    """Rows-wire decode of G groups (the JAX resident-decoder entry).

    csize_hw[G] i32; tables[G, max(2^tlog/128, 1), 128] i32 (pack_rans_dtable);
    init_states[G,8,128] i32; streams[G, stream_word_rows(hrows), 128] i32
    (packed payload words, pack_stream_words); steptots[G, 4*t4_count, 8]
    i32 shipped per-row renorm counts.
    Returns (out[G, t4_count*8, 128] i32 — 4 decoded bytes per word —,
    err[G] i32, 0 = ok); err covers final states != 2^16 and counts that
    disagree with csize_hw."""
    return _decode("rans_decode_v2", csize_hw, tables, init_states, streams,
                   steptots, t4_count, hrows, tlog)


def rans_decode_w(csize_hw, tables, init_states, streams, steptots,
                  t4_count: int, hrows: int, nway: int,
                  tlog: int = RANS_TABLELOG, S: int = 32):
    """The JAX windowed-decoder entry: same inputs and outputs as
    rans_decode_v2, plus its shape rule (t4_count a multiple of the window
    span S, S a multiple of 32 supercycles).  nway and S tune the TPU's
    VMEM windows and have no effect on the GPU kernel."""
    assert t4_count % S == 0 and S % 32 == 0, (t4_count, S)
    return _decode("rans_decode_w", csize_hw, tables, init_states, streams,
                   steptots, t4_count, hrows, tlog)
