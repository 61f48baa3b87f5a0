"""TurboRANS kernel wrappers: the CUDA kernels and their plain PyTorch versions.

The entries keep the JAX package's names, output shapes and dtypes (i32
holding u32 bit patterns) and argument order, less ``interpret``, which
each entry takes as its last parameter instead: interpret=True runs the
plain PyTorch version on the inputs' device (the counterpart of a Pallas
kernel's body in the interpreter) and counts no launch:

* ``rans_encode2`` -> csrc/rans_encode.cu (replaces _rans_encode_rl_kernel,
  rowloc=True, and _rans_encode2_kernel, rowloc=False: the same wire, two
  halfwords per output word, placed row by row or by a flat binary search
  on the TPU; here the chains stage each 32-lane sub-row's halfwords and
  a placement kernel stores them where they go, so both placements launch
  the same kernels: one call, one count);
* ``rans_encode`` -> csrc/rans_encode.cu (replaces _rans_encode_kernel): the
  v1 encode, one halfword per output i32 (the U16 codec's encode, and the
  byte mode that the JAX package's encode parity test runs);
* ``rans_decode_v2`` and ``rans_decode_w`` on the rows wire ([G,T,8] shipped
  row counts) -> csrc/rans_decode.cu (replace _rans_decode_v2_kernel and
  _rans_decode_w_kernel, which compute the same function; the port keeps
  both entries so the routing stays visible);
* ``rans_decode_v2`` and ``rans_decode_w`` on the totals wire ([G,T]
  shipped step totals) and ``rans_decode`` (v1 frames, no section) ->
  csrc/rans_decode_flat.cu (replaces _rans_decode_v2t_kernel, the totals
  mode of _rans_decode_w_kernel and _rans_decode_kernel): the rank is a
  prefix over all 1024 lanes, so one block (a warp per row) decodes a
  whole group.

Wire modes, named by the JAX wrappers' flags:

* ``byte`` (the default): 4 byte symbols per source / output word (spc 4);
* ``pair`` (encode ``u16=True``; decode ``u16=True, pair=True``): 2 pair ids
  per source word, 2 u16 LUT values per output word (spc 2);
* ``quad`` (``quad=True``): 1 id per source word, the u32 LUT value is the
  output word (spc 1);
* ``u16`` (``u16=True``, U16 codec, symbols <= 1023): 2 u16 symbols per
  word (spc 2), decode entries (cumul << 21) | (freq << 10) | sym;
* ``u16x`` (``u16=True, u16x=True``, symbols <= 4095, tableLog 12-13): as
  u16, with split decode tables (freq << 13) | (slot - cumul) plus a
  symbol plane (tables.pack_rans16x_dtable).

A step is t = spc*t4 + p.  Pair and quad decode tables carry the 256-entry
id LUT after the main table (tables.pack_pair_dtable / pack_quad_dtable).
The totals wire is byte-only, as the JAX package writes it.  The encodes
take the mode from the table width as the JAX kernels do: 2 chunks (256
entries) byte, pair (``u16=True``) or quad; 8 chunks u16; 32 chunks u16x.

On CPU tensors, or when asked by interpret=True, a wrapper runs the plain
PyTorch version beside it; otherwise, on CUDA tensors, it launches the
kernel, or raises.  ``launches`` counts kernel
launches per entry and mode ("rans_encode2:quad", "rans_encode2_flat:byte"
for the flat placement, "rans_decode_w:totals"; turbo/kernels.py adds
"turbo_fse_decode:v0"); nothing else adds to it.  LAUNCH_MODES lists the
modes the package's paths launch; the other combinations the JAX kernels
accept (the flat placement on the pair and quad wires, the row-local one
with u16 tables, the v1 encode of pair ids) launch the same kernel and
count under their own keys.

The plain versions work in int64 with explicit 32-bit masks: torch's ``>>``
on int32 is arithmetic and uint32 has little support, while encoder states
and quad LUT values lie in [0, 2^32).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load
from .format import TURBO_LANES
from .rans import RANS_L, RANS_TABLELOG
from .tables import _enc_chunking, stream_word_rows, tch_of

# steps per source / output word of each wire mode
SPC = {"byte": 4, "pair": 2, "quad": 1, "u16": 2, "u16x": 2}
# the modes each entry launches in; "totals" is the totals wire (byte symbols)
LAUNCH_MODES = {
    "rans_encode2": ("byte", "pair", "quad"),          # row-local placement
    "rans_encode2_flat": ("byte", "u16", "u16x"),      # flat placement (mesh)
    "rans_encode": ("byte", "u16", "u16x"),
    "turbo_fse_decode": ("v0",),                       # turbo/kernels.py
    "rans_decode_v2": ("byte", "pair", "quad", "totals", "u16", "u16x"),
    "rans_decode_w": ("byte", "pair", "quad", "totals", "u16", "u16x"),
    "rans_decode": ("byte", "pair", "u16", "u16x"),
}
launches = {f"{e}:{m}": 0 for e, ms in LAUNCH_MODES.items() for m in ms}
_MODE_ID = {"byte": 0, "pair": 1, "quad": 2, "u16": 3, "u16x": 4}  # csrc/rans_step.cuh

_M32 = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {   # C entry -> (library, argument types)
    "rans_encode_launch": (
        "rans_encode",
        [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "rans_decode_launch": (
        "rans_decode", [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "rans_decode_flat_launch": (
        "rans_decode_flat",
        [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "turbo_fse_decode_launch": (        # turbo/kernels.py
        "turbo_fse_decode", [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P]),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(key: str) -> None:
    launches[key] = launches.get(key, 0) + 1


def _mode(u16: bool, pair: bool, quad: bool, u16x: bool = False) -> str:
    """The wire mode named by the JAX wrappers' flags (see the module
    docstring)."""
    if quad:
        return "quad"
    if u16 and pair:
        return "pair"
    if u16:
        return "u16x" if u16x else "u16"
    if pair or u16x:
        raise ValueError("the pair wire runs with u16=True and pair=True, "
                         "the wide U16 tables with u16=True and u16x=True")
    return "byte"


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


def _with_zero_entry(tbl: torch.Tensor) -> torch.Tensor:
    """[G, n] table + a zero column n: symbols or ids past the table (only
    a malformed source can hold one) read 0, as the JAX kernels' chunk
    selects give them."""
    return torch.cat([tbl, torch.zeros_like(tbl[:, :1])], dim=1)


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


_entries: dict[str, ctypes._CFuncPtr] = {}


def _stream_of(dev: torch.device) -> int:
    """The raw cudaStream_t of dev's current stream: torch's raw accessor
    where it has one, cheaper than building a Stream object (small
    launches are host-bound)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(dev.index) if raw else torch.cuda.current_stream(dev).cuda_stream


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    """Calls the C entry fn_name with args and dev's current stream, with
    dev the current device."""
    fn = _entries.get(fn_name)
    if fn is None:
        lib_name, argtypes = _SIGS[fn_name]
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[fn_name] = fn
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _stream_of(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed (cudaError_t {rc})")


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _encode_plain(fc_tables, magic_tables, src_words, t4_count: int,
                  nhw: int, tlog: int, spc: int):
    """The encode kernels' math over all G groups and 1024 lanes at once.

    Steps run in reverse; flagged lanes scatter their halfword to cursor +
    total - rank (flat inclusive rank), unflagged lanes and halfwords at or
    past nhw to a sink column that is dropped.  Tables of 32 chunks (4096
    symbols) hold 14-bit fields, smaller ones 12-bit fields.  Returns
    (halfwords[G, nhw] int64, finals[G,8,128] i32, csize[G] i32,
    stots[G, T, 8] i32)."""
    G = fc_tables.shape[0]
    nsyms = fc_tables[0].numel()
    dev = fc_tables.device
    T = spc * t4_count
    fc = _with_zero_entry(_u32(fc_tables.reshape(G, nsyms)))
    mg = _with_zero_entry(_u32(magic_tables.reshape(G, nsyms)))
    words = _u32(src_words.reshape(G, t4_count, TURBO_LANES))
    x = torch.full((G, TURBO_LANES), RANS_L, dtype=torch.int64, device=dev)
    cursor = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    hw = torch.zeros((G, nhw + 1), dtype=torch.int64, device=dev)
    stots = torch.zeros((G, T, 8), dtype=torch.int32, device=dev)
    shift = 32 - tlog
    sym_mask = 0xFFFF if spc == 2 else 0xFF
    for t in range(T - 1, -1, -1):
        t4, p = divmod(t, spc)
        # byte p of the word, u16 p (pair ids, u16 symbols), or the quad id
        sym = ((words[:, t4] >> (32 // spc * p)) & sym_mask).clamp(max=nsyms)
        e = torch.gather(fc, 1, sym)
        m = torch.gather(mg, 1, sym)
        if nsyms == 4096:
            f, cu = e & 0x3FFF, e >> 14
        else:
            f, cu = e & 0xFFF, (e >> 12) & 0xFFF
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
    return (hw[:, :nhw], _i32(x).view(G, 8, 128), cursor[:, 0].to(torch.int32),
            stots)


def _encode_mode(fc_tables, magic_tables, src_words, t4_count: int,
                 u16: bool, quad: bool = False) -> str:
    """The encode mode from the tables' width, as the JAX kernels read it:
    2 chunks (256 entries) byte, pair (u16) or quad; 8 chunks (u16 symbols
    <= 1023) u16; 32 chunks (u16 symbols <= 4095, 14-bit fields) u16x.
    Checks the inputs' shapes and types."""
    G = fc_tables.shape[0]
    nch = fc_tables.shape[1] if fc_tables.dim() == 3 else 0
    if nch == 2:
        mode = "quad" if quad else "pair" if u16 else "byte"
    elif nch in (8, 32) and u16 and not quad:
        mode = "u16" if nch == 8 else "u16x"
    else:
        raise ValueError(f"fc_tables: expected [G, 2, 128], or [G, 8 or 32, "
                         f"128] with u16=True; got {tuple(fc_tables.shape)}")
    _check(fc_tables, "fc_tables", (G, nch, 128))
    _check(magic_tables, "magic_tables", (G, nch, 128))
    _check(src_words, "src_words", (G, t4_count * 8, 128))
    return mode


def rans_encode2_plain(fc_tables, magic_tables, src_words, t4_count: int,
                       hrows_cap: int, tlog: int = RANS_TABLELOG,
                       u16: bool = False, quad: bool = False,
                       steptots: bool = True, force_chunk: int = 0,
                       rowloc: bool = False):
    """Plain PyTorch version of rans_encode2's kernel (same inputs, outputs;
    the placement flag changes nothing in them)."""
    mode = _encode_mode(fc_tables, magic_tables, src_words, t4_count, u16, quad)
    _enc_chunking(t4_count, SPC[mode], force_chunk)
    G = fc_tables.shape[0]
    srows = stream_word_rows(hrows_cap)
    hw, fin, csize, stots = _encode_plain(fc_tables, magic_tables, src_words,
                                          t4_count, srows * 256, tlog, SPC[mode])
    pairs = hw.view(G, srows * 128, 2)
    stream = _i32(pairs[..., 0] | (pairs[..., 1] << 16)).view(G, srows, 128)
    return stream, fin, csize, stots if steptots else None


def _encode_kernel(fc_tables, magic_tables, src_words, t4_count: int,
                   hrows_cap: int, tlog: int, mode: str, packed: bool = True,
                   steptots: bool = True):
    """The encode kernels (csrc/rans_encode.cu: the state chains, the scan
    of the step counts, the placement).  packed: rans_encode2's wire,
    stream_word_rows(hrows_cap) rows of two halfwords per word; else
    rans_encode's, hrows_cap rows of one halfword per i32.  Scratch: the
    staged halfwords ([G, T, 32, 32]) and the counts and bases ([G, T, 32])
    of each 32-lane sub-row and step."""
    G = fc_tables.shape[0]
    dev = fc_tables.device
    T = SPC[mode] * t4_count
    rows = stream_word_rows(hrows_cap) if packed else hrows_cap
    stream = torch.zeros((G, rows, 128), dtype=torch.int32, device=dev)
    finals = torch.empty((G, 8, 128), dtype=torch.int32, device=dev)
    csize = torch.empty((G,), dtype=torch.int32, device=dev)
    stots = (torch.empty((G, T, 8), dtype=torch.int32, device=dev)
             if steptots else None)
    counts, base = (torch.empty((G, T, 32), dtype=torch.int32, device=dev)
                    for _ in range(2))
    stage = torch.empty((G, T, 32, 32), dtype=torch.int16, device=dev)
    fc, mg, src = (a.contiguous() for a in (fc_tables, magic_tables, src_words))
    _launch("rans_encode_launch", dev, fc.data_ptr(), mg.data_ptr(),
            src.data_ptr(), stream.data_ptr(),
            rows * 128 * (2 if packed else 1), finals.data_ptr(),
            csize.data_ptr(), None if stots is None else stots.data_ptr(),
            counts.data_ptr(), stage.data_ptr(), base.data_ptr(), G, t4_count,
            tlog, SPC[mode], fc.shape[1], int(packed))
    return stream, finals, csize, stots


def rans_encode2(fc_tables, magic_tables, src_words, t4_count: int,
                 hrows_cap: int, tlog: int = RANS_TABLELOG,
                 u16: bool = False, quad: bool = False,
                 steptots: bool = True, force_chunk: int = 0,
                 rowloc: bool = False, interpret: bool = False):
    """Packed-out encode of G groups: the speed and ratio wires, byte, pair
    (u16=True on 2-chunk tables), quad, u16 and u16x.

    fc_tables[G,nch,128] i32 ((cumul<<12)|freq; (cumul<<14)|freq at 32
    chunks); magic_tables the same shape (floor(2^32/freq), clipped);
    src_words[G, t4_count*8, 128] i32 (4 bytes, 2 pair ids or u16 symbols,
    or 1 quad id per word, lane layout of turbo/format.py).  Returns
    (stream[G, stream_word_rows(hrows_cap), 128] i32 — 2 LE halfwords per
    word, the wire payload is these words' first csize*2 bytes, zero
    beyond —, finals[G,8,128] i32, csize_hw[G] i32, stots[G,
    spc*t4_count, 8] i32 per-step per-row renorm counts, or None when
    steptots is False).  rowloc names the JAX kernel the call replaces (the
    row-local or the flat placement) and the launch count it adds to; the
    output is the same.  force_chunk (tests only) shrinks the JAX kernel's
    source chunk: the output is the same, but the chunking rule still
    holds."""
    mode = _encode_mode(fc_tables, magic_tables, src_words, t4_count, u16, quad)
    _enc_chunking(t4_count, SPC[mode], force_chunk)  # frame-shaping rule
    if not _on_cuda(fc_tables, magic_tables, src_words) or interpret:
        return rans_encode2_plain(fc_tables, magic_tables, src_words, t4_count,
                                  hrows_cap, tlog, u16, quad, steptots)
    out = _encode_kernel(fc_tables, magic_tables, src_words, t4_count,
                         hrows_cap, tlog, mode, True, steptots)
    count_launch(f"rans_encode2{'' if rowloc else '_flat'}:{mode}")
    return out


def rans_encode_plain(fc_tables, magic_tables, src_words, t4_count: int,
                      hrows_cap: int, u16: bool = False,
                      tlog: int = RANS_TABLELOG, steptots: bool = True):
    """Plain PyTorch version of rans_encode's kernel (same inputs, outputs)."""
    mode = _encode_mode(fc_tables, magic_tables, src_words, t4_count, u16)
    G = fc_tables.shape[0]
    hw, fin, csize, stots = _encode_plain(fc_tables, magic_tables, src_words,
                                          t4_count, hrows_cap * 128, tlog,
                                          SPC[mode])
    return (hw.to(torch.int32).view(G, hrows_cap, 128), fin, csize,
            stots if steptots else None)


def rans_encode(fc_tables, magic_tables, src_words, t4_count: int,
                hrows_cap: int, u16: bool = False,
                tlog: int = RANS_TABLELOG, steptots: bool = True,
                interpret: bool = False):
    """The v1 encode (the JAX rans_encode entry) of G groups: byte symbols
    on 2-chunk tables (u16=False), u16 symbols <= 1023 on 8-chunk tables
    and <= 4095 on 32-chunk ones (u16=True).

    Tables and src_words as rans_encode2's (2 u16 symbols per word in the
    u16 modes, the lane layout of turbo/rans16.py).  Returns (stream[G,
    hrows_cap, 128] i32 — one halfword per entry, in order; the wire
    payload is the first csize_hw entries, zero beyond —, finals[G,8,128]
    i32, csize_hw[G] i32, stots[G, spc*t4_count, 8] i32 or None when
    steptots is False).  The U16 codec encodes through it; the byte mode's
    callers in the JAX package are its encode parity test and fullbench
    stage 205 (the multi-device compress runs rans_encode2)."""
    mode = _encode_mode(fc_tables, magic_tables, src_words, t4_count, u16)
    if not _on_cuda(fc_tables, magic_tables, src_words) or interpret:
        return rans_encode_plain(fc_tables, magic_tables, src_words, t4_count,
                                 hrows_cap, u16, tlog, steptots)
    out = _encode_kernel(fc_tables, magic_tables, src_words, t4_count,
                         hrows_cap, tlog, mode, False, steptots)
    count_launch(f"rans_encode:{mode}")
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_prep(csize_hw, steptots):
    """Cursors [G,T], row offsets [G,T,8] (the exclusive prefix of shipped
    row counts; None on the totals wire) and the cursor-consistency flag
    [G], as the JAX wrappers compute them outside Pallas
    (rans_kernels.py:1253-1294, :1485-1513)."""
    st = steptots.to(torch.int64)
    totals = st if st.dim() == 2 else st.sum(dim=2)
    cursors = csize_hw.to(torch.int64)[:, None] - (torch.cumsum(totals, 1) - totals)
    bad = (cursors[:, -1] - totals[:, -1]) != 0
    roff = None if st.dim() == 2 else (torch.cumsum(st, dim=2) - st).to(torch.int32)
    return cursors.to(torch.int32), roff, bad


def _err(res: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """err[G]: 1 where a final state is not 2^16 or the cursors are
    inconsistent (counts that disagree with csize, or a v1 chain that does
    not end at 0), else 0."""
    return ((res != 0).flatten(1).any(dim=1) | bad).to(torch.int32)


def _decode_plain(tables, init_states, streams, t4_count: int, tlog: int,
                  mode: str, cursors=None, roff=None, csize_hw=None):
    """The decode kernels' math over all G groups and 1024 lanes at once.

    Rank: with roff (rows wire) the shipped row offset plus the rank among
    the row's flagged lanes; without, the flat prefix over all 1024 lanes.
    Cursor: cursors[:, t] when given (rows and totals wires); else the v1
    chain, from csize_hw down by each step's total.  Stream indices clamp
    into the group's buffer.  Returns (out[G, t4*8, 128] i32, res[G,8,128]
    i32 = final states ^ 2^16, the v1 chain's end cursor [G] or None)."""
    spc = SPC[mode]
    G = tables.shape[0]
    dev = tables.device
    T = spc * t4_count
    tbl = _u32(tables.reshape(G, -1))
    lut = _with_zero_entry(tbl[:, -256:])   # pair / quad: id -> LUT value
    plane = max(1 << tlog, 128)             # u16x: the symbol plane's offset
    w = _u32(streams.reshape(G, -1))
    hw = torch.stack([w & 0xFFFF, w >> 16], dim=2).reshape(G, -1)
    nhw = hw.shape[1]
    x = _u32(init_states.reshape(G, TURBO_LANES))
    cur = None if cursors is None else cursors.to(torch.int64)
    chain = None if cursors is not None else csize_hw.to(torch.int64)[:, None]
    row_of_lane = torch.arange(TURBO_LANES, device=dev) // 128
    syms = torch.empty((G, T, TURBO_LANES), dtype=torch.int64, device=dev)
    mask = (1 << tlog) - 1
    for t in range(T):
        slot = x & mask
        e = torch.gather(tbl, 1, slot)
        if mode == "byte":      # (cumul << 20) | (freq << 8) | sym
            syms[:, t] = e & 0xFF
            x = ((e >> 8) & 0xFFF) * (x >> tlog) + slot - (e >> 20)
        elif mode == "u16":     # (cumul << 21) | (freq << 10) | sym
            syms[:, t] = e & 0x3FF
            x = ((e >> 10) & 0x7FF) * (x >> tlog) + slot - (e >> 21)
        elif mode == "u16x":    # (freq << 13) | j, then the symbol plane
            syms[:, t] = torch.gather(tbl, 1, slot + plane)
            x = (e >> 13) * (x >> tlog) + (e & 0x1FFF)
        else:                   # (id << 2*tlog) | (freq << tlog) | slot-cumul
            syms[:, t] = torch.gather(lut, 1, (e >> (2 * tlog)).clamp(max=256))
            x = ((e >> tlog) & mask) * (x >> tlog) + (e & mask)
        x = x & _M32
        flag = x < RANS_L
        if roff is None:
            rank = torch.cumsum(flag, dim=1)
        else:
            within = torch.cumsum(flag.view(G, 8, 128), dim=2).view(G, TURBO_LANES)
            rank = roff[:, t].to(torch.int64)[:, row_of_lane] + within
        start = chain if cur is None else cur[:, t : t + 1]
        pos = (start - rank).clamp(0, nhw - 1)
        v = torch.gather(hw, 1, pos)
        x = torch.where(flag, ((x << 16) | v) & _M32, x)
        if cur is None:
            chain = chain - rank[:, -1:]
    s = syms.view(G, t4_count, spc, TURBO_LANES)
    word = s[:, :, 0]
    for p in range(1, spc):     # byte p at bit 8p; u16 value p at bit 16p
        word = word | (s[:, :, p] << (32 // spc * p))
    return (_i32(word).view(G, t4_count * 8, 128),
            _i32(x ^ RANS_L).view(G, 8, 128),
            None if chain is None else chain[:, 0])


def _decode_kernel(tables, init_states, streams, cursors, roff,
                   t4_count: int, tlog: int, mode: str):
    """The rows-wire kernel (csrc/rans_decode.cu)."""
    G = tables.shape[0]
    dev = tables.device
    out = torch.empty((G, t4_count * 8, 128), dtype=torch.int32, device=dev)
    res = torch.empty((G, 8, 128), dtype=torch.int32, device=dev)
    tbl, ini, strm = (a.contiguous() for a in (tables, init_states, streams))
    if strm.data_ptr() % 16:        # the kernel stages the stream in 16-byte copies
        strm = strm.clone()
    _launch("rans_decode_launch", dev, tbl.data_ptr(), tbl.shape[1] * 128,
            ini.data_ptr(), strm.data_ptr(), strm.shape[1] * 256,
            cursors.data_ptr(), roff.data_ptr(), out.data_ptr(),
            res.data_ptr(), G, t4_count, tlog, _MODE_ID[mode])
    return out, res


def _decode_flat_kernel(tables, init_states, streams, csize_hw, cursors,
                        t4_count: int, tlog: int, mode: str):
    """The flat-rank kernel (csrc/rans_decode_flat.cu): cursors [G,T] on
    the totals wire, None for the v1 chain from csize_hw.  Returns (out,
    res, end cursor [G] i32)."""
    G = tables.shape[0]
    dev = tables.device
    out = torch.empty((G, t4_count * 8, 128), dtype=torch.int32, device=dev)
    res = torch.empty((G, 8, 128), dtype=torch.int32, device=dev)
    cend = torch.empty((G,), dtype=torch.int32, device=dev)
    tbl, ini, strm, cs = (a.contiguous() for a in
                          (tables, init_states, streams, csize_hw))
    if strm.data_ptr() % 16:        # the kernel stages the stream in 16-byte copies
        strm = strm.clone()
    cur = None if cursors is None else cursors.contiguous()
    _launch("rans_decode_flat_launch", dev, tbl.data_ptr(), tbl[0].numel(),
            ini.data_ptr(), strm.data_ptr(), strm[0].numel() * 2,
            cs.data_ptr(), None if cur is None else cur.data_ptr(),
            out.data_ptr(), res.data_ptr(), cend.data_ptr(), G, t4_count,
            tlog, _MODE_ID[mode])
    return out, res, cend


def _check_decode(csize_hw, tables, init_states, streams, steptots,
                  t4_count: int, hrows: int, tlog: int, mode: str) -> None:
    """Shapes and types of a decode entry's inputs; steptots None is v1."""
    G = tables.shape[0]
    top = 13 if mode == "u16x" else 12
    if not 5 <= tlog <= top:
        raise ValueError(f"tableLog must be in [5, {top}], got {tlog}")
    _check(csize_hw, "csize_hw", (G,))
    _check(tables, "tables", (G, tch_of(mode, tlog), 128))
    _check(init_states, "init_states", (G, 8, 128))
    _check(streams, "streams", (G, stream_word_rows(hrows), 128))
    if steptots is None:
        return
    T = SPC[mode] * t4_count
    if steptots.dim() == 2:
        if mode != "byte":
            raise ValueError("the totals wire (FLAG_TOTALS) is byte-only")
        _check(steptots, "steptots", (G, T))
    else:
        _check(steptots, "steptots", (G, T, 8))


def rans_decode_plain(csize_hw, tables, init_states, streams, steptots,
                      t4_count: int, hrows: int, tlog: int = RANS_TABLELOG,
                      u16: bool = False, u16x: bool = False,
                      pair: bool = False, quad: bool = False):
    """Plain PyTorch version of the kernels behind rans_decode_v2 and
    rans_decode_w (same inputs and outputs as rans_decode_v2)."""
    mode = _mode(u16, pair, quad, u16x)
    _check_decode(csize_hw, tables, init_states, streams, steptots,
                  t4_count, hrows, tlog, mode)
    cursors, roff, bad = _decode_prep(csize_hw, steptots)
    out, res, _ = _decode_plain(tables, init_states, streams, t4_count, tlog,
                                mode, cursors, roff)
    return out, _err(res, bad)


def _decode(entry: str, csize_hw, tables, init_states, streams, steptots,
            t4_count: int, hrows: int, tlog: int, mode: str, interpret: bool):
    _check_decode(csize_hw, tables, init_states, streams, steptots,
                  t4_count, hrows, tlog, mode)
    cursors, roff, bad = _decode_prep(csize_hw, steptots)
    if not _on_cuda(csize_hw, tables, init_states, streams, steptots) or interpret:
        out, res, _ = _decode_plain(tables, init_states, streams, t4_count,
                                    tlog, mode, cursors, roff)
        return out, _err(res, bad)
    if roff is None:            # totals wire: the flat-rank kernel
        out, res, _ = _decode_flat_kernel(tables, init_states, streams,
                                          csize_hw, cursors, t4_count, tlog,
                                          mode)
        launches[f"{entry}:totals"] += 1
    else:
        out, res = _decode_kernel(tables, init_states, streams, cursors,
                                  roff, t4_count, tlog, mode)
        launches[f"{entry}:{mode}"] += 1
    return out, _err(res, bad)


def rans_decode_v2(csize_hw, tables, init_states, streams, steptots,
                   t4_count: int, hrows: int, tlog: int = RANS_TABLELOG,
                   u16: bool = False, u16x: bool = False, pair: bool = False,
                   quad: bool = False, interpret: bool = False):
    """Speed-wire decode of G groups (the JAX resident-decoder entry).

    csize_hw[G] i32; tables[G, tch, 128] i32 (tables.pack_*_dtable; see
    state.LAYOUTS for each mode's tch); init_states[G,8,128] i32;
    streams[G, stream_word_rows(hrows), 128] i32 (packed payload words,
    pack_stream_words); steptots either [G, spc*t4_count, 8] i32 shipped
    per-row renorm counts (FLAG_STEPTOTS) or [G, 4*t4_count] i32 shipped
    step totals (FLAG_TOTALS, byte mode).  Returns (out[G, t4_count*8, 128]
    i32 — 4 bytes, 2 u16 values or 1 quad value per word —, err[G] i32, 0 =
    ok); err covers final states != 2^16 and counts that disagree with
    csize_hw."""
    return _decode("rans_decode_v2", csize_hw, tables, init_states, streams,
                   steptots, t4_count, hrows, tlog,
                   _mode(u16, pair, quad, u16x), interpret)


def rans_decode_w(csize_hw, tables, init_states, streams, steptots,
                  t4_count: int, hrows: int, nway: int,
                  tlog: int = RANS_TABLELOG, S: int = 32, u16: bool = False,
                  u16x: bool = False, pair: bool = False, quad: bool = False,
                  interpret: bool = False):
    """The JAX windowed-decoder entry: same inputs and outputs as
    rans_decode_v2, plus its shape rule (t4_count a multiple of the window
    span S, S a multiple of 128//spc supercycles).  nway and S tune the
    TPU's VMEM windows and have no effect on the GPU kernels."""
    mode = _mode(u16, pair, quad, u16x)
    assert t4_count % S == 0 and S % (128 // SPC[mode]) == 0, (t4_count, S)
    return _decode("rans_decode_w", csize_hw, tables, init_states, streams,
                   steptots, t4_count, hrows, tlog, mode, interpret)


def rans_decode_v1_plain(csize_hw, tables, init_states, streams,
                         t4_count: int, hrows: int, u16: bool = False,
                         tlog: int = RANS_TABLELOG, u16x: bool = False,
                         pair: bool = False):
    """Plain PyTorch version of rans_decode's kernel (same inputs, outputs)."""
    mode = _mode(u16, pair, False, u16x)
    _check_decode(csize_hw, tables, init_states, streams, None, t4_count,
                  hrows, tlog, mode)
    out, res, cend = _decode_plain(tables, init_states, streams, t4_count,
                                   tlog, mode, csize_hw=csize_hw)
    return out, _err(res, cend != 0)


def rans_decode(csize_hw, tables, init_states, streams, t4_count: int,
                hrows: int, u16: bool = False, tlog: int = RANS_TABLELOG,
                u16x: bool = False, pair: bool = False,
                interpret: bool = False):
    """v1 decode of G groups (frames with no section: ratio mode, v1 pair,
    the U16 codec's ratio frames).  The rank and the cursor chain are both
    computed in the kernel: the cursor starts at csize_hw and drops by each
    step's total.

    Inputs as rans_decode_v2 less steptots; modes byte, pair (u16=True,
    pair=True), u16 and u16x.  Returns (out[G, t4_count*8, 128] i32,
    err[G] i32, 0 = ok); err covers final states != 2^16 and a chain that
    does not end at cursor 0."""
    mode = _mode(u16, pair, False, u16x)
    _check_decode(csize_hw, tables, init_states, streams, None, t4_count,
                  hrows, tlog, mode)
    if not _on_cuda(csize_hw, tables, init_states, streams) or interpret:
        out, res, cend = _decode_plain(tables, init_states, streams, t4_count,
                                       tlog, mode, csize_hw=csize_hw)
    else:
        out, res, cend = _decode_flat_kernel(tables, init_states, streams,
                                             csize_hw, None, t4_count, tlog,
                                             mode)
        launches[f"rans_decode:{mode}"] += 1
    return out, _err(res, cend != 0)
