"""Bit-level I/O on byte buffers, as batched torch ops.

The port of the JAX package's ops/bitio.py.  Words are little-endian u32
values held in int64 tensors (torch's ``>>`` on int32 is arithmetic and
uint32 has little support), so every shift and mask below is the u32
operation of the original:

* reading: an arbitrary <=25-bit field at bit offset p is two gathered
  words funnel-shifted, with the offset clamped at 0 and the word index at
  the last word (never out of bounds; corrupt streams give garbage values
  and an error flag downstream);
* writing: a stream is the concatenation of (value, nbBits) fields in
  emission order; field bit offsets are a prefix sum and the words come
  from a scatter-add (``index_add_``) of non-overlapping word parts.

The plain versions of the compat kernels (ops/fse_kernels.py,
ops/huf_kernels.py) and the sharded round trip (parallel/dp.py) use these.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def highbit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each value of x (0 <= x < 2^32), -1
    for 0: the exact integer ``31 - clz(x)`` (a binary search, no float)."""
    x = x.to(torch.int64)
    hb = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hb = hb + s * ((x >> (hb + s)) > 0)
    return torch.where(x > 0, hb, -1)


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 bit patterns."""
    t = t.to(torch.int64) & _M32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def u32_mask(nb: torch.Tensor) -> torch.Tensor:
    """(1 << nb) - 1 as a u32 op: all ones where nb, taken as u32, is >= 32
    (XLA's shift by the width or more gives 0)."""
    nb = nb.to(torch.int64)
    big = (nb < 0) | (nb >= 32)
    return torch.where(big, _M32, (1 << nb.clamp(0, 31)) - 1)


def bytes_to_words(buf_u8: torch.Tensor) -> torch.Tensor:
    """[..., 4*W] uint8 -> [..., W] little-endian u32 values (int64)."""
    b = buf_u8.to(torch.int64)
    return b[..., 0::4] | (b[..., 1::4] << 8) | (b[..., 2::4] << 16) | (b[..., 3::4] << 24)


def words_to_bytes(words_u32: torch.Tensor) -> torch.Tensor:
    """[..., W] u32 words (int64 values or int32 patterns) -> [..., 4*W]
    uint8 little-endian."""
    w = words_u32.to(torch.int64) & _M32
    parts = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF,
                         (w >> 24) & 0xFF], dim=-1)
    return parts.reshape(*w.shape[:-1], w.shape[-1] * 4).to(torch.uint8)


def read_bits(words: torch.Tensor, bitpos: torch.Tensor,
              nb: torch.Tensor) -> torch.Tensor:
    """Read `nb` (<=25) bits at absolute bit offset `bitpos`.

    words: [..., W] u32 values (one stream a row); bitpos, nb: [...] (0-d
    for one stream, as the JAX function takes them).  Offsets are clamped
    at 0 and word indices at W-1, as the reference's "never overread,
    detect later" contract (bitstream.h:416-440) has it."""
    bp = torch.as_tensor(bitpos, device=words.device).to(torch.int64).clamp(min=0)
    wmax = words.shape[-1] - 1
    word = bp >> 5
    sh = bp & 31

    def at(idx):        # the word at idx as a u32 value (only two a row taken)
        return torch.gather(words, -1, idx.clamp(max=wmax)[..., None])[..., 0].to(torch.int64) & _M32
    w0, w1 = at(word), at(word + 1)
    window = ((w0 | (w1 << 32)) >> sh) & _M32
    return window & u32_mask(torch.as_tensor(nb, device=words.device))


def pack_fields(values: torch.Tensor, nbbits: torch.Tensor, out_words: int):
    """Pack per-field (value, nbBits) into a little-endian bitstream.

    values, nbbits: [B, F]; fields are emitted in order, padding fields
    must have nbBits == 0.  Returns (words[B, out_words] u32 values in
    int64, total_bits[B] int32); bits past out_words words are dropped."""
    B, F = values.shape
    dev = values.device
    nb = nbbits.to(torch.int64)
    vals = values.to(torch.int64) & _M32 & u32_mask(nb)
    offs = torch.cumsum(nb, dim=1) - nb          # exclusive prefix sum
    total_bits = offs[:, -1] + nb[:, -1] if F else torch.zeros(B, dtype=torch.int64,
                                                               device=dev)
    word = offs >> 5
    sh = offs & 31
    lo = (vals << sh) & _M32
    hi = torch.where(sh == 0, 0, vals >> (32 - sh))
    base = torch.arange(B, device=dev)[:, None] * (out_words + 1)
    acc = torch.zeros(B * (out_words + 1), dtype=torch.int64, device=dev)
    acc.index_add_(0, (base + word.clamp(max=out_words)).reshape(-1), lo.reshape(-1))
    acc.index_add_(0, (base + (word + 1).clamp(max=out_words)).reshape(-1),
                   hi.reshape(-1))
    words = acc.reshape(B, out_words + 1)[:, :out_words] & _M32
    return words, total_bits.to(torch.int32)


def initial_bitpos(stream_u8: torch.Tensor, csize: torch.Tensor):
    """Absolute bit offset of the endMark (== payload bit count), and
    whether it is missing.

    stream_u8: [B, S]; csize: [B].  Mirrors BIT_initDStream's
    last-byte-highbit rule (bitstream.h:282-284): (bitpos[B] int32,
    bad[B] bool); csize 0 gives bitpos 0."""
    S = stream_u8.shape[1]
    cs = csize.to(torch.int64)
    idx = (cs - 1).clamp(min=0).clamp(max=S - 1)
    last = torch.gather(stream_u8, 1, idx[:, None])[:, 0].to(torch.int64)
    hb = highbit(last.clamp(min=1))
    bitpos = (cs - 1) * 8 + hb
    return torch.where(cs > 0, bitpos, 0).to(torch.int32), last == 0
