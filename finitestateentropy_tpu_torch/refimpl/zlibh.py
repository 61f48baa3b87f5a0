"""zlibh decoder — zlib's Huffman-only block format (programs/zlibh.c).

The reference ships zlib's static/dynamic Huffman coder as a comparison
baseline (`fse -z`).  This module implements BOTH directions: the decoder
reads frames produced by the reference CLI, and the encoder reproduces the
reference's output byte for byte (zlib tree build with the depth
tie-break, the send_tree RLE, and the exact 16-bit bit-writer cadence).

Block layout (bits read LSB-first from LE bytes, ZLIBH_inflate
zlibh.c:1492-1665):
  1 bit: 0 = dynamic block, 1 = fixed (deflate's static literal code)
  dynamic: 4 bits (ncode-4); ncode x 3-bit code-length-code lengths in the
  deflate `order`; then 257 literal code lengths with the 16/17/18 repeat
  escapes; codes are canonical deflate codes (RFC1951 bit order).
  payload: literal codes; symbol 256 = end of block.
"""
from __future__ import annotations

from ..errors import CorruptionError

_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
_MAXBITS = 15

# deflate's fixed literal/length code: 0-143 -> 8 bits, 144-255 -> 9,
# 256-279 -> 7, 280-287 -> 8 (only 0..256 ever occur in zlibh streams)
_FIXED_LENS = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


class _BitReader:
    __slots__ = ("data", "pos", "hold", "bits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.hold = 0
        self.bits = 0

    def need(self, n: int) -> None:
        while self.bits < n:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            if self.pos >= len(self.data) + 4:
                raise CorruptionError("zlibh: out of input")
            self.pos += 1
            self.hold |= b << self.bits
            self.bits += 8

    def take(self, n: int) -> int:
        self.need(n)
        v = self.hold & ((1 << n) - 1)
        self.hold >>= n
        self.bits -= n
        return v


class _Huffman:
    """Canonical deflate code: decode via the counts/offsets walk
    (the classic public-domain 'puff' structure)."""

    def __init__(self, lens):
        self.counts = [0] * (_MAXBITS + 1)
        for l in lens:
            self.counts[l] += 1
        self.counts[0] = 0
        left = 1
        for l in range(1, _MAXBITS + 1):
            left = (left << 1) - self.counts[l]
            if left < 0:
                raise CorruptionError("zlibh: over-subscribed code")
        offs = [0] * (_MAXBITS + 2)
        for l in range(1, _MAXBITS + 1):
            offs[l + 1] = offs[l] + self.counts[l]
        self.symbols = [0] * offs[_MAXBITS + 1]
        for sym, l in enumerate(lens):
            if l:
                self.symbols[offs[l]] = sym
                offs[l] += 1

    def decode(self, br: _BitReader) -> int:
        code = first = index = 0
        for length in range(1, _MAXBITS + 1):
            code |= br.take(1)
            count = self.counts[length]
            if code - first < count:
                return self.symbols[index + code - first]
            index += count
            first = (first + count) << 1
            code <<= 1
        raise CorruptionError("zlibh: invalid code")


def zlibh_decompress(comp: bytes, dst_size: int) -> bytes:
    br = _BitReader(comp)
    if br.take(1) == 1:                      # fixed block
        lcode = _Huffman(_FIXED_LENS)
    else:                                    # dynamic block
        ncode = br.take(4) + 4
        cl_lens = [0] * 19
        for i in range(ncode):
            cl_lens[_ORDER[i]] = br.take(3)
        clcode = _Huffman(cl_lens)
        lens: list[int] = []
        while len(lens) < 257:
            sym = clcode.decode(br)
            if sym < 16:
                lens.append(sym)
            elif sym == 16:
                if not lens:
                    raise CorruptionError("zlibh: repeat with no previous")
                lens.extend([lens[-1]] * (3 + br.take(2)))
            elif sym == 17:
                lens.extend([0] * (3 + br.take(3)))
            else:
                lens.extend([0] * (11 + br.take(7)))
        if len(lens) > 257:
            raise CorruptionError("zlibh: too many code lengths")
        if lens[256] == 0:
            raise CorruptionError("zlibh: missing end-of-block code")
        lcode = _Huffman(lens)

    out = bytearray()
    while True:
        sym = lcode.decode(br)
        if sym == 256:
            break
        if sym > 256 or len(out) >= dst_size:
            # >= : appending would exceed the declared regenerated size, so
            # the stream is corrupt even if end-of-block follows immediately
            raise CorruptionError("zlibh: corrupt literal stream")
        out.append(sym)
    return bytes(out)


# ---------------------------------------------------------------------------
# Encoder (ZLIBH_compress, zlibh.c:781-848)
# ---------------------------------------------------------------------------
#
# Byte-parity caveat: the reference sizes each block as (bits+8)>>3, which
# when bits % 8 == 0 copies one byte the bit writer never wrote (stale
# buffer content in the C program).  We emit a zero there, so frames are
# byte-identical except possibly that final per-block byte; the acceptance
# tests therefore check cross-decode + exact sizes.

_REP_3_6, _REPZ_3_10, _REPZ_11_138 = 16, 17, 18
_EXTRA_BLBITS = (0,) * 16 + (2, 3, 7)
_MAX_BL_BITS = 7


class _Tree:
    """zlib-semantics Huffman build: array heap with the depth tie-break
    (zlibh.c build_tree/pqdownheap/gen_bitlen/gen_codes)."""

    def __init__(self, freqs, max_length, static_lens=None, extra=None,
                 extra_base=0):
        elems = len(freqs)
        self.freq = list(freqs) + [0] * (2 * elems + 1 - elems)
        self.len = [0] * (2 * elems + 1)
        self.code = [0] * (2 * elems + 1)
        self.dad = [0] * (2 * elems + 1)
        self.opt_len = 0
        self.static_len = 0
        depth = [0] * (2 * elems + 1)
        heap = [0] * (2 * elems + 2)  # heap[0] = count
        extra = extra or ()

        max_code = -1
        for n in range(elems):
            if self.freq[n]:
                heap[0] += 1
                heap[heap[0]] = max_code = n
            else:
                self.len[n] = 0
        self.max_code = max_code

        def smaller(n, m):
            return self.freq[n] < self.freq[m] or (
                self.freq[n] == self.freq[m] and depth[n] <= depth[m])

        def downheap(k):
            v = heap[k]
            j = k << 1
            while j <= heap[0]:
                if j < heap[0] and smaller(heap[j + 1], heap[j]):
                    j += 1
                if smaller(v, heap[j]):
                    break
                heap[k] = heap[j]
                k = j
                j <<= 1
            heap[k] = v

        def acct(n, bits):
            xbits = extra[n - extra_base] if (extra and n >= extra_base) else 0
            f = self.freq[n]
            self.opt_len += f * (bits + xbits)
            if static_lens is not None:
                self.static_len += f * (static_lens[n] + xbits)

        if heap[0] > 1:
            heap_max = 2 * elems + 1
            for n in range(heap[0] // 2, 0, -1):
                downheap(n)
            node = elems
            while heap[0] >= 2:
                n = heap[1]
                heap[1] = heap[heap[0]]
                heap[0] -= 1
                downheap(1)
                m = heap[1]
                heap_max -= 1
                heap[heap_max] = n
                heap_max -= 1
                heap[heap_max] = m
                self.freq[node] = self.freq[n] + self.freq[m]
                depth[node] = max(depth[n], depth[m]) + 1
                self.dad[n] = self.dad[m] = node
                heap[1] = node
                node += 1
                downheap(1)
            heap_max -= 1
            heap[heap_max] = heap[1]

            # gen_bitlen
            bl_count = [0] * (_MAXBITS + 1)
            self.len[heap[heap_max]] = 0
            overflow = 0
            for h in range(heap_max + 1, 2 * elems + 1):
                n = heap[h]
                bits = self.len[self.dad[n]] + 1
                if bits > max_length:
                    bits = max_length
                    overflow += 1
                self.len[n] = bits
                if n > max_code:
                    continue
                bl_count[bits] += 1
                acct(n, bits)
            if overflow:
                while overflow > 0:
                    bits = max_length - 1
                    while bl_count[bits] == 0:
                        bits -= 1
                    bl_count[bits] -= 1
                    bl_count[bits + 1] += 2
                    bl_count[max_length] -= 1
                    overflow -= 2
                h = 2 * elems + 1
                for bits in range(max_length, 0, -1):
                    n = bl_count[bits]
                    while n:
                        h -= 1
                        m = heap[h]
                        if m > max_code:
                            continue
                        if self.len[m] != bits:
                            self.opt_len += (bits - self.len[m]) * self.freq[m]
                            self.len[m] = bits
                        n -= 1

            # gen_codes (canonical, bit-reversed)
            next_code = [0] * (_MAXBITS + 1)
            code = 0
            for bits in range(1, _MAXBITS + 1):
                code = (code + bl_count[bits - 1]) << 1
                next_code[bits] = code
            for n in range(max_code + 1):
                l = self.len[n]
                if l:
                    c = next_code[l]
                    next_code[l] += 1
                    self.code[n] = int(f"{c:0{l}b}"[::-1], 2)
        elif heap[0] == 1:
            # single code: one-bit code (zlibh.c:757-778)
            for n in range(max_code):
                self.len[n] = 0
            self.len[max_code] = 1
            xbits = extra[max_code - extra_base] if (extra and max_code >= extra_base) else 0
            f = self.freq[max_code]
            self.opt_len += f * (1 + xbits)
            if static_lens is not None:
                self.static_len += f * (static_lens[max_code] + xbits)
            self.code[max_code] = 0
        else:
            self.max_code = 0


class _BitWriter:
    """Exact SENDBITS/flush semantics (16-bit buffer, zlibh.c:328-343)."""

    __slots__ = ("out", "buf", "valid")

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.valid = 0

    def send(self, value: int, length: int) -> None:
        if self.valid > 16 - length:
            self.buf |= (value << self.valid) & 0xFFFFFFFF
            self.out.append(self.buf & 0xFF)
            self.out.append((self.buf >> 8) & 0xFF)
            self.buf = value >> (16 - self.valid)
            self.valid += length - 16
        else:
            self.buf |= value << self.valid
            self.valid += length

    def finish(self) -> bytes:
        if self.valid > 8:
            self.out.append(self.buf & 0xFF)
            self.out.append((self.buf >> 8) & 0xFF)
        elif self.valid > 0:
            self.out.append(self.buf & 0xFF)
        return bytes(self.out)


def _static_codes():
    lens = _FIXED_LENS
    bl_count = [0] * (_MAXBITS + 1)
    for l in lens:
        bl_count[l] += 1
    next_code = [0] * (_MAXBITS + 1)
    code = 0
    for bits in range(1, _MAXBITS + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    codes = []
    for l in lens:
        c = next_code[l]
        next_code[l] += 1
        codes.append(int(f"{c:0{l}b}"[::-1], 2))
    return codes


_STATIC_CODES = _static_codes()


def zlibh_compress(src: bytes) -> bytes:
    """ZLIBH_compress twin. Returns exactly (bits+8)>>3 bytes per the
    reference's size contract (zero-padded where the C leaves stale bytes)."""
    freqs = [0] * 257
    for b in src:
        freqs[b] += 1
    freqs[256] = 1

    ltree = _Tree(freqs, _MAXBITS, static_lens=_FIXED_LENS)

    # feed_bltree: RLE stats of the literal code lengths (zlibh.c:482-527)
    bl_freq = [0] * 19
    lens = ltree.len[:258]
    lens = lens[:257] + [0xFFFF]
    prevlen, count = -1, 0
    nextlen = lens[0]
    max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)
    for n in range(257):
        curlen, nextlen = nextlen, lens[n + 1]
        count += 1
        if count < max_count and curlen == nextlen:
            continue
        elif count < min_count:
            bl_freq[curlen] += count
        elif curlen != 0:
            if curlen != prevlen:
                bl_freq[curlen] += 1
            bl_freq[_REP_3_6] += 1
        elif count <= 10:
            bl_freq[_REPZ_3_10] += 1
        else:
            bl_freq[_REPZ_11_138] += 1
        count, prevlen = 0, curlen
        if nextlen == 0:
            max_count, min_count = 138, 3
        elif curlen == nextlen:
            max_count, min_count = 6, 3
        else:
            max_count, min_count = 7, 4

    bltree = _Tree(bl_freq, _MAX_BL_BITS, extra=_EXTRA_BLBITS, extra_base=0)

    max_blindex = 18
    while max_blindex >= 3 and bltree.len[_ORDER[max_blindex]] == 0:
        max_blindex -= 1
    bl_opt = bltree.opt_len + 3 * (max_blindex + 1) + 4

    w = _BitWriter()
    if bl_opt + ltree.opt_len < ltree.static_len:      # dynamic block
        blcodes = max_blindex + 1
        w.buf = (blcodes - 4) << 1                      # type bit 0 + ncode
        w.valid = 5
        for n in range(blcodes):
            w.send(bltree.len[_ORDER[n]], 3)
        # send_tree (merged in ZLIBH_compress_block, zlibh.c:357-433)
        prevlen, count = -1, 0
        nextlen = lens[0]
        max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)
        for n in range(257):
            curlen, nextlen = nextlen, lens[n + 1]
            count += 1
            if count < max_count and curlen == nextlen:
                continue
            elif count < min_count:
                for _ in range(count):
                    w.send(bltree.code[curlen], bltree.len[curlen])
            elif curlen != 0:
                if curlen != prevlen:
                    w.send(bltree.code[curlen], bltree.len[curlen])
                    count -= 1
                w.send(bltree.code[_REP_3_6], bltree.len[_REP_3_6])
                w.send(count - 3, 2)
            elif count < 11:
                w.send(bltree.code[_REPZ_3_10], bltree.len[_REPZ_3_10])
                w.send(count - 3, 3)
            else:
                w.send(bltree.code[_REPZ_11_138], bltree.len[_REPZ_11_138])
                w.send(count - 11, 7)
            count, prevlen = 0, curlen
            if nextlen == 0:
                max_count, min_count = 138, 3
            elif curlen == nextlen:
                max_count, min_count = 6, 3
            else:
                max_count, min_count = 7, 4
        codes, code_lens = ltree.code, ltree.len
        total_bits = bl_opt + ltree.opt_len
    else:                                               # static block
        w.buf = 1                                       # type bit 1
        w.valid = 1
        codes, code_lens = _STATIC_CODES, _FIXED_LENS
        total_bits = ltree.static_len

    for b in src:
        w.send(codes[b], code_lens[b])
    w.send(codes[256], code_lens[256])
    out = bytearray(w.finish())

    size = (total_bits + 8) >> 3
    out.extend(b"\0" * max(0, size - len(out)))
    return bytes(out[:size])
