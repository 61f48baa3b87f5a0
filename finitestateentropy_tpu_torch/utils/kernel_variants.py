"""Variants of the flat-rank, v0, FSE and Huff0 kernels, built side by
side and timed on one card:

    python -m finitestateentropy_tpu_torch.utils.kernel_variants [name ...]

A variant is the committed source of csrc/rans_decode_flat.cu,
csrc/turbo_fse_decode.cu, csrc/fse_encode.cu, csrc/fse_decode.cu,
csrc/huf_encode.cu or csrc/huf_decode.cu with a few text substitutions:
another number of state chains a thread, another way to exchange the warps'
counts, another chunk, ring or number of blocks a CTA, the FSE encode's
placement after its chains instead of beside them, the first design's loop
forced (the Huff0 kernels' fallbacks), or one part of the step taken out.
The last kind (``TIMING_ONLY``) computes wrong results: it only shows what
the part costs.  Every variant is built with nvcc into
build/kernel_variants/ (one process per variant, started together),
launched through its C entry on the batches of chip_smoke.py's paths
(ratio mode on 64 x 1 MiB of Proba80, the totals wire on 3 MiB, v1 pair
frames on 8 MiB, v0 frames on 16 x 1 MiB, the FSE and Huff0 codecs' 2048
blocks of 32 KiB of Proba80; the X2 decode's variants on the first 256 of
those blocks and on all 2048), held against the plain version and timed
(CUDA events, mean of 20 launches, the better of two rounds).  Prints one
JSON line: {"gpu", "ms": {"variant/case": ms}, "exact": {"variant/case":
bool}}.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..turbo import api
from ..turbo import kernels as v0
from ..turbo import rans_kernels as rk
from ..turbo._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from ..turbo.format import parse_group, turbo_fse_compress
from ..turbo.state import to_tensors
from .probagen import generate_proba

FLAT, V0 = "rans_decode_flat", "turbo_fse_decode"
FSE_ENC, FSE_DEC = "fse_encode", "fse_decode"
HUF_ENC, HUF_DEC = "huf_encode", "huf_decode"
_CHAINS = "constexpr int kChains = {}; "
_FLAT_EXCHANGE = """\
      const int rc = lane < kWarps ? cnt[s & 1][lane] : 0;
      const int below = __reduce_add_sync(kFull, lane < w ? rc : 0);
      const int total = __reduce_add_sync(kFull, rc);
"""
_FLAT_SELECT_SUM = """\
      int below = 0, total = 0;
#pragma unroll
      for (int q = 0; q < kWarps / 4; ++q) {
        const int4 c4 = reinterpret_cast<const int4*>(cnt[s & 1])[q];
        const int rc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          below += 4 * q + r < w ? rc[r] : 0;
          total += rc[r];
        }
      }
"""
_V0_SELECT_SUM = """\
        int below = 0, total = 0;
#pragma unroll
        for (int k = 0; k < kWarps / 4; ++k) {
          const int4 c4 = reinterpret_cast<const int4*>(cnt[s & 1])[k];
          const int rt[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            below += 4 * k + r < w ? rt[r] : 0;
            total += rt[r];
          }
        }
"""
_V0_WARP_REDUCE = """\
        const int rc = lane < kWarps ? cnt[s & 1][lane] : 0;
        const int below = __reduce_add_sync(kFull, lane < w ? rc : 0);
        const int total = __reduce_add_sync(kFull, rc);
"""
_V0_BALLOTS = """\
        int excl = 0, wtot = 0;
#pragma unroll
        for (int b = 0; b < kSumBits; ++b) {
          const unsigned bb = __ballot_sync(kFull, (sum >> b) & 1);
          excl += __popc(bb & lt_mask) << b;
          wtot += __popc(bb) << b;
        }
"""
_FLAT_BALLOTS = """\
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        word[j] |= advance<MODE>(tbl, aux, x[j], tlog, mask) << (kParts * p);
        bal[j] = __ballot_sync(kFull, x[j] < kRansL);
"""
_BARRIER = "      __syncthreads();\n      // every warp is past"
_ENC_PLACE = ("      if (k > 0) place_chunk(k - 1);\n", "")
_ENC_ZERO = ("          words[static_cast<size_t>(b0 + p) * W + wd] = 0;", "          ;")
_HUF_ATOMICS = ("""\
    if (width > 0 || lane == 0) atomicOr(wb + w, lo << sh | (lane == 0 ? carry : 0u));
    if (sh + width > 32) atomicOr(wb + w + 1, __funnelshift_l(lo, hi, sh));
    if (sh + width > 64) atomicOr(wb + w + 2, hi >> (32 - sh));
""", "    if (lo == 0xFFFFFFFFu && sh == 31) wb[w] = hi;\n")
_HUF_REQUEST = ("      w.request();\n#pragma unroll", "#pragma unroll")
_HUF_BELOW = ('        : "r"(a), "r"(static_cast<int>(take && inside)));',
              '        : "r"(a), "r"(0));')

_X2_GLOBAL = ("const bool on_global = !fast[pb]", "const bool on_global = true || !fast[pb]")
# The X2 kernel's first design: a thread a stream, 32 threads a
# block, the packed table and the stream in global memory (x2_global's
# loop; its wrapper zero-filled the output, so the kernel zeroes the rest)
_X2_FIRST = [('extern "C" int huf_decode_launch(', """\
namespace {
__global__ void huf_decode_kernel_x2_first(const uint8_t* __restrict__ streams, int S,
                                           const int32_t* __restrict__ csize,
                                           const int32_t* __restrict__ n_out,
                                           const int32_t* __restrict__ tlog,
                                           const int32_t* __restrict__ tbl0, int T,
                                           uint8_t* __restrict__ out, int max_seg,
                                           bool* __restrict__ err, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint8_t* row = streams + static_cast<size_t>(r) * S;
  bool bad;
  const int bitpos = compat::initial_bitpos(row, S, csize[r], &bad);
  uint8_t* orow = out + static_cast<size_t>(r) * max_seg;
  int bytes;
  const int c = x2_global(reinterpret_cast<const uint32_t*>(row), S / 4 - 1, bitpos, tlog[r],
                          tbl0 + static_cast<size_t>(r) * T, T, n_out[r], max_seg, orow, &bytes);
  for (int z = min(bytes, max_seg); z < max_seg; ++z) orow[z] = 0;
  err[r] = n_out[r] > 0 && (c != 0 || bytes != n_out[r] || bad);
}
}  // namespace

extern "C" int huf_decode_launch("""), ("""\
  if (x2) {
    const int per_cta = per_cta_for(R, kX2Blocks);""", """\
  if (x2) {
    huf_decode_kernel_x2_first<<<(R + 31) / 32, 32, 0, s>>>(
        st, S, static_cast<const int32_t*>(csize), static_cast<const int32_t*>(n_out),
        static_cast<const int32_t*>(tlog), static_cast<const int32_t*>(tbl0), T,
        static_cast<uint8_t*>(out), max_seg, static_cast<bool*>(err), R);
    return static_cast<int>(cudaGetLastError());
  }
  if (false) {
    const int per_cta = per_cta_for(R, kX2Blocks);""")]


# The X2 table as u32 entries nbBits | (length-1) << 7 | seq << 8 (16 KiB
# a block) in place of the three byte planes: the lookup reads the word,
# the bytes come from its upper half
_X2_U32 = [
    ("constexpr int kTable2 = 3 * kSlot;", "constexpr int kTable2 = 4 * kSlot;"),
    ("""\
    *at = (__funnelshift_r(lo, hi, x) & mask) | tbase;
    const uint32_t e = smem[*at];""", """\
    *at = (__funnelshift_r(lo, hi, x) & mask) * 4 | tbase;
    const uint32_t e = *reinterpret_cast<const uint32_t*>(smem + *at);"""),
    ("""\
  *b0 = smem[at + kSlot];
  *b1 = smem[at + 2 * kSlot];""", """\
  const uint32_t e = *reinterpret_cast<const uint32_t*>(smem + at);
  *b0 = e >> 8;
  *b1 = e >> 16;"""),
    ("""\
  dst[i] = static_cast<uint8_t>(nl);
  dst[kSlot + i] = static_cast<uint8_t>(e);
  dst[2 * kSlot + i] = static_cast<uint8_t>(e >> 8);""",
     "  reinterpret_cast<uint32_t*>(dst)[i] = nl | (e & 0xFFFFu) << 8;"),
    ("""\
        *reinterpret_cast<uint32_t*>(dst + i) = nl;
        *reinterpret_cast<uint32_t*>(dst + kSlot + i) = gather_byte(v, 0);
        *reinterpret_cast<uint32_t*>(dst + 2 * kSlot + i) = gather_byte(v, 1);""", """\
        x2_put(dst, i, nl & 0xFF, v.x);
        x2_put(dst, i + 1, (nl >> 8) & 0xFF, v.y);
        x2_put(dst, i + 2, (nl >> 16) & 0xFF, v.z);
        x2_put(dst, i + 3, nl >> 24, v.w);""")]


def _x2_blocks(n: int) -> tuple:
    return ("constexpr int kX2Blocks = 16;", f"constexpr int kX2Blocks = {n};")


def _x2_batch(n: int) -> tuple:
    return ("constexpr int kX2Batch = 32;", f"constexpr int kX2Batch = {n};")


def _x2_lanes(n: int) -> tuple:
    return ("constexpr int kX2Lanes = 16;", f"constexpr int kX2Lanes = {n};")


# name -> (source, [(old, new), ...]); substitutions apply in order
VARIANTS = {
    "flat": (FLAT, []),
    "flat_chains1": (FLAT, [(_CHAINS.format(2), _CHAINS.format(1))]),
    "flat_chains4": (FLAT, [(_CHAINS.format(2), _CHAINS.format(4))]),
    "flat_chains8": (FLAT, [(_CHAINS.format(2), _CHAINS.format(8))]),
    # the first design's exchange: every thread sums the counts it selects
    "flat_select_sum": (FLAT, [(_FLAT_EXCHANGE, _FLAT_SELECT_SUM)]),
    # every chain's table read before the first ballot (no shared load
    # moves across a warp vote)
    "flat_loads_first": (FLAT, [(_FLAT_BALLOTS, """\
      uint32_t v[kChains];
#pragma unroll
      for (int j = 0; j < kChains; ++j) v[j] = advance<MODE>(tbl, aux, x[j], tlog, mask);
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        word[j] |= v[j] << (kParts * p);
        bal[j] = __ballot_sync(kFull, x[j] < kRansL);
""")]),
    "flat_int32_cursor": (FLAT, [("long long cursor = csize[g];",
                                  "int cursor = csize[g];")]),
    "flat_no_barrier": (FLAT, [(_BARRIER, "      // every warp is past")]),
    "flat_no_exchange": (FLAT, [
        (_FLAT_EXCHANGE, "      const int below = mine * w, total = mine * kWarps;\n"),
        (_BARRIER, "      // every warp is past")]),
    "flat_no_ring": (FLAT, [("(x[j] << 16) | ring.at(pc)",
                             "(x[j] << 16) | static_cast<uint16_t>(pc)")]),
    "flat_no_table": (FLAT, [(
        "word[j] |= advance<MODE>(tbl, aux, x[j], tlog, mask) << (kParts * p);",
        "{ const uint32_t e = (x[j] & mask) * 2654435761u; "
        "x[j] = ((e >> 8) & 0xFFFu) * (x[j] >> tlog) + (x[j] & mask) - (e >> 20); "
        "word[j] |= (e & 0xFFu) << (kParts * p); }")]),
    "v0": (V0, []),
    "v0_chains2": (V0, [(_CHAINS.format(4), _CHAINS.format(2))]),
    "v0_chains8": (V0, [(_CHAINS.format(4), _CHAINS.format(8))]),
    "v0_warp_reduce": (V0, [(_V0_SELECT_SUM, _V0_WARP_REDUCE)]),
    "v0_shuffle_scan": (V0, [(_V0_BALLOTS, """\
        int incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int excl = incl - sum, wtot = __shfl_sync(kFull, incl, 31);
""")]),
    "v0_no_barrier": (V0, [("        __syncthreads();\n        // every warp is past",
                            "        // every warp is past")]),
    "fse_encode": (FSE_ENC, []),
    # barrier phases: chunk k's fields placed after its chains, not beside k+1's
    "fse_encode_phases": (FSE_ENC, [
        _ENC_PLACE, ("      if (k + 1 < K) stage_chunk(k + 1);\n    }\n    __syncthreads();\n",
                     "      if (k + 1 < K) stage_chunk(k + 1);\n    }\n    __syncthreads();\n"
                     "    if (warp > 0 && k < K) place_chunk(k);\n    __syncthreads();\n")]),
    "fse_encode_chunk64": (FSE_ENC, [("constexpr int kChunk = 128;",
                                      "constexpr int kChunk = 64;")]),
    "fse_encode_blocks16": (FSE_ENC, [("constexpr int kMaxBlocks = 8;",
                                       "constexpr int kMaxBlocks = 16;")]),
    "fse_encode_blocks4": (FSE_ENC, [("constexpr int kMaxBlocks = 8;",
                                      "constexpr int kMaxBlocks = 4;")]),
    "fse_encode_helpers4": (FSE_ENC, [("constexpr int kHelpers = 8;",
                                       "constexpr int kHelpers = 4;")]),
    # parts taken out: the placement, the zeroing, both, or every helper's
    # work in the loop (the chains then walk chunks 0 and 1 over and over)
    "fse_encode_no_place": (FSE_ENC, [_ENC_PLACE]),
    "fse_encode_no_zero": (FSE_ENC, [_ENC_ZERO]),
    "fse_encode_stage_only": (FSE_ENC, [_ENC_PLACE, _ENC_ZERO]),
    "fse_encode_chain_alone": (FSE_ENC, [
        ("    fetch_chunk(0);\n    stage_chunk(0);\n",
         "    fetch_chunk(0);\n    stage_chunk(0);\n    fetch_chunk(1);\n    stage_chunk(1);\n"),
        ("      if (k + 1 < K) fetch_chunk(k + 1);\n", ""), _ENC_PLACE, _ENC_ZERO,
        ("      if (k + 1 < K) stage_chunk(k + 1);\n", "")]),
    "fse_decode": (FSE_DEC, []),
    "fse_decode_blocks8": (FSE_DEC, [("constexpr int kMaxBlocks = 4;",
                                      "constexpr int kMaxBlocks = 8;")]),
    "fse_decode_blocks16": (FSE_DEC, [("constexpr int kMaxBlocks = 4;",
                                       "constexpr int kMaxBlocks = 16;")]),
    "fse_decode_threads256": (FSE_DEC, [("constexpr int kThreads = 128;",
                                         "constexpr int kThreads = 256;")]),
    # every block through the first design's loop (global table, read_bits)
    "fse_decode_global": (FSE_DEC, [("  if (!fast[lane]) {", "  if (true) {")]),
    # the ring never refilled, or the symbols never stored
    "fse_decode_no_refill_load": (FSE_DEC, [("      stage::cp_async16_if(p,", "      stage::cp_async16_if(false,")]),
    "fse_decode_no_store": (FSE_DEC, [(
        "        o128[t / kUnroll] = make_uint4(q[0], q[1], q[2], q[3]);",
        "        if ((q[0] & q[1] & q[2] & q[3]) == ~0u) o128[0] = make_uint4(q[0], 0, 0, 0);")]),
    "huf_encode": (HUF_ENC, []),
    # at most 32 registers a thread: 16 CTAs an SM, the batch in one wave
    "huf_encode_regs32": (HUF_ENC, [("__launch_bounds__(kThreads)\nhuf_encode_kernel",
                                     "__launch_bounds__(kThreads, 16)\nhuf_encode_kernel")]),
    # byte loads only (no aligned word a lane)
    "huf_encode_bytes": (HUF_ENC, [("  const int whole = by_word ? active / kChunk : 0;",
                                    "  const int whole = 0;")]),
    # every stream through the first design's thread-a-stream loop
    "huf_encode_serial": (HUF_ENC, [(
        "const bool shared_form = __syncthreads_and(ok);",
        "const bool shared_form = __syncthreads_and(ok) && false;")]),
    # no placement: the fields' bits never reach the word buffer
    "huf_encode_no_place": (HUF_ENC, [_HUF_ATOMICS]),
    "huf_decode": (HUF_DEC, []),
    # blocks a CTA and the lanes of a chain warp: (16, 16) is four chain warps
    # of 16 streams a CTA, one CTA an SM
    **{f"huf_decode_b{b}l{n}": (HUF_DEC, [
        ("constexpr int kMaxBlocks = 16;", f"constexpr int kMaxBlocks = {b};"),
        ("constexpr int kChainLanes = 16;", f"constexpr int kChainLanes = {n};")])
       for b, n in ((16, 32), (16, 8), (8, 16), (4, 16))},
    # steps a ring request: 16 or 32 (the ring's reach and size follow)
    **{f"huf_decode_batch{n}": (HUF_DEC, [("constexpr int kBatch = 64;",
                                           f"constexpr int kBatch = {n};")]) for n in (16, 32)},
    # a request as kUnits predicated copies, not a loop
    "huf_decode_request_unrolled": (HUF_DEC, [(
        "    for (int u = 0; u < G::units && low > want && low >= 4; ++u) {\n"
        "      low -= 4;\n"
        "      stage::cp_async16(ring + ((low + lead) & (G::ring - 1)), words + low);\n"
        "    }",
        "#pragma unroll\n"
        "    for (int u = 0; u < G::units; ++u) {\n"
        "      const bool p = low > want && low >= 4;\n"
        "      stage::cp_async16_if(p, ring + ((low - 4 + lead) & (G::ring - 1)), "
        "words + max(low - 4, 0));\n"
        "      low = p ? low - 4 : low;\n"
        "    }")]),
    # the wait for the ring's copies: the last request's too
    "huf_decode_inflight1": (HUF_DEC, [("constexpr int kInFlight = 2;",
                                        "constexpr int kInFlight = 1;")]),
    # `below` loaded every step, not only when a refill took its low half
    "huf_decode_below_every": (HUF_DEC, [("    fetch_below(take);",
                                          "    fetch_below(true);")]),
    # every stream through the first design's loop (global tables, read_bits)
    "huf_decode_global": (HUF_DEC, [("  if (!fast[pb] || bitpos", "  if (true || bitpos")]),
    # parts taken out: the lookups' bank conflicts (every lane in banks of
    # its own, wrong entries), the ring's requests, its reads, both, the
    # output stores
    "huf_decode_no_conflict": (HUF_DEC, [(
        "smem + ((__funnelshift_r(lo, hi, x) & mask2) | tbase)",
        "smem + ((__funnelshift_r(lo, hi, x) & mask2 & ~0x3Cu) | tbase | "
        "((threadIdx.x & 15) << 2))")]),
    "huf_decode_no_request": (HUF_DEC, [_HUF_REQUEST]),
    "huf_decode_no_below": (HUF_DEC, [_HUF_BELOW]),
    "huf_decode_chain_alone": (HUF_DEC, [_HUF_REQUEST, _HUF_BELOW]),
    "huf_decode_no_store": (HUF_DEC, [(
        "        o128[(i + h) / kUnroll] = make_uint4(q[0], q[1], q[2], q[3]);",
        "        if ((q[0] & q[1] & q[2] & q[3]) == ~0u) o128[0] = make_uint4(q[0], 0, 0, 0);")]),
    # the X2 decode (launched with x2 = 1; X2_CASES): as committed; every
    # stream through the first design's loop in this launch shape, or the
    # first design's own kernel and launch; blocks a CTA and the lanes of
    # a chain warp (4: a block's streams in a warp of their own); the steps
    # a ring request; the table as u32 entries nbBits | (length-1) << 7 |
    # seq << 8 (16 KiB a block: 8 blocks a CTA)
    "huf_decode_x2": (HUF_DEC, []),
    "huf_decode_x2_global": (HUF_DEC, [_X2_GLOBAL]),
    "huf_decode_x2_first": (HUF_DEC, _X2_FIRST),
    **{f"huf_decode_x2_b{b}": (HUF_DEC, [_x2_blocks(b)]) for b in (8, 4)},
    **{f"huf_decode_x2_lanes{n}": (HUF_DEC, [_x2_lanes(n)]) for n in (32, 8, 4)},
    "huf_decode_x2_batch16": (HUF_DEC, [_x2_batch(16)]),
    "huf_decode_x2_b8_batch64": (HUF_DEC, [_x2_blocks(8), _x2_batch(64)]),
    "huf_decode_x2_b8_u32": (HUF_DEC, [_x2_blocks(8), *_X2_U32]),
    # parts taken out: the output bytes' staging stores; rows 1-3's loads
    # (each block's tables read once, not four times)
    "huf_decode_x2_no_stage": (HUF_DEC, [(
        "        staged[p & (kStage - 1)] = static_cast<uint8_t>(b0);\n"
        "        staged[(p + 1) & (kStage - 1)] = static_cast<uint8_t>(b1);\n", "")]),
    "huf_decode_x2_one_row": (HUF_DEC, [
        (f"        const uint4 v{k} = __ldg(reinterpret_cast<const uint4*>(t0 + o{k} + i));",
         f"        const uint4 v{k} = v;") for k in (1, 2, 3)]),
}
TIMING_ONLY = ("flat_no_barrier", "flat_no_exchange", "flat_no_ring",
               "flat_no_table", "v0_no_barrier", "fse_encode_no_place",
               "fse_encode_no_zero", "fse_encode_stage_only", "fse_encode_chain_alone",
               "fse_decode_no_refill_load", "fse_decode_no_store", "huf_encode_no_place",
               "huf_decode_no_conflict", "huf_decode_no_request", "huf_decode_no_below",
               "huf_decode_chain_alone", "huf_decode_no_store", "huf_decode_x2_no_stage",
               "huf_decode_x2_one_row")
# the cases each source is timed on; the X2 variants' (HUF_DEC launched
# with x2 = 1): the Huff0 codec's first 256 blocks (chip_smoke.py's x2
# path) and all 2048
CASES_OF = {FLAT: ("v1_byte_64", "totals_3", "v1_pair_8"), V0: ("v0_16",),
            FSE_ENC: ("fse_p80_2048",), FSE_DEC: ("fse_p80_2048", "fse_codec_2048"),
            HUF_ENC: ("huf_p80_2048",), HUF_DEC: ("huf_p80_2048",)}
X2_CASES = ("huf_x2_256", "huf_x2_2048")


def is_x2(name: str) -> bool:
    return name.startswith("huf_decode_x2")


def cases_of(name: str) -> tuple:
    return X2_CASES if is_x2(name) else CASES_OF[VARIANTS[name][0]]


def variant_source(name: str) -> str:
    """The source of variant `name`: each substitution must match once."""
    src, subs = VARIANTS[name]
    text = (CSRC / f"{src}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(names) -> dict[str, ctypes.CDLL]:
    out_dir = BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name))
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _fse_cases(corpus: bytes) -> dict:
    """{case: {source: (launch arguments, the plain version's outputs)}} of
    the FSE codec's batch of 64 MiB in 32 KiB blocks, staged as the codec
    stages it: fse_p80_2048 the encode, and the decode of its words;
    fse_codec_2048 the decode of the codec's compressed blocks, staged by
    its decode_inputs (as chip_smoke.py's fse path stages them)."""
    from ..models.fse_codec import FseTpuCodec
    from ..ops import bitio, fse_kernels, fse_tables

    codec = FseTpuCodec()
    blocks = [corpus[i:i + codec.block_size] for i in range(0, len(corpus), codec.block_size)]
    e = codec.encode_inputs(codec.encode_plan(blocks)[1])
    t = {k: torch.from_numpy(v).to("cuda") for k, v in e.items() if k in ("src", "n", "norm", "tlog")}
    ct = [c.contiguous() for c in fse_tables.build_ctables(t["norm"], t["tlog"])]
    enc = (t["src"], t["n"], t["tlog"], ct)
    words, csize = fse_kernels.fse_encode_batch_plain(*enc, max_syms=e["max_syms"],
                                                      out_bytes=e["out_bytes"])
    streams = bitio.words_to_bytes(words)
    packed = fse_kernels.pack_dtable(*fse_tables.build_dtables(t["norm"], t["tlog"])[:3])
    want_dec = fse_kernels.fse_decode_batch_plain(
        streams, csize, t["n"], t["tlog"], fse_tables.build_dtables(t["norm"], t["tlog"])[:3],
        max_out=e["max_syms"])
    items = [(r.data, len(b)) for r, b in zip(codec.compress_blocks(blocks), blocks)]
    d = codec.decode_inputs(items)
    u = {k: torch.from_numpy(d[k]).to("cuda") for k in ("streams", "csize", "n_out", "norm", "tlog")}
    dt = fse_tables.build_dtables(u["norm"], u["tlog"])[:3]
    dec = (u["streams"], u["csize"], u["n_out"], u["tlog"])
    return {"fse_p80_2048": {
        FSE_ENC: ((enc, e["max_syms"], e["out_bytes"]), (words, csize)),
        FSE_DEC: ((streams, csize, t["n"], t["tlog"], packed, e["max_syms"]), want_dec)},
        "fse_codec_2048": {FSE_DEC: ((*dec, fse_kernels.pack_dtable(*dt), d["max_out"]),
                                     fse_kernels.fse_decode_batch_plain(*dec, dt,
                                                                        max_out=d["max_out"]))}}


def _huf_cases(corpus: bytes, x2: bool) -> dict:
    """{"huf_p80_2048": {source: (launch arguments, the plain version's
    outputs)}}: the Huff0 codec's batch of 64 MiB in 32 KiB blocks, the
    encode staged by its encode_inputs and the X1 decode of its compressed
    blocks by its decode_inputs (as chip_smoke.py's huf path stages them);
    with x2 also "huf_x2_256" and "huf_x2_2048", the X2 decode of the first
    256 blocks and of all 2048, staged by the x2 codec's decode_inputs."""
    from ..models.huf_codec import HufTpuCodec
    from ..ops import huf_kernels

    codec = HufTpuCodec()
    blocks = [corpus[i:i + codec.block_size] for i in range(0, len(corpus), codec.block_size)]
    e = codec.encode_inputs(codec.encode_plan(blocks)[1])
    t = {k: torch.from_numpy(e[k]).to("cuda") for k in ("src", "n", "val", "nb")}
    enc = (t["src"], t["n"], t["val"].to(torch.int32).contiguous(),
           t["nb"].to(torch.int32).contiguous(), e["max_block"], e["seg_bytes"])
    items = [(r.data, len(b)) for r, b in zip(codec.compress_blocks(blocks), blocks)]
    d = codec.decode_inputs(items)
    u = {k: torch.from_numpy(d[k]).to("cuda") for k in ("streams", "csize", "n_out", "tlog",
                                                          "weights")}
    B = len(items)
    bt, nt = huf_kernels.build_dtables_x1(u["weights"], u["tlog"].view(B, 4)[:, 0])
    tables = (bt.repeat_interleave(4, dim=0), nt.repeat_interleave(4, dim=0))
    dec = (u["streams"], u["csize"], u["n_out"], u["tlog"], tables, d["max_seg"])
    out = {"huf_p80_2048": {HUF_ENC: (enc, huf_kernels.huf_encode_4x_batch_plain(*enc)),
                            HUF_DEC: (dec, huf_kernels.huf_decode_4x1_batch_plain(*dec))}}
    if x2:      # the X2 decode of the first 256 blocks and of all of them
        x2_codec = HufTpuCodec(decoder="x2")
        for case, nblk in (("huf_x2_256", 256), ("huf_x2_2048", B)):
            d2 = x2_codec.decode_inputs(items[:nblk])
            v = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in (
                d2["streams"], d2["csize"], d2["n_out"], np.repeat(d2["x2_tlog"], 4),
                np.repeat(d2["x2_tbl"], 4, axis=0))]
            args = (*v[:4], (v[4],), d2["max_seg"])
            out[case] = {HUF_DEC: (args, huf_kernels.huf_decode_4x2_batch_plain(
                *v, d2["max_seg"]))}
    return out


def _cases(srcs, x2: bool) -> dict:
    """{case: (launch arguments, the plain version's outputs)} on the card
    for the sources srcs (and the X2 cases with x2); the FSE and Huff0 cases
    by source."""
    group = 1 << 20
    corpus = generate_proba(80, 64 * group)

    def flat_case(data, mode, **flags):
        groups = api.parse_groups(api.turbo_compress_device(data, group, **flags))
        ((_w, n_pad, tlog, kind), idxs), = api.plan_decode(groups)[1].items()
        cs, tbl, init, hws, tots, t4, _h = api.stage_decode_batch(
            groups, idxs, n_pad, tlog, mode, kind)
        ins = to_tensors("cuda", csize_hw=cs, tables=tbl, init_states=init, streams=hws)
        cur = (None if tots is None else
               rk._decode_prep(ins["csize_hw"], to_tensors("cuda", steptots=tots)["steptots"])[0])
        want = rk._decode_plain(ins["tables"], ins["init_states"], ins["streams"], t4,
                                tlog, mode, cur, None, None if cur is not None else ins["csize_hw"])
        return (ins, cur, t4, tlog, mode), want[:2]

    cases = {}
    if FLAT in srcs:
        cases = {"v1_byte_64": flat_case(corpus, "byte", steptots=False),
                 "totals_3": flat_case(corpus[:3 * group], "byte", totals_only=True),
                 "v1_pair_8": flat_case(corpus[:8 * group], "pair", pair=1,
                                        steptots=False)}
    if V0 in srcs:
        cs, tbl, init, st, t4, wrows = v0.stage_groups(
            [parse_group(turbo_fse_compress(corpus[i * group:(i + 1) * group]))[0]
             for i in range(16)])
        ins = list(to_tensors("cuda", csize_bits=cs, tables=tbl, init_states=init,
                              streams=st).values())
        cases["v0_16"] = ((ins, t4), v0.turbo_fse_decode_plain(*ins, t4, wrows))
    if {FSE_ENC, FSE_DEC} & set(srcs):
        cases.update(_fse_cases(corpus))
    if {HUF_ENC, HUF_DEC} & set(srcs):
        cases.update(_huf_cases(corpus, x2))
    return cases


def _launcher(lib, src: str, args, x2: bool = False):
    """(launch(), outputs) of one variant on one case's inputs (the Huff0
    decode in mode x2 where x2 holds)."""
    entry = f"{src}_launch"
    fn = getattr(lib, entry)
    fn.argtypes = rk._SIGS[entry][1]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    if src == FSE_ENC:
        (s_u8, n, tl, (st, dfs, dnb)), max_syms, out_bytes = args
        B, S = s_u8.shape
        W = (out_bytes + 3) // 4
        outs = (torch.empty((B, W), dtype=torch.int32, device="cuda"),
                torch.empty((B,), dtype=torch.int32, device="cuda"))
        call = (s_u8.data_ptr(), S, n.data_ptr(), tl.data_ptr(), st.data_ptr(),
                st.shape[1], dfs.data_ptr(), dnb.data_ptr(), dfs.shape[1],
                outs[0].data_ptr(), W, outs[1].data_ptr(), B, max_syms, stream)
    elif src == FSE_DEC:
        streams, csize, n, tl, packed, max_out = args
        B, S = streams.shape
        outs = (torch.empty((B, max_out), dtype=torch.uint8, device="cuda"),
                torch.empty((B,), dtype=torch.bool, device="cuda"))
        call = (streams.data_ptr(), S, csize.data_ptr(), n.data_ptr(), tl.data_ptr(),
                packed.data_ptr(), packed.shape[1], outs[0].data_ptr(), max_out,
                outs[1].data_ptr(), B, stream)
    elif src == HUF_ENC:
        s_u8, n, val, nb, max_block, seg_bytes = args
        B, S = s_u8.shape
        W = (seg_bytes + 3) // 4
        outs = (torch.empty((B, 4, W), dtype=torch.int32, device="cuda"),
                torch.empty((B, 4), dtype=torch.int32, device="cuda"))
        call = (s_u8.data_ptr(), S, n.data_ptr(), val.data_ptr(), nb.data_ptr(), val.shape[1],
                outs[0].data_ptr(), W, outs[1].data_ptr(), B, max_block, stream)
    elif src == HUF_DEC:
        streams, csize, n_out, tl, tables, max_seg = args
        bt, nt = tables if not x2 else (tables[0], tables[0])
        R, S = streams.shape
        outs = (torch.empty((R, max_seg), dtype=torch.uint8, device="cuda"),
                torch.empty((R,), dtype=torch.bool, device="cuda"))
        call = (streams.data_ptr(), S, csize.data_ptr(), n_out.data_ptr(), tl.data_ptr(),
                bt.data_ptr(), nt.data_ptr(), bt.shape[1], int(x2), outs[0].data_ptr(),
                max_seg, outs[1].data_ptr(), R, stream)
    elif src == V0:
        (cs, tbl, init, st), t4 = args
        G = tbl.shape[0]
        outs = (torch.empty((G, t4 * 8, 128), dtype=torch.int32, device="cuda"),
                torch.empty((G,), dtype=torch.int32, device="cuda"))
        call = (cs.data_ptr(), tbl.data_ptr(), init.data_ptr(), st.data_ptr(),
                st[0].numel(), outs[0].data_ptr(), outs[1].data_ptr(), G, t4, stream)
    else:
        ins, cur, t4, tlog, mode = args
        tbl, strm = ins["tables"], ins["streams"]
        G = tbl.shape[0]
        outs = (torch.empty((G, t4 * 8, 128), dtype=torch.int32, device="cuda"),
                torch.empty((G, 8, 128), dtype=torch.int32, device="cuda"))
        cend = torch.empty((G,), dtype=torch.int32, device="cuda")
        call = (tbl.data_ptr(), tbl[0].numel(), ins["init_states"].data_ptr(),
                strm.data_ptr(), strm[0].numel() * 2, ins["csize_hw"].data_ptr(),
                None if cur is None else cur.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), cend.data_ptr(), G, t4, tlog,
                rk._MODE_ID[mode], stream)

    def launch():
        rc = fn(*call)
        if rc:
            raise RuntimeError(f"{entry}: CUDA launch failed (cudaError_t {rc})")
    return launch, outs


def _ms(launch, reps: int = 20) -> float:
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    libs = build(names)
    cases = _cases({VARIANTS[name][0] for name in names}, any(map(is_x2, names)))
    ms, exact = {}, {}
    for _round in range(2):
        for name in names:
            src = VARIANTS[name][0]
            for case in cases_of(name):
                args, want = (cases[case][src] if case.startswith(("fse_", "huf_"))
                              else cases[case])
                launch, outs = _launcher(libs[name], src, args, is_x2(name))
                key = f"{name}/{case}"
                print(key, file=sys.stderr, flush=True)
                t = _ms(launch)
                ms[key] = min(ms.get(key, t), t)
                exact[key] = all(torch.equal(o, w) for o, w in zip(outs, want))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"gpu": gpu, "timing_only": list(TIMING_ONLY), "ms": ms,
                      "exact": exact}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
