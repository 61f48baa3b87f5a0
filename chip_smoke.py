#!/usr/bin/env python3
"""Chip smoke for finitestateentropy_tpu_torch: the TurboRANS and compat codecs on one GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, one result line each:
  1. the GPU's name and power limit (nvidia-smi);
  2. build the CUDA sources of finitestateentropy_tpu_torch/csrc (nvcc, one
     process per source, started together) and the native host library
     (native/build.sh: the entry points' byte stats); the compat kernels'
     launch shapes at 2048 blocks, and the X2 decode's at 256 and 2048
     (blocks a CTA, shared memory, CTAs an SM holds, registers);
  3. every kernel entry in every mode against its plain PyTorch version on
     the GPU, bit for bit, on 3-group batches (1 MiB groups; 512 Ki-symbol
     U16 groups): the encodes (rans_encode2 byte / pair / quad in the
     row-local placement, rans_encode2_flat byte with and without step
     counts, u16 and u16x in the flat placement, rans_encode byte / u16 /
     u16x), and each decode entry (rans_decode_v2 and rans_decode_w on the
     rows and totals wires, rans_decode on v1 frames, turbo_fse_decode on
     v0 frames) with group 1 corrupted (its err must be set, the others'
     not); and the compat kernels (fse_encode, fse_decode, huf_encode_4x,
     huf_decode_4x x1 and x2) on 4 KiB blocks of Proba80 / 14 / 2, a
     ragged, an n = 2 and a 13-byte block, one endMark byte zeroed, and
     the FSE pair on two whole 32 KiB blocks (one decoded from an eighth
     of its stream) and on payloads past a 600-byte buffer;
  4. twenty-eight paths, each with the launch counts set to 0 just before it
     and read just after; twelve through the entry points
     (turbo_compress_device / turbo_decompress_device,
     turbo16_compress_device / turbo16_decompress_device):
       default_p80_64MiB  default flags, 64 MiB of Proba80 in 1 MiB groups:
                          the main path; every group is quad @ 10, so one
                          quad encode and one quad rans_decode_w launch;
       quad0_p80_8MiB     quad=0 on 8 MiB of Proba80: every group pair @ 9,
                          one pair encode and one pair rans_decode_w;
       byte_p80_64MiB, byte_p80_3MiB
                          the byte wire (pair=0, quad=0): one encode and one
                          rans_decode_w, or one rans_decode_v2 launch;
       default_mixed      default flags on the mixed 9000-byte input (pair,
                          pair, quad @ 9 with an odd step count, byte groups)
                          and on 64 KiB groups of Proba90, a pair- and a
                          quad-escape corpus and Proba14: pair, quad and byte
                          batches through rans_decode_v2;
       byte_mixed_9000    the mixed input on the byte wire: RLE / raw /
                          small groups;
       ratio_p80_64MiB    ratio mode (steptots=False): v1 byte frames @ 11,
                          one byte encode and one rans_decode launch;
       ratio_pair_p80_8MiB
                          pair=1 in ratio mode: v1 pair frames @ 9, one pair
                          encode and one pair rans_decode;
       totals_p80_64MiB, totals_p80_3MiB
                          the totals wire (totals_only=True): one byte encode
                          and one totals rans_decode_w (64 groups) or
                          rans_decode_v2 (3 groups);
       u16_pareto_64MiB   the U16 codec on 32 Mi symbols <= 1023 (the JAX
                          package's pareto(1.2) corpus) in 64 groups: speed
                          frames (decoded at windows=0, which routes them to
                          rans_decode_v2, and at windows=8: rans_decode_w)
                          and ratio frames (rans_decode);
       u16x_pareto_16MiB  the same on 8 Mi symbols <= 4095 (pareto(1.0)),
                          16 groups at tableLog 13, the split u16x tables;
       mesh_p80_64MiB     the entry points over a mesh of the visible GPUs
                          (make_mesh(); one on a one-card machine, which
                          still runs the sharded steps) in speed (byte wire)
                          and ratio mode: the sharded_turbo_encode_v2 /
                          sharded_turbo_encode and sharded_turbo_decode_v2 /
                          sharded_turbo_decode steps, one flat byte encode
                          and one decode per mode and shard; the frames must
                          equal the single-device ones;
     five more:
       mesh_u16_pareto    sharded_turbo16_roundtrip over the mesh on the u16
                          path's 64 groups: the flat u16 encode and v2:u16;
       u16codec_turbo     models.U16Codec(wire="turbo") on 8 groups of each
                          path's symbols: one encode and one v2 decode of
                          each alphabet; its frames are those paths' first
                          8 groups;
       dryrun_multichip   parallel/dryrun.py over the mesh's devices: every
                          sharded round trip on 8-128 KiB groups, and a
                          mixed frame through the entry points with mesh set;
       v0_p80_16MiB       the v0 TurboFSE codec: 16 x 1 MiB of Proba80
                          compressed by the numpy twin on the host, then one
                          turbo_fse_decode launch, which must give the input
                          back, as must turbo_fse_decompress;
     and the device-resident pipeline (turbo/device_api.py) and the CLI:
       resident_p80_64MiB rans_compress_resident on 64 MiB of Proba80 in GPU
                          memory (hist, normalization and tables on the GPU,
                          one byte encode), then rans_decompress_resident
                          (one rans_decode_v2); the same on 8 MiB with
                          totals_only=True (rans_decode_v2:totals) and
                          steptots=False (rans_decode:byte); the output,
                          on the GPU, equals the input, and the frames equal
                          the byte-wire paths' and the twin's;
       resident_roundtrip_p80_64MiB
                          rans_resident_roundtrip on the same 64 MiB: one
                          encode and one rans_decode_w, all in GPU memory;
       resident_mixed_16MiB
                          16 x 1 MiB of coded, random and RLE groups (the
                          JAX package's mixed corpus): the fused compress
                          classifies them, the coded ones decode through
                          rans_decode_w, the rest are rebuilt on the GPU;
       cli_p80_8MiB       python -m finitestateentropy_tpu_torch.cli -T on a
                          file of 8 MiB of Proba80 in a child process, then
                          -T -d: the file comes back and the .tfse equals
                          turbo_compress_device's (one quad encode and one
                          quad rans_decode_w, counted in the child).
     and the compat codecs (models/, io/frame.py) at the CLI's 32 KiB blocks:
       fse_p80_64MiB, huf_p80_64MiB
                          64 MiB of Proba80 through fio.compress_bytes with
                          FseTpuCodec / HufTpuCodec and back through
                          decompress_bytes: 2048 blocks, one encode and one
                          decode (x1) launch; the frames begin with the
                          blocks of the first 8 MiB's device frame, which
                          equals the host twin's; the twin decodes the
                          device frame of the first 4 MiB;
       huf_x2_p80_8MiB    the X2 decoder on that 8 MiB Huff0 frame (tables
                          built on the host): one x2 launch;
       huf_x2_p80_64MiB   the X2 decoder on the 64 MiB Huff0 frame: one x2
                          launch of 2048 blocks (a kernels row of its own);
       compat_mixed_8MiB  8 x 1 MiB of Proba80, Proba14, random and
                          one-byte groups and a ragged tail through FSE,
                          Huff0 and AutoTpuCodec, each decoded by its magic;
                          the frames equal the twin's;
       cli_compat_p80_8MiB
                          the CLI in a child process: -e, -h and --auto,
                          each then -d, and -z --device host then -d; the
                          frames equal --device host's (the twin's);
       mesh_compat_p80    the codecs over make_mesh() (one card: one shard):
                          sharded_encode / _decode / _huf_encode /
                          _huf_decode, a launch per shard; the frames equal
                          the single-device ones.
     Every round trip gives back its input and every TurboRANS frame equals
     the port's numpy twin of the wire and mode its group was coded in
     (quad_compress, pair_compress, rans_compress, rans16_compress);
  5. every batch of each path, planned and staged as the entry points do
     it (the dry run's on its own inputs and shapes; the resident paths'
     device ops also against their CPU runs, the host prep and the host
     table packers, and their encodes on the coded rows), through the wrappers
     on the GPU against the plain versions (err included); the batches per
     entry and mode (times the shards of the mesh each runs on) equal the
     path's launches, and every entry and mode is launched by
     some path but two, which no path of the JAX package runs either
     (rans_encode:byte, rans_encode2_flat:u16x): those are checked at the
     shapes of the byte and u16x paths; a compat batch is held whole
     against its plain version on the GPU, run once a distinct input (its
     decode batch staged from the items the frame layer handed the codec);
  6. end-to-end GB/s of the default-flag path (and of the byte wire), the
     entry points' own stage seconds on the default-flag path, the compat
     codecs' GB/s on their 64 MiB paths (median of 3) with the codecs' stage
     seconds and the frame checksum's time, the resident
     pipeline's rates (fused compress, round trip, mixed round trip and the
     resident entries whole; CUDA events, median of 3) with a
     torch.profiler split of rans_compress_resident by stage, per-step
     chain latencies (csrc/chain_probe.cu) and per-kernel-and-mode times
     at the shapes of the first path that launches each: the wrapper's
     launch call (CUDA events, mean of 20 calls, allocations included) and
     each CUDA kernel's own device time (torch.profiler), beside the GPU's
     name and power limit; the flat-rank and v0 rows carry the chain bound
     of their former design, a 1024-thread block a group
     (chain_bound_ms_1024), beside their own; and the host prep's c_prep
     with the native stats (api.prep_group) against the numpy prep
     (prep_split, three calls each);
  7. the bench (benchmarks/): fullbench.main over host stages 1 and 9 and
     the device stages 200-209, 215 and 210-214 at their default sizes
     (16 groups of 1 MiB; 64 blocks of 32 KiB), each stage's launches read
     around its timing (its kernel and no plain version), one output of
     each held against the same call with interpret=True (the TurboRANS
     stages) or the host twin and the input (the compat stages); then the
     CLI's -b -i2 in the -e, -h and -T modes on a file of 16 MiB of
     Proba80, each line carrying the ratio of the port's own frames.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure exits nonzero with no ok line,
as does a machine without a CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

GB = 1e9
GROUP = 1 << 20                # the entry points' default group size
GROUP16 = 1 << 19              # the U16 entry points' default group (symbols)
MAIN_MIB = 64                  # the default-flag, byte, ratio and totals paths
PAIR_MIB = 8                   # the quad=0 (pair) and ratio pair paths
U16_MSYMS = 32                 # Mi symbols of the u16 path (64 MiB)
U16X_MSYMS = 8                 # Mi symbols of the u16x path (16 MiB)
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES = 132 * 64         # H100 SXM: 132 SMs x 64 INT32 units (Hopper white paper)
# 32-bit integer operations one lane-step of the rANS math needs, whatever
# the design.  Encode: symbol extract 2 (byte p, pair id p or u16 symbol p:
# shift, mask; quad: mask 1), two table reads 2, freq and cumul fields 3,
# renorm threshold 2, emit and conditional shift 2, mulhi and
# multiply-subtract 2, two corrections 6, new state 3, rank among the
# flagged lanes (ballot, mask, popc) 3.  Byte and u16 decode: slot 1, table
# read 1, symbol into the output word 2, freq and cumul fields 3, state
# multiply-add and correction 4, renorm test 1, rank (ballot, mask, popc,
# row offset) 4, stream index 1, stream read 1, state refill 2.  u16x
# decode: slot 1, table read 1, freq and j fields 2, symbol-plane read 2,
# state multiply-add 2, symbol into the word 2, renorm test 1, rank 4,
# stream index 1, stream read 1, state refill 2.  Pair / quad decode: slot
# 1, table read 1, id, freq and j fields 4, LUT read 1, state multiply-add
# 2, renorm test 1, rank 4, stream index 1, stream read 1, state refill 2,
# and for pair the value into the output word 2 (a quad value is the
# word).  The flat-rank decode (v1 and totals) ranks as the rows decode
# does, with the warp's offset in the row offset's place, and adds per lane
# the cursor's update (v1) or load (totals) 1; the prefix of the 32 warp
# counts is 31 adds once per group-step, however many warps repeat it.
# The v0 TurboFSE decode: slot mask 1, table read 1, symbol field 1 and
# into the output word 2, nb field 2, base field 1, the lane's prefix add
# 1, field start 1, word index 1, two stream reads 2, shift amount 1, the
# 64-bit funnel shift 2, the nb-bit mask 2 and its and 1, new state 1; the
# prefix of the 32 warp totals is 31 adds per group-step, as above.
ENC_OPS_PER_STEP = {"byte": 25, "pair": 25, "quad": 24, "u16": 25, "u16x": 25}
DEC_OPS_PER_STEP = {"byte": 20, "pair": 20, "quad": 18, "u16": 20, "u16x": 19}
V0_OPS_PER_STEP = 20
FLAT_LANE_OPS = 1
FLAT_SCAN_ADDS = 31
V0_MIB = 16                    # the v0 path: its only encoder is the numpy twin
U16CODEC_GROUPS = 8            # U16Codec's turbo path: 8 groups of each alphabet
RES_SMALL_MIB = 8              # the resident path's totals and ratio pieces
RES_TLOG = 10                  # the resident speed mode's tableLog
MIXED_GROUPS = 16              # the resident mixed path: 16 x 1 MiB
CLI_MIB = 8                    # the CLI path
REPO = Path(__file__).resolve().parent
# the benchmarks phase: fullbench's host stages 1 and 9 and its device
# stages (stage -> the kernel key it launches; 202 and 203 are host work),
# and the CLI's -b on a file of BENCH_FILE_MIB of Proba80
BENCH_KERNEL = {200: "rans_encode2_flat:byte", 201: "rans_decode:byte",
                204: "rans_decode_v2:byte", 205: "rans_encode:byte",
                206: "rans_decode_w:byte", 207: "rans_encode2:byte",
                208: "rans_decode_w:pair", 209: "rans_decode_w:quad",
                215: "rans_encode2:quad", 210: "fse_encode", 211: "fse_decode",
                212: "huf_encode_4x", 213: "huf_decode_4x:x1",
                214: "huf_decode_4x:x2"}
BENCH_STAGES = (1, 9, 202, 203, *BENCH_KERNEL)
BENCH_FILE_MIB = 16
# the CLI run as `python -m` runs it (runpy), in a child that then reports
# its launch counts on its last line of stderr
CLI_CHILD = """
import json, runpy, sys
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
sys.argv = ["finitestateentropy_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("finitestateentropy_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
print(json.dumps({k: v for k, v in rk.launches.items() if v}), file=sys.stderr)
sys.exit(code)
"""
# the compat codecs (models/, io/frame.py): the CLI's default 32 KiB blocks
COMPAT_BID = 5
COMPAT_BLOCK = 1 << (10 + COMPAT_BID)
COMPAT_MIB = 8                 # the x2, mixed, CLI and mesh paths
# the frames held against the host twin are the first COMPAT_MIB, and the
# twin decodes a frame of the first 4 MiB: the twin is pure Python, one
# block after another on one core, so the whole 64 MiB would cost minutes
TWIN_DECODE_MIB = 4
# integer operations a symbol of each compat function needs, whatever the
# design.  FSE encode: the symbol load 1, two transform reads 2, nb (add,
# shift) 2, the state shift and add 2, the table read 1, the value mask
# (shift, subtract, and) 3, the bit container (shift, or, count) 3, the
# word test 1.  FSE decode: the table read 1, symbol and nb fields 3, the
# cursor 1, the field read (word index, shift amount, two stream reads, the
# funnel shift, the mask 3) 8, the new state (field, add) 2, the byte store
# 1.  Huff0 encode: the byte load 1, value and nb reads 2, the mask 3, the
# container 3, the word test 1.  Huff0 decode x1: the available bits (min,
# max) 2, the field read 8, the index shift 2, byte and nb reads 2, the
# store 1, the cursor 1; x2 a lookup the same plus its fields (nb, length,
# last test) 4, 20 a lookup, and a store for each second byte: counted on
# the lookups this run's streams take (huf_decode_4x2_lookups).
COMPAT_OPS = {"fse_encode": 16, "fse_decode": 17, "huf_encode_4x": 10,
              "huf_decode_4x:x1": 16, "huf_decode_4x:x2": 20}
COMPAT_KERNEL = {  # key -> (CUDA source, JAX function, file:line in finitestateentropy_tpu/)
    "fse_encode": ("fse_encode.cu", "ops/fse_kernels.py:138"),
    "fse_decode": ("fse_decode.cu", "ops/fse_kernels.py:58"),
    "huf_encode_4x": ("huf_encode.cu", "ops/huf_kernels.py:29"),
    "huf_decode_4x:x1": ("huf_decode.cu", "ops/huf_kernels.py:139"),
    "huf_decode_4x:x2": ("huf_decode.cu", "ops/huf_kernels.py:210")}
FLAT_THREADS = 512             # a group's block in csrc/rans_decode_flat.cu
V0_THREADS = 256               # and in csrc/turbo_fse_decode.cu
# paths timed as rows of their own beside the first path that launches a
# kernel: C5 at the 64 MiB frame's 2048 blocks (its first row: 256)
EXTRA_ROWS = ("huf_x2_p80_64MiB",)
KERNEL_LINE = {  # entry -> TPU kernel, file:line in finitestateentropy_tpu/turbo/
    "rans_encode2": "rans_kernels.py:607", "rans_encode2_flat": "rans_kernels.py:473",
    "rans_encode": "rans_kernels.py:303", "rans_decode": "rans_kernels.py:182",
    "rans_decode_v2": "rans_kernels.py:1019",
    "rans_decode_v2:totals": "rans_kernels.py:1113",
    "rans_decode_w": "rans_kernels.py:1322", "turbo_fse_decode": "kernels.py:59"}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(fn) -> tuple:
    """fn()'s result and the device time of that one call in ms (CUDA
    events, no warm-up)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, kernel: str, reps: int) -> dict:
    """Mean device time per launch of each CUDA kernel whose name holds
    `kernel` (torch.profiler's CUDA trace of reps calls of fn, each
    launching it once), without the wrapper's host work and allocations:
    {kernel function: ms}, empty when the trace holds no such kernel."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _attempt in range(3):          # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0)
            name = re.search(kernel + r"\w*", e.key)
            if name and us:         # the mean launch: the trace may drop some
                out[name.group(0)] = out.get(name.group(0), 0.0) + us / 1e3 / e.count
        if out:
            break
    return out


def max_abs_err(got, want) -> int:
    require(all((g is None) == (w is None) for g, w in zip(got, want)),
            "a kernel and its plain version disagree on which outputs exist")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want) if g is not None)


# source file -> the start of its kernel functions' names
KERNEL_FN = {"rans_encode.cu": "rans_encode_", "rans_decode.cu": "rans_decode_rows",
             "rans_decode_flat.cu": "rans_decode_flat",
             "turbo_fse_decode.cu": "turbo_fse_decode",
             "fse_encode.cu": "fse_encode_kernel", "fse_decode.cu": "fse_decode_kernel",
             "huf_encode.cu": "huf_encode_kernel", "huf_decode.cu": "huf_decode_kernel"}


def is_encode(key: str) -> bool:
    return key.startswith("rans_encode") or key in ("fse_encode", "huf_encode_4x")


def source_of(key: str) -> str:
    if key in COMPAT_KERNEL:
        return "finitestateentropy_tpu_torch/csrc/" + COMPAT_KERNEL[key][0]
    entry, mode = key.split(":")
    if entry.startswith("rans_encode"):
        name = "rans_encode.cu"
    elif entry == "turbo_fse_decode":
        name = "turbo_fse_decode.cu"
    elif entry == "rans_decode" or mode == "totals":
        name = "rans_decode_flat.cu"
    else:
        name = "rans_decode.cu"
    return "finitestateentropy_tpu_torch/csrc/" + name


def replaces(key: str) -> str:
    if key in COMPAT_KERNEL:
        return "finitestateentropy_tpu/" + COMPAT_KERNEL[key][1]
    entry = key.split(":")[0]
    return "finitestateentropy_tpu/turbo/" + KERNEL_LINE.get(key, KERNEL_LINE[entry])


def pair_escape_corpus(n: int, seed: int = 3) -> bytes:
    """8 hot byte pairs salted with 400 rare ones: coded on the pair wire
    with an escape section (the quad alphabet escapes too much)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, n // 2, dtype=np.uint16) * 257
    hot[rng.choice(n // 2, size=400, replace=False)] = \
        (np.arange(400) * 7 + 300).astype(np.uint16)
    return hot.astype("<u2").tobytes()[:n]


def quad_escape_corpus(n: int, seed: int = 13) -> bytes:
    """8 hot quads salted with 260 rare ones: coded on the quad wire with
    escapes."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, n // 4, dtype=np.uint32) * 0x01010101
    hot[rng.choice(n // 4, size=260, replace=False)] = \
        (np.arange(260) * 9719 + 77).astype(np.uint32)
    return hot.astype("<u4").tobytes()[:n]


def u16_corpus(n: int, wide: bool, seed: int = 0) -> np.ndarray:
    """The JAX package's U16 corpora (tests/test_turbo.py:287, :386):
    pareto(1.2)*50 clipped at 1023, or pareto(1.0)*300 clipped at 4095."""
    rng = np.random.default_rng(seed)
    a, scale, top = (1.0, 300, 4095) if wide else (1.2, 50, 1023)
    return np.clip((rng.pareto(a, n) * scale).astype(np.int64), 0,
                   top).astype(np.uint16)


def mixed_corpus(section: int, n: int) -> bytes:
    """The JAX package's mixed corpus (bench.py:596-609): group i of
    `section` bytes is Proba80, Proba14, random or one repeated byte by
    i % 4."""
    from finitestateentropy_tpu_torch.utils import generate_proba

    rng = np.random.default_rng(1)
    base80, base14 = generate_proba(80), generate_proba(14)
    parts = []
    for i in range(n):
        k = i % 4
        if k in (0, 1):
            base = base80[(i * 7919) % 4096:] if k == 0 else base14[(i * 104729) % 4096:]
            parts.append((base * ((section // len(base)) + 2))[:section])
        elif k == 2:
            parts.append(bytes(rng.integers(0, 256, section, dtype=np.uint8)))
        else:
            parts.append(bytes([i & 0xFF]) * section)
    return b"".join(parts)


def build_dir() -> Path:
    d = REPO / "build"
    d.mkdir(exist_ok=True)
    return d


def run_cli(argv: list[str], stderr: list | None = None) -> dict:
    """python -m finitestateentropy_tpu_torch.cli argv in a child process;
    returns the child's launch counts (and adds its other stderr lines to
    stderr when given).  Fails on a nonzero exit."""
    r = subprocess.run([sys.executable, "-c", CLI_CHILD, *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    require(r.returncode == 0, f"cli {argv}: exit {r.returncode}: {r.stderr[-2000:]}")
    lines = r.stderr.strip().splitlines()
    if stderr is not None:
        stderr.extend(lines[:-1])
    return json.loads(lines[-1])


def kernel_registers(ptxas: list[str]) -> dict:
    """{kernel function (mangled): registers} from a source's ptxas lines."""
    import re

    out, fn = {}, None
    for ln in ptxas:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        fn = m.group(1) if m else fn
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn] = int(m.group(1))
    return out


def occupancy(built: dict, blocks: int, kernels: dict) -> dict:
    """The launch shape of each compat kernel in `kernels` ({label:
    (source, kernel function, argument of the <label>_config C entry)}) for
    `blocks` blocks: blocks a CTA, threads, dynamic (the Huff0 encode:
    static) shared bytes, the CTAs an SM can hold by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, CTAs, SMs; whether the
    CTAs fit the card at once, and the kernel's registers as ptxas gave
    them."""
    from finitestateentropy_tpu_torch.turbo._build import load

    out = {"blocks": blocks}
    keys = ("blocks_per_cta", "threads", "smem_bytes", "ctas_per_sm", "ctas", "sms")
    for label, (source, kernel, arg) in kernels.items():
        fn = getattr(load(source), f"{label}_config")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        cfg = (ctypes.c_int * len(keys))()
        rc = fn(arg, cfg)
        require(rc == 0 and cfg[3] >= 1, f"{label}_config: cudaError_t {rc}, {list(cfg)}")
        d = dict(zip(keys, cfg))
        ptxas = built.get(source, {}).get("ptxas", [])
        d["one_wave"] = d["ctas"] <= d["ctas_per_sm"] * d["sms"]
        d["registers"] = ([r for f, r in kernel_registers(ptxas).items() if kernel in f]
                          if ptxas else "not built in this run")
        out[label] = d
    return out


def chain_step_ns() -> dict:
    """ns per dependent step of each kind csrc/chain_probe.cu measures, on
    one block: shared-memory load, global load hitting L1, global load
    hitting L2, a 1024-, 512- and 256-thread barrier with a shared
    exchange, the encoder's state recurrence, and a multiply-add with a
    warp ballot and popcount."""
    from finitestateentropy_tpu_torch.turbo._build import load

    fn = load("chain_probe").chain_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    steps = 1 << 16
    out = torch.empty(1024, dtype=torch.int32, device=DEV)

    def chain(n, stride):      # each entry the index of the next hop
        return ((torch.arange(n, device=DEV) + stride) % n).to(torch.int32)

    l1, l2 = chain(2048, 33), chain(1 << 22, 1056)   # 8 KiB; 16 MiB, a line a hop
    cases = {"smem": (0, l1, 128), "global_l1": (1, l1, 128),
             "global_l2": (2, l2, 128), "barrier_1024": (3, l1, 1024),
             "barrier_512": (3, l1, FLAT_THREADS), "barrier_256": (3, l1, V0_THREADS),
             "encode_step": (4, l1, 128), "mad_ballot": (5, l1, 128)}
    res = {}
    for name, (mode, buf, threads) in cases.items():
        def run(mode=mode, buf=buf, threads=threads):
            rc = fn(mode, buf.data_ptr(), buf.numel(), steps, threads,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            require(rc == 0, f"chain_probe launch failed (cudaError_t {rc})")
        res[name] = cuda_ms(run, 3) * 1e6 / steps
    return res


def dryrun_launches(m: int) -> dict:
    """Launches of dryrun_multichip(m) on m CUDA devices: one per shard of
    the compat step (sharded_fse_step: an FSE encode and decode) and of
    each sharded round trip (the windowed one runs on min(m, 2) devices);
    then the mixed frame, whose two coded 16 KiB groups of Proba80 go pair
    at default flags: a pair encode per shard for the mesh compress (mesh=1
    is single-device: one), one for the single-device compress, and a pair
    decode per shard."""
    return {"fse_encode": m, "fse_decode": m,
            "rans_encode2_flat:byte": 2 * m, "rans_decode:byte": m,
            "rans_decode_v2:byte": m, "rans_encode2:byte": min(m, 2),
            "rans_decode_w:byte": min(m, 2), "rans_encode2_flat:u16": m,
            "rans_decode_v2:u16": m, "rans_encode2:pair": m + m + 1,
            "rans_decode_v2:pair": m + m, "rans_encode2:quad": m,
            "rans_decode_v2:quad": m}


def bound(nbytes: int, ops: int, steps: int, step_ns: float,
          clock_hz: float) -> dict:
    """The least time the card could take: the largest of the bytes over
    the HBM rate, the integer operations over the INT32 rate, and the chain
    of `steps` dependent steps per group at `step_ns` each (each kept)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (INT32_LANES * clock_hz) * 1e3
    t_chain = steps * step_ns * 1e-6
    best = max(t_bytes, t_ops, t_chain)
    return {"bound_ms": best,
            "bound_by": "bytes" if t_bytes == best else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "chain_bound_ms": t_chain}


class Piece:
    """One call of a compress entry point and the decompress calls of its
    output: codec "turbo" (bytes) or "turbo16" (u16 symbols)."""

    def __init__(self, codec, data, group, flags=None, windows=(0,)):
        self.codec, self.data, self.group = codec, data, group
        self.flags, self.windows = flags or {}, windows

    @property
    def nbytes(self) -> int:
        return len(self.data) * (2 if self.codec == "turbo16" else 1)


def recording(decompress, into: list):
    """decompress, keeping in `into` the compressed blocks the frame layer
    hands it ([(payload, regenerated size)]): the items a path's decode
    batch is staged from."""
    def run(items):
        into.extend(items)
        return decompress(items)
    return run


def compat_ident(key: str, staged: dict) -> tuple:
    """A compat batch's key and a digest of its staged inputs: batches of
    equal inputs (the same 8 MiB through several paths) are held against
    one run of the plain version."""
    h = hashlib.sha1()
    for k in sorted(staged):
        v = staged[k]
        h.update(k.encode())
        h.update(v.tobytes() if isinstance(v, np.ndarray) else repr(v).encode())
    return key, h.hexdigest()


def compat_encode_batches(codec, blocks, shards: int = 1) -> list[dict]:
    """The encode batch of blocks, planned and staged as the codec's
    compress_blocks does it (encode_plan, encode_inputs, the tables on the
    card): {key, ident, run (the wrapper) and plain (the plain version),
    both on the card at the path's shapes and compared whole, kernel (the
    bare launch), G, steps, ops, nbytes, chain, shards}."""
    from finitestateentropy_tpu_torch.ops import fse_kernels as fk, fse_tables
    from finitestateentropy_tpu_torch.ops import huf_kernels as hk

    _res, todo = codec.encode_plan(blocks)
    if not todo:
        return []
    e = codec.encode_inputs(todo)
    t = {k: torch.from_numpy(v).to(DEV) for k, v in e.items() if isinstance(v, np.ndarray)}
    B, n = len(todo), e["n"].astype(np.int64)
    if "norm" in e:
        ct = fse_tables.build_ctables(t["norm"], t["tlog"])
        args = (t["src"], t["n"], t["tlog"], ct)
        kw = dict(max_syms=e["max_syms"], out_bytes=e["out_bytes"])
        tbl_bytes = sum(c.numel() * 4 for c in ct)
        return [dict(key="fse_encode", ident=compat_ident("fse_encode", e), G=B,
                     shards=shards, chain="lookup", steps=int((n.max() + 1) // 2),
                     ops=COMPAT_OPS["fse_encode"] * int(n.sum()),
                     run=partial(fk.fse_encode_batch, *args, **kw),
                     plain=partial(fk.fse_encode_batch_plain, *args, **kw),
                     kernel=partial(fk._encode_kernel, *args, kw["max_syms"], kw["out_bytes"]),
                     # the source once, the tables, n and tableLog, the payload, csize
                     nbytes=lambda o: int(n.sum()) + tbl_bytes + 8 * B
                     + int(o[1].long().sum()) + 4 * B)]
    args = (t["src"], t["n"], t["val"], t["nb"], e["max_block"], e["seg_bytes"])
    seg = (n + 3) // 4
    return [dict(key="huf_encode_4x", ident=compat_ident("huf_encode_4x", e), G=B,
                 shards=shards, chain="none", steps=int(seg.max()),
                 ops=COMPAT_OPS["huf_encode_4x"] * int(n.sum()),
                 run=partial(hk.huf_encode_4x_batch, *args),
                 plain=partial(hk.huf_encode_4x_batch_plain, *args),
                 kernel=partial(hk._encode_kernel, *args),
                 # the source once, the code tables, n, the streams, their sizes
                 nbytes=lambda o: int(n.sum()) + 8 * t["val"].numel() + 4 * B
                 + int(o[1].long().sum()) + 16 * B)]


def compat_decode_batches(codec, items, shards: int = 1) -> list[dict]:
    """The decode batch of a frame's compressed blocks, staged as the
    codec's decompress_blocks does it (decode_inputs, the tables on the
    card; the X2 tables built on the host), fields as
    compat_encode_batches'.  The chain is the longest stream's lookups:
    n/2 a state (FSE), seg (Huff0 x1), and for x2 the lookups that run (one
    or two bytes each), counted by huf_decode_4x2_lookups."""
    from finitestateentropy_tpu_torch.ops import fse_kernels as fk, fse_tables
    from finitestateentropy_tpu_torch.ops import huf_kernels as hk

    d = codec.decode_inputs(items)
    t = {k: torch.from_numpy(v).to(DEV) for k, v in d.items() if isinstance(v, np.ndarray)}
    B = len(items)
    cs, nout = d["csize"].astype(np.int64), d["n_out"].astype(np.int64)
    if "norm" in d:
        dt = fse_tables.build_dtables(t["norm"], t["tlog"])[:3]
        args = (t["streams"], t["csize"], t["n_out"], t["tlog"], dt)
        kw = dict(max_out=d["max_out"])
        tbl_bytes = sum(x.numel() * 4 for x in dt)
        return [dict(key="fse_decode", ident=compat_ident("fse_decode", d), G=B,
                     shards=shards, chain="lookup", steps=int((nout.max() + 1) // 2),
                     ops=COMPAT_OPS["fse_decode"] * int(nout.sum()),
                     run=partial(fk.fse_decode_batch, *args, **kw),
                     plain=partial(fk.fse_decode_batch_plain, *args, **kw),
                     kernel=partial(fk._decode_kernel, *args[:4], fk.pack_dtable(*dt),
                                    d["max_out"]),
                     # the payload, the tables, csize / n_out / tableLog, out, err
                     nbytes=lambda o: int(cs.sum()) + tbl_bytes + 12 * B + int(nout.sum()) + B)]
    head = (t["streams"], t["csize"], t["n_out"])
    if codec.decoder == "x2":
        key, wrapper, plain = ("huf_decode_4x:x2", hk.huf_decode_4x2_batch,
                               hk.huf_decode_4x2_batch_plain)
        tl4 = torch.from_numpy(np.repeat(d["x2_tlog"], 4)).to(DEV)
        tables = (torch.from_numpy(np.repeat(d["x2_tbl"], 4, axis=0)).to(DEV),)
        arg = tables[0]
        lookups = hk.huf_decode_4x2_lookups(*head, tl4, arg, d["max_seg"])
        steps, n_look = int(lookups.max()), int(lookups.sum())
        # 20 a lookup, and a store for each byte a lookup writes second
        ops = COMPAT_OPS[key] * n_look + max(int(nout.sum()) - n_look, 0)
    else:
        key, wrapper, plain = ("huf_decode_4x:x1", hk.huf_decode_4x1_batch,
                               hk.huf_decode_4x1_batch_plain)
        tl4 = t["tlog"]
        bt, nt = hk.build_dtables_x1(t["weights"], tl4.view(B, 4)[:, 0])
        tables = (bt.repeat_interleave(4, dim=0), nt.repeat_interleave(4, dim=0))
        arg, steps = tables, int(nout.max())
        ops = COMPAT_OPS[key] * int(nout.sum())
    full = (*head, tl4, arg, d["max_seg"])
    tbl_bytes = sum(x.numel() * x.element_size() for x in tables)
    return [dict(key=key, ident=compat_ident(key, d), G=B, shards=shards, chain="lookup",
                 steps=steps, ops=ops,
                 run=partial(wrapper, *full), plain=partial(plain, *full),
                 kernel=partial(hk._decode_kernel, *head, tl4, tables, d["max_seg"],
                                key.endswith("x2")),
                 # the streams, the tables, csize / n_out / tableLog, out, err
                 nbytes=lambda o: int(cs.sum()) + tbl_bytes + 12 * 4 * B
                 + int(nout.sum()) + 4 * B)]


def compat_small_cases() -> list[dict]:
    """C1-C5 at small shapes (4 KiB blocks of Proba80 / 14 / 2, a ragged
    block, an n = 2 block; Huff0 blocks of 13 bytes and odd lengths), each
    wrapper's outputs against its plain version's, whole; the decodes with
    one endMark byte zeroed (FSE block 2; Huff0 block 2, stream 0).  And
    C1 / C2 on two whole 32 KiB blocks (Proba80, Proba14; the second
    decoded from an eighth of its stream, so its cursor falls below bit 0
    long before the end) and on 4 KiB blocks whose payloads run past a
    600-byte buffer (the words past it dropped, csize counting them); C3-C5
    on two whole 32 KiB blocks (Proba80, Proba14), and the Huff0 decodes
    with the streams of two blocks on different X1 tables or tableLogs:
    {key, run, plain, err (the flags the decode must give, or None)}."""
    from finitestateentropy_tpu_torch.ops import bitio, fse_kernels as fk, fse_tables
    from finitestateentropy_tpu_torch.ops import huf_kernels as hk
    from finitestateentropy_tpu_torch.refimpl.hist import hist_count
    from finitestateentropy_tpu_torch.refimpl.huf import (huf_build_ctable,
                                                          huf_read_dtable_x2,
                                                          huf_read_stats,
                                                          huf_write_ctable)
    from finitestateentropy_tpu_torch.refimpl.norm import (fse_normalize_count,
                                                           fse_optimal_table_log)
    from finitestateentropy_tpu_torch.utils import generate_proba

    def fse_cases(blocks, S, out_bytes, spoil):
        """The FSE encode and decode of blocks in rows of S bytes; spoil(
        streams, csize) alters the decode's input in place and returns the
        flags the decode must give."""
        B = len(blocks)
        src = np.zeros((B, S), np.uint8)
        norms = np.zeros((B, 256), np.int32)
        tlogs, ns = np.zeros(B, np.int32), np.zeros(B, np.int32)
        for k, b in enumerate(blocks):
            arr = np.frombuffer(b, np.uint8)
            max_sv = int(arr.max())
            norm, tlogs[k] = fse_normalize_count(
                fse_optimal_table_log(11, len(b), max_sv),
                np.bincount(arr, minlength=256)[: max_sv + 1], len(b), max_sv)
            src[k, : len(b)], ns[k] = arr, len(b)
            norms[k, : len(norm)] = norm
        on = {k: torch.from_numpy(v).to(DEV) for k, v in
              (("src", src), ("n", ns), ("norm", norms), ("tlog", tlogs))}
        ct = fse_tables.build_ctables(on["norm"], on["tlog"])
        enc = (on["src"], on["n"], on["tlog"], ct)
        kw = dict(max_syms=S, out_bytes=out_bytes)
        words, csize = fk.fse_encode_batch_plain(*enc, **kw)
        streams = bitio.words_to_bytes(words)
        flags = spoil(streams, csize)
        dt = fse_tables.build_dtables(on["norm"], on["tlog"])[:3]
        dec = (streams, csize, on["n"], on["tlog"], dt)
        return [dict(key="fse_encode", run=partial(fk.fse_encode_batch, *enc, **kw),
                     plain=partial(fk.fse_encode_batch_plain, *enc, **kw), err=None),
                dict(key="fse_decode", run=partial(fk.fse_decode_batch, *dec, max_out=S),
                     plain=partial(fk.fse_decode_batch_plain, *dec, max_out=S),
                     err=flags)]

    def no_endmark(streams, csize):
        streams[2, int(csize[2]) - 1] = 0
        return [False, False, True, False, False]

    def cursor_low(streams, csize):
        csize[1] //= 8
        return [False, True]

    S = 4096
    p80, p14, p02 = (generate_proba(p, S) for p in (80, 14, 2))
    blocks = [p80, p14, p02, p14[:1001], b"\x05\x09"]
    cases = fse_cases(blocks, S, S + 64, no_endmark)
    cases += fse_cases([generate_proba(p, COMPAT_BLOCK) for p in (80, 14)],
                       COMPAT_BLOCK, 36000, cursor_low)
    overflow = fse_cases(blocks[:3], S, 600, lambda st, cs: None)
    require(int((overflow[0]["plain"]()[1] > 600).sum()) == 2,
            "the overflow case drops no FSE payload")
    cases += overflow

    def huf_cases(hblocks, S, spoil):
        """The Huff0 encode of hblocks in rows of S bytes, and the X1 and X2
        decodes of its output; spoil(streams, sizes, tables) alters the
        decodes' inputs in place (tables: the X1 [tlog, byte, nb] a stream)
        and returns the flags they must give, or None."""
        B = len(hblocks)
        hsrc, hn = np.zeros((B, S), np.uint8), np.zeros(B, np.int32)
        val, nb = np.zeros((B, 256), np.int32), np.zeros((B, 256), np.int32)
        weights, tls = np.zeros((B, 256), np.int32), np.zeros(B, np.int32)
        x2 = np.zeros((B, 4096), np.int32)
        x2_tl = np.zeros(B, np.int32)
        for k, b in enumerate(hblocks):
            count, max_sv, _ = hist_count(b)
            table = huf_build_ctable(count, max_sv, fse_optimal_table_log(
                11, len(b), max_sv, minus=1, max_allowed=12))
            header = huf_write_ctable(table, max_sv)
            w, _rs, _nsym, tls[k], _used = huf_read_stats(header)
            weights[k, : len(w)] = np.frombuffer(w, np.uint8)
            dt2 = huf_read_dtable_x2(header)[0]
            x2[k], x2_tl[k] = hk.pack_dtable_x2(dt2), dt2.table_log
            hsrc[k, : len(b)], hn[k] = np.frombuffer(b, np.uint8), len(b)
            val[k, : max_sv + 1], nb[k, : max_sv + 1] = table.val, table.nb_bits
        henc = tuple(torch.from_numpy(a).to(DEV) for a in (hsrc, hn, val, nb)) + (S, S // 4 + 64)
        hwords, sizes = hk.huf_encode_4x_batch_plain(*henc)
        hstreams = bitio.words_to_bytes(hwords.view(4 * B, -1))
        sizes = sizes.view(-1)
        seg = (torch.from_numpy(hn).long() + 3) // 4
        nout = torch.stack([seg, seg, seg, torch.from_numpy(hn).long() - 3 * seg], 1).view(-1)
        bt, nt = hk.build_dtables_x1(torch.from_numpy(weights).to(DEV),
                                     torch.from_numpy(tls).to(DEV))
        tables = [torch.from_numpy(np.repeat(tls, 4)).to(DEV), bt.repeat_interleave(4, 0),
                  nt.repeat_interleave(4, 0)]
        flags = spoil(hstreams, sizes, tables)
        head = (hstreams, sizes, nout.to(torch.int32).to(DEV))
        x1 = (*head, tables[0], (tables[1], tables[2]), S // 4)
        x2a = (*head, torch.from_numpy(np.repeat(x2_tl, 4)).to(DEV),
               torch.from_numpy(np.repeat(x2, 4, axis=0)).to(DEV), S // 4)
        return [
            dict(key="huf_encode_4x", run=partial(hk.huf_encode_4x_batch, *henc),
                 plain=partial(hk.huf_encode_4x_batch_plain, *henc), err=None),
            dict(key="huf_decode_4x:x1", run=partial(hk.huf_decode_4x1_batch, *x1),
                 plain=partial(hk.huf_decode_4x1_batch_plain, *x1), err=flags),
            dict(key="huf_decode_4x:x2", run=partial(hk.huf_decode_4x2_batch, *x2a),
                 plain=partial(hk.huf_decode_4x2_batch_plain, *x2a), err=flags)]

    def huf_no_endmark(streams, sizes, tables):
        streams[8, int(sizes[8]) - 1] = 0
        return [r == 8 for r in range(streams.shape[0])]

    def huf_mixed_tables(streams, sizes, tables):
        """Block 1's stream 2 decodes with block 0's X1 table, block 3's
        stream 1 with a tableLog one lower: those blocks leave the X1
        kernel's shared table for its global-table loop."""
        tables[1][6], tables[2][6] = tables[1][0], tables[2][0]
        tables[0][13] -= 1
        return None

    hblocks = [p80, p14, p80[:S - 1], p80[100:113], p14[:517]]
    cases += huf_cases(hblocks, S, huf_no_endmark)
    cases += huf_cases([generate_proba(p, COMPAT_BLOCK) for p in (80, 14)], COMPAT_BLOCK,
                       lambda st, cs, t: [False] * 8)
    cases += [c for c in huf_cases(hblocks, S, huf_mixed_tables) if c["key"] == "huf_decode_4x:x1"]
    return cases


def benchmarks_phase(gpu: str) -> dict:
    """The port's bench (benchmarks/): fullbench.main on CUDA over host
    stages 1 and 9 and every device stage, each stage's launch counts read
    around its timing (every device stage launches its kernel and runs no
    plain version), one output of each held against the same call with
    interpret=True (the TurboRANS stages) or against the host twin and the
    input (the compat stages); then the CLI's -b on a file of
    BENCH_FILE_MIB of Proba80 in the -e, -h and -T modes, each line
    carrying the ratio of the port's own frames.  Prints fullbench's lines
    and returns the phase's record."""
    import contextlib
    import io
    import re

    from finitestateentropy_tpu_torch.benchmarks import fullbench as fb
    from finitestateentropy_tpu_torch.models import get_batch_codec
    from finitestateentropy_tpu_torch.ops import fse_kernels as fk, huf_kernels as hk
    from finitestateentropy_tpu_torch.refimpl import fse, huf
    from finitestateentropy_tpu_torch.turbo import api, kernels as v0
    from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
    from finitestateentropy_tpu_torch.utils import generate_proba

    t_phase = time.perf_counter()
    # every plain version a wrapper can fall back to, counted while
    # fullbench runs: none may run
    plain_calls = {}
    plains = [(rk, "rans_encode2_plain"), (rk, "rans_encode_plain"), (rk, "_decode_plain"),
              (fk, "fse_encode_batch_plain"), (fk, "fse_decode_batch_plain"),
              (hk, "huf_encode_4x_batch_plain"), (hk, "huf_decode_4x1_batch_plain"),
              (hk, "huf_decode_4x2_batch_plain"), (v0, "turbo_fse_decode_plain")]
    saved = {(m, n): getattr(m, n) for m, n in plains}

    def counting(name, fn):
        def run(*a, **k):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*a, **k)
        return run

    per_stage = []                 # launch counts of each timed stage, in order

    def recorded(timer):
        def run(fn, payload, *a, **k):
            rk.reset_launches()
            rate = timer(fn, payload, *a, **k)
            per_stage.append({k2: v for k2, v in rk.launches.items() if v})
            return rate
        return run

    timers = fb._calibrated, fb._calibrated_device
    fb._calibrated, fb._calibrated_device = (recorded(t) for t in timers)
    for (m, n), fn in saved.items():
        setattr(m, n, counting(n, fn))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = fb.main([str(s) for s in BENCH_STAGES])
    finally:
        fb._calibrated, fb._calibrated_device = timers
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    text = out.getvalue()
    print(text, end="", flush=True)
    require(rc == 0, f"fullbench exit {rc}")
    lines = [re.match(r"^\s*(\d+) (.+?) +([\d.]+) MB/s$", ln) for ln in text.splitlines()]
    require(all(lines) and [int(m.group(1)) for m in lines] == sorted(BENCH_STAGES),
            f"fullbench printed {text!r}")
    require(not plain_calls, f"fullbench ran plain versions: {plain_calls}")
    stages = {}
    for m, counts in zip(lines, per_stage):
        num = int(m.group(1))
        want = BENCH_KERNEL.get(num)
        require(want is None and not counts or set(counts) == {want},
                f"fullbench stage {num} launched {counts}, expected {want}")
        stages[num] = {"name": m.group(2), "MBps": float(m.group(3)),
                       "launches": counts}

    # one output of each device stage against its plain version
    t0 = time.perf_counter()
    checked = {}
    turbo = fb._turbo_stages(device=DEV)
    for num, key in BENCH_KERNEL.items():
        if num not in turbo:
            continue
        fn = turbo[num][1]
        got, want = fn(), fn(True)
        torch.cuda.synchronize()
        if key.startswith("rans_encode"):
            hw = torch.int16 if key.startswith("rans_encode2") else torch.int32
            cs = got[2].cpu()
            require(torch.equal(cs, want[2].cpu()), f"stage {num}: csize differs")
            for g in range(cs.numel()):
                n = int(cs[g])
                require(torch.equal(got[0][g].reshape(-1).view(hw)[:n],
                                    want[0][g].reshape(-1).view(hw)[:n]),
                        f"stage {num}: group {g}'s stream words differ")
            require(torch.equal(got[1], want[1]), f"stage {num}: finals differ")
            err = 0
        else:
            require(not got[1].any() and not want[1].any(), f"stage {num}: err set")
            require(torch.equal(got[0], want[0]), f"stage {num}: output differs")
            err = int((got[0].long() - want[0].long()).abs().max())
        checked[num] = {"vs": "interpret=True", "max_abs_err": err}
    compat = fb._device_compat_stages(device=DEV)
    # the stages' blocks: 64 of 32 KiB of Proba20 (stage 210's payload)
    data = generate_proba(fb.P_DEFAULT, compat[210][2])
    blocks = [data[i:i + COMPAT_BLOCK] for i in range(0, len(data), COMPAT_BLOCK)]
    for num, twin in ((210, fse.fse_compress), (212, huf.huf_compress)):
        res = compat[num][1]()
        require([(r.kind.name, r.data) for r in res]
                == [(r.kind.name, r.data) for r in map(twin, blocks)],
                f"stage {num}: the blocks differ from the host twin's")
        checked[num] = {"vs": "host twin", "max_abs_err": 0}
    for num in (211, 213, 214):
        require(compat[num][1]() == blocks, f"stage {num}: the decode differs from the input")
        checked[num] = {"vs": "input", "max_abs_err": 0}
    check_s = time.perf_counter() - t0

    # the CLI's -b on a Proba80 file, each mode in a child process
    t0 = time.perf_counter()
    data = generate_proba(80, BENCH_FILE_MIB << 20)
    blocks = [data[i:i + COMPAT_BLOCK] for i in range(0, len(data), COMPAT_BLOCK)]
    ratio = {"-e": len(data) / sum(len(r.data) for r in get_batch_codec(
                 "fse", block_size=COMPAT_BLOCK)[0](blocks)),
             "-h": len(data) / sum(len(r.data) for r in get_batch_codec(
                 "huf", block_size=COMPAT_BLOCK)[0](blocks)),
             "-T": len(data) / len(api.turbo_compress_device(data, device=DEV))}
    want_keys = {"-e": {"fse_encode", "fse_decode"},
                 "-h": {"huf_encode_4x", "huf_decode_4x:x1"},
                 "-T": {"rans_encode2:quad", "rans_decode_w:quad"}}
    cli = {}
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        path = Path(tmp) / f"p80_{BENCH_FILE_MIB}MiB"
        path.write_bytes(data)
        for flag in ("-e", "-h", "-T"):
            err = []
            counts = run_cli(["-b", "-i2", flag, str(path)], err)
            require(len(err) == 1 and f"ratio {ratio[flag]:6.3f}" in err[0],
                    f"cli -b {flag}: {err}, expected ratio {ratio[flag]:6.3f}")
            require(set(counts) == want_keys[flag], f"cli -b {flag} launched {counts}")
            cli[flag] = {"line": err[0], "ratio": ratio[flag], "launches": counts}
    return {"phase": "benchmarks", "gpu": gpu, "fullbench": stages,
            "checked": checked, "check_s": check_s, "blockbench": cli,
            "blockbench_s": time.perf_counter() - t0,
            "seconds": time.perf_counter() - t_phase}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from finitestateentropy_tpu_torch.parallel import dryrun as dr
    from finitestateentropy_tpu_torch.parallel.mesh import make_mesh
    from finitestateentropy_tpu_torch.parallel.turbo_dp import sharded_turbo16_roundtrip
    from finitestateentropy_tpu_torch.ops.hist import hist_count_masked
    from finitestateentropy_tpu_torch.ops.norm import fse_normalize_batch
    from finitestateentropy_tpu_torch.ops.rans_tables import pack_rans_dtable_batch
    from finitestateentropy_tpu_torch.turbo import api
    from finitestateentropy_tpu_torch.turbo import device_api as da
    from finitestateentropy_tpu_torch.turbo import kernels as v0
    from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
    from finitestateentropy_tpu_torch.turbo._build import build_all
    from finitestateentropy_tpu_torch.turbo.format import (parse_group,
                                                           turbo_fse_compress,
                                                           turbo_fse_decompress)
    from finitestateentropy_tpu_torch.turbo.pair import pair_compress
    from finitestateentropy_tpu_torch.turbo.quad import quad_compress
    from finitestateentropy_tpu_torch.turbo.rans import RANS_TABLELOG, rans_compress
    from finitestateentropy_tpu_torch.turbo.rans16 import rans16_compress
    from finitestateentropy_tpu_torch.turbo.state import to_tensors
    from finitestateentropy_tpu_torch.turbo.tables import (pack_rans16_dtable,
                                                           pack_rans_ctables,
                                                           pack_rans_dtable)
    from finitestateentropy_tpu_torch.utils import generate_proba

    def compress(p: Piece) -> bytes:
        if p.codec == "turbo16":
            return api.turbo16_compress_device(p.data, p.group, device=DEV,
                                               **p.flags)
        return api.turbo_compress_device(p.data, p.group, device=DEV, **p.flags)

    def decompress(p: Piece, blob: bytes, windows: int):
        if p.codec == "turbo16":
            return api.turbo16_decompress_device(blob, windows=windows, device=DEV)
        return api.turbo_decompress_device(blob, mesh=p.flags.get("mesh", 0),
                                           windows=windows, device=DEV)

    def same(p: Piece, back) -> bool:
        return (np.array_equal(back, p.data) if p.codec == "turbo16"
                else back == p.data)

    # 1. the card
    gpu = nvidia_smi("name,power.limit")
    print(f"gpu: {gpu}", flush=True)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6

    # 2. build
    t0 = time.perf_counter()
    built = build_all()
    # the native host library (api.prep_group's stats; g++, a few seconds)
    from finitestateentropy_tpu_torch import native
    native_built = native.available()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "native_built": native_built,
                      "built": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                                for k, v in built.items()}}), flush=True)
    # C1 / C2 and C3 / C4 at the 64 MiB compat paths' 2048 blocks (the
    # decodes' configs take their rows, four a block), C5 at the x2 path's
    # 256 blocks and at 2048
    nblk = MAIN_MIB * GROUP // COMPAT_BLOCK
    print(json.dumps({"phase": "fse_occupancy", "gpu": gpu, **occupancy(
        built, nblk, {"fse_encode": ("fse_encode", "fse_encode_kernel", nblk),
                      "fse_decode": ("fse_decode", "fse_decode_kernel", nblk)})}), flush=True)
    print(json.dumps({"phase": "huf_occupancy", "gpu": gpu, **occupancy(
        built, nblk, {"huf_encode": ("huf_encode", "huf_encode_kernel", nblk),
                      "huf_decode": ("huf_decode", "huf_decode_kernel_x1", 4 * nblk)})}),
          flush=True)
    x2_blk = COMPAT_MIB * GROUP // COMPAT_BLOCK
    print(json.dumps({"phase": "huf_x2_occupancy", "gpu": gpu, **{
        f"blocks_{b}": occupancy(built, b, {"huf_decode_x2": (
            "huf_decode", "huf_decode_kernel_x2", 4 * b)})["huf_decode_x2"]
        for b in (x2_blk, nblk)}}), flush=True)

    def encode_batches(p: Piece, entry: str | None = None) -> list[dict]:
        """Every encode batch of p, planned and staged as the compress
        entry point does it: {key, run (the wrapper), plain, kernel (the
        bare launch), G, steps, ops, nbytes(kernel output), chain,
        shards}.  Placement and steptots are the compress entry point's
        (api.encode_placement); under a mesh (flags["mesh"]) a batch
        launches once per shard.  entry "rans_encode" puts byte batches
        through the v1 encode instead, "rans_encode2_flat" U16 batches
        through the flat packed encode."""
        out = []
        st = p.flags.get("steptots", True)
        if p.codec == "turbo":
            f = p.flags
            mesh = f.get("mesh")
            tlog0, pair, quad = api.mode_flags(
                f.get("table_log", 0), st, f.get("totals_only", False),
                f.get("pair", -1), f.get("quad", -1))
            _n, _f, batches = api.plan_encode(p.data, p.group, tlog0, pair, quad)
            for (wire, n_pad, tlog), items in batches.items():
                fc, mg, srcw = api.STAGE_BATCH[wire](items, n_pad)
                ins = to_tensors(DEV, fc_tables=fc, magic_tables=mg, src_words=srcw)
                t4, hcap = api._wire_t4(wire, n_pad), api._hrows_cap(n_pad)
                args = (*ins.values(), t4, hcap, tlog)
                b = dict(mode=wire, G=len(items), steps=rk.SPC[wire] * t4,
                         tbl_bytes=fc.nbytes + mg.nbytes, src_bytes=srcw.nbytes,
                         chain="encode", out_hw=2,
                         shards=1 if mesh is None else mesh.devices.size)
                if entry == "rans_encode":          # the byte v1 encode
                    v1 = (*ins.values(), t4, hcap, False, tlog, st)
                    b.update(key="rans_encode:byte", stots=st, out_hw=4,
                             run=partial(rk.rans_encode, *ins.values(), t4, hcap,
                                         False, False, tlog, st),
                             plain=partial(rk.rans_encode_plain, *v1),
                             kernel=partial(rk._encode_kernel, *args, wire, False, st))
                else:
                    rowloc, est = api.encode_placement(wire, st, mesh)
                    mf = dict(u16=wire == "pair", quad=wire == "quad", steptots=est)
                    b.update(key=f"rans_encode2{'' if rowloc else '_flat'}:{wire}",
                             stots=est,
                             run=partial(rk.rans_encode2, *args[:5], tlog=tlog, **mf,
                                         rowloc=rowloc),
                             plain=partial(rk.rans_encode2_plain, *args, **mf),
                             kernel=partial(rk._encode_kernel, *args, wire, True, est))
                out.append(b)
        else:
            _n, _f, batches = api.plan_encode16(p.data, p.group, st)
            packed = entry == "rans_encode2_flat"
            for (n_pad, big, tlog), items in batches.items():
                fc, mg, srcw = api.STAGE_BATCH["u16x" if big else "u16"](items, n_pad)
                ins = to_tensors(DEV, fc_tables=fc, magic_tables=mg, src_words=srcw)
                t2, hcap = n_pad // 2048, api._round8(n_pad // 128 + 16)
                mode = "u16x" if big else "u16"
                args = (*ins.values(), t2, hcap)
                if packed:
                    run = partial(rk.rans_encode2, *args, tlog=tlog, u16=True,
                                  steptots=st)
                    plain = partial(rk.rans_encode2_plain, *args, tlog, u16=True,
                                    steptots=st)
                else:
                    run = partial(rk.rans_encode, *args, False, True, tlog, st)
                    plain = partial(rk.rans_encode_plain, *args, True, tlog, st)
                out.append(dict(
                    key=f"{entry or 'rans_encode'}:{mode}", mode=mode, run=run,
                    plain=plain, stots=st,
                    kernel=partial(rk._encode_kernel, *args, tlog, mode, packed, st),
                    G=len(items), steps=2 * t2, out_hw=2 if packed else 4,
                    tbl_bytes=fc.nbytes + mg.nbytes, src_bytes=srcw.nbytes,
                    chain="encode"))
        for b in out:
            b["ops"] = ENC_OPS_PER_STEP[b["mode"]] * b["G"] * b["steps"] * 1024
            # src once, tables once, the payload halfwords (one per word on
            # the v1 encode), finals, csize and the step counts when kept
            b["nbytes"] = lambda o, b=b: (
                b["src_bytes"] + b["tbl_bytes"]
                + b["out_hw"] * int(o[2].long().sum()) + b["G"] * (4096 + 4)
                + (b["G"] * b["steps"] * 8 * 4 if b["stots"] else 0))
        return out

    def decode_batches(p: Piece, blob: bytes, windows: int) -> list[dict]:
        """Every decode batch of blob, planned, staged and routed as the
        decompress entry point does it (same fields as encode_batches)."""
        mesh = p.flags.get("mesh")
        staged = []
        if p.codec == "turbo":
            groups = api.parse_groups(blob)
            for (wire, n_pad, tlog, kind), idxs in api.plan_decode(groups)[1].items():
                arrays = api.stage_decode_batch(groups, idxs, n_pad, tlog, wire, kind)
                flags = dict(u16=wire == "pair", pair=wire == "pair",
                             quad=wire == "quad")
                staged.append((arrays, tlog, kind, wire, flags))
        else:
            groups = api.parse_groups(blob, api.parse_rans16_group)
            for (wire, n_pad, tlog, kind), idxs in api.plan_decode16(groups)[1].items():
                arrays = api.stage_decode_batch(groups, idxs, n_pad, tlog, wire, kind)
                staged.append((arrays, tlog, kind, wire,
                               dict(u16=True, u16x=wire == "u16x")))
        out = []
        for (cs, tbl, init, hws, tots, t4, hrows), tlog, kind, mode, flags in staged:
            ins = to_tensors(DEV, csize_hw=cs, tables=tbl, init_states=init,
                             streams=hws)
            common = tuple(ins.values())
            G = len(cs)
            b = dict(mode=mode, G=G, steps=rk.SPC[mode] * t4, streams=ins["streams"],
                     mid_word=cs // 4, chain="flat",
                     shards=1 if mesh is None else mesh.devices.size)
            if kind == 0:
                v1 = {k: v for k, v in flags.items() if k != "quad"}
                b.update(key=f"rans_decode:{mode}",
                         run=partial(rk.rans_decode, *common, t4, hrows, tlog=tlog, **v1),
                         plain=partial(rk.rans_decode_v1_plain, *common, t4, hrows,
                                       tlog=tlog, **v1),
                         kernel=partial(rk._decode_flat_kernel, *common[1:3], common[3],
                                        common[0], None, t4, tlog, mode),
                         tots_bytes=0)
            else:
                st = to_tensors(DEV, steptots=tots)["steptots"]
                # the mesh branch decodes every speed-wire batch with v2
                nway, S = ((0, 0) if mesh is not None else api._window_dispatch(
                    windows, t4, hrows, tlog, G, kind == 1, **flags))
                entry = "rans_decode_w" if nway else "rans_decode_v2"
                cursors, roff, _bad = rk._decode_prep(ins["csize_hw"], st)
                if nway:
                    run = partial(rk.rans_decode_w, *common, st, t4, hrows, nway,
                                  tlog, S, **flags)
                else:
                    run = partial(rk.rans_decode_v2, *common, st, t4, hrows,
                                  tlog=tlog, **flags)
                if kind == 1:
                    kernel = partial(rk._decode_flat_kernel, *common[1:3], common[3],
                                     common[0], cursors, t4, tlog, mode)
                else:
                    kernel = partial(rk._decode_kernel, *common[1:], cursors, roff,
                                     t4, tlog, mode)
                    b["chain"] = "rows"
                b.update(key=f"{entry}:{'totals' if kind == 1 else mode}", run=run,
                         plain=partial(rk.rans_decode_plain, *common, st, t4, hrows,
                                       tlog, **flags),
                         kernel=kernel, tots_bytes=tots.nbytes)
            flat = b["chain"] == "flat"
            b["ops"] = G * b["steps"] * (
                (DEC_OPS_PER_STEP[mode] + (FLAT_LANE_OPS if flat else 0)) * 1024
                + (FLAT_SCAN_ADDS if flat else 0))
            # payload halfwords, tables, init states, step counts, csize once;
            # the output words and err once
            nb = (2 * int(cs.astype(np.int64).sum()) + tbl.nbytes + init.nbytes
                  + b["tots_bytes"] + cs.nbytes + G * t4 * 4096 + G * 4)
            b["nbytes"] = lambda o, nb=nb: nb
            out.append(b)
        return out

    def v0_batch(blobs: list[bytes]) -> dict:
        """The v0 decode of v0 frames of one padded size, staged as the JAX
        package's test composes it (parse_group, pack_dtable)."""
        cs, tbl, init, st, t4, wrows = v0.stage_groups(
            [parse_group(b)[0] for b in blobs])
        ins = to_tensors(DEV, csize_bits=cs, tables=tbl, init_states=init,
                         streams=st)
        args = (*ins.values(), t4, wrows)
        G = len(blobs)
        # payload words, tables, init states, csize once; output words, err
        nb = (4 * int(((cs.astype(np.int64) + 31) // 32).sum()) + tbl.nbytes
              + init.nbytes + cs.nbytes + G * t4 * 4096 + G * 4)
        return dict(key="turbo_fse_decode:v0", mode="v0", G=G, steps=4 * t4,
                    run=partial(v0.turbo_fse_decode, *args),
                    plain=partial(v0.turbo_fse_decode_plain, *args),
                    kernel=partial(v0._decode_v0_kernel, *args[:4], t4),
                    streams=ins["streams"], mid_word=cs // 64, chain="v0",
                    ops=G * 4 * t4 * (V0_OPS_PER_STEP * 1024 + FLAT_SCAN_ADDS),
                    nbytes=lambda o, nb=nb: nb)

    # 3. each kernel entry and mode against its plain version, a group corrupted
    corpus = generate_proba(80, max(MAIN_MIB, PAIR_MIB) * GROUP)
    u16_syms = u16_corpus(U16_MSYMS << 20, False)
    u16x_syms = u16_corpus(U16X_MSYMS << 20, True)
    errs = dict.fromkeys(rk.launches, 0)
    three, three16, three16x = (corpus[:3 * GROUP], u16_syms[:3 * GROUP16],
                                u16x_syms[:3 * GROUP16])
    cases = [Piece("turbo", three, GROUP, f) for f in (
        dict(pair=0, quad=0), dict(quad=0), {}, dict(steptots=False),
        dict(pair=1, steptots=False), dict(totals_only=True))]
    cases += [Piece("turbo16", s, GROUP16, dict(steptots=st))
              for s in (three16, three16x) for st in (True, False)]
    mesh = make_mesh()          # the visible GPUs: the flat byte encode
    m = mesh.devices.size
    require(m >= 1, "no CUDA device in the mesh")
    cases += [Piece("turbo", three, GROUP, dict(f, mesh=mesh))
              for f in (dict(pair=0, quad=0), dict(steptots=False))]
    checked = set()

    def check_decode(b: dict) -> None:
        require(b["G"] == 3, f"{b['key']}: {b['G']} groups, not 3")
        b["streams"][1].view(-1)[int(b["mid_word"][1])] ^= 1 << 9
        want, got = b["plain"](), b["run"]()
        torch.cuda.synchronize()
        errs[b["key"]] = max(errs[b["key"]], max_abs_err(got, want))
        require((got[1] != 0).tolist() == [False, True, False],
                f"{b['key']}: corrupt group not flagged: {got[1].tolist()}")
        checked.add(b["key"])

    for p in cases:
        for b in encode_batches(p):
            errs[b["key"]] = max(errs[b["key"]], max_abs_err(b["run"](), b["plain"]()))
            checked.add(b["key"])
        blob = compress(p)
        for windows in (1, 8):          # the resident and the windowed entry
            for b in decode_batches(p, blob, windows):
                check_decode(b)
    # the byte v1 encode, and the flat encode on U16 tables
    extra = [b for st in (True, False) for b in encode_batches(
        Piece("turbo", three, GROUP, dict(pair=0, quad=0, steptots=st)), "rans_encode")]
    extra += [b for s in (three16, three16x) for b in encode_batches(
        Piece("turbo16", s, GROUP16, dict(steptots=True)), "rans_encode2_flat")]
    for b in extra:
        errs[b["key"]] = max(errs[b["key"]], max_abs_err(b["run"](), b["plain"]()))
        checked.add(b["key"])
    check_decode(v0_batch([turbo_fse_compress(corpus[i * GROUP:(i + 1) * GROUP])
                           for i in range(3)]))
    # the compat kernels at small shapes; a missing endMark is flagged
    for c in compat_small_cases():
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        errs[c["key"]] = max(errs[c["key"]], max_abs_err(got, want))
        if c["err"] is not None:
            require(got[1].tolist() == c["err"],
                    f"{c['key']}: flags {got[1].tolist()} on the corrupt batch")
        checked.add(c["key"])
    require(checked == set(rk.launches),
            f"not checked against plain: {sorted(set(rk.launches) - checked)}")
    require(max(errs.values()) == 0, f"a kernel differs from its plain version: {errs}")
    print(json.dumps({"phase": "kernel_vs_plain", "max_abs_err": errs,
                      "corrupt_group_flagged": [False, True, False]}), flush=True)

    # 4. the paths through the entry points, each counted on its own
    rng = np.random.default_rng(5)
    mixed = (generate_proba(80)[:20000] + b"R" * 9000
             + bytes(rng.integers(0, 256, 12000, dtype=np.uint8))
             + generate_proba(14)[:5000])
    small64 = (generate_proba(90, 1 << 16) + pair_escape_corpus(1 << 16)
               + quad_escape_corpus(1 << 16) + generate_proba(14, 1 << 16))
    byte = dict(pair=0, quad=0)
    main_data, pair_data = corpus[:MAIN_MIB * GROUP], corpus[:PAIR_MIB * GROUP]
    p80_3 = generate_proba(80, 3 * GROUP)
    # each kernel and mode is timed at the first path that launches it
    paths = {
        "default_p80_64MiB": [Piece("turbo", main_data, GROUP)],
        "quad0_p80_8MiB": [Piece("turbo", pair_data, GROUP, dict(quad=0))],
        "byte_p80_64MiB": [Piece("turbo", main_data, GROUP, byte)],
        "byte_p80_3MiB": [Piece("turbo", p80_3, GROUP, byte)],
        "default_mixed": [Piece("turbo", mixed, 9000),
                          Piece("turbo", small64, 1 << 16)],
        "byte_mixed_9000": [Piece("turbo", mixed, 9000, byte)],
        "ratio_p80_64MiB": [Piece("turbo", main_data, GROUP, dict(steptots=False))],
        "ratio_pair_p80_8MiB": [Piece("turbo", pair_data, GROUP,
                                      dict(pair=1, steptots=False))],
        "totals_p80_64MiB": [Piece("turbo", main_data, GROUP, dict(totals_only=True))],
        "totals_p80_3MiB": [Piece("turbo", p80_3, GROUP, dict(totals_only=True))],
        "u16_pareto_64MiB": [
            Piece("turbo16", u16_syms, GROUP16, dict(steptots=True), (0, 8)),
            Piece("turbo16", u16_syms, GROUP16, dict(steptots=False))],
        "u16x_pareto_16MiB": [
            Piece("turbo16", u16x_syms, GROUP16, dict(steptots=True), (0, 8)),
            Piece("turbo16", u16x_syms, GROUP16, dict(steptots=False))],
        "mesh_p80_64MiB": [Piece("turbo", main_data, GROUP, dict(byte, mesh=mesh)),
                           Piece("turbo", main_data, GROUP,
                                 dict(steptots=False, mesh=mesh))],
    }
    warm = Piece("turbo", corpus[:GROUP], GROUP)
    decompress(warm, compress(warm), 0)
    blobs, launches, e2e_s = {}, {}, {}
    for name, pieces in paths.items():
        rk.reset_launches()
        torch.cuda.synchronize()
        for k, p in enumerate(pieces):
            t0 = time.perf_counter()
            blob = compress(p)
            secs = [time.perf_counter() - t0]
            for windows in p.windows:
                t0 = time.perf_counter()
                back = decompress(p, blob, windows)
                secs.append(time.perf_counter() - t0)
                require(same(p, back), f"{name}: round trip of piece {k} "
                                       f"(windows={windows})")
            blobs[(name, k)], e2e_s[f"{name}/{k}"] = blob, secs
        launches[name] = {k: v for k, v in rk.launches.items() if v}
    require(blobs[("mesh_p80_64MiB", 0)] == blobs[("byte_p80_64MiB", 0)]
            and blobs[("mesh_p80_64MiB", 1)] == blobs[("ratio_p80_64MiB", 0)],
            "mesh frames differ from the single-device frames")

    # the U16 round trip over the mesh: the flat encode on 8-chunk tables
    _n, _f, b16 = api.plan_encode16(u16_syms, GROUP16, True)
    ((n16, big16, tlog16), items16), = b16.items()
    fc16, mg16, src16 = api.STAGE_BATCH["u16x" if big16 else "u16"](items16, n16)
    dtbl16 = np.stack([pack_rans16_dtable(it[2][0], tlog16) for it in items16])
    t2, hcap16 = n16 // 2048, api._round8(n16 // 128 + 16)
    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, total = sharded_turbo16_roundtrip(mesh, t2, hcap16, tlog=tlog16)(
        fc16, mg16, src16, dtbl16)
    ok, total = int(ok), int(total)
    e2e_s["mesh_u16_pareto/0"] = [time.perf_counter() - t0]
    launches["mesh_u16_pareto"] = {k: v for k, v in rk.launches.items() if v}
    single16 = sum(g[1] for g in api.parse_groups(blobs[("u16_pareto_64MiB", 0)],
                                                  api.parse_rans16_group))
    require(ok == 1 and total == single16,
            f"mesh u16 round trip: ok {ok}, {total} halfwords, single-device {single16}")
    u16_speed = Piece("turbo16", u16_syms, GROUP16, dict(steptots=True))
    path_batches = {"mesh_u16_pareto": lambda: [dict(b, shards=m) for b in (
        encode_batches(u16_speed, "rans_encode2_flat")
        + decode_batches(u16_speed, blobs[("u16_pareto_64MiB", 0)], 1))]}

    # U16Codec's turbo wire (models/u16_codec.py) on a stream of each
    # alphabet: its frames are the first groups of the u16 and u16x paths'
    # speed frames
    from finitestateentropy_tpu_torch.models import U16Codec

    codec_streams = [u16_syms[:U16CODEC_GROUPS * GROUP16],
                     u16x_syms[:U16CODEC_GROUPS * GROUP16]]
    u16c = U16Codec(wire="turbo")
    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u16c_blobs = u16c.compress_streams(codec_streams)
    secs = [time.perf_counter() - t0]
    t0 = time.perf_counter()
    back = u16c.decompress_streams([(b, len(s)) for b, s in zip(u16c_blobs, codec_streams)])
    torch.cuda.synchronize()
    e2e_s["u16codec_turbo/0"] = secs + [time.perf_counter() - t0]
    launches["u16codec_turbo"] = {k: v for k, v in rk.launches.items() if v}
    require(all(np.array_equal(s, o) for s, o in zip(codec_streams, back)),
            "u16codec_turbo: the round trip")
    for blob, path in zip(u16c_blobs, ("u16_pareto_64MiB", "u16x_pareto_16MiB")):
        ref = blobs[(path, 0)]
        require(ref.startswith(blob)
                and len(api.parse_groups(blob, api.parse_rans16_group)) == U16CODEC_GROUPS,
                f"u16codec_turbo: the frames differ from {path}'s first groups")
    codec_pieces = [Piece("turbo16", s, GROUP16, dict(steptots=True)) for s in codec_streams]
    path_batches["u16codec_turbo"] = lambda: [
        b for p, blob in zip(codec_pieces, u16c_blobs)
        for b in encode_batches(p) + decode_batches(p, blob, 0)]

    def dryrun_batches() -> list[dict]:
        """The batches of dryrun_multichip(m) on the dry run's own inputs
        (parallel/dryrun.py): each sharded round trip's encode and decode
        over its 2m groups (the windowed one's min(m, 2)), a launch per
        shard, the decode fed the plain encode's output; then the mixed
        frame's batches as the entry points plan them."""
        p80, w = generate_proba(80), min(m, 2)
        trips = (  # inputs, encode flags, decode entry, decode flags, shards
            (dr.byte_inputs(p80, 2 * m, 8192) + (11,), dict(steptots=False),
             "rans_decode", {}, m),
            (dr.byte_inputs(p80, 2 * m, 8192) + (11,), {}, "rans_decode_v2", {}, m),
            (dr.w_inputs(w) + (11,), dict(rowloc=True), "rans_decode_w",
             dict(nway=1, S=32), w),
            (dr.u16_inputs(2 * m) + (11,), dict(u16=True), "rans_decode_v2",
             dict(u16=True), m),
            (dr.multibyte_inputs(2 * m, "pair")[:7], dict(u16=True, rowloc=True),
             "rans_decode_v2", dict(u16=True, pair=True), m),
            (dr.multibyte_inputs(2 * m, "quad")[:7], dict(quad=True, rowloc=True),
             "rans_decode_v2", dict(quad=True), m))
        # the compat step: sharded_fse_step's encode and decode of the
        # graft entry's batch, a launch per shard
        from finitestateentropy_tpu_torch.ops import bitio, fse_kernels as fk, fse_tables

        S = dr.COMPAT_BLOCK
        src, n, norm, tlog = (torch.from_numpy(a).to(DEV) for a in dr.compat_inputs(2 * m, S))
        enc = (src, n, tlog, fse_tables.build_ctables(norm, tlog))
        kw = dict(max_syms=S, out_bytes=S + (S >> 6) + 64)
        words, csize = fk.fse_encode_batch_plain(*enc, **kw)
        dec = (bitio.words_to_bytes(words), csize, n, tlog,
               fse_tables.build_dtables(norm, tlog)[:3])
        out = [dict(key="fse_encode", shards=m, run=partial(fk.fse_encode_batch, *enc, **kw),
                    plain=lambda enc_out=(words, csize): enc_out),
               dict(key="fse_decode", shards=m, run=partial(fk.fse_decode_batch, *dec, max_out=S),
                    plain=partial(fk.fse_decode_batch_plain, *dec, max_out=S))]
        for (*arrays, steps, hcap, tlog), ef, entry, df, shards in trips:
            fc, mg, srcw, dtbl = (torch.from_numpy(a).to(DEV) for a in arrays)
            rowloc = ef.pop("rowloc", False)
            args = (fc, mg, srcw, steps, hcap, tlog)
            enc = rk.rans_encode2_plain(*args, **ef)
            mode = rk._encode_mode(fc, mg, srcw, steps, ef.get("u16", False),
                                   ef.get("quad", False))
            out.append(dict(key=f"rans_encode2{'' if rowloc else '_flat'}:{mode}",
                            shards=shards, plain=lambda enc=enc: enc,
                            run=partial(rk.rans_encode2, *args[:5], tlog=tlog, **ef,
                                        rowloc=rowloc)))
            stream, fin, csize, stots = enc
            nway, S = df.pop("nway", 0), df.pop("S", 0)
            if entry == "rans_decode":
                dargs = (csize, dtbl, fin, stream, steps, hcap)
                run = partial(rk.rans_decode, *dargs, tlog=tlog)
                plain = partial(rk.rans_decode_v1_plain, *dargs, tlog=tlog)
            else:
                dargs = (csize, dtbl, fin, stream, stots, steps, hcap)
                run = (partial(rk.rans_decode_w, *dargs, nway, tlog, S, **df) if nway
                       else partial(rk.rans_decode_v2, *dargs, tlog=tlog, **df))
                plain = partial(rk.rans_decode_plain, *dargs, tlog, **df)
            dmode = rk._mode(df.get("u16", False), df.get("pair", False),
                             df.get("quad", False))
            out.append(dict(key=f"{entry}:{dmode}", shards=shards, run=run,
                            plain=plain))
        one = Piece("turbo", dr.mixed_frame_data(), dr.MIXED_GROUP)
        meshed = Piece("turbo", one.data, one.group, dict(mesh=mesh)) if m > 1 else one
        return (out + encode_batches(meshed) + encode_batches(one)
                + decode_batches(meshed, compress(one), 0))
    path_batches["dryrun_multichip"] = dryrun_batches

    # the multi-device dry run over the visible GPUs
    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dry = []
    dr.dryrun_multichip(m, log=dry.append)
    torch.cuda.synchronize()
    e2e_s["dryrun_multichip/0"] = [time.perf_counter() - t0]
    launches["dryrun_multichip"] = {k: v for k, v in rk.launches.items() if v}
    print(json.dumps({"phase": "dryrun_multichip", "devices": m,
                      "lines": dry}), flush=True)

    # the v0 TurboFSE path: the numpy twin encodes, one decode launch
    v0_data = corpus[:V0_MIB * GROUP]
    t0 = time.perf_counter()
    v0_blobs = [turbo_fse_compress(v0_data[i * GROUP:(i + 1) * GROUP])
                for i in range(V0_MIB)]
    v0_secs = [time.perf_counter() - t0]
    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, err = v0_batch(v0_blobs)["run"]()
    out, err = out.cpu().numpy(), err.cpu().numpy()
    v0_secs.append(time.perf_counter() - t0)
    launches["v0_p80_16MiB"] = {k: v for k, v in rk.launches.items() if v}
    require(not err.any() and out.astype("<i4").tobytes() == v0_data,
            "v0 path: the decode does not give the input back")
    require(all(turbo_fse_decompress(b) == v0_data[i * GROUP:(i + 1) * GROUP]
                for i, b in enumerate(v0_blobs)), "v0 path: twin decode differs")
    e2e_s["v0_p80_16MiB/0"] = v0_secs
    path_batches["v0_p80_16MiB"] = lambda: [v0_batch(v0_blobs)]

    # the device-resident paths (turbo/device_api.py): the payload stays on
    # the GPU; the histogram, normalization and tables run there too
    x64 = torch.from_numpy(np.frombuffer(main_data, np.uint8).copy()).to(DEV)
    res_modes = {"rows": (x64, {}),
                 "totals": (x64[:RES_SMALL_MIB * GROUP], dict(totals_only=True)),
                 "ratio": (x64[:RES_SMALL_MIB * GROUP], dict(steptots=False))}
    res_blobs = {}
    rk.reset_launches()
    torch.cuda.synchronize()
    for mode, (x, kw) in res_modes.items():
        t0 = time.perf_counter()
        blob = da.rans_compress_resident(x, GROUP, **kw)
        secs = [time.perf_counter() - t0]
        t0 = time.perf_counter()
        back = da.rans_decompress_resident(blob, device=DEV)
        require(back.device == x.device and torch.equal(back, x),
                f"resident_p80_64MiB: the {mode} round trip")
        torch.cuda.synchronize()
        e2e_s[f"resident_p80_64MiB/{mode}"] = secs + [time.perf_counter() - t0]
        res_blobs[mode] = blob
    launches["resident_p80_64MiB"] = {k: v for k, v in rk.launches.items() if v}

    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, rt_cs, rt_n = da.rans_resident_roundtrip(x64, GROUP)
    e2e_s["resident_roundtrip_p80_64MiB/0"] = [time.perf_counter() - t0]
    launches["resident_roundtrip_p80_64MiB"] = {k: v for k, v in rk.launches.items() if v}
    frames_cs = sum(g[1] for g in api.parse_groups(res_blobs["rows"]))
    require(ok and rt_n == len(main_data) and rt_cs == frames_cs,
            f"resident round trip: ok {ok}, {rt_cs} halfwords, frames {frames_cs}")

    # mixed groups (bench.py:596-609): coded, raw and RLE rows share the
    # encode launch; one sync of the flags gives the coded set
    xm = torch.from_numpy(np.frombuffer(mixed_corpus(GROUP, MIXED_GROUPS),
                                        np.uint8).copy()).to(DEV)
    lens_m = torch.full((MIXED_GROUPS,), GROUP, dtype=torch.int32, device=DEV)
    warm_m = da._resident_compress(xm.view(MIXED_GROUPS, GROUP), lens_m, GROUP,
                                   RES_TLOG, True)
    flags_m = warm_m[6].cpu().numpy()
    coded_m = tuple(int(i) for i in np.flatnonzero(flags_m == 0))
    require(flags_m.tolist() == [0, 0, 4, 1] * (MIXED_GROUPS // 4),
            f"resident mixed flags {flags_m.tolist()}")
    torch.cuda.synchronize()            # a fault in the shared launch shows here
    cap_hw = api._hrows_cap(GROUP) * 128
    csize_m = warm_m[2].cpu().numpy()
    require(int(csize_m.max()) <= cap_hw,
            f"resident mixed: csize {csize_m.tolist()} past the capacity {cap_hw}")
    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, mixed_cs = da._resident_mixed_rt(xm, GROUP, RES_TLOG, coded_m)
    ok, mixed_cs = bool(ok), int(mixed_cs)
    e2e_s["resident_mixed_16MiB/0"] = [time.perf_counter() - t0]
    launches["resident_mixed_16MiB"] = {k: v for k, v in rk.launches.items() if v}
    mixed_frames = api.parse_groups(da.rans_compress_resident(xm, GROUP))
    require(ok and mixed_cs == sum(int(csize_m[i]) for i in coded_m)
            == sum(mixed_frames[i][1] for i in coded_m),
            f"resident mixed round trip: ok {ok}, {mixed_cs} halfwords")

    # the CLI in a subprocess: -T compresses a file, -T -d gives it back
    cli_data = corpus[:CLI_MIB * GROUP]
    cli_launches = {}
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        src, tfse, back = (Path(tmp) / n for n in ("p80", "p80.tfse", "back"))
        src.write_bytes(cli_data)
        t0 = time.perf_counter()
        secs = []
        for argv in (["-T", "-f", str(src), str(tfse)],
                     ["-T", "-d", "-f", str(tfse), str(back)]):
            for k, v in run_cli(argv).items():
                cli_launches[k] = cli_launches.get(k, 0) + v
            secs.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        cli_blob = tfse.read_bytes()
        require(back.read_bytes() == cli_data, "cli_p80_8MiB: the round trip")
    e2e_s["cli_p80_8MiB/0"] = secs
    launches["cli_p80_8MiB"] = cli_launches
    require(cli_blob == api.turbo_compress_device(cli_data, device=DEV),
            "cli_p80_8MiB: .tfse differs from turbo_compress_device")

    def resident_encode_batch(name: str, x, mode_kw: dict, coded=None) -> dict:
        """The resident compress's encode of x's one batch (1 MiB groups),
        its device ops held against their CPU runs, the host prep
        (_prep_group) and the host packers; the launch against its plain
        version on the coded rows (coded None: all)."""
        n = int(x.shape[0])
        _count, batches = da._resident_batches(n, GROUP)
        ((n_pad, items),) = batches.items()
        st = mode_kw.get("steptots", True)
        tlog = RES_TLOG if st else RANS_TABLELOG
        xp, lens = da._resident_slices(x, items, n_pad)
        gpu_ops = da._resident_prep(xp, lens, n_pad, tlog)
        cpu_ops = da._resident_prep(xp.cpu(), lens.cpu(), n_pad, tlog)
        names = ("counts", "norm", "flags", "mfs", "norm_s", "fc", "magic", "srcw")
        for nm, g, c in zip(names, gpu_ops, cpu_ops):
            require(torch.equal(g.cpu(), c), f"{name}: device op {nm} differs from its CPU run")
        counts, norm, flags, mfs, norm_s, fc, mg, srcw = (t.cpu().numpy() for t in gpu_ops)
        host = x.cpu().numpy()
        for j, (_gi, st0, ln) in enumerate(items):
            prep = api._prep_group(host[st0:st0 + ln], tlog)
            if prep is None:
                require(flags[j] in (1, 4), f"{name}: group {j} flags {flags[j]}")
                continue
            h_norm, max_sv, _nc, h_mfs = prep
            h_fc, h_mg = pack_rans_ctables(h_norm)
            require(flags[j] == 0 and mfs[j] == h_mfs
                    and np.array_equal(norm[j, :max_sv + 1], h_norm)
                    and not norm[j, max_sv + 1:].any()
                    and np.array_equal(fc[j].reshape(-1)[:max_sv + 1],
                                       h_fc.reshape(-1)[:max_sv + 1])
                    and np.array_equal(mg[j].reshape(-1)[:max_sv + 1],
                                       h_mg.reshape(-1)[:max_sv + 1]),
                    f"{name}: group {j} differs from the host prep")
        device_ops_checked[name] = device_ops_checked.get(name, 0) + len(items)
        rows = (torch.arange(len(items), device=DEV) if coded is None
                else torch.tensor(coded, device=DEV))
        args = (gpu_ops[5], gpu_ops[6], gpu_ops[7], n_pad // 4096,
                api._hrows_cap(n_pad))

        def on_rows(out):
            return tuple(None if o is None else o[rows] for o in out)
        enc = partial(rk.rans_encode2, *args, tlog=tlog, steptots=st, rowloc=True)
        return dict(key="rans_encode2:byte", shards=1,
                    run=lambda: on_rows(enc()),
                    plain=lambda: on_rows(rk.rans_encode2_plain(*args, tlog, steptots=st)),
                    outputs=enc,
                    norm_s=gpu_ops[4], tlog=tlog, t4=n_pad // 4096,
                    hcap=api._hrows_cap(n_pad))

    def resident_decode_batches(blob: bytes) -> list[dict]:
        """rans_decompress_resident's decode batches of blob: rows and
        totals frames through rans_decode_v2, v1 frames through
        rans_decode."""
        groups = api.parse_groups(blob)
        out = []
        for (wire, n_pad, tlog, kind), idxs in api.plan_decode(groups)[1].items():
            cs, tbl, init, hws, tots, t4, hrows = api.stage_decode_batch(
                groups, idxs, n_pad, tlog, wire, kind)
            ins = tuple(to_tensors(DEV, csize_hw=cs, tables=tbl, init_states=init,
                                   streams=hws).values())
            if kind:
                stt = to_tensors(DEV, steptots=tots)["steptots"]
                out.append(dict(
                    key="rans_decode_v2:" + ("totals" if kind == 1 else wire), shards=1,
                    run=partial(rk.rans_decode_v2, *ins, stt, t4, hrows, tlog=tlog),
                    plain=partial(rk.rans_decode_plain, *ins, stt, t4, hrows, tlog)))
            else:
                out.append(dict(
                    key=f"rans_decode:{wire}", shards=1,
                    run=partial(rk.rans_decode, *ins, t4, hrows, tlog=tlog),
                    plain=partial(rk.rans_decode_v1_plain, *ins, t4, hrows, tlog=tlog)))
        return out

    def resident_w_batch(name: str, enc: dict, coded=None) -> dict:
        """The round trips' windowed decode of enc's encode output on the
        coded rows, with decode tables built on the device (held against
        their CPU build and the host packer)."""
        stream, fin, csize, stots = enc["outputs"]()
        rows = slice(None) if coded is None else torch.tensor(coded, device=DEV)
        norm_s = enc["norm_s"][rows]
        dtbl = pack_rans_dtable_batch(norm_s, enc["tlog"])
        require(torch.equal(dtbl.cpu(), pack_rans_dtable_batch(norm_s.cpu(), enc["tlog"])),
                f"{name}: device dtable differs from its CPU run")
        for j, row in enumerate(norm_s.cpu().numpy()):
            max_sv = int(np.flatnonzero(row).max())
            require(np.array_equal(dtbl[j].cpu().numpy(),
                                   pack_rans_dtable(row[:max_sv + 1], enc["tlog"])),
                    f"{name}: device dtable {j} differs from the host packer")
        args = (csize[rows], dtbl, fin[rows], stream[rows], stots[rows], enc["t4"],
                enc["hcap"])
        return dict(key="rans_decode_w:byte", shards=1,
                    run=partial(rk.rans_decode_w, *args, 8, enc["tlog"], 32),
                    plain=partial(rk.rans_decode_plain, *args, enc["tlog"]))

    device_ops_checked = {}
    path_batches["resident_p80_64MiB"] = lambda: [
        b for mode, (x, kw) in res_modes.items()
        for b in [resident_encode_batch("resident_p80_64MiB", x, kw)]
        + resident_decode_batches(res_blobs[mode])]

    def roundtrip_batches(name, x, coded=None):
        enc = resident_encode_batch(name, x, {}, coded)
        return [enc, resident_w_batch(name, enc, coded)]
    path_batches["resident_roundtrip_p80_64MiB"] = lambda: roundtrip_batches(
        "resident_roundtrip_p80_64MiB", x64)
    path_batches["resident_mixed_16MiB"] = lambda: roundtrip_batches(
        "resident_mixed_16MiB", xm, coded_m)
    cli_piece = Piece("turbo", cli_data, GROUP)
    path_batches["cli_p80_8MiB"] = lambda: (encode_batches(cli_piece)
                                            + decode_batches(cli_piece, cli_blob, 0))
    # the compat codecs: FSE and Huff0 frames (io/frame.py) through the
    # device codecs (models/) at the CLI's 32 KiB blocks, one encode and one
    # decode launch a batch; frames held against the host twin
    from finitestateentropy_tpu_torch.io import frame as fio
    from finitestateentropy_tpu_torch.models import (AutoTpuCodec, FseTpuCodec,
                                                     HufTpuCodec, choose_codec,
                                                     get_batch_codec)

    def codec_of(name: str, **kw):
        return {"fse": FseTpuCodec, "huf": HufTpuCodec}[name](**kw)

    def counted(name: str, fn):
        """fn() with the launch counts set to 0 before it and read after."""
        rk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        e2e_s[f"{name}/0"] = [time.perf_counter() - t0]
        launches[name] = {k: v for k, v in rk.launches.items() if v}
        return out

    # the 64 MiB paths; the device frames of the first COMPAT_MIB equal the
    # host twin's, and the 64 MiB frames begin with their blocks
    prefix = main_data[:COMPAT_MIB * GROUP]
    compat_blobs, compat_twin, frames8 = {}, {}, {}
    for codec in ("fse", "huf"):
        name, items = f"{codec}_p80_64MiB", []
        rk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = fio.compress_bytes(main_data, codec, COMPAT_BID,
                                  codec_of(codec).compress_blocks)
        secs = [time.perf_counter() - t0]
        t0 = time.perf_counter()
        back = fio.decompress_bytes(blob, recording(codec_of(codec).decompress_blocks, items))
        e2e_s[f"{name}/0"] = secs + [time.perf_counter() - t0]
        launches[name] = {k: v for k, v in rk.launches.items() if v}
        require(back == main_data, f"{name}: the round trip")
        compat_blobs[codec] = blob
        frames8[codec] = fio.compress_bytes(prefix, codec, COMPAT_BID,
                                            codec_of(codec).compress_blocks)
        require(blob.startswith(frames8[codec][:-3]),   # all but the trailer
                f"{name}: the first {COMPAT_MIB} MiB's blocks differ from their own frame's")
        compat_twin[codec] = fio.compress_bytes(prefix, codec, COMPAT_BID)
        require(frames8[codec] == compat_twin[codec],
                f"{name}: the first {COMPAT_MIB} MiB's frame differs from the host twin's")
        dec = main_data[:TWIN_DECODE_MIB * GROUP]
        require(fio.decompress_bytes(fio.compress_bytes(
            dec, codec, COMPAT_BID, codec_of(codec).compress_blocks)) == dec,
            f"{name}: the host twin does not decode the device frame")
        path_batches[name] = partial(
            lambda c, it: (compat_encode_batches(codec_of(c), fio.split_blocks(
                main_data, COMPAT_BLOCK)) + compat_decode_batches(codec_of(c), it)),
            codec, items)

    # the X2 decoder on the first 8 MiB's Huff0 frame (tables built on the host)
    x2_codec, x2_items = HufTpuCodec(decoder="x2"), []
    require(counted("huf_x2_p80_8MiB", lambda: fio.decompress_bytes(
        frames8["huf"], recording(x2_codec.decompress_blocks, x2_items))) == prefix,
        "huf_x2_p80_8MiB: the round trip")
    path_batches["huf_x2_p80_8MiB"] = lambda: compat_decode_batches(x2_codec, x2_items)
    # and on the whole 64 MiB frame: 2048 blocks, timed as a row of its own
    x2_items64 = []
    require(counted("huf_x2_p80_64MiB", lambda: fio.decompress_bytes(
        compat_blobs["huf"], recording(x2_codec.decompress_blocks, x2_items64))) == main_data,
        "huf_x2_p80_64MiB: the round trip")
    path_batches["huf_x2_p80_64MiB"] = lambda: compat_decode_batches(x2_codec, x2_items64)

    # mixed blocks: Proba80, Proba14, random, one repeated byte, a ragged
    # tail; FSE, Huff0 and the auto pick, each frame decoded by its magic
    mixed_c = mixed_corpus(GROUP, COMPAT_MIB) + generate_proba(80)[:12345]
    chosen = choose_codec(fio.split_blocks(mixed_c, COMPAT_BLOCK))
    tags = (("fse", "fse"), ("huf", "huf"), (chosen, "auto"))   # (codec, frame)
    mixed_items = {tag: [] for _c, tag in tags}

    def mixed_run() -> dict:
        frames = {}
        for codec, tag in tags:
            c = AutoTpuCodec() if tag == "auto" else codec_of(codec)
            blob = fio.compress_bytes(mixed_c, codec, COMPAT_BID, c.compress_blocks)
            magic = fio.CODEC_BY_MAGIC[int.from_bytes(blob[:4], "little")]
            require(fio.decompress_bytes(blob, recording(get_batch_codec(magic)[1],
                                                         mixed_items[tag])) == mixed_c,
                    f"compat_mixed_8MiB: the {tag} round trip")
            frames[tag] = blob
        return frames
    mixed_frames = counted("compat_mixed_8MiB", mixed_run)
    mixed_twin = {c: fio.compress_bytes(mixed_c, c, COMPAT_BID) for c in ("fse", "huf")}
    require(all(mixed_frames[tag] == mixed_twin[codec] for codec, tag in tags),
            "compat_mixed_8MiB: a frame differs from the host twin's")
    path_batches["compat_mixed_8MiB"] = lambda: [
        b for codec, tag in tags for b in
        compat_encode_batches(codec_of(codec), fio.split_blocks(mixed_c, COMPAT_BLOCK))
        + compat_decode_batches(codec_of(codec), mixed_items[tag])]

    # the CLI in a child process: -e, -h and --auto on the device codecs,
    # each then -d; -z on the host twin (no device codec), then -d
    cli_frames, cli_launches = {}, {}
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        src = Path(tmp) / "p80"
        src.write_bytes(prefix)
        t0 = time.perf_counter()
        for flags, tag in ((["-e"], "fse"), (["-h"], "huf"), (["--auto"], "auto"),
                           (["-z", "--device", "host"], "zlibh")):
            out, back = Path(tmp) / f"p80.{tag}.fse", Path(tmp) / f"{tag}.back"
            for argv in ([*flags, "-f", str(src), str(out)],
                         ["-d", "-f", str(out), str(back)]):
                for k, v in run_cli(argv).items():
                    cli_launches[k] = cli_launches.get(k, 0) + v
            require(back.read_bytes() == prefix, f"cli_compat_p80_8MiB: the {tag} round trip")
            cli_frames[tag] = out.read_bytes()
        e2e_s["cli_compat_p80_8MiB/0"] = [time.perf_counter() - t0]
    launches["cli_compat_p80_8MiB"] = cli_launches
    cli_pick = choose_codec(fio.split_blocks(prefix, COMPAT_BLOCK))
    cli_tags = (("fse", "fse"), ("huf", "huf"), (cli_pick, "auto"))
    require(all(cli_frames[tag] == compat_twin[codec] for codec, tag in cli_tags),
            "cli_compat_p80_8MiB: a frame differs from --device host's (the host twin's)")
    require(fio.CODEC_BY_MAGIC[int.from_bytes(cli_frames["zlibh"][:4], "little")] == "zlibh",
            "cli_compat_p80_8MiB: -z wrote no zlibh frame")
    # the child's decode batches: the items of its frames, decoded here
    cli_items = {tag: [] for _c, tag in cli_tags}
    for codec, tag in cli_tags:
        fio.decompress_bytes(cli_frames[tag], recording(codec_of(codec).decompress_blocks,
                                                        cli_items[tag]))
    path_batches["cli_compat_p80_8MiB"] = lambda: [
        b for codec, tag in cli_tags for b in
        compat_encode_batches(codec_of(codec), fio.split_blocks(prefix, COMPAT_BLOCK))
        + compat_decode_batches(codec_of(codec), cli_items[tag])]

    # the four sharded_* steps over the mesh of the visible GPUs (one card:
    # one shard): the mesh frames equal the single-device frames
    mesh_items = {"fse": [], "huf": []}

    def mesh_run() -> dict:
        frames = {}
        for codec in ("fse", "huf"):
            c = codec_of(codec, mesh=mesh)
            frames[codec] = fio.compress_bytes(prefix, codec, COMPAT_BID, c.compress_blocks)
            require(fio.decompress_bytes(frames[codec], recording(
                c.decompress_blocks, mesh_items[codec])) == prefix,
                f"mesh_compat_p80: the {codec} round trip")
        return frames
    mesh_frames = counted("mesh_compat_p80", mesh_run)
    require(mesh_frames == frames8,
            "mesh_compat_p80: the mesh frames differ from the single-device frames")
    path_batches["mesh_compat_p80"] = lambda: [
        b for codec in ("fse", "huf") for b in
        compat_encode_batches(codec_of(codec), fio.split_blocks(prefix, COMPAT_BLOCK), m)
        + compat_decode_batches(codec_of(codec), mesh_items[codec], m)]
    print(json.dumps({"phase": "compat_frames_vs_twin",
                      "twin_frames_equal_mib": {"fse_huf_64MiB_prefix": COMPAT_MIB,
                                                "cli": COMPAT_MIB, "mixed": COMPAT_MIB},
                      "twin_decoded_mib": TWIN_DECODE_MIB,
                      "auto_pick": {"mixed": chosen, "cli_p80": cli_pick},
                      "ratio": {c: len(main_data) / len(b) for c, b in compat_blobs.items()},
                      "mixed_ratio": {c: len(mixed_c) / len(b) for c, b in mixed_frames.items()}}),
          flush=True)

    print(json.dumps({"phase": "main_path", "launches": launches,
                      "seconds_compress_then_decompress": e2e_s}), flush=True)
    expect = {
        "default_p80_64MiB": {"rans_encode2:quad": 1, "rans_decode_w:quad": 1},
        "quad0_p80_8MiB": {"rans_encode2:pair": 1, "rans_decode_w:pair": 1},
        "byte_p80_64MiB": {"rans_encode2:byte": 1, "rans_decode_w:byte": 1},
        "byte_p80_3MiB": {"rans_encode2:byte": 1, "rans_decode_v2:byte": 1},
        "ratio_p80_64MiB": {"rans_encode2:byte": 1, "rans_decode:byte": 1},
        "ratio_pair_p80_8MiB": {"rans_encode2:pair": 1, "rans_decode:pair": 1},
        "totals_p80_64MiB": {"rans_encode2:byte": 1, "rans_decode_w:totals": 1},
        "totals_p80_3MiB": {"rans_encode2:byte": 1, "rans_decode_v2:totals": 1},
        "u16_pareto_64MiB": {"rans_encode:u16": 2, "rans_decode_v2:u16": 1,
                             "rans_decode_w:u16": 1, "rans_decode:u16": 1},
        "u16x_pareto_16MiB": {"rans_encode:u16x": 2, "rans_decode_v2:u16x": 1,
                              "rans_decode_w:u16x": 1, "rans_decode:u16x": 1},
        # one launch per shard of each step
        "mesh_p80_64MiB": {"rans_encode2_flat:byte": 2 * m,
                           "rans_decode_v2:byte": m, "rans_decode:byte": m},
        "mesh_u16_pareto": {"rans_encode2_flat:u16": m, "rans_decode_v2:u16": m},
        "dryrun_multichip": dryrun_launches(m),
        "v0_p80_16MiB": {"turbo_fse_decode:v0": 1},
        # one encode per mode; the resident decode takes v2 for rows and
        # totals frames, rans_decode for v1 frames
        "resident_p80_64MiB": {"rans_encode2:byte": 3, "rans_decode_v2:byte": 1,
                               "rans_decode_v2:totals": 1, "rans_decode:byte": 1},
        "resident_roundtrip_p80_64MiB": {"rans_encode2:byte": 1,
                                         "rans_decode_w:byte": 1},
        "resident_mixed_16MiB": {"rans_encode2:byte": 1, "rans_decode_w:byte": 1},
        # default flags: 8 x 1 MiB of Proba80 go quad, as on the main path
        "cli_p80_8MiB": {"rans_encode2:quad": 1, "rans_decode_w:quad": 1},
        # the compat codecs: one encode and one decode launch a batch
        "fse_p80_64MiB": {"fse_encode": 1, "fse_decode": 1},
        "huf_p80_64MiB": {"huf_encode_4x": 1, "huf_decode_4x:x1": 1},
        "huf_x2_p80_8MiB": {"huf_decode_4x:x2": 1},
        "huf_x2_p80_64MiB": {"huf_decode_4x:x2": 1},
        # U16Codec's turbo wire: the entry points' speed frames at windows=0
        "u16codec_turbo": {"rans_encode:u16": 1, "rans_decode_v2:u16": 1,
                           "rans_encode:u16x": 1, "rans_decode_v2:u16x": 1},
        "compat_mixed_8MiB": {
            "fse_encode": 1 + (chosen == "fse"), "fse_decode": 1 + (chosen == "fse"),
            "huf_encode_4x": 1 + (chosen == "huf"), "huf_decode_4x:x1": 1 + (chosen == "huf")},
        "cli_compat_p80_8MiB": {
            "fse_encode": 1 + (cli_pick == "fse"), "fse_decode": 1 + (cli_pick == "fse"),
            "huf_encode_4x": 1 + (cli_pick == "huf"),
            "huf_decode_4x:x1": 1 + (cli_pick == "huf")},
        "mesh_compat_p80": {"fse_encode": m, "fse_decode": m, "huf_encode_4x": m,
                            "huf_decode_4x:x1": m}}
    for name, want in expect.items():
        require(launches[name] == want, f"{name} routes: {launches[name]}")
    for name, need in (("default_mixed", ("pair", "quad", "byte")),
                       ("byte_mixed_9000", ("byte",))):
        got = launches[name]
        require(all(got.get(f"{e}:{w}", 0) >= 1 for w in need
                    for e in ("rans_encode2", "rans_decode_v2"))
                and not any(k.startswith("rans_decode_w") for k in got),
                f"{name} routes: {got}")

    # every frame equals the twin of the wire and mode its group was coded in
    def frames_of(p: Piece, blob: bytes) -> list[bytes]:
        parse = (api.parse_rans16_group if p.codec == "turbo16"
                 else api.parse_rans_group)
        out, pos = [], 0
        while pos < len(blob):
            _g, used = parse(blob[pos:])
            out.append(blob[pos:pos + used])
            pos += used
        return out

    def wires_of(p: Piece) -> dict:
        """{group index: wire} of p's coded groups (RLE and raw: absent)."""
        if p.codec == "turbo16":
            return {}
        f = p.flags
        tlog0, pair, quad = api.mode_flags(
            0, f.get("steptots", True), f.get("totals_only", False),
            f.get("pair", -1), f.get("quad", -1))
        _n, _f, batches = api.plan_encode(p.data, p.group, tlog0, pair, quad)
        return {gi: wire for (wire, _p, _t), items in batches.items()
                for gi, _ch, _prep in items}

    n_frames, wires_seen, twin_frames = 0, {}, {}
    for name, pieces in paths.items():
        for k, p in enumerate(pieces):
            frames = frames_of(p, blobs[(name, k)])
            require(len(frames) == -(-len(p.data) // p.group), f"{name}: group count")
            st, tot = p.flags.get("steptots", True), p.flags.get("totals_only", False)
            wire_of = wires_of(p)
            for i, f in enumerate(frames):
                ch = p.data[i * p.group:(i + 1) * p.group]
                if p.codec == "turbo16":
                    wire, want = "u16", rans16_compress(ch, st)
                else:
                    wire = wire_of.get(i, "byte")       # RLE / raw: the byte twin's
                    want = (quad_compress(ch) if wire == "quad"
                            else pair_compress(ch, steptots=st) if wire == "pair"
                            else None)
                    if want is None:
                        want = rans_compress(ch, steptots=st, totals_only=tot)
                require(f == want, f"{name}: frame {i} differs from the {wire} twin")
                twin_frames.setdefault((name, k), []).append(want)
                wires_seen.setdefault(name, set()).add(wire)
            n_frames += len(frames)
    require(wires_seen["default_p80_64MiB"] == {"quad"}, "main path not all quad")
    require(wires_seen["quad0_p80_8MiB"] == {"pair"}, "quad=0 path not all pair")
    require(wires_seen["ratio_pair_p80_8MiB"] == {"pair"}, "ratio pair path not all pair")
    ratio = {f"{n}/{k}": paths[n][k].nbytes / len(blobs[(n, k)])
             for n, k in (("default_p80_64MiB", 0), ("quad0_p80_8MiB", 0),
                          ("byte_p80_64MiB", 0), ("ratio_p80_64MiB", 0),
                          ("ratio_pair_p80_8MiB", 0), ("totals_p80_64MiB", 0),
                          ("u16_pareto_64MiB", 0), ("u16_pareto_64MiB", 1),
                          ("u16x_pareto_16MiB", 0), ("u16x_pareto_16MiB", 1))}
    print(json.dumps({"phase": "frames_vs_twin", "frames": n_frames,
                      "wires": {p: sorted(w) for p, w in wires_seen.items()},
                      "ratio": ratio}), flush=True)
    # the resident frames equal the host path's on the byte wire
    # (turbo_compress_device(d, pair=0, quad=0): the byte path; the totals and
    # ratio paths' first groups) and the numpy twin's of that mode
    host_of = {"rows": ("byte_p80_64MiB", MAIN_MIB),
               "totals": ("totals_p80_64MiB", RES_SMALL_MIB),
               "ratio": ("ratio_p80_64MiB", RES_SMALL_MIB)}
    for mode, (path, k) in host_of.items():
        host = b"".join(frames_of(paths[path][0], blobs[(path, 0)])[:k])
        require(res_blobs[mode] == host == b"".join(twin_frames[(path, 0)][:k]),
                f"resident_p80_64MiB: the {mode} frames differ from {path}'s and the twin's")
    print(json.dumps({"phase": "resident_frames_vs_host_and_twin",
                      "groups": {m: k for m, (_p, k) in host_of.items()},
                      "ratio": {m: res_modes[m][0].numel() / len(b)
                                for m, b in res_blobs.items()}}), flush=True)

    # 5. every batch of every path: the wrappers against the plain versions
    def batches_of(name: str) -> list[dict]:
        if name in path_batches:
            return path_batches[name]()
        out = []
        for k, p in enumerate(paths[name]):
            out += encode_batches(p)
            for windows in p.windows:
                out += decode_batches(p, blobs[(name, k)], windows)
        return out

    shapes, extra_shapes, path_errs = {}, {}, {}
    plain_of = {}       # compat ident -> the plain version's outputs and ms
    for name in [*paths, *path_batches]:
        perr, counts = {}, {}
        for b in batches_of(name):
            key = b["key"]
            if "ident" in b:
                got = b["run"]()
                if b["ident"] not in plain_of:
                    plain_of[b["ident"]] = timed_call(b["plain"])
                want, b["plain_ms"] = plain_of[b["ident"]]
            else:
                got, want = b["run"](), b["plain"]()
            if not is_encode(key):
                require(not want[1].any(), f"{name}: plain decode flags a clean group")
            perr[key] = max(perr.get(key, 0), max_abs_err(got, want))
            counts[key] = counts.get(key, 0) + b.get("shards", 1)
            if "kernel" in b:                   # timed at the first path's shapes
                shapes.setdefault(key, (name, b))
                if name in EXTRA_ROWS:
                    extra_shapes[f"{key} ({b['G']} blocks)"] = (key, name, b)
        torch.cuda.synchronize()
        require(counts == launches[name],
                f"{name}: launches {launches[name]} != batches {counts}")
        require(max(perr.values()) == 0, f"{name}: a wrapper differs from plain: {perr}")
        path_errs[name] = perr
        for key, v in perr.items():
            errs[key] = max(errs[key], v)
    del plain_of
    # entry-modes no path launches (the JAX package runs them only in its
    # tests) are timed at the shapes of the path named
    timing_only = {
        "rans_encode:byte": ("byte_p80_64MiB", lambda: encode_batches(
            Piece("turbo", main_data, GROUP, byte), "rans_encode")),
        "rans_encode2_flat:u16x": ("u16x_pareto_16MiB", lambda: encode_batches(
            Piece("turbo16", u16x_syms, GROUP16, dict(steptots=True)),
            "rans_encode2_flat"))}
    for key, (like, make) in timing_only.items():
        if key not in shapes:
            (b,) = make()
            require(b["key"] == key, f"{key}: staged {b['key']}")
            errs[key] = max(errs[key], max_abs_err(b["run"](), b["plain"]()))
            shapes[key] = (f"shapes of {like} (no path launches it)", b)
    require(max(errs.values()) == 0, f"a kernel differs from its plain version: {errs}")
    require(set(shapes) == set(rk.launches), f"kernels never launched: "
            f"{sorted(set(rk.launches) - set(shapes))}")
    require(set(device_ops_checked) == {"resident_p80_64MiB", "resident_mixed_16MiB",
                                        "resident_roundtrip_p80_64MiB"},
            f"device ops checked on {sorted(device_ops_checked)}")
    print(json.dumps({"phase": "path_kernels_vs_plain", "max_abs_err": path_errs,
                      "timed_on": {k: p for k, (p, _b) in shapes.items()},
                      # groups whose hist, norm, flags, mfs, tables and
                      # source words equal their CPU runs and the host prep
                      "device_ops_equal_cpu_and_host_prep": device_ops_checked}),
          flush=True)

    # 6. timings: end to end on the default flags (and the byte wire)
    e2e = {"gpu": gpu, "input_bytes": len(main_data)}
    for name, flags in (("default", {}), ("byte", byte)):
        p = Piece("turbo", main_data, GROUP, flags)
        first = e2e_s[f"{name}_p80_64MiB/0"]
        comp_s, decomp_s = [first[0]], [first[1]]
        for _ in range(2):
            t0 = time.perf_counter()
            b2 = compress(p)
            comp_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            decompress(p, b2, 0)
            decomp_s.append(time.perf_counter() - t0)
        e2e[name] = {"compress_s": comp_s, "decompress_s": decomp_s,
                     "compress_GBps_median": len(main_data) / sorted(comp_s)[1] / GB,
                     "decompress_GBps_median": len(main_data) / sorted(decomp_s)[1] / GB}
    print(json.dumps({"phase": "end_to_end", **e2e}), flush=True)

    # the entry points' own stage seconds (api.stage_seconds), one call each
    api.stage_seconds = {}
    t0 = time.perf_counter()
    b2 = api.turbo_compress_device(main_data, device=DEV)
    c_total = time.perf_counter() - t0
    t0 = time.perf_counter()
    api.turbo_decompress_device(b2, device=DEV)
    d_total = time.perf_counter() - t0
    st, api.stage_seconds = api.stage_seconds, None
    for side, total in (("c", c_total), ("d", d_total)):
        st[f"{side}_rest"] = total - sum(v for k, v in st.items()
                                         if k.startswith(side + "_"))
        st[f"{side}_total"] = total
    print(json.dumps({"phase": "host_breakdown", "gpu": gpu,
                      "path": "default_p80_64MiB", "seconds": st}), flush=True)

    # c_prep with api.prep_group (the native stats, as the JAX package's
    # main path takes them) against the numpy _prep_group every group ran
    # before: three compress calls each, alternating; the frames are equal
    prep_s = {"prep_group": [], "_prep_group": []}
    native_prep = api.prep_group
    for _ in range(3):
        for name, fn in (("prep_group", native_prep), ("_prep_group", api._prep_group)):
            api.prep_group, api.stage_seconds = fn, {}
            blob = api.turbo_compress_device(main_data, device=DEV)
            prep_s[name].append(api.stage_seconds["c_prep"])
            api.prep_group, api.stage_seconds = native_prep, None
            require(blob == b2, f"prep_split: {name}'s frames differ")
    print(json.dumps({"phase": "prep_split", "gpu": gpu, "path": "default_p80_64MiB",
                      "native_built": native_built, "c_prep_s": prep_s,
                      "c_prep_median_s": {k: sorted(v)[1] for k, v in prep_s.items()}}),
          flush=True)

    # the compat codecs end to end on the 64 MiB paths: compress /
    # decompress through the frame layer whole (the blocks, the batch
    # codec, the XXH32 checksum), median of 3 runs (the path's, one more,
    # and one with the codecs' stage seconds on, whose device stages end in
    # a sync); "rest" is the frame layer around the codec, checksum included
    from finitestateentropy_tpu_torch.models import fse_codec as fse_codec_mod
    from finitestateentropy_tpu_torch.utils.xxhash32 import xxh32

    compat_e2e = {"gpu": gpu, "input_bytes": len(main_data)}
    for codec in ("fse", "huf"):
        first = e2e_s[f"{codec}_p80_64MiB/0"]
        comp_s, dec_s, split = [first[0]], [first[1]], {}
        c = codec_of(codec)
        for staged in (False, True):
            fse_codec_mod.stage_seconds = {} if staged else None
            t0 = time.perf_counter()
            b2 = fio.compress_bytes(main_data, codec, COMPAT_BID, c.compress_blocks)
            comp_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fio.decompress_bytes(b2, c.decompress_blocks)
            dec_s.append(time.perf_counter() - t0)
        split, fse_codec_mod.stage_seconds = fse_codec_mod.stage_seconds, None
        for side, total in (("c", comp_s[-1]), ("d", dec_s[-1])):
            split[f"{side}_rest"] = total - sum(v for k, v in split.items()
                                                if k.startswith(side + "_"))
            split[f"{side}_total"] = total
        compat_e2e[codec] = {
            "compress_s": comp_s, "decompress_s": dec_s,
            "compress_GBps_median": len(main_data) / sorted(comp_s)[1] / GB,
            "decompress_GBps_median": len(main_data) / sorted(dec_s)[1] / GB,
            "stage_seconds": split}
    t0 = time.perf_counter()
    xxh32(main_data, 0)
    compat_e2e["checksum_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "compat_end_to_end", **compat_e2e}), flush=True)

    # the resident pipeline's rates: CUDA events around the whole call,
    # median of 3 after a warm-up; and where a compress call's time goes
    def median3(fn) -> tuple[float, list[float]]:
        fn()
        ms = [timed_call(fn)[1] for _ in range(3)]
        return sorted(ms)[1], ms

    xp64 = x64.view(MAIN_MIB, GROUP)
    lens64 = torch.full((MAIN_MIB,), GROUP, dtype=torch.int32, device=DEV)
    timed = {
        "fused_compress": (len(main_data), lambda: da._resident_compress(
            xp64, lens64, GROUP, RES_TLOG, True)),
        "roundtrip": (len(main_data), lambda: da.rans_resident_roundtrip(x64, GROUP)),
        "mixed_roundtrip": (xm.numel(), lambda: bool(da._resident_mixed_rt(
            xm, GROUP, RES_TLOG, coded_m)[0])),
        # the entry points whole: frames on the host, the output on the GPU
        "compress_resident": (len(main_data),
                              lambda: da.rans_compress_resident(x64, GROUP)),
        "decompress_resident": (len(main_data), lambda: da.rans_decompress_resident(
            res_blobs["rows"], device=DEV)),
    }
    rates = {}
    for name, (nbytes, fn) in timed.items():
        ms, runs = median3(fn)
        rates[name] = {"GBps": nbytes / (ms * 1e-3) / GB, "ms": ms, "runs_ms": runs}

    # the fused compress by stage, each stage alone (CUDA events, median of 3)
    counts64 = hist_count_masked(xp64, GROUP, lens64)
    prep64 = da._resident_prep(xp64, lens64, GROUP, RES_TLOG)
    enc_args = (prep64[5], prep64[6], prep64[7], GROUP // 4096, api._hrows_cap(GROUP))
    stage_ms = {
        "hist": median3(lambda: hist_count_masked(xp64, GROUP, lens64))[0],
        "norm": median3(lambda: fse_normalize_batch(counts64, lens64, RES_TLOG))[0],
        "prep (hist, norm, tables, pad and view)": median3(
            lambda: da._resident_prep(xp64, lens64, GROUP, RES_TLOG))[0],
        "encode": median3(lambda: rk.rans_encode2(*enc_args, tlog=RES_TLOG,
                                                  rowloc=True))[0]}

    # where a whole rans_compress_resident call goes: torch.profiler, each
    # stage's host time (its record_function range) and its span on the
    # device's timeline (the range's twin there: first start to last end,
    # gaps included), so the device idles at least 1 - sum(spans) / wall
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    da.rans_compress_resident(x64, GROUP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        da.rans_compress_resident(x64, GROUP)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host_ms = {}
    for e in prof.events():
        if e.name.startswith("resident.") and e.device_type == DeviceType.CPU:
            host_ms[e.name] = host_ms.get(e.name, 0.0) + e.cpu_time_total / 1e3
    span_ms = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key.startswith("resident.")}
    print(json.dumps({"phase": "resident", "gpu": gpu, "input_bytes": len(main_data),
                      "mixed_input_bytes": xm.numel(),
                      "fused_compress_GBps": rates["fused_compress"]["GBps"],
                      "roundtrip_GBps": rates["roundtrip"]["GBps"],
                      "mixed_roundtrip_GBps": rates["mixed_roundtrip"]["GBps"],
                      "rates": rates,
                      "fused_compress_stage_ms": stage_ms,
                      "compress_split": {"call": f"rans_compress_resident, {MAIN_MIB} x 1 MiB",
                                         "wall_ms": wall_ms, "host_ms_by_stage": host_ms,
                                         "device_span_ms_by_stage": span_ms,
                                         "device_idle_share_at_least":
                                             1 - sum(span_ms.values()) / wall_ms}}),
          flush=True)

    step_ns = chain_step_ns()
    # what a step of the function needs: the encoder's state recurrence;
    # the rows decode's table read, state update with its ballot, and stream
    # read (both shared: the window is staged); the flat-rank and v0 decodes
    # the same plus the exchange of the group's counts among the threads
    # that hold it (their former chain, "flat_1024": a table read, the
    # 1024-thread barrier and an L1 stream read, kept beside it)
    rows_chain = 2 * step_ns["smem"] + step_ns["mad_ballot"]
    # the compat chains: one dependent table lookup a step, at best from
    # shared memory (the Huff0 encode has no chain)
    chain = {"lookup": step_ns["smem"], "none": 0.0,
             "encode": step_ns["encode_step"], "rows": rows_chain,
             "flat": rows_chain + step_ns["barrier_512"],
             "v0": rows_chain + step_ns["barrier_256"],
             "flat_1024": step_ns["smem"] + step_ns["barrier_1024"] + step_ns["global_l1"]}
    print(json.dumps({"phase": "chain_probe", "gpu": gpu, "ns_per_step": step_ns,
                      "chain_step_ns": chain}), flush=True)

    rows = []
    for key, row_name, (path, b) in ([(k, k, shapes[k]) for k in rk.launches]  # every entry-mode
                                     + [(k, n, (p, b)) for n, (k, p, b) in extra_shapes.items()]):
        ms = cuda_ms(b["kernel"], 20)
        dev_ms = device_ms(b["kernel"], KERNEL_FN[source_of(key).rsplit("/", 1)[1]], 5)
        # a compat batch's plain version at the path's shapes runs for
        # seconds (a Python step a symbol pair): its one call in step 5
        plain_ms = b["plain_ms"] if "plain_ms" in b else cuda_ms(b["plain"], 1)
        nbytes = b["nbytes"](b["kernel"]())
        old = ({"chain_bound_ms_1024": b["steps"] * chain["flat_1024"] * 1e-6}
               if b["chain"] in ("flat", "v0") else {})
        rows.append({"name": row_name, "route": "cuda", "source": source_of(key),
                     "replaces": replaces(key),
                     "path": path, "launches": launches.get(path, {}).get(key, 0),
                     "launches_by_path": {p: c.get(key, 0) for p, c in launches.items()},
                     "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, b["ops"], b["steps"], chain[b["chain"]], clock_hz),
                     **old, "library_ms": None, "groups": b["G"], "steps": b["steps"],
                     "ns_per_step": ms * 1e6 / b["steps"],
                     "device_ms": sum(dev_ms.values()) if dev_ms else None,
                     "device_ms_by_kernel": dev_ms})
    print(json.dumps({"phase": "kernel_times", "gpu": gpu,
                      "clocks_sm_power_draw": nvidia_smi("clocks.sm,clocks.max.sm,power.draw"),
                      "library": "no single PyTorch call computes rANS, tANS or "
                                 "Huffman coding: library_ms is null"}),
          flush=True)

    print(json.dumps(benchmarks_phase(gpu)), flush=True)

    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
