#!/usr/bin/env python3
"""Chip smoke for finitestateentropy_tpu_torch: the TurboRANS codecs on one GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, one result line each:
  1. the GPU's name and power limit (nvidia-smi);
  2. build the CUDA sources of finitestateentropy_tpu_torch/csrc (nvcc, one
     process per source, started together);
  3. every kernel entry in every mode against its plain PyTorch version on
     the GPU, bit for bit, on 3-group batches (1 MiB groups; 512 Ki-symbol
     U16 groups): the encodes (rans_encode2 byte / pair / quad in the
     row-local placement, rans_encode2_flat byte with and without step
     counts, u16 and u16x in the flat placement, rans_encode byte / u16 /
     u16x), and each decode entry (rans_decode_v2 and rans_decode_w on the
     rows and totals wires, rans_decode on v1 frames, turbo_fse_decode on
     v0 frames) with group 1 corrupted (its err must be set, the others'
     not);
  4. sixteen paths, each with the launch counts set to 0 just before it
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
     and four more:
       mesh_u16_pareto    sharded_turbo16_roundtrip over the mesh on the u16
                          path's 64 groups: the flat u16 encode and v2:u16;
       dryrun_multichip   parallel/dryrun.py over the mesh's devices: every
                          sharded round trip on 8-128 KiB groups, and a
                          mixed frame through the entry points with mesh set;
       v0_p80_16MiB       the v0 TurboFSE codec: 16 x 1 MiB of Proba80
                          compressed by the numpy twin on the host, then one
                          turbo_fse_decode launch, which must give the input
                          back, as must turbo_fse_decompress.
     Every round trip gives back its input and every frame equals the
     port's numpy twin of the wire and mode its group was coded in
     (quad_compress, pair_compress, rans_compress, rans16_compress);
  5. every batch of each path, planned and staged as the entry points do
     it (the dry run's on its own inputs and shapes), through the wrappers
     on the GPU against the plain versions (err included); the batches per
     entry and mode (times the shards of the mesh each runs on) equal the
     path's launches, and every entry and mode is launched by
     some path but two, which no path of the JAX package runs either
     (rans_encode:byte, rans_encode2_flat:u16x): those are checked at the
     shapes of the byte and u16x paths;
  6. end-to-end GB/s of the default-flag path (and of the byte wire), the
     entry points' own stage seconds on the default-flag path, per-step
     chain latencies (csrc/chain_probe.cu) and per-kernel-and-mode times
     at the shapes of the first path that launches each: the wrapper's
     launch call (CUDA events, mean of 20 calls, allocations included) and
     each CUDA kernel's own device time (torch.profiler), beside the GPU's
     name and power limit; the flat-rank and v0 rows carry the chain bound
     of their former design, a 1024-thread block a group
     (chain_bound_ms_1024), beside their own.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure exits nonzero with no ok line,
as does a machine without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from functools import partial

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
FLAT_THREADS = 512             # a group's block in csrc/rans_decode_flat.cu
V0_THREADS = 256               # and in csrc/turbo_fse_decode.cu
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
             "turbo_fse_decode.cu": "turbo_fse_decode"}


def source_of(key: str) -> str:
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
    each sharded round trip (the windowed one runs on min(m, 2) devices);
    then the mixed frame, whose two coded 16 KiB groups of Proba80 go pair
    at default flags: a pair encode per shard for the mesh compress (mesh=1
    is single-device: one), one for the single-device compress, and a pair
    decode per shard."""
    return {"rans_encode2_flat:byte": 2 * m, "rans_decode:byte": m,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from finitestateentropy_tpu_torch.parallel import dryrun as dr
    from finitestateentropy_tpu_torch.parallel.mesh import make_mesh
    from finitestateentropy_tpu_torch.parallel.turbo_dp import sharded_turbo16_roundtrip
    from finitestateentropy_tpu_torch.turbo import api
    from finitestateentropy_tpu_torch.turbo import kernels as v0
    from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
    from finitestateentropy_tpu_torch.turbo._build import build_all
    from finitestateentropy_tpu_torch.turbo.format import (parse_group,
                                                           turbo_fse_compress,
                                                           turbo_fse_decompress)
    from finitestateentropy_tpu_torch.turbo.pair import pair_compress
    from finitestateentropy_tpu_torch.turbo.quad import quad_compress
    from finitestateentropy_tpu_torch.turbo.rans import rans_compress
    from finitestateentropy_tpu_torch.turbo.rans16 import rans16_compress
    from finitestateentropy_tpu_torch.turbo.state import to_tensors
    from finitestateentropy_tpu_torch.turbo.tables import pack_rans16_dtable
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
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "built": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                                for k, v in built.items()}}), flush=True)

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
                             run=partial(rk.rans_encode, *v1),
                             plain=partial(rk.rans_encode_plain, *v1),
                             kernel=partial(rk._encode_kernel, *args, wire, False, st))
                else:
                    rowloc, est = api.encode_placement(wire, st, mesh)
                    mf = dict(u16=wire == "pair", quad=wire == "quad", steptots=est)
                    b.update(key=f"rans_encode2{'' if rowloc else '_flat'}:{wire}",
                             stots=est,
                             run=partial(rk.rans_encode2, *args, **mf, rowloc=rowloc),
                             plain=partial(rk.rans_encode2_plain, *args, **mf),
                             kernel=partial(rk._encode_kernel, *args, wire, True, est))
                out.append(b)
        else:
            _n, _f, batches = api.plan_encode16(p.data, p.group, st)
            packed = entry == "rans_encode2_flat"
            for (n_pad, big, tlog), items in batches.items():
                fc, mg, srcw = api.stage_encode16_batch(items, n_pad, big)
                ins = to_tensors(DEV, fc_tables=fc, magic_tables=mg, src_words=srcw)
                t2, hcap = n_pad // 2048, api._round8(n_pad // 128 + 16)
                mode = "u16x" if big else "u16"
                args = (*ins.values(), t2, hcap)
                if packed:
                    run = partial(rk.rans_encode2, *args, tlog, u16=True, steptots=st)
                    plain = partial(rk.rans_encode2_plain, *args, tlog, u16=True,
                                    steptots=st)
                else:
                    run = partial(rk.rans_encode, *args, True, tlog, st)
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
            groups = api.parse_groups16(blob)
            for (n_pad, tlog, tots, big), idxs in api.plan_decode16(groups)[1].items():
                arrays = api.stage_decode16_batch(groups, idxs, n_pad, tlog, tots, big)
                staged.append((arrays, tlog, 2 if tots else 0,
                               "u16x" if big else "u16", dict(u16=True, u16x=big)))
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
                    run = partial(rk.rans_decode_v2, *common, st, t4, hrows, tlog,
                                  **flags)
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
    fc16, mg16, src16 = api.stage_encode16_batch(items16, n16, big16)
    dtbl16 = np.stack([pack_rans16_dtable(it[2][0], tlog16) for it in items16])
    t2, hcap16 = n16 // 2048, api._round8(n16 // 128 + 16)
    rk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, total = sharded_turbo16_roundtrip(mesh, t2, hcap16, tlog16)(
        fc16, mg16, src16, dtbl16)
    ok, total = int(ok), int(total)
    e2e_s["mesh_u16_pareto/0"] = [time.perf_counter() - t0]
    launches["mesh_u16_pareto"] = {k: v for k, v in rk.launches.items() if v}
    single16 = sum(g[1] for g in api.parse_groups16(blobs[("u16_pareto_64MiB", 0)]))
    require(ok == 1 and total == single16,
            f"mesh u16 round trip: ok {ok}, {total} halfwords, single-device {single16}")
    u16_speed = Piece("turbo16", u16_syms, GROUP16, dict(steptots=True))
    path_batches = {"mesh_u16_pareto": lambda: [dict(b, shards=m) for b in (
        encode_batches(u16_speed, "rans_encode2_flat")
        + decode_batches(u16_speed, blobs[("u16_pareto_64MiB", 0)], 1))]}

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
        out = []
        for (*arrays, steps, hcap, tlog), ef, entry, df, shards in trips:
            fc, mg, srcw, dtbl = (torch.from_numpy(a).to(DEV) for a in arrays)
            rowloc = ef.pop("rowloc", False)
            args = (fc, mg, srcw, steps, hcap, tlog)
            enc = rk.rans_encode2_plain(*args, **ef)
            mode = rk._encode_mode(fc, mg, srcw, steps, ef.get("u16", False),
                                   ef.get("quad", False))
            out.append(dict(key=f"rans_encode2{'' if rowloc else '_flat'}:{mode}",
                            shards=shards, plain=lambda enc=enc: enc,
                            run=partial(rk.rans_encode2, *args, **ef, rowloc=rowloc)))
            stream, fin, csize, stots = enc
            nway, S = df.pop("nway", 0), df.pop("S", 0)
            if entry == "rans_decode":
                dargs = (csize, dtbl, fin, stream, steps, hcap)
                run = partial(rk.rans_decode, *dargs, tlog=tlog)
                plain = partial(rk.rans_decode_v1_plain, *dargs, tlog=tlog)
            else:
                dargs = (csize, dtbl, fin, stream, stots, steps, hcap)
                run = (partial(rk.rans_decode_w, *dargs, nway, tlog, S, **df) if nway
                       else partial(rk.rans_decode_v2, *dargs, tlog, **df))
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
        "v0_p80_16MiB": {"turbo_fse_decode:v0": 1}}
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

    n_frames, wires_seen = 0, {}
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

    shapes, path_errs = {}, {}
    for name in [*paths, *path_batches]:
        perr, counts = {}, {}
        for b in batches_of(name):
            key = b["key"]
            got, want = b["run"](), b["plain"]()
            if not key.startswith("rans_encode"):
                require(not want[1].any(), f"{name}: plain decode flags a clean group")
            perr[key] = max(perr.get(key, 0), max_abs_err(got, want))
            counts[key] = counts.get(key, 0) + b.get("shards", 1)
            if "kernel" in b:                   # timed at the first path's shapes
                shapes.setdefault(key, (name, b))
        torch.cuda.synchronize()
        require(counts == launches[name],
                f"{name}: launches {launches[name]} != batches {counts}")
        require(max(perr.values()) == 0, f"{name}: a wrapper differs from plain: {perr}")
        path_errs[name] = perr
        for key, v in perr.items():
            errs[key] = max(errs[key], v)
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
    print(json.dumps({"phase": "path_kernels_vs_plain", "max_abs_err": path_errs,
                      "timed_on": {k: p for k, (p, _b) in shapes.items()}}),
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

    step_ns = chain_step_ns()
    # what a step of the function needs: the encoder's state recurrence;
    # the rows decode's table read, state update with its ballot, and stream
    # read (both shared: the window is staged); the flat-rank and v0 decodes
    # the same plus the exchange of the group's counts among the threads
    # that hold it (their former chain, "flat_1024": a table read, the
    # 1024-thread barrier and an L1 stream read, kept beside it)
    rows_chain = 2 * step_ns["smem"] + step_ns["mad_ballot"]
    chain = {"encode": step_ns["encode_step"], "rows": rows_chain,
             "flat": rows_chain + step_ns["barrier_512"],
             "v0": rows_chain + step_ns["barrier_256"],
             "flat_1024": step_ns["smem"] + step_ns["barrier_1024"] + step_ns["global_l1"]}
    print(json.dumps({"phase": "chain_probe", "gpu": gpu, "ns_per_step": step_ns,
                      "chain_step_ns": chain}), flush=True)

    rows = []
    for key in rk.launches:                    # every entry, every mode
        path, b = shapes[key]
        ms = cuda_ms(b["kernel"], 20)
        dev_ms = device_ms(b["kernel"], KERNEL_FN[source_of(key).rsplit("/", 1)[1]], 5)
        plain_ms = cuda_ms(b["plain"], 1)
        nbytes = b["nbytes"](b["kernel"]())
        old = ({"chain_bound_ms_1024": b["steps"] * chain["flat_1024"] * 1e-6}
               if b["chain"] in ("flat", "v0") else {})
        rows.append({"name": key, "route": "cuda", "source": source_of(key),
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
                      "library": "no single PyTorch call computes rANS: library_ms is null"}),
          flush=True)

    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
