#!/usr/bin/env python3
"""Chip smoke for finitestateentropy_tpu_torch: the TurboRANS speed-mode wires on one GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, one result line each:
  1. the GPU's name and power limit (nvidia-smi);
  2. build the CUDA sources of finitestateentropy_tpu_torch/csrc (nvcc, one
     process per source, started together);
  3. each kernel in each wire mode (byte, pair, quad) against its plain
     PyTorch version on the GPU, bit for bit, on 3 x 1 MiB groups: the
     encode, and the decode through rans_decode_v2 and rans_decode_w with
     one group corrupted (its err must be set, the others' not);
  4. six paths through turbo_compress_device / turbo_decompress_device, each
     with the launch counts set to 0 just before it and read just after:
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
                          small groups.
     Every round trip gives back its input and every frame equals the
     port's numpy twin of the wire its group was coded on (quad_compress,
     pair_compress or rans_compress);
  5. every batch of each path, planned and staged as the entry points do
     it, through the wrappers on the GPU against the plain versions (err
     included); the batches per entry and mode equal the path's launches;
  6. end-to-end GB/s of the default-flag path (and of the byte wire), the
     entry points' own stage seconds on the default-flag path, per-step
     chain latencies (csrc/chain_probe.cu) and per-kernel-and-mode times
     (CUDA events) at the shapes of the path each launches on, beside the
     GPU's name and power limit.
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

import numpy as np
import torch

GB = 1e9
GROUP = 1 << 20                # the entry points' default group size
MAIN_MIB = 64                  # the default-flag and byte-wire main paths
PAIR_MIB = 8                   # the quad=0 (pair) path
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES = 132 * 64         # H100 SXM: 132 SMs x 64 INT32 units (Hopper white paper)
# 32-bit integer operations one lane-step of the rANS math needs, whatever
# the design.  Encode: symbol extract 2 (byte p or pair id p: shift, mask;
# quad: mask 1), two table reads 2, freq and cumul fields 3, renorm
# threshold 2, emit and conditional shift 2, mulhi and multiply-subtract 2,
# two corrections 6, new state 3, rank among the flagged lanes (ballot,
# mask, popc) 3.  Byte decode: slot 1, table read 1, symbol into the output
# word 2, freq and cumul fields 3, state multiply-add and correction 4,
# renorm test 1, rank (ballot, mask, popc, row offset) 4, stream index 1,
# stream read 1, state refill 2.  Pair / quad decode: slot 1, table read 1,
# id, freq and j fields 4, LUT read 1, state multiply-add 2, renorm test 1,
# rank 4, stream index 1, stream read 1, state refill 2, and for pair the
# value into the output word 2 (a quad value is the word).
ENC_OPS_PER_STEP = {"byte": 25, "pair": 25, "quad": 24}
DEC_OPS_PER_STEP = {"byte": 20, "pair": 20, "quad": 18}
TLOG = 10                      # the speed-mode tableLog (RANS_SPEED_TABLELOG)
SOURCES = {"rans_encode2": "rans_encode.cu", "rans_decode_v2": "rans_decode.cu",
           "rans_decode_w": "rans_decode.cu"}
REPLACES = {"rans_encode2": "607", "rans_decode_v2": "1019", "rans_decode_w": "1322"}


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


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def frames_of(blob: bytes) -> list[bytes]:
    from finitestateentropy_tpu_torch.turbo.rans import parse_rans_group

    out, pos = [], 0
    while pos < len(blob):
        _g, used = parse_rans_group(blob[pos:])
        out.append(blob[pos:pos + used])
        pos += used
    return out


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


def chain_step_ns() -> dict:
    """ns per dependent step of each kind csrc/chain_probe.cu measures, on
    one block: shared-memory load, global load hitting L1, global load
    hitting L2, and a barrier with a shared exchange at 128 and 1024
    threads."""
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
             "global_l2": (2, l2, 128), "barrier_128": (3, l1, 128),
             "barrier_1024": (3, l1, 1024)}
    res = {}
    for name, (mode, buf, threads) in cases.items():
        def run(mode=mode, buf=buf, threads=threads):
            rc = fn(mode, buf.data_ptr(), buf.numel(), steps, threads,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            require(rc == 0, f"chain_probe launch failed (cudaError_t {rc})")
        res[name] = cuda_ms(run, 3) * 1e6 / steps
    return res


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from finitestateentropy_tpu_torch.turbo import api
    from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
    from finitestateentropy_tpu_torch.turbo._build import build_all
    from finitestateentropy_tpu_torch.turbo.pair import pair_compress
    from finitestateentropy_tpu_torch.turbo.quad import quad_compress
    from finitestateentropy_tpu_torch.turbo.rans import rans_compress
    from finitestateentropy_tpu_torch.turbo.state import to_tensors
    from finitestateentropy_tpu_torch.utils import generate_proba

    group = GROUP
    modes_of = {"byte": {}, "pair": dict(u16=True, pair=True),
                "quad": dict(quad=True)}

    def compress(data, gs=group, **flags):
        return api.turbo_compress_device(data, gs, device=DEV, **flags)

    def decompress(blob):
        return api.turbo_decompress_device(blob, device=DEV)

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

    def encode_batches(data, gs, **flags):
        """[(wire, wrapper args, mode flags)] of every encode batch, planned
        and staged as turbo_compress_device does it."""
        _n, _frames, batches = api.plan_encode(data, gs, TLOG, **flags)
        out = []
        for (wire, n_pad, tlog), items in batches.items():
            fc, mg, srcw = api.STAGE_BATCH[wire](items, n_pad)
            ins = to_tensors(DEV, fc_tables=fc, magic_tables=mg, src_words=srcw)
            out.append((wire, (ins["fc_tables"], ins["magic_tables"],
                               ins["src_words"], api._wire_t4(wire, n_pad),
                               api._hrows_cap(n_pad), tlog),
                        dict(u16=wire == "pair", quad=wire == "quad")))
        return out

    def decode_batches(blob, windows=0):
        """[(entry, wire, wrapper args, tlog, (nway, S))] of every decode
        batch, as turbo_decompress_device routes it."""
        groups = api.parse_groups(blob)
        out = []
        for (wire, n_pad, tlog), idxs in api.plan_decode(groups)[1].items():
            cs, tbl, init, hws, tots, t4, hrows = api.stage_decode_batch(
                groups, idxs, n_pad, tlog, wire)
            ins = to_tensors(DEV, csize_hw=cs, tables=tbl, init_states=init,
                             streams=hws, steptots=tots)
            args = (ins["csize_hw"], ins["tables"], ins["init_states"],
                    ins["streams"], ins["steptots"], t4, hrows)
            w = api._window_dispatch(windows, t4, hrows, tlog, len(idxs),
                                     wire == "pair", wire == "quad")
            out.append(("rans_decode_w" if w[0] else "rans_decode_v2", wire,
                        args, tlog, w))
        return out

    def run_decode(entry, wire, args, tlog, w):
        if entry == "rans_decode_w":
            return rk.rans_decode_w(*args, w[0], tlog, w[1], **modes_of[wire])
        return rk.rans_decode_v2(*args, tlog, **modes_of[wire])

    # 3. each kernel and mode against its plain version, a group corrupted
    corpus = generate_proba(80, max(MAIN_MIB, PAIR_MIB) * group)
    errs = dict.fromkeys(rk.launches, 0)
    flags_of = {"byte": dict(pair=0, quad=0), "pair": dict(quad=0), "quad": {}}
    for wire, flags in flags_of.items():
        three = corpus[:3 * group]
        (w_, enc, mflags), = encode_batches(three, group, **flags)
        require(w_ == wire, f"3 x 1 MiB at {flags} coded {w_}, not {wire}")
        got, want = rk.rans_encode2(*enc, **mflags), rk.rans_encode2_plain(*enc, **mflags)
        torch.cuda.synchronize()
        errs[f"rans_encode2:{wire}"] = max_abs_err(got, want)
        (_e, w2, args, tlog, _w), = decode_batches(compress(three, **flags), windows=1)
        args[3][1].view(-1)[int(args[0][1]) // 4] ^= 1 << 9   # corrupt group 1
        want = rk.rans_decode_plain(*args, tlog, **modes_of[wire])
        for entry, win in (("rans_decode_v2", (0, 0)),
                           ("rans_decode_w", (8, 128 // rk.SPC[wire]))):
            got = run_decode(entry, wire, args, tlog, win)
            torch.cuda.synchronize()
            errs[f"{entry}:{wire}"] = max_abs_err(got, want)
            require(got[1].tolist() == [0, 1, 0],
                    f"{entry}:{wire}: corrupt group not flagged: {got[1].tolist()}")
    require(max(errs.values()) == 0, f"a kernel differs from its plain version: {errs}")
    print(json.dumps({"phase": "kernel_vs_plain", "max_abs_err": errs,
                      "corrupt_group_err": [0, 1, 0]}), flush=True)

    # 4. the paths through the entry points, each counted on its own
    rng = np.random.default_rng(5)
    mixed = (generate_proba(80)[:20000] + b"R" * 9000
             + bytes(rng.integers(0, 256, 12000, dtype=np.uint8))
             + generate_proba(14)[:5000])
    small64 = (generate_proba(90, 1 << 16) + pair_escape_corpus(1 << 16)
               + quad_escape_corpus(1 << 16) + generate_proba(14, 1 << 16))
    byte = dict(pair=0, quad=0)
    # each kernel and mode is timed at the first path that launches it, so
    # the byte wire's 64 MiB and 3 MiB paths come before the mixed ones
    paths = {"default_p80_64MiB": [(corpus[:MAIN_MIB * group], group, {})],
             "quad0_p80_8MiB": [(corpus[:PAIR_MIB * group], group, dict(quad=0))],
             "byte_p80_64MiB": [(corpus[:MAIN_MIB * group], group, byte)],
             "byte_p80_3MiB": [(generate_proba(80, 3 * group), group, byte)],
             "default_mixed": [(mixed, 9000, {}), (small64, 1 << 16, {})],
             "byte_mixed_9000": [(mixed, 9000, byte)]}
    decompress(compress(corpus[:group]))             # warm-up
    blobs, launches, e2e_s = {}, {}, {}
    for name, pieces in paths.items():
        rk.reset_launches()
        torch.cuda.synchronize()
        for k, (data, gs, flags) in enumerate(pieces):
            t0 = time.perf_counter()
            blob = compress(data, gs, **flags)
            t_c = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = decompress(blob)
            t_d = time.perf_counter() - t0
            require(back == data, f"{name}: round trip of piece {k}")
            blobs[(name, k)], e2e_s[(name, k)] = blob, (t_c, t_d)
        launches[name] = {k: v for k, v in rk.launches.items() if v}
    print(json.dumps({"phase": "main_path", "launches": launches}), flush=True)
    expect = {"default_p80_64MiB": {"rans_encode2:quad": 1, "rans_decode_w:quad": 1},
              "quad0_p80_8MiB": {"rans_encode2:pair": 1, "rans_decode_w:pair": 1},
              "byte_p80_64MiB": {"rans_encode2:byte": 1, "rans_decode_w:byte": 1},
              "byte_p80_3MiB": {"rans_encode2:byte": 1, "rans_decode_v2:byte": 1}}
    for name, want in expect.items():
        require(launches[name] == want, f"{name} routes: {launches[name]}")
    for name, need in (("default_mixed", ("pair", "quad", "byte")),
                       ("byte_mixed_9000", ("byte",))):
        got = launches[name]
        require(all(got.get(f"{e}:{w}", 0) >= 1 for w in need
                    for e in ("rans_encode2", "rans_decode_v2"))
                and not any(k.startswith("rans_decode_w") for k in got),
                f"{name} routes: {got}")

    # every frame equals the twin of the wire its group was coded on
    twins = {"quad": quad_compress, "pair": pair_compress, "byte": rans_compress}
    n_frames, wires_seen = 0, {}
    for name, pieces in paths.items():
        for k, (data, gs, flags) in enumerate(pieces):
            frames = frames_of(blobs[(name, k)])
            require(len(frames) == -(-len(data) // gs), f"{name}: group count")
            _n, _f, batches = api.plan_encode(data, gs, TLOG, **flags)
            wire_of = {gi: wire for (wire, _p, _t), items in batches.items()
                       for gi, _ch, _prep in items}
            for i, f in enumerate(frames):
                ch = data[i * gs:(i + 1) * gs]
                wire = wire_of.get(i, "byte")       # RLE / raw: the byte twin's
                want = twins[wire](ch)
                require(f == (rans_compress(ch) if want is None else want),
                        f"{name}: frame {i} differs from the {wire} twin")
                wires_seen.setdefault(name, []).append(wire)
            n_frames += len(frames)
    require(set(wires_seen["default_p80_64MiB"]) == {"quad"}, "main path not all quad")
    require(set(wires_seen["quad0_p80_8MiB"]) == {"pair"}, "quad=0 path not all pair")
    ratio = {p: len(paths[p][0][0]) / len(blobs[(p, 0)])
             for p in ("default_p80_64MiB", "quad0_p80_8MiB", "byte_p80_64MiB")}
    print(json.dumps({"phase": "frames_vs_twin", "frames": n_frames,
                      "wires": {p: sorted(set(w)) for p, w in wires_seen.items()},
                      "ratio_p80": ratio}), flush=True)

    # 5. every batch of every path: the wrappers against the plain versions
    shapes, path_errs = {}, {}
    for name, pieces in paths.items():
        perr, batches = {}, {}
        for k, (data, gs, flags) in enumerate(pieces):
            for wire, args, mflags in encode_batches(data, gs, **flags):
                key = f"rans_encode2:{wire}"
                perr[key] = max(perr.get(key, 0), max_abs_err(
                    rk.rans_encode2(*args, **mflags),
                    rk.rans_encode2_plain(*args, **mflags)))
                batches[key] = batches.get(key, 0) + 1
                shapes.setdefault(key, (name, args))
            for entry, wire, args, tlog, w in decode_batches(blobs[(name, k)]):
                key = f"{entry}:{wire}"
                got = run_decode(entry, wire, args, tlog, w)
                want = rk.rans_decode_plain(*args, tlog, **modes_of[wire])
                require(not want[1].any(), f"{name}: plain decode flags a clean group")
                perr[key] = max(perr.get(key, 0), max_abs_err(got, want))
                batches[key] = batches.get(key, 0) + 1
                shapes.setdefault(key, (name, (args, tlog)))
        torch.cuda.synchronize()
        require(batches == launches[name],
                f"{name}: launches {launches[name]} != batches {batches}")
        require(max(perr.values()) == 0, f"{name}: a wrapper differs from plain: {perr}")
        path_errs[name] = perr
        for key, v in perr.items():
            errs[key] = max(errs[key], v)
    require(set(shapes) == set(rk.launches), f"kernels never launched: "
            f"{sorted(set(rk.launches) - set(shapes))}")
    print(json.dumps({"phase": "path_kernels_vs_plain", "max_abs_err": path_errs,
                      "timed_on": {k: p for k, (p, _a) in shapes.items()}}),
          flush=True)

    # 6. timings: end to end on the default flags (and the byte wire)
    main = corpus[:MAIN_MIB * group]
    e2e = {"gpu": gpu, "input_bytes": len(main)}
    for name, flags in (("default", {}), ("byte", byte)):
        first = e2e_s[(f"{name}_p80_64MiB", 0)]
        comp_s, decomp_s = [first[0]], [first[1]]
        for _ in range(2):
            t0 = time.perf_counter()
            b2 = compress(main, **flags)
            comp_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            decompress(b2)
            decomp_s.append(time.perf_counter() - t0)
        e2e[name] = {"compress_s": comp_s, "decompress_s": decomp_s,
                     "compress_GBps_median": len(main) / sorted(comp_s)[1] / GB,
                     "decompress_GBps_median": len(main) / sorted(decomp_s)[1] / GB}
    print(json.dumps({"phase": "end_to_end", **e2e}), flush=True)

    # the entry points' own stage seconds (api.stage_seconds), one call each
    api.stage_seconds = {}
    t0 = time.perf_counter()
    b2 = compress(main)
    c_total = time.perf_counter() - t0
    t0 = time.perf_counter()
    decompress(b2)
    d_total = time.perf_counter() - t0
    st, api.stage_seconds = api.stage_seconds, None
    for side, total in (("c", c_total), ("d", d_total)):
        st[f"{side}_rest"] = total - sum(v for k, v in st.items()
                                         if k.startswith(side + "_"))
        st[f"{side}_total"] = total
    print(json.dumps({"phase": "host_breakdown", "gpu": gpu,
                      "path": "default_p80_64MiB", "seconds": st}), flush=True)

    step_ns = chain_step_ns()
    chain = {"rans_encode2": step_ns["barrier_1024"],
             "rans_decode": step_ns["smem"] + step_ns["barrier_128"]
             + step_ns["global_l1"]}
    print(json.dumps({"phase": "chain_probe", "gpu": gpu, "ns_per_step": step_ns,
                      "chain_step_ns": chain}), flush=True)

    rows = []
    for key in rk.launches:                    # every entry, every mode
        entry, wire = key.split(":")
        path, a = shapes[key]
        spc = rk.SPC[wire]
        if entry == "rans_encode2":
            G, t4, tlog = a[0].shape[0], a[3], a[5]
            mflags = dict(u16=wire == "pair", quad=wire == "quad")
            ms = cuda_ms(lambda: rk._encode_kernel(*a, wire), 5)
            plain_ms = cuda_ms(lambda: rk.rans_encode2_plain(*a, **mflags), 1)
            csize = rk._encode_kernel(*a, wire)[2]
            nbytes = (G * t4 * 4096 + G * 2 * 2 * 128 * 4
                      + 2 * int(csize.long().sum()) + G * 4096 + G * 4
                      + G * spc * t4 * 8 * 4)
            ops = ENC_OPS_PER_STEP[wire] * G * spc * t4 * 1024
            step = chain["rans_encode2"]
        else:
            args, tlog = a
            cs, tbl, ini, strm, tots, t4, _hrows = args
            cursors, roff, _bad = rk._decode_prep(cs, tots)
            G = tbl.shape[0]
            ms = cuda_ms(lambda: rk._decode_kernel(tbl, ini, strm, cursors, roff,
                                                   t4, tlog, wire), 5)
            plain_ms = cuda_ms(lambda: rk.rans_decode_plain(
                *args, tlog, **modes_of[wire]), 1)
            nbytes = (2 * int(cs.long().sum()) + tbl.numel() * 4 + G * 4096
                      + tots.numel() * 4 + G * 4 + G * t4 * 4096 + G * 4)
            ops = DEC_OPS_PER_STEP[wire] * G * spc * t4 * 1024
            step = chain["rans_decode"]
        rows.append({"name": key, "route": "cuda",
                     "source": "finitestateentropy_tpu_torch/csrc/" + SOURCES[entry],
                     "replaces": "finitestateentropy_tpu/turbo/rans_kernels.py:"
                                 + REPLACES[entry],
                     "path": path, "launches": launches[path].get(key, 0),
                     "launches_by_path": {p: c.get(key, 0) for p, c in launches.items()},
                     "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, ops, spc * t4, step, clock_hz),
                     "library_ms": None, "groups": G, "steps": spc * t4,
                     "ns_per_step": ms * 1e6 / (spc * t4)})
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
