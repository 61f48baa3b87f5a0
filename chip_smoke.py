#!/usr/bin/env python3
"""Chip smoke for finitestateentropy_tpu_torch: the TurboRANS byte wire on one GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, one result line each:
  1. the GPU's name and power limit (nvidia-smi);
  2. build the CUDA sources of finitestateentropy_tpu_torch/csrc (nvcc, one
     process per source, started together);
  3. hold each kernel against its plain PyTorch version on the GPU, bit for
     bit: encode on 3 x 1 MiB Proba80 + 1 MiB Proba14 + 1 MiB Proba02, the
     decode through rans_decode_v2 on 3 groups (one corrupted: its err must
     be set) and through rans_decode_w on 8 groups;
  4. three paths through turbo_compress_device / turbo_decompress_device
     (pair=0, quad=0), each with the launch counts set to 0 just before it
     and read just after: 64 MiB of Proba80 in 1 MiB groups (the main path:
     one encode and one rans_decode_w launch), 3 MiB of Proba80 (one encode,
     one rans_decode_v2) and a mixed RLE/raw/Proba14 input at 9000-byte
     groups (rans_decode_v2 on small padded groups).  Every round trip gives
     back its input and every frame equals the numpy twin rans_compress;
  5. every batch of each path, planned and staged as the entry points do
     it, through the wrappers on the GPU against the plain versions (err
     included);
  6. end-to-end GB/s, the entry points' own stage seconds, per-step chain
     latencies (csrc/chain_probe.cu) and per-kernel times (CUDA events) at
     the main-path shapes, beside the GPU's name and power limit.
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
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES = 132 * 64         # H100 SXM: 132 SMs x 64 INT32 units (Hopper white paper)
# 32-bit integer operations one lane-step of the rANS math needs, whatever
# the design.  Encode: byte extract 2, two table reads 2, freq and cumul
# fields 3, renorm threshold 2, emit and conditional shift 2, mulhi and
# multiply-subtract 2, two corrections 6, new state 3, rank among the
# flagged lanes (ballot, mask, popc) 3.  Decode: slot 1, table read 1,
# symbol into the output word 2, freq and cumul fields 3, state
# multiply-add and correction 4, renorm test 1, rank (ballot, mask, popc,
# row offset) 4, stream index 1, stream read 1, state refill 2.
ENC_OPS_PER_STEP = 25
DEC_OPS_PER_STEP = 20
TLOG = 10                      # the speed-mode tableLog (RANS_SPEED_TABLELOG)


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
    from finitestateentropy_tpu_torch.turbo.format import _pad_n
    from finitestateentropy_tpu_torch.turbo.rans import (parse_rans_group,
                                                         rans_compress)
    from finitestateentropy_tpu_torch.turbo.state import to_tensors
    from finitestateentropy_tpu_torch.utils import generate_proba

    group = GROUP

    def compress(data, gs=group):
        return api.turbo_compress_device(data, gs, pair=0, quad=0, device=DEV)

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

    def encode_args(items, n_pad):
        fc, mg, srcw = api.stage_encode_batch(items, n_pad)
        ins = to_tensors(DEV, fc_tables=fc, magic_tables=mg, src_words=srcw)
        return (ins["fc_tables"], ins["magic_tables"], ins["src_words"],
                n_pad // 4096, api._hrows_cap(n_pad), TLOG)

    def decode_args(groups, idxs, n_pad, tlog):
        cs, tbl, init, hws, tots, t4, hrows = api.stage_decode_batch(
            groups, idxs, n_pad, tlog)
        ins = to_tensors(DEV, csize_hw=cs, tables=tbl, init_states=init,
                         streams=hws, steptots=tots)
        return (ins["csize_hw"], ins["tables"], ins["init_states"],
                ins["streams"], ins["steptots"], t4, hrows)

    # 3. each kernel against its plain version, on the card
    corpus = generate_proba(80, 64 * group)
    src = np.frombuffer(corpus, np.uint8)
    cmp_chunks = [src[i * group:(i + 1) * group] for i in range(3)] + [
        np.frombuffer(generate_proba(p, group), np.uint8) for p in (14, 2)]
    enc_args = encode_args([(i, ch, api._prep_group(ch, TLOG))
                            for i, ch in enumerate(cmp_chunks)], _pad_n(group))
    got = rk.rans_encode2(*enc_args)
    want = rk.rans_encode2_plain(*enc_args)
    torch.cuda.synchronize()
    errs = {"rans_encode2": max_abs_err(got, want)}
    require(errs["rans_encode2"] == 0, "encode kernel differs from its plain version")

    groups3 = [parse_rans_group(rans_compress(bytes(c)))[0] for c in cmp_chunks[:3]]
    dec3 = decode_args(groups3, [0, 1, 2], _pad_n(group), TLOG)
    dec3[3][1].view(-1)[int(dec3[0][1]) // 4] ^= 1 << 9  # corrupt group 1
    got = rk.rans_decode_v2(*dec3, TLOG)
    want = rk.rans_decode_plain(*dec3, TLOG)
    torch.cuda.synchronize()
    errs["rans_decode_v2"] = max_abs_err(got, want)
    require(errs["rans_decode_v2"] == 0, "decode (v2 entry) differs from plain")
    require(got[1].tolist() == [0, 1, 0], f"corrupt group not flagged: {got[1].tolist()}")
    require(got[0][0].cpu().numpy().tobytes() == cmp_chunks[0].tobytes(),
            "v2 entry decode is wrong")

    groups8 = api.parse_groups(compress(corpus[:8 * group]))
    dec8 = decode_args(groups8, list(range(8)), _pad_n(group), TLOG)
    got = rk.rans_decode_w(*dec8, 8, TLOG, 32)
    want = rk.rans_decode_plain(*dec8, TLOG)
    torch.cuda.synchronize()
    errs["rans_decode_w"] = max_abs_err(got, want)
    require(errs["rans_decode_w"] == 0, "decode (w entry) differs from plain")
    require(got[1].tolist() == [0] * 8, "w entry flags a clean group")
    require(got[0].cpu().numpy().tobytes() == corpus[:8 * group], "w entry decode is wrong")
    print(json.dumps({"phase": "kernel_vs_plain", "max_abs_err": errs,
                      "corrupt_group_err": [0, 1, 0]}), flush=True)

    # 4. the paths through the entry points, each counted on its own
    rng = np.random.default_rng(5)
    mixed = (generate_proba(80)[:20000] + b"R" * 9000
             + bytes(rng.integers(0, 256, 12000, dtype=np.uint8))
             + generate_proba(14)[:5000])
    paths = {"p80_64MiB": (corpus, group),
             "p80_3MiB": (generate_proba(80, 3 * group), group),
             "mixed_9000": (mixed, 9000)}
    decompress(compress(corpus[:group]))             # warm-up
    blobs, launches, e2e_s = {}, {}, {}
    for name, (data, gs) in paths.items():
        rk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = compress(data, gs)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = decompress(blob)
        t_d = time.perf_counter() - t0
        launches[name] = dict(rk.launches)
        require(back == data, f"{name}: round trip")
        blobs[name], e2e_s[name] = blob, (t_c, t_d)
    print(json.dumps({"phase": "main_path", "launches": launches}), flush=True)
    require(launches["p80_64MiB"] == {"rans_encode2": 1, "rans_decode_v2": 0,
                                      "rans_decode_w": 1},
            f"64 MiB path routes: {launches['p80_64MiB']}")
    require(launches["p80_3MiB"] == {"rans_encode2": 1, "rans_decode_v2": 1,
                                     "rans_decode_w": 0},
            f"3 MiB path routes: {launches['p80_3MiB']}")
    mix = launches["mixed_9000"]
    require(mix["rans_encode2"] >= 1 and mix["rans_decode_v2"] >= 1
            and mix["rans_decode_w"] == 0, f"mixed path routes: {mix}")
    n_frames = 0
    for name, (data, gs) in paths.items():
        frames = frames_of(blobs[name])
        require(len(frames) == -(-len(data) // gs), f"{name}: group count")
        for i, f in enumerate(frames):
            require(f == rans_compress(data[i * gs:(i + 1) * gs]),
                    f"{name}: frame {i} differs from the numpy twin")
        n_frames += len(frames)
    ratio = len(corpus) / len(blobs["p80_64MiB"])
    print(json.dumps({"phase": "frames_vs_twin", "frames": n_frames,
                      "ratio_p80": ratio}), flush=True)

    # 5. every batch of every path: the wrappers against the plain versions
    shapes, path_errs = {}, {}
    for name, (data, gs) in paths.items():
        perr, batches = dict.fromkeys(rk.launches, 0), dict.fromkeys(rk.launches, 0)
        _n, _frames, enc_batches = api.plan_encode(data, gs, TLOG)
        for n_pad, items in enc_batches.items():
            args = encode_args(items, n_pad)
            perr["rans_encode2"] = max(perr["rans_encode2"], max_abs_err(
                rk.rans_encode2(*args), rk.rans_encode2_plain(*args)))
            batches["rans_encode2"] += 1
            shapes.setdefault(("rans_encode2", name), args)
        groups = api.parse_groups(blobs[name])
        _pieces, dec_batches = api.plan_decode(groups)
        for (n_pad, tlog), idxs in dec_batches.items():
            args = decode_args(groups, idxs, n_pad, tlog)
            nway, S = api._window_dispatch(0, args[5], args[6], tlog, len(idxs))
            entry = "rans_decode_w" if nway else "rans_decode_v2"
            got = (rk.rans_decode_w(*args, nway, tlog, S) if nway
                   else rk.rans_decode_v2(*args, tlog))
            want = rk.rans_decode_plain(*args, tlog)
            require(not want[1].any(), f"{name}: plain decode flags a clean group")
            perr[entry] = max(perr[entry], max_abs_err(got, want))
            batches[entry] += 1
            shapes.setdefault((entry, name), args)
        torch.cuda.synchronize()
        require(batches == launches[name],
                f"{name}: launches {launches[name]} != batches {batches}")
        require(max(perr.values()) == 0, f"{name}: a wrapper differs from plain: {perr}")
        path_errs[name] = perr
        for k, v in perr.items():
            errs[k] = max(errs[k], v)
    print(json.dumps({"phase": "path_kernels_vs_plain", "max_abs_err": path_errs,
                      "shapes": {f"{e}@{p}": list(a[2].shape)
                                 for (e, p), a in shapes.items()}}), flush=True)

    # 6. timings at the main-path shapes
    comp_s, decomp_s = [e2e_s["p80_64MiB"][0]], [e2e_s["p80_64MiB"][1]]
    for _ in range(2):
        t0 = time.perf_counter()
        b2 = compress(corpus)
        comp_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        decompress(b2)
        decomp_s.append(time.perf_counter() - t0)
    e2e = {"gpu": gpu, "input_bytes": len(corpus),
           "compress_s": comp_s, "decompress_s": decomp_s,
           "compress_GBps_median": len(corpus) / sorted(comp_s)[1] / GB,
           "decompress_GBps_median": len(corpus) / sorted(decomp_s)[1] / GB}
    print(json.dumps({"phase": "end_to_end", **e2e}), flush=True)

    # the entry points' own stage seconds (api.stage_seconds), one call each
    api.stage_seconds = {}
    t0 = time.perf_counter()
    b2 = compress(corpus)
    c_total = time.perf_counter() - t0
    t0 = time.perf_counter()
    decompress(b2)
    d_total = time.perf_counter() - t0
    st, api.stage_seconds = api.stage_seconds, None
    for side, total in (("c", c_total), ("d", d_total)):
        st[f"{side}_rest"] = total - sum(v for k, v in st.items()
                                         if k.startswith(side + "_"))
        st[f"{side}_total"] = total
    print(json.dumps({"phase": "host_breakdown", "gpu": gpu, "seconds": st}),
          flush=True)

    step_ns = chain_step_ns()
    chain = {"rans_encode2": step_ns["barrier_1024"],
             "rans_decode": step_ns["smem"] + step_ns["barrier_128"]
             + step_ns["global_l1"]}
    print(json.dumps({"phase": "chain_probe", "gpu": gpu, "ns_per_step": step_ns,
                      "chain_step_ns": chain}), flush=True)

    rows = []

    def record(name, path, ms, plain_ms, nbytes, ops, steps, step):
        rows.append({"name": name, "route": "cuda",
                     "source": "finitestateentropy_tpu_torch/csrc/"
                               + ("rans_encode.cu" if name == "rans_encode2"
                                  else "rans_decode.cu"),
                     "replaces": "finitestateentropy_tpu/turbo/rans_kernels.py:"
                                 + {"rans_encode2": "607", "rans_decode_v2": "1019",
                                    "rans_decode_w": "1322"}[name],
                     "path": path, "launches": launches[path][name],
                     "launches_by_path": {p: c[name] for p, c in launches.items()},
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, ops, steps, step, clock_hz),
                     "library_ms": None, "ns_per_step": ms * 1e6 / steps})

    enc = shapes[("rans_encode2", "p80_64MiB")]
    G, t4 = enc[0].shape[0], enc[3]
    ms = cuda_ms(lambda: rk._encode_kernel(*enc), 5)
    plain_ms = cuda_ms(lambda: rk.rans_encode2_plain(*enc), 1)
    csize = rk._encode_kernel(*enc)[2]
    nbytes = (G * t4 * 4096 + G * 2 * 2 * 128 * 4 + 2 * int(csize.long().sum())
              + G * 4096 + G * 4 + G * 4 * t4 * 8 * 4)
    record("rans_encode2", "p80_64MiB", ms, plain_ms, nbytes,
           ENC_OPS_PER_STEP * G * 4 * t4 * 1024, 4 * t4, chain["rans_encode2"])

    for name, path in (("rans_decode_w", "p80_64MiB"), ("rans_decode_v2", "p80_3MiB")):
        args = shapes[(name, path)]
        cs, tbl, ini, strm, tots, t4d, _hrows = args
        cursors, roff, _bad = rk._decode_prep(cs, tots)
        Gd = tbl.shape[0]
        ms = cuda_ms(lambda: rk._decode_kernel(tbl, ini, strm, cursors, roff,
                                               t4d, TLOG), 5)
        plain_ms = cuda_ms(lambda: rk.rans_decode_plain(*args, TLOG), 1)
        nbytes = (2 * int(cs.long().sum()) + tbl.numel() * 4 + Gd * 4096
                  + tots.numel() * 4 + Gd * 4 + Gd * t4d * 4096 + Gd * 4)
        record(name, path, ms, plain_ms, nbytes,
               DEC_OPS_PER_STEP * Gd * 4 * t4d * 1024, 4 * t4d, chain["rans_decode"])
    print(json.dumps({"phase": "kernel_times", "gpu": gpu,
                      "clocks_sm_power_draw": nvidia_smi("clocks.sm,clocks.max.sm,power.draw"),
                      "shapes": {"rans_encode2": f"64 x {group} B Proba80",
                                 "rans_decode_w": f"64 x {group} B Proba80",
                                 "rans_decode_v2": f"3 x {group} B Proba80"},
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
